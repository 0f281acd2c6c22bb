"""Times the segment-sum kernel at GCN layer 2 on ogbn-products (random
float32 (E, 47) messages over the full batch's receivers, seed 0) under
plans cut at several piece sizes: the measurement that chose
`kernel.PIECE`. Needs a card:

    PYTHONPATH=src python -m repro_torch.kernels.segment_spmm.tune

Prints the card's name and power limit, then one JSON line of the
kernel's median milliseconds per piece size (CUDA events, each run after
a 256 MiB write that evicts the L2), each held to the PIECE plan's sums
within 1e-4 of their largest magnitude."""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys

import numpy as np
import torch

from repro_torch.configs import gcn_cora
from repro_torch.data.graphs import make_graph_batch
from repro_torch.kernels.segment_spmm.kernel import segment_spmm_kernel
from repro_torch.kernels.segment_spmm.ops import piece_table, segment_plan

PIECES = (64, 128, 256, 512, 1024, 4096)
REPS = 10


def time_ms(fn, flush: torch.Tensor) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60)
    print(card.stdout.strip().splitlines()[0], flush=True)
    dims = gcn_cora.SHAPE_DIMS["ogb_products"]
    g = make_graph_batch("ogb_products", **dims, seed=0, device="cuda")
    n = g.node_mask.shape[0]
    vals = torch.randn(
        (g.receivers.shape[0], dims["n_classes"]), device="cuda",
        generator=torch.Generator(device="cuda").manual_seed(3))
    plan = segment_plan(g.receivers, g.edge_mask, n)
    ref = segment_spmm_kernel(vals, plan, n)
    scale = float(ref.abs().max())
    flush = torch.empty(64 << 20, dtype=torch.int32, device="cuda")
    sweep = {}
    for piece in PIECES:
        cut = dataclasses.replace(plan, **piece_table(plan.offsets, piece))
        # other pieces sum in another order: held to the plan's sums
        diff = float((segment_spmm_kernel(vals, cut, n) - ref).abs().max())
        if diff > 1e-4 * scale:
            raise AssertionError(f"piece {piece}: max |diff| {diff}")
        sweep[piece] = dict(
            ms=time_ms(lambda: segment_spmm_kernel(vals, cut, n), flush),
            n_pieces=cut.n_pieces, max_abs_diff=diff)
        del cut
    print(json.dumps({"segment_spmm_piece_sweep": {
        "shape": list(vals.shape) + [n], "ms": sweep}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
