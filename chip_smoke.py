"""On-card smoke run of the PyTorch/CUDA port (``src/repro_torch``).

    python3 chip_smoke.py

Needs one CUDA card and nvcc (CUDA_HOME or /usr/local/cuda). Phases, in
order; any failure exits non-zero:

1. device — the card's name and power limit;
2. build — compile the kernels from src/repro_torch/csrc with nvcc;
3. kernels — each kernel against its plain PyTorch version on the card at
   the main path's shapes (bit-identical, every output), with its median
   CUDA-event time over 25 runs (L2 flushed before each), its bound, the
   plain version's time and, where one exists, a PyTorch library call's;
4. main path — LUBM(1) at scale 1.0, WawPart over 3 shards, served by
   WorkloadServer(join_impl="sorted") with the kernels: every result equals
   the oracle, no overflow flag is set, scan_hits and join_ranges launched;
5. expand path — LUBM at scale 0.1 under join_impl="expand": the same
   checks, and compat_matrix launched.

The last three lines are the card's name and power limit, a JSON line of
per-kernel numbers, and ``{"ok": true, "device": {...}}``.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

if not torch.cuda.is_available():
    print("chip_smoke: torch.cuda.is_available() is false; this run needs a "
          "CUDA card", file=sys.stderr)
    sys.exit(2)

sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))

from repro_torch import kernels  # noqa: E402
from repro_torch.core.partitioner import wawpart_partition  # noqa: E402
from repro_torch.engine.oracle import evaluate_bgp  # noqa: E402
from repro_torch.kernels.kg_join import ops as join_ops  # noqa: E402
from repro_torch.kernels.kg_join.ref import (compat_matrix_ref,  # noqa: E402
                                             join_ranges_ref)
from repro_torch.kernels.kg_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.kg_scan.ref import scan_hits_ref  # noqa: E402
from repro_torch.kg.generator import generate_lubm  # noqa: E402
from repro_torch.kg.workloads import lubm_queries  # noqa: E402
from repro_torch.launch.serve import (WorkloadServer,  # noqa: E402
                                      request_stream)

DEV = torch.device("cuda", 0)
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory rate
INT_OPS_PER_S = 67e12        # H100 SXM float32 rate outside the tensor
#                              cores; integer ALU ops are counted against it
REPS = 25
RNG = np.random.default_rng(0)
BATCH = 14                   # requests per serve(): one per LUBM template


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def dev(a) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(DEV)


_FLUSH = None


def time_ms(fn) -> float:
    """Median milliseconds of fn() over REPS CUDA-event-timed runs, each
    after a 256 MiB write that evicts the 50 MB L2."""
    global _FLUSH
    if _FLUSH is None:
        _FLUSH = torch.empty(64 << 20, dtype=torch.int32, device=DEV)
    for _ in range(3):
        fn()
    times = []
    for _ in range(REPS):
        _FLUSH.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_err(outs, refs) -> int:
    """Largest |kernel - plain| over every output; fails unless 0."""
    err = 0
    for o, r in zip(outs, refs):
        if o.shape != r.shape or o.dtype != r.dtype:
            raise AssertionError(f"kernel output {tuple(o.shape)} {o.dtype} "
                                 f"!= plain {tuple(r.shape)} {r.dtype}")
        err = max(err, int((o.to(torch.int64) - r.to(torch.int64))
                           .abs().max().item()) if o.numel() else 0)
    if err != 0:
        raise AssertionError(f"kernel differs from its plain version by "
                             f"{err}")
    return err


def bound(n_bytes: float, n_ops: float) -> tuple[float, str]:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def scan_case(n_inst: int, n: int, mask_only: bool = False):
    va = dev(RNG.uniform(size=(n_inst, n)) < 0.8)
    if mask_only:
        args = (None, va, None, None)
    else:
        tr = dev(RNG.integers(-1, 30, (n_inst, n, 3)).astype(np.int32))
        pats = np.array([[5, -1, 7], [-1, -1, -1], [-2, 3, -1], [4, -1, -1]],
                        np.int32)
        gates = np.array([[0, 0, 0], [1, 0, 0], [0, 0, 0], [0, 1, 1]], bool)
        args = (tr, va, dev(pats[np.arange(n_inst) % 4]),
                dev(gates[np.arange(n_inst) % 4]))
    out = scan_ops.scan_hits(*args)
    torch.cuda.synchronize()
    ref = scan_hits_ref(*args)
    err = max_err(out, ref)
    rows = n_inst * n
    n_bytes = rows * (1 + 4) + (0 if mask_only else rows * (12 + 1))
    n_ops = rows * (2 if mask_only else 20)
    return args, err, bound(n_bytes, n_ops)


def ranges_case(n_inst: int, sb: int, c: int, r: int):
    keys = np.sort(RNG.integers(-1, 4000, (n_inst, sb, c)).astype(np.int32),
                   axis=-1)
    keys = np.where(RNG.uniform(size=keys.shape) < 0.2, 2**31 - 1, keys)
    keys = dev(np.sort(keys, axis=-1).astype(np.int32))
    rkey = dev(RNG.integers(-1, 4100, (n_inst, r)).astype(np.int32))
    out = join_ops.join_ranges(keys, rkey)
    torch.cuda.synchronize()
    err = max_err(out, join_ranges_ref(keys, rkey))
    k1 = keys[:, 0].contiguous()
    err = max(err, max_err(join_ops.join_ranges(k1, rkey),
                           join_ranges_ref(k1, rkey)))
    searches = n_inst * sb * r
    n_bytes = n_inst * sb * c * 4 + n_inst * r * 4 + 2 * searches * 4
    n_ops = searches * 2 * int(np.ceil(np.log2(c + 1))) * 3
    return (keys, rkey), err, bound(n_bytes, n_ops)


def compat_case(n_inst: int, r: int, v: int, c: int):
    args = (dev(RNG.integers(-1, 20, (n_inst, r, v)).astype(np.int32)),
            dev(RNG.uniform(size=(n_inst, r)) < 0.7),
            dev(RNG.integers(-1, 20, (n_inst, c, 3)).astype(np.int32)),
            dev(RNG.uniform(size=(n_inst, c)) < 0.7),
            dev(RNG.integers(0, 3, (n_inst, 3)).astype(np.int32)),
            dev(RNG.integers(-1, v + 1, (n_inst, 3)).astype(np.int32)))
    out = join_ops.compat_matrix(*args)
    torch.cuda.synchronize()
    err = max_err([out], [compat_matrix_ref(*args)])
    n_bytes = (n_inst * r * (v * 4 + 1) + n_inst * c * (12 + 1)
               + n_inst * r * c)
    return args, err, bound(n_bytes, n_inst * r * c * 8)


def phase_kernels() -> dict:
    """Check every kernel on the ragged sweep shapes and the main path's
    shapes; time each at its main-path shape. Returns per-kernel records."""
    for n in (9, 64, 1000, 4096, 36800):
        for mask_only in (False, True):
            scan_case(3, n, mask_only)
    for sb, c, r in ((1, 64, 32), (3, 1000, 200), (8, 128, 513),
                     (1, 16384, 32768), (3, 16384, 32768)):
        ranges_case(2, sb, c, r)
    for r, v, c in ((32, 4, 64), (200, 1, 17), (513, 6, 300)):
        compat_case(3, r, v, c)
    log("  ragged sweep shapes: all bit-identical")

    rec = {}
    # kg_scan at the merge-path scan of bucket 4: 8 padded requests x 3
    # shards, 36,800 rows per LUBM(1) shard
    args, err, (b_ms, b_by) = scan_case(24, 36800)
    rec["scan_hits"] = dict(
        name="kg_scan.scan_hits", route="cuda",
        source="src/repro_torch/csrc/kg_scan.cu",
        replaces="src/repro/kernels/kg_scan/kernel.py:51",
        max_abs_err=err, ms=time_ms(lambda: scan_ops.scan_hits(*args)),
        plain_ms=time_ms(lambda: scan_hits_ref(*args)), bound_ms=b_ms,
        bound_by=b_by, library_ms=None)
    log(f"  kg_scan.scan_hits (24 x 36800 rows): {rec['scan_hits']}")
    # the same kernel as the prefix sum of bucket 4's step-3 pair mask
    # (R x S_b x K = 32768 x 3 x 2048 per instance; one request's 3 shards)
    args, err, (b_ms, _) = scan_case(3, 32768 * 3 * 2048, mask_only=True)
    mask = args[1]
    log(f"  kg_scan.scan_hits prefix mode (3 x {mask.shape[1]}): err={err} "
        f"ms={time_ms(lambda: scan_ops.scan_hits(*args)):.4f} "
        f"plain_ms={time_ms(lambda: scan_hits_ref(*args)):.4f} "
        f"torch.cumsum_ms="
        f"{time_ms(lambda: torch.cumsum(mask, -1, dtype=torch.int32)):.4f} "
        f"bound_ms={b_ms:.4f}")
    del args, mask

    # kg_join.join_ranges at bucket 4's gathered merge steps: 24 instances,
    # 3 key blocks of C = 16,384, R = 32,768 table rows
    (keys, rkey), err, (b_ms, b_by) = ranges_case(24, 3, 16384, 32768)
    rk = rkey[:, None, :].expand(24, 3, 32768).contiguous()
    rec["join_ranges"] = dict(
        name="kg_join.join_ranges", route="cuda",
        source="src/repro_torch/csrc/kg_join.cu",
        replaces="src/repro/kernels/kg_join/kernel.py:62",
        max_abs_err=err,
        ms=time_ms(lambda: join_ops.join_ranges(keys, rkey)),
        plain_ms=time_ms(lambda: join_ranges_ref(keys, rkey)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=time_ms(lambda: (
            torch.searchsorted(keys, rk, side="left", out_int32=True),
            torch.searchsorted(keys, rk, side="right", out_int32=True))))
    log(f"  kg_join.join_ranges (24 x 3 x 16384 keys, 32768 rows): "
        f"{rec['join_ranges']}")
    # the PPN-local merge steps: one key block
    (k1, r1), err, (b1, _) = ranges_case(24, 1, 16384, 32768)
    log(f"  kg_join.join_ranges S_b=1: err={err} "
        f"ms={time_ms(lambda: join_ops.join_ranges(k1, r1)):.4f} "
        f"bound_ms={b1:.4f}")

    # kg_join.compat_matrix at the expand path's largest call of phase 5
    # (LUBM scale 0.1, bucket 4: 8 requests x 3 shards, R = 256 table rows
    # of 4 vars against 3 gathered blocks of 256 matches) and one larger
    # random case
    args, err, (b_ms, b_by) = compat_case(24, 256, 4, 768)
    rec["compat_matrix"] = dict(
        name="kg_join.compat_matrix", route="cuda",
        source="src/repro_torch/csrc/kg_join.cu",
        replaces="src/repro/kernels/kg_join/kernel.py:111",
        max_abs_err=err,
        ms=time_ms(lambda: join_ops.compat_matrix(*args)),
        plain_ms=time_ms(lambda: compat_matrix_ref(*args)),
        bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"  kg_join.compat_matrix (24 x 256 x 768): {rec['compat_matrix']}")
    args, err, (b_ms, _) = compat_case(6, 4096, 6, 8192)
    log(f"  kg_join.compat_matrix (6 x 4096 x 8192): err={err} "
        f"ms={time_ms(lambda: join_ops.compat_matrix(*args)):.4f} "
        f"plain_ms={time_ms(lambda: compat_matrix_ref(*args)):.4f} "
        f"bound_ms={b_ms:.4f}")
    return rec


# ---------------------------------------------------------------------------
# phases 4 and 5: serve the workload through the port's entry points
# ---------------------------------------------------------------------------

def reset_counts():
    scan_ops.scan_hits.launches = 0
    join_ops.join_ranges.launches = 0
    join_ops.compat_matrix.launches = 0


def counts() -> dict:
    return {"scan_hits": scan_ops.scan_hits.launches,
            "join_ranges": join_ops.join_ranges.launches,
            "compat_matrix": join_ops.compat_matrix.launches}


def serve_path(scale: float, join_impl: str, passes: int = 2) -> dict:
    """Build, partition and serve a round-robin stream over every LUBM
    template (``passes`` passes of BATCH requests); check every result
    against the oracle. Returns the launch counts of the served run."""
    t0 = time.perf_counter()
    store = generate_lubm(1, scale=scale, seed=0)
    queries = lubm_queries()
    part = wawpart_partition(store, queries, n_shards=3)
    server = WorkloadServer(queries, part, join_impl=join_impl,
                            backend="cuda", device=DEV)
    log(f"  LUBM scale {scale}: {len(store):,} triples -> shards "
        f"{part.shard_sizes.tolist()}, kg {tuple(server.kg.triples.shape)}, "
        f"{server.n_buckets} buckets, cuts {server.collective_counts()} "
        f"({time.perf_counter() - t0:.1f} s to build and plan)")
    stream = request_stream(queries, BATCH * passes)
    chunks = [stream[i:i + BATCH] for i in range(0, len(stream), BATCH)]
    t0 = time.perf_counter()
    server.warmup(chunks[0])
    torch.cuda.synchronize()
    log(f"  warmup: {time.perf_counter() - t0:.3f} s")
    # the planner's join order: in query order some LUBM(1) templates pass
    # through cartesian intermediates far larger than host memory; the
    # solution set does not depend on the order
    oracle = {q.name: evaluate_bgp(store, q,
                                   order=server.plans[q.name].meta["order"])
              for q in queries}

    server.reset_stats()
    torch.cuda.reset_peak_memory_stats(DEV)
    reset_counts()
    t_all = time.perf_counter()
    results, per_call = [], []
    for chunk in chunks:
        t0 = time.perf_counter()
        results += server.serve(chunk)
        torch.cuda.synchronize()
        per_call.append(time.perf_counter() - t0)
    dt = time.perf_counter() - t_all
    launched = counts()
    peak = torch.cuda.max_memory_allocated(DEV)

    for (name, _), (rows, n, ovf) in zip(stream, results):
        if ovf:
            raise AssertionError(f"{name}: overflow flag set")
        if not np.array_equal(rows, oracle[name]) or n != len(oracle[name]):
            raise AssertionError(f"{name}: result differs from the oracle")
    log(f"  served {len(stream)} requests in {dt:.4f} s "
        f"({len(stream) / dt:.2f} queries/s; per serve() call "
        f"{[round(t, 4) for t in per_call]} s; first pass "
        f"{BATCH / per_call[0]:.2f} queries/s)")
    log(f"  stats {server.stats}; launches {launched}; "
        f"max_memory_allocated {peak:,} bytes")
    log(f"  every result equals evaluate_bgp; no overflow "
        f"({sum(len(oracle[n]) for n, _ in stream):,} solutions)")
    return launched


def main() -> None:
    t_start = time.perf_counter()
    card = card_line()
    log(f"[1/6] device: {card}; torch.cuda.get_device_name: "
        f"{torch.cuda.get_device_name(0)}; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")

    log(f"[2/6] build: {kernels.build():.2f} s (nvcc, "
        f"{' '.join(kernels.NVCC_FLAGS)})")

    log("[3/6] kernels against their plain versions on the card")
    rec = phase_kernels()

    log("[4/6] main path: LUBM(1) scale 1.0, WawPart 3 shards, join sorted, "
        f"backend cuda, {BATCH} requests per serve()")
    main_counts = serve_path(1.0, "sorted")
    for k in ("scan_hits", "join_ranges"):
        if main_counts[k] <= 0:
            raise AssertionError(f"main path never launched {k}")

    log("[5/6] expand path: LUBM scale 0.1, join expand, backend cuda")
    expand_counts = serve_path(0.1, "expand")
    if expand_counts["compat_matrix"] <= 0:
        raise AssertionError("expand path never launched compat_matrix")

    rec["scan_hits"]["launches"] = main_counts["scan_hits"]
    rec["join_ranges"]["launches"] = main_counts["join_ranges"]
    rec["compat_matrix"]["launches"] = expand_counts["compat_matrix"]
    log("[6/6] kernels: " + ", ".join(
        f"{r['name']} ok (bit-identical) launches={r['launches']}"
        for r in rec.values())
        + f"; main path launches {main_counts}, expand path launches "
        f"{expand_counts}; total {time.perf_counter() - t_start:.1f} s")
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(card)
    print(json.dumps({"kernels": [{k: r[k] for k in keys}
                                  for r in rec.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
