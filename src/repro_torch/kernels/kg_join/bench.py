"""Times kg_join's range search and the expand join's step on a card.

    PYTHONPATH=src python3 src/repro_torch/kernels/kg_join/bench.py [ranges|compat]

It imports `repro_torch` from the path, so the same file run over
another tree's `src` times that tree's kernels on the same inputs; run the
trees in turns in one machine to compare them (parent, change, change,
parent).

"ranges" (and by default) times `join_ranges` at the LUBM(1) main path's
bucket 4 step-3 shape: 24 instances x 3 key blocks of 16,384 sorted keys
(drawn from [-1, 4,000), 20% INT_MAX padding) against 32,768 row keys
(from [-1, 4,100)), made from seed 0. "compat" (and by default) times the
expand join's step, `engine.batch._join_data(..., backend="cuda")` with
new_mode "all" and "none", and `kg_join.ops.compat_matrix` alone, at the
expand path's largest call at LUBM 0.1 (24 instances x 256 table rows of
4 variables against 768 matches) and a larger one (6 x 4,096 rows of 6
against 8,192 matches): values from [-1, 20), 70% live masks, kinds from
{0, 1, 2}, columns from [-1, V + 1), seed 0.

Prints the card's name and power limit, then one JSON line a timed call:
for each of 5 rounds, the median CUDA-event milliseconds of 25 calls (each
after a 256 MiB write that evicts the L2; the host's time to issue a call
included) and the device milliseconds per call of 25 back-to-back calls
by torch.profiler (kernels and memsets only), the medians over the
rounds, and a checksum of the outputs (equal for two versions that
agree).
"""
from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from repro_torch.engine import batch
from repro_torch.kernels.kg_join.ops import compat_matrix, join_ranges

SHAPE = dict(instances=24, sb=3, c=16384, r=32768)
COMPAT_SHAPES = {"expand path": dict(instances=24, r=256, v=4, c=768),
                 "large": dict(instances=6, r=4096, v=6, c=8192)}
ROUNDS, REPS = 5, 25


def event_ms(fn, flush: torch.Tensor) -> float:
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


def device_ms(fn) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
    on_device = torch.autograd.DeviceType.CUDA
    return sum(e.self_device_time_total for e in prof.key_averages()
               if e.device_type == on_device) / REPS / 1e3


def rounds(op: str, shape: dict, call, flush, checksum) -> None:
    """ROUNDS of event and device times of call, as one JSON line."""
    got = [(event_ms(call, flush), device_ms(call)) for _ in range(ROUNDS)]
    ev, de = zip(*got)
    print(json.dumps(dict(
        op=op, shape=shape, rounds_event_ms=ev, rounds_device_ms=de,
        event_ms=float(np.median(ev)), device_ms=float(np.median(de)),
        checksum=checksum)), flush=True)


def bench_ranges(rng, flush) -> None:
    n, sb, c, r = SHAPE.values()
    keys = rng.integers(-1, 4000, (n, sb, c)).astype(np.int32)
    keys = np.where(rng.uniform(size=keys.shape) < 0.2, 2**31 - 1, keys)
    keys = torch.sort(torch.from_numpy(keys.astype(np.int32)).cuda(),
                      dim=-1)[0]
    rkey = torch.from_numpy(
        rng.integers(-1, 4100, (n, r)).astype(np.int32)).cuda()
    lo, hi = join_ranges(keys, rkey)
    checksum = [int(lo.sum(dtype=torch.int64)), int(hi.sum(dtype=torch.int64))]
    rounds("kg_join.join_ranges", SHAPE, lambda: join_ranges(keys, rkey),
           flush, checksum)


def compat_inputs(rng, instances: int, r: int, v: int, c: int):
    def dev(a):
        return torch.from_numpy(np.ascontiguousarray(a)).cuda()

    return (dev(rng.integers(-1, 20, (instances, r, v)).astype(np.int32)),
            dev(rng.uniform(size=(instances, r)) < 0.7),
            dev(rng.integers(-1, 20, (instances, c, 3)).astype(np.int32)),
            dev(rng.uniform(size=(instances, c)) < 0.7),
            dev(rng.integers(0, 3, (instances, 3)).astype(np.int32)),
            dev(rng.integers(-1, v + 1, (instances, 3)).astype(np.int32)))


def bench_compat(rng, flush) -> None:
    for name, shape in COMPAT_SHAPES.items():
        args = compat_inputs(rng, **shape)
        for mode in ("all", "none"):
            def call():
                return batch._join_data(*args, mode, backend="cuda")
            out = call()
            checksum = [int(x.to(torch.int64).sum()) for x in out]
            rounds(f"engine.batch._join_data[{mode}]", dict(shape, at=name),
                   call, flush, checksum)
        matrix = compat_matrix(*args)
        rounds("kg_join.compat_matrix", dict(shape, at=name),
               lambda: compat_matrix(*args), flush,
               [int(matrix.sum(dtype=torch.int64))])
        del matrix, args
        torch.cuda.empty_cache()


def main() -> int:
    what = sys.argv[1:] or ["ranges", "compat"]
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60)
    print(card.stdout.strip().splitlines()[0], flush=True)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    if "ranges" in what:
        bench_ranges(np.random.default_rng(0), flush)
    if "compat" in what:
        bench_compat(np.random.default_rng(0), flush)
    return 0


if __name__ == "__main__":
    sys.exit(main())
