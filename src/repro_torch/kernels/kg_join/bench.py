"""Times kg_join's range search at the LUBM(1) main path's bucket 4
step-3 shape: 24 instances x 3 key blocks of 16,384 sorted keys (drawn
from [-1, 4,000), 20% INT_MAX padding) against 32,768 row keys (from
[-1, 4,100)), made from seed 0. Needs a card:

    PYTHONPATH=src python3 src/repro_torch/kernels/kg_join/bench.py

It imports `repro_torch` from the path, so the same file run over
another tree's `src` times that tree's kernel on the same inputs; run the
two trees in turns in one machine to compare them.

Prints the card's name and power limit, then one JSON line: for each of
5 rounds, the median CUDA-event milliseconds of 25 calls (each after a
256 MiB write that evicts the L2; the host's time to issue a call
included) and the device milliseconds per call of 25 back-to-back calls
by torch.profiler (kernels and memsets only), the medians over the
rounds, and a checksum of lo and hi (equal for two versions that agree).
"""
from __future__ import annotations

import json
import subprocess
import sys

import numpy as np
import torch

from repro_torch.kernels.kg_join.ops import join_ranges

SHAPE = dict(instances=24, sb=3, c=16384, r=32768)
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


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True, timeout=60)
    print(card.stdout.strip().splitlines()[0], flush=True)
    rng = np.random.default_rng(0)
    n, sb, c, r = SHAPE.values()
    keys = rng.integers(-1, 4000, (n, sb, c)).astype(np.int32)
    keys = np.where(rng.uniform(size=keys.shape) < 0.2, 2**31 - 1, keys)
    keys = torch.sort(torch.from_numpy(keys.astype(np.int32)).cuda(),
                      dim=-1)[0]
    rkey = torch.from_numpy(
        rng.integers(-1, 4100, (n, r)).astype(np.int32)).cuda()
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    lo, hi = join_ranges(keys, rkey)
    checksum = [int(lo.sum(dtype=torch.int64)), int(hi.sum(dtype=torch.int64))]

    def call():
        return join_ranges(keys, rkey)

    rounds = [(event_ms(call, flush), device_ms(call)) for _ in range(ROUNDS)]
    ev, de = zip(*rounds)
    print(json.dumps(dict(
        op="kg_join.join_ranges", shape=SHAPE, rounds_event_ms=ev,
        rounds_device_ms=de, event_ms=float(np.median(ev)),
        device_ms=float(np.median(de)), checksum=checksum)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
