"""KG query serving — batched workload execution on PyTorch:

  python -m repro_torch.launch.serve --dataset lubm --n-shards 3 \
      --method wawpart --batch 14 --device cuda

Builds the dataset, partitions it for its published workload, buckets the
query plans by shape (see engine/batch.py), builds one engine per bucket,
and serves the request stream batch by batch, reporting throughput
(queries/sec) and the engine count.

--backend cuda (the default) runs every bucket engine's scan/join
primitives through the hand-written kg_scan / kg_join CUDA kernels;
--backend torch runs the plain PyTorch formulation. Results are
bit-identical. --device cuda (the default) needs a CUDA card and raises
without one; --device cpu runs on the CPU, where the kernel ops use their
plain versions.
"""
from __future__ import annotations

import argparse
import enum
import time
from collections import OrderedDict
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import torch

from repro_torch.core.partitioner import (Partitioning, centralized_partition,
                                          random_partition, wawpart_partition)
from repro_torch.engine.batch import (EngineCache, bucket_collectives,
                                      bucket_plans, canonical_params,
                                      dedup_requests, extract_batch,
                                      extract_fanout, kg_tensors,
                                      pad_requests_pow2, resolve_device,
                                      stage_batch)
from repro_torch.engine.federated import ShardedKG
from repro_torch.engine.planner import make_plan
from repro_torch.engine.primitives import check_backend
from repro_torch.kg.generator import generate_bsbm, generate_lubm
from repro_torch.kg.workloads import bsbm_queries, lubm_queries


class Counter(str, enum.Enum):
    """Every ``WorkloadServer.stats`` counter, by name (each member *is*
    its string value, so ``stats[Counter.SERVED]`` and ``stats["served"]``
    hit the same entry). Invariant: served == cache_hits + executed +
    deduped."""

    SERVED = "served"                  # requests delivered (hits + executed)
    EXECUTED = "executed"              # unique instances dispatched to engines
    DEDUPED = "deduped"                # requests collapsed onto an instance
    CACHE_HITS = "cache_hits"          # answer-cache hits (skip dispatch)
    CACHE_MISSES = "cache_misses"      # answer-cache lookups that missed


class WorkloadServer:
    """Serve batches of (query_name, params) requests with bucketed engines.

    Plans for the workload's template queries are built once and grouped
    into shape buckets; each bucket's engine is built on first use through
    the `EngineCache` (shared across servers when passed in). The KG blocks
    and sort permutations live on ``device`` for the server's lifetime.

    ``serve()`` routes each request, checks the epoch-versioned answer
    cache, dedups identical (template, params) requests within the batch
    (``dedup=True``), pads each bucket's batch to a power of two, stages it
    onto the device, runs the bucket engine, then extracts the results and
    fills the cache. answer_cache=True (or an int LRU capacity) memoizes
    final results by (template, canonical padded params); the cache drops
    whenever the serving epoch changes. warmup never reads or fills it.

    backend: "cuda" (hand-written kernels; plain versions on CPU tensors)
    or "torch" (plain PyTorch primitives) — bit-identical results.
    """

    ANSWER_CACHE_CAP = 65536

    def __init__(self, queries, part: Partitioning, *,
                 join_impl: str = "sorted", max_per_row: int | None = None,
                 gather_cap: int | None = None,
                 params_spec: dict[str, dict] | None = None,
                 cache: EngineCache | None = None, dedup: bool = True,
                 answer_cache: bool | int = True, backend: str = "cuda",
                 kernel_blocks=None, device="cuda"):
        """Build the serving state for ``part`` on ``device``; engines are
        built lazily on the first dispatch that touches each bucket.

        Raises ValueError on an unknown backend or invalid kernel_blocks,
        RuntimeError when ``device`` is CUDA and no card is available.
        """
        self.device = resolve_device(device)
        self.queries = list(queries)
        self.join_impl = join_impl
        self.max_per_row = max_per_row
        self.gather_cap = gather_cap
        self.backend = backend
        self.kernel_blocks = check_backend(backend, kernel_blocks)
        self.cache = cache if cache is not None else EngineCache()
        self.dedup = dedup
        self.params_spec = params_spec or {}
        self.answer_cache_cap = (self.ANSWER_CACHE_CAP if answer_cache is True
                                 else int(answer_cache))
        self._answers: OrderedDict[tuple, tuple] = OrderedDict()
        self._answers_epoch = 0
        self._cache_bypass = False
        self._stats = {c.value: 0 for c in Counter}

        self.part = part
        self.epoch = 0
        self.plans = {q.name: make_plan(q, part,
                                        params=self.params_spec.get(q.name))
                      for q in self.queries}
        self.kg = ShardedKG.build(part)
        self.buckets = bucket_plans([self.plans[q.name]
                                     for q in self.queries])
        self.route: dict[str, tuple[int, int]] = {}
        for bi, b in enumerate(self.buckets):
            for pi, plan in enumerate(b.plans):
                self.route[plan.query.name] = (bi, pi)
        self._tr, self._va, self._perms = kg_tensors(self.kg, None,
                                                     self.device)

    @property
    def n_buckets(self) -> int:
        """Number of shape buckets (upper bound on engine builds)."""
        return len(self.buckets)

    @property
    def n_compiles(self) -> int:
        """Engines built so far through this server's (shared) cache."""
        return self.cache.misses

    @property
    def stats(self) -> dict[str, int]:
        """Counter totals keyed by `Counter` value."""
        return dict(self._stats)

    def collective_counts(self) -> list[int]:
        """Per-bucket cross-shard gather sites — the bucket-level WawPart
        cut counts (0 = gather-free engine)."""
        return [bucket_collectives(b.signature) for b in self.buckets]

    def _engine(self, bucket):
        return self.cache.get(bucket.signature, join_impl=self.join_impl,
                              max_per_row=self.max_per_row,
                              gather_cap=self.gather_cap,
                              backend=self.backend,
                              kernel_blocks=self.kernel_blocks)

    def serve(self, requests: list[tuple[str, np.ndarray | None]]):
        """Execute one batch of requests; results align with request order.

        Each result is (solutions, count, overflow). Each bucket appearing
        among the cache misses dispatches exactly once, in order of first
        appearance. Raises KeyError for a template outside the workload and
        ValueError for a param vector wider than its bucket executes with.
        """
        results: list = [None] * len(requests)
        queues: dict[int, list[tuple[int, str, np.ndarray | None]]] = {}
        if self._answers and self._answers_epoch != self.epoch:
            self._answers.clear()
        self._answers_epoch = self.epoch
        use_cache = self.answer_cache_cap > 0 and not self._cache_bypass
        for slot, (name, pv) in enumerate(requests):
            bi, _ = self.route[name]
            key = (name, canonical_params(pv, self.buckets[bi].n_params))
            if use_cache:
                hit = self._answers.get(key)
                if hit is not None:
                    self._answers.move_to_end(key)
                    results[slot] = hit
                    self._stats["served"] += 1
                    self._stats["cache_hits"] += 1
                    continue
                self._stats["cache_misses"] += 1
            queues.setdefault(bi, []).append((slot, name, pv))
        for bi, queued in queues.items():
            self._dispatch(bi, queued, results, use_cache)
        return results

    def _dispatch(self, bi: int, queued, results, fill: bool) -> None:
        """Dedup, pad, stage and run one bucket's cut of the batch, then
        extract its results into ``results`` and fill the answer cache."""
        bucket = self.buckets[bi]
        reqs = [(self.route[name][1], pv) for _, name, pv in queued]
        if self.dedup:
            unique, inverse = dedup_requests(reqs, bucket.n_params)
        else:
            unique, inverse = reqs, None
        with torch.profiler.record_function(f"dispatch/bucket{bi}"):
            pd, params = stage_batch(bucket, pad_requests_pow2(unique),
                                     device=self.device)
            out = self._engine(bucket)(self._tr, self._va, self._perms, pd,
                                       params)
            table, tmask, overflow = (t.cpu().numpy() for t in out)
        if inverse is None:
            extracted = extract_batch(bucket, unique, table, tmask, overflow)
        else:
            extracted = extract_fanout(bucket, unique, inverse, table, tmask,
                                       overflow)
        self._stats["executed"] += len(unique)
        self._stats["deduped"] += len(queued) - len(unique)
        self._stats["served"] += len(queued)
        for (slot, name, pv), res in zip(queued, extracted):
            results[slot] = res
            if fill:
                key = (name, canonical_params(pv, bucket.n_params))
                if key not in self._answers:
                    self._answers[key] = res
                    if len(self._answers) > self.answer_cache_cap:
                        self._answers.popitem(last=False)

    def warmup(self, requests) -> None:
        """Build every bucket engine the request stream touches. Warmup
        bypasses the answer cache entirely (no reads, no fills: a
        pre-warmed cache would make steady-state measurements all-hit)."""
        bypass, self._cache_bypass = self._cache_bypass, True
        try:
            self.serve(requests)
        finally:
            self._cache_bypass = bypass

    def reset_stats(self) -> None:
        """Zero every stats counter — the steady-state measurement
        boundary after warmup."""
        self._stats = {c.value: 0 for c in Counter}


def build_dataset(dataset: str, scale: float, seed: int = 0):
    """(store, template queries) for "lubm" or "bsbm" at `scale`."""
    if dataset == "lubm":
        return generate_lubm(1, scale=scale, seed=seed), lubm_queries()
    return generate_bsbm(int(1000 * scale), seed=seed), bsbm_queries()


def build_partition(method: str, store, queries, n_shards: int):
    """Partition `store` by method: "wawpart" | "random" | "centralized"."""
    if method == "wawpart":
        return wawpart_partition(store, queries, n_shards=n_shards)
    if method == "random":
        return random_partition(store, queries, n_shards=n_shards, seed=0)
    return centralized_partition(store, queries)


def request_stream(queries, n_requests: int, *,
                   weights: dict[str, float] | None = None,
                   seed: int | np.random.SeedSequence = 0,
                   ) -> list[tuple[str, np.ndarray | None]]:
    """Request stream over the workload's template queries.

    weights=None gives a deterministic round-robin. With weights ({template
    name: relative frequency}), requests are sampled i.i.d. from the
    normalized distribution with numpy's ``default_rng(seed)``. Raises
    ValueError when the weights give zero total mass over the workload.
    """
    if weights is None:
        return [(queries[i % len(queries)].name, None)
                for i in range(n_requests)]
    names = [q.name for q in queries]
    p = np.asarray([max(0.0, float(weights.get(n, 0.0))) for n in names])
    if p.sum() <= 0:
        raise ValueError("weights give zero total mass over the workload")
    rng = np.random.default_rng(seed)
    idx = rng.choice(len(names), size=n_requests, p=p / p.sum())
    return [(names[int(i)], None) for i in idx]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def kernel_ops() -> dict:
    """The engine's kernel ops by name; each counts its launches in its
    ``launches`` attribute."""
    from repro_torch.kernels.kg_join import ops as join_ops
    from repro_torch.kernels.kg_scan import ops as scan_ops
    return {name: fn for mod in (scan_ops, join_ops)
            for name, fn in vars(mod).items() if hasattr(fn, "launches")}


def _profiler(device: torch.device):
    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _report_profile(prof, device: torch.device, wall_s: float,
                    out_dir: str) -> None:
    """Print the profiled loop's ops by device (or CPU) time, each bucket's
    dispatch (host time, and its span on the device timeline) and the
    device-busy share; write the Chrome trace."""
    avgs = prof.key_averages()
    key = "self_device_time_total" if device.type == "cuda" \
        else "self_cpu_time_total"
    print(avgs.table(sort_by=key, row_limit=25))
    on_device = torch.autograd.DeviceType.CUDA
    busy_us = sum(e.self_device_time_total for e in avgs
                  if e.device_type == on_device and not e.is_user_annotation)
    buckets: dict[str, list[float]] = {}
    for e in avgs:
        if e.key.startswith("dispatch/bucket"):
            row = buckets.setdefault(e.key, [0.0, 0.0])
            if e.device_type == on_device:
                row[1] += e.device_time_total
            else:
                row[0] += e.cpu_time_total
    for name, (host_us, span_us) in sorted(buckets.items()):
        print(f"  {name}: host {host_us / 1e3:.3f} ms, device span "
              f"{span_us / 1e3:.3f} ms")
    if device.type == "cuda":
        print(f"  device busy {busy_us / 1e3:.3f} ms of {wall_s * 1e3:.3f} ms"
              f" wall ({busy_us / 1e6 / wall_s:.1%})")
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(Path(out_dir) / "trace.json"))
    print(f"  trace -> {Path(out_dir) / 'trace.json'}")


def _trace_events(device: torch.device) -> list:
    """The card's allocator events recorded so far (with their stacks)."""
    snap = torch.cuda.memory._snapshot()
    index = torch.cuda.current_device() if device.index is None \
        else device.index
    return snap["device_traces"][index]


def peak_blocks(events: list, first: int) -> tuple[int, int, dict]:
    """Replay the card's allocator events (``torch.cuda.memory._snapshot``'s
    device trace) and return (peak bytes, live blocks, {line: [bytes,
    blocks]}) at the peak of the allocated bytes after event ``first``,
    the blocks grouped by the innermost repro_torch line that allocated
    them. The allocated bytes fall at "free_requested", as the allocator's
    statistics do, so the peak is torch.cuda.max_memory_allocated when
    every allocation was recorded."""
    cur = peak = 0
    at = first
    for i, ev in enumerate(events):
        if ev["action"] == "alloc":
            cur += ev["size"]
        elif ev["action"] == "free_requested":
            cur -= ev["size"]
        if i >= first and cur > peak:
            peak, at = cur, i
    live = {}
    for ev in events[:at + 1]:
        if ev["action"] == "alloc":
            live[ev["addr"]] = ev
        elif ev["action"] == "free_requested":
            live.pop(ev["addr"], None)
    groups: dict[str, list[int]] = {}
    for ev in live.values():
        where = next((f"{f['filename'].split('repro_torch/')[-1]}:"
                      f"{f['line']} {f['name']}" for f in ev["frames"]
                      if "repro_torch/" in f["filename"]),
                     "(no repro_torch frame)")
        row = groups.setdefault(where, [0, 0])
        row[0] += ev["size"]
        row[1] += 1
    return peak, len(live), groups


def main(argv: list[str] | None = None) -> None:
    """CLI entry point: partition, warm up, and serve the request stream."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", choices=("lubm", "bsbm"), default="lubm")
    ap.add_argument("--scale", type=float, default=0.3)
    ap.add_argument("--n-shards", type=int, default=3)
    ap.add_argument("--method", choices=("wawpart", "random", "centralized"),
                    default="wawpart")
    ap.add_argument("--join", choices=("expand", "sorted"), default="sorted")
    ap.add_argument("--backend", choices=("cuda", "torch"), default="cuda",
                    help="engine primitives: the hand-written CUDA kernels "
                         "(cuda; plain versions on CPU tensors) or plain "
                         "PyTorch (torch) — results are bit-identical")
    ap.add_argument("--batch", type=int, default=64,
                    help="requests per serve() call")
    ap.add_argument("--requests", type=int, default=256,
                    help="total requests in the stream")
    ap.add_argument("--max-per-row", type=int, default=0,
                    help="ceiling on the merge-join window (0 = auto: "
                         "per-step data-sized fan-out caps)")
    ap.add_argument("--no-dedup", action="store_true",
                    help="disable dedup of identical batch requests")
    ap.add_argument("--no-cache", action="store_true",
                    help="disable the epoch-versioned answer cache")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda; raises "
                         "without a card — pass cpu to run on the CPU)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="run the timed loop under torch.profiler, print "
                         "the ops by device time (CPU time on the CPU) and "
                         "the per-bucket dispatch times, and write "
                         "DIR/trace.json (Chrome trace)")
    ap.add_argument("--memory-peak", action="store_true",
                    help="record every allocation on the card with its "
                         "Python stack (this slows the host, so the run's "
                         "times are not comparable) and print the blocks "
                         "live at the timed loop's peak, by the line that "
                         "allocated them")
    ap.add_argument("--check", action="store_true",
                    help="after the timed loop, compare every served answer "
                         "with the oracle (evaluate_bgp in the plan's join "
                         "order) and print how many agree")
    args = ap.parse_args(argv)
    if args.batch < 1:
        ap.error("--batch must be >= 1")
    device = resolve_device(args.device)
    if args.memory_peak:
        if device.type != "cuda":
            ap.error("--memory-peak needs a CUDA device")
        torch.cuda.memory._record_memory_history(stacks="python")

    store, queries = build_dataset(args.dataset, args.scale)
    stream = request_stream(queries, args.requests)
    t0 = time.perf_counter()
    part = build_partition(args.method, store, queries, args.n_shards)
    t_part = time.perf_counter() - t0
    server = WorkloadServer(queries, part, join_impl=args.join,
                            max_per_row=args.max_per_row or None,
                            dedup=not args.no_dedup, backend=args.backend,
                            answer_cache=not args.no_cache, device=device)
    print(f"{args.dataset}: {len(store):,} triples -> {part.n_shards} shards "
          f"{part.shard_sizes.tolist()} ({t_part:.1f}s partitioning), "
          f"{len(queries)} template queries in {server.n_buckets} buckets, "
          f"backend={args.backend}, device={device}")
    print(f"  per-bucket collective counts (WawPart cuts): "
          f"{server.collective_counts()}")

    for i in range(0, len(stream), args.batch):
        server.warmup(stream[i:i + args.batch])
    _sync(device)
    server.reset_stats()
    ops = kernel_ops()
    for op in ops.values():
        op.launches = 0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    first = len(_trace_events(device)) if args.memory_peak else 0
    prof = _profiler(device) if args.profile else nullcontext()
    with prof:
        t0 = time.perf_counter()
        n_solutions = overflows = 0
        per_call, answers = [], []
        for i in range(0, len(stream), args.batch):
            t_call = time.perf_counter()
            for res in server.serve(stream[i:i + args.batch]):
                n_solutions += res[1]
                overflows += bool(res[2])
                answers.append(res[0])
            _sync(device)
            per_call.append(time.perf_counter() - t_call)
        dt = time.perf_counter() - t0
    st = server.stats
    print(f"served {len(stream)} requests in {dt * 1e3:.1f} ms  "
          f"({len(stream) / dt:,.0f} queries/sec, batch={args.batch})")
    print(f"  per serve() call: median {np.median(per_call) * 1e3:.3f} ms "
          f"of {len(per_call)} {[round(t * 1e3, 3) for t in per_call]}")
    print(f"  kernel launches {({k: op.launches for k, op in ops.items()})}")
    if device.type == "cuda":
        print(f"  peak device memory "
              f"{torch.cuda.max_memory_allocated(device):,} bytes "
              f"(torch.cuda.max_memory_allocated)")
    print(f"  solutions={n_solutions:,}  overflows={overflows}  "
          f"engines={server.n_compiles} (<= {server.n_buckets} buckets)  "
          f"dedup: {st['executed']}/{st['served']} instances executed")
    if st["cache_hits"] or st["cache_misses"]:
        total = st["cache_hits"] + st["cache_misses"]
        print(f"  answer cache: {st['cache_hits']}/{total} hits "
              f"({st['cache_hits'] / max(1, total):.0%})")
    if args.check:
        from repro_torch.engine.oracle import evaluate_bgp
        by_name = {q.name: q for q in queries}
        oracle = {name: evaluate_bgp(store, by_name[name],
                                     order=server.plans[name].meta["order"])
                  for name in {name for name, _ in stream}}
        agree = sum(np.array_equal(rows, oracle[name])
                    for (name, _), rows in zip(stream, answers))
        print(f"  oracle: {agree}/{len(stream)} answers equal evaluate_bgp")
    if args.profile:
        _report_profile(prof, device, dt, args.profile)
    if args.memory_peak:
        events = _trace_events(device)
        torch.cuda.memory._record_memory_history(enabled=None)
        peak, n_live, groups = peak_blocks(events, first)
        print(f"  peak of the timed loop, replayed from {len(events):,} "
              f"allocator events: {peak:,} bytes "
              f"(torch.cuda.max_memory_allocated "
              f"{torch.cuda.max_memory_allocated(device):,}) in {n_live:,} "
              f"blocks, by the line that allocated them:")
        for where, (size, n) in sorted(groups.items(), key=lambda g: -g[1][0]):
            print(f"    {size:>14,} bytes {n:>5} blocks  {where}")


if __name__ == "__main__":
    main()
