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

--pipeline serves through the continuous-batching pipeline instead of
fixed synchronous batches: requests are submitted one by one with paced
arrivals (--arrival-ms), per-bucket queues flush when full or when the
oldest queued request's deadline budget (--deadline-ms) expires, batches
retire when their outputs' CUDA event fires, and the run reports
p50/p95/p99 latency plus flush-reason counters.
"""
from __future__ import annotations

import argparse
import enum
import time
from collections import OrderedDict, deque
from contextlib import contextmanager, nullcontext
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch.adaptive.migrate import MigrationPlan
from repro_torch.adaptive.stats import WorkloadTracker, plan_shards
from repro_torch.core.features import pattern_feature
from repro_torch.core.partitioner import (Partitioning, centralized_partition,
                                          random_partition, wawpart_partition)
from repro_torch.engine.batch import (EngineCache, OutputFetch,
                                      bucket_collectives, bucket_plans,
                                      canonical_params, dedup_requests,
                                      extract_batch, extract_fanout,
                                      fetch_outputs, kg_tensors,
                                      pad_requests_pow2, resolve_device,
                                      stage_batch)
from repro_torch.engine.federated import ShardedKG
from repro_torch.engine.planner import make_plan
from repro_torch.engine.primitives import check_backend
from repro_torch.faults import MigrationAbortedError, ShutdownError
from repro_torch.kg.generator import generate_bsbm, generate_lubm
from repro_torch.kg.workloads import bsbm_queries, lubm_queries
from repro_torch.obs import DEFAULT_CLOCK, Telemetry


class Counter(str, enum.Enum):
    """Every ``WorkloadServer.stats`` counter, by name (each member *is*
    its string value, so ``stats[Counter.SERVED]`` and ``stats["served"]``
    hit the same entry). ``stats`` is the flat view; the labeled
    per-bucket / per-template series live in the server's ``telemetry``
    registry. Invariant: served == cache_hits + executed + deduped + shed.
    The retry, timeout, degraded-mode and migration-abort counters stay 0
    until those layers are ported, except migration_aborts, which
    ``migrate()`` counts."""

    SERVED = "served"                  # requests delivered (hits + executed)
    EXECUTED = "executed"              # unique instances dispatched to engines
    DEDUPED = "deduped"                # requests collapsed onto an instance
    CACHE_HITS = "cache_hits"          # answer-cache hits (bypass the queue)
    CACHE_MISSES = "cache_misses"      # answer-cache lookups that missed
    FLUSH_FULL = "flush_full"          # dispatches cut by a full bucket queue
    FLUSH_DEADLINE = "flush_deadline"  # dispatches cut by a deadline expiry
    FLUSH_DRAIN = "flush_drain"        # dispatches cut by drain()/serve()
    RETRIES = "retries"                # tickets re-enqueued after a transient
    TIMEOUTS = "timeouts"              # tickets shed past their retry deadline
    SHED = "shed"                      # tickets resolved with a typed error
    DEGRADED_SERVED = "degraded_served"  # served exactly while a shard is down
    SHARD_DOWN = "shard_down"          # degraded-mode activations
    MIGRATION_ABORTS = "migration_aborts"  # migrate() prepares rolled back
    ENGINE_CACHE_EVICTIONS = "engine_cache_evictions"  # LRU engine evictions


@dataclass(frozen=True)
class PipelineConfig:
    """Continuous-batching pipeline knobs (see WorkloadServer.submit).

    deadline_ms: per-request latency budget — a bucket's queue is flushed
        partially filled once its oldest request has waited this long.
        ``None`` disables deadline flushes entirely (fill-only batching:
        a bucket dispatches only when full or drained).
    max_batch: queue length that triggers an immediate "full" flush.
    max_inflight: dispatched-but-unextracted batches kept outstanding —
        2 is double buffering (stage and launch batch k+1 while batch k
        computes on the card); 1 degenerates to synchronous dispatch.
    clock: monotonic time source; injectable so tests drive deadlines
        deterministically without sleeping. The server's telemetry
        recorder adopts this clock, so trace spans, latency stats, and
        the CLI timing all share one timebase (obs.DEFAULT_CLOCK ==
        time.monotonic).
    """

    deadline_ms: float | None = 25.0
    max_batch: int = 64
    max_inflight: int = 2
    clock: Callable[[], float] = DEFAULT_CLOCK


@dataclass
class Ticket:
    """One submitted request's handle: result slot + lifecycle timestamps.

    ``submit()`` returns a Ticket immediately; ``done`` flips when the
    request's batch is extracted (or instantly on an answer-cache hit).
    The four timestamps are the pipeline's latency instrumentation:
    enqueue (submit), flush (queue cut into a batch), dispatch (engine
    call issued), done (results extracted) — ``latency_s`` is end-to-end.
    ``epoch`` records the serving epoch the request executed against and
    ``flush_reason`` which trigger cut its batch ("full" | "deadline" |
    "drain"; "hit" for answer-cache hits that never queued; "shed" for
    tickets resolved with a typed error before any dispatch).

    A ticket resolved with a typed error (``ShutdownError`` past a
    shutdown's grace budget) has ``done=True``, ``result=None`` and the
    error in ``error`` — callers distinguish answers from rejections by
    ``error is None``. ``attempts`` stays 0 until a retry layer is ported.
    """

    name: str
    params: np.ndarray | None
    seq: int
    t_enqueue: float
    deadline_s: float | None = None     # absolute; None = never expires
    t_flush: float | None = None
    t_dispatch: float | None = None
    t_done: float | None = None
    result: tuple | None = None
    done: bool = False
    epoch: int | None = None
    flush_reason: str | None = None
    cache_hit: bool = False
    attempts: int = 0
    error: Exception | None = None

    @property
    def latency_s(self) -> float:
        """End-to-end latency (enqueue -> done) in seconds."""
        if self.t_done is None:
            raise ValueError(f"request {self.name!r} is not done yet")
        return self.t_done - self.t_enqueue


class _Inflight(NamedTuple):
    """One dispatched-but-unextracted batch (the pipeline's device leg)."""
    bucket: object
    bi: int                           # bucket index (telemetry label/lane)
    tickets: list                     # Tickets in flush order
    unique: list                      # deduped (plan_idx, params) requests
    inverse: list | None              # fan-out map, None when dedup is off
    out: OutputFetch                  # engine outputs on their way to host
    epoch: int                        # serving epoch at dispatch


_UNSET = object()     # "use the config default" sentinel for submit()


class _ServingState(NamedTuple):
    """One partitioning epoch's immutable serving artifacts. A migration
    swaps the server's state; an in-flight batch holds the tensors of the
    epoch it dispatched on, so they never change under it."""
    epoch: int
    part: Partitioning
    kg: ShardedKG
    plans: dict                       # template name -> unpadded PhysicalPlan
    buckets: list
    route: dict                       # template name -> (bucket, idx)
    tr: torch.Tensor
    va: torch.Tensor
    perms: torch.Tensor


class WorkloadServer:
    """Serve a stream of (query_name, params) requests with bucketed engines.

    Plans for the workload's template queries are built once and grouped
    into shape buckets; each bucket's engine is built on first use through
    the `EngineCache` (shared across servers when passed in). The KG blocks
    and sort permutations of the current epoch live on ``device``.

    dedup=True collapses identical (template, params) requests within a
    batch to one executed instance, fanned back out at delivery.
    answer_cache=True (or an int LRU capacity) memoizes final results by
    (template, canonical padded params); the cache is epoch-versioned, so
    `migrate()` drops it. warmup never reads or fills it.

    pipeline (a `PipelineConfig`) tunes the continuous-batching path:
    `submit()` enqueues one request into its bucket's queue and returns a
    `Ticket`; queues flush when full (max_batch), when the oldest queued
    request's deadline budget expires (`pump()`), or on `drain()`. A flush
    stages the batch onto the device (pinned, non-blocking), launches the
    engine and starts its outputs' copy to pinned host memory, recording a
    CUDA event (`engine/batch.fetch_outputs`); up to max_inflight batches
    stay outstanding, and `pump()` retires the oldest while its event has
    fired, without blocking. The synchronous `serve()` is submit + drain.

    telemetry (a `repro_torch.obs.Telemetry`) backs `stats`, latency
    histograms, queue and shard-load gauges, the Chrome trace (``trace=True``)
    and ``torch.profiler`` ranges ``dispatch/bucket{i}`` (``annotate=True``).

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
                 kernel_blocks=None,
                 pipeline: PipelineConfig | None = None,
                 telemetry: Telemetry | None = None, device="cuda"):
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
        self.pipeline = pipeline if pipeline is not None else PipelineConfig()
        self.telemetry = telemetry if telemetry is not None else Telemetry()
        self.telemetry.bind_clock(self.pipeline.clock)
        self._track = True
        self.answer_cache_cap = (self.ANSWER_CACHE_CAP if answer_cache is True
                                 else int(answer_cache))
        self._answers: OrderedDict[tuple, tuple] = OrderedDict()
        self._answers_epoch = 0
        self._cache_bypass = False
        self._queues: dict[int, list[Ticket]] = {}
        self._queues_epoch = 0
        self._inflight: deque[_Inflight] = deque()
        self._latencies: deque[tuple] = deque(maxlen=self.ANSWER_CACHE_CAP)
        self._seq = 0
        self._evictions_seen = self.cache.evictions
        self.tracker = WorkloadTracker()   # feeds the shard-load gauges

        plans = {q.name: make_plan(q, part,
                                   params=self.params_spec.get(q.name))
                 for q in self.queries}
        self._state = self._build_state(0, part, ShardedKG.build(part), plans)
        self._refresh_obs()

    # ---- state ---------------------------------------------------------

    def _build_state(self, epoch: int, part: Partitioning, kg: ShardedKG,
                     plans: dict) -> _ServingState:
        buckets = bucket_plans([plans[q.name] for q in self.queries])
        route: dict[str, tuple[int, int]] = {}
        for bi, b in enumerate(buckets):
            for pi, plan in enumerate(b.plans):
                route[plan.query.name] = (bi, pi)
        tr, va, pe = kg_tensors(kg, None, self.device)
        return _ServingState(epoch, part, kg, plans, buckets, route,
                             tr, va, pe)

    @property
    def part(self) -> Partitioning:
        """The current epoch's partitioning."""
        return self._state.part

    @property
    def kg(self) -> ShardedKG:
        """The current epoch's sharded triple blocks."""
        return self._state.kg

    @property
    def plans(self) -> dict:
        """template name -> the current epoch's unpadded PhysicalPlan."""
        return self._state.plans

    @property
    def buckets(self) -> list:
        """The current epoch's plan buckets (engine build units)."""
        return self._state.buckets

    @property
    def route(self) -> dict:
        """template name -> (bucket index, plan index) under this epoch."""
        return self._state.route

    @property
    def epoch(self) -> int:
        """Serving epoch: bumped by every migrate()."""
        return self._state.epoch

    @property
    def n_buckets(self) -> int:
        """Number of shape buckets (upper bound on engine builds)."""
        return len(self._state.buckets)

    @property
    def n_compiles(self) -> int:
        """Engines built so far through this server's (shared) cache."""
        return self.cache.misses

    @property
    def stats(self) -> dict[str, int]:
        """Flat counter totals keyed by `Counter` value, read from the
        telemetry registry (labels summed out; the per-bucket and
        per-template series live in `telemetry.snapshot()`)."""
        return {c.value: int(self.telemetry.total(c.value)) for c in Counter}

    def collective_counts(self) -> list[int]:
        """Per-bucket cross-shard gather sites — the bucket-level WawPart
        cut counts (0 = gather-free engine)."""
        return [bucket_collectives(b.signature) for b in self._state.buckets]

    def _refresh_obs(self) -> None:
        """Re-publish the state gauges (epoch, per-bucket cut collectives)
        for the current serving state; called at init and on every epoch
        bump since buckets can change count and signature."""
        tele = self.telemetry
        tele.gauge("epoch", self._state.epoch)
        tele.registry["cut_collectives"].clear()
        for bi, b in enumerate(self._state.buckets):
            tele.gauge("cut_collectives", bucket_collectives(b.signature),
                       bucket=str(bi))
        self._refresh_shard_load()

    def _refresh_shard_load(self) -> None:
        """Publish live per-shard load gauges from the tracker window.

        `shard_requests{shard=s}` is the number of window requests whose
        routed plan touched shard s (a request spanning k shards counts
        once on each), and `shard_load_imbalance` is their max/mean across
        all shards. The family is cleared first so a shard that fell out
        of the window never leaves a stale gauge behind.
        """
        tele = self.telemetry
        snap = self.tracker.snapshot()
        n_shards = self._state.part.n_shards
        tele.registry["shard_requests"].clear()
        for s in range(n_shards):
            tele.gauge("shard_requests", snap.shard_load.get(s, 0),
                       shard=str(s))
        tele.gauge("shard_load_imbalance", snap.imbalance(n_shards))

    # ---- migration -----------------------------------------------------

    def _query_units(self, q, part: Partitioning) -> set:
        """Every data unit a query's patterns can touch under a placement —
        the same resolution make_plan routes through (routing_units)."""
        units: set = set()
        for pat in q.patterns:
            units.update(part.routing_units(pattern_feature(pat)))
        return units

    def migrate(self, new_part: Partitioning) -> dict:
        """Swap the server onto a new placement of the same store.

        Transactional: the whole next serving state is *prepared* first —
        KG deltas applied, plans rewritten, buckets rebuilt, the blocks put
        on the device — and only then *committed* by the epoch swap. Any
        exception during prepare rolls back (the old epoch keeps serving,
        no ticket is lost or duplicated, `migration_aborts` counts it) and
        surfaces as `MigrationAbortedError` (ValueError for bad input
        passes through unchanged).

          1. per-shard triple deltas applied to the ShardedKG (block
             capacity kept when the new shards still fit, so engines keep
             their input shapes);
          2. only plans whose data units moved are re-rewritten (same
             catalog; a full re-run's new catalog re-plans everything) —
             scan/table capacities are reused;
          3. buckets rebuilt; the shared EngineCache keeps every bucket
             whose signature survived;
          4. the epoch bumps and the serving state swaps; in-flight
             batches hold the old state's tensors, and queued requests
             re-route through the new epoch's buckets before their next
             dispatch (`_sync_queues`).

        The epoch bump drops the whole answer cache. Returns a report dict:
        epoch, n_moved, moved_fraction, plans_rewritten/reused,
        signatures_reused/new, cap_grew. Raises ValueError (via
        MigrationPlan.build) if `new_part` covers a different store.
        """
        st = self._state
        try:
            # ---- prepare: build the entire next state off to the side
            mig = MigrationPlan.build(st.part, new_part)
            kg = mig.apply_kg(st.kg, new_part)
            same_catalog = new_part.catalog is st.part.catalog
            moved_units = set()
            if same_catalog:
                keys = set(st.part.unit_shard) | set(new_part.unit_shard)
                moved_units = {u for u in keys
                               if st.part.unit_shard.get(u)
                               != new_part.unit_shard.get(u)}
            plans: dict = {}
            rewritten = 0
            for q in self.queries:
                old_plan = st.plans[q.name]
                # same catalog => same unit_shard key set (incremental moves
                # reassign values only), so one placement's resolution covers
                # both sides of the move
                if same_catalog and not self._query_units(q, new_part) \
                        & moved_units:
                    plans[q.name] = old_plan
                    continue
                caps = ([s.scan_cap for s in old_plan.steps],
                        old_plan.table_cap)
                plans[q.name] = make_plan(q, new_part,
                                          params=self.params_spec.get(q.name),
                                          capacities=caps)
                rewritten += 1

            new_state = self._build_state(st.epoch + 1, new_part, kg, plans)
        except Exception as exc:
            # ---- rollback: nothing was swapped; old epoch keeps serving
            self.telemetry.count("migration_aborts")
            self.telemetry.trace.instant(
                "migration_abort", args={"epoch": st.epoch,
                                         "error": type(exc).__name__})
            if isinstance(exc, (MigrationAbortedError, ValueError)):
                raise
            raise MigrationAbortedError(
                f"migration prepare failed: {exc}") from exc

        # ---- commit: the swap (nothing below can throw partway)
        old_sigs = {b.signature for b in st.buckets}
        new_sigs = {b.signature for b in new_state.buckets}
        self._state = new_state
        self._answers.clear()        # every cached answer is pre-migration
        self._answers_epoch = new_state.epoch
        self._refresh_obs()
        self.telemetry.count("epoch_bumps", kind="migrate")
        self.telemetry.trace.instant(
            "migration", args={"epoch": new_state.epoch,
                               "n_moved": mig.n_moved,
                               "plans_rewritten": rewritten})
        return {"epoch": new_state.epoch, "n_moved": mig.n_moved,
                "moved_fraction": mig.moved_fraction,
                "plans_rewritten": rewritten,
                "plans_reused": len(self.queries) - rewritten,
                "signatures_reused": len(new_sigs & old_sigs),
                "signatures_new": len(new_sigs - old_sigs),
                "cap_grew": kg.cap > st.kg.cap}

    # ---- continuous-batching pipeline ----------------------------------

    def submit(self, name: str, params: np.ndarray | None = None, *,
               deadline_ms=_UNSET, _pump: bool = True) -> Ticket:
        """Enqueue one request into its bucket's queue; returns a Ticket.

        The request is routed (feeding the workload tracker), checked
        against the answer cache — a hit bypasses the queue entirely and
        returns an already-done Ticket whose latency is still stamped —
        and otherwise appended to its bucket's queue. deadline_ms
        overrides the pipeline config's budget for this request (None =
        never deadline-flush it); the queue dispatches when it reaches
        max_batch ("full"), when its oldest request's budget expires
        ("deadline", checked in pump()), or on drain().

        Raises KeyError for a template name outside the workload and
        ValueError for a param vector wider than the bucket executes with.
        """
        now = self.pipeline.clock()
        self._sync_queues()
        st = self._state
        tele = self.telemetry
        bi, pi = st.route[name]
        plan = st.buckets[bi].plans[pi]
        # cache hits still feed the tracker: the load gauges must see the
        # real mix even at high hit rates
        if self._track:
            self.tracker.observe(name, cut_joins=len(plan.cut_steps),
                                  shards=plan_shards(plan))
            if plan.cut_steps:
                tele.count("observed_cut_joins", len(plan.cut_steps),
                           template=name)
        # validate params eagerly — an oversized vector must fail at
        # submit, not at a deadline flush long after the caller moved on
        key = (name, canonical_params(params, st.buckets[bi].n_params))

        budget = self.pipeline.deadline_ms if deadline_ms is _UNSET \
            else deadline_ms
        ticket = Ticket(name=name, params=params, seq=self._seq,
                        t_enqueue=now,
                        deadline_s=None if budget is None
                        else now + budget / 1e3)
        self._seq += 1

        if self._answers and self._answers_epoch != st.epoch:
            self._answers.clear()
        self._answers_epoch = st.epoch
        if self.answer_cache_cap > 0 and not self._cache_bypass:
            hit = self._answers.get(key)
            if hit is not None:
                self._answers.move_to_end(key)
                ticket.result = hit
                ticket.done = True
                ticket.cache_hit = True
                ticket.flush_reason = "hit"
                ticket.epoch = st.epoch
                ticket.t_flush = ticket.t_dispatch = ticket.t_done = \
                    self.pipeline.clock()
                tele.count("served", template=name)
                tele.count("cache_hits", template=name)
                tele.observe("request_latency_ms",
                             (ticket.t_done - ticket.t_enqueue) * 1e3)
                if tele.trace.enabled:
                    span = f"ticket/{name}"
                    tele.trace.async_begin(span, ticket.seq,
                                           ts=ticket.t_enqueue,
                                           args={"cache_hit": True,
                                                 "epoch": st.epoch})
                    tele.trace.async_end(span, ticket.seq,
                                         ts=ticket.t_done)
                self._latencies.append((bi, ticket.t_enqueue, ticket.t_flush,
                                        ticket.t_dispatch, ticket.t_done))
                return ticket
            tele.count("cache_misses", template=name)

        self._queues.setdefault(bi, []).append(ticket)
        tele.gauge("queue_depth", len(self._queues[bi]), bucket=str(bi))
        if _pump:
            self.pump()
        return ticket

    def pump(self) -> int:
        """Advance the pipeline without blocking on new work.

        Cuts every full queue into "full" flushes (max_batch at a time),
        deadline-flushes every bucket whose oldest queued request's budget
        has expired (the *partial* bucket dispatch that bounds tail
        latency), and retires in-flight batches whose outputs have reached
        the host (their CUDA event has fired). Returns the number of
        requests completed by this call.
        """
        now = self.pipeline.clock()
        self._sync_queues()
        before = int(self.telemetry.total("served"))
        for bi in list(self._queues):
            while len(self._queues.get(bi, ())) >= self.pipeline.max_batch:
                self._flush(bi, "full", now, limit=self.pipeline.max_batch)
        for bi in list(self._queues):
            q = self._queues.get(bi)
            if not q:
                continue
            due = min((t.deadline_s for t in q if t.deadline_s is not None),
                      default=None)
            if due is not None and now >= due:
                self._flush(bi, "deadline", now)
        self._retire()
        self.telemetry.gauge("inflight", len(self._inflight))
        self._refresh_shard_load()
        return int(self.telemetry.total("served")) - before

    def drain(self) -> int:
        """Flush every queued request and retire all in-flight batches.

        The sync barrier: after drain() returns, every submitted Ticket is
        done, `queue_depth()` is 0, and nothing is in flight. Each bucket's
        remaining queue dispatches as one batch (reason "drain", however
        partial). Returns the number of requests completed by this call.
        With everything settled, the telemetry counter invariants are
        enforced (`Telemetry.check_invariants`) — a RuntimeError here
        means a serving-path accounting bug, not bad user input.
        """
        self.pipeline.clock()   # a barrier reads the clock on entry, as
        #                         submit and pump do
        self._sync_queues()
        before = int(self.telemetry.total("served"))
        while self._queues:
            now = self.pipeline.clock()
            for bi in list(self._queues):
                if self._queues.get(bi):
                    self._flush(bi, "drain", now)
        while self._inflight:
            self._complete(self._inflight.popleft())
        self.telemetry.gauge("inflight", 0)
        self._refresh_shard_load()
        self.telemetry.check_invariants()
        return int(self.telemetry.total("served")) - before

    def shutdown(self, grace_s: float = 2.0) -> dict:
        """Graceful-shutdown barrier with a bounded grace budget.

        Tries to drain normally for up to `grace_s` seconds on the
        pipeline clock; once the budget expires — or immediately when
        ``grace_s <= 0`` — every still-queued ticket resolves with a
        typed `ShutdownError` (counted as shed, so the telemetry
        invariants hold for the partial run). In-flight batches always
        complete: their work is already on the device. Returns
        {"drained": n, "shed": n}; the invariants are checked before
        returning, exactly as a full drain would.
        """
        clock = self.pipeline.clock
        deadline = clock() + max(0.0, grace_s)
        before = int(self.telemetry.total("served"))
        self._sync_queues()
        if grace_s > 0:
            while self._queues and clock() < deadline:
                now = clock()
                for bi in list(self._queues):
                    if self._queues.get(bi):
                        self._flush(bi, "drain", now)
                    if clock() >= deadline:
                        break
        shed_n = 0
        for bi in list(self._queues):
            for t in self._queues.pop(bi):
                self._resolve_error(
                    t, ShutdownError("server shutting down"), bi=bi)
                shed_n += 1
            self.telemetry.gauge("queue_depth", 0, bucket=str(bi))
        while self._inflight:
            self._complete(self._inflight.popleft())
        self.telemetry.gauge("inflight", 0)
        self._refresh_shard_load()
        self.telemetry.check_invariants()
        drained = int(self.telemetry.total("served")) - before - shed_n
        return {"drained": drained, "shed": shed_n}

    def queue_depth(self) -> int:
        """Requests enqueued but not yet flushed into a dispatch."""
        return sum(len(q) for q in self._queues.values())

    @property
    def n_inflight(self) -> int:
        """Batches dispatched to the device but not yet extracted."""
        return len(self._inflight)

    _LATENCY_KEYS = ("p50_ms", "p95_ms", "p99_ms", "mean_ms", "max_ms",
                     "queue_p99_ms", "service_p99_ms")

    @classmethod
    def _percentiles(cls, rows: list[tuple]) -> dict:
        """Percentile block for one group of (bi, te, tf, td, tdone) rows.

        Rows missing the flush stamp still contribute end-to-end latency
        but are excluded from the queue/service leg split.
        """
        te = np.asarray([r[1] for r in rows])
        tdone = np.asarray([r[4] for r in rows])
        total = (tdone - te) * 1e3
        out = {"n": len(rows),
               "p50_ms": float(np.percentile(total, 50)),
               "p95_ms": float(np.percentile(total, 95)),
               "p99_ms": float(np.percentile(total, 99)),
               "mean_ms": float(total.mean()),
               "max_ms": float(total.max()),
               "queue_p99_ms": 0.0, "service_p99_ms": 0.0}
        staged = [r for r in rows if r[2] is not None]
        if staged:
            queue = np.asarray([(r[2] - r[1]) for r in staged]) * 1e3
            service = np.asarray([(r[4] - r[2]) for r in staged]) * 1e3
            out["queue_p99_ms"] = float(np.percentile(queue, 99))
            out["service_p99_ms"] = float(np.percentile(service, 99))
        return out

    def latency_stats(self, *, per_bucket: bool = False) -> dict:
        """Latency percentiles over the recorded request lifecycle stamps.

        Covers every request completed since the last reset_stats()
        (answer-cache hits included). Returns n plus p50/p95/p99/mean/max
        end-to-end latency in ms, and p99 of the queue (enqueue->flush)
        and service (flush->done) legs; all zeros when nothing was
        recorded. Rows missing enqueue/done stamps are skipped; rows
        missing only the flush stamp fall out of the leg percentiles.

        per_bucket=True additionally returns a ``"per_bucket"`` dict
        mapping bucket index to the same percentile block over just that
        bucket's requests.
        """
        rows = [r for r in self._latencies
                if r[1] is not None and r[4] is not None]
        if not rows:
            out = {"n": 0, **{k: 0.0 for k in self._LATENCY_KEYS}}
            if per_bucket:
                out["per_bucket"] = {}
            return out
        out = self._percentiles(rows)
        if per_bucket:
            by_bucket: dict[int, list[tuple]] = {}
            for r in rows:
                by_bucket.setdefault(r[0], []).append(r)
            out["per_bucket"] = {bi: self._percentiles(rs)
                                 for bi, rs in sorted(by_bucket.items())}
        return out

    def _sync_queues(self) -> None:
        """Re-route queued requests after an epoch bump (lazy).

        migrate() rebuilds the buckets, so queue keys (bucket indices) and
        plan routing may be stale. Queued tickets are re-enqueued through
        the *new* epoch's route in submission order, keeping their
        enqueue timestamps and deadlines — a flush after the bump never
        dispatches a stale-epoch plan. In-flight batches are untouched.
        """
        if self._queues_epoch == self._state.epoch:
            return
        pending = sorted((t for q in self._queues.values() for t in q),
                         key=lambda t: t.seq)
        self._queues = {}
        for t in pending:
            bi, _ = self._state.route[t.name]
            self._queues.setdefault(bi, []).append(t)
        self._queues_epoch = self._state.epoch

    def _flush(self, bi: int, reason: str, now: float,
               limit: int | None = None) -> None:
        """Cut (up to limit of) bucket bi's queue into one engine dispatch.

        Stamps flush/dispatch times, dedups, pads the batch axis to a
        power of two (noop fillers), stages the batch onto the device
        (pinned, non-blocking), launches the engine, starts the outputs'
        copy to pinned host memory behind a CUDA event, and enqueues the
        in-flight record. Completes the oldest in-flight batch when
        max_inflight would be exceeded — the pipeline's backpressure, and
        its only wait besides drain(). A dispatch error propagates.
        """
        q = self._queues[bi]
        take, rest = (q[:limit], q[limit:]) if limit is not None \
            else (q, [])
        if rest:
            self._queues[bi] = rest
        else:
            del self._queues[bi]

        st = self._state
        tele = self.telemetry
        tr = tele.trace
        bucket = st.buckets[bi]
        b_lab = str(bi)
        tele.gauge("queue_depth", len(rest), bucket=b_lab)
        tele.count(f"flush_{reason}", bucket=b_lab)
        tele.observe("batch_fill_ratio",
                     len(take) / self.pipeline.max_batch, bucket=b_lab)
        for t in take:
            t.t_flush = now
            t.flush_reason = reason
        reqs = [(st.route[t.name][1], t.params) for t in take]
        if self.dedup:
            unique, inverse = dedup_requests(reqs, bucket.n_params)
        else:
            unique, inverse = reqs, None
        tele.observe("dedup_fanout", len(take) / len(unique), bucket=b_lab)
        fn = self._engine(bucket)
        t_stage = tr.clock() if tr.enabled else now
        pd, params = stage_batch(bucket, pad_requests_pow2(unique),
                                 device=self.device)
        t_call = tr.clock() if tr.enabled else now
        with tele.annotation(f"dispatch/bucket{bi}"):
            out = fetch_outputs(fn(st.tr, st.va, st.perms, pd, params))
        t_dispatch = self.pipeline.clock()
        if tr.enabled:
            lane = f"bucket{bi}"
            tr.complete(f"flush/{reason}", now, t_dispatch, tid=lane,
                        args={"n": len(take), "unique": len(unique),
                              "epoch": st.epoch})
            tr.complete("stage", t_stage, t_call, tid=lane)
            tr.complete("dispatch", t_call, t_dispatch, tid=lane)
        for t in take:
            t.t_dispatch = t_dispatch
            t.epoch = st.epoch
        self._inflight.append(_Inflight(bucket, bi, take, unique, inverse,
                                        out, st.epoch))
        while len(self._inflight) > self.pipeline.max_inflight:
            self._complete(self._inflight.popleft())
        tele.gauge("inflight", len(self._inflight))

    def _resolve_error(self, ticket: Ticket, err: Exception, *,
                       bi: int) -> None:
        """Resolve one ticket to a typed error result (counted as shed).

        The ticket completes like any served request — done flips, the
        latency is observed, the trace span closes — but `result` stays
        None and `error` carries the typed fault. `served` still counts
        it, keeping served == cache_hits + executed + deduped + shed.
        """
        now = self.pipeline.clock()
        ticket.error = err
        ticket.result = None
        ticket.done = True
        ticket.epoch = self._state.epoch
        ticket.t_done = now
        if ticket.flush_reason is None:
            ticket.flush_reason = "shed"
        tele = self.telemetry
        tele.count("served", template=ticket.name)
        tele.count("shed", template=ticket.name)
        tele.observe("request_latency_ms",
                     (now - ticket.t_enqueue) * 1e3)
        if tele.trace.enabled:
            span = f"ticket/{ticket.name}"
            tele.trace.async_begin(span, ticket.seq, ts=ticket.t_enqueue,
                                   args={"error": type(err).__name__,
                                         "epoch": ticket.epoch})
            tele.trace.async_end(span, ticket.seq, ts=now)
        self._latencies.append((bi, ticket.t_enqueue, ticket.t_flush,
                                ticket.t_dispatch, now))

    def _retire(self) -> int:
        """Complete in-flight batches whose outputs have reached the host.

        Only the queue head is eligible (completion order == dispatch
        order); its CUDA event is queried, never waited on, so a pump()
        between paced arrivals retires finished work early without
        blocking.
        """
        done = 0
        while self._inflight and self._inflight[0].out.ready():
            done += self._complete(self._inflight.popleft())
        return done

    def _complete(self, rec: _Inflight) -> int:
        """Extract one in-flight batch and deliver its results.

        Waits on the batch's CUDA event (a no-op once it has fired), runs
        the host-side extraction (per-unique np.unique, fan-out to
        duplicates) on the pinned host copies, stamps done-times, fills
        the answer cache (only when the serving epoch still matches the
        dispatch epoch — a migration mid-flight makes the answers stale
        before they land), and bumps the served/executed/deduped counters.
        Returns the delivered count.
        """
        tele = self.telemetry
        tr = tele.trace
        t_retire = tr.clock() if tr.enabled else None
        table, tmask, overflow = rec.out.wait()
        if rec.inverse is None:
            extracted = extract_batch(rec.bucket, rec.unique, table, tmask,
                                      overflow)
        else:
            extracted = extract_fanout(rec.bucket, rec.unique, rec.inverse,
                                       table, tmask, overflow)
        now = self.pipeline.clock()
        fill = (self.answer_cache_cap > 0 and not self._cache_bypass
                and rec.epoch == self._state.epoch)
        b_lab = str(rec.bi)
        tele.count("executed", len(rec.unique), bucket=b_lab)
        if len(rec.tickets) > len(rec.unique):
            tele.count("deduped", len(rec.tickets) - len(rec.unique),
                       bucket=b_lab)
        if tr.enabled:
            tr.complete("retire", t_retire, now, tid=f"bucket{rec.bi}",
                        args={"n": len(rec.tickets), "epoch": rec.epoch})
        for t, res in zip(rec.tickets, extracted):
            t.result = res
            t.t_done = now
            t.done = True
            tele.count("served", template=t.name)
            tele.observe("request_latency_ms",
                         (t.t_done - t.t_enqueue) * 1e3)
            if tr.enabled:
                span = f"ticket/{t.name}"
                tr.async_begin(span, t.seq, ts=t.t_enqueue,
                               args={"flush": t.flush_reason,
                                     "epoch": t.epoch})
                tr.async_end(span, t.seq, ts=t.t_done)
            self._latencies.append((rec.bi, t.t_enqueue, t.t_flush,
                                    t.t_dispatch, t.t_done))
            if fill:
                key = (t.name, canonical_params(t.params,
                                                rec.bucket.n_params))
                if key not in self._answers:
                    self._answers[key] = res
                    if len(self._answers) > self.answer_cache_cap:
                        self._answers.popitem(last=False)
        return len(rec.tickets)

    # ---- serving -------------------------------------------------------

    def serve(self, requests: list[tuple[str, np.ndarray | None]]):
        """Execute one batch of requests; results align with request order.

        A thin synchronous wrapper over the pipeline: every request is
        submitted (without intermediate flushes) and one drain() delivers
        them — each bucket appearing among the cache misses dispatches
        exactly once, in order of first appearance, identical instances
        collapse (dedup), and each result is (solutions, count, overflow).
        Raises KeyError / ValueError per submit().
        """
        tickets = [self.submit(name, pv, _pump=False)
                   for name, pv in requests]
        self.drain()
        return [t.result for t in tickets]

    def _engine(self, bucket):
        """The engine for `bucket` under this server's options.

        Publishes the EngineCache's LRU eviction delta (the cache may be
        shared across servers, so each server counts only what it saw
        grow)."""
        fn = self.cache.get(bucket.signature, join_impl=self.join_impl,
                            max_per_row=self.max_per_row,
                            gather_cap=self.gather_cap,
                            backend=self.backend,
                            kernel_blocks=self.kernel_blocks)
        ev = self.cache.evictions
        if ev > self._evictions_seen:
            self.telemetry.count("engine_cache_evictions",
                                 ev - self._evictions_seen)
            self._evictions_seen = ev
        return fn

    @contextmanager
    def tracking_paused(self):
        """Serve without feeding the workload tracker (warmup,
        steady-state timing)."""
        track, self._track = self._track, False
        try:
            yield self
        finally:
            self._track = track

    def warmup(self, requests) -> None:
        """Build every bucket engine the request stream touches. Warmup
        requests do not feed the workload tracker and bypass the answer
        cache entirely (no reads, no fills: a pre-warmed cache would make
        steady-state measurements all-hit)."""
        bypass, self._cache_bypass = self._cache_bypass, True
        try:
            with self.tracking_paused():
                self.serve(requests)
        finally:
            self._cache_bypass = bypass

    def reset_stats(self) -> None:
        """Zero every stats counter (and histogram), drop the recorded
        latencies, and clear the trace buffer — the steady-state
        measurement boundary after warmup. State gauges (epoch, cut
        collectives) persist: they describe the current serving state."""
        self.telemetry.reset_counters()
        self.telemetry.trace.clear()
        self._latencies.clear()


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


def drifting_stream(queries, phases: list[tuple[int, dict[str, float]]], *,
                    seed: int = 0) -> list[tuple[str, np.ndarray | None]]:
    """Concatenated weighted phases: [(n_requests, weights), ...] — the
    template mix shifts at each phase boundary. Per-phase seeds are spawned
    from one SeedSequence, so phase k of seed s never shares samples with
    phase k-1 of seed s+1."""
    out: list[tuple[str, np.ndarray | None]] = []
    children = np.random.SeedSequence(seed).spawn(len(phases))
    for (n, w), child in zip(phases, children):
        out.extend(request_stream(queries, n, weights=w, seed=child))
    return out


def two_phase_weights(queries) -> tuple[dict[str, float], dict[str, float]]:
    """A canonical drifting mix: phase A concentrates on the first half of
    the workload's templates, phase B on the second half (with a small
    residual mass everywhere, so both phases exercise all buckets)."""
    names = [q.name for q in queries]
    half = max(1, len(names) // 2)
    a = {n: (8.0 if i < half else 0.5) for i, n in enumerate(names)}
    b = {n: (0.5 if i < half else 8.0) for i, n in enumerate(names)}
    return a, b


def replay_paced(server: WorkloadServer, stream, arrival_s: float,
                 ) -> tuple[float, list[Ticket]]:
    """Feed `stream` through the pipeline at one request per `arrival_s`.

    The open-loop load generator of --pipeline: arrivals are paced on the
    server's pipeline clock (the offered load is fixed, not adapted to
    service speed), the server is pumped while waiting so deadline
    flushes and in-flight retirement happen on time, and a final drain()
    delivers everything. Returns (elapsed seconds, tickets).
    """
    clock = server.pipeline.clock
    tickets: list[Ticket] = []
    t0 = clock()
    t_next = t0
    for name, pv in stream:
        while True:
            now = clock()
            if now >= t_next:
                break
            server.pump()
            time.sleep(min(2e-4, t_next - now))
        tickets.append(server.submit(name, pv))
        t_next += arrival_s
    server.drain()
    return clock() - t0, tickets


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
                    help="requests per serve() call (and the pipeline's "
                         "full-flush threshold under --pipeline)")
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
    ap.add_argument("--pipeline", action="store_true",
                    help="serve through the continuous-batching pipeline "
                         "(submit/pump/drain) with paced arrivals and "
                         "deadline-based partial-bucket flushes, reporting "
                         "p50/p95/p99 latency instead of per-call times")
    ap.add_argument("--deadline-ms", type=float, default=25.0,
                    help="per-request latency budget under --pipeline: a "
                         "partial bucket dispatches when its oldest request "
                         "has waited this long (0 = fill-only batching, no "
                         "deadline flushes)")
    ap.add_argument("--arrival-ms", type=float, default=1.0,
                    help="inter-arrival gap of the paced open-loop stream "
                         "under --pipeline")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="record the request lifecycle and write a "
                         "Chrome-trace-event JSON file after serving")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write a metrics snapshot after serving: "
                         "Prometheus text exposition when PATH ends in "
                         ".prom, JSON otherwise")
    ap.add_argument("--grace-ms", type=float, default=2000.0,
                    help="graceful-shutdown budget on Ctrl-C: queued "
                         "requests get this long to drain before being "
                         "shed with a typed ShutdownError; --trace-out/"
                         "--metrics-out artifacts are still written")
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
    pipeline_cfg = PipelineConfig(
        deadline_ms=args.deadline_ms if args.deadline_ms > 0 else None,
        max_batch=args.batch)
    clock = pipeline_cfg.clock   # one timebase: partition timing, serving
    #                              timing, tickets and trace spans agree
    t0 = clock()
    part = build_partition(args.method, store, queries, args.n_shards)
    t_part = clock() - t0
    telemetry = Telemetry(trace=args.trace_out is not None,
                          annotate=args.profile is not None)
    server = WorkloadServer(queries, part, join_impl=args.join,
                            max_per_row=args.max_per_row or None,
                            dedup=not args.no_dedup, backend=args.backend,
                            answer_cache=not args.no_cache,
                            pipeline=pipeline_cfg, telemetry=telemetry,
                            device=device)
    print(f"{args.dataset}: {len(store):,} triples -> {part.n_shards} shards "
          f"{part.shard_sizes.tolist()} ({t_part:.1f}s partitioning), "
          f"{len(queries)} template queries in {server.n_buckets} buckets, "
          f"backend={args.backend}, device={device}")
    print(f"  per-bucket collective counts (WawPart cuts): "
          f"{server.collective_counts()}")

    # warmup, the serving loop and its report run under one try, so an
    # interrupt anywhere still shuts down gracefully and still writes the
    # --trace-out / --metrics-out artifacts (the finally)
    try:
        for i in range(0, len(stream), args.batch):
            server.warmup(stream[i:i + args.batch])
        if args.pipeline:
            # deadline flushes cut partial batches: warm the small
            # power-of-two batch shapes too
            for n in (1, 2, 4, 8, 16, 32):
                if n <= args.batch:
                    server.warmup(stream[:n])
        _sync(device)
        server.reset_stats()
        ops = kernel_ops()
        for op in ops.values():
            op.launches = 0
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        first = len(_trace_events(device)) if args.memory_peak else 0
        prof = _profiler(device) if args.profile else nullcontext()
        per_call = []
        with prof:
            if args.pipeline:
                dt, tickets = replay_paced(server, stream,
                                           args.arrival_ms / 1e3)
                results = [t.result for t in tickets]
            else:
                t0 = time.perf_counter()
                results = []
                for i in range(0, len(stream), args.batch):
                    t_call = time.perf_counter()
                    results += server.serve(stream[i:i + args.batch])
                    _sync(device)
                    per_call.append(time.perf_counter() - t_call)
                dt = time.perf_counter() - t0
        n_solutions = sum(res[1] for res in results)
        overflows = sum(bool(res[2]) for res in results)
        st = server.stats
        print(f"served {len(stream)} requests in {dt * 1e3:.1f} ms  "
              f"({len(stream) / dt:,.0f} queries/sec, batch={args.batch})")
        if per_call:
            print(f"  per serve() call: median "
                  f"{np.median(per_call) * 1e3:.3f} ms of {len(per_call)} "
                  f"{[round(t * 1e3, 3) for t in per_call]}")
        print(f"  kernel launches "
              f"{({k: op.launches for k, op in ops.items()})}")
        if device.type == "cuda":
            print(f"  peak device memory "
                  f"{torch.cuda.max_memory_allocated(device):,} bytes "
                  f"(torch.cuda.max_memory_allocated)")
        print(f"  solutions={n_solutions:,}  overflows={overflows}  "
              f"engines={server.n_compiles} (<= {server.n_buckets} buckets)"
              f"  dedup: {st['executed']}/{st['served']} instances executed")
        if args.pipeline:
            ls = server.latency_stats()
            print(f"  latency: p50={ls['p50_ms']:.3f} p95={ls['p95_ms']:.3f}"
                  f" p99={ls['p99_ms']:.3f} mean={ls['mean_ms']:.3f} ms, "
                  f"queue p99={ls['queue_p99_ms']:.3f} service p99="
                  f"{ls['service_p99_ms']:.3f} ms (arrival="
                  f"{args.arrival_ms}ms, deadline="
                  f"{args.deadline_ms or 'fill-only'}ms)")
            print(f"  flushes: full={st['flush_full']} "
                  f"deadline={st['flush_deadline']} "
                  f"drain={st['flush_drain']}  "
                  f"queue_depth={server.queue_depth()} "
                  f"inflight={server.n_inflight}")
        if st["cache_hits"] or st["cache_misses"]:
            total = st["cache_hits"] + st["cache_misses"]
            print(f"  answer cache: {st['cache_hits']}/{total} hits "
                  f"({st['cache_hits'] / max(1, total):.0%})")
        if args.check:
            from repro_torch.engine.oracle import evaluate_bgp
            by_name = {q.name: q for q in queries}
            oracle = {name: evaluate_bgp(
                store, by_name[name], order=server.plans[name].meta["order"])
                for name in {name for name, _ in stream}}
            agree = sum(np.array_equal(res[0], oracle[name])
                        for (name, _), res in zip(stream, results))
            print(f"  oracle: {agree}/{len(stream)} answers equal "
                  f"evaluate_bgp")
        if args.profile:
            _report_profile(prof, device, dt, args.profile)
        if args.memory_peak:
            events = _trace_events(device)
            torch.cuda.memory._record_memory_history(enabled=None)
            peak, n_live, groups = peak_blocks(events, first)
            print(f"  peak of the timed loop, replayed from {len(events):,} "
                  f"allocator events: {peak:,} bytes "
                  f"(torch.cuda.max_memory_allocated "
                  f"{torch.cuda.max_memory_allocated(device):,}) in "
                  f"{n_live:,} blocks, by the line that allocated them:")
            for where, (size, n) in sorted(groups.items(),
                                           key=lambda g: -g[1][0]):
                print(f"    {size:>14,} bytes {n:>5} blocks  {where}")
    except KeyboardInterrupt:
        out = server.shutdown(args.grace_ms / 1e3)
        print(f"\ninterrupted: drained {out['drained']} and shed "
              f"{out['shed']} queued requests within the "
              f"{args.grace_ms:g} ms grace budget; "
              f"served={server.stats['served']} total")
    finally:
        if args.trace_out:
            telemetry.dump_trace(args.trace_out)
            print(f"  trace: {len(telemetry.trace)} events "
                  f"({telemetry.trace.dropped} dropped) -> {args.trace_out}")
        if args.metrics_out:
            telemetry.dump_metrics(args.metrics_out)
            print(f"  metrics snapshot -> {args.metrics_out}")

if __name__ == "__main__":
    main()
