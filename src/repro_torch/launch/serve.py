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

--chaos SPEC arms seeded fault injection (failed dispatches, flush delays,
a shard-down window, migration aborts; see repro_torch.faults.FaultPlan)
with retries on unless --no-retry. --replicate copies the hottest safe cut
features onto their queries' primary shards after warmup. --adaptive
tracks the live template mix, detects drift and migrates shards under a
budget between batches; pair it with --drift, a two-phase stream whose mix
shifts halfway through.
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

from repro_torch.adaptive.controller import (AdaptiveConfig,
                                             AdaptiveController)
from repro_torch.adaptive.migrate import MigrationPlan
from repro_torch.adaptive.replicate import plan_hot_replication
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
from repro_torch.faults import (DeadlineExceededError, FaultInjector,
                                FaultPlan, MigrationAbortedError,
                                RetryExhaustedError, RetryPolicy,
                                ShardDownError, ShutdownError, classify,
                                degraded_placement, uncovered_templates)
from repro_torch.kg.generator import generate_bsbm, generate_lubm
from repro_torch.kg.workloads import bsbm_queries, lubm_queries
from repro_torch.obs import DEFAULT_CLOCK, Telemetry


class Counter(str, enum.Enum):
    """Every ``WorkloadServer.stats`` counter, by name (each member *is*
    its string value, so ``stats[Counter.SERVED]`` and ``stats["served"]``
    hit the same entry). ``stats`` is the flat view; the labeled
    per-bucket / per-template series live in the server's ``telemetry``
    registry. Invariant: served == cache_hits + executed + deduped + shed.
    retries, timeouts and shed move under a `RetryPolicy` and fault
    injection; degraded_served and shard_down while a shard is down
    (`mark_shard_down`); migration_aborts when a `migrate()` prepare rolls
    back."""

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

    ``attempts`` counts dispatch attempts under a RetryPolicy; a ticket
    that exhausts its budget (or hits a permanent fault, its absolute
    retry deadline, an uncovered degraded template, or a shutdown's grace
    budget) resolves with ``done=True``, ``result=None`` and the typed
    fault in ``error`` — callers distinguish answers from rejections by
    ``error is None``.
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
    degraded: bool = False            # dispatched while a shard was down


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
    shed: frozenset = frozenset()     # templates shed while degraded


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

    faults (a `FaultPlan` or `FaultInjector`, repro_torch.faults) arms
    seeded fault injection: dispatch failures, flush delays, shard-down
    windows and migration aborts. retry (a `RetryPolicy`) re-enqueues the
    tickets of a transiently failed flush at the queue front with
    decorrelated-jitter backoff; exhausted tickets resolve to typed errors.
    An injected failure fires before the batch is staged, so a failed
    attempt launches nothing, and its retry dispatches through the same
    engine and backend. With faults=None and retry=None no try wraps the
    dispatch. An error the card reports when a batch completes
    (`OutputFetch.ready` / `wait`) is not caught: it propagates out of
    pump() or drain().

    adaptive=True (or an `AdaptiveConfig`) attaches an
    `AdaptiveController`: every routed request feeds its sliding-window
    tracker, drift checks run after pump() completions and after serve(),
    and a detected drift triggers a budgeted repartition applied through
    `migrate()` while batches of the old epoch may still be in flight.
    `replicate_hot()` copies hot cut features onto their queries' primary
    shards; `mark_shard_down()` / `mark_shard_up()` serve around a down
    shard from its units' replicas. Each bumps the epoch.
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
                 telemetry: Telemetry | None = None, device="cuda",
                 faults: FaultPlan | FaultInjector | None = None,
                 retry: RetryPolicy | None = None, adaptive=None):
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

        self.retry = retry
        if faults is None or isinstance(faults, FaultInjector):
            self.faults = faults
        else:
            self.faults = FaultInjector(faults)
        self._retry_after: dict[int, float] = {}   # bucket -> backoff until
        self._backoff_prev: dict[int, float] = {}  # bucket -> last backoff
        self._degraded: int | None = None          # down shard, if any
        self._pre_degraded: _ServingState | None = None

        # the shard-load gauges read this tracker until an adaptive
        # controller attaches below; then its tracker (sized by the
        # adaptive window) takes over through the `tracker` property
        self._tracker = WorkloadTracker()
        self.adaptive = None

        plans = {q.name: make_plan(q, part,
                                   params=self.params_spec.get(q.name))
                 for q in self.queries}
        self._state = self._build_state(0, part, ShardedKG.build(part), plans)
        self._refresh_obs()

        if adaptive is not None and adaptive is not False:
            cfg = adaptive if isinstance(adaptive, AdaptiveConfig) else None
            self.adaptive = AdaptiveController(self, cfg)

    # ---- state ---------------------------------------------------------

    def _build_state(self, epoch: int, part: Partitioning, kg: ShardedKG,
                     plans: dict, shed: frozenset = frozenset(),
                     ) -> _ServingState:
        buckets = bucket_plans([plans[q.name] for q in self.queries])
        route: dict[str, tuple[int, int]] = {}
        for bi, b in enumerate(buckets):
            for pi, plan in enumerate(b.plans):
                route[plan.query.name] = (bi, pi)
        tr, va, pe = kg_tensors(kg, None, self.device)
        return _ServingState(epoch, part, kg, plans, buckets, route,
                             tr, va, pe, shed)

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
        """Serving epoch: bumped by every migrate()/replicate_hot() (and by
        mark_shard_down()/mark_shard_up() transitions)."""
        return self._state.epoch

    @property
    def degraded(self) -> int | None:
        """The down shard the server is currently serving around, or
        None when every shard is healthy."""
        return self._degraded

    @property
    def shed_templates(self) -> frozenset:
        """Templates rejected under the current epoch (no live replica
        coverage while degraded); empty when healthy."""
        return self._state.shed

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

    @property
    def tracker(self) -> WorkloadTracker:
        """The live workload tracker feeding the shard-load gauges: the
        adaptive controller's when one is attached, else the server's own,
        so the gauges are published either way."""
        if self.adaptive is not None:
            return self.adaptive.tracker
        return self._tracker

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
        passes through unchanged). Migration is refused while degraded — a
        placement computed against the healthy topology must not land
        while a shard is down — and an armed `FaultPlan.abort_migrations`
        aborts it after the KG deltas are applied.

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
            if self._degraded is not None:
                raise MigrationAbortedError(
                    f"migration refused while shard {self._degraded} is "
                    f"down (degraded placement is temporary)")
            mig = MigrationPlan.build(st.part, new_part)
            kg = mig.apply_kg(st.kg, new_part)
            if self.faults is not None:
                self.faults.check_migration_abort()
            same_catalog = new_part.catalog is st.part.catalog
            moved_units = set()
            if same_catalog:
                # a unit counts as moved when its set of copies changed:
                # a repartition drops the replicas replicate_hot() added,
                # and a plan that read a dropped copy on its primary shard
                # must gather again (the JAX package's migrate compares
                # primary homes only, and answers such plans from the
                # rows that are gone)
                keys = (set(st.part.unit_shard) | set(new_part.unit_shard)
                        | set(st.part.replicas) | set(new_part.replicas))
                moved_units = {u for u in keys
                               if st.part.unit_copies(u)
                               != new_part.unit_copies(u)}
            # same catalog => same unit_shard key set (incremental moves
            # reassign values only), so one placement's resolution covers
            # both sides of the move
            stale = {q.name for q in self.queries
                     if not same_catalog
                     or self._query_units(q, new_part) & moved_units}
            rewritten = len(stale)
            plans = self._replan(new_part, stale)
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
        self._swap_state(new_state)
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

    def _swap_state(self, new_state: _ServingState) -> None:
        """Commit an epoch bump: swap the serving state, drop the answer
        cache (one cache per epoch) and re-publish the state gauges."""
        self._state = new_state
        self._answers.clear()
        self._answers_epoch = new_state.epoch
        self._refresh_obs()

    def _replan(self, part: Partitioning, names, **kw) -> dict:
        """The current plans, with the templates in ``names`` re-planned on
        ``part`` at their old scan and table capacities (so surviving
        bucket signatures keep their engines)."""
        plans = dict(self._state.plans)
        for q in self.queries:
            if q.name in names:
                old = plans[q.name]
                plans[q.name] = make_plan(
                    q, part, params=self.params_spec.get(q.name),
                    capacities=([s.scan_cap for s in old.steps],
                                old.table_cap), **kw)
        return plans

    # ---- hot cut-edge replication --------------------------------------

    def replicate_hot(self, query_weights: dict[str, float] | None = None, *,
                      top_k: int = 4, budget_frac: float = 0.25) -> dict:
        """Replicate the workload's hottest safe cut features onto their
        queries' primary shards, removing those cross-shard gathers.

        query_weights defaults to the adaptive tracker's live window (when
        attached and non-empty), then the partitioning's recorded workload
        weights, then uniform; top_k bounds how many candidates are taken
        and budget_frac bounds replicated triples as a fraction of the
        store. The ShardedKG is rebuilt with the replica rows appended (the
        old block capacity kept when they fit, so unchanged engines keep
        their input shapes) and put on the device, only the affected
        queries re-plan (capacities reused), and the epoch bump swaps the
        state, drops the answer cache and re-routes queued requests.
        Results stay bit-identical: replication changes where a step's
        rows are read, never which rows exist.

        Returns a report dict: epoch, replicated_units/_triples,
        plans_rewritten, queries_affected, collectives_before/_after
        (per bucket), cap_grew.
        """
        st = self._state
        if query_weights is None and self.adaptive is not None:
            snap = self.adaptive.tracker.snapshot()
            if snap.total:
                query_weights = dict(snap.counts)
        if query_weights is None:
            # uniform when the partitioning was built without a recorded
            # workload mix (meta stores {} then)
            query_weights = st.part.meta.get("query_weights") or None

        report = plan_hot_replication(st.part, self.queries, query_weights,
                                      top_k=top_k, budget_frac=budget_frac)
        before = self.collective_counts()
        out = {"epoch": st.epoch, "replicated_units": 0,
               "replicated_triples": 0, "plans_rewritten": 0,
               "queries_affected": [],
               "collectives_before": before, "collectives_after": before,
               "cap_grew": False}
        if not report.replicas:
            return out

        new_part = st.part.with_replicas(report.replicas)
        kg = ShardedKG.build(new_part, min_cap=st.kg.cap)
        affected = {name for c in report.chosen for name in c.queries}
        plans = self._replan(new_part, affected)
        self._swap_state(self._build_state(st.epoch + 1, new_part, kg,
                                           plans))
        self.telemetry.count("epoch_bumps", kind="replicate")
        self.telemetry.trace.instant(
            "replication", args={"epoch": st.epoch + 1,
                                 "replicated_triples": report.total_triples})
        out.update(
            epoch=st.epoch + 1,
            replicated_units=sum(len(ts) for ts in report.replicas.values()),
            replicated_triples=report.total_triples,
            plans_rewritten=len(affected),
            queries_affected=sorted(affected),
            collectives_after=self.collective_counts(),
            cap_grew=kg.cap > st.kg.cap)
        return out

    # ---- degraded mode (shard down) -------------------------------------

    def mark_shard_down(self, shard: int) -> dict:
        """Enter degraded mode: serve around `shard` using live replicas.

        Builds the degraded primary-only placement (`degraded_placement`:
        units homed on the down shard re-home onto a live replica holder),
        re-plans every still-coverable template with the down shard
        forbidden as the plan's primary (capacities reused, and the block
        capacity kept, so surviving bucket signatures keep their engines),
        puts the degraded blocks on the device and swaps the state under a
        new epoch. Covered templates keep serving exactly. Templates that
        need a unit whose only copy was on the down shard go into the
        state's `shed` set: queued tickets for them resolve at once with
        `ShardDownError`, and new submits shed without queueing.

        The healthy state is kept verbatim, device tensors included, for
        `mark_shard_up()`; batches dispatched on either epoch hold their
        own state's tensors until they complete. Raises RuntimeError if
        already degraded (one down shard at a time) and ValueError for a
        shard outside the placement. Returns a report dict: epoch, shard,
        shed_templates, lost_units, rehomed_units.
        """
        if self._degraded is not None:
            raise RuntimeError(f"already degraded (shard {self._degraded} "
                               f"down); mark_shard_up() first")
        st = self._state
        tele = self.telemetry
        dpart, lost = degraded_placement(st.part, shard)
        shed = uncovered_templates(self.queries, dpart, lost)
        rehomed = sum(1 for u, s in st.part.unit_shard.items()
                      if s == shard and dpart.unit_shard[u] != shard)
        # a shed template keeps its old plan, so buckets and route still
        # cover it (the shed check fires before any dispatch can reach it)
        plans = self._replan(dpart, {q.name for q in self.queries} - shed,
                             forbid_ppn=frozenset({shard}))
        kg = ShardedKG.build(dpart, min_cap=st.kg.cap)
        new_state = self._build_state(st.epoch + 1, dpart, kg, plans,
                                      shed=shed)
        self._pre_degraded = st
        self._degraded = shard
        self._retry_after.clear()  # backoff lanes are per-epoch buckets
        self._backoff_prev.clear()
        self._swap_state(new_state)
        tele.count("epoch_bumps", kind="degrade")
        tele.count("shard_down", shard=str(shard))
        tele.trace.instant("shard_down",
                           args={"shard": shard, "epoch": new_state.epoch,
                                 "shed_templates": len(shed)})
        # already-queued tickets for uncovered templates shed now — they
        # can never dispatch under this epoch
        self._sync_queues()
        for bi in list(self._queues):
            keep = [t for t in self._queues[bi] if t.name not in shed]
            for t in self._queues[bi]:
                if t.name in shed:
                    self._resolve_error(
                        t, ShardDownError(
                            f"template {t.name!r} has no live replica "
                            f"coverage with shard {shard} down"), bi=bi)
            if keep:
                self._queues[bi] = keep
            else:
                del self._queues[bi]
            tele.gauge("queue_depth", len(keep), bucket=str(bi))
        return {"epoch": new_state.epoch, "shard": shard,
                "shed_templates": sorted(shed), "lost_units": len(lost),
                "rehomed_units": rehomed}

    def mark_shard_up(self) -> dict | None:
        """Leave degraded mode: restore the saved healthy state.

        The healthy placement, blocks (already on the device), plans and
        buckets swap back under a new epoch (`epoch_bumps{kind=restore}`):
        the bucket signatures are the healthy ones, so the EngineCache
        serves every engine without building one. Queued tickets re-route
        lazily (`_sync_queues`) and the answer cache drops. No-op
        returning None when not degraded.
        """
        if self._degraded is None:
            return None
        new_state = self._pre_degraded._replace(epoch=self._state.epoch + 1)
        self._degraded = None
        self._pre_degraded = None
        self._retry_after.clear()
        self._backoff_prev.clear()
        self._swap_state(new_state)
        self.telemetry.count("epoch_bumps", kind="restore")
        self.telemetry.trace.instant("shard_up",
                                     args={"epoch": new_state.epoch})
        return {"epoch": new_state.epoch}

    def _poll_faults(self, now: float) -> None:
        """Drive injector-scheduled shard-down windows off the clock.

        Called at the top of submit/pump/drain: enters degraded mode when
        a window opens, restores when it closes (windows are relative to
        the injector's arming — its first poll).
        """
        inj = self.faults
        if inj is None or not inj.enabled:
            return
        down = inj.shard_down_now(now)
        if down == self._degraded:
            return
        if self._degraded is not None:
            self.mark_shard_up()
        if down is not None:
            inj.injected["shard_down"] += 1
            self.mark_shard_down(down)

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

        While degraded (a shard down), a template in the state's shed set
        returns an already-done Ticket carrying a `ShardDownError` — the
        fast typed rejection — instead of queueing work that could never
        dispatch exactly.
        """
        now = self.pipeline.clock()
        self._poll_faults(now)
        self._sync_queues()
        st = self._state
        tele = self.telemetry
        bi, pi = st.route[name]
        plan = st.buckets[bi].plans[pi]
        # cache hits still feed the tracker: drift detection and the load
        # gauges must see the real mix even at high hit rates
        if self._track:
            if self.adaptive is not None:
                self.adaptive.record(name, plan)
            else:
                self._tracker.observe(name, cut_joins=len(plan.cut_steps),
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

        if st.shed and name in st.shed:
            self._resolve_error(
                ticket, ShardDownError(
                    f"template {name!r} has no live replica coverage "
                    f"with shard {self._degraded} down"), bi=bi)
            return ticket

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
        requests completed by this call, and runs the adaptive drift check
        after completions.

        A bucket inside its retry backoff window (a transient dispatch
        failure re-enqueued its tickets) or an injected flush-delay window
        is skipped this pump — its tickets dispatch on a later pump or at
        drain().
        """
        now = self.pipeline.clock()
        self._poll_faults(now)
        self._sync_queues()
        before = int(self.telemetry.total("served"))
        for bi in list(self._queues):
            while (len(self._queues.get(bi, ())) >= self.pipeline.max_batch
                   and not self._held(bi, now)):
                self._flush(bi, "full", now, limit=self.pipeline.max_batch)
        for bi in list(self._queues):
            q = self._queues.get(bi)
            if not q or self._held(bi, now):
                continue
            due = min((t.deadline_s for t in q if t.deadline_s is not None),
                      default=None)
            if due is not None and now >= due:
                self._flush(bi, "deadline", now)
        self._retire()
        self.telemetry.gauge("inflight", len(self._inflight))
        self._refresh_shard_load()
        done = int(self.telemetry.total("served")) - before
        if done and self.adaptive is not None and self._track:
            self.adaptive.maybe_adapt()
        return done

    def drain(self) -> int:
        """Flush every queued request and retire all in-flight batches.

        The sync barrier: after drain() returns, every submitted Ticket is
        done, `queue_depth()` is 0, and nothing is in flight. Each bucket's
        remaining queue dispatches as one batch (reason "drain", however
        partial). Returns the number of requests completed by this call.
        With everything settled, the telemetry counter invariants are
        enforced (`Telemetry.check_invariants`) — a RuntimeError here
        means a serving-path accounting bug, not bad user input.

        Under fault injection and retry, drain ignores backoff and
        flush-delay windows (it is the barrier) and flushes until the
        queues are empty: every re-enqueued ticket either dispatches or
        exhausts its attempts into a typed error, so the retry budget
        bounds the rounds.
        """
        self._poll_faults(self.pipeline.clock())
        self._sync_queues()
        before = int(self.telemetry.total("served"))
        rounds = 0
        while self._queues:
            now = self.pipeline.clock()
            for bi in list(self._queues):
                if self._queues.get(bi):
                    self._flush(bi, "drain", now)
            rounds += 1
            if rounds > 100_000:
                raise RuntimeError("drain() made no progress after "
                                   "100000 flush rounds")
        while self._inflight:
            self._complete(self._inflight.popleft())
        self.telemetry.gauge("inflight", 0)
        self._refresh_shard_load()
        self.telemetry.check_invariants()
        return int(self.telemetry.total("served")) - before

    def shutdown(self, grace_s: float = 2.0) -> dict:
        """Graceful-shutdown barrier with a bounded grace budget.

        Tries to drain normally for up to `grace_s` seconds on the
        pipeline clock (backoff and delay windows are ignored, like
        drain); once the budget expires — or immediately when
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
            rounds = 0
            while self._queues and clock() < deadline:
                now = clock()
                for bi in list(self._queues):
                    if self._queues.get(bi):
                        self._flush(bi, "drain", now)
                    if clock() >= deadline:
                        break
                rounds += 1
                if rounds > 100_000:
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
        its only wait besides drain().

        Without faults or a retry policy a dispatch error propagates. With
        either, the injector's draw, the staging, the launches and the
        start of the copies sit in one try: a failure leaves no in-flight
        record and goes to `_flush_failed`. The injected draw comes first,
        so an injected failure stages and launches nothing.
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
        if self.faults is None and self.retry is None:
            pd, params = stage_batch(bucket, pad_requests_pow2(unique),
                                     device=self.device)
            t_call = tr.clock() if tr.enabled else now
            with tele.annotation(f"dispatch/bucket{bi}"):
                out = fetch_outputs(fn(st.tr, st.va, st.perms, pd, params))
        else:
            try:
                if self.faults is not None:
                    self.faults.on_dispatch(bi)
                pd, params = stage_batch(bucket, pad_requests_pow2(unique),
                                         device=self.device)
                t_call = tr.clock() if tr.enabled else now
                with tele.annotation(f"dispatch/bucket{bi}"):
                    out = fetch_outputs(fn(st.tr, st.va, st.perms, pd,
                                           params))
            except Exception as exc:
                self._flush_failed(bi, take, exc, now)
                return
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
                                        out, st.epoch,
                                        self._degraded is not None))
        while len(self._inflight) > self.pipeline.max_inflight:
            self._complete(self._inflight.popleft())
        tele.gauge("inflight", len(self._inflight))

    def _held(self, bi: int, now: float) -> bool:
        """Whether pump() skips bucket bi at `now`: it sits inside its
        retry backoff window or an injected flush-delay window."""
        return (self._retry_after.get(bi, 0.0) > now
                or (self.faults is not None
                    and self.faults.flush_delayed(bi, now)))

    def _resolve_error(self, ticket: Ticket, err: Exception, *, bi: int,
                       timeout: bool = False) -> None:
        """Resolve one ticket to a typed error result (counted as shed,
        and as a timeout with ``timeout``).

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
        if timeout:
            tele.count("timeouts", template=ticket.name)
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

    def _flush_failed(self, bi: int, take: list[Ticket], exc: Exception,
                      now: float) -> None:
        """Recover from a failed dispatch of bucket bi's cut tickets.

        `classify` splits the world in two: a *permanent* fault
        (CapacityOverflowError, bad-input errors) — or any fault with no
        RetryPolicy attached — resolves every ticket in the cut to a typed
        error at once. A *transient* fault (a `RuntimeError`, the CUDA
        out-of-memory error among them) re-enqueues the surviving tickets
        at the *front* of the bucket's queue (their seq order is kept, so
        epoch order and re-routing stay right) and arms a backoff window
        for the bucket; tickets past the policy's absolute deadline
        resolve as timeouts, tickets out of attempts as
        RetryExhaustedError.
        """
        tele = self.telemetry
        kind = classify(exc)
        if tele.trace.enabled:
            tele.trace.instant("dispatch_fault",
                               args={"bucket": bi, "kind": kind,
                                     "error": type(exc).__name__})
        policy = self.retry
        if kind == "permanent" or policy is None:
            for t in take:
                t.attempts += 1
                self._resolve_error(t, exc, bi=bi)
            return
        survivors: list[Ticket] = []
        for t in take:
            t.attempts += 1
            hard = None if policy.deadline_ms is None \
                else t.t_enqueue + policy.deadline_ms / 1e3
            if hard is not None and now >= hard:
                self._resolve_error(
                    t, DeadlineExceededError(
                        f"{t.name!r} past its {policy.deadline_ms:g} ms "
                        f"retry deadline after {t.attempts} attempts"),
                    bi=bi, timeout=True)
            elif t.attempts >= policy.max_attempts:
                err = RetryExhaustedError(
                    f"{t.attempts} dispatch attempts failed for "
                    f"{t.name!r}: {exc}")
                err.__cause__ = exc
                self._resolve_error(t, err, bi=bi)
            else:
                survivors.append(t)
        if not survivors:
            return
        tele.count("retries", len(survivors), bucket=str(bi))
        # front of the queue: a retried ticket never reorders behind
        # requests submitted after it (take was cut in seq order)
        self._queues[bi] = survivors + self._queues.get(bi, [])
        tele.gauge("queue_depth", len(self._queues[bi]), bucket=str(bi))
        back = policy.backoff_s(max(t.attempts for t in survivors),
                                self._backoff_prev.get(bi))
        self._backoff_prev[bi] = back
        self._retry_after[bi] = now + back

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
            if rec.degraded:
                tele.count("degraded_served", template=t.name)
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
        collapse (dedup), and each result is (solutions, count, overflow),
        or None for a request resolved with a typed error. With adaptivity
        on, a drift check (and possibly a migration) runs after the batch
        completes. Raises KeyError / ValueError per submit().
        """
        tickets = [self.submit(name, pv, _pump=False)
                   for name, pv in requests]
        self.drain()
        if self.adaptive is not None and self._track:
            self.adaptive.maybe_adapt()
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
        """Serve without feeding the workload tracker or running drift
        checks (warmup, steady-state timing)."""
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


def build_partition(method: str, store, queries, n_shards: int,
                    query_weights: dict[str, float] | None = None):
    """Partition `store` by method: "wawpart" | "random" | "centralized"."""
    if method == "wawpart":
        return wawpart_partition(store, queries, n_shards=n_shards,
                                 query_weights=query_weights)
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
    ap.add_argument("--replicate", action="store_true",
                    help="after warmup, replicate the hottest safe cut "
                         "features onto their queries' primary shards "
                         "(removes those cross-shard gathers)")
    ap.add_argument("--adaptive", action="store_true",
                    help="track the live workload, detect drift, and migrate "
                         "shards under a budget between batches")
    ap.add_argument("--drift", action="store_true",
                    help="serve a two-phase stream whose template mix shifts "
                         "halfway (instead of round-robin)")
    ap.add_argument("--seed", type=int, default=0,
                    help="stream sampling seed (the --drift stream)")
    ap.add_argument("--chaos", default=None, metavar="SPEC",
                    help="arm seeded fault injection, e.g. "
                         "'dispatch=0.1/4,down=1@0.2:0.6,seed=7' (see "
                         "repro_torch.faults.FaultPlan.parse); transient "
                         "failures are retried unless --no-retry")
    ap.add_argument("--no-retry", action="store_true",
                    help="no RetryPolicy under --chaos: a failed dispatch "
                         "resolves its tickets with typed errors on the "
                         "first attempt")
    args = ap.parse_args(argv)
    if args.batch < 1:
        ap.error("--batch must be >= 1")
    device = resolve_device(args.device)
    if args.memory_peak:
        if device.type != "cuda":
            ap.error("--memory-peak needs a CUDA device")
        torch.cuda.memory._record_memory_history(stacks="python")

    store, queries = build_dataset(args.dataset, args.scale)
    phase_a_weights = None
    if args.drift:
        phase_a_weights, wb = two_phase_weights(queries)
        half = args.requests // 2
        stream = drifting_stream(
            queries, [(half, phase_a_weights), (args.requests - half, wb)],
            seed=args.seed)
    else:
        stream = request_stream(queries, args.requests)
    pipeline_cfg = PipelineConfig(
        deadline_ms=args.deadline_ms if args.deadline_ms > 0 else None,
        max_batch=args.batch)
    clock = pipeline_cfg.clock   # one timebase: partition timing, serving
    #                              timing, tickets and trace spans agree
    t0 = clock()
    part = build_partition(args.method, store, queries, args.n_shards,
                           query_weights=phase_a_weights)
    t_part = clock() - t0
    adaptive = None
    if args.adaptive:
        adaptive = AdaptiveConfig(window=max(64, args.batch * 4),
                                  check_every=args.batch,
                                  min_requests=min(64, args.batch))
    telemetry = Telemetry(trace=args.trace_out is not None,
                          annotate=args.profile is not None)
    fault_plan = FaultPlan.parse(args.chaos) if args.chaos else None
    retry = RetryPolicy() if (fault_plan is not None
                              and not args.no_retry) else None
    server = WorkloadServer(queries, part, join_impl=args.join,
                            max_per_row=args.max_per_row or None,
                            dedup=not args.no_dedup, backend=args.backend,
                            answer_cache=not args.no_cache,
                            pipeline=pipeline_cfg, telemetry=telemetry,
                            device=device, faults=fault_plan, retry=retry,
                            adaptive=adaptive)
    print(f"{args.dataset}: {len(store):,} triples -> {part.n_shards} shards "
          f"{part.shard_sizes.tolist()} ({t_part:.1f}s partitioning), "
          f"{len(queries)} template queries in {server.n_buckets} buckets, "
          f"backend={args.backend}, device={device}"
          + (", adaptive" if args.adaptive else ""))
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
        if args.replicate:
            rep = server.replicate_hot()
            print(f"  replicated {rep['replicated_units']} unit copies "
                  f"({rep['replicated_triples']} triples), rewrote "
                  f"{rep['plans_rewritten']} plans; collectives "
                  f"{rep['collectives_before']} -> "
                  f"{rep['collectives_after']}, cap grew "
                  f"{rep['cap_grew']}")
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
        answered = [res for res in results if res is not None]
        n_solutions = sum(res[1] for res in answered)
        overflows = sum(bool(res[2]) for res in answered)
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
        per_epoch = "" if server.epoch \
            else f" (<= {server.n_buckets} buckets)"
        print(f"  solutions={n_solutions:,}  overflows={overflows}  "
              f"engines={server.n_compiles}{per_epoch}"
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
        if server.faults is not None and server.faults.enabled:
            inj = server.faults.injected
            print(f"  chaos: injected dispatch_failures={inj['dispatch']} "
                  f"shard_down={inj['shard_down']}; recovered "
                  f"retries={st['retries']} shed={st['shed']} "
                  f"timeouts={st['timeouts']} "
                  f"degraded_served={st['degraded_served']}")
        if st["cache_hits"] or st["cache_misses"]:
            total = st["cache_hits"] + st["cache_misses"]
            print(f"  answer cache: {st['cache_hits']}/{total} hits "
                  f"({st['cache_hits'] / max(1, total):.0%})")
        if server.adaptive is not None:
            print(f"  adaptive: epoch={server.epoch}, "
                  f"{server.adaptive.n_migrations} migrations")
            for ev in server.adaptive.events:
                mig = ev.migration or {}
                print(f"    [{ev.severity}] divergence={ev.divergence:.3f} "
                      f"mode={ev.mode} moved={ev.moved_triples}"
                      f"/{ev.budget_triples} budget, "
                      f"cost {ev.cost_before:.0f}->{ev.cost_after:.0f}"
                      + (f", rewrote {mig['plans_rewritten']} plans, "
                         f"reused {mig['signatures_reused']} engine sigs"
                         if mig else ""))
        if args.check:
            from repro_torch.engine.oracle import evaluate_bgp
            by_name = {q.name: q for q in queries}
            oracle = {name: evaluate_bgp(
                store, by_name[name], order=server.plans[name].meta["order"])
                for name in {name for name, _ in stream}}
            agree = sum(res is not None and np.array_equal(res[0],
                                                           oracle[name])
                        for (name, _), res in zip(stream, results))
            print(f"  oracle: {agree}/{len(answered)} answers equal "
                  f"evaluate_bgp ({len(stream) - len(answered)} resolved "
                  f"with a typed error)")
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
