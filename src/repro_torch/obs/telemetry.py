"""Serving-stack telemetry: declared metric schema + Telemetry facade.

`SERVING_SCHEMA` is the single source of truth for every metric the
serving stack emits — name, kind, label names, help text, histogram
buckets. `serving_registry()` instantiates it; `tools/check_docs.py`
imports it (stdlib-only, no torch) to verify the documented metric table
in docs/observability.md matches what the code declares.

`Telemetry` bundles the registry with a `TraceRecorder` and the optional
`torch.profiler` annotation hook, and enforces the counter invariants from
docs/architecture.md ("Stats counters") via `check_invariants()` — the
serving pipeline calls it at `drain()`.
"""
from __future__ import annotations

from contextlib import contextmanager, nullcontext
from typing import Callable

from .metrics import MetricsRegistry, snapshot_delta
from .trace import DEFAULT_CLOCK, TraceRecorder

#: Declared serving metrics: (name, kind, labels, help[, buckets]).
#: `bucket` labels carry the batch-bucket signature index; `template`
#: labels carry the query-template name; `shard` labels a shard id.
SERVING_SCHEMA: tuple[tuple, ...] = (
    ("served", "counter", ("template",),
     "Requests answered (cache hits + executed + deduped)."),
    ("executed", "counter", ("bucket",),
     "Requests that ran as the unique row of a dispatched batch."),
    ("deduped", "counter", ("bucket",),
     "Requests answered by an identical in-batch row's result."),
    ("cache_hits", "counter", ("template",),
     "Requests answered from the epoch-versioned answer cache."),
    ("cache_misses", "counter", ("template",),
     "Cache lookups that missed (cache enabled only)."),
    ("flush_full", "counter", ("bucket",),
     "Bucket flushes triggered by a full batch."),
    ("flush_deadline", "counter", ("bucket",),
     "Bucket flushes triggered by the oldest ticket's deadline."),
    ("flush_drain", "counter", ("bucket",),
     "Partial-bucket flushes forced by drain()."),
    ("observed_cut_joins", "counter", ("template",),
     "Cut joins actually crossed by routed requests (plan cut_steps)."),
    ("drift_checks", "counter", ("severity",),
     "Drift verdicts by severity (none | incremental | full)."),
    ("epoch_bumps", "counter", ("kind",),
     "Serving-state swaps by kind (migrate | replicate | degrade | "
     "restore)."),
    ("retries", "counter", ("bucket",),
     "Tickets re-enqueued after a transient dispatch failure."),
    ("timeouts", "counter", ("template",),
     "Tickets resolved as errors past their absolute retry deadline."),
    ("shed", "counter", ("template",),
     "Tickets resolved with a typed error instead of an answer."),
    ("degraded_served", "counter", ("template",),
     "Requests served exactly from re-homed replicas while degraded."),
    ("shard_down", "counter", ("shard",),
     "Shard-down windows entered (degraded-mode activations)."),
    ("migration_aborts", "counter", (),
     "migrate() prepare phases rolled back before the epoch swap."),
    ("engine_cache_evictions", "counter", (),
     "Compiled engines evicted from the LRU-capped EngineCache."),
    ("queue_depth", "gauge", ("bucket",),
     "Tickets currently queued per bucket (set on enqueue/flush)."),
    ("inflight", "gauge", (),
     "Dispatched batches not yet retired."),
    ("epoch", "gauge", (),
     "Current serving-state epoch."),
    ("cut_collectives", "gauge", ("bucket",),
     "Collectives per dispatch for the bucket == WawPart cut count."),
    ("shard_requests", "gauge", ("shard",),
     "Requests in the tracker window touching the shard (live load)."),
    ("shard_load_imbalance", "gauge", (),
     "Max/mean of per-shard request touches over the tracker window."),
    ("engine_flops", "gauge", ("bucket",),
     "XLA cost_analysis FLOPs for the bucket's compiled engine."),
    ("engine_bytes", "gauge", ("bucket",),
     "XLA cost_analysis bytes accessed for the bucket's engine."),
    ("batch_fill_ratio", "histogram", ("bucket",),
     "Tickets per flush / max_batch.", (0.25, 0.5, 0.75, 1.0)),
    ("dedup_fanout", "histogram", ("bucket",),
     "Batch rows per unique request at dispatch.",
     (1.0, 2.0, 4.0, 8.0, 16.0, 32.0)),
    ("request_latency_ms", "histogram", (),
     "Enqueue-to-done latency per ticket, milliseconds.",
     (1.0, 2.5, 5.0, 10.0, 25.0, 50.0, 100.0, 250.0, 1000.0)),
)

#: The flat counter names whose totals back `WorkloadServer.stats`.
COUNTER_NAMES: tuple[str, ...] = tuple(
    name for name, kind, *_ in SERVING_SCHEMA if kind == "counter")


def serving_registry() -> MetricsRegistry:
    """A fresh registry with every `SERVING_SCHEMA` family declared."""
    reg = MetricsRegistry()
    for entry in SERVING_SCHEMA:
        name, kind, labels, help = entry[:4]
        if kind == "counter":
            reg.counter(name, help, labels)
        elif kind == "gauge":
            reg.gauge(name, help, labels)
        else:
            reg.histogram(name, help, labels, buckets=entry[4])
    return reg


class Telemetry:
    """Metrics + trace + profiler-annotation bundle for one server.

    Constructed cheaply with everything off by default: `trace=False`
    keeps the recorder disabled (no-op on every path), `annotate=False`
    keeps `annotation()` a nullcontext, and the metric registry is plain
    dict arithmetic. The serving pipeline calls `bind_clock()` with its
    injected clock so trace timestamps share the tickets' timebase.
    """

    def __init__(self, *, trace: bool = False, annotate: bool = False,
                 clock: Callable[[], float] | None = None,
                 max_events: int = 200_000) -> None:
        """Build the registry and recorder; `clock=None` defers the
        timebase to `bind_clock` (falling back to `DEFAULT_CLOCK`)."""
        self.registry = serving_registry()
        self._clock_pinned = clock is not None
        self.trace = TraceRecorder(clock or DEFAULT_CLOCK, enabled=trace,
                                   max_events=max_events)
        self.annotate = annotate

    def bind_clock(self, clock: Callable[[], float]) -> None:
        """Adopt the pipeline's injected clock unless the constructor
        already pinned one explicitly."""
        if not self._clock_pinned:
            self.trace.clock = clock

    # -- recording ---------------------------------------------------------

    def count(self, name: str, amount: float = 1, **labels) -> None:
        """Increment counter `name` by `amount` for `labels`."""
        self.registry[name].inc(amount, **labels)

    def gauge(self, name: str, value: float, **labels) -> None:
        """Set gauge `name` to `value` for `labels`."""
        self.registry[name].set(value, **labels)

    def observe(self, name: str, value: float, **labels) -> None:
        """Record `value` into histogram `name` for `labels`."""
        self.registry[name].observe(value, **labels)

    def total(self, name: str) -> float:
        """Counter total over all label sets (the flat-stats view)."""
        return self.registry.total(name)

    def reset_counters(self) -> None:
        """Zero counters and histograms (gauges are state, kept)."""
        self.registry.reset()

    # -- export ------------------------------------------------------------

    def snapshot(self) -> dict:
        """Current registry snapshot (JSON-ready)."""
        return self.registry.snapshot()

    def delta_since(self, old: dict) -> dict:
        """Counter/histogram delta of the current snapshot vs `old`."""
        return snapshot_delta(self.snapshot(), old)

    def dump_metrics(self, path: str) -> None:
        """Write the snapshot to `path` — Prometheus text exposition
        when the suffix is .prom, JSON otherwise."""
        text = (self.registry.to_prometheus() if path.endswith(".prom")
                else self.registry.to_json())
        with open(path, "w") as f:
            f.write(text)

    def dump_trace(self, path: str) -> None:
        """Write the Chrome trace-event JSON to `path`."""
        self.trace.dump(path)

    # -- profiler hook -----------------------------------------------------

    def annotation(self, name: str):
        """A `torch.profiler.record_function(name)` scope when annotation
        is on (imported lazily), else a free nullcontext."""
        if not self.annotate:
            return nullcontext()
        return _torch_annotation(name)

    # -- invariants --------------------------------------------------------

    def check_invariants(self) -> None:
        """Enforce the docs/architecture.md counter invariants.

        Raises `RuntimeError` if `served != cache_hits + executed +
        deduped + shed` (every served request is answered exactly one
        way — or rejected with exactly one typed error), if a timeout
        was counted without a matching shed, or if any counter total is
        negative.
        """
        totals = {n: self.total(n) for n in COUNTER_NAMES}
        negative = [n for n, v in totals.items() if v < 0]
        if negative:
            raise RuntimeError(f"telemetry invariant: negative counters "
                               f"{negative}")
        lhs = totals["served"]
        rhs = (totals["cache_hits"] + totals["executed"]
               + totals["deduped"] + totals["shed"])
        if lhs != rhs:
            raise RuntimeError(
                "telemetry invariant violated: served == cache_hits + "
                f"executed + deduped + shed ({lhs} != "
                f"{totals['cache_hits']} + {totals['executed']} + "
                f"{totals['deduped']} + {totals['shed']})")
        if totals["timeouts"] > totals["shed"]:
            raise RuntimeError(
                "telemetry invariant violated: every timeout is a shed "
                f"({totals['timeouts']} timeouts > {totals['shed']} shed)")


@contextmanager
def _torch_annotation(name: str):
    """Lazy `torch.profiler.record_function` so this module never imports
    torch at module scope (the docs gate imports the schema without it)."""
    from torch.profiler import record_function
    with record_function(name):
        yield
