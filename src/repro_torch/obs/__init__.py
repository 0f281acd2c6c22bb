"""Observability: trace recorder, labeled metrics, serving telemetry.

Stdlib-only at import time (torch is only touched lazily by the profiler
annotation hook), so tooling can import the declared metric schema
without the accelerator stack.
"""
from .metrics import (CounterMetric, GaugeMetric, HistogramMetric,
                      MetricError, MetricsRegistry, parse_prometheus,
                      snapshot_delta)
from .telemetry import (COUNTER_NAMES, SERVING_SCHEMA, Telemetry,
                        serving_registry)
from .trace import DEFAULT_CLOCK, TraceRecorder

__all__ = [
    "CounterMetric", "GaugeMetric", "HistogramMetric", "MetricError",
    "MetricsRegistry", "parse_prometheus", "snapshot_delta",
    "COUNTER_NAMES", "SERVING_SCHEMA", "Telemetry", "serving_registry",
    "DEFAULT_CLOCK", "TraceRecorder",
]
