"""Fault tolerance for the serving stack: deterministic chaos injection
and the recovery policies that absorb it.

* :mod:`repro_torch.faults.errors` — the typed fault taxonomy and the
  transient-vs-permanent classifier the retry layer consults;
* :mod:`repro_torch.faults.inject` — a seeded :class:`FaultPlan` /
  :class:`FaultInjector` pair (driven by the pipeline's injectable clock)
  that can fail a dispatch, delay a bucket flush, mark a shard down for a
  window, or abort a migration mid-prepare — strictly a no-op when
  disabled;
* :mod:`repro_torch.faults.retry` — :class:`RetryPolicy`, exponential
  backoff with decorrelated jitter plus per-ticket absolute deadlines;
* :mod:`repro_torch.faults.degraded` — replica-aware degraded placement:
  when a shard is down, units with live replica copies re-home so covered
  templates keep serving exactly, uncovered ones shed fast.

``WorkloadServer(faults=..., retry=...)`` threads all four through the
continuous-batching pipeline; ``python -m repro_torch.launch.serve --chaos
SPEC`` does the same from the CLI. An injected dispatch failure fires
before the batch is staged, so a failed attempt launches nothing on the
card, and a retry goes through the same engine and kernels.
"""
from .errors import (DeadlineExceededError, InjectedDispatchError,
                     MigrationAbortedError, RetryExhaustedError,
                     ServingFault, ShardDownError, ShutdownError, classify)
from .inject import FaultInjector, FaultPlan
from .retry import RetryPolicy
from .degraded import degraded_placement, uncovered_templates

__all__ = [
    "ServingFault", "InjectedDispatchError", "ShardDownError",
    "DeadlineExceededError", "RetryExhaustedError", "MigrationAbortedError",
    "ShutdownError", "classify",
    "FaultPlan", "FaultInjector",
    "RetryPolicy",
    "degraded_placement", "uncovered_templates",
]
