"""Fault taxonomy for the serving stack.

:mod:`repro_torch.faults.errors` holds the typed errors the serving
pipeline resolves tickets with (``ShutdownError`` past a shutdown's grace
budget, ``MigrationAbortedError`` when ``migrate()`` rolls back) and the
transient-vs-permanent classifier a retry layer consults. Injection,
retry and degraded mode are not part of the port yet.
"""
from .errors import (DeadlineExceededError, InjectedDispatchError,
                     MigrationAbortedError, RetryExhaustedError,
                     ServingFault, ShardDownError, ShutdownError, classify)

__all__ = [
    "ServingFault", "InjectedDispatchError", "ShardDownError",
    "DeadlineExceededError", "RetryExhaustedError", "MigrationAbortedError",
    "ShutdownError", "classify",
]
