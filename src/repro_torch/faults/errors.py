"""Typed fault taxonomy + the transient/permanent classifier.

Every error the recovery layer can hand back rides on `ServingFault`, so
callers distinguish "the serving stack degraded" from bad input with one
isinstance check. `classify` is the retry layer's single decision point:
transient errors are worth another dispatch, permanent ones are resolved
immediately (retrying a capacity overflow or a malformed request can
never succeed, it only burns the latency budget).
"""
from __future__ import annotations


class ServingFault(RuntimeError):
    """Base class for serving-stack fault conditions.

    A ticket resolved with a `ServingFault` has ``result=None`` and the
    fault instance on ``Ticket.error`` — a typed rejection, not a crash:
    ``drain()`` still completes and the counter invariant still holds
    (error-resolved tickets count under both ``served`` and ``shed``).
    """


class InjectedDispatchError(ServingFault):
    """A chaos-injected dispatch failure (always transient)."""


class ShardDownError(ServingFault):
    """The request's template cannot be served around the down shard —
    no live replica covers one of its routing units (shed fast)."""


class DeadlineExceededError(ServingFault):
    """The ticket's absolute retry deadline expired before a dispatch
    succeeded (counted under ``timeouts``)."""


class RetryExhaustedError(ServingFault):
    """Every retry attempt failed; the last underlying cause is chained
    via ``__cause__``."""


class MigrationAbortedError(ServingFault):
    """`migrate()` failed during its prepare phase and rolled back — the
    old epoch keeps serving, no state was swapped."""


class ShutdownError(ServingFault):
    """The server shut down before this queued ticket could dispatch
    (graceful-shutdown shedding past the grace budget)."""


#: Error types that can never succeed on retry. CapacityOverflowError is
#: resolved lazily by name to keep this module import-light (the engine
#: package pulls in torch).
_PERMANENT_TYPES = (ValueError, TypeError, KeyError, IndexError)
_PERMANENT_NAMES = frozenset({"CapacityOverflowError"})


def classify(err: BaseException) -> str:
    """``"transient"`` or ``"permanent"`` for one error instance.

    Injected faults and generic runtime failures are transient (a retry
    may land on a healthy window); input/validation errors and capacity
    overflows are permanent — re-dispatching identical work reproduces
    them exactly.
    """
    for klass in type(err).__mro__:
        if klass.__name__ in _PERMANENT_NAMES:
            return "permanent"
    if isinstance(err, ServingFault):
        return "transient"
    if isinstance(err, _PERMANENT_TYPES):
        return "permanent"
    return "transient"
