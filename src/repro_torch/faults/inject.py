"""Seeded chaos: a declarative FaultPlan and its runtime FaultInjector.

The plan is a frozen value object describing *what* goes wrong and when
(dispatch-failure rate, flush-delay windows, a shard-down window, pending
migration aborts); the injector is the small stateful runtime the server
polls on its own injectable clock. Time windows are relative to the
injector's arming instant — the first serving activity the server polls
it with — so one plan works under both real and fake clocks.

Determinism: the dispatch-failure draw is a seeded PRNG stream, so two
runs of the same plan against the same request stream inject the exact
same faults — the chaos differential test relies on this to assert
bit-identical recovered answers.

With ``plan=None`` (or an all-zero plan) every hook is a no-op: the
fault-free pipeline is bit-identical with and without an injector
installed.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .errors import InjectedDispatchError, MigrationAbortedError


def _windows(spec: str) -> tuple[tuple[float, float], ...]:
    """Parse ``t0:t1[;t0:t1...]`` into (start, end) second windows."""
    out = []
    for w in spec.split(";"):
        t0, t1 = w.split(":")
        out.append((float(t0), float(t1)))
    return tuple(out)


@dataclass(frozen=True)
class FaultPlan:
    """Declarative, seeded fault schedule (strictly no-op when empty).

    dispatch_fail_rate: probability each engine dispatch fails with an
        `InjectedDispatchError` (seeded draw — deterministic sequence).
    max_dispatch_failures: hard cap on injected dispatch failures
        (``None`` = unlimited); rate=1.0 with a cap of N fails exactly
        the first N dispatches, the deterministic shape tests use.
    flush_delay: ``(t0, t1)`` windows (seconds since arming) during
        which deadline flushes are held back — queued work waits out the
        window instead of dispatching (results unchanged, latency not).
    shard_down: ``(shard, t0, t1)`` windows during which the shard is
        marked down; the server enters replica-degraded mode for the
        window and restores afterwards.
    abort_migrations: abort the next N `migrate()` calls mid-prepare
        with a `MigrationAbortedError` (the rollback differential).
    seed: PRNG seed for the dispatch-failure draw.
    """

    seed: int = 0
    dispatch_fail_rate: float = 0.0
    max_dispatch_failures: int | None = None
    flush_delay: tuple[tuple[float, float], ...] = ()
    shard_down: tuple[tuple[int, float, float], ...] = ()
    abort_migrations: int = 0

    @property
    def empty(self) -> bool:
        """True when this plan injects nothing (the strict no-op case)."""
        return (self.dispatch_fail_rate <= 0 and not self.flush_delay
                and not self.shard_down and self.abort_migrations <= 0)

    @staticmethod
    def parse(spec: str) -> "FaultPlan":
        """Build a plan from a ``serve.py --chaos`` spec string.

        Comma-separated ``key=value`` clauses:
          ``dispatch=RATE[/MAX]`` — dispatch-failure rate (optional cap),
          ``down=SHARD@T0:T1``   — shard-down window (seconds),
          ``delay=T0:T1[;...]``  — flush-delay window(s),
          ``abort=N``            — abort the next N migrations,
          ``seed=N``             — injection seed.
        Example: ``--chaos "dispatch=0.2,down=1@0.5:2.0,seed=7"``.
        Raises ValueError on an unknown key or malformed clause.
        """
        kw: dict = {}
        for clause in filter(None, (c.strip() for c in spec.split(","))):
            try:
                key, val = clause.split("=", 1)
            except ValueError:
                raise ValueError(f"chaos clause {clause!r} is not key=value")
            if key == "dispatch":
                rate, _, cap = val.partition("/")
                kw["dispatch_fail_rate"] = float(rate)
                if cap:
                    kw["max_dispatch_failures"] = int(cap)
            elif key == "down":
                shard, _, win = val.partition("@")
                t0, t1 = win.split(":")
                kw.setdefault("shard_down", [])
                kw["shard_down"] = tuple(kw.get("shard_down", ())) + (
                    (int(shard), float(t0), float(t1)),)
            elif key == "delay":
                kw["flush_delay"] = _windows(val)
            elif key == "abort":
                kw["abort_migrations"] = int(val)
            elif key == "seed":
                kw["seed"] = int(val)
            else:
                raise ValueError(f"unknown chaos key {key!r} in {clause!r}")
        return FaultPlan(**kw)


@dataclass
class FaultInjector:
    """Stateful runtime for one FaultPlan (server-polled, clock-driven).

    The server calls the hooks below from its pipeline path; each is a
    cheap no-op when the plan injects nothing. `injected` tallies what
    actually fired, per kind — the chaos tests and the smoke run read it to
    assert the schedule really ran.
    """

    plan: FaultPlan | None = None
    injected: dict = field(default_factory=lambda: {
        "dispatch": 0, "shard_down": 0, "migration_abort": 0})
    _t0: float | None = None
    _aborts_left: int = 0
    _rng: np.random.Generator = None

    def __post_init__(self):
        """Seed the dispatch-failure stream and arm the abort budget."""
        if self.plan is None:
            self.plan = FaultPlan()
        self._aborts_left = self.plan.abort_migrations
        self._rng = np.random.default_rng(self.plan.seed)

    @property
    def enabled(self) -> bool:
        """Whether this injector can fire anything at all."""
        return not self.plan.empty

    def _elapsed(self, now: float) -> float:
        """Seconds since arming; the first poll arms the schedule."""
        if self._t0 is None:
            self._t0 = now
        return now - self._t0

    # ---- hooks the server calls -----------------------------------------

    def observe(self, now: float) -> None:
        """Arm the schedule on first serving activity (idempotent)."""
        self._elapsed(now)

    def on_dispatch(self, bucket: int) -> None:
        """Raise `InjectedDispatchError` when the seeded draw says so."""
        plan = self.plan
        if plan.dispatch_fail_rate <= 0:
            return
        if (plan.max_dispatch_failures is not None
                and self.injected["dispatch"] >= plan.max_dispatch_failures):
            return
        if self._rng.random() < plan.dispatch_fail_rate:
            self.injected["dispatch"] += 1
            raise InjectedDispatchError(
                f"injected dispatch failure #{self.injected['dispatch']} "
                f"(bucket {bucket})")

    def flush_delayed(self, bucket: int, now: float) -> bool:
        """Whether deadline flushes are held back at `now`."""
        if not self.plan.flush_delay:
            return False
        t = self._elapsed(now)
        return any(t0 <= t < t1 for t0, t1 in self.plan.flush_delay)

    def shard_down_now(self, now: float) -> int | None:
        """The shard currently inside a down window, else None."""
        if not self.plan.shard_down:
            return None
        t = self._elapsed(now)
        for shard, t0, t1 in self.plan.shard_down:
            if t0 <= t < t1:
                return int(shard)
        return None

    def check_migration_abort(self) -> None:
        """Raise `MigrationAbortedError` while abort budget remains."""
        if self._aborts_left > 0:
            self._aborts_left -= 1
            self.injected["migration_abort"] += 1
            raise MigrationAbortedError(
                "injected migration abort (mid-prepare)")
