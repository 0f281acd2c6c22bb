"""Adaptive serving controller: tracks, detects, repartitions, migrates.

One controller per WorkloadServer. The server calls `record` for every
request it routes (cheap, O(1)) and `maybe_adapt` after each served batch —
so a migration always lands *between* batches and the in-flight batch
finishes against the epoch it started on.

The decision chain per check:
  tracker snapshot -> DriftDetector.check(baseline, snap)
    none         -> nothing
    incremental  -> budgeted greedy unit moves on the observed weights
    full         -> wawpart re-run on the updated query set + weights
  improving result -> server.migrate(new placement), baseline re-anchors to
  the observed mix, the window resets (old-epoch cut counts must not pollute
  the new epoch's statistics).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.adaptive.drift import DriftDetector
from repro_torch.adaptive.repartition import (full_repartition,
                                        incremental_repartition)
from repro_torch.adaptive.stats import (WorkloadTracker, plan_shards,
                                  uniform_baseline)
from repro_torch.faults import MigrationAbortedError


@dataclass
class AdaptiveConfig:
    window: int = 512               # tracker sliding-window size (requests)
    check_every: int = 128          # requests between drift checks
    min_requests: int = 64          # below this, never act on the window
    drift_threshold: float = 0.15   # TV distance triggering incremental
    full_threshold: float = 0.45    # TV distance triggering full re-run
    unseen_mass_threshold: float = 0.05
    budget_frac: float = 0.10       # max fraction of triples moved per
                                    # incremental migration
    balance_tol: float = 0.15
    max_moves: int = 256


@dataclass
class AdaptEvent:
    """One drift-check outcome that led to (or explicitly skipped) action."""
    epoch: int                      # epoch the decision was made in
    severity: str                   # drift severity that fired
    divergence: float
    mode: str                       # "incremental" | "full" | "noop"
                                    # | "aborted" (prepare rolled back)
    moved_triples: int              # triples actually migrated (0 on noop)
    proposed_triples: int           # movement of the (possibly unapplied)
                                    # proposal the check produced
    budget_triples: int
    cost_before: float
    cost_after: float
    migration: dict | None          # server.migrate report (None on noop)


class AdaptiveController:
    def __init__(self, server, config: AdaptiveConfig | None = None) -> None:
        self.server = server
        self.cfg = config or AdaptiveConfig()
        self.tracker = WorkloadTracker(self.cfg.window)
        self.detector = DriftDetector(
            threshold=self.cfg.drift_threshold,
            full_threshold=self.cfg.full_threshold,
            unseen_mass_threshold=self.cfg.unseen_mass_threshold,
            min_requests=self.cfg.min_requests)
        self.baseline = self._initial_baseline()
        self.events: list[AdaptEvent] = []
        self._since_check = 0
        self._cooldown_until = 0

    def _initial_baseline(self) -> dict[str, float]:
        """The template mix the current partitioning was computed from: its
        recorded query_weights if any, else the paper's uniform workload
        over the analyzed templates."""
        qw = self.server.part.meta.get("query_weights") or {}
        total = sum(qw.values())
        if total > 0:
            return {n: w / total for n, w in qw.items() if w > 0}
        return uniform_baseline([q.name for q in self.server.queries])

    def _known_templates(self) -> set[str]:
        """Templates whose features all have data units in the current
        partitioning's catalog — the ones incremental moves can help."""
        from repro_torch.core.features import query_features
        cat = self.server.part.catalog
        return {q.name for q in self.server.queries
                if all(f in cat.feature_units for f in query_features(q))}

    # ---- hooks the server calls ---------------------------------------

    def record(self, name: str, plan) -> None:
        self.tracker.observe(name, cut_joins=len(plan.cut_steps),
                             shards=plan_shards(plan))
        self._since_check += 1

    def maybe_adapt(self) -> AdaptEvent | None:
        """Run a drift check if due; migrate if it pays. Returns the event
        when a drift fired (even a noop one), else None."""
        if self._since_check < self.cfg.check_every:
            return None
        self._since_check = 0
        if self.tracker.seen_total < self._cooldown_until:
            return None
        snap = self.tracker.snapshot()
        report = self.detector.check(self.baseline, snap,
                                     known=self._known_templates())
        tele = getattr(self.server, "telemetry", None)
        if tele is not None:
            tele.count("drift_checks", severity=report.severity)
            tele.trace.instant(
                f"drift/{report.severity}",
                args={"divergence": round(report.divergence, 4),
                      "window": snap.total})
        if not report.drifted:
            return None

        server = self.server
        part = server.part
        queries = server.queries
        weights = {n: float(c) for n, c in snap.counts.items()}
        if report.severity == "full":
            result = full_repartition(
                part.catalog.store, queries, weights,
                n_shards=part.n_shards, balance_tol=self.cfg.balance_tol,
                old_part=part)
        else:
            result = incremental_repartition(
                part, queries, weights, budget_frac=self.cfg.budget_frac,
                balance_tol=self.cfg.balance_tol,
                max_moves=self.cfg.max_moves)

        migration = None
        mode = result.mode
        if result.mode != "noop" and result.improved:
            try:
                migration = server.migrate(result.part)
            except MigrationAbortedError:
                # the prepare phase rolled back (injected abort, or the
                # server is degraded): the old epoch keeps serving; the
                # noop cooldown below re-scores after the window turns
                mode = "aborted"
        else:
            mode = "noop"
        event = AdaptEvent(
            epoch=server.epoch if migration is None
            else migration["epoch"] - 1,
            severity=report.severity, divergence=report.divergence,
            mode=mode,
            moved_triples=result.moved_triples if migration is not None
            else 0,
            proposed_triples=result.moved_triples,
            budget_triples=result.budget_triples,
            cost_before=result.cost_before, cost_after=result.cost_after,
            migration=migration)
        self.events.append(event)
        if migration is not None:
            # the new placement was optimized for the observed mix; its
            # recorded query_weights are the baseline from here on, and the
            # old epoch's cut counts must not pollute the new epoch's window
            self.baseline = self._initial_baseline()
            self.tracker.reset()
        else:
            # drift is real but not improvable right now (conflicted mixed-
            # phase window, or already optimal): hold the baseline — it pins
            # the mix the *placement* is built for, so a further shift keeps
            # accumulating divergence — and wait for the window to turn over
            # before re-scoring moves
            self._cooldown_until = self.tracker.seen_total + self.cfg.window
        return event

    @property
    def n_migrations(self) -> int:
        return sum(1 for e in self.events if e.migration is not None)
