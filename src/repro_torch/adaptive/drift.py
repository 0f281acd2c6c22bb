"""Workload drift detection.

Two triggers, mirroring what actually invalidates a WawPart placement:

* frequency divergence — the template mix shifted, so the q terms the
  statistics module optimized no longer describe the stream. Measured as
  total-variation distance between the baseline distribution (the one the
  current partitioning was computed from) and the tracked window.
* unseen templates — queries outside the analyzed workload carry features
  with no data units in the catalog; no incremental unit move can localize
  them, only a full re-partition (which rebuilds the catalog) can.

Severity is graded: below `threshold` nothing happens; between `threshold`
and `full_threshold` the incremental budgeted repartitioner runs; above it
(or when unseen templates carry real mass) the full wawpart re-run is
warranted.
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.adaptive.stats import WorkloadSnapshot

SEVERITIES = ("none", "incremental", "full")


@dataclass(frozen=True)
class DriftReport:
    divergence: float               # total-variation distance in [0, 1]
    unseen: tuple[str, ...]         # templates absent from the baseline
    unseen_mass: float              # window frequency mass on unseen names
    total: int                      # window size the report was made from
    severity: str                   # "none" | "incremental" | "full"

    @property
    def drifted(self) -> bool:
        return self.severity != "none"


def total_variation(p: dict[str, float], q: dict[str, float]) -> float:
    """TV distance 0.5 * sum |p - q| over the union of templates: 0 for
    identical mixes, 1 for disjoint support."""
    names = set(p) | set(q)
    return 0.5 * sum(abs(p.get(n, 0.0) - q.get(n, 0.0)) for n in names)


class DriftDetector:
    def __init__(self, *, threshold: float = 0.15,
                 full_threshold: float = 0.45,
                 unseen_mass_threshold: float = 0.05,
                 min_requests: int = 64) -> None:
        if not 0.0 < threshold <= full_threshold:
            raise ValueError(f"need 0 < threshold <= full_threshold, got "
                             f"{threshold} / {full_threshold}")
        if not 0.0 < unseen_mass_threshold <= 1.0:
            # 0.0 would make `unseen_mass >= threshold` always true and
            # escalate every check to "full" on a perfectly stable stream
            raise ValueError(f"unseen_mass_threshold must be in (0, 1], got "
                             f"{unseen_mass_threshold}")
        self.threshold = threshold
        self.full_threshold = full_threshold
        self.unseen_mass_threshold = unseen_mass_threshold
        self.min_requests = min_requests

    def check(self, baseline: dict[str, float], snap: WorkloadSnapshot,
              known: set[str] | None = None) -> DriftReport:
        """Compare the tracked window against the baseline template mix.

        `known` is the set of templates the current partitioning can
        represent (its catalog has data units for their features); it
        defaults to the baseline's support. Templates outside it are
        *unseen* — no incremental unit move can localize them, so real mass
        on them escalates straight to "full". Divergence against the
        baseline mix alone never escalates past its thresholds.

        Below min_requests the report is always "none": a near-empty window
        makes every frequency estimate noise, and a spurious migration costs
        real data movement.
        """
        support = set(baseline) if known is None else set(known)
        freqs = snap.frequencies
        unseen = tuple(sorted(n for n in freqs if n not in support))
        unseen_mass = sum(freqs[n] for n in unseen)
        div = total_variation(baseline, freqs)
        if snap.total < self.min_requests:
            severity = "none"
        elif (div >= self.full_threshold
              or unseen_mass >= self.unseen_mass_threshold):
            severity = "full"
        elif div >= self.threshold:
            severity = "incremental"
        else:
            severity = "none"
        return DriftReport(divergence=div, unseen=unseen,
                           unseen_mass=unseen_mass, total=snap.total,
                           severity=severity)
