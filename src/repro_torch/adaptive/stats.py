"""Live workload statistics from the serving path.

The tracker sees every request the WorkloadServer routes (template name plus
the routed plan's cut-step count and owner shards) and maintains a sliding
window over the last `window` requests. Everything downstream — drift
detection, the weighted repartitioning objective — reads one immutable
`WorkloadSnapshot`, so a migration decision is made against a consistent
view even while new requests keep arriving.
"""
from __future__ import annotations

from collections import Counter, deque
from dataclasses import dataclass


@dataclass(frozen=True)
class WorkloadSnapshot:
    """Immutable view of the tracker's window."""
    counts: dict[str, int]          # template name -> requests in window
    total: int                      # requests in window
    cut_joins: int                  # sum of routed plans' cut-step counts
    shard_load: dict[int, int]      # shard -> requests touching it
    seen_total: int                 # lifetime requests observed

    @property
    def frequencies(self) -> dict[str, float]:
        if self.total == 0:
            return {}
        return {name: c / self.total for name, c in self.counts.items()}

    @property
    def cut_join_rate(self) -> float:
        """Observed cross-shard join steps per request — the serving-side
        image of the paper's distributed-join objective."""
        return self.cut_joins / self.total if self.total else 0.0

    def imbalance(self, n_shards: int) -> float:
        """Max/mean of per-shard request touches across all `n_shards`.

        1.0 is perfectly balanced; k means the hottest shard sees k times
        the mean load. Shards absent from `shard_load` count as zero (an
        untouched shard is exactly what imbalance should expose), and an
        idle window reports 0.0.
        """
        if n_shards <= 0:
            return 0.0
        loads = [self.shard_load.get(s, 0) for s in range(n_shards)]
        mean = sum(loads) / n_shards
        return max(loads) / mean if mean else 0.0


@dataclass
class _Obs:
    name: str
    cuts: int
    shards: tuple[int, ...]


class WorkloadTracker:
    """Sliding-window accumulator of per-template request statistics.

    observe() is O(1) amortized; the window evicts oldest-first so the
    frequency estimate follows the stream's current phase rather than its
    lifetime average (a lifetime average can never detect drift).
    """

    def __init__(self, window: int = 1024) -> None:
        if window < 1:
            raise ValueError(f"window must be >= 1, got {window}")
        self.window = window
        self._obs: deque[_Obs] = deque()
        self._counts: Counter[str] = Counter()
        self._cut_joins = 0
        self._shard_load: Counter[int] = Counter()
        self.seen_total = 0

    def __len__(self) -> int:
        return len(self._obs)

    def observe(self, name: str, *, cut_joins: int = 0,
                shards: tuple[int, ...] = ()) -> None:
        """Record one served request: its template, how many of its plan
        steps crossed a partition cut, and which shards held its data."""
        self._obs.append(_Obs(name, int(cut_joins), tuple(shards)))
        self._counts[name] += 1
        self._cut_joins += int(cut_joins)
        for s in shards:
            self._shard_load[int(s)] += 1
        self.seen_total += 1
        while len(self._obs) > self.window:
            old = self._obs.popleft()
            self._counts[old.name] -= 1
            if self._counts[old.name] == 0:
                del self._counts[old.name]
            self._cut_joins -= old.cuts
            for s in old.shards:
                self._shard_load[s] -= 1
                if self._shard_load[s] == 0:
                    del self._shard_load[s]

    def snapshot(self) -> WorkloadSnapshot:
        return WorkloadSnapshot(counts=dict(self._counts),
                                total=len(self._obs),
                                cut_joins=self._cut_joins,
                                shard_load=dict(self._shard_load),
                                seen_total=self.seen_total)

    def reset(self) -> None:
        """Drop the window (after a migration: the old partitioning's cut
        counts must not pollute the new epoch's statistics)."""
        self._obs.clear()
        self._counts.clear()
        self._cut_joins = 0
        self._shard_load.clear()


def plan_shards(plan) -> tuple[int, ...]:
    """The shard ids a routed plan's data lives on, sorted.

    Union of the plan's per-step home shards; a plan whose metadata lacks
    homes (e.g. a centralized placement) attributes its load to the
    partition-by number so every observation lands somewhere.
    """
    homes = plan.meta.get("homes") or []
    shards = {s for h in homes for s in h} or {plan.ppn}
    return tuple(sorted(shards))


def uniform_baseline(names: list[str]) -> dict[str, float]:
    """The paper's implicit workload model: every template equally likely."""
    if not names:
        return {}
    return {n: 1.0 / len(names) for n in names}
