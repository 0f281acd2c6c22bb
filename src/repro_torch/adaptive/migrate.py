"""Shard migration: apply a new placement to a live ShardedKG as deltas.

A migration between two placements of the same store is fully described by
the rows whose shard assignment changed. `MigrationPlan` materializes those
per-(src, dst) row deltas, and `apply_kg` rebuilds each shard block as
(rows that stay, in their old block order) + (arriving rows) — the padded
block capacity is kept whenever the largest new shard still fits, so the
compiled bucket engines keep their input shapes and jit does not
re-specialize on a migration that only moves data.

The plan is placement-level and epoch-agnostic; `WorkloadServer.migrate`
owns the serving-side sequencing (epoch bump, plan re-rewrites, cache
reuse) and in-flight batches keep executing against the old epoch's
tensors, which stay alive as long as any reference does.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.core.partitioner import Partitioning
from repro_torch.engine.federated import ShardedKG


@dataclass
class MigrationPlan:
    """Row-level diff between two placements of one triple store.

    Built by `build`; `shard_deltas` groups the moved rows by (src, dst)
    shard pair and `apply_kg` rebuilds a live ShardedKG in place of a
    cold restart. n_moved/moved_fraction summarize the movement cost.
    """

    old_assign: np.ndarray          # (N,) shard per triple row, old placement
    new_assign: np.ndarray          # (N,) shard per triple row, new placement
    n_shards: int                   # target shard count
    n_moved: int
    moved_fraction: float

    @staticmethod
    def build(old: Partitioning, new: Partitioning) -> "MigrationPlan":
        """Diff two placements' assign_triples() into a plan.

        Raises ValueError when the placements cover different stores —
        a migration only moves rows, it never changes which rows exist.
        """
        if old.catalog.store is not new.catalog.store:
            raise ValueError("migration requires both placements to cover "
                             "the same triple store")
        oa = old.assign_triples()
        na = new.assign_triples()
        moved = int((oa != na).sum())
        return MigrationPlan(oa, na, new.n_shards, moved,
                             moved / max(1, oa.shape[0]))

    def shard_deltas(self) -> dict[tuple[int, int], np.ndarray]:
        """(src, dst) -> row indices leaving src for dst — what a real
        deployment would put on the wire, shard-pair by shard-pair."""
        diff = np.nonzero(self.old_assign != self.new_assign)[0]
        if diff.size == 0:
            return {}
        # group rows by their (src, dst) pair in one stable argsort pass
        src = self.old_assign[diff].astype(np.int64)
        dst = self.new_assign[diff].astype(np.int64)
        pair = src * max(1, self.n_shards) + dst
        order = np.argsort(pair, kind="stable")
        diff, pair = diff[order].astype(np.int64), pair[order]
        keys, starts = np.unique(pair, return_index=True)
        groups = np.split(diff, starts[1:])
        return {(int(src[order[i]]), int(dst[order[i]])): g
                for i, g in zip(starts, groups)}

    def apply_kg(self, kg: ShardedKG, new: Partitioning, *,
                 pad_multiple: int = 64) -> ShardedKG:
        """New ShardedKG with the deltas applied.

        Shard-count changes (a full re-run may alter routing semantics but
        n_shards is fixed by the mesh) fall back to a from-scratch build.
        """
        store = new.catalog.store
        if kg.n_shards != self.n_shards:
            return ShardedKG.build(new, pad_multiple=pad_multiple)
        extra = new.replica_rows() if new.replicas else {}
        sizes = [int((self.new_assign == s).sum()) + len(extra.get(s, ()))
                 for s in range(self.n_shards)]
        cap = kg.cap
        if max(sizes) > cap:        # grow in pad_multiple steps; never shrink
            cap = int(np.ceil(max(sizes) / pad_multiple)) * pad_multiple
        tr = np.full((self.n_shards, cap, 3), -1, dtype=np.int32)
        va = np.zeros((self.n_shards, cap), dtype=bool)
        for s in range(self.n_shards):
            stay = np.nonzero((self.old_assign == s)
                              & (self.new_assign == s))[0]
            arrive = np.nonzero((self.new_assign == s)
                                & (self.old_assign != s))[0]
            parts = [stay, arrive]
            if s in extra:          # replicated copies ride after primaries
                parts.append(extra[s])
            rows = np.concatenate(parts)
            tr[s, :rows.shape[0]] = store.triples[rows]
            va[s, :rows.shape[0]] = True
        return ShardedKG(tr, va, self.n_shards, cap)
