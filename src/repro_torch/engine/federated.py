"""Shard blocks of the federated KG and the capacity checks shared by the
engines (paper §3.2 + §4).

Each shard holds its padded triple block. A plan step whose pattern data
lives off the query's primary processing node (PPN) gathers candidate
matches across the shard axis — the tensor analogue of a SERVICE call;
steps whose data is PPN-local never communicate.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.partitioner import Partitioning

AXIS = "shards"


class CapacityOverflowError(RuntimeError):
    """A static capacity (scan cap, table cap, gather_cap, or merge-join
    window) was exceeded at run time: the result set is truncated. Raised by
    the runners under ``strict=True``; otherwise the condition is reported
    through the returned overflow flag."""


def check_gather_cap(gather_cap) -> None:
    """Validate a gather_cap argument before any work happens.

    A non-positive capacity would compact every cross-shard gather down to
    nothing — results would be silently empty/truncated rather than an error
    (the overflow flag fires, but only at run time, per request).
    """
    if gather_cap is None:
        return
    if isinstance(gather_cap, bool) or not isinstance(
            gather_cap, (int, np.integer)) or gather_cap < 1:
        raise ValueError(
            f"gather_cap must be a positive int or None, got {gather_cap!r}")


def raise_on_overflow(overflow, query_name: str, path: str) -> None:
    """Shared strict-mode check: one error message for every execution path
    (vmapped / sharded / batched), so callers can match on it."""
    if bool(np.asarray(overflow)):
        raise CapacityOverflowError(
            f"query {query_name!r}: static capacity overflow on the {path} "
            "path — results are truncated; raise the plan's scan/table caps, "
            "gather_cap, or max_per_row")


@dataclass
class ShardedKG:
    triples: np.ndarray   # (n_shards, cap, 3) int32, padded with -1
    valid: np.ndarray     # (n_shards, cap) bool
    n_shards: int
    cap: int

    @staticmethod
    def build(part: Partitioning, *, pad_multiple: int = 64,
              min_cap: int = 0) -> "ShardedKG":
        """Materialize per-shard triple blocks: each shard's primary rows
        (`assign_triples`, every triple exactly once) followed by any
        replicated rows (`part.replica_rows`). min_cap lets a caller keep
        the pre-replication block shape so built engines stay valid."""
        store = part.catalog.store
        assign = part.assign_triples()
        n = part.n_shards
        extra = part.replica_rows() if part.replicas else {}
        sizes = [int((assign == s).sum()) + len(extra.get(s, ()))
                 for s in range(n)]
        cap = max(8, min_cap,
                  int(np.ceil(max(sizes) / pad_multiple)) * pad_multiple)
        tr = np.full((n, cap, 3), -1, dtype=np.int32)
        va = np.zeros((n, cap), dtype=bool)
        for s in range(n):
            rows = store.triples[assign == s]
            rep = extra.get(s)
            if rep is not None:
                rows = np.concatenate([rows, store.triples[rep]])
            tr[s, :rows.shape[0]] = rows
            va[s, :rows.shape[0]] = True
        return ShardedKG(tr, va, n, cap)

    @staticmethod
    def from_arrays(triples, valid) -> "ShardedKG":
        """Shard blocks from existing (n_shards, cap, 3) triples and
        (n_shards, cap) valid arrays, e.g. another build of the same
        partitioning. Raises ValueError on mismatched shapes."""
        tr = np.ascontiguousarray(np.asarray(triples, dtype=np.int32))
        va = np.ascontiguousarray(np.asarray(valid, dtype=bool))
        if tr.ndim != 3 or tr.shape[2] != 3 or va.shape != tr.shape[:2]:
            raise ValueError(f"triples {tr.shape} / valid {va.shape} are not "
                             "(n_shards, cap, 3) / (n_shards, cap)")
        return ShardedKG(tr, va, tr.shape[0], tr.shape[1])

    def to_device(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(triples, valid) as tensors on ``device``."""
        return (torch.from_numpy(self.triples).to(device),
                torch.from_numpy(self.valid).to(device))
