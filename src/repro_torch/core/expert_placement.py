"""WawPart beyond the paper: workload-aware MoE expert placement (DESIGN §5).

A copy of the reference's `core/expert_placement.py` (numpy; no path of
either package calls it), held value for value by
tests/test_torch_moe.py. `apply_placement` permutes numpy arrays or
tensors alike.

Expert-parallel MoE is a partitioning problem with a workload: the "queries"
are tokens, their "features" the experts their router selects (top-k), and
the placement objective mirrors Algorithm 2 —
  * co-locate experts that co-fire (a token whose experts span fewer model
    columns hits fewer per-column capacity limits -> fewer drops),
  * balance column LOAD (a hot column is a synchronous straggler: every chip
    waits for the busiest expert column each layer).

Reuses the paper's machinery verbatim: Jaccard distances over co-assignment
events -> HAC -> cut -> pack groups balancing load. Returns an expert
permutation to apply to the stacked expert weights at setup time (EP shards
contiguous expert ranges per column).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.hac import cut, linkage_numpy
from repro_torch.tree import tree_map


def routing_stats(expert_ids: np.ndarray, n_experts: int):
    """From profiled top-k assignments (T, k): per-expert load + co-fire
    counts C[e, f] = #tokens selecting both e and f."""
    T, k = expert_ids.shape
    load = np.bincount(expert_ids.reshape(-1), minlength=n_experts)
    co = np.zeros((n_experts, n_experts), dtype=np.int64)
    for a in range(k):
        for b in range(a + 1, k):
            np.add.at(co, (expert_ids[:, a], expert_ids[:, b]), 1)
            np.add.at(co, (expert_ids[:, b], expert_ids[:, a]), 1)
    return load.astype(np.int64), co


def place_experts(load: np.ndarray, co: np.ndarray, n_cols: int,
                  *, balance_tol: float = 0.10) -> np.ndarray:
    """Permutation perm s.t. column j owns experts perm[j*E_loc:(j+1)*E_loc].

    Jaccard distance between experts e, f: 1 - co[e,f] / (load[e] + load[f]
    - co[e,f]) (co-assignment events as the feature sets) -> HAC -> cut into
    >= n_cols groups -> pack groups onto columns, splitting any group whose
    load exceeds the balanced column budget (the paper's balancing module).
    """
    E = load.shape[0]
    assert E % n_cols == 0
    e_loc = E // n_cols
    union = load[:, None] + load[None, :] - co
    with np.errstate(divide="ignore", invalid="ignore"):
        sim = np.where(union > 0, co / np.maximum(union, 1), 0.0)
    dist = 1.0 - sim
    np.fill_diagonal(dist, 0.0)

    z = linkage_numpy(dist, "average")
    labels = cut(z, E, n_clusters=min(E, n_cols * 4))

    groups: dict[int, list[int]] = {}
    for e, g in enumerate(labels):
        groups.setdefault(int(g), []).append(e)
    # order experts within a group hot-first so splits stay balanced
    glist = [sorted(g, key=lambda e: -load[e]) for g in groups.values()]
    glist.sort(key=lambda g: -sum(load[e] for e in g))

    cols: list[list[int]] = [[] for _ in range(n_cols)]
    col_load = np.zeros(n_cols)

    def emptiest() -> int:
        free = [j for j in range(n_cols) if len(cols[j]) < e_loc]
        return min(free, key=lambda j: col_load[j])

    for g in glist:
        for e in g:                       # groups split only when a column
            j = emptiest()                # fills (capacity e_loc) — the
            cols[j].append(e)             # balancing-module behaviour
            col_load[j] += load[e]
    perm = np.concatenate([np.asarray(c, np.int64) for c in cols])
    return perm


def max_column_load(load: np.ndarray, perm: np.ndarray, n_cols: int) -> float:
    """Straggler metric: the hottest column's share of total routed load."""
    E = load.shape[0]
    e_loc = E // n_cols
    col = load[perm].reshape(n_cols, e_loc).sum(axis=1)
    return float(col.max() / max(1, load.sum()) * n_cols)  # 1.0 = balanced


def apply_placement(expert_tree, perm: np.ndarray):
    """Permute stacked expert weights (..., E, ·, ·) by the placement."""
    def permute(w):
        if w.ndim < 3:
            return w
        idx = torch.as_tensor(perm, device=w.device) \
            if isinstance(w, torch.Tensor) else perm
        return w[..., idx, :, :]
    return tree_map(permute, expert_tree)
