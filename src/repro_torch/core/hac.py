"""Hierarchical agglomerative clustering of the query workload (Algorithm 1).

Produces a scipy-style linkage matrix Z[(n-1), 4] = (id_a, id_b, dist, size)
with new-cluster ids n+step, from a precomputed distance matrix, with the
paper's three linkages: single (SL), complete (CL), average (AL) — Fig. 2.

Two implementations:
  * `linkage_numpy` — host oracle (O(n^3), fine for workload-sized n),
  * `linkage_torch` — the Lance-Williams loop in plain PyTorch on a device,
                      the counterpart of the reference's jit-ed
                      `linkage_jax`, for large production workloads.
"""
from __future__ import annotations

import numpy as np

LINKAGES = ("single", "complete", "average")
_INF = 1e30


def _lance_williams(da: np.ndarray, db: np.ndarray, na: float, nb: float,
                    linkage: str):
    if linkage == "single":
        return np.minimum(da, db)
    if linkage == "complete":
        return np.maximum(da, db)
    if linkage == "average":
        return (na * da + nb * db) / (na + nb)
    raise ValueError(f"unknown linkage {linkage!r}")


def linkage_numpy(dist: np.ndarray, linkage: str = "single") -> np.ndarray:
    """scipy-style linkage matrix from a (n, n) distance matrix."""
    n = dist.shape[0]
    d = dist.astype(np.float64).copy()
    np.fill_diagonal(d, _INF)
    active = np.ones(n, dtype=bool)
    cluster_id = np.arange(n)          # current cluster id living at each slot
    sizes = np.ones(n)
    z = np.zeros((max(0, n - 1), 4))
    for step in range(n - 1):
        masked = np.where(active[:, None] & active[None, :], d, _INF)
        flat = int(np.argmin(masked))
        i, j = divmod(flat, n)
        if i > j:
            i, j = j, i
        dij = masked[i, j]
        z[step] = (min(cluster_id[i], cluster_id[j]),
                   max(cluster_id[i], cluster_id[j]), dij, sizes[i] + sizes[j])
        # merge j into slot i
        new_row = _lance_williams(d[i], d[j], sizes[i], sizes[j], linkage)
        d[i, :] = new_row
        d[:, i] = new_row
        d[i, i] = _INF
        active[j] = False
        sizes[i] = sizes[i] + sizes[j]
        cluster_id[i] = n + step
    return z


def linkage_torch(dist, linkage: str = "single", *,
                  device="cuda") -> np.ndarray:
    """Algorithm 1 on ``device`` in float32, merge for merge the reference's
    `linkage_jax`: each step merges the first minimum of the flattened
    matrix (``torch.argmin`` returns the first occurrence, as
    ``jnp.argmin`` does), so ties — the rule among Jaccard distances —
    break the same way.

    The reference re-masks inactive rows and columns with _INF before
    every argmin; here they are kept at _INF in ``d`` itself (a merged
    slot's row and column are overwritten on the step that retires it), so
    the argmin reads the same matrix with one pass fewer. The merge slots
    stay on the device through the step: the loop makes no host sync, and
    the linkage matrix comes back in one copy at the end.
    """
    import torch

    from repro_torch.engine.batch import resolve_device

    if linkage not in LINKAGES:
        raise ValueError(f"unknown linkage {linkage!r}")
    n = int(dist.shape[0])
    if n < 2:
        return np.zeros((0, 4))
    dev = resolve_device(device)
    if isinstance(dist, torch.Tensor):
        d = dist.to(device=dev, dtype=torch.float32, copy=True)
    else:
        d = torch.tensor(np.asarray(dist), dtype=torch.float32, device=dev)
    d.fill_diagonal_(_INF)
    active = torch.ones(n, dtype=torch.bool, device=dev)
    sizes = torch.ones(n, dtype=torch.float32, device=dev)
    cid = torch.arange(n, dtype=torch.float32, device=dev)
    z = torch.empty((n - 1, 4), dtype=torch.float32, device=dev)
    inf = torch.full((n,), _INF, dtype=torch.float32, device=dev)
    for step in range(n - 1):
        flat = torch.argmin(d.view(-1))
        i0, j0 = flat // n, flat % n
        i = torch.minimum(i0, j0).view(1)
        j = torch.maximum(i0, j0).view(1)
        ci, cj = cid.index_select(0, i), cid.index_select(0, j)
        si, sj = sizes.index_select(0, i), sizes.index_select(0, j)
        z[step] = torch.cat([torch.minimum(ci, cj), torch.maximum(ci, cj),
                             d.view(-1).index_select(0, i * n + j),
                             si + sj])
        da, db = d.index_select(0, i)[0], d.index_select(0, j)[0]
        if linkage == "single":
            new_row = torch.minimum(da, db)
        elif linkage == "complete":
            new_row = torch.maximum(da, db)
        else:
            # fma(si, da, sj * db), the contraction XLA makes of the
            # reference's (si * da + sj * db)
            new_row = torch.addcmul(sj * db, si, da) / (si + sj)
        active.index_fill_(0, j, False)
        new_row = torch.where(active, new_row, inf)
        new_row.index_fill_(0, i, _INF)
        d.index_copy_(0, i, new_row[None, :])
        d.index_copy_(1, i, new_row[:, None])
        d.index_copy_(0, j, inf[None, :])
        d.index_copy_(1, j, inf[:, None])
        sizes.index_copy_(0, i, si + sj)
        cid.index_fill_(0, i, float(n + step))
    return z.cpu().numpy().astype(np.float64)


def cut(z: np.ndarray, n: int, *, n_clusters: int | None = None,
        distance: float | None = None) -> np.ndarray:
    """Flat cluster labels from a linkage matrix.

    Exactly one of n_clusters (maxclust cut) / distance (threshold cut) given.
    """
    if (n_clusters is None) == (distance is None):
        raise ValueError("give exactly one of n_clusters / distance")
    parent = list(range(n + max(0, n - 1)))

    def find(x: int) -> int:
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    merges = z.shape[0]
    if n_clusters is not None:
        n_clusters = max(1, min(n, n_clusters))
        take = max(0, n - n_clusters)
    else:
        take = int(np.sum(z[:, 2] <= distance + 1e-12))
    for step in range(min(take, merges)):
        a, b = int(z[step, 0]), int(z[step, 1])
        new = n + step
        parent[find(a)] = new
        parent[find(b)] = new
    roots = {}
    labels = np.zeros(n, dtype=np.int64)
    for q in range(n):
        r = find(q)
        labels[q] = roots.setdefault(r, len(roots))
    return labels
