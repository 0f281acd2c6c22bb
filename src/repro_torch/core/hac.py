"""Hierarchical agglomerative clustering of the query workload (Algorithm 1).

Produces a scipy-style linkage matrix Z[(n-1), 4] = (id_a, id_b, dist, size)
with new-cluster ids n+step, from a precomputed distance matrix, with the
paper's three linkages: single (SL), complete (CL), average (AL) — Fig. 2.

`linkage_numpy` is the host implementation (O(n^3), fine for workload-sized
n). A device-side Lance-Williams loop for very large workloads is not part of
this package yet.
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
