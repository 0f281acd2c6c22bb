"""Jaccard distance matrix over workload queries (paper §3.2, Fig. 1).

dist(Qa, Qb) = 1 - |Fa ∩ Fb| / |Fa ∪ Fb| over the queries' feature sets.

Computed on the host with numpy over the binary query×feature membership
matrix (the intersection counts are a 0/1 matmul). A device kernel for very
large workloads is not part of this package yet.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.features import Feature, query_features
from repro_torch.kg.query import Query


def feature_matrix(queries: list[Query]) -> tuple[np.ndarray, list[Feature]]:
    """Binary membership matrix M[q, f] plus the feature axis ordering."""
    featsets = [query_features(q) for q in queries]
    all_feats = sorted(set().union(*featsets)) if featsets else []
    index = {f: i for i, f in enumerate(all_feats)}
    m = np.zeros((len(queries), max(1, len(all_feats))), dtype=np.float32)
    for qi, fs in enumerate(featsets):
        for f in fs:
            m[qi, index[f]] = 1.0
    return m, all_feats


def jaccard_distance_from_membership(m: np.ndarray) -> np.ndarray:
    """Pure-numpy oracle: 1 - |a∩b|/|a∪b| from a binary membership matrix."""
    m = m.astype(np.float64)
    inter = m @ m.T
    counts = m.sum(axis=1)
    union = counts[:, None] + counts[None, :] - inter
    with np.errstate(divide="ignore", invalid="ignore"):
        sim = np.where(union > 0, inter / np.maximum(union, 1e-30), 1.0)
    # two empty feature sets are identical -> distance 0 (sim forced to 1 above)
    d = 1.0 - sim
    np.fill_diagonal(d, 0.0)
    return d


def jaccard_distance_matrix(queries: list[Query]) -> np.ndarray:
    """Q×Q Jaccard distances between the queries' feature sets."""
    m, _ = feature_matrix(queries)
    return jaccard_distance_from_membership(m)
