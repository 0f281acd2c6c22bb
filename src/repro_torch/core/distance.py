"""Jaccard distance matrix over workload queries (paper §3.2, Fig. 1).

dist(Qa, Qb) = 1 - |Fa ∩ Fb| / |Fa ∪ Fb| over the queries' feature sets.

Two compute paths over the binary query×feature membership matrix, where
the intersection counts are a 0/1 matmul:
  * numpy host path (default for the small Q×Q matrices of the paper),
  * ``use_kernel=True``: the matrix moves to a device and
    `kernels.jaccard` computes the distances there — on a CUDA device the
    hand-written kernel, on the CPU its plain version. For production
    workloads with 10^4-10^5 distinct queries this matmul is the hot spot.
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


def jaccard_distance_matrix(queries: list[Query], *, use_kernel: bool = False,
                            device="cuda") -> np.ndarray:
    """Q×Q Jaccard distances between the queries' feature sets: float64 from
    the numpy path, float32 from the kernel on ``device`` (which raises when
    a CUDA device is asked for and none is available)."""
    m, _ = feature_matrix(queries)
    if use_kernel:
        import torch

        from repro_torch.engine.batch import resolve_device
        from repro_torch.kernels.jaccard.ops import jaccard_distance
        dev = resolve_device(device)
        return jaccard_distance(torch.from_numpy(m).to(dev)).cpu().numpy()
    return jaccard_distance_from_membership(m)
