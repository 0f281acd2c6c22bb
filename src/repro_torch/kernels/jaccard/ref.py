"""Plain PyTorch version of the Jaccard-distance kernel: the CPU path and
the yardstick the CUDA kernel is held against on the card."""
from __future__ import annotations

import torch


def jaccard_distance_ref(m: torch.Tensor) -> torch.Tensor:
    """m: (Q, F) 0/1 membership matrix -> (Q, Q) float32 Jaccard distances.

    Pairs of empty sets have distance 0 (identical); the diagonal is 0."""
    m = m.to(torch.float32)
    inter = m @ m.T
    counts = m.sum(dim=1)
    union = counts[:, None] + counts[None, :] - inter
    sim = torch.where(union > 0, inter / torch.clamp(union, min=1e-30), 1.0)
    d = 1.0 - sim
    return d * (1.0 - torch.eye(m.shape[0], dtype=d.dtype, device=m.device))
