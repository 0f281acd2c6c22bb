"""Plain PyTorch versions of the Jaccard kernels: the CPU path and the
yardsticks the CUDA kernels are held against on the card."""
from __future__ import annotations

import torch

from repro_torch.kernels.jaccard.kernel import packed_width


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


def jaccard_pack_ref(m: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The pack pass: (Q, F) 0/1 float32 -> the zero-padded int8 copy
    (Q, packed_width(F)) and the int32 row counts."""
    q, f = m.shape
    packed = torch.zeros((q, packed_width(f)), dtype=torch.int8,
                         device=m.device)
    packed[:, :f] = (m == 1).to(torch.int8)
    return packed, packed.sum(dim=1, dtype=torch.int32)
