"""Public Jaccard-distance op: dispatch on the tensor's device.

A CPU tensor runs the plain version (`ref.jaccard_distance_ref`); a CUDA
tensor launches the jaccard kernels (int8 pack, then the product over one
triangle of tiles), and anything they do not take raises, such as a value
other than 0 or 1, or an input that requires grad under grad mode (the
kernels have no backward). There is no fallback from the card to the plain
version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import forbid_backward
from repro_torch.kernels.jaccard.kernel import jaccard_distance_kernel
from repro_torch.kernels.jaccard.ref import jaccard_distance_ref


def jaccard_distance(m: torch.Tensor) -> torch.Tensor:
    """(Q, F) 0/1 membership matrix -> (Q, Q) float32 Jaccard distance
    matrix with a zero diagonal."""
    if m.device.type == "cpu":
        return jaccard_distance_ref(m)
    forbid_backward("jaccard_distance", "ref.jaccard_distance_ref", m)
    out = jaccard_distance_kernel(m.to(torch.float32).contiguous())
    jaccard_distance.launches += 1
    return out


jaccard_distance.launches = 0
