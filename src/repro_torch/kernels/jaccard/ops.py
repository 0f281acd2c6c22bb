"""Public Jaccard-distance op: dispatch on the tensor's device.

A CPU tensor runs the plain version (`ref.jaccard_distance_ref`); a CUDA
tensor launches the jaccard kernels (int8 pack, then the product over one
triangle of tiles), and anything they do not take raises, such as a value
other than 0 or 1, or an input that requires grad under grad mode (the
kernels have no backward). There is no fallback from the card to the plain
version. A meta tensor gets a meta output and its work counted in
`kernels.meta_cost` (see the package's docstring).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import forbid_backward, is_meta, meta_cost
from repro_torch.kernels.jaccard.kernel import (jaccard_distance_kernel,
                                                packed_width)
from repro_torch.kernels.jaccard.ref import jaccard_distance_ref


def jaccard_distance(m: torch.Tensor) -> torch.Tensor:
    """(Q, F) 0/1 membership matrix -> (Q, Q) float32 Jaccard distance
    matrix with a zero diagonal."""
    if m.device.type == "cpu":
        return jaccard_distance_ref(m)
    if is_meta(m):
        q, f = m.shape
        # Q x F read, Q x Q written; Q (Q + 1) / 2 dot products of F
        # multiply-adds on int8 tensor cores
        meta_cost.add("jaccard_distance", ops=q * (q + 1) * f,
                      n_bytes=4 * q * f + 4 * q * q)
        # the launches' scratch as on the card: the packed copy, the
        # counts, the flag
        scratch = (torch.empty((q, packed_width(f)), dtype=torch.int8,
                               device="meta"),
                   torch.empty((q,), dtype=torch.int32, device="meta"),
                   torch.empty((1,), dtype=torch.int32, device="meta"))
        out = torch.empty((q, q), dtype=torch.float32, device="meta")
        del scratch
        return out
    forbid_backward("jaccard_distance", "ref.jaccard_distance_ref", m)
    out = jaccard_distance_kernel(m.to(torch.float32).contiguous())
    jaccard_distance.launches += 1
    return out


jaccard_distance.launches = 0
