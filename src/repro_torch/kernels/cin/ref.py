"""Plain PyTorch versions of the CIN-layer kernel: the CPU path and the
yardstick the CUDA kernel is held against on the card (`cin_layer_ref`,
which materializes the (B, H, F, D) outer product, as the reference's
plain path does), and the kernel's split arithmetic (`cin_layer_split_ref`,
for tests and the on-card checks only)."""
from __future__ import annotations

import torch


def cin_layer_ref(xk: torch.Tensor, x0: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """xk: (B, H, D); x0: (B, F, D); w: (K, H, F) -> (B, K, D).

    out[b,k,d] = sum_{h,f} w[k,h,f] * xk[b,h,d] * x0[b,f,d]
    """
    z = torch.einsum("bhd,bfd->bhfd", xk, x0)
    return torch.einsum("bhfd,khf->bkd", z, w)


def _split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    hi = x.to(torch.bfloat16).to(torch.float32)
    return hi, (x - hi).to(torch.bfloat16).to(torch.float32)


def cin_layer_split_ref(xk: torch.Tensor, x0: torch.Tensor,
                        w: torch.Tensor) -> torch.Tensor:
    """The kernel's arithmetic: z = xk x0 in float32, z and w each split
    into bf16 hi = bf16(x) and lo = bf16(x - hi), and the three products
    hi hi + hi lo + lo hi summed in float32 (lo lo is dropped)."""
    z_hi, z_lo = _split(torch.einsum("bhd,bfd->bhfd", xk, x0))
    w_hi, w_lo = _split(w)
    return (torch.einsum("bhfd,khf->bkd", z_hi, w_hi)
            + torch.einsum("bhfd,khf->bkd", z_hi, w_lo)
            + torch.einsum("bhfd,khf->bkd", z_lo, w_hi))
