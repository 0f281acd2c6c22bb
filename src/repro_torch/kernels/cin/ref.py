"""Plain PyTorch version of the CIN-layer kernel: the CPU path and the
yardstick the CUDA kernel is held against on the card. It materializes the
(B, H, F, D) outer product, as the reference's plain path does."""
from __future__ import annotations

import torch


def cin_layer_ref(xk: torch.Tensor, x0: torch.Tensor,
                  w: torch.Tensor) -> torch.Tensor:
    """xk: (B, H, D); x0: (B, F, D); w: (K, H, F) -> (B, K, D).

    out[b,k,d] = sum_{h,f} w[k,h,f] * xk[b,h,d] * x0[b,f,d]
    """
    z = torch.einsum("bhd,bfd->bhfd", xk, x0)
    return torch.einsum("bhfd,khf->bkd", z, w)
