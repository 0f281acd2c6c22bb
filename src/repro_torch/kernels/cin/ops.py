"""Public CIN-layer op: dispatch on the tensor's device.

A CPU tensor runs the plain version (`ref.cin_layer_ref`); a CUDA tensor
launches the fused CIN kernel, and anything the kernel does not take
raises, as does an input that requires grad under grad mode (the kernel
has no backward). There is no fallback from the card to the plain version, and no
padding of B or K.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import forbid_backward
from repro_torch.kernels.cin.kernel import cin_layer_kernel
from repro_torch.kernels.cin.ref import cin_layer_ref


def cin_layer(xk: torch.Tensor, x0: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """xk: (B, H, D); x0: (B, F, D); w: (K, H, F) -> (B, K, D)."""
    if xk.device.type == "cpu":
        return cin_layer_ref(xk, x0, w)
    forbid_backward("cin_layer", "XDeepFM.cin_forward(use_kernel=False)",
                    xk, x0, w)
    out = cin_layer_kernel(xk.contiguous(), x0.contiguous(), w.contiguous())
    cin_layer.launches += 1
    return out


cin_layer.launches = 0
