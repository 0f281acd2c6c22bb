"""Public CIN-layer op: dispatch on the tensor's device.

A CPU tensor runs the plain version (`ref.cin_layer_ref`); a CUDA tensor
launches the fused CIN kernel, and anything the kernel does not take
raises, as does an input that requires grad under grad mode (the kernel
has no backward). There is no fallback from the card to the plain version, and no
padding of B or K. A meta tensor gets a meta output and its work counted
in `kernels.meta_cost` (see the package's docstring).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import forbid_backward, is_meta, meta_cost
from repro_torch.kernels.cin.kernel import (cin_layer_kernel, plan,
                                            scratch_elems)
from repro_torch.kernels.cin.ref import cin_layer_ref


def cin_layer(xk: torch.Tensor, x0: torch.Tensor,
              w: torch.Tensor) -> torch.Tensor:
    """xk: (B, H, D); x0: (B, F, D); w: (K, H, F) -> (B, K, D)."""
    if xk.device.type == "cpu":
        return cin_layer_ref(xk, x0, w)
    if is_meta(xk):
        b, h, d = xk.shape
        k, f = w.shape[0], x0.shape[1]
        # its three bf16 products (the split hi/lo arithmetic)
        meta_cost.add("cin_layer", ops=3 * 2 * b * k * d * h * f,
                      n_bytes=4 * (b * h * d + b * f * d + k * h * f
                                   + b * k * d))
        out = torch.empty((b, k, d), dtype=xk.dtype, device="meta")
        # the launch's split-w scratch, live while it runs, as on the card
        torch.empty((scratch_elems(plan(b, h, f, d, k), h, f),),
                    dtype=torch.bfloat16, device="meta")
        return out
    forbid_backward("cin_layer", "XDeepFM.cin_forward(use_kernel=False)",
                    xk, x0, w)
    out = cin_layer_kernel(xk.contiguous(), x0.contiguous(), w.contiguous())
    cin_layer.launches += 1
    return out


cin_layer.launches = 0
