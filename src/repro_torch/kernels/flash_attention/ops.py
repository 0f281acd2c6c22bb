"""Public flash-attention op: dispatch on the tensor's device.

A CPU tensor runs the plain version (`ref.attention_ref`); a CUDA tensor
launches the route that `kernel.plan` picks by shape (a bf16 tensor-core
prefill kernel, the split-KV decode pair or the CUDA-core kernel), and
anything it does not take raises, as does an input that requires grad
under grad mode (the kernels have no backward). There is no fallback from the card to the plain
version, no repeated copy of the KV heads and no padding of S or T.
``flash_attention.launches`` counts the calls on the card and
``flash_attention.routes`` the route each one took.
"""
from __future__ import annotations

import math
from collections import Counter

import torch

from repro_torch.kernels import forbid_backward
from repro_torch.kernels.flash_attention.kernel import (
    flash_attention_kernel, plan)
from repro_torch.kernels.flash_attention.ref import attention_ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    q_start: int | None = None) -> torch.Tensor:
    """q: (B, H, S, d); k/v: (B, Hkv, T, d) with H % Hkv == 0 (GQA; query
    head h reads KV head h // (H / Hkv)) -> (B, H, S, d) in q's dtype.

    ``q_start`` is the causal diagonal's offset: row s sees keys
    t <= q_start + s. It defaults to T - S, as the reference op passes
    (`t_minus_s`); a cache of T slots holding S new rows at position p
    takes ``q_start=p``. On the card the inputs may be any strided views
    whose last dim is contiguous (e.g. a (B, T, Hkv, d) cache transposed),
    and the output is a (B, H, S, d) view of (B, S, H, d) storage."""
    s_n, t_n = q.shape[2], k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[3]) if scale is None else float(scale)
    q_start = t_n - s_n if q_start is None else int(q_start)
    if causal and q_start < 0:
        raise ValueError(f"causal attention needs q_start >= 0 (row 0 sees "
                         f"key 0), got {q_start}")
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, scale=scale,
                             q_start=q_start)
    forbid_backward("flash_attention", "transformer._sdpa, use_kernel=False",
                    q, k, v)
    route = plan(q, k, v, causal=causal, q_start=q_start)
    out = flash_attention_kernel(q, k, v, causal=causal, scale=scale,
                                 q_start=q_start, route=route)
    flash_attention.launches += 1
    flash_attention.routes[route.route] += 1
    return out


flash_attention.launches = 0
flash_attention.routes = Counter()
