"""Plain PyTorch version of the flash-attention kernel: the CPU path and the
yardstick the CUDA kernel is held against on the card. It computes what the
reference's `attention_ref` computes behind `flash_attention_reference`:
KV heads repeated for GQA, float32 scores and softmax, float32
probabilities into the value product, and a cast to q's dtype at the end,
with the causal diagonal at an explicit offset ``q_start``."""
from __future__ import annotations

import math

import torch


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, scale: float | None = None,
                  q_start: int | None = None) -> torch.Tensor:
    """q: (B, H, S, d); k/v: (B, Hkv, T, d), H % Hkv == 0 -> (B, H, S, d).

    With ``causal``, row s sees keys t <= q_start + s (``q_start`` defaults
    to T - S, the bottom-right diagonal)."""
    h, hkv = q.shape[1], k.shape[1]
    s_n, t_n, d = q.shape[2], k.shape[2], q.shape[3]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    q_start = t_n - s_n if q_start is None else q_start
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    s = torch.einsum("bhsd,bhtd->bhst", q.float(), k.float()) * scale
    if causal:
        rows = torch.arange(s_n, device=q.device)[:, None] + q_start
        mask = torch.arange(t_n, device=q.device)[None, :] <= rows
        s = s.masked_fill(~mask, float("-inf"))
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhst,bhtd->bhsd", p, v.float()).to(q.dtype)
