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


def attention_split_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, chunk: int, causal: bool = True,
                        scale: float | None = None,
                        q_start: int | None = None) -> torch.Tensor:
    """The split-KV route's plain version: the keys [0, t_end) that some
    row sees, cut into chunks of ``chunk`` keys in order (as
    `kernel.split_plan` cuts them), one float32 partial (m, l, acc) per
    (row, chunk), merged in chunk order. A chunk wholly past a causal row's
    limit has m = -1e30, l = 0, acc = 0 and adds nothing. Same contract as
    `attention_ref`; the tests and the card's checks use it, the op never
    does."""
    h, hkv = q.shape[1], k.shape[1]
    s_n, t_n, d = q.shape[2], k.shape[2], q.shape[3]
    scale = 1.0 / math.sqrt(d) if scale is None else scale
    q_start = t_n - s_n if q_start is None else q_start
    t_end = min(t_n, q_start + s_n) if causal else t_n
    if hkv != h:
        k = k.repeat_interleave(h // hkv, dim=1)
        v = v.repeat_interleave(h // hkv, dim=1)
    rows = torch.arange(s_n, device=q.device)[:, None] + q_start
    parts = []
    for c0 in range(0, t_end, chunk):
        c1 = min(c0 + chunk, t_end)
        s = torch.einsum("bhsd,bhtd->bhst", q.float(),
                         k[:, :, c0:c1].float()) * scale
        mask = torch.ones((s_n, c1 - c0), dtype=torch.bool, device=q.device)
        if causal:
            mask = torch.arange(c0, c1, device=q.device)[None, :] <= rows
        s = s.masked_fill(~mask, -1e30)
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m).masked_fill(~mask, 0.0)
        parts.append((m, p.sum(dim=-1, keepdim=True),
                      torch.einsum("bhst,bhtd->bhsd", p,
                                   v[:, :, c0:c1].float())))
    m_all = parts[0][0]
    for m, _, _ in parts[1:]:
        m_all = torch.maximum(m_all, m)
    l_all = torch.zeros_like(m_all)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for m, l_c, a in parts:
        w = torch.exp(m - m_all)
        l_all = l_all + l_c * w
        acc = acc + a * w
    return (acc / l_all.clamp_min(1e-30)).to(q.dtype)


def attention_lse_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, scale: float | None = None,
                      q_start: int | None = None):
    """`attention_ref` and each row's float32 log-sum-exp of its scaled,
    masked scores: (out (B, H, S, d) in q's dtype, lse (B, H, S)). A row
    that sees no key has lse -inf and output 0 (no NaN)."""
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
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None].clamp_min(-3.0e38))
    out = torch.einsum("bhst,bhtd->bhsd", p, v.float())
    return out.to(q.dtype), lse
