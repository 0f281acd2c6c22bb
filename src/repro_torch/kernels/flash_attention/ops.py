"""Public flash-attention op: dispatch on the tensor's device.

A CPU tensor runs the plain version (`ref.attention_ref`); a CUDA tensor
launches the route that `kernel.plan` picks by shape (a bf16 tensor-core
prefill kernel, the split-KV decode pair or the CUDA-core kernel), and
anything it does not take raises, as does an input that requires grad
under grad mode (the kernels have no backward). There is no fallback from the card to the plain
version, no repeated copy of the KV heads and no padding of S or T.
``flash_attention.launches`` counts the calls on the card and
``flash_attention.routes`` the route each one took ("split_lse" for the
split route asked for its log-sum-exp).
"""
from __future__ import annotations

import math
from collections import Counter

import torch

from repro_torch.kernels import forbid_backward, is_meta, meta_cost
from repro_torch.kernels.flash_attention.kernel import (
    SPLIT_ROWS, flash_attention_kernel, plan, split_scratch_numel)
from repro_torch.kernels.flash_attention.ref import (attention_lse_ref,
                                                     attention_ref)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, scale: float | None = None,
                    q_start: int | None = None, return_lse: bool = False):
    """q: (B, H, S, d); k/v: (B, Hkv, T, d) with H % Hkv == 0 (GQA; query
    head h reads KV head h // (H / Hkv)) -> (B, H, S, d) in q's dtype.

    ``q_start`` is the causal diagonal's offset: row s sees keys
    t <= q_start + s. It defaults to T - S, as the reference op passes
    (`t_minus_s`); a cache of T slots holding S new rows at position p
    takes ``q_start=p``. On the card the inputs may be any strided views
    whose last dim is contiguous (e.g. a (B, T, Hkv, d) cache transposed),
    and the output is a (B, H, S, d) view of (B, S, H, d) storage.

    ``return_lse`` also returns each row's float32 log-sum-exp of its
    scaled scores, (B, H, S): on the card the split route always takes the
    call (its combine writes them), in launches of at most 16 rows a KV
    head (the query heads of a KV head in groups where G * S is more).

    On meta tensors it returns meta outputs as the plain version does and
    counts its bound's work in `kernels.meta_cost`: 4 d operations a
    visible (row, key) pair, q and out once, the K and V rows the rows
    see once (and the log-sum-exp)."""
    s_n, t_n = q.shape[2], k.shape[2]
    scale = 1.0 / math.sqrt(q.shape[3]) if scale is None else float(scale)
    q_start = t_n - s_n if q_start is None else int(q_start)
    if causal and q_start < 0:
        raise ValueError(f"causal attention needs q_start >= 0 (row 0 sees "
                         f"key 0), got {q_start}")
    if q.device.type == "cpu":
        fn = attention_lse_ref if return_lse else attention_ref
        return fn(q, k, v, causal=causal, scale=scale, q_start=q_start)
    if is_meta(q):
        return _meta(q, k, v, causal=causal, q_start=q_start,
                     return_lse=return_lse)
    forbid_backward("flash_attention", "transformer._sdpa, use_kernel=False",
                    q, k, v)
    if return_lse:
        return _with_lse(q, k, v, causal=causal, scale=scale,
                         q_start=q_start)
    route = plan(q, k, v, causal=causal, q_start=q_start)
    out = flash_attention_kernel(q, k, v, causal=causal, scale=scale,
                                 q_start=q_start, route=route)
    flash_attention.launches += 1
    flash_attention.routes[route.route] += 1
    return out


flash_attention.launches = 0
flash_attention.routes = Counter()


def _meta(q, k, v, *, causal: bool, q_start: int, return_lse: bool):
    b, h, s, d = q.shape
    hkv, t = k.shape[1], k.shape[2]
    if causal:
        # row i sees min(t, q_start + i + 1) keys
        lo = max(0, min(s, t - q_start))       # rows that see fewer than t
        pairs = lo * q_start + lo * (lo + 1) // 2 + (s - lo) * t
        kv_rows = min(t, q_start + s)
    else:
        pairs, kv_rows = s * t, t
    meta_cost.add("flash_attention", ops=4 * b * h * d * pairs,
                  n_bytes=q.element_size() * (2 * b * h * s * d
                                              + 2 * b * hkv * kv_rows * d)
                  + (4 * b * h * s if return_lse else 0))
    # the output as the kernel lays it, (B, S, H, d) storage, and the split
    # route's partials while the launch runs, as on the card
    out = torch.empty((b, s, h, d), dtype=q.dtype,
                      device="meta").transpose(1, 2)
    lse = torch.empty((b, h, s), dtype=torch.float32, device="meta") \
        if return_lse else None
    route = plan(q, k, v, causal=causal, q_start=q_start, lse=return_lse)
    if route.route == "split":
        torch.empty(split_scratch_numel(b, hkv, h // hkv * s, route.n_split,
                                        d), dtype=torch.float32,
                    device="meta")
    return (out, lse) if return_lse else out


def _with_lse(q, k, v, **kw):
    """The split route with its log-sum-exp, in groups of query heads of
    at most SPLIT_ROWS rows a KV head: (out, lse)."""
    b, h, s_n, d = q.shape
    hkv = k.shape[1]
    g_n = h // hkv
    per = SPLIT_ROWS // s_n
    if per < 1:
        raise ValueError(f"flash_attention(return_lse=True) takes at most "
                         f"{SPLIT_ROWS} query rows a head, got S = {s_n}")
    if g_n <= per:
        return _launch_lse(q, k, v, **kw)
    out = torch.empty((b, s_n, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = torch.empty((b, h, s_n), dtype=torch.float32, device=q.device)
    for g0 in range(0, g_n, per):
        g1 = min(g0 + per, g_n)
        o, ls = _launch_lse(q.unflatten(1, (hkv, g_n))[:, :, g0:g1]
                            .flatten(1, 2).contiguous(), k, v, **kw)
        out.unflatten(1, (hkv, g_n))[:, :, g0:g1] = o.unflatten(
            1, (hkv, g1 - g0))
        lse.unflatten(1, (hkv, g_n))[:, :, g0:g1] = ls.unflatten(
            1, (hkv, g1 - g0))
    return out, lse


def _launch_lse(q, k, v, *, causal, scale, q_start):
    """One launch of the split route writing each row's log-sum-exp."""
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    route = plan(q, k, v, causal=causal, q_start=q_start, lse=True)
    out = flash_attention_kernel(q, k, v, causal=causal, scale=scale,
                                 q_start=q_start, route=route, lse=lse)
    flash_attention.launches += 1
    flash_attention.routes["split_lse"] += 1
    return out, lse
