"""ctypes binding and launch of the flash-attention CUDA kernel
(csrc/flash_attention.cu)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import check, current_stream, library, ptr

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, ctypes.c_int, _L, _L, _L, _L, _L, _L, _P, _L,
             ctypes.c_int, ctypes.c_float, _P]
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_D = 128                 # head dims one block's threads cover


def _entry():
    fn = library("flash_attention.cu").flash_attention
    if fn.argtypes != _ARGTYPES:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def flash_attention_kernel(q, k, v, *, causal: bool, scale: float,
                           q_start: int):
    """(B, H, S, d) attention of CUDA tensors q (B, H, S, d) and k, v
    (B, Hkv, T, d), float32 or bfloat16, each a strided view whose last dim
    is contiguous. The output is a (B, H, S, d) view of fresh (B, S, H, d)
    storage, so the model's (B, S, H * d) projection input needs no copy."""
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        if t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
        if t.dtype not in DTYPES or t.dtype != q.dtype:
            raise ValueError(f"{name} must be float32 or bfloat16 like q, "
                             f"got {t.dtype} (q {q.dtype})")
        if t.dim() != 4 or (t.shape[3] > 1 and t.stride(3) != 1):
            raise ValueError(f"{name} must be 4-d with a contiguous last "
                             f"dim, got shape {tuple(t.shape)} strides "
                             f"{t.stride()}")
    b, h, s, d = q.shape
    hkv, t_n = k.shape[1], k.shape[2]
    if k.shape != (b, hkv, t_n, d) or v.shape != k.shape:
        raise ValueError(f"attention operands do not agree: q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    if not q.device == k.device == v.device:
        raise ValueError("attention operands lie on different devices")
    if hkv < 1 or h % hkv:
        raise ValueError(f"H = {h} is not a multiple of Hkv = {hkv}")
    if not 1 <= d <= MAX_D or t_n < 1:
        raise ValueError(f"flash attention takes 1 <= d <= {MAX_D} and "
                         f"T >= 1, got d = {d}, T = {t_n}")
    if b * hkv > 65535:
        raise ValueError(f"flash attention takes B * Hkv <= 65535, got "
                         f"{b * hkv}")
    out = torch.empty((b, s, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    strides = (_L * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                        *out.stride()[:3])
    status = _entry()(ptr(q), ptr(k), ptr(v), ptr(out), DTYPES[q.dtype], b, h,
                      hkv, s, t_n, d, ctypes.cast(strides, _P), q_start,
                      int(causal), scale, current_stream(q.device))
    check(status, "flash_attention")
    return out
