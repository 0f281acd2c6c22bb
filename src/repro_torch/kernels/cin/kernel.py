"""ctypes binding and launch of the CIN-layer CUDA kernel (csrc/cin.cu)."""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import check, current_stream, library, ptr, require

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _L, _L, _L, _L, _L, _P]
ROWS = 64                   # (b, d) rows per block, as kRows in the source
SMEM_LIMIT = 232448         # dynamic shared memory one Hopper block can use


def _entry():
    fn = library("cin.cu").cin_layer
    if fn.argtypes != _ARGTYPES:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def smem_bytes(h: int, f: int) -> int:
    """Dynamic shared memory of one block: two (16, 64) step tiles plus the
    xk and x0 values of its 64 rows (as smem_bytes in the source)."""
    return 4 * (2 * 16 * ROWS + (h + f) * ROWS)


def cin_layer_kernel(xk, x0, w):
    """(B, K, D) float32 from contiguous float32 CUDA tensors xk (B, H, D),
    x0 (B, F, D) and w (K, H, F)."""
    require(xk, "xk", torch.float32, 3)
    require(x0, "x0", torch.float32, 3)
    require(w, "w", torch.float32, 3)
    b, h, d = xk.shape
    f = x0.shape[1]
    k = w.shape[0]
    if x0.shape != (b, f, d) or w.shape != (k, h, f):
        raise ValueError(f"cin operands do not agree: xk {tuple(xk.shape)}, "
                         f"x0 {tuple(x0.shape)}, w {tuple(w.shape)}")
    if not xk.device == x0.device == w.device:
        raise ValueError("cin operands lie on different devices")
    if h < 1 or f < 1:
        raise ValueError("cin needs H >= 1 and F >= 1")
    if smem_bytes(h, f) > SMEM_LIMIT:
        raise ValueError(f"cin stages H + F = {h + f} rows of 64 in shared "
                         f"memory: {smem_bytes(h, f)} bytes > {SMEM_LIMIT}")
    if -(-k // 64) > 65535:
        raise ValueError(f"cin takes at most {65535 * 64} outputs, got {k}")
    out = torch.empty((b, k, d), dtype=torch.float32, device=xk.device)
    status = _entry()(ptr(xk), ptr(x0), ptr(w), ptr(out), b, h, f, d, k,
                      current_stream(xk.device))
    check(status, "cin_layer")
    return out
