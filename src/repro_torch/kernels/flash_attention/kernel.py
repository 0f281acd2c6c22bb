"""ctypes binding and launch of the flash-attention CUDA kernels
(csrc/flash_attention.cu), and the plan that picks their route by shape.

Routes (see the source's note): "wgmma", the bf16 prefill kernel on
wgmma fed by TMA; "mma", the bf16 prefill kernel on mma.sync for what TMA
cannot take (head dims not a multiple of 8, T under one 64-key tile,
8-byte aligned layouts); "split", the split-KV pair of kernels (decode: at
most 16 rows per KV head on a grid that would not fill the card); "tile",
the CUDA-core kernel (float32, and bf16 whose head dim or strides no copy
takes). The plan is plain Python, so the CPU tests reach it."""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import check, current_stream, library, ptr

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_I = ctypes.c_int
_ARGTYPES = [_P, _P, _P, _P, _P, _L, _I, _L, _L, _L, _L, _L, _L, _P, _L, _I,
             ctypes.c_float, _I, _I, _L, _L, _P, _P]
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROUTES = {"tile": 0, "mma": 1, "split": 2, "wgmma": 3}
MAX_D = 128                 # head dims every route covers
KEY_TILE = 64               # keys per tile of the prefill kernels
SPLIT_ROWS = 16             # most G * S rows one split block takes
SPLIT_MIN_KEYS = 256        # keys a split chunk streams at least
SPLIT_BLOCKS_PER_SM = 16    # split blocks aimed at per SM: many short
#                             waves, so the last one idles few SMs
H100_SMS = 132


class Plan(NamedTuple):
    route: str              # "wgmma", "mma", "split" or "tile"
    vec: int                # bytes per cp.async copy (0: element loads)
    n_split: int            # key chunks (1 unless route == "split")
    chunk: int              # keys per chunk, a multiple of KEY_TILE
    t_end: int              # keys [0, t_end) some row sees


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_plan(b: int, hkv: int, rows: int, t_end: int,
               n_sm: int = H100_SMS) -> tuple[int, int]:
    """(n_split, chunk) for keys [0, t_end) of each of b * hkv (batch, KV
    head) pairs with ``rows`` = G * S query rows each. Chunks of ``chunk``
    keys (a multiple of KEY_TILE, at least SPLIT_MIN_KEYS) cover
    [0, t_end) in order, the last one ragged. n_split is 1 where the
    unsplit launch already fills the card (2 blocks per SM) or a block
    cannot take the rows; else the chunks give about SPLIT_BLOCKS_PER_SM
    blocks per SM."""
    blocks = b * hkv
    whole = _cdiv(t_end, KEY_TILE) * KEY_TILE
    if rows > SPLIT_ROWS or blocks >= 2 * n_sm:
        return 1, whole
    want = _cdiv(SPLIT_BLOCKS_PER_SM * n_sm, blocks)
    chunk = _cdiv(max(SPLIT_MIN_KEYS, _cdiv(t_end, want)), KEY_TILE) \
        * KEY_TILE
    return _cdiv(t_end, chunk), min(chunk, whole)


def _vec_bytes(tensors, d: int) -> int:
    """The widest cp.async copy (16, 8 or 4 bytes) that every tensor takes:
    its address, the strides of its first three dims and the head dim whole
    chunks; 0 where none does."""
    size = tensors[0].element_size()
    for vec in (16, 8, 4):
        e = vec // size
        if e >= 1 and d % e == 0 and all(
                t.data_ptr() % vec == 0
                and all(s % e == 0 for s in t.stride()[:3])
                for t in tensors):
            return vec
    return 0


def plan(q, k, v, *, causal: bool, q_start: int, n_sm: int | None = None,
         chunk: int | None = None, lse: bool = False) -> Plan:
    """The route for (B, H, S, d) attention of q over k, v (B, Hkv, T, d),
    chosen by shape and layout before any launch: "split" where the rows
    of a KV head fit one split block and the unsplit grid would not fill
    the card; else for bf16 "wgmma" where every input takes 16-byte copies
    (whole 8-element column groups: TMA's boxes) and T holds a 64-key
    tile, "mma" where the copies take 8 bytes; else "tile". ``n_sm``
    defaults to the card's SM count (132 off the card).
    A ``chunk`` forces the split route with chunks of that many keys (the
    checks' small shapes); ``lse`` forces it with `split_plan`'s chunks
    (one chunk where the unsplit grid fills the card): only that route
    returns each row's log-sum-exp."""
    b, h, s, d = q.shape
    hkv, t_n = k.shape[1], k.shape[2]
    if n_sm is None:
        n_sm = (torch.cuda.get_device_properties(q.device)
                .multi_processor_count if q.device.type == "cuda"
                else H100_SMS)
    t_end = min(t_n, q_start + s) if causal else t_n
    if chunk is not None:
        return Plan("split", _vec_bytes((k, v), d), _cdiv(t_end, chunk),
                    chunk, t_end)
    n_split, chunk = split_plan(b, hkv, h // hkv * s, t_end, n_sm)
    if n_split > 1 or lse:
        return Plan("split", _vec_bytes((k, v), d), n_split, chunk, t_end)
    vec = _vec_bytes((q, k, v), d)
    if q.dtype == torch.bfloat16 and vec == 16 and t_n >= KEY_TILE:
        return Plan("wgmma", vec, 1, chunk, t_end)
    if q.dtype == torch.bfloat16 and vec >= 8:
        return Plan("mma", vec, 1, chunk, t_end)
    return Plan("tile", 0, 1, chunk, t_end)


def split_scratch_numel(b: int, hkv: int, rows: int, n_split: int,
                        d: int) -> int:
    """float32 elements of the split route's partials: (m, l, acc[d_pad])
    per (batch x KV head, row, chunk), d_pad = d rounded up to 8."""
    return b * hkv * rows * n_split * (_cdiv(d, 8) * 8 + 2)


def _entry():
    fn = library("flash_attention.cu").flash_attention
    if fn.argtypes != _ARGTYPES:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def flash_attention_kernel(q, k, v, *, causal: bool, scale: float,
                           q_start: int, route: Plan | None = None,
                           lse: torch.Tensor | None = None):
    """(B, H, S, d) attention of CUDA tensors q (B, H, S, d) and k, v
    (B, Hkv, T, d), float32 or bfloat16, each a strided view whose last dim
    is contiguous. The output is a (B, H, S, d) view of fresh (B, S, H, d)
    storage, so the model's (B, S, H * d) projection input needs no copy.
    ``route`` is `plan`'s (taken when None); a plan the shape does not fit
    raises. An ``lse``, a contiguous float32 (B, H, S) on q's device, takes
    each row's log-sum-exp of its scaled scores (route "split" only)."""
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
    if route is None:
        route = plan(q, k, v, causal=causal, q_start=q_start,
                     lse=lse is not None)
    if lse is not None and (route.route != "split"
                            or lse.shape != (b, h, s)
                            or lse.dtype != torch.float32
                            or not lse.is_contiguous()
                            or lse.device != q.device):
        raise ValueError(f"lse must be a contiguous float32 {(b, h, s)} on "
                         f"{q.device} and the route 'split', got "
                         f"{tuple(lse.shape)} {lse.dtype} on {lse.device}, "
                         f"route {route.route!r}")
    out = torch.empty((b, s, h, d), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    part = None
    part_n = 0
    if route.route == "split":
        part_n = split_scratch_numel(b, hkv, h // hkv * s, route.n_split, d)
        part = torch.empty(part_n, dtype=torch.float32, device=q.device)
    strides = (_L * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                        *out.stride()[:3])
    status = _entry()(ptr(q), ptr(k), ptr(v), ptr(out), ptr(part), part_n,
                      DTYPES[q.dtype], b, h, hkv, s, t_n, d,
                      ctypes.cast(strides, _P), q_start, int(causal), scale,
                      ROUTES[route.route], route.vec, route.n_split,
                      route.chunk, current_stream(q.device), ptr(lse))
    check(status, f"flash_attention ({route.route})")
    return out
