"""ctypes binding, tile plan and launch of the kg_scan CUDA kernel
(csrc/kg_scan.cu).

The kernel reads its inputs in place: the leading dims of the op's
arguments stay as they are (at most ``MAX_LEAD`` after folding), each with
its stride per input, so a broadcast dim is read without a copy. Only the
last dims, (N, 3) of the triples and (N,) of the mask, are contiguous.
Outputs are flat and instance-major.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from dataclasses import dataclass

import torch

from repro_torch.kernels import check, current_stream, library, ptr

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, ctypes.c_char_p, _P, _P, _P, _P, _P, _L, _P, _L,
             _L, _L, _L, _P]
SEG_ROWS = 16            # rows of one 16-byte load of the mask
MAX_VECS = 8             # such loads a thread, at most (a power of 2)
MAX_THREADS = 512        # as kMaxThreads
MIN_TILES = 1024         # tiles grow while a launch keeps this many
MAX_LEAD = 4             # leading dims the kernel takes, as kMaxLead
MAX_INSTANCES = 65535
MAX_ROWS = 2**31 - 1     # rows per instance (int32 counts and indices)


@dataclass(frozen=True)
class Plan:
    """How one launch covers ``instances`` x ``n`` rows: tile t holds rows
    [(t % tiles_per_instance) * tile_rows, … + tile_rows) of instance
    t // tiles_per_instance; one status word per tile."""
    threads: int
    rows_per_thread: int
    tile_rows: int
    tiles_per_instance: int
    tiles: int
    status_words: int


@functools.lru_cache(maxsize=256)
def plan(n: int, instances: int) -> Plan:
    """The launch's tiles: warps enough for n rows at 16 rows a thread, up
    to 512 threads (8,192-row tiles); then, while the launch would keep at
    least MIN_TILES tiles, twice the rows a thread, up to 128 (65,536-row
    tiles), since a block's loads are in flight only until its look-back.
    Raises beyond 65,535 instances or past 2^31 - 1 rows per instance."""
    if not 0 <= instances <= MAX_INSTANCES:
        raise ValueError(f"kg_scan takes at most {MAX_INSTANCES} instances, "
                         f"got {instances}")
    if not 0 <= n <= MAX_ROWS:
        raise ValueError(f"kg_scan takes at most {MAX_ROWS} rows per "
                         f"instance, got {n}")
    warps = -(-n // (32 * SEG_ROWS))
    threads = 32 * min(max(warps, 1), MAX_THREADS // 32)
    vecs = 1
    while vecs < MAX_VECS and instances * -(-n // (
            threads * SEG_ROWS * vecs * 2)) >= MIN_TILES:
        vecs *= 2
    tile_rows = threads * SEG_ROWS * vecs
    per_inst = -(-n // tile_rows)
    tiles = instances * per_inst
    return Plan(threads, SEG_ROWS * vecs, tile_rows, per_inst, tiles, tiles)


_ENTRY = []


def _entry():
    if not _ENTRY:
        fn = library("kg_scan.cu").kg_scan
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
        _ENTRY.append(fn)
    return _ENTRY[0]


def _lead_bytes(lead, strides) -> bytes:
    """nd, then the sizes and each input's strides, MAX_LEAD int64 each."""
    pad = (0,) * (MAX_LEAD - len(lead))
    vals = (len(lead), *lead, *pad)
    for st in strides:
        vals += (*st, *pad)
    return struct.pack(f"{len(vals)}q", *vals)


def scan_kernel(triples, valid, spo, eq, lead, strides, *, k=None,
                with_hit=True, with_cum=True):
    """Launch the scan over ``lead`` instances of n rows.

    valid (…, N) bool, triples (…, N, 3) int32 or None, spo (…, 3) int32
    (None with triples None), eq (…, 3) bool or None: CUDA tensors whose
    leading dims are ``lead`` (at most MAX_LEAD) with strides ``strides``
    (valid, triples, spo, eq; 0 where broadcast or absent) and whose last
    dims are contiguous. Returns (hit (…, N) bool or None, cum (…, N)
    int32 or None) when k is None, else (hit or None, idx (…, k) int32,
    sel (…, k) bool, total (…,) int32) with k <= N, the leading dims
    valid's. hit is written when the triples are given and ``with_hit``;
    cum (k None) when ``with_cum``; at least one of them.
    """
    if valid.device.type != "cuda":
        raise ValueError(f"valid must be a CUDA tensor, got {valid.device}")
    if valid.dtype != torch.bool:
        raise ValueError(f"valid must be torch.bool, got {valid.dtype}")
    if len(lead) > MAX_LEAD:
        raise ValueError(f"kg_scan takes at most {MAX_LEAD} leading dims")
    n = valid.shape[-1]
    if n > 1 and valid.stride(-1) != 1:
        raise ValueError("valid's last dim must be contiguous")
    if triples is not None:
        if triples.device != valid.device or triples.dtype != torch.int32:
            raise ValueError("triples must be int32 on valid's device")
        if triples.shape[-2:] != (n, 3) or triples.stride(-1) != 1 \
                or (n > 1 and triples.stride(-2) != 3):
            raise ValueError(f"triples must end in a contiguous ({n}, 3), "
                             f"got {tuple(triples.shape)} strides "
                             f"{triples.stride()}")
        if spo is None or spo.dtype != torch.int32 or spo.stride(-1) != 1:
            raise ValueError("spo must be int32 with a contiguous last dim")
        if eq is not None and (eq.dtype != torch.bool or eq.stride(-1) != 1):
            raise ValueError("eq must be bool with a contiguous last dim")
    n_inst = 1
    for s in lead:
        n_inst *= s
    p = plan(n, n_inst)
    dev = valid.device
    shape = valid.shape
    hit = None if triples is None or not with_hit else torch.empty(
        shape, dtype=torch.bool, device=dev)
    cum = idx = sel = total = None
    if k is None:
        if not with_cum and hit is None:
            raise ValueError("kg_scan would write nothing")
        if with_cum:
            cum = torch.empty(shape, dtype=torch.int32, device=dev)
    else:
        if not 0 <= k <= n:
            raise ValueError(f"k must lie in [0, {n}], got {k}")
        idx = torch.empty((*shape[:-1], k), dtype=torch.int32, device=dev)
        sel = torch.empty((*shape[:-1], k), dtype=torch.bool, device=dev)
        total = torch.empty(shape[:-1], dtype=torch.int32, device=dev)
    status = torch.empty(p.status_words + 1, dtype=torch.int64, device=dev)
    err = _entry()(ptr(triples), ptr(valid), ptr(spo), ptr(eq),
                   _lead_bytes(lead, strides), ptr(hit), ptr(cum), ptr(idx),
                   ptr(sel), ptr(total), -1 if k is None else k, ptr(status),
                   n_inst, n, p.threads, p.rows_per_thread // SEG_ROWS,
                   current_stream(dev))
    check(err, "kg_scan")
    return (hit, cum) if k is None else (hit, idx, sel, total)
