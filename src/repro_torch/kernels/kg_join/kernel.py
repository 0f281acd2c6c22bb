"""ctypes bindings, tile plan and launches of the kg_join CUDA kernels
(csrc/kg_join.cu): merge-join candidate ranges, their select epilogue and
the compat matrix.

The range search and its select read their inputs in place: the leading
dims of the op's arguments stay as they are (at most ``MAX_LEAD`` after
folding), each with its stride per input, so a broadcast dim is read
without a copy; only the last dims (the keys of a block, the row keys, the
row mask) are contiguous. Outputs are flat and instance-major. The compat
matrix takes flat instance-major buffers.
"""
from __future__ import annotations

import ctypes
import functools
import struct
from dataclasses import dataclass

import torch

from repro_torch.kernels import check, current_stream, library, ptr, require

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_RANGES_ARGS = [_P, _P, ctypes.c_char_p, _P, _P, _L, _L, _L, _L, _L, _L, _L,
                _L, _P]
_SELECT_ARGS = [_P, _P, _P, ctypes.c_char_p, _P, _P, _P, _P, _P, _P, _L, _L,
                _L, _L, _L, _L, _L, _L, _L, _L, _L, _P]
_COMPAT_ARGS = [_P, _P, _P, _P, _P, _P, _P, _L, _L, _L, _L, _P]
KEY_BUDGET = 16384       # keys of a block staged in shared memory (64 KB)
THREADS = 256            # a block's threads, as kMaxThreads
ILP = 8                  # row keys a thread searches at once, as kIlp
MAX_ROWS_PER_THREAD = 32
# blocks a launch aims for on the H100's 132 SMs: four a SM for the search
# (three fit by shared memory, so a short last wave balances the SMs), two
# for the select's tiles
RANGES_MIN_BLOCKS = 528
SELECT_MIN_BLOCKS = 264
SMEM_BYTES = 232448      # dynamic shared memory a block may use (227 KB)
MAX_LEAD = 4             # leading dims the kernels take, as kMaxLead
MAX_KEY_BLOCKS = 65535   # key blocks an instance, as the C entries check
MAX_INT32 = 2**31 - 1


@dataclass(frozen=True)
class Tiling:
    """Tiles of tile_rows = THREADS * rows_per_thread row keys; thread t
    takes rows t + THREADS * q. ``blocks`` is the launch's grid and
    ``smem_bytes`` its dynamic shared memory."""
    rows_per_thread: int
    tile_rows: int
    tiles_per_instance: int
    blocks: int
    smem_bytes: int


@dataclass(frozen=True)
class Plan:
    """How the launches cover ``instances`` x ``sb`` key blocks of ``c``
    keys against ``r`` row keys. route "shared": the whole tree of a key
    block in shared memory; "splitter": its top levels there (every
    2^shift-th key, ``staged`` of them) and the last ``shift`` levels read
    from device memory. ``ranges`` tiles the search launch (one block per
    key block and row tile); ``select`` the select epilogue's launch after
    it (one block per row tile, every key block, claimed in order, one
    status word a tile)."""
    route: str
    shift: int
    levels: int
    staged: int
    ranges: Tiling
    select: Tiling


def _tree_bytes(staged: int, smem_levels: int) -> int:
    """The staged keys and an INT_MAX sentinel for each level in shared
    memory, 16-byte aligned (as tree_bytes in kg_join.cu)."""
    return -(-(staged + smem_levels) * 4 // 16) * 16


def _tiling(per_block: int, r: int, smem_of, min_rpt: int,
            min_blocks: int) -> Tiling:
    """The most rows a thread (down from 32, min_rpt at least) that fit
    shared memory (``smem_of(tile rows)``) and give min_blocks blocks;
    short of that, ILP rows a thread, or fewer where only fewer fit."""
    fits = []
    rpt = MAX_ROWS_PER_THREAD
    while rpt >= min_rpt:
        rows = THREADS * rpt
        if smem_of(rows) <= SMEM_BYTES:
            fits.append((rpt, rows))
        rpt //= 2
    if not fits:
        raise ValueError("kg_join cannot fit a tile in shared memory")
    pick = next((f for f in fits if per_block * -(-r // f[1]) >= min_blocks),
                None)
    if pick is None:
        pick = min((f for f in fits if f[0] >= ILP), default=fits[-1])
    rpt, rows = pick
    tiles = -(-r // rows)
    blocks = per_block * tiles
    if blocks > MAX_INT32:
        raise ValueError(f"kg_join grid of {blocks} blocks is too large")
    return Tiling(rpt, rows, tiles, blocks, smem_of(rows))


@functools.lru_cache(maxsize=256)
def plan(instances: int, sb: int, c: int, r: int) -> Plan:
    """The launches' route and tiles. The tree keeps at most KEY_BUDGET
    keys in shared memory (the smallest shift that fits). The search
    launch takes the most rows a thread (up to 32) that still gives
    RANGES_MIN_BLOCKS blocks, so a key block is staged few times; the
    select launch likewise (SELECT_MIN_BLOCKS), with its (rows x sb)
    counts in shared memory. Raises past int32 counts, on an empty shape or when a tile cannot
    fit its shared memory."""
    if instances < 1 or sb < 1 or r < 1:
        raise ValueError(f"kg_join needs at least one instance, key block "
                         f"and row key, got {instances}, {sb}, {r}")
    if not 0 <= c <= MAX_INT32 or r > MAX_INT32 or sb > MAX_KEY_BLOCKS:
        raise ValueError(f"kg_join takes at most {MAX_INT32} keys and row "
                         f"keys and {MAX_KEY_BLOCKS} key blocks, got {c}, {r} "
                         f"and {sb}")
    shift = 0
    while c >> shift > KEY_BUDGET:
        shift += 1
    staged = c >> shift
    tree = _tree_bytes(staged, max(c.bit_length() - shift, 0))
    ranges = _tiling(instances * sb, r, lambda rows: tree, ILP,
                     RANGES_MIN_BLOCKS)
    select = _tiling(instances, r, lambda rows: rows * sb * 4, 1,
                     SELECT_MIN_BLOCKS)
    return Plan("shared" if shift == 0 else "splitter", shift,
                c.bit_length(), staged, ranges, select)


_ENTRIES: dict = {}


def _entry(name: str, argtypes):
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = getattr(library("kg_join.cu"), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _ENTRIES[name] = fn
    return fn


def _lead_bytes(lead, strides) -> bytes:
    """nd, then the sizes and each input's strides, MAX_LEAD int64 each."""
    pad = (0,) * (MAX_LEAD - len(lead))
    vals = (len(lead), *lead, *pad)
    for st in strides:
        vals += (*st, *pad)
    return struct.pack(f"{len(vals)}q", *vals)


def _check_inputs(keys, rkey, tmask, lead):
    """(instances, sb, c, r) of the search's inputs, validated: CUDA int32
    keys (…, sb, c) and rkey (…, r), bool tmask (…, r) or None, whose
    leading dims are ``lead`` (at most MAX_LEAD) and whose last dims are
    contiguous."""
    if keys.device.type != "cuda":
        raise ValueError(f"keys must be a CUDA tensor, got {keys.device}")
    if len(lead) > MAX_LEAD:
        raise ValueError(f"kg_join takes at most {MAX_LEAD} leading dims")
    for t, name, dtype in ((keys, "keys", torch.int32),
                           (rkey, "rkey", torch.int32),
                           (tmask, "tmask", torch.bool)):
        if t is None:
            continue
        if t.device != keys.device or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} on keys' device")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError(f"{name}'s last dim must be contiguous")
    sb, c = keys.shape[-2:]
    r = rkey.shape[-1]
    if tmask is not None and tmask.shape[-1] != r:
        raise ValueError(f"tmask {tuple(tmask.shape)} does not match rkey "
                         f"{tuple(rkey.shape)}")
    n_inst = 1
    for s in lead:
        n_inst *= s
    return n_inst, sb, c, r


def ranges_kernel(keys, rkey, lead, strides):
    """(lo, hi) (I, sb, r) int32 of keys (…, sb, c) int32 (sorted per block,
    INT_MAX-padded) and rkey (…, r) int32 < INT_MAX, CUDA tensors whose
    leading dims are ``lead`` with strides ``strides`` (keys, rkey and an
    absent row mask, 0 where broadcast or absent); I = prod(lead)."""
    n_inst, sb, c, r = _check_inputs(keys, rkey, None, lead)
    lo, hi = torch.empty((2, n_inst, sb, r), dtype=torch.int32,
                         device=keys.device)
    if n_inst == 0 or r == 0:
        return lo, hi
    p = plan(n_inst, sb, c, r)
    status = _entry("kg_join_ranges", _RANGES_ARGS)(
        ptr(keys), ptr(rkey), _lead_bytes(lead, strides), ptr(lo),
        ptr(hi), n_inst, sb, c, r, keys.stride(-2), THREADS,
        p.ranges.rows_per_thread, p.shift, current_stream(keys.device))
    check(status, "kg_join_ranges")
    return lo, hi


def select_kernel(keys, rkey, tmask, lead, strides, fan: int, cap: int):
    """The merge join's search and stable compaction of its (row, block,
    slot) pairs: (lo (I, sb, r), counts (I, sb, r), order (I, k), omask
    (I, k), total (I,)) with k = min(cap, r * sb * fan). Arguments as for
    `ranges_kernel`, tmask required. A search launch writes lo and counts
    and a second launch selects from them."""
    if tmask is None:
        raise ValueError("join_select needs tmask")
    n_inst, sb, c, r = _check_inputs(keys, rkey, tmask, lead)
    n = r * sb * fan
    if fan < 1 or n == 0:
        raise ValueError(f"join_select needs a pair slot: r {r}, sb {sb}, "
                         f"fan-out cap {fan}")
    if n > MAX_INT32:
        raise ValueError(f"join_select takes fewer than 2^31 pair slots, "
                         f"got r * sb * K = {n}")
    if cap < 0:
        raise ValueError(f"cap must be at least 0, got {cap}")
    k = min(cap, n)
    dev = keys.device
    # one int32 buffer for lo, counts, order and total
    size = n_inst * sb * r
    out = torch.empty(2 * size + n_inst * (k + 1), dtype=torch.int32,
                      device=dev)
    lo = out[:size].view(n_inst, sb, r)
    counts = out[size:2 * size].view(n_inst, sb, r)
    order = out[2 * size:2 * size + n_inst * k].view(n_inst, k)
    total = out[2 * size + n_inst * k:]
    omask = torch.empty((n_inst, k), dtype=torch.bool, device=dev)
    if n_inst == 0:
        return lo, counts, order, omask, total
    p = plan(n_inst, sb, c, r)
    status = torch.empty(n_inst * p.select.tiles_per_instance + 1,
                         dtype=torch.int64, device=dev)
    err = _entry("kg_join_select", _SELECT_ARGS)(
        ptr(keys), ptr(rkey), ptr(tmask), _lead_bytes(lead, strides),
        ptr(lo), ptr(counts), ptr(order), ptr(omask), ptr(total),
        ptr(status), n_inst, sb, c, r, keys.stride(-2), fan, k, THREADS,
        p.select.rows_per_thread, p.ranges.rows_per_thread, p.shift,
        current_stream(dev))
    check(err, "kg_join_select")
    return lo, counts, order, omask, total


def compat_matrix_kernel(table, tmask, matches, mmask, kind, col):
    """(I, R, C) bool compat matrix from table (I, R, V) int32, tmask (I, R)
    bool, matches (I, C, 3) int32, mmask (I, C) bool, kind/col (I, 3)
    int32, all contiguous CUDA."""
    require(table, "table", torch.int32, 3)
    require(tmask, "tmask", torch.bool, 2)
    require(matches, "matches", torch.int32, 3)
    require(mmask, "mmask", torch.bool, 2)
    require(kind, "kind", torch.int32, 2)
    require(col, "col", torch.int32, 2)
    n_inst, r, v = table.shape
    c = matches.shape[1]
    if (tmask.shape != (n_inst, r) or matches.shape != (n_inst, c, 3)
            or mmask.shape != (n_inst, c) or kind.shape != (n_inst, 3)
            or col.shape != (n_inst, 3) or v < 1):
        raise ValueError("compat_matrix operands do not agree: table "
                         f"{tuple(table.shape)}, tmask {tuple(tmask.shape)}, "
                         f"matches {tuple(matches.shape)}, mmask "
                         f"{tuple(mmask.shape)}, kind {tuple(kind.shape)}, "
                         f"col {tuple(col.shape)}")
    if n_inst > 65535 or -(-r // 64) > 65535:
        raise ValueError(f"compat_matrix grid too large: {n_inst} "
                         f"instances x {r} rows")
    out = torch.empty((n_inst, r, c), dtype=torch.bool, device=table.device)
    status = _entry("kg_compat_matrix", _COMPAT_ARGS)(
        ptr(table), ptr(tmask), ptr(matches), ptr(mmask), ptr(kind),
        ptr(col), ptr(out), n_inst, r, v, c, current_stream(table.device))
    check(status, "kg_compat_matrix")
    return out
