"""ctypes bindings, tile plans and launches of the kg_join CUDA kernels:
merge-join candidate ranges and their select epilogue (csrc/kg_join.cu),
the expand join's compat matrix and its select epilogue
(csrc/kg_compat.cu).

Every kernel reads its inputs in place: the leading dims of the op's
arguments stay as they are (at most ``MAX_LEAD`` after folding), each with
its stride per input, so a broadcast dim is read without a copy. The range
search and its select take contiguous last dims (the keys of a block, the
row keys, the row mask); the compat kernels take every inner stride.
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
_RANGES_ARGS = [_P, _P, ctypes.c_char_p, _P, _P, _L, _L, _L, _L, _L, _L, _L,
                _L, _P]
_SELECT_ARGS = [_P, _P, _P, ctypes.c_char_p, _P, _P, _P, _P, _P, _P, _L, _L,
                _L, _L, _L, _L, _L, _L, _L, _L, _L, _P]
_COMPAT_MATRIX_ARGS = [_P] * 6 + [ctypes.c_char_p, _P, _L, _L, _L, _L, _L,
                                   _L, _P]
_COMPAT_SELECT_ARGS = [_P] * 6 + [ctypes.c_char_p, _P, _P, _P, _P, _P, _P,
                                   _P, _L, _L, _L, _L, _L, _L, _L, _P]
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
# compat: a warp takes a tile of 32 rows (one a lane); a block COMPAT_TILES
# tiles at most (one a warp) and stages COMPAT_CHUNK segments of COMPAT_SEG
# columns at most, as kMaxWarps, kMaxChunk and kSeg; at most
# COMPAT_MAX_SEGS segments a row. The plan's blocks aim at
# COMPAT_MIN_BLOCKS, two an SM.
COMPAT_SEG = 256
COMPAT_TILES = 8
COMPAT_CHUNK = 4
COMPAT_MAX_SEGS = 512
COMPAT_MIN_BLOCKS = 264
COMPAT_SEG_BYTES = (3 * COMPAT_SEG + 8) * 4    # a staged segment, kSegWords
COMPAT_TILE_BYTES = 32 * 9 * 4                 # a transpose buffer, kTileWords
COMPAT_SCAN_THREADS = 128

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


def _entry(name: str, argtypes, source: str = "kg_join.cu"):
    fn = _ENTRIES.get(name)
    if fn is None:
        fn = getattr(library(source), name)
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


@dataclass(frozen=True)
class CompatPlan:
    """How the compat launches cover ``instances`` x ``r`` rows x ``c``
    columns: tiles of 32 rows, ``segments`` of COMPAT_SEG columns a row.
    The matrix launch, and the select's count launch, have a block per
    (instance, ``tiles_per_block`` tiles, chunk of ``chunk_segments``
    segments): the block stages its segments once and each warp takes them
    for one tile; ``blocks`` in all. The select's scan launch has a block
    per tile (``scan_blocks``), claimed in order; its write launch a block
    per (instance, ``tiles_per_block`` tiles, segment) (``write_blocks``)."""
    segments: int
    tiles_per_instance: int
    tiles_per_block: int
    chunk_segments: int
    blocks: int
    scan_blocks: int
    write_blocks: int
    count_smem: int
    matrix_smem: int
    write_smem: int


@functools.lru_cache(maxsize=256)
def compat_plan(instances: int, r: int, c: int, v: int) -> CompatPlan:
    """The compat launches' tiles and grids: the most tiles a block (up to
    COMPAT_TILES), then the most segments it stages (up to COMPAT_CHUNK),
    that still give COMPAT_MIN_BLOCKS blocks; short of that, a tile and a
    segment a block. Raises on an empty shape, past COMPAT_MAX_SEGS
    segments a row, or past a grid of 2^31 - 1 blocks."""
    if instances < 1 or r < 1 or c < 1 or v < 1:
        raise ValueError(f"compat needs at least one instance, row, column "
                         f"and table column, got {instances}, {r}, {c}, {v}")
    if r > MAX_INT32 or v > MAX_INT32:
        raise ValueError(f"compat takes at most {MAX_INT32} rows and table "
                         f"columns, got {r} and {v}")
    segments = -(-c // COMPAT_SEG)
    if segments > COMPAT_MAX_SEGS:
        raise ValueError(f"compat takes at most "
                         f"{COMPAT_MAX_SEGS * COMPAT_SEG} columns, got {c}")
    tiles = -(-r // 32)

    def blocks_of(rw, sc):
        return instances * -(-tiles // rw) * -(-segments // sc)

    shapes = [(rw, sc) for rw in (8, 4, 2, 1) for sc in (4, 2, 1)
              if rw <= max(1, min(COMPAT_TILES, tiles))
              and sc <= max(1, min(COMPAT_CHUNK, segments))]
    rw, sc = next((x for x in shapes
                   if blocks_of(*x) >= COMPAT_MIN_BLOCKS), (1, 1))
    blocks, writes = blocks_of(rw, sc), blocks_of(rw, 1)
    if writes > MAX_INT32:
        raise ValueError(f"compat grid of {writes} blocks is too large")
    count_smem = sc * COMPAT_SEG_BYTES
    return CompatPlan(segments, tiles, rw, sc, blocks, instances * tiles,
                      writes, count_smem,
                      count_smem + rw * COMPAT_TILE_BYTES,
                      COMPAT_SEG_BYTES + rw * COMPAT_TILE_BYTES)


_COMPAT_INPUTS = (("table", torch.int32, 2), ("tmask", torch.bool, 1),
                  ("matches", torch.int32, 2), ("mmask", torch.bool, 1),
                  ("kind", torch.int32, 1), ("col", torch.int32, 1))


def _compat_inputs(args, lead, strides):
    """(instances, r, c, v, lead bytes) of the compat kernels' inputs,
    validated: table (…, r, v) int32, tmask (…, r) bool, matches (…, c, 3)
    int32, mmask (…, c) bool, kind and col (…, 3) int32 on one CUDA
    device, their leading dims ``lead`` (at most MAX_LEAD) with strides
    ``strides``. The bytes hold nd, the sizes, each input's strides over
    ``lead`` and the inner strides, as kg_compat.cu reads them."""
    table = args[0]
    if table.device.type != "cuda":
        raise ValueError(f"table must be a CUDA tensor, got {table.device}")
    if len(lead) > MAX_LEAD:
        raise ValueError(f"compat takes at most {MAX_LEAD} leading dims")
    for t, (name, dtype, _) in zip(args, _COMPAT_INPUTS):
        if t.device != table.device or t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} on table's device")
    table, tmask, matches, mmask, kind, col = args
    r, v = table.shape[-2:]
    c = matches.shape[-2]
    if (tmask.shape[-1] != r or tuple(matches.shape[-1:]) != (3,)
            or mmask.shape[-1] != c or kind.shape[-1] != 3
            or col.shape[-1] != 3):
        raise ValueError("compat operands do not agree: table "
                         f"{tuple(table.shape)}, tmask {tuple(tmask.shape)}, "
                         f"matches {tuple(matches.shape)}, mmask "
                         f"{tuple(mmask.shape)}, kind {tuple(kind.shape)}, "
                         f"col {tuple(col.shape)}")
    n_inst = 1
    for s in lead:
        n_inst *= s
    pad = (0,) * (MAX_LEAD - len(lead))
    vals = (len(lead), *lead, *pad)
    for st in strides:
        vals += (*st, *pad)
    vals += (table.stride(-2), table.stride(-1), tmask.stride(-1),
             matches.stride(-2), matches.stride(-1), mmask.stride(-1),
             kind.stride(-1), col.stride(-1))
    return n_inst, r, c, v, struct.pack(f"{len(vals)}q", *vals)


def compat_matrix_kernel(args, lead, strides):
    """(I, R, C) bool compat matrix of args = (table, tmask, matches, mmask,
    kind, col) as `_compat_inputs` takes them; I = prod(lead)."""
    n_inst, r, c, v, lead_b = _compat_inputs(args, lead, strides)
    out = torch.empty((n_inst, r, c), dtype=torch.bool, device=args[0].device)
    if out.numel() == 0:
        return out
    p = compat_plan(n_inst, r, c, v)
    status = _entry("kg_compat_matrix", _COMPAT_MATRIX_ARGS, "kg_compat.cu")(
        *(ptr(t) for t in args), lead_b, ptr(out), n_inst, r, c, v,
        p.tiles_per_block, p.chunk_segments, current_stream(out.device))
    check(status, "kg_compat_matrix")
    return out


def compat_select_kernel(args, lead, strides, cap: int):
    """The compat select epilogue: (keep (I, R) bool, order (I, k) int32,
    omask (I, k) bool, total (I,) int32) with k = min(cap, R * C), args as
    for `compat_matrix_kernel`. Three launches: count (each row's pairs a
    segment, and their columns where they are one or two: two (I, segments,
    R) int16; it zeroes the scan's status words), scan (keep, each row's
    first slot (I, R) int32, total and the tail) and, for k > 0, write; no
    (I, R, C) tensor."""
    n_inst, r, c, v, lead_b = _compat_inputs(args, lead, strides)
    n = r * c
    if n == 0:
        raise ValueError(f"compat_select needs a pair: r {r}, c {c}")
    if n > MAX_INT32:
        raise ValueError(f"compat_select takes fewer than 2^31 pairs, got "
                         f"r * c = {n}")
    if cap < 0:
        raise ValueError(f"cap must be at least 0, got {cap}")
    k = min(cap, n)
    dev = args[0].device
    ints = torch.empty(n_inst * (k + 1 + r), dtype=torch.int32, device=dev)
    order = ints[:n_inst * k].view(n_inst, k)
    total = ints[n_inst * k:n_inst * (k + 1)]
    rowbase = ints[n_inst * (k + 1):]
    flags = torch.empty(n_inst * (r + k), dtype=torch.bool, device=dev)
    keep = flags[:n_inst * r].view(n_inst, r)
    omask = flags[n_inst * r:].view(n_inst, k)
    if n_inst == 0:
        return keep, order, omask, total
    p = compat_plan(n_inst, r, c, v)
    counts = torch.empty(2 * n_inst * p.segments * r, dtype=torch.int16,
                         device=dev)
    status = torch.empty(p.scan_blocks + 1, dtype=torch.int64, device=dev)
    err = _entry("kg_compat_select", _COMPAT_SELECT_ARGS, "kg_compat.cu")(
        *(ptr(t) for t in args), lead_b, ptr(keep), ptr(order), ptr(omask),
        ptr(total), ptr(counts), ptr(rowbase), ptr(status), n_inst, r, c, v,
        k, p.tiles_per_block, p.chunk_segments, current_stream(dev))
    check(err, "kg_compat_select")
    return keep, order, omask, total
