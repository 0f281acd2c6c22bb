"""ctypes binding and launch of the Jaccard CUDA kernels (csrc/jaccard.cu).

`jaccard_pack` packs the float32 membership matrix into a zero-padded
int8 copy of ``packed_width(F)`` columns and takes the row counts;
`jaccard_tri` computes one 128 x 128 output tile per block, for the tiles
(i, j) with i <= j only (``triangle_tile`` maps a block to its tile), on
int8 tensor cores, and writes each off-diagonal tile twice, as (i, j) and
(j, i)."""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import check, current_stream, library, ptr, require

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _P, _L, _L, _L, _P]
TILE = 128             # output tile edge, as kTile in the source
ROW_BYTES = 16         # the packed row stride is a multiple of 16 bytes


def _entry():
    fn = library("jaccard.cu").jaccard_distance
    if fn.argtypes != _ARGTYPES:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def packed_width(f: int) -> int:
    """Columns of the packed int8 copy: F rounded up to 16 bytes, the TMA
    row alignment (4,864 at F = 4,859)."""
    return -(-f // ROW_BYTES) * ROW_BYTES


def n_tiles(q: int) -> int:
    """Blocks of the product: the upper triangle of the (Q / 128)^2 tile
    grid, diagonal included."""
    t = -(-q // TILE)
    return t * (t + 1) // 2


def triangle_tile(t: int) -> tuple[int, int]:
    """Tile (i, j), i <= j, of block ``t`` (as triangle_tile in the source):
    the blocks of column tile j are t = j (j + 1) / 2 + i."""
    j = (math.isqrt(8 * t + 1) - 1) // 2
    return t - j * (j + 1) // 2, j


def jaccard_distance_kernel(m):
    """(Q, Q) float32 distances from a contiguous (Q, F) float32 CUDA
    tensor of zeros and ones (raises on any other value). Ragged Q and F
    are handled in the kernels: the packed copy is scratch."""
    require(m, "m", torch.float32, 2)
    q, f = m.shape
    if f < 1:
        raise ValueError("m needs at least one feature column")
    if n_tiles(q) > 2**31 - 1:
        raise ValueError(f"jaccard's {n_tiles(q)} tiles exceed a grid of "
                         f"2**31 - 1 blocks")
    fp = packed_width(f)
    packed = torch.empty((q, fp), dtype=torch.int8, device=m.device)
    counts = torch.empty((q,), dtype=torch.int32, device=m.device)
    bad = torch.zeros((1,), dtype=torch.int32, device=m.device)
    out = torch.empty((q, q), dtype=torch.float32, device=m.device)
    status = _entry()(ptr(m), ptr(packed), ptr(counts), ptr(bad), ptr(out),
                      q, f, fp, current_stream(m.device))
    check(status, "jaccard_distance")
    if bad.item():
        raise ValueError("jaccard_distance takes a 0/1 membership matrix")
    return out
