"""ctypes binding, launch plan and launch of the CIN-layer CUDA kernel
(csrc/cin.cu): bf16 tensor cores (wgmma) on hi/lo splits of z and w.

`plan` picks the block's row tile (64 or 128 rows (b, d), one or two
consumer warpgroups), its column tile (72 or 200 columns k, the wgmma
widths the source instantiates) and the depth of the w ring, so that the
grid fills the card's 132 SMs at the served batches and the block fits in
shared memory."""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import check, current_stream, library, ptr, require

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_ARGTYPES = [_P, _P, _P, _P, _P] + [_L] * 10 + [_P]
ROWS = (128, 64)            # rows (b, d) per block: 2 or 1 consumer warpgroups
COLS = (200, 72)            # columns k per block: wgmma m64n200 / m64n72
SLOTS = 32                  # reduction slots p per ring stage (kSlots)
STAGES = (4, 3, 2)          # ring depths tried, deepest first
SMS = 132                   # streaming multiprocessors of an H100 SXM
SMEM_LIMIT = 232448         # dynamic shared memory one Hopper block can use


@dataclasses.dataclass(frozen=True)
class Plan:
    """One launch of cin_wgmma: row tile r covers examples
    [b0, b0 + examples) x dims [d0, d0 + d_span) (d fastest), column tile c
    covers k in [c * cols, (c + 1) * cols)."""
    rows: int
    cols: int
    examples: int
    d_span: int
    d_tiles: int
    row_tiles: int
    col_tiles: int
    stages: int
    smem: int

    @property
    def blocks(self) -> int:
        return self.row_tiles * self.col_tiles

    def tile(self, r: int, c: int) -> tuple[int, int, int]:
        """(b0, d0, k0) of block (r, c), as the source computes them."""
        return ((r // self.d_tiles) * self.examples,
                (r % self.d_tiles) * self.d_span, c * self.cols)


def padded(h: int, f: int) -> tuple[int, int]:
    """The reduction axis the kernel walks, (f group, h, f mod 8): h
    rounded up to 2 and f to 8 (the padding is zero)."""
    return -(-h // 2) * 2, -(-f // 8) * 8


def n_stages(h: int, f: int) -> int:
    """Ring stages along the padded reduction axis: 32 slots each."""
    h2, f8 = padded(h, f)
    return -(-(h2 * f8) // SLOTS)


def smem_bytes(rows: int, cols: int, stages: int, h: int, f: int) -> int:
    """Dynamic shared memory of one block (as layout() in the source): the
    w ring, then the staged xk and x0 rows (padded; rows + 4 floats each),
    the output tile reusing both, then the barriers."""
    h2, f8 = padded(h, f)
    ld = rows + 4
    in_end = stages * cols * 128 + 4 * (h2 + f8) * ld
    out_end = 4 * rows * (cols + 1)
    return -(-max(in_end, out_end) // 8) * 8 + 16 * stages


def scratch_elems(plan: Plan, h: int, f: int) -> int:
    """bf16 elements of the split-w scratch: per column tile and stage,
    hi and lo of 2 steps x 16 slots x cols."""
    return plan.col_tiles * n_stages(h, f) * plan.cols * 64


@functools.lru_cache(maxsize=256)
def plan(b: int, h: int, f: int, d: int, k: int) -> Plan:
    """The launch for xk (b, h, d), x0 (b, f, d), w (k, h, f). Candidates
    are every (rows, cols) that fits in shared memory with at least two
    ring stages; each is scored by its waves of blocks over the card's SMs
    times its column tile (a block of 64 rows is scored as one of 128: it
    reads the same w from L2 for half the work). The least score wins,
    then the larger row tile, then the larger column tile. Raises when
    nothing fits."""
    best = None
    for rt in ROWS:
        for nt in COLS:
            stages = next((s for s in STAGES
                           if smem_bytes(rt, nt, s, h, f) <= SMEM_LIMIT), None)
            if stages is None:
                continue
            ds = min(d, rt)
            ex = rt // ds
            d_tiles = -(-d // ds)
            p = Plan(rows=rt, cols=nt, examples=ex, d_span=ds,
                     d_tiles=d_tiles, row_tiles=-(-b // ex) * d_tiles,
                     col_tiles=-(-k // nt), stages=stages,
                     smem=smem_bytes(rt, nt, stages, h, f))
            score = (-(-p.blocks // SMS) * nt, -rt, -nt)
            if best is None or score < best[0]:
                best = (score, p)
    if best is None:
        raise ValueError(f"cin stages H + F = {h + f} rows per block: no "
                         f"row and column tile fits in {SMEM_LIMIT} bytes")
    return best[1]


def _entry():
    fn = library("cin.cu").cin_layer
    if fn.argtypes != _ARGTYPES:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def cin_layer_kernel(xk, x0, w):
    """(B, K, D) float32 from contiguous float32 CUDA tensors xk (B, H, D),
    x0 (B, F, D) and w (K, H, F), launched as ``plan`` of the shapes."""
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
    p = plan(b, h, f, d, k)
    if p.col_tiles > 65535 or p.row_tiles > 2**31 - 1:
        raise ValueError(f"cin's grid {p.row_tiles} x {p.col_tiles} is too "
                         "large")
    out = torch.empty((b, k, d), dtype=torch.float32, device=xk.device)
    ws = torch.empty((scratch_elems(p, h, f),), dtype=torch.bfloat16,
                     device=xk.device)
    status = _entry()(ptr(xk), ptr(x0), ptr(w), ptr(ws), ptr(out), b, h, f,
                      d, k, p.rows, p.cols, p.examples, p.d_span, p.stages,
                      current_stream(xk.device))
    check(status, "cin_layer")
    return out
