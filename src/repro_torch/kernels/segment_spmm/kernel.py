"""ctypes binding and launch of the segment-sum CUDA kernel
(csrc/segment_spmm.cu), and the segment plan it reads."""
from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch

from repro_torch.kernels import check, current_stream, library, ptr, require

_P = ctypes.c_void_p
_L = ctypes.c_longlong
_ARGTYPES = [_P] * 9 + [_L] * 6 + [ctypes.c_int, _P]
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
INT32_MAX = 2 ** 31 - 1
# A node whose range is longer than PIECE edges is summed in pieces of at
# most PIECE edges, one warp (or block) each, and the pieces are added in
# order by a second kernel. Chosen on an NVIDIA H100 80GB HBM3 (700 W) at
# GCN layer 2 on ogbn-products by `python -m
# repro_torch.kernels.segment_spmm.tune`, which times the kernel under
# plans cut at piece sizes 64 to 4,096 (PERF.md): 256 lies in the flat
# middle of that sweep.
PIECE = 256


@dataclass(frozen=True)
class SegmentPlan:
    """Where each node's live edges lie, built once per graph.

    order: (E,) int32, the stable sort of the live receivers: sorted
    position i holds edge order[i]; the live edges come first.
    offsets: (N + 1,) int64, node v owns the sorted positions
    [offsets[v], offsets[v + 1]).
    The piece table (`ops.piece_table`) cuts every range longer than
    ``piece`` (PIECE) edges into pieces of at most ``piece``, in edge
    order: piece p starts at sorted position piece_start[p] (int64) within
    node piece_node[p] (int32), and ends at the next piece's start or the
    node's end. split_node (S,) int32 are the nodes so cut, in node order,
    and split_pieces (S + 1,) int64 the first piece of each (pieces of
    split_node[s] are [split_pieces[s], split_pieces[s + 1])).
    receivers and edge_mask are the tensors the plan was built from: the
    plan fixes which edges count, and the op takes it only with them."""
    order: torch.Tensor
    offsets: torch.Tensor
    piece_node: torch.Tensor
    piece_start: torch.Tensor
    split_node: torch.Tensor
    split_pieces: torch.Tensor
    receivers: torch.Tensor
    edge_mask: torch.Tensor
    n_edges: int
    n_nodes: int
    piece: int

    @property
    def n_pieces(self) -> int:
        return self.piece_node.shape[0]

    @property
    def n_split(self) -> int:
        return self.split_node.shape[0]

    def check(self, n_edges: int, n_nodes: int) -> None:
        """Raise unless the plan was built for ``n_edges`` edges into
        ``n_nodes`` nodes."""
        if (self.n_edges, self.n_nodes) != (n_edges, n_nodes):
            raise ValueError(
                f"segment plan built for E {self.n_edges}, N {self.n_nodes}; "
                f"called with E {n_edges}, N {n_nodes}")

    def check_edges(self, receivers, edge_mask) -> None:
        """Raise unless the plan was built from these very ``receivers`` and
        ``edge_mask`` tensors: a plan built under another mask of the same
        E and N would give other sums."""
        if receivers is not self.receivers or edge_mask is not self.edge_mask:
            raise ValueError("segment plan built from other receivers or "
                             "another edge mask")


def check_values(values) -> None:
    """Raise unless ``values`` is a contiguous (E, D) float32 or bfloat16
    CUDA tensor."""
    if values.dtype not in _DTYPES:
        raise ValueError(f"values must be float32 or bfloat16, got "
                         f"{values.dtype}")
    require(values, "values", values.dtype, 2)


def _entry():
    fn = library("segment_spmm.cu").segment_spmm_plan
    if fn.argtypes != _ARGTYPES:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def segment_spmm_kernel(values, plan: SegmentPlan, n_nodes: int):
    """(n_nodes, D) sums, in the values' dtype, of the rows of contiguous
    (E, D) float32 or bfloat16 CUDA ``values`` over each node's range of
    ``plan`` (the rows are read in place through ``plan.order``), summed in
    float32. Every output element is written."""
    plan.check(values.shape[0], n_nodes)
    check_values(values)
    for name in ("order", "offsets", "piece_node", "piece_start",
                 "split_node", "split_pieces"):
        t = getattr(plan, name)
        if t.device != values.device or not t.is_contiguous():
            raise ValueError(f"plan.{name} must be contiguous on "
                             f"{values.device}")
    if not 0 <= n_nodes < INT32_MAX:
        raise ValueError(f"n_nodes must lie in [0, 2**31 - 1), got {n_nodes}")
    e, d = values.shape
    out = torch.empty((n_nodes, d), dtype=values.dtype, device=values.device)
    scratch = torch.empty((plan.n_pieces, d), dtype=torch.float32,
                          device=values.device)
    status = _entry()(
        ptr(values), ptr(plan.order), ptr(plan.offsets), ptr(plan.piece_node),
        ptr(plan.piece_start), ptr(plan.split_node), ptr(plan.split_pieces),
        ptr(scratch), ptr(out), e, d, n_nodes, plan.n_pieces, plan.n_split,
        plan.piece, _DTYPES[values.dtype], current_stream(values.device))
    check(status, "segment_spmm_plan")
    return out
