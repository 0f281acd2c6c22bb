"""Public segment-sum op and its segment plan: dispatch.

`segment_plan` stands where the TPU op's argsort and per-block range
tables stand (src/repro/kernels/segment_spmm/ops.py): built once per graph,
in plain PyTorch on the receivers' device, and handed to every segment
sum over that graph's edges. As the TPU op does, a masked edge gets a
sentinel receiver past every node (and so does a receiver outside
[0, n_nodes), which `jax.ops.segment_sum` drops) and the edges are sorted
stably by receiver; unlike it, nothing is padded to a block and the values
are never sorted or copied: the kernel reads them through the plan's
order.

A CPU tensor runs a plain version (`ref.segment_spmm_ref`, or with a plan
`ref.segment_spmm_plan_ref`, which reads the plan as the kernel does); a
CUDA tensor launches the segment-sum kernel, and anything the kernel does
not take raises. There is no fallback from the card to the plain version.

On the card the op is differentiable (`SegmentSum`): the kernel is the
forward, and the backward is the segment sum's transpose, a gather of the
output gradient at each live edge's receiver in plain PyTorch
(`ref.segment_spmm_backward`), as XLA transposes `jax.ops.segment_sum`.
The TPU kernel has no backward of its own. The plain versions on the CPU
are differentiable as they stand.

On meta tensors `segment_plan` returns a plan of meta tensors (its sort
and search as on the card, an empty piece table: the table's sizes are
read from the host) and the op returns a meta output under the same
autograd function, launching nothing, its bound's work counted in
`kernels.meta_cost`.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import is_meta, meta_cost, nbytes
from repro_torch.kernels.segment_spmm.kernel import (INT32_MAX, PIECE,
                                                     SegmentPlan,
                                                     check_values,
                                                     segment_spmm_kernel)
from repro_torch.kernels.segment_spmm.ref import (segment_spmm_backward,
                                                  segment_spmm_plan_ref,
                                                  segment_spmm_ref)


def segment_plan(receivers: torch.Tensor, edge_mask: torch.Tensor,
                 n_nodes: int, *, assume_sorted: bool = False) -> SegmentPlan:
    """The segment plan of (E,) ``receivers`` under the (E,) ``edge_mask``
    into ``n_nodes`` nodes, on the receivers' device. An edge counts when
    it is live and its receiver lies in [0, n_nodes). ``assume_sorted``
    takes receivers that are already non-decreasing (checked) and builds
    the same plan without the sort. Costs a few host synchronisations (the
    piece table's sizes); count: ``segment_plan.builds``."""
    recv = receivers.to(torch.int32)
    live = edge_mask.to(torch.bool) & (recv >= 0) & (recv < n_nodes)
    dev = recv.device
    if assume_sorted:
        if recv.numel() > 1 and bool((recv[1:] < recv[:-1]).any().item()):
            raise ValueError("assume_sorted: receivers are not sorted")
        # what the stable sort gives on sorted receivers: the live edges in
        # order, then the others
        order = torch.cat([live.nonzero(), (~live).nonzero()])[:, 0]
        keys = recv[live]
    else:
        keys, order = torch.sort(torch.where(live, recv, INT32_MAX),
                                 stable=True)
    offsets = torch.searchsorted(
        keys, torch.arange(n_nodes + 1, dtype=torch.int32, device=dev))
    segment_plan.builds += 1
    if dev.type == "meta":
        none = torch.empty(0, dtype=torch.int32, device=dev)
        return SegmentPlan(
            order=order.to(torch.int32), offsets=offsets, piece_node=none,
            piece_start=torch.empty(0, dtype=torch.int64, device=dev),
            split_node=none,
            split_pieces=torch.zeros(1, dtype=torch.int64, device=dev),
            piece=PIECE, receivers=receivers, edge_mask=edge_mask,
            n_edges=recv.shape[0], n_nodes=n_nodes)
    return SegmentPlan(order=order.to(torch.int32), offsets=offsets,
                       **piece_table(offsets, PIECE), receivers=receivers,
                       edge_mask=edge_mask, n_edges=recv.shape[0],
                       n_nodes=n_nodes)


def piece_table(offsets: torch.Tensor, piece: int) -> dict:
    """The piece table of a plan's ``offsets``: every range longer than
    ``piece`` edges cut into pieces of at most ``piece``, in edge order
    (`SegmentPlan`'s fields piece_node, piece_start, split_node,
    split_pieces and piece)."""
    dev = offsets.device
    n_pieces = torch.div(offsets[1:] - offsets[:-1] + piece - 1, piece,
                         rounding_mode="floor")
    split_node = torch.nonzero(n_pieces > 1)[:, 0]
    counts = n_pieces[split_node]
    split_pieces = torch.zeros(split_node.shape[0] + 1, dtype=torch.int64,
                               device=dev)
    torch.cumsum(counts, 0, out=split_pieces[1:])
    total = int(split_pieces[-1].item())
    piece_node = torch.repeat_interleave(split_node, counts,
                                         output_size=total)
    first = torch.repeat_interleave(split_pieces[:-1], counts,
                                    output_size=total)
    piece_start = offsets[piece_node] + (
        torch.arange(total, dtype=torch.int64, device=dev) - first) * piece
    return dict(piece_node=piece_node.to(torch.int32),
                piece_start=piece_start,
                split_node=split_node.to(torch.int32),
                split_pieces=split_pieces, piece=piece)


segment_plan.builds = 0


class SegmentSum(torch.autograd.Function):
    """The segment-sum kernel under autograd: forward the kernel over a
    built plan, backward `ref.segment_spmm_backward` (no kernel launch;
    ``segment_spmm.launches`` counts forwards only)."""

    @staticmethod
    def forward(ctx, values: torch.Tensor, plan: SegmentPlan,
                n_nodes: int) -> torch.Tensor:
        ctx.plan, ctx.n_nodes = plan, n_nodes
        if is_meta(values):
            e, d = values.shape
            # messages, receivers and mask read once, the output written
            meta_cost.add("segment_spmm", ops=e * d,
                          n_bytes=nbytes(values) + 4 * e + e
                          + values.element_size() * n_nodes * d)
            return values.new_empty((n_nodes, d))
        return segment_spmm_kernel(values, plan, n_nodes)

    @staticmethod
    def backward(ctx, grad_out: torch.Tensor):
        plan = ctx.plan
        return (segment_spmm_backward(grad_out, plan.receivers,
                                      plan.edge_mask, ctx.n_nodes),
                None, None)


def segment_spmm(values: torch.Tensor, receivers: torch.Tensor,
                 edge_mask: torch.Tensor, n_nodes: int, *,
                 assume_sorted: bool = False,
                 plan: SegmentPlan | None = None) -> torch.Tensor:
    """Scatter-sum per-edge messages (E, D) into (n_nodes, D), in the
    values' dtype (float32 or bfloat16 on the card), summed in float32.

    Receivers outside [0, n_nodes) are dropped, as `jax.ops.segment_sum`
    drops them. ``plan`` is the `segment_plan` of these very ``receivers``
    and ``edge_mask`` tensors (anything else raises; the receivers and mask
    are not read again, and ``assume_sorted`` does not apply); on the card
    one is built when none is given, with ``assume_sorted`` passed on."""
    if plan is not None:
        plan.check(values.shape[0], n_nodes)
        plan.check_edges(receivers, edge_mask)
    if values.device.type == "cpu":
        if plan is None:
            return segment_spmm_ref(values, receivers, edge_mask, n_nodes)
        return segment_spmm_plan_ref(values, plan.order, plan.offsets)
    values = values.contiguous()
    if not is_meta(values):
        check_values(values)
    if plan is None:
        plan = segment_plan(receivers, edge_mask, n_nodes,
                            assume_sorted=assume_sorted)
    out = SegmentSum.apply(values, plan, n_nodes)
    if not is_meta(values):
        segment_spmm.launches += 1
    return out


segment_spmm.launches = 0
