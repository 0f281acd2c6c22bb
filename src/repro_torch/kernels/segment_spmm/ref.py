"""Plain PyTorch version of the segment-sum kernel: the CPU path and the
yardstick the CUDA kernel is held against on the card."""
from __future__ import annotations

import torch


def segment_spmm_ref(values: torch.Tensor, receivers: torch.Tensor,
                     edge_mask: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """values: (E, D) per-edge messages; scatter-sum the live edges into
    (n_nodes, D) with `index_add_`, in float32, rounded once to the values'
    dtype. As `jax.ops.segment_sum` does, an edge whose receiver lies
    outside [0, n_nodes) is dropped: it and every masked edge go to a spare
    row past the output, so the values are never copied to be masked."""
    e, d = values.shape
    recv = receivers.to(torch.int64)
    live = edge_mask & (recv >= 0) & (recv < n_nodes)
    out = torch.zeros((n_nodes + 1, d), dtype=torch.float32,
                      device=values.device)
    out.index_add_(0, torch.where(live, recv, n_nodes),
                   values.to(torch.float32))
    return out[:n_nodes].to(values.dtype)


def segment_spmm_plan_ref(values: torch.Tensor, order: torch.Tensor,
                          offsets: torch.Tensor) -> torch.Tensor:
    """The plain version that reads a segment plan as the kernel does:
    out[v] = sum of values[order[offsets[v]:offsets[v + 1]]], by
    `index_add_` in float32 of each sorted position's row into the node
    that owns it, rounded once to the values' dtype. A wrong plan gives a
    wrong sum."""
    n = offsets.shape[0] - 1
    counts = offsets[1:] - offsets[:-1]
    lo, hi = int(offsets[0].item()), int(offsets[-1].item())
    node = torch.repeat_interleave(
        torch.arange(n, device=values.device), counts, output_size=hi - lo)
    rows = values.index_select(0, order[lo:hi].to(torch.int64))
    out = torch.zeros((n, values.shape[1]), dtype=torch.float32,
                      device=values.device)
    out.index_add_(0, node, rows.to(torch.float32))
    return out.to(values.dtype)


def segment_spmm_backward(grad_out: torch.Tensor, receivers: torch.Tensor,
                          edge_mask: torch.Tensor,
                          n_nodes: int) -> torch.Tensor:
    """The segment sum's transpose, a gather: grad_values[e] =
    grad_out[receivers[e]] for a live edge whose receiver lies in
    [0, n_nodes), else 0 (what XLA computes for `jax.ops.segment_sum`'s
    gradient). (E, D) in grad_out's dtype."""
    recv = receivers.to(torch.int64)
    live = edge_mask.to(torch.bool) & (recv >= 0) & (recv < n_nodes)
    rows = grad_out.index_select(0, torch.where(live, recv, 0))
    return rows.masked_fill_(~live[:, None], 0)
