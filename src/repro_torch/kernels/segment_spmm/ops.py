"""Public segment-sum op: masking, sorting, dispatch.

A CPU tensor runs the plain version (`ref.segment_spmm_ref`); a CUDA tensor
launches the segment-sum kernel, and anything the kernel does not take
raises. There is no fallback from the card to the plain version. As the
TPU op does, masked edges get a sentinel receiver past every node and the
edges are sorted stably by receiver unless ``assume_sorted``; unlike it,
nothing is padded to a block and no per-block range table is built: the
kernel finds each node's edge range itself.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.segment_spmm.kernel import (INT32_MAX,
                                                     segment_spmm_kernel)
from repro_torch.kernels.segment_spmm.ref import segment_spmm_ref


def segment_spmm(values: torch.Tensor, receivers: torch.Tensor,
                 edge_mask: torch.Tensor, n_nodes: int, *,
                 assume_sorted: bool = False) -> torch.Tensor:
    """Scatter-sum per-edge messages (E, D) into (n_nodes, D), in the
    values' dtype (float32 or bfloat16 on the card), summed in float32.

    Receivers outside [0, n_nodes) are dropped, as `jax.ops.segment_sum`
    drops them. With ``assume_sorted`` the receivers must already be
    non-decreasing (checked on the card, which costs one synchronisation);
    the mask is then applied inside the kernel."""
    if values.device.type == "cpu":
        return segment_spmm_ref(values, receivers, edge_mask, n_nodes)
    values = values.contiguous()
    receivers = receivers.to(torch.int32).contiguous()
    edge_mask = edge_mask.to(torch.bool).contiguous()
    if assume_sorted:
        if receivers.numel() > 1 and \
                bool((receivers[1:] < receivers[:-1]).any().item()):
            raise ValueError("assume_sorted: receivers are not sorted")
        out = segment_spmm_kernel(values, receivers, edge_mask, n_nodes)
    else:
        recv = torch.where(edge_mask, receivers, INT32_MAX)
        recv, order = torch.sort(recv, stable=True)
        out = segment_spmm_kernel(values.index_select(0, order), recv, None,
                                  n_nodes)
    segment_spmm.launches += 1
    return out


segment_spmm.launches = 0
