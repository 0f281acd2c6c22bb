"""Public row-gather and bag-sum ops: dispatch on the tensor's device.

A CPU tensor runs the plain version (`ref.gather_rows_ref`,
`ref.bag_sum_ref`); a CUDA tensor launches the kernel, and anything the
kernel does not take raises, as does an input that requires grad under
grad mode (the kernels have no backward).
There is no fallback from the card to the plain version. A meta tensor
gets a meta output and its work counted in `kernels.meta_cost` (every id
taken as a distinct row; see the package's docstring). Unlike the TPU op,
the table is not padded to 128 lanes: at the full xDeepFM width that would
copy its 26.4M rows on every call.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import forbid_backward, is_meta, meta_cost
from repro_torch.kernels.embedding_bag.kernel import (bag_sum_kernel,
                                                     gather_rows_kernel)
from repro_torch.kernels.embedding_bag.ref import bag_sum_ref, gather_rows_ref


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table: (V, D) float32; ids: (N,) integer -> (N, D) = table[ids]."""
    if table.device.type == "cpu":
        return gather_rows_ref(table, ids)
    if is_meta(table):
        n, d = ids.shape[0], table.shape[1]
        # the ids, the rows they name, the output
        meta_cost.add("gather_rows", ops=0,
                      n_bytes=4 * n + 2 * table.element_size() * n * d)
        return torch.empty((n, d), dtype=table.dtype, device="meta")
    forbid_backward("gather_rows", "XDeepFM.embedding_lookup(use_kernel="
                    "False)", table)
    out = gather_rows_kernel(table, ids.to(torch.int32).contiguous())
    gather_rows.launches += 1
    return out


gather_rows.launches = 0


def bag_sum(table: torch.Tensor, ids: torch.Tensor,
            weights: torch.Tensor | None = None) -> torch.Tensor:
    """table: (V, D); ids: (B, bag) integer; weights: (B, bag) or None
    (all 1) -> (B, D) weighted bag sums in the table's dtype, accumulated in
    float32. No JAX code path calls the reference op; this is an op only."""
    if table.device.type == "cpu":
        return bag_sum_ref(table, ids, weights)
    if is_meta(table):
        b, bag = ids.shape
        d = table.shape[1]
        meta_cost.add("bag_sum", ops=2 * b * bag * d,
                      n_bytes=4 * b * bag * 2
                      + table.element_size() * (b * bag * d + b * d))
        return torch.empty((b, d), dtype=table.dtype, device="meta")
    forbid_backward("bag_sum", "ref.bag_sum_ref", table, weights)
    w = None if weights is None else \
        weights.to(torch.float32).contiguous()
    out = bag_sum_kernel(table, ids.to(torch.int32).contiguous(), w)
    bag_sum.launches += 1
    return out


bag_sum.launches = 0
