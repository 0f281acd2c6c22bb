"""Plain PyTorch versions of the row-gather and bag-sum kernels: the CPU
path and the yardstick the CUDA kernels are held against on the card."""
from __future__ import annotations

import torch


def gather_rows_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table: (V, D); ids: (N,) -> (N, D), with jnp.take's semantics: an id
    in [-V, 0) counts from the end, an id outside [-V, V) gives NaN."""
    v = table.shape[0]
    ids = ids.to(torch.int64)
    ids = torch.where(ids < 0, ids + v, ids)
    ok = (ids >= 0) & (ids < v)
    rows = table.index_select(0, torch.where(ok, ids, 0))
    return torch.where(ok[:, None], rows, float("nan"))


def bag_sum_ref(table: torch.Tensor, ids: torch.Tensor,
                weights: torch.Tensor | None = None) -> torch.Tensor:
    """table: (V, D); ids: (B, bag); weights: (B, bag) or None (all 1) ->
    (B, D) = sum_j weights[b, j] * table[ids[b, j]], accumulated in float32
    and returned in the table's dtype. Ids follow `gather_rows_ref`."""
    b, bag = ids.shape
    rows = gather_rows_ref(table, ids.reshape(-1)).reshape(b, bag, -1)
    rows = rows.to(torch.float32)
    if weights is not None:
        rows = rows * weights.to(torch.float32)[..., None]
    return rows.sum(dim=1).to(table.dtype)
