"""Plain PyTorch version of the row-gather kernel: the CPU path and the
yardstick the CUDA kernel is held against on the card."""
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
