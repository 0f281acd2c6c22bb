"""Public row-gather op: dispatch on the tensor's device.

A CPU tensor runs the plain version (`ref.gather_rows_ref`); a CUDA tensor
launches the gather kernel, and anything the kernel does not take raises.
There is no fallback from the card to the plain version. Unlike the TPU op,
the table is not padded to 128 lanes: at the full xDeepFM width that would
copy its 26.4M rows on every call.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag.kernel import gather_rows_kernel
from repro_torch.kernels.embedding_bag.ref import gather_rows_ref


def gather_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """table: (V, D) float32; ids: (N,) integer -> (N, D) = table[ids]."""
    if table.device.type == "cpu":
        return gather_rows_ref(table, ids)
    out = gather_rows_kernel(table, ids.to(torch.int32).contiguous())
    gather_rows.launches += 1
    return out


gather_rows.launches = 0
