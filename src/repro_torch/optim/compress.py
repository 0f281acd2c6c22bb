"""Error-feedback int8 gradient compression for the DP all-reduce.

The port of the reference's `optim/compress.py`: each gradient plus its
carried residual is quantized to int8 with a per-tensor scale (round half
to even, as `jnp.round` and `torch.round` both do; clipped to +-127), and
the quantization error is carried into the next step (error feedback,
Seide et al. 2014 / EF-SGD). With one device there is no all-reduce: the
trainer decompresses at once, and the update sees the quantized gradient.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_map


def _comp(g: torch.Tensor, r: torch.Tensor):
    g32 = g.to(torch.float32) + r
    scale = torch.clamp(torch.max(torch.abs(g32)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return q, scale, g32 - q.to(torch.float32) * scale


def ef_compress(grads, residual):
    """Returns (int8 tree, scales tree, new residual carried locally)."""
    out = tree_map(_comp, grads, residual)
    return tuple(tree_map(lambda _, t, i=i: t[i], grads, out)
                 for i in range(3))


def ef_decompress(q, scales):
    return tree_map(lambda qq, s: qq.to(torch.float32) * s, q, scales)


def ef_init(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
