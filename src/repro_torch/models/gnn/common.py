"""Shared GNN plumbing: padded graph batches and segment-op message passing.

The port of the reference's `models/gnn/common.py`. The reference
aggregates with `jax.ops.segment_sum` and names the Pallas `segment_spmm`
kernel as that aggregation's accelerated form; here `aggregate` scatters
through the segment-sum op (`kernels.segment_spmm`): the hand-written CUDA
kernel for tensors on the card (differentiable: its backward is the plain
gather that transposes a segment sum), its plain `index_add_` version on
the CPU.
``use_kernel=False`` takes the plain version on any device, for the
comparisons. Degrees, the edge softmax and per-graph pooling stay plain
PyTorch (`index_add_`, `scatter_reduce_`), as they are plain `jax.ops` in
the reference.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.segment_spmm.kernel import SegmentPlan
from repro_torch.kernels.segment_spmm.ops import segment_spmm
from repro_torch.kernels.segment_spmm.ref import segment_spmm_ref


@dataclass
class GraphBatch:
    """Padded, fixed-shape graph batch: tensors on one device.

    senders/receivers index into the node axis; padded edges point at node 0
    with edge_mask False. For batched small graphs (molecule shape), graph_ids
    maps nodes to their graph for pooling.
    """
    node_feat: torch.Tensor | None          # (N, F)
    positions: torch.Tensor | None          # (N, 3) geometric graphs
    senders: torch.Tensor                   # (E,) int32
    receivers: torch.Tensor                 # (E,) int32
    edge_mask: torch.Tensor                 # (E,) bool
    node_mask: torch.Tensor                 # (N,) bool
    labels: torch.Tensor | None = None
    label_mask: torch.Tensor | None = None
    graph_ids: torch.Tensor | None = None   # (N,) int32 for pooled tasks
    n_graphs: int = 1
    species: torch.Tensor | None = None     # (N,) int32 atomic species

    @property
    def device(self) -> torch.device:
        return self.senders.device


def aggregate(messages: torch.Tensor, receivers: torch.Tensor,
              edge_mask: torch.Tensor, n_nodes: int, *, reduce: str = "sum",
              use_kernel: bool = True,
              plan: SegmentPlan | None = None) -> torch.Tensor:
    """Scatter edge messages to receiver nodes. messages: (E, ...); ranks
    above 2 are flattened to (E, prod(...)) for one segment-sum call.
    ``plan`` is the receivers' `segment_plan` under ``edge_mask``, which a
    forward builds once for all its calls; it is passed on to the op."""
    e = messages.shape[0]
    flat = messages.reshape(e, -1)
    if use_kernel:
        out = segment_spmm(flat, receivers, edge_mask, n_nodes, plan=plan)
    else:
        out = segment_spmm_ref(flat, receivers, edge_mask, n_nodes)
    out = out.reshape(n_nodes, *messages.shape[1:])
    if reduce == "mean":
        deg = degrees(receivers, edge_mask, n_nodes, messages.dtype)
        out = out / deg.clamp_min(1.0)[(...,) + (None,) * (messages.dim() - 1)]
    return out


def edge_softmax(scores: torch.Tensor, receivers: torch.Tensor,
                 edge_mask: torch.Tensor, n_nodes: int) -> torch.Tensor:
    """Numerically-stable softmax over each receiver's incoming edges.
    scores: (E, H)."""
    neg = torch.finfo(torch.float32).min / 2
    s = torch.where(edge_mask[:, None], scores.to(torch.float32), neg)
    idx = receivers.to(torch.int64)
    smax = torch.full((n_nodes, s.shape[1]), -torch.inf, dtype=torch.float32,
                      device=s.device)
    smax.scatter_reduce_(0, idx[:, None].expand_as(s), s, reduce="amax")
    s = s - smax[idx]
    e = torch.where(edge_mask[:, None], torch.exp(s), 0.0)
    z = torch.zeros_like(smax).index_add_(0, idx, e)
    return (e / z[idx].clamp_min(1e-20)).to(scores.dtype)


def degrees(receivers, edge_mask, n_nodes, dtype=torch.float32):
    return torch.zeros(n_nodes, dtype=dtype, device=receivers.device) \
        .index_add_(0, receivers, edge_mask.to(dtype))


def segment_sum(data: torch.Tensor, ids: torch.Tensor,
                n_segments: int) -> torch.Tensor:
    """`jax.ops.segment_sum` over the leading axis, plain `index_add_`."""
    return torch.zeros((n_segments, *data.shape[1:]), dtype=data.dtype,
                       device=data.device).index_add_(0, ids, data)


def graph_ids(g: GraphBatch) -> torch.Tensor:
    return g.graph_ids if g.graph_ids is not None else \
        torch.zeros(g.node_mask.shape[0], dtype=torch.int32, device=g.device)


def energy_loss(energy: torch.Tensor, g: GraphBatch):
    """The geometric models' loss: the mean square of the per-graph
    energies against `graph_targets`, in float32."""
    loss = torch.mean(torch.square(energy.to(torch.float32)
                                   - graph_targets(g)))
    return loss, {"loss": loss}


def graph_targets(g: GraphBatch) -> torch.Tensor:
    """Per-graph scalar regression targets derived from node labels
    (synthetic-energy convention shared by the geometric models)."""
    gid = graph_ids(g)
    w = g.node_mask.to(torch.float32)
    s = segment_sum(g.labels.to(torch.float32) * w, gid, g.n_graphs)
    c = segment_sum(w, gid, g.n_graphs)
    return s / c.clamp_min(1.0)


def frozen(t: torch.Tensor) -> nn.Parameter:
    """A parameter that serving leaves frozen: a trainer turns on its
    gradient (through the model's `param_tree`)."""
    return nn.Parameter(t, requires_grad=False)


def to_tensor(a, device) -> torch.Tensor:
    """A reference array (jax or numpy) as a tensor on ``device``."""
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def normal(generator: torch.Generator, shape, scale: float,
           dtype=torch.float32) -> torch.Tensor:
    """float32 normals times ``scale`` on the generator's device, cast to
    ``dtype`` (the reference draws float32 and casts)."""
    return (torch.randn(tuple(shape), generator=generator,
                        device=generator.device, dtype=torch.float32)
            * scale).to(dtype)


class MLP(nn.Module):
    """Dense layers x @ w + b, the reference's `mlp_init` list of
    {"w", "b"} dicts."""

    def __init__(self, layers: list[tuple[torch.Tensor, torch.Tensor]]):
        super().__init__()
        self.w = nn.ParameterList([frozen(w) for w, _ in layers])
        self.b = nn.ParameterList([frozen(b) for _, b in layers])

    def param_tree(self) -> list[dict]:
        """The reference's list of {"w", "b"} of these very tensors."""
        return [{"w": w, "b": b} for w, b in zip(self.w, self.b)]

    @classmethod
    def from_jax(cls, layers: list[dict], device) -> MLP:
        return cls([(to_tensor(la["w"], device), to_tensor(la["b"], device))
                    for la in layers])


def mlp_init(generator: torch.Generator, dims, dtype=torch.float32) -> MLP:
    """Weights normal / sqrt(fan_in), biases zero, as the reference."""
    return MLP([(normal(generator, (a, b), 1 / np.sqrt(a), dtype),
                 torch.zeros((b,), dtype=dtype, device=generator.device))
                for a, b in zip(dims[:-1], dims[1:])])


def mlp_apply(mlp: MLP, x: torch.Tensor, act=F.silu,
              final_act: bool = False) -> torch.Tensor:
    n = len(mlp.w)
    for i, (w, b) in enumerate(zip(mlp.w, mlp.b)):
        x = x @ w + b
        if i < n - 1 or final_act:
            x = act(x)
    return x
