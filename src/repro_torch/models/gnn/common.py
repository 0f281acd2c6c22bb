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

A forward computes through a `MeshGraph`. On one device it is the
functions below over the whole batch. On a mesh rank the batch is a
`GraphBlock`, the rank's node block and edge block as the reference's
`graph_batch_specs` lays them out, and `MeshGraph` carries the
collectives (its docstring derives their gradients).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.kernels.segment_spmm.kernel import SegmentPlan
from repro_torch.kernels.segment_spmm.ops import segment_plan, segment_spmm
from repro_torch.kernels.segment_spmm.ref import segment_spmm_ref
from repro_torch.sharding.rules import (AllReduce, Gather, Replicated,
                                        data_axes)


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


@dataclass
class GraphBlock(GraphBatch):
    """A mesh rank's block of a `GraphBatch` (`launch.cells.graph_block`):
    each node array's rows of the rank's node block, split over
    ``node_axes`` (whole where empty), and each edge array's edges of its
    edge block, split over ``edge_axes``. The senders and receivers keep
    the whole graph's node indices, and ``n_nodes`` is the whole graph's
    node count. The models compute on it through a `MeshGraph`."""
    mesh: Any = None
    n_nodes: int = 0
    node_axes: tuple[str, ...] = ()
    edge_axes: tuple[str, ...] = ()


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
                 edge_mask: torch.Tensor, n_nodes: int, *, max_over=None,
                 sum_over=None) -> torch.Tensor:
    """Numerically-stable softmax over each receiver's incoming edges.
    scores: (E, H). The maximum is a shift the softmax does not depend
    on, so no gradient flows through it. ``max_over`` and ``sum_over`` map
    the (n_nodes, H) maxima and denominators before the edges read them
    back (a `MeshGraph`'s reductions over its edge axes)."""
    neg = torch.finfo(torch.float32).min / 2
    s = torch.where(edge_mask[:, None], scores.to(torch.float32), neg)
    idx = receivers.to(torch.int64)
    smax = torch.full((n_nodes, s.shape[1]), -torch.inf, dtype=torch.float32,
                      device=s.device)
    smax.scatter_reduce_(0, idx[:, None].expand_as(s), s.detach(),
                         reduce="amax")
    if max_over is not None:
        smax = max_over(smax)
    e = torch.where(edge_mask[:, None], torch.exp(s - smax[idx]), 0.0)
    z = torch.zeros_like(smax).index_add_(0, idx, e)
    if sum_over is not None:
        z = sum_over(z)
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


def _axes_of(mesh, axes) -> tuple[str, ...]:
    """``axes`` that hold more than one rank of ``mesh``."""
    return tuple(a for a in axes if mesh.shape[a] > 1)


class MeshGraph:
    """The graph one forward computes through: the segment plan of its
    live edges and the operations that cross from nodes to edges and back.

    On one device (``g`` a `GraphBatch`) the node and edge axes are empty,
    no collective runs, and every operation is the plain function above
    over the whole batch. On a mesh rank (``g`` a `GraphBlock`) the rank
    (d, m) holds node block d (the node axes' index; the whole graph where
    the nodes are not split) and edge block m (the edge axes' index). An
    edge of its block is live on the rank when it is live at all and its
    receiver lies in node block d, so every live edge is computed on
    exactly one rank of a line of copies; the receivers are mapped to
    block rows (`receivers`, the others masked out of `edge_mask`), and
    one `segment_plan` is built over them.

    Node state is held as the rank's node block, the same on every rank
    of the edge axes. The operations keep one invariant: the gradient that
    reaches a node-block tensor is the gradient of the whole loss with
    respect to it (so it too is the same on every rank of the edge axes),
    and the one that reaches an edge tensor is its own edge's:
      * `rows(x)` gathers the node blocks (N, ...) for the edge block to
        index: `Gather` over the node axes after `Replicated` over the
        edge axes, whose backward sums the ranks' edge gradients over the
        edge axes and reduce-scatters them over the node axes: the whole
        gradient of this rank's rows;
      * `aggregate` sums the live edges' messages onto the node block and
        adds the edge blocks' partials (`AllReduce` over the edge axes,
        whose backward hands each partial the node gradient: the whole
        one, by the invariant);
      * `edge(w)` is a parameter used on the edge block: `Replicated`
        over the edge axes, so its gradient adds every edge block's;
      * `edge_softmax` takes the maximum over the edge axes (no gradient:
        the softmax does not depend on the shift) and the denominators'
        sum (`AllReduce`, then `Replicated` where the edge block reads it
        back);
      * `pool` / `node_sum` add the node blocks' partial sums
        (`AllReduce` over the node axes: every rank holds the whole loss,
        and its backward hands each block the whole gradient).
    A parameter used on node blocks thus gets its node block's share of
    the whole gradient on each rank, one used on the edge block the share
    of the edges live on its node block (summed over the edge axes); the
    node blocks' shares add up over the node axes. The mesh Trainer sums
    each replicated leaf's gradient over the data axes and divides by
    their size, so `trainer_loss` scales the loss it differentiates by the
    number of node blocks (`loss_scale`): with the nodes whole, every data
    rank computes the whole gradient and the division takes the copies
    out. The node axes must be data axes and the edge axes none of them
    (`launch.cells.graph_batch_specs`: "model" for the edges).
    """

    def __init__(self, g: GraphBatch, edge_mask: torch.Tensor | None = None,
                 *, use_kernel: bool = True):
        self.g = g
        self.use_kernel = use_kernel
        self.mesh = getattr(g, "mesh", None)
        self.n_loc = g.node_mask.shape[0]
        self.n_nodes, self.offset = self.n_loc, 0
        self.node_axes = self.edge_axes = ()
        if self.mesh is not None:
            mesh, dp = self.mesh, set(data_axes(self.mesh))
            if not set(g.node_axes) <= dp or set(g.edge_axes) & dp:
                raise ValueError(
                    f"a graph block's nodes split over data axes and its "
                    f"edges over others; got nodes {g.node_axes}, edges "
                    f"{g.edge_axes} on a mesh of data axes {sorted(dp)}")
            if self.n_loc * (mesh.axes_size(g.node_axes) if g.node_axes
                             else 1) != g.n_nodes:
                raise ValueError(f"a node block of {self.n_loc} rows over "
                                 f"{g.node_axes} for {g.n_nodes} nodes")
            self.n_nodes = g.n_nodes
            self.node_axes = _axes_of(mesh, g.node_axes)
            self.edge_axes = _axes_of(mesh, g.edge_axes)
            if g.node_axes:
                self.offset = mesh.axis_index(g.node_axes) * self.n_loc
        self.receivers = self.edge_mask = self.plan = None
        self._mask_in = None
        self._deg: dict = {}
        if edge_mask is not None:
            self.mask_edges(edge_mask)

    def mask_edges(self, edge_mask: torch.Tensor) -> MeshGraph:
        """Take ``edge_mask`` (E,) as the edges that count and build the
        segment plan of the live ones (when the kernel is used)."""
        self._mask_in = edge_mask
        local = self.g.receivers - self.offset
        live = edge_mask & (local >= 0) & (local < self.n_loc)
        self.receivers = torch.where(live, local, 0).to(torch.int32)
        self.edge_mask = live
        self._deg = {}
        self.plan = (segment_plan(self.receivers, self.edge_mask, self.n_loc)
                     if self.use_kernel else None)
        return self

    # ---- nodes to edges ----------------------------------------------
    def rows(self, x: torch.Tensor) -> torch.Tensor:
        """The whole graph's rows (N, ...) of the node-block tensor ``x``,
        for the edge block's senders and receivers to index."""
        if self.edge_axes:
            x = Replicated.apply(x, self.mesh, self.edge_axes)
        if self.node_axes:
            x = Gather.apply(x, self.mesh, self.node_axes, 0)
        return x

    def edge(self, w: torch.Tensor) -> torch.Tensor:
        """A parameter as the edge block uses it."""
        if not self.edge_axes:
            return w
        return Replicated.apply(w, self.mesh, self.edge_axes)

    # ---- edges to nodes ----------------------------------------------
    def aggregate(self, messages: torch.Tensor, reduce: str = "sum"
                  ) -> torch.Tensor:
        """`aggregate` of the live edges' messages onto the node block,
        through the plan; ``reduce="mean"`` divides by `degrees`."""
        out = aggregate(messages, self.receivers, self.edge_mask, self.n_loc,
                        use_kernel=self.use_kernel, plan=self.plan)
        if self.edge_axes:
            out = AllReduce.apply(out, self.mesh, self.edge_axes)
        if reduce == "mean":
            deg = self.degrees(messages.dtype)
            out = out / deg.clamp_min(1.0)[
                (...,) + (None,) * (messages.dim() - 1)]
        return out

    def degrees(self, dtype=torch.float32) -> torch.Tensor:
        """Each node-block row's count of live incoming edges."""
        if dtype not in self._deg:
            d = degrees(self.receivers, self.edge_mask, self.n_loc, dtype)
            self._deg[dtype] = (self.mesh.all_reduce(d, self.edge_axes)
                                if self.edge_axes else d)
        return self._deg[dtype]

    def sender_degrees(self, dtype=torch.float32) -> torch.Tensor:
        """Every node's count of outgoing edges under the mask given to
        `mask_edges` (N,): on a mesh each edge block's counts added over
        the edge axes."""
        d = degrees(self.g.senders, self._mask_in, self.n_nodes, dtype)
        if not self.edge_axes:
            return d
        return self.mesh.all_reduce(d, self.edge_axes)

    def edge_softmax(self, scores: torch.Tensor) -> torch.Tensor:
        """`edge_softmax` of the edge block's (E, H) scores over each
        receiver's live incoming edges, wherever they lie."""
        if not self.edge_axes:
            return edge_softmax(scores, self.receivers, self.edge_mask,
                                self.n_loc)
        mesh, axes = self.mesh, self.edge_axes
        return edge_softmax(
            scores, self.receivers, self.edge_mask, self.n_loc,
            max_over=lambda m: mesh.all_reduce(m, axes, op="max"),
            sum_over=lambda z: Replicated.apply(
                AllReduce.apply(z, mesh, axes), mesh, axes))

    # ---- node blocks to the whole graph ------------------------------
    def node_sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the node blocks of a partial result (under
        autograd)."""
        if not self.node_axes:
            return x
        return AllReduce.apply(x, self.mesh, self.node_axes)

    def node_total(self, x: torch.Tensor) -> torch.Tensor:
        """`node_sum` of a tensor no gradient flows through."""
        if not self.node_axes:
            return x
        return self.mesh.all_reduce(x, self.node_axes)

    def pool(self, e_node: torch.Tensor) -> torch.Tensor:
        """Per-graph sums (n_graphs,) of a node-block tensor."""
        return self.node_sum(segment_sum(e_node, graph_ids(self.g),
                                         self.g.n_graphs))

    @property
    def loss_scale(self) -> int:
        """The number of node blocks (1 on one device)."""
        return self.mesh.axes_size(self.node_axes) if self.node_axes else 1

    def trainer_loss(self, loss: torch.Tensor) -> torch.Tensor:
        """The loss a mesh Trainer differentiates: ``loss`` times
        `loss_scale` (``loss`` itself on one device)."""
        return loss if self.loss_scale == 1 else loss * self.loss_scale


def energy_loss(energy: torch.Tensor, g: GraphBatch):
    """The geometric models' loss: the mean square of the per-graph
    energies against `graph_targets`, in float32. On a `GraphBlock` the
    loss handed back for differentiation is `MeshGraph.trainer_loss`'s;
    the metric is the loss itself."""
    loss = torch.mean(torch.square(energy.to(torch.float32)
                                   - graph_targets(g)))
    return MeshGraph(g).trainer_loss(loss), {"loss": loss}


def graph_targets(g: GraphBatch) -> torch.Tensor:
    """Per-graph scalar regression targets derived from node labels
    (synthetic-energy convention shared by the geometric models); on a
    `GraphBlock` the node blocks' sums added over the node axes."""
    mg = MeshGraph(g)
    gid = graph_ids(g)
    w = g.node_mask.to(torch.float32)
    s = mg.node_total(segment_sum(g.labels.to(torch.float32) * w, gid,
                                  g.n_graphs))
    c = mg.node_total(segment_sum(w, gid, g.n_graphs))
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
              final_act: bool = False, wrap=None) -> torch.Tensor:
    """``wrap`` maps each weight and bias before its use (`MeshGraph.edge`
    for an MLP on the edge block)."""
    n = len(mlp.w)
    for i, (w, b) in enumerate(zip(mlp.w, mlp.b)):
        if wrap is not None:
            w, b = wrap(w), wrap(b)
        x = x @ w + b
        if i < n - 1 or final_act:
            x = act(x)
    return x
