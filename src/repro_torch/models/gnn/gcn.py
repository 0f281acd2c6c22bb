"""GCN (Kipf & Welling 2017): 2-layer symmetric-normalized spectral conv.

Assigned config gcn-cora: n_layers=2, d_hidden=16, mean aggregator, sym norm.
Self-loops are added by the data pipeline. The forward (logits per node)
of the reference's `models/gnn/gcn.py`: dense product first (F -> H),
then the normalized messages scattered through `aggregate`; `loss_fn` is
its masked node-classification cross-entropy.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.engine.batch import resolve_device
from repro_torch.models.gnn.common import (GraphBatch, MeshGraph, frozen,
                                           normal, to_tensor)


@dataclass(frozen=True)
class GCNConfig:
    name: str = "gcn-cora"
    n_layers: int = 2
    d_in: int = 1433
    d_hidden: int = 16
    n_classes: int = 7
    norm: str = "sym"         # sym | mean
    dtype: str = "float32"


class GCN(nn.Module):
    """GCN's layer weights on one device and its serving forward."""

    def __init__(self, cfg: GCNConfig, weights: list[torch.Tensor]):
        super().__init__()
        self.cfg = cfg
        self.weights = nn.ParameterList([frozen(w) for w in weights])

    @classmethod
    def random(cls, cfg: GCNConfig, generator: torch.Generator) -> GCN:
        """Weights drawn on ``generator.device`` with the reference's
        distribution, normal * sqrt(2 / fan_in)."""
        resolve_device(generator.device)
        dims = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) \
            + [cfg.n_classes]
        dt = getattr(torch, cfg.dtype)
        return cls(cfg, [normal(generator, (a, b), np.sqrt(2.0 / a), dt)
                         for a, b in zip(dims[:-1], dims[1:])])

    @classmethod
    def from_jax(cls, cfg: GCNConfig, params: dict, *, device="cuda") -> GCN:
        """Carry the reference's `init_params(cfg, key)` onto ``device``."""
        dev = resolve_device(device)
        return cls(cfg, [to_tensor(la["w"], dev) for la in params["layers"]])

    def param_tree(self) -> dict:
        """The reference's `init_params` pytree of these very tensors."""
        return {"layers": [{"w": w} for w in self.weights]}

    def forward(self, g: GraphBatch, *, use_kernel: bool = True
                ) -> torch.Tensor:
        """Logits (N, n_classes); on a `GraphBlock` the node block's rows.
        ``use_kernel=False`` aggregates through the plain `index_add_`
        version on any device."""
        mg = MeshGraph(g, g.edge_mask, use_kernel=use_kernel)
        deg = mg.degrees().clamp_min(1.0)
        deg_s = mg.sender_degrees().clamp_min(1.0)
        if self.cfg.norm == "sym":
            coef = torch.rsqrt(deg_s[g.senders]) * torch.rsqrt(
                deg[mg.receivers])
        else:
            coef = 1.0 / deg[mg.receivers]
        x = g.node_feat
        last = len(self.weights) - 1
        for i, w in enumerate(self.weights):
            x = x @ w                                      # dense first: F->H
            # scaled in place: at ogbn-products the (E, H) messages are
            # 12.1 GB, and a second copy would double that
            msg = mg.rows(x).index_select(0, g.senders)
            msg.mul_(coef[:, None].to(x.dtype))
            x = mg.aggregate(msg)
            del msg
            if i < last:
                x = torch.relu(x)
        return x


def loss_fn(model: GCN, g: GraphBatch, *, use_kernel: bool = True):
    """Masked cross-entropy over the labelled nodes (``label_mask``, else
    ``node_mask``) and the share of them classified right ("acc"). On a
    `GraphBlock` the sums over the node blocks are added (`MeshGraph`),
    and the loss handed back for differentiation is
    `MeshGraph.trainer_loss`'s."""
    logits = model(g, use_kernel=use_kernel).to(torch.float32)
    mg = MeshGraph(g)
    mask = g.label_mask if g.label_mask is not None else g.node_mask
    mask = mask.to(torch.float32)
    logp = F.log_softmax(logits, dim=-1)
    safe = torch.clamp(g.labels, min=0).to(torch.int64)
    nll = -torch.take_along_dim(logp, safe[:, None], dim=-1)[:, 0]
    denom = torch.clamp(mg.node_total(mask.sum()), min=1.0)
    loss = mg.node_sum((nll * mask).sum()) / denom
    acc = mg.node_total(((logits.argmax(-1) == g.labels) * mask).sum()) \
        / denom
    return mg.trainer_loss(loss), {"loss": loss, "acc": acc}
