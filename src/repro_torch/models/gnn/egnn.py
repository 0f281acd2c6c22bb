"""EGNN (Satorras et al. 2021): E(n)-equivariant GNN without spherical
harmonics — messages from invariant distances, coordinate updates along
relative vectors. Assigned config: 4 layers, d_hidden=64.

The forward of the reference's `models/gnn/egnn.py`: two `aggregate`
calls per layer (the coordinate mean and the message sum); `loss_fn` is
the energies' mean square against `graph_targets`.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn

from repro_torch.engine.batch import resolve_device
from repro_torch.models.gnn.common import (MLP, GraphBatch, MeshGraph,
                                           energy_loss, frozen, mlp_apply,
                                           mlp_init, normal, to_tensor)


@dataclass(frozen=True)
class EGNNConfig:
    name: str = "egnn"
    n_layers: int = 4
    d_in: int = 16           # species embedding dim
    d_hidden: int = 64
    n_species: int = 16
    coord_agg: str = "mean"
    dtype: str = "float32"


class EGNNLayer(nn.Module):
    def __init__(self, phi_e: MLP, phi_x: MLP, phi_h: MLP):
        super().__init__()
        self.phi_e, self.phi_x, self.phi_h = phi_e, phi_x, phi_h


class EGNN(nn.Module):
    """EGNN's parameters on one device and its serving forward."""

    def __init__(self, cfg: EGNNConfig, embed: torch.Tensor,
                 layers: list[EGNNLayer], readout: MLP):
        super().__init__()
        self.cfg = cfg
        self.embed = frozen(embed)                # (n_species, H)
        self.layers = nn.ModuleList(layers)
        self.readout = readout

    @classmethod
    def random(cls, cfg: EGNNConfig, generator: torch.Generator) -> EGNN:
        """Weights drawn on ``generator.device`` with the reference's
        distributions (the numbers differ from JAX's for the same seed)."""
        resolve_device(generator.device)
        dt = getattr(torch, cfg.dtype)
        h = cfg.d_hidden
        layers = [EGNNLayer(mlp_init(generator, [2 * h + 1, h, h], dt),
                            mlp_init(generator, [h, h, 1], dt),
                            mlp_init(generator, [2 * h, h, h], dt))
                  for _ in range(cfg.n_layers)]
        return cls(cfg, normal(generator, (cfg.n_species, h), 0.1, dt),
                   layers, mlp_init(generator, [h, h, 1], dt))

    @classmethod
    def from_jax(cls, cfg: EGNNConfig, params: dict, *, device="cuda"
                 ) -> EGNN:
        """Carry the reference's `init_params(cfg, key)` onto ``device``."""
        dev = resolve_device(device)
        layers = [EGNNLayer(*(MLP.from_jax(la[k], dev)
                              for k in ("phi_e", "phi_x", "phi_h")))
                  for la in params["layers"]]
        return cls(cfg, to_tensor(params["embed"], dev), layers,
                   MLP.from_jax(params["readout"], dev))

    def param_tree(self) -> dict:
        """The reference's `init_params` pytree of these very tensors."""
        return {"embed": self.embed,
                "layers": [{k: getattr(la, k).param_tree()
                            for k in ("phi_e", "phi_x", "phi_h")}
                           for la in self.layers],
                "readout": self.readout.param_tree()}

    def forward(self, g: GraphBatch, *, use_kernel: bool = True):
        """Returns (per-graph energy (n_graphs,), final positions); on a
        `GraphBlock` the positions of the node block. The positions are
        node state: a mesh rank gathers them, as ``h``, in every layer."""
        mg = MeshGraph(g, g.edge_mask, use_kernel=use_kernel)
        h = self.embed[g.species]
        x = g.positions
        for layer in self.layers:
            xs, hs = mg.rows(x), mg.rows(h)
            d = xs[g.senders] - xs[g.receivers]
            d2 = torch.sum(d * d, dim=-1, keepdim=True)
            m = mlp_apply(layer.phi_e,
                          torch.cat([hs[g.senders], hs[g.receivers], d2], -1),
                          final_act=True, wrap=mg.edge)
            w = mlp_apply(layer.phi_x, m, wrap=mg.edge)     # (E, 1)
            x = x + mg.aggregate(d * w, reduce=self.cfg.coord_agg)
            agg = mg.aggregate(m)
            h = h + mlp_apply(layer.phi_h, torch.cat([h, agg], -1))
        e_node = mlp_apply(self.readout, h)[:, 0] * g.node_mask
        return mg.pool(e_node), x


def loss_fn(model: EGNN, g: GraphBatch, *, use_kernel: bool = True):
    energy, _ = model(g, use_kernel=use_kernel)
    return energy_loss(energy, g)
