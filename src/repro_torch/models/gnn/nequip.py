"""NequIP (Batzner et al. 2021): E(3)-equivariant interatomic potential via
Clebsch-Gordan tensor products of node irreps with edge spherical harmonics.

Assigned config: 5 layers, 32 channels, l_max=2, 8 Bessel RBFs, cutoff 5 A.
The forward (per-graph energies) of the reference's
`models/gnn/nequip.py`, with its simplifications: uniform multiplicity per
l, the full set of tensor-product paths {(l1,l2,l3): |l1-l2| <= l3 <=
min(l1+l2, l_max)} with per-path radial weights, gate nonlinearity, and a
scalar energy readout. One `aggregate` call per layer, on the (E, 9, 32)
messages flattened to (E, 288). `energy_and_forces` takes the forces as
-dE/dpositions through autograd (on the card through the segment sum's
backward); `loss_fn` is the energies' mean square against `graph_targets`.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.engine.batch import resolve_device
from repro_torch.models.gnn.common import (MLP, GraphBatch, MeshGraph,
                                           energy_loss, frozen, mlp_apply,
                                           mlp_init, normal, to_tensor)
from repro_torch.models.gnn.so3 import (cg_tensor, irrep_dim,
                                        spherical_harmonics)


@dataclass(frozen=True)
class NequIPConfig:
    name: str = "nequip"
    n_layers: int = 5
    d_hidden: int = 32          # channel multiplicity per l
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_species: int = 16
    radial_hidden: int = 64
    dtype: str = "float32"


@lru_cache(maxsize=None)
def tp_paths(l_max: int) -> tuple[tuple[int, int, int], ...]:
    out = []
    for l1 in range(l_max + 1):
        for l2 in range(l_max + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, l_max) + 1):
                out.append((l1, l2, l3))
    return tuple(out)


def bessel_rbf(r: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    """Bessel radial basis with smooth polynomial cutoff envelope (p=6)."""
    r = torch.clamp(r, min=1e-6)
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    b = float(np.sqrt(2.0 / cutoff)) \
        * torch.sin(n * np.pi * r[..., None] / cutoff) / r[..., None]
    u = r / cutoff
    env = 1 - 28 * u**6 + 48 * u**7 - 21 * u**8   # smooth, u(1)=0
    env = torch.where(u < 1.0, env, 0.0)
    return b * env[..., None]


def _tensor_product(h_src: torch.Tensor, Y: torch.Tensor, w: torch.Tensor,
                    cfg: NequIPConfig) -> torch.Tensor:
    """Per-edge TP message. h_src: (E, (L+1)^2, C); Y: (E, (L+1)^2);
    w: (E, n_paths, C). Returns (E, (L+1)^2, C)."""
    out = torch.zeros_like(h_src)
    for pi, (l1, l2, l3) in enumerate(tp_paths(cfg.l_max)):
        C3 = cg_tensor(l1, l2, l3, h_src)
        h1 = h_src[:, l1 * l1:(l1 + 1) ** 2, :]          # (E, 2l1+1, C)
        y2 = Y[:, l2 * l2:(l2 + 1) ** 2]                 # (E, 2l2+1)
        m = torch.einsum("abm,eac,eb->emc", C3, h1, y2)
        out[:, l3 * l3:(l3 + 1) ** 2, :] += m * w[:, pi, None, :]
    return out


class NequIPLayer(nn.Module):
    def __init__(self, radial: MLP, w_self: torch.Tensor,
                 w_msg: torch.Tensor, w_gate: torch.Tensor):
        super().__init__()
        self.radial = radial                     # n_rbf -> n_paths * C
        self.w_self = frozen(w_self)             # (L+1, C, C)
        self.w_msg = frozen(w_msg)               # (L+1, C, C)
        self.w_gate = frozen(w_gate)             # (C, l_max * C)


class NequIP(nn.Module):
    """NequIP's parameters on one device and its serving forward."""

    def __init__(self, cfg: NequIPConfig, embed: torch.Tensor,
                 layers: list[NequIPLayer], readout: MLP):
        super().__init__()
        self.cfg = cfg
        self.embed = frozen(embed)               # (n_species, C)
        self.layers = nn.ModuleList(layers)
        self.readout = readout

    @classmethod
    def random(cls, cfg: NequIPConfig, generator: torch.Generator) -> NequIP:
        """Weights drawn on ``generator.device`` with the reference's
        distributions (the numbers differ from JAX's for the same seed)."""
        resolve_device(generator.device)
        dt = getattr(torch, cfg.dtype)
        C, L1 = cfg.d_hidden, cfg.l_max + 1
        n_paths = len(tp_paths(cfg.l_max))
        layers = [NequIPLayer(
            mlp_init(generator, [cfg.n_rbf, cfg.radial_hidden, n_paths * C],
                     dt),
            normal(generator, (L1, C, C), 1 / np.sqrt(C), dt),
            normal(generator, (L1, C, C), 1 / np.sqrt(C), dt),
            normal(generator, (C, cfg.l_max * C), 1 / np.sqrt(C), dt))
            for _ in range(cfg.n_layers)]
        return cls(cfg, normal(generator, (cfg.n_species, C), 0.5, dt),
                   layers, mlp_init(generator, [C, C, 1], dt))

    @classmethod
    def from_jax(cls, cfg: NequIPConfig, params: dict, *, device="cuda"
                 ) -> NequIP:
        """Carry the reference's `init_params(cfg, key)` onto ``device``."""
        dev = resolve_device(device)
        layers = [NequIPLayer(MLP.from_jax(la["radial"], dev),
                              *(to_tensor(la[k], dev)
                                for k in ("w_self", "w_msg", "w_gate")))
                  for la in params["layers"]]
        return cls(cfg, to_tensor(params["embed"], dev), layers,
                   MLP.from_jax(params["readout"], dev))

    def param_tree(self) -> dict:
        """The reference's `init_params` pytree of these very tensors."""
        return {"embed": self.embed,
                "layers": [{"radial": la.radial.param_tree(),
                            "w_self": la.w_self, "w_msg": la.w_msg,
                            "w_gate": la.w_gate} for la in self.layers],
                "readout": self.readout.param_tree()}

    def forward(self, g: GraphBatch, *, use_kernel: bool = True
                ) -> torch.Tensor:
        """Per-graph energies (n_graphs,)."""
        cfg = self.cfg
        mg = MeshGraph(g, use_kernel=use_kernel)
        n = mg.n_loc
        C = cfg.d_hidden
        dim = irrep_dim(cfg.l_max)
        n_paths = len(tp_paths(cfg.l_max))
        # node irreps: scalars initialized from species embedding, rest zero
        h = torch.zeros((n, dim, C), dtype=getattr(torch, cfg.dtype),
                        device=g.device)
        h[:, 0, :] = self.embed[g.species]

        pos = mg.rows(g.positions)
        vec = pos[g.senders] - pos[g.receivers]
        r = torch.sqrt(torch.sum(vec * vec, -1) + 1e-12)
        # zero-length edges have no direction: mask them out of message passing
        mg.mask_edges(g.edge_mask & (r > 1e-5))
        Y = spherical_harmonics(vec, cfg.l_max).to(h.dtype)
        rbf = bessel_rbf(r, cfg.n_rbf, cfg.cutoff).to(h.dtype)

        for layer in self.layers:
            w = mlp_apply(layer.radial, rbf, wrap=mg.edge).reshape(
                -1, n_paths, C)
            msg = _tensor_product(mg.rows(h)[g.senders], Y, w, cfg)
            agg = mg.aggregate(msg)

            # per-l linear self + message mix
            new = []
            for l in range(cfg.l_max + 1):
                lo, hi = l * l, (l + 1) ** 2
                new.append(h[:, lo:hi, :] @ layer.w_self[l]
                           + agg[:, lo:hi, :] @ layer.w_msg[l])
            hn = torch.cat(new, dim=1)

            # gate nonlinearity: scalars -> silu; l>0 scaled by sigmoid(gates)
            scal = F.silu(hn[:, 0, :])
            gates = torch.sigmoid(hn[:, 0, :] @ layer.w_gate)
            gates = gates.reshape(n, cfg.l_max, C)
            parts = [scal[:, None, :]]
            for l in range(1, cfg.l_max + 1):
                lo, hi = l * l, (l + 1) ** 2
                parts.append(hn[:, lo:hi, :] * gates[:, None, l - 1, :])
            h = torch.cat(parts, dim=1)

        e_node = mlp_apply(self.readout, h[:, 0, :])[:, 0] * g.node_mask
        return mg.pool(e_node)


def energy_and_forces(model: NequIP, g: GraphBatch, *,
                      use_kernel: bool = True):
    """(total energy of the batch, forces (N, 3) = -dE/dpositions)."""
    pos = g.positions.detach().requires_grad_(True)
    with torch.enable_grad():
        e = model(dataclasses.replace(g, positions=pos),
                  use_kernel=use_kernel).sum()
        (grad,) = torch.autograd.grad(e, pos)
    return e.detach(), -grad


def loss_fn(model: NequIP, g: GraphBatch, *, use_kernel: bool = True):
    return energy_loss(model(g, use_kernel=use_kernel), g)
