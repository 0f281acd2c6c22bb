"""EquiformerV2 (Liao et al. 2023): equivariant graph attention where each
edge's SO(3) convolution is reduced to SO(2) by rotating features into the
edge frame (the eSCN trick), with m_max truncation.

Assigned config: 12 layers, 128 channels, l_max=6, m_max=2, 8 heads.

The forward (per-graph energies) of the reference's
`models/gnn/equiformer_v2.py`, and its `loss_fn` (the energies' mean
square against `graph_targets`). Per-edge Wigner-D matrices are built on the
device by the exact CG recursion (`so3.wigner_d_blocks`), and only the
|m| <= m_max rows of the rotated features are materialized: per edge,
Sum_l (2*min(l,m_max)+1) coefficients (29 for L=6, m=2) instead of
(L+1)^2 = 49. One `aggregate` call per layer, on the (E, 49, 128) values
flattened to (E, 6272); the edge softmax stays plain PyTorch. The rotation
of the senders' rows, the SO(2) convolution, the radial MLP, the
attention and the values run on the edge block (`MeshGraph`); the
equivariant RMS norm and the FFN are per node.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.engine.batch import resolve_device
from repro_torch.models.gnn.common import (MLP, GraphBatch, MeshGraph,
                                           energy_loss, frozen, mlp_apply,
                                           mlp_init, normal, to_tensor)
from repro_torch.models.gnn.nequip import bessel_rbf   # same radial basis
from repro_torch.models.gnn.so3 import (irrep_dim, rotation_to_z,
                                        wigner_d_blocks)


@dataclass(frozen=True)
class EquiformerV2Config:
    name: str = "equiformer-v2"
    n_layers: int = 12
    d_hidden: int = 128
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    n_rbf: int = 16
    cutoff: float = 6.0
    n_species: int = 16
    dtype: str = "float32"


@lru_cache(maxsize=None)
def _m_rows(l_max: int, m_max: int):
    """Row indices (into the (l_max+1)^2 flat irrep axis) with |m| <= m_max,
    plus per-row (l, m)."""
    rows, lms = [], []
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            if abs(m) <= m_max:
                rows.append(l * l + l + m)
                lms.append((l, m))
    return tuple(rows), tuple(lms)


@lru_cache(maxsize=None)
def _m_groups(l_max: int, m_max: int):
    """For each m in 0..m_max: positions (within the truncated row list) of
    the +m and -m coefficients, ordered by l."""
    rows, lms = _m_rows(l_max, m_max)
    pos_of = {lm: i for i, lm in enumerate(lms)}
    groups = []
    for m in range(0, m_max + 1):
        ls = [l for l in range(max(1, m) if m else 0, l_max + 1) if l >= m]
        plus = [pos_of[(l, m)] for l in ls]
        minus = [pos_of[(l, -m)] for l in ls] if m else []
        groups.append((m, tuple(ls), tuple(plus), tuple(minus)))
    return tuple(groups)


def _rotate_truncated(feat, d_blocks, cfg, transpose=False):
    """Rotate irreps keeping only |m| <= m_max rows of the edge frame (eSCN
    truncation). Forward: (E, (L+1)^2, C) -> (E, n_rows, C). transpose=True
    rotates truncated edge-frame features back: (E, n_rows, C) -> (E, (L+1)^2, C).
    """
    rows, _lms = _m_rows(cfg.l_max, cfg.m_max)
    parts = []
    off = 0
    for l in range(cfg.l_max + 1):
        lo, hi = l * l, (l + 1) ** 2
        sel = [i - lo for i in rows if lo <= i < hi]
        d_sel = d_blocks[l][..., sel, :]            # (E, n_sel, 2l+1)
        if not transpose:
            parts.append(torch.einsum("emn,enc->emc", d_sel,
                                      feat[:, lo:hi, :]))
        else:
            k = len(sel)
            parts.append(torch.einsum("emn,emc->enc", d_sel,
                                      feat[:, off:off + k, :]))
            off += k
    return torch.cat(parts, dim=1)


def _so2_conv(z, radial_scale, layer, cfg, edge):
    """Per-m SO(2) linear maps on edge-frame features.
    z: (E, n_rows, C); radial_scale: (E, m_max+1, C). ``edge`` maps each
    weight before its use (`MeshGraph.edge`)."""
    groups = _m_groups(cfg.l_max, cfg.m_max)
    E, _, C = z.shape
    out = torch.zeros_like(z)
    for gi, (m, ls, plus, minus) in enumerate(groups):
        w1 = edge(layer.so2_w1[gi])
        plus = list(plus)
        fp = z[:, plus, :].reshape(E, -1)
        if m == 0:
            o = fp @ w1
            o = o.reshape(E, len(ls), C) * radial_scale[:, 0, None, :]
            out[:, plus, :] = o
        else:
            w2 = edge(layer.so2_w2[gi])
            minus = list(minus)
            fm = z[:, minus, :].reshape(E, -1)
            op = (fp @ w1 - fm @ w2).reshape(E, len(ls), C)
            om = (fm @ w1 + fp @ w2).reshape(E, len(ls), C)
            scale = radial_scale[:, m, None, :]
            out[:, plus, :] = op * scale
            out[:, minus, :] = om * scale
    return out


def _equi_layernorm(h, eps=1e-6):
    """Equivariant RMS norm per l (over m and channels)."""
    L1s = int(np.sqrt(h.shape[1]))
    parts = []
    for l in range(L1s):
        lo, hi = l * l, (l + 1) ** 2
        blk = h[:, lo:hi, :]
        rms = torch.sqrt(torch.mean(torch.square(blk), dim=(1, 2),
                                    keepdim=True) + eps)
        parts.append(blk / rms)
    return torch.cat(parts, dim=1)


class EquiformerV2Layer(nn.Module):
    """One layer's parameters: the reference's per-layer dict. ``so2_w2``
    holds an empty tensor for m = 0, where the reference has None."""

    def __init__(self, so2: list[tuple[torch.Tensor, torch.Tensor | None]],
                 radial: MLP, attn_vec, w_val, w_upd, ffn_gate: MLP, ffn):
        super().__init__()
        dev = attn_vec.device
        self.so2_w1 = nn.ParameterList([frozen(w1) for w1, _ in so2])
        self.so2_w2 = nn.ParameterList([
            frozen(torch.empty(0, device=dev) if w2 is None else w2)
            for _, w2 in so2])
        self.radial = radial                     # n_rbf -> (m_max+1) * C
        self.attn_vec = frozen(attn_vec)         # (H, C / H)
        self.w_val = frozen(w_val)               # (C, C)
        self.w_upd = frozen(w_upd)               # (L+1, C, C)
        self.ffn_gate = ffn_gate                 # C -> (L+1) * C
        self.ffn = frozen(ffn)                   # (L+1, C, C)


class EquiformerV2(nn.Module):
    """Equiformer-v2's parameters on one device and its serving forward."""

    def __init__(self, cfg: EquiformerV2Config, embed: torch.Tensor,
                 layers: list[EquiformerV2Layer], readout: MLP):
        super().__init__()
        self.cfg = cfg
        self.embed = frozen(embed)               # (n_species, C)
        self.layers = nn.ModuleList(layers)
        self.readout = readout

    @classmethod
    def random(cls, cfg: EquiformerV2Config, generator: torch.Generator
               ) -> EquiformerV2:
        """Weights drawn on ``generator.device`` with the reference's
        distributions (the numbers differ from JAX's for the same seed)."""
        resolve_device(generator.device)
        dt = getattr(torch, cfg.dtype)
        C, L1, H = cfg.d_hidden, cfg.l_max + 1, cfg.n_heads
        groups = _m_groups(cfg.l_max, cfg.m_max)
        layers = []
        for _ in range(cfg.n_layers):
            so2 = []
            for m, ls, _plus, _minus in groups:
                dim = len(ls) * C
                so2.append((normal(generator, (dim, dim), 1 / np.sqrt(dim), dt),
                            normal(generator, (dim, dim), 1 / np.sqrt(dim), dt)
                            if m > 0 else None))
            layers.append(EquiformerV2Layer(
                so2,
                mlp_init(generator, [cfg.n_rbf, C, (cfg.m_max + 1) * C], dt),
                normal(generator, (H, C // H), 1 / np.sqrt(C), dt),
                normal(generator, (C, C), 1 / np.sqrt(C), dt),
                normal(generator, (L1, C, C), 1 / np.sqrt(C), dt),
                mlp_init(generator, [C, C, L1 * C], dt),
                normal(generator, (L1, C, C), 1 / np.sqrt(C), dt)))
        return cls(cfg, normal(generator, (cfg.n_species, C), 0.5, dt),
                   layers, mlp_init(generator, [C, C, 1], dt))

    @classmethod
    def from_jax(cls, cfg: EquiformerV2Config, params: dict, *,
                 device="cuda") -> EquiformerV2:
        """Carry the reference's `init_params(cfg, key)` onto ``device``."""
        dev = resolve_device(device)

        def t(a):
            return to_tensor(a, dev)

        layers = [EquiformerV2Layer(
            [(t(s["w1"]), None if s["w2"] is None else t(s["w2"]))
             for s in la["so2"]],
            MLP.from_jax(la["radial"], dev), t(la["attn_vec"]),
            t(la["w_val"]), t(la["w_upd"]), MLP.from_jax(la["ffn_gate"], dev),
            t(la["ffn"])) for la in params["layers"]]
        return cls(cfg, t(params["embed"]), layers,
                   MLP.from_jax(params["readout"], dev))

    def param_tree(self) -> dict:
        """The reference's `init_params` pytree of these very tensors (w2
        None at m = 0, as there)."""
        groups = _m_groups(self.cfg.l_max, self.cfg.m_max)
        return {"embed": self.embed,
                "layers": [{
                    "so2": [{"w1": w1, "w2": w2 if m > 0 else None}
                            for (m, *_), w1, w2 in zip(groups, la.so2_w1,
                                                       la.so2_w2)],
                    "radial": la.radial.param_tree(),
                    "attn_vec": la.attn_vec, "w_val": la.w_val,
                    "w_upd": la.w_upd, "ffn_gate": la.ffn_gate.param_tree(),
                    "ffn": la.ffn} for la in self.layers],
                "readout": self.readout.param_tree()}

    def forward(self, g: GraphBatch, *, use_kernel: bool = True
                ) -> torch.Tensor:
        """Per-graph energies (n_graphs,)."""
        cfg = self.cfg
        mg = MeshGraph(g, use_kernel=use_kernel)
        n = mg.n_loc
        C = cfg.d_hidden
        H = cfg.n_heads
        dim = irrep_dim(cfg.l_max)
        dt = getattr(torch, cfg.dtype)

        h = torch.zeros((n, dim, C), dtype=dt, device=g.device)
        h[:, 0, :] = self.embed[g.species]

        pos = mg.rows(g.positions)
        vec = pos[g.senders] - pos[g.receivers]
        r = torch.sqrt(torch.sum(vec * vec, -1) + 1e-12)
        # degenerate (zero-length / self-loop) edges have no edge frame: mask them
        mg.mask_edges(g.edge_mask & (r > 1e-5))
        rot = rotation_to_z(vec).to(dt)
        d_blocks = wigner_d_blocks(rot, cfg.l_max)
        rbf = bessel_rbf(r, cfg.n_rbf, cfg.cutoff).to(dt)

        for layer in self.layers:
            hn = _equi_layernorm(h)
            # rotate source features into the edge frame, truncated to |m|<=m_max
            z = _rotate_truncated(mg.rows(hn)[g.senders], d_blocks, cfg)
            rs = mlp_apply(layer.radial, rbf, wrap=mg.edge).reshape(
                -1, cfg.m_max + 1, C)
            z = _so2_conv(z, rs, layer, cfg, mg.edge)

            # attention scores from the m=0, l=0 row (invariant channel)
            inv = z[:, 0, :].reshape(-1, H, C // H)
            score = F.leaky_relu(
                torch.einsum("ehc,hc->eh", inv, mg.edge(layer.attn_vec)), 0.2)
            alpha = mg.edge_softmax(score)                          # (E, H)

            # values: rotate back to the global frame, head-weighted
            val = _rotate_truncated(z @ mg.edge(layer.w_val), d_blocks, cfg,
                                    transpose=True)                 # (E,49,C)
            val = val.reshape(-1, dim, H, C // H) * alpha[:, None, :, None]
            msg = mg.aggregate(val.reshape(-1, dim, C))

            upd = []
            for l in range(cfg.l_max + 1):
                lo, hi = l * l, (l + 1) ** 2
                upd.append(msg[:, lo:hi, :] @ layer.w_upd[l])
            h = h + torch.cat(upd, dim=1)

            # gated equivariant FFN
            hn2 = _equi_layernorm(h)
            gates = mlp_apply(layer.ffn_gate, hn2[:, 0, :])
            gates = torch.sigmoid(gates.reshape(n, cfg.l_max + 1, C))
            ff = []
            for l in range(cfg.l_max + 1):
                lo, hi = l * l, (l + 1) ** 2
                ff.append((hn2[:, lo:hi, :] @ layer.ffn[l])
                          * gates[:, None, l, :])
            h = h + torch.cat(ff, dim=1)

        e_node = mlp_apply(self.readout, h[:, 0, :])[:, 0] * g.node_mask
        return mg.pool(e_node)


def loss_fn(model: EquiformerV2, g: GraphBatch, *, use_kernel: bool = True):
    return energy_loss(model(g, use_kernel=use_kernel), g)
