"""xDeepFM (Lian et al. 2018): sparse embeddings + CIN + deep MLP + linear.

Assigned config: 39 sparse fields, embed_dim=10, CIN 200-200-200, MLP 400-400.
One concatenated embedding table holds every field's rows at per-field
offsets; fields are single-valued (Criteo-style), and huge tables use the
per-field vocab list below (power-law sized, ~10^6 rows max by default).

The CIN layer x^{k+1}_h = sum_{i,j} W^k_{h,i,j} (x^k_i ∘ x^0_j) is einsum-
shaped. With ``use_kernel=True`` on a CUDA device, the lookup runs the
hand-written gather kernel (`kernels.embedding_bag`) and each CIN layer the
fused CIN kernel (`kernels.cin`), which never stores the (B, H, F, D) outer
product; on the CPU the same flag runs their plain versions. The linear
term, the CIN output projection and the MLP are plain PyTorch, as they are
plain jnp in the reference.

Training (`loss_fn`, the reference's sigmoid cross-entropy) runs the plain
path, as the reference trains through its jnp path: the kernels have no
backward and raise under autograd. The parameters do not require
gradients until a trainer turns them on (`param_tree` is the reference's
pytree of these very tensors).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.engine.batch import resolve_device
from repro_torch.kernels.cin.ops import cin_layer
from repro_torch.kernels.cin.ref import cin_layer_ref
from repro_torch.kernels.embedding_bag.ops import gather_rows


def default_vocab_sizes(n_fields: int = 39, max_vocab: int = 1_000_000,
                        seed: int = 7) -> tuple[int, ...]:
    """Criteo-like power-law vocabulary sizes."""
    rng = np.random.default_rng(seed)
    raw = np.clip((max_vocab * rng.pareto(1.1, n_fields)).astype(np.int64),
                  100, max_vocab)
    raw[:3] = max_vocab            # a few huge tables, like Criteo
    return tuple(int(x) for x in raw)


@dataclass(frozen=True)
class XDeepFMConfig:
    name: str = "xdeepfm"
    n_sparse: int = 39
    n_dense: int = 13
    embed_dim: int = 10
    cin_layers: tuple[int, ...] = (200, 200, 200)
    mlp_layers: tuple[int, ...] = (400, 400)
    vocab_sizes: tuple[int, ...] = field(default_factory=default_vocab_sizes)
    dtype: str = "float32"

    @property
    def total_vocab(self) -> int:
        return int(sum(self.vocab_sizes))


def field_offsets(cfg: XDeepFMConfig) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(cfg.vocab_sizes)[:-1]]).astype(np.int32)


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class XDeepFM(nn.Module):
    """xDeepFM's parameters on one device and its serving forward.

    Build it with `XDeepFM.random` (weights drawn from a torch.Generator on
    the device) or `XDeepFM.from_jax` (the reference's `init_params`
    output); the constructor takes the parameter tensors themselves.
    """

    def __init__(self, cfg: XDeepFMConfig, embed: torch.Tensor,
                 lin_embed: torch.Tensor, dense_proj: torch.Tensor,
                 cin: list[torch.Tensor], cin_out: torch.Tensor,
                 mlp: list[tuple[torch.Tensor, torch.Tensor]]):
        super().__init__()
        self.cfg = cfg
        self.embed = _frozen(embed)              # (total_vocab, D)
        self.lin_embed = _frozen(lin_embed)      # (total_vocab, 1)
        self.dense_proj = _frozen(dense_proj)    # (n_dense, D), unused as
        #                                          in the reference forward
        self.cin = nn.ParameterList([_frozen(w) for w in cin])  # (H, Hp, F)
        self.cin_out = _frozen(cin_out)          # (sum(H_k), 1)
        self.mlp_w = nn.ParameterList([_frozen(w) for w, _ in mlp])
        self.mlp_b = nn.ParameterList([_frozen(b) for _, b in mlp])
        self.register_buffer("offsets", torch.from_numpy(
            field_offsets(cfg)).to(embed.device))

    @classmethod
    def random(cls, cfg: XDeepFMConfig,
               generator: torch.Generator) -> XDeepFM:
        """Weights drawn on ``generator.device`` with the reference's
        distributions (the numbers differ from JAX's for the same seed)."""
        dev = generator.device
        dt = getattr(torch, cfg.dtype)
        D, F = cfg.embed_dim, cfg.n_sparse

        def normal(*shape, scale):
            return (torch.randn(shape, generator=generator, device=dev,
                                dtype=torch.float32) * scale).to(dt)

        total = cfg.total_vocab
        cin, h_prev = [], F
        for h in cfg.cin_layers:
            cin.append(normal(h, h_prev, F, scale=1 / np.sqrt(h_prev * F)))
            h_prev = h
        dims = [F * D + cfg.n_dense, *cfg.mlp_layers, 1]
        mlp = [(normal(a, b, scale=1 / np.sqrt(a)),
                torch.zeros((b,), dtype=dt, device=dev))
               for a, b in zip(dims[:-1], dims[1:])]
        return cls(cfg, normal(total, D, scale=0.01),
                   normal(total, 1, scale=0.01),
                   normal(cfg.n_dense, D, scale=0.1), cin,
                   normal(sum(cfg.cin_layers), 1, scale=0.1), mlp)

    @classmethod
    def from_jax(cls, cfg: XDeepFMConfig, params: dict, *,
                 device="cuda") -> XDeepFM:
        """Carry the reference's `init_params(cfg, key)` output (arrays or
        numpy arrays, same pytree) onto ``device``."""
        dev = resolve_device(device)

        def t(a):
            return torch.from_numpy(np.array(a, copy=True)).to(dev)

        return cls(cfg, t(params["embed"]), t(params["lin_embed"]),
                   t(params["dense_proj"]), [t(w) for w in params["cin"]],
                   t(params["cin_out"]),
                   [(t(layer["w"]), t(layer["b"])) for layer in params["mlp"]])

    def param_tree(self) -> dict:
        """The reference's `init_params` pytree of the module's own
        parameter tensors (no copies): what a trainer updates and a
        checkpoint stores."""
        return {"embed": self.embed, "lin_embed": self.lin_embed,
                "dense_proj": self.dense_proj, "cin": list(self.cin),
                "cin_out": self.cin_out,
                "mlp": [{"w": w, "b": b}
                        for w, b in zip(self.mlp_w, self.mlp_b)]}

    def _rows(self, sparse_ids: torch.Tensor) -> torch.Tensor:
        """(B, n_sparse) per-field local ids -> global table rows, int32."""
        return sparse_ids.to(torch.int32) + self.offsets[None, :]

    def embedding_lookup(self, sparse_ids: torch.Tensor, *,
                         use_kernel: bool = False) -> torch.Tensor:
        """sparse_ids: (B, n_sparse) per-field local ids -> (B, n_sparse, D).

        The hot path: a gather over a 10^6+-row table (EmbeddingBag, bag
        size 1 per field). The plain path is `F.embedding`, whose dense
        backward sorts the ids before it sums their rows; `index_select`'s
        adds them with atomics, in an order that changes between runs on
        the card."""
        rows = self._rows(sparse_ids)
        if use_kernel:
            out = gather_rows(self.embed, rows.reshape(-1))
            return out.reshape(*rows.shape, self.cfg.embed_dim)
        return F.embedding(rows, self.embed)

    def cin_forward(self, x0: torch.Tensor, *,
                    use_kernel: bool = False) -> torch.Tensor:
        """Compressed Interaction Network. x0: (B, F, D) -> (B, sum(H_k))."""
        feats = []
        xk = x0
        layer = cin_layer if use_kernel else cin_layer_ref
        for w in self.cin:
            xk = layer(xk, x0, w)
            feats.append(xk.sum(dim=-1))           # sum-pool over D
        return torch.cat(feats, dim=-1)

    def forward(self, sparse_ids: torch.Tensor, dense_feats: torch.Tensor, *,
                use_kernel: bool = False) -> torch.Tensor:
        """Logits (B,). sparse_ids (B, n_sparse) int32; dense (B, n_dense)."""
        emb = self.embedding_lookup(sparse_ids, use_kernel=use_kernel)
        B = emb.shape[0]
        # linear term
        rows = self._rows(sparse_ids)
        lin = F.embedding(rows, self.lin_embed)[..., 0].sum(dim=-1)
        # CIN term
        cin = self.cin_forward(emb, use_kernel=use_kernel)
        cin_logit = (cin @ self.cin_out)[:, 0]
        # deep term
        x = torch.cat([emb.reshape(B, -1), dense_feats], dim=-1)
        for i, (w, b) in enumerate(zip(self.mlp_w, self.mlp_b)):
            x = x @ w + b
            if i < len(self.mlp_w) - 1:
                x = torch.relu(x)
        return lin + cin_logit + x[:, 0]

    def retrieval_scores(self, query_emb: torch.Tensor,
                         candidate_ids: torch.Tensor) -> torch.Tensor:
        """Score 1 query against n_candidates via one batched dot.

        query_emb: (F*D,) pooled query representation; candidate_ids: (N,)
        rows of the embedding table treated as item vectors."""
        cand = self.embed.index_select(0, candidate_ids)       # (N, D)
        q = query_emb.reshape(-1, self.cfg.embed_dim).mean(dim=0)
        return cand @ q


def loss_fn(model: XDeepFM, batch: dict, *, use_kernel: bool = False):
    """Sigmoid cross-entropy in its stable form, max(l, 0) - l y +
    log1p(exp(-|l|)), averaged over the batch, and the share of logits on
    the label's side of 0 ("acc"). ``batch``: sparse (B, n_sparse), dense
    (B, n_dense), label (B,) tensors."""
    logits = model(batch["sparse"], batch["dense"],
                   use_kernel=use_kernel).to(torch.float32)
    y = batch["label"].to(torch.float32)
    loss = torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))
    acc = torch.mean(((logits > 0) == (y > 0.5)).to(torch.float32))
    return loss, {"loss": loss, "acc": acc}
