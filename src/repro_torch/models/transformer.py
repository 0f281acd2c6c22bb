"""Dense decoder-only transformer LM: serving and training.

The port of the reference's `models/transformer.py` for the dense
configurations (granite-3-8b, granite-20b, nemotron-4-15b): GQA/MQA
attention with RoPE, RMSNorm, SwiGLU / GELU / squared-ReLU MLPs, and
layer-stacked parameters in the reference's pytree layout. It serves
`forward`, `prefill` and `decode_step` with a KV cache kept in the
reference's (layers, B, T, Hkv, d_head) layout.

Attention goes through the flash-attention op (`kernels.flash_attention`):
the hand-written CUDA kernel for tensors on the card, its plain version on
the CPU. ``use_kernel=False`` selects `_sdpa`, the port of the reference's
XLA-level attention, which rounds the probabilities to the input dtype
before the value product as the reference does; it is there for the
comparisons, and it is the attention training runs through.

Training (`hidden_forward`, `ce_from_hidden`, `loss_fn`) follows the
reference's plain path: `_sdpa` attention under autograd, the cross-entropy
over the unpadded vocabulary, optionally in sequence chunks each
recomputed in the backward (``ce_chunk``, `torch.utils.checkpoint` where
the reference maps `jax.checkpoint` over the chunks), and with
``remat=True`` each layer recomputed in the backward, as the reference's
`_scan_layers` checkpoints its scan body. DeepSeek MLA, the MoE layers and
the MTP head are not ported yet (ROADMAP, Queue 1 item 3).

Unlike the reference's functional cache, the KV cache is updated in place:
`prefill` and `decode_step` write the new slots into the cache tensors they
are given and return those same tensors. A functional copy of the cache
(42.9 GB for granite-3-8b at batch 8 and 32,768 slots) does not fit beside
the weights on one card.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.engine.batch import resolve_device
from repro_torch.kernels.flash_attention.ops import flash_attention


@dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_head: int
    d_ff: int
    vocab_size: int
    mlp: str = "swiglu"            # swiglu | gelu | relu2
    attn: str = "gqa"              # gqa | mla
    # --- MLA (DeepSeek) ---
    q_lora_rank: int = 0
    kv_lora_rank: int = 512
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128
    # --- MoE ---
    moe: bool = False
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    moe_d_ff: int = 0
    shared_d_ff: int = 0
    first_dense_layers: int = 0
    capacity_factor: float = 1.25
    # --- extras ---
    mtp_depth: int = 0
    rope_theta: float = 10000.0
    attn_chunk: int = 0            # q-chunked attention (0 = full scores)
    ce_chunk: int = 0              # seq-chunked cross-entropy (0 = full logits)
    norm_eps: float = 1e-5
    vocab_pad_to: int = 128
    dtype: str = "bfloat16"
    tie_embeddings: bool = False

    @property
    def padded_vocab(self) -> int:
        m = self.vocab_pad_to
        return ((self.vocab_size + m - 1) // m) * m

    @property
    def q_dim(self) -> int:
        if self.attn == "mla":
            return self.n_heads * (self.qk_nope_dim + self.qk_rope_dim)
        return self.n_heads * self.d_head

    def n_params(self) -> int:
        """Analytic parameter count (embedding included once)."""
        c = self
        d = c.d_model
        n = c.padded_vocab * d  # embed
        if not c.tie_embeddings:
            n += c.padded_vocab * d
        per_layer_attn = 0
        if c.attn == "mla":
            qin = c.q_lora_rank or d
            if c.q_lora_rank:
                per_layer_attn += d * c.q_lora_rank + c.q_lora_rank  # + norm
            per_layer_attn += qin * c.n_heads * (c.qk_nope_dim + c.qk_rope_dim)
            per_layer_attn += d * (c.kv_lora_rank + c.qk_rope_dim)
            per_layer_attn += c.kv_lora_rank  # kv_norm
            per_layer_attn += c.kv_lora_rank * c.n_heads * (c.qk_nope_dim + c.v_head_dim)
            per_layer_attn += c.n_heads * c.v_head_dim * d
        else:
            per_layer_attn += d * c.n_heads * c.d_head
            per_layer_attn += 2 * d * c.n_kv_heads * c.d_head
            per_layer_attn += c.n_heads * c.d_head * d

        def mlp_params(ff):
            return (3 if c.mlp == "swiglu" else 2) * d * ff

        total_layers = 0
        for li in range(c.n_layers):
            total_layers += per_layer_attn + 2 * d  # norms
            if c.moe and li >= c.first_dense_layers:
                total_layers += d * c.n_experts  # router
                total_layers += c.n_experts * mlp_params(c.moe_d_ff)
                total_layers += mlp_params(c.shared_d_ff) * (1 if c.n_shared_experts else 0)
            else:
                total_layers += mlp_params(c.d_ff)
        n += total_layers + d  # final norm
        if c.mtp_depth:        # MTP: concat proj + one dense block
            n += 2 * d * d + per_layer_attn + mlp_params(c.d_ff) + 2 * d
        return n

    def active_params(self) -> int:
        """Params active per token (MoE: top_k + shared experts only)."""
        if not self.moe:
            return self.n_params()
        c = self
        d = c.d_model

        def mlp_params(ff):
            return (3 if c.mlp == "swiglu" else 2) * d * ff

        dense_all = self.n_params()
        moe_layers = c.n_layers - c.first_dense_layers
        inactive = moe_layers * (c.n_experts - c.top_k) * mlp_params(c.moe_d_ff)
        return dense_all - inactive


def _check_dense(cfg: LMConfig) -> None:
    for flag, what in ((cfg.attn == "mla", "MLA attention"),
                       (cfg.moe, "MoE layers"),
                       (cfg.mtp_depth > 0, "the MTP head")):
        if flag:
            raise NotImplementedError(
                f"{cfg.name}: {what} is not ported yet (ROADMAP, Queue 1 "
                "item 3); the port serves and trains the dense GQA/MQA "
                "configs")


# ---------------------------------------------------------------------------
# forward pieces (the reference's names and layouts)
# ---------------------------------------------------------------------------

def rmsnorm(x, scale, eps):
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(x.dtype) * scale


def rope_freqs(positions, dim, theta):
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                        device=positions.device) / dim))
    ang = positions.float()[..., None] * inv  # (..., dim/2)
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, cos, sin):
    """x: (..., n_heads, dim); cos/sin: (..., dim/2) broadcast over heads.
    The halves of the head are rotated (not interleaved pairs); the float32
    cos/sin promote the products before the cast back."""
    x1, x2 = x.chunk(2, dim=-1)
    c, s = cos[..., None, :], sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


def _act(x, kind):
    if kind == "gelu":
        return F.gelu(x, approximate="tanh")   # jax.nn.gelu's default
    if kind == "relu2":
        r = torch.relu(x)
        return r * r
    raise ValueError(kind)


def _mlp(p, x, kind):
    if kind == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_in"])) @ p["w_out"]
    return _act(x @ p["w_in"], kind) @ p["w_out"]


def _sdpa(q, k, v, scale, q_start, *, chunk: int = 0):
    """q: (B,S,H,dh) k/v: (B,T,Hkv,dh). Grouped-head GQA — KV never repeated
    in memory.

    Causal mask: col <= q_start + row. The scores are formed in the input
    dtype, masked and soft-maxed in float32, and the probabilities rounded
    back to the input dtype before the value product, as in the reference.
    chunk > 0 loops over q chunks so peak score memory is (chunk, T)."""
    B, S, H, dh = q.shape
    Hkv = k.shape[2]
    G = H // Hkv
    T = k.shape[1]
    cols = torch.arange(T, device=q.device)[None, :]

    def block(qb, row0):
        cs = qb.shape[1]
        scores = torch.einsum("bskgd,btkd->bkgst", qb, k) * scale
        rows = q_start + row0 + torch.arange(cs, device=q.device)[:, None]
        scores = torch.where(cols <= rows, scores.float(), -1e30)
        probs = torch.softmax(scores, dim=-1).to(qb.dtype)
        return torch.einsum("bkgst,btkd->bskgd", probs, v)

    qg = q.reshape(B, S, Hkv, G, dh)
    if chunk and S > chunk and S % chunk == 0:
        out = torch.cat([block(qg[:, i:i + chunk], i)
                         for i in range(0, S, chunk)], dim=1)
    else:
        out = block(qg, 0)
    return out.reshape(B, S, H, v.shape[-1])


def _gqa_attention(p, cfg: LMConfig, x, positions, q_start, cache=None, *,
                   use_kernel: bool = True):
    """Attention of one layer. ``cache`` is (ck, cv, cur): the layer's
    (B, T, Hkv, dh) cache tensors, into whose slots cur .. cur + S the new
    keys and values are written in place, and the first slot's index."""
    B, S, D = x.shape
    c = cfg
    q = (x @ p["wq"]).reshape(B, S, c.n_heads, c.d_head)
    k = (x @ p["wk"]).reshape(B, S, c.n_kv_heads, c.d_head)
    v = (x @ p["wv"]).reshape(B, S, c.n_kv_heads, c.d_head)
    cos, sin = rope_freqs(positions, c.d_head, c.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if cache is not None:
        ck, cv, cur = cache
        if not 0 <= cur <= ck.shape[1] - S:
            raise ValueError(f"cache of {ck.shape[1]} slots cannot take "
                             f"{S} rows at position {cur}")
        ck[:, cur:cur + S] = k
        cv[:, cur:cur + S] = v
        k, v = ck, cv
    scale = 1.0 / math.sqrt(c.d_head)
    if use_kernel:
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=True, scale=scale,
                              q_start=q_start).transpose(1, 2)
    else:
        out = _sdpa(q, k, v, scale, q_start, chunk=c.attn_chunk)
    return out.reshape(B, S, c.n_heads * c.d_head) @ p["wo"]


def _layer_fwd(p, cfg: LMConfig, x, positions, q_start, cache=None, *,
               use_kernel: bool = True):
    h = _gqa_attention(p["attn"], cfg, rmsnorm(x, p["ln1"], cfg.norm_eps),
                       positions, q_start, cache, use_kernel=use_kernel)
    x = x + h
    z = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + _mlp(p["mlp"], z, cfg.mlp)


def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
               device="cuda"):
    """Stacked per-layer KV cache, zeros: {"dense": (ck, cv), "moe": None}
    with ck, cv of shape (n_layers, batch, max_len, n_kv_heads, d_head)."""
    _check_dense(cfg)
    dt = dtype or getattr(torch, cfg.dtype)
    dev = resolve_device(device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.d_head)
    return {"dense": (torch.zeros(shape, dtype=dt, device=dev),
                      torch.zeros(shape, dtype=dt, device=dev)),
            "moe": None}


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _tensor(a, dev) -> torch.Tensor:
    """One reference array (JAX or numpy) as a tensor on ``dev``; bfloat16
    crosses as its raw 16 bits (numpy has no bfloat16 of its own)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).astype(np.int16)) \
            .view(torch.bfloat16).to(dev)
    return torch.from_numpy(np.array(a, copy=True)).to(dev)


class Transformer:
    """A dense LM's parameters on one device and its serving entry points.

    ``params`` holds the reference's pytree: "embed" (V, D), "final_norm"
    (D,), "lm_head" (D, V) unless embeddings are tied, and "dense_layers"
    with each leaf stacked over the layers ("attn": wq, wk, wv, wo; "ln1",
    "ln2"; "mlp": w_in, w_out and, for SwiGLU, w_gate). Build it with
    `Transformer.random` or `Transformer.from_jax`.
    """

    def __init__(self, cfg: LMConfig, params: dict):
        _check_dense(cfg)
        self.cfg = cfg
        self.params = params
        stacked = params["dense_layers"]
        self.layers = [_map(stacked, lambda t, i=i: t[i])
                       for i in range(cfg.n_layers)]

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    @classmethod
    def random(cls, cfg: LMConfig, seed: int = 0, device="cuda",
               dtype=None) -> Transformer:
        """Weights drawn from a seeded torch.Generator on ``device``: each
        matrix normal x 1/sqrt(fan-in), the embedding normal x 0.02, the
        norms at one, as the reference's `_dense` draws them (the numbers
        differ from JAX's for the same seed). The fan-in is each layer's
        matrix's input width; the reference's `init_params` reads it off the
        first axis of the layer-stacked array, i.e. the layer count, which
        would make every layer's scale depend on how far the depth is cut.
        Layers are drawn one at a time in float32 and cast, so the 8B config
        needs no float32 copy of a whole stack."""
        _check_dense(cfg)
        dev = resolve_device(device)
        dt = dtype or getattr(torch, cfg.dtype)
        gen = torch.Generator(device=dev).manual_seed(seed)
        d, L = cfg.d_model, cfg.n_layers

        def normal(*shape, scale, stack=()):
            out = torch.empty((*stack, *shape), dtype=dt, device=dev)
            for view in (out if stack else [out]):
                view.copy_(torch.randn(shape, generator=gen, device=dev) * scale)
            return out

        def dense(fan_in, fan_out, stack=(L,)):
            return normal(fan_in, fan_out, scale=1.0 / math.sqrt(fan_in),
                          stack=stack)

        ones = torch.ones((L, d), dtype=dt, device=dev)
        layers = {
            "attn": {"wq": dense(d, cfg.n_heads * cfg.d_head),
                     "wk": dense(d, cfg.n_kv_heads * cfg.d_head),
                     "wv": dense(d, cfg.n_kv_heads * cfg.d_head),
                     "wo": dense(cfg.n_heads * cfg.d_head, d)},
            "ln1": ones, "ln2": ones.clone(),
            "mlp": {"w_in": dense(d, cfg.d_ff), "w_out": dense(cfg.d_ff, d)}}
        if cfg.mlp == "swiglu":
            layers["mlp"]["w_gate"] = dense(d, cfg.d_ff)
        params = {"embed": normal(cfg.padded_vocab, d, scale=0.02),
                  "final_norm": torch.ones((d,), dtype=dt, device=dev),
                  "dense_layers": layers}
        if not cfg.tie_embeddings:
            params["lm_head"] = dense(d, cfg.padded_vocab, stack=())
        return cls(cfg, params)

    @classmethod
    def from_jax(cls, cfg: LMConfig, params: dict,
                 device="cuda") -> Transformer:
        """Carry the reference's `init_params(cfg, key)` output (JAX or
        numpy arrays, same pytree) onto ``device``."""
        _check_dense(cfg)
        dev = resolve_device(device)
        return cls(cfg, _map(params, lambda a: _tensor(a, dev)))

    def n_params(self) -> int:
        return sum(t.numel() for t in _leaves(self.params))

    def param_tree(self) -> dict:
        """The reference's `init_params` pytree: ``params`` itself."""
        return self.params

    def init_cache(self, batch: int, max_len: int):
        """A zero cache in the parameters' dtype on their device."""
        return init_cache(self.cfg, batch, max_len,
                          self.params["embed"].dtype, self.device)

    def _run(self, tokens, positions, q_start, cache=None, cur=0, *,
             use_kernel):
        p = self.params
        x = p["embed"][tokens]
        for i, lp in enumerate(self.layers):
            layer_cache = None if cache is None else (
                cache["dense"][0][i], cache["dense"][1][i], cur)
            x = _layer_fwd(lp, self.cfg, x, positions, q_start, layer_cache,
                           use_kernel=use_kernel)
        x = rmsnorm(x, p["final_norm"], self.cfg.norm_eps)
        head = p["embed"].T if self.cfg.tie_embeddings else p["lm_head"]
        return x @ head

    def forward(self, tokens, *, use_kernel: bool = True):
        """tokens (B, S) -> logits (B, S, padded_vocab)."""
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
        return self._run(tokens, positions, 0, use_kernel=use_kernel)

    def prefill(self, tokens, max_len: int | None = None, *,
                use_kernel: bool = True):
        """Prefill pass: (logits (B, S, V), a fresh cache of ``max_len``
        slots (default S) holding the prompt's keys and values in slots
        0 .. S - 1)."""
        B, S = tokens.shape
        cache = self.init_cache(B, max_len or S)
        positions = torch.arange(S, device=tokens.device)[None]
        return self._run(tokens, positions, 0, cache, 0,
                         use_kernel=use_kernel), cache

    def decode_step(self, cache, tokens, cur_len: int, *,
                    use_kernel: bool = True):
        """One decode step. tokens (B, 1) at position ``cur_len``; cache from
        `init_cache` or `prefill`, written in place at slot ``cur_len``.
        Returns (logits (B, 1, V), cache) — the same cache object."""
        cur_len = int(cur_len)
        positions = torch.full((tokens.shape[0], 1), cur_len,
                               dtype=torch.int32, device=tokens.device)
        return self._run(tokens, positions, cur_len, cache, cur_len,
                         use_kernel=use_kernel), cache


# ---------------------------------------------------------------------------
# training: the reference's loss on its plain path
# ---------------------------------------------------------------------------

def hidden_forward(params, cfg: LMConfig, tokens, *, remat: bool = False):
    """tokens (B, S) -> final hidden states (B, S, D) (pre-head), through
    `_sdpa` attention. ``remat`` recomputes each layer in the backward."""
    _check_dense(cfg)
    S = tokens.shape[1]
    x = F.embedding(tokens, params["embed"])
    positions = torch.arange(S, device=tokens.device)[None]
    stacked = params["dense_layers"]

    def layer(x, i):
        lp = _map(stacked, lambda t: t[i])
        return _layer_fwd(lp, cfg, x, positions, 0, use_kernel=False)

    for i in range(cfg.n_layers):
        x = (checkpoint(layer, x, i, use_reentrant=False) if remat
             else layer(x, i))
    return rmsnorm(x, params["final_norm"], cfg.norm_eps)


def _ce(logits, labels, cfg: LMConfig):
    """Mean negative log-likelihood of the labels >= 0 (-100 masks), the
    padded vocabulary entries masked out of the normaliser."""
    V = logits.shape[-1]
    mask = labels >= 0
    nll = _nll(logits, labels, mask, cfg.vocab_size, V)
    return nll.sum() / torch.clamp(mask.sum(), min=1)


def _nll(logits, labels, mask, vocab_size: int, V: int):
    safe = torch.where(mask, labels, 0).to(torch.int64)
    real = torch.arange(V, device=logits.device) < vocab_size
    logz = torch.logsumexp(torch.where(real, logits, -1e30), dim=-1)
    gold = torch.take_along_dim(logits, safe[..., None], dim=-1)[..., 0]
    return (logz - gold) * mask


def ce_from_hidden(x, head, labels, cfg: LMConfig):
    """Cross-entropy from final hidden states, optionally seq-chunked.

    ce_chunk > 0 never holds the full (B, S, V) logits: each sequence chunk
    computes its logits, reduces them to (nll_sum, count), and is
    recomputed in the backward (`torch.utils.checkpoint`), so the peak
    drops from O(B*S*V) to O(B*chunk*V) at the same FLOPs."""
    if not cfg.ce_chunk or x.shape[1] % cfg.ce_chunk != 0:
        return _ce((x @ head).to(torch.float32), labels, cfg)
    c = cfg.ce_chunk

    def chunk(xb, lb):
        logits = (xb @ head).to(torch.float32)
        mask = lb >= 0
        return (_nll(logits, lb, mask, cfg.vocab_size, logits.shape[-1])
                .sum(), mask.sum())

    sums, counts = zip(*(checkpoint(chunk, x[:, i:i + c], labels[:, i:i + c],
                                    use_reentrant=False)
                         for i in range(0, x.shape[1], c)))
    return torch.stack(sums).sum() / torch.clamp(torch.stack(counts).sum(),
                                                 min=1)


def loss_fn(params, cfg: LMConfig, tokens, labels, *, remat: bool = False):
    """Causal LM loss; labels == -100 masked; pad-vocab ids masked out.
    Returns (loss, {"ce", "loss"}). The MTP term is not ported."""
    x = hidden_forward(params, cfg, tokens, remat=remat)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    main = ce_from_hidden(x, head, labels, cfg)
    return main, {"ce": main, "loss": main}


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    return fn(tree)


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree
