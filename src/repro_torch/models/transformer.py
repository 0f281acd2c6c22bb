"""Decoder-only transformer LM: serving and training.

The port of the reference's `models/transformer.py` for the five LM
configurations: GQA/MQA attention (granite-3-8b, granite-20b,
nemotron-4-15b, qwen2-moe-a2.7b) and DeepSeek MLA with its compressed KV
cache (deepseek-v3-671b), RoPE, RMSNorm, SwiGLU / GELU / squared-ReLU MLPs,
the shared + routed top-k MoE with capacity-bounded scatter dispatch, the
MTP head's loss term, and layer-stacked parameters in the reference's
pytree layout. It serves `forward`, `prefill` and `decode_step` with a
cache kept in the reference's layouts: (layers, B, T, Hkv, d_head) keys and
values, or MLA's (layers, B, T, kv_lora) latent and (layers, B, T, 1, rope)
decoupled key. The layers run dense first, then MoE, as the reference
stacks them.

GQA attention goes through the flash-attention op
(`kernels.flash_attention`): the hand-written CUDA kernel for tensors on
the card, its plain version on the CPU. ``use_kernel=False`` selects
`_sdpa`, the port of the reference's XLA-level attention, which rounds the
probabilities to the input dtype before the value product as the reference
does; it is there for the comparisons, and it is the attention training
runs through. MLA reaches no kernel in the reference and none here: its
prefill expands the latent into per-head keys and values for `_sdpa`
(query/key head 192, value head 128 at deepseek-v3), and its decode step
attends in the latent space with `wkv_b` absorbed into the query and the
output.

The MoE layer (`_moe_mlp`) follows the reference's one-device dispatch:
float32 router softmax, top-k with ties to the lower expert index, slots
ranked within their expert by a stable sort, (token, k) pairs past the
capacity dropped, the kept ones copied into (E, capacity, D) for the
batched expert products and gathered back. The reference's expert-parallel
`shard_map` and split-KV decodes run on a mesh and are not ported (ROADMAP,
Queue 1 item 5).

Training (`hidden_forward`, `ce_from_hidden`, `loss_fn`) follows the
reference's plain path: `_sdpa` attention under autograd, the cross-entropy
over the unpadded vocabulary, optionally in sequence chunks each
recomputed in the backward (``ce_chunk``, `torch.utils.checkpoint` where
the reference maps `jax.checkpoint` over the chunks), with ``remat=True``
each layer recomputed in the backward, as the reference's `_scan_layers`
checkpoints its scan body, and the MTP term (0.3 x the next-next-token
cross-entropy of one extra dense block) where the config has one.

Unlike the reference's functional cache, the cache is updated in place:
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


def _depths(cfg: LMConfig) -> tuple[int, int]:
    """(dense layers, MoE layers): a MoE config's first_dense_layers are
    dense, as the reference's `init_params` stacks them."""
    if not cfg.moe:
        return cfg.n_layers, 0
    if not 0 <= cfg.first_dense_layers <= cfg.n_layers:
        raise ValueError(
            f"{cfg.name}: first_dense_layers {cfg.first_dense_layers} does "
            f"not fit in {cfg.n_layers} layers; cut it with the depth")
    return cfg.first_dense_layers, cfg.n_layers - cfg.first_dense_layers


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


def _mla_attention(p, cfg: LMConfig, x, positions, q_start, cache=None, *,
                   use_kernel: bool = True):
    """DeepSeek MLA with the compressed cache: ``cache`` is (cc, cr, cur),
    the layer's (B, T, kv_lora) latent and (B, T, 1, rope) decoupled key,
    into whose slots cur .. cur + S the new entries are written in place.
    The attention reads the slots up to cur + S only: the reference's
    masks give the later ones probability zero. A decode step (S = 1 with a
    cache) attends in the latent space with `wkv_b` absorbed; otherwise the
    latent is expanded into per-head keys and values for `_sdpa`. MLA
    reaches no kernel (``use_kernel`` is accepted for the GQA signature)."""
    c = cfg
    B, S, D = x.shape
    qin = rmsnorm(x @ p["wq_a"], p["q_norm"], c.norm_eps) \
        if c.q_lora_rank else x
    q = (qin @ p["wq_b"]).reshape(B, S, c.n_heads,
                                  c.qk_nope_dim + c.qk_rope_dim)
    q_nope, q_rope = q.split([c.qk_nope_dim, c.qk_rope_dim], dim=-1)
    c_kv, k_rope = (x @ p["wkv_a"]).split([c.kv_lora_rank, c.qk_rope_dim],
                                          dim=-1)
    c_kv = rmsnorm(c_kv, p["kv_norm"], c.norm_eps)
    cos, sin = rope_freqs(positions, c.qk_rope_dim, c.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)   # (B, S, 1, rope)
    if cache is not None:
        cc, cr, cur = cache
        if not 0 <= cur <= cc.shape[1] - S:
            raise ValueError(f"cache of {cc.shape[1]} slots cannot take "
                             f"{S} rows at position {cur}")
        cc[:, cur:cur + S] = c_kv
        cr[:, cur:cur + S] = k_rope
        c_kv, k_rope = cc[:, :cur + S], cr[:, :cur + S]

    scale = 1.0 / math.sqrt(c.qk_nope_dim + c.qk_rope_dim)
    if cache is not None and S == 1:
        # absorbed decode: the per-token (B, T, H, .) keys and values are
        # never formed; memory per layer stays O(B T kv_lora)
        w_uk, w_uv = p["wkv_b"].reshape(
            c.kv_lora_rank, c.n_heads, c.qk_nope_dim + c.v_head_dim).split(
            [c.qk_nope_dim, c.v_head_dim], dim=-1)
        q_lat = torch.einsum("bshd,lhd->bshl", q_nope, w_uk)
        scores = (torch.einsum("bshl,btl->bhst", q_lat, c_kv)
                  + torch.einsum("bshr,btur->bhst", q_rope, k_rope)) * scale
        cols = torch.arange(c_kv.shape[1], device=x.device)
        scores = torch.where(cols <= q_start, scores.float(), -1e30)
        probs = torch.softmax(scores, dim=-1).to(x.dtype)
        ctx = torch.einsum("bhst,btl->bshl", probs, c_kv)
        out = torch.einsum("bshl,lhd->bshd", ctx, w_uv)
    else:
        T = c_kv.shape[1]
        k_nope, v = (c_kv @ p["wkv_b"]).reshape(
            B, T, c.n_heads, c.qk_nope_dim + c.v_head_dim).split(
            [c.qk_nope_dim, c.v_head_dim], dim=-1)
        k = torch.cat([k_nope, k_rope.expand(B, T, c.n_heads,
                                             c.qk_rope_dim)], dim=-1)
        out = _sdpa(torch.cat([q_nope, q_rope], dim=-1), k, v, scale,
                    q_start, chunk=c.attn_chunk)
    return out.reshape(B, S, c.n_heads * c.v_head_dim) @ p["wo"]


def moe_capacity(cfg: LMConfig, n_tokens: int) -> int:
    """Slots per expert for a batch of ``n_tokens`` tokens: the reference's
    rule, rounded up to a multiple of 512 from 4,096 tokens on."""
    cap = int(np.ceil(n_tokens * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor))
    cap = max(8, min(cap, n_tokens))
    if n_tokens >= 4096:
        cap = int(np.ceil(cap / 512)) * 512
    return cap


def moe_route(p, cfg: LMConfig, xt):
    """Routing of (T, D) tokens: (gates (T, k) in the input dtype, expert
    ids (T, k), each (token, k) pair's expert and slot as flat (T k,)
    indices — (0, 0) where dropped — and the kept mask). Top-k takes ties
    in the lower expert index first, as `jax.lax.top_k` does; a stable sort
    of the flat expert ids ranks each pair within its expert in token
    order, and the pairs ranked past the capacity drop."""
    c = cfg
    T = xt.shape[0]
    logits = (xt @ p["router"]).float()                        # (T, E)
    probs, ranked = torch.sort(torch.softmax(logits, dim=-1), dim=-1,
                               descending=True, stable=True)
    gates, idx = probs[:, :c.top_k], ranked[:, :c.top_k]
    gates = (gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)) \
        .to(xt.dtype)
    eid = idx.reshape(T * c.top_k)
    order = torch.sort(eid, stable=True).indices
    sorted_eid = eid[order]
    starts = torch.searchsorted(
        sorted_eid, torch.arange(c.n_experts, device=xt.device))
    pos = torch.empty_like(eid)
    pos[order] = torch.arange(T * c.top_k, device=xt.device) \
        - starts[sorted_eid]
    keep = pos < moe_capacity(c, T)
    return (gates, idx, torch.where(keep, eid, 0), torch.where(keep, pos, 0),
            keep)


def moe_dispatch(cfg: LMConfig, xt, e_safe, p_safe, keep):
    """(T, D) tokens into the (E, capacity, D) expert buffer: each kept
    (token, k) pair copied into its own slot, zeros elsewhere. The dropped
    pairs are written to one spare row past the buffer, which nothing
    reads, so every slot is written at most once and the buffer equals the
    reference's (whose dropped pairs add zeros into slot (0, 0)) without
    an accumulating scatter."""
    E, D = cfg.n_experts, xt.shape[1]
    cap = moe_capacity(cfg, xt.shape[0])
    slot = torch.where(keep, e_safe * cap + p_safe, E * cap)
    tok = torch.arange(slot.shape[0], device=xt.device) // cfg.top_k
    return xt.new_zeros((E * cap + 1, D)).index_put((slot,), xt[tok])[:-1] \
        .view(E, cap, D)


def moe_experts(w, cfg: LMConfig, buf):
    """The experts' MLPs over every slot: (E, capacity, D) batched
    products with the (E, D, F) and (E, F, D) weights."""
    if cfg.mlp == "swiglu":
        h = F.silu(torch.bmm(buf, w["w_gate"])) * torch.bmm(buf, w["w_in"])
    else:
        h = _act(torch.bmm(buf, w["w_in"]), cfg.mlp)
    return torch.bmm(h, w["w_out"])


def _moe_mlp(p, cfg: LMConfig, x, drops: list | None = None):
    """Capacity-bounded top-k MoE with scatter dispatch (no (T, E, C)
    one-hot): the kept (token, k) pairs scattered into (E, capacity, D),
    the experts' MLPs as batched products, the pairs gathered back (a
    dropped one reads slot (0, 0) and is zeroed, as in the reference) and
    summed with their gates, the shared expert added. ``drops`` gets the
    count of dropped pairs (a 0-d tensor; no host sync)."""
    c = cfg
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    gates, _, e_safe, p_safe, keep = moe_route(p, c, xt)
    if drops is not None:
        drops.append((~keep).sum())
    out_e = moe_experts(p["experts"], c,
                        moe_dispatch(c, xt, e_safe, p_safe, keep))
    gath = out_e[e_safe, p_safe] * keep[:, None]               # (T k, D)
    comb = (gath.reshape(T, c.top_k, D) * gates[..., None]).sum(dim=1)
    if c.n_shared_experts:
        comb = comb + _mlp(p["shared"], xt, c.mlp)
    return comb.reshape(B, S, D)


def _layer_fwd(p, cfg: LMConfig, x, positions, q_start, moe: bool = False,
               cache=None, *, use_kernel: bool = True,
               drops: list | None = None):
    attn = _mla_attention if cfg.attn == "mla" else _gqa_attention
    h = attn(p["attn"], cfg, rmsnorm(x, p["ln1"], cfg.norm_eps), positions,
             q_start, cache, use_kernel=use_kernel)
    x = x + h
    z = rmsnorm(x, p["ln2"], cfg.norm_eps)
    return x + (_moe_mlp(p, cfg, z, drops) if moe
                else _mlp(p["mlp"], z, cfg.mlp))


def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
               device="cuda"):
    """Stacked per-layer cache, zeros, in the reference's layout:
    {"dense": stack or None, "moe": stack or None}, each stack a pair over
    its layers: (keys, values) of shape (layers, batch, max_len,
    n_kv_heads, d_head), or for MLA the latent (layers, batch, max_len,
    kv_lora_rank) and the decoupled key (layers, batch, max_len, 1,
    qk_rope_dim)."""
    dt = dtype or getattr(torch, cfg.dtype)
    dev = resolve_device(device)

    def mk(n):
        if n == 0:
            return None
        if cfg.attn == "mla":
            shapes = ((n, batch, max_len, cfg.kv_lora_rank),
                      (n, batch, max_len, 1, cfg.qk_rope_dim))
        else:
            shapes = ((n, batch, max_len, cfg.n_kv_heads, cfg.d_head),) * 2
        return tuple(torch.zeros(s, dtype=dt, device=dev) for s in shapes)

    n_dense, n_moe = _depths(cfg)
    return {"dense": mk(n_dense), "moe": mk(n_moe)}


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
    """An LM's parameters on one device and its serving entry points.

    ``params`` holds the reference's pytree: "embed" (V, D), "final_norm"
    (D,), "lm_head" (D, V) unless embeddings are tied; "dense_layers" and,
    for a MoE config, "moe_layers", with each leaf stacked over the stack's
    layers ("attn": wq, wk, wv, wo, or MLA's wq_a, q_norm, wq_b, wkv_a,
    kv_norm, wkv_b, wo; "ln1", "ln2"; a dense layer's "mlp": w_in, w_out
    and, for SwiGLU, w_gate; a MoE layer's "router", "experts" with each
    matrix stacked over (layers, E) and "shared"); and for an MTP config
    "mtp": "proj" (2 D, D) and "block", one dense layer. Build it with
    `Transformer.random` or `Transformer.from_jax`. ``dropped`` holds, after
    each call, the (token, k) pairs each MoE layer dropped (0-d tensors on
    the device).
    """

    def __init__(self, cfg: LMConfig, params: dict):
        self.cfg = cfg
        self.params = params
        n_dense, n_moe = _depths(cfg)
        self.stacks = [
            (name, moe, [_map(params[key], lambda t, i=i: t[i])
                         for i in range(n)])
            for name, key, moe, n in (("dense", "dense_layers", False,
                                       n_dense),
                                      ("moe", "moe_layers", True, n_moe))
            if n]
        self.dropped: list = []

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    @classmethod
    def random(cls, cfg: LMConfig, seed: int = 0, device="cuda",
               dtype=None) -> Transformer:
        """Weights drawn from a seeded torch.Generator on ``device``: each
        matrix normal x 1/sqrt(fan-in), the embedding normal x 0.02, the
        norms at one, as the reference's `_dense` draws them (the numbers
        differ from JAX's for the same seed). The fan-in is each matrix's
        input width (D for an expert's w_in, its d_ff for w_out); the
        reference's `init_params` reads it off the first axis of the
        stacked array, i.e. the layer count, which would make every layer's
        scale depend on how far the depth is cut. Matrices are drawn one at
        a time (one layer's, or one expert's) in float32 and cast, so no
        float32 copy of a whole stack is needed. A dense config's weights
        are drawn in the order they always were: its layers, the embedding,
        the head; the MoE layers and the MTP head follow."""
        dev = resolve_device(device)
        dt = dtype or getattr(torch, cfg.dtype)
        gen = torch.Generator(device=dev).manual_seed(seed)
        c, d = cfg, cfg.d_model
        n_dense, n_moe = _depths(cfg)

        def normal(*shape, scale, stack=()):
            out = torch.empty((*stack, *shape), dtype=dt, device=dev)
            for view in out.view(-1, *shape):
                view.copy_(torch.randn(shape, generator=gen, device=dev) * scale)
            return out

        def dense(fan_in, fan_out, stack):
            return normal(fan_in, fan_out, scale=1.0 / math.sqrt(fan_in),
                          stack=stack)

        def ones(*shape):
            return torch.ones(shape, dtype=dt, device=dev)

        def attn(stack):
            if c.attn != "mla":
                return {"wq": dense(d, c.n_heads * c.d_head, stack),
                        "wk": dense(d, c.n_kv_heads * c.d_head, stack),
                        "wv": dense(d, c.n_kv_heads * c.d_head, stack),
                        "wo": dense(c.n_heads * c.d_head, d, stack)}
            a = {}
            if c.q_lora_rank:
                a["wq_a"] = dense(d, c.q_lora_rank, stack)
                a["q_norm"] = ones(*stack, c.q_lora_rank)
            a["wq_b"] = dense(c.q_lora_rank or d,
                              c.n_heads * (c.qk_nope_dim + c.qk_rope_dim),
                              stack)
            a["wkv_a"] = dense(d, c.kv_lora_rank + c.qk_rope_dim, stack)
            a["kv_norm"] = ones(*stack, c.kv_lora_rank)
            a["wkv_b"] = dense(c.kv_lora_rank,
                               c.n_heads * (c.qk_nope_dim + c.v_head_dim),
                               stack)
            a["wo"] = dense(c.n_heads * c.v_head_dim, d, stack)
            return a

        def mlp(ff, stack):
            m = {"w_in": dense(d, ff, stack), "w_out": dense(ff, d, stack)}
            if c.mlp == "swiglu":
                m["w_gate"] = dense(d, ff, stack)
            return m

        def layer(stack, moe):
            lp = {"attn": attn(stack), "ln1": ones(*stack, d),
                  "ln2": ones(*stack, d)}
            if not moe:
                lp["mlp"] = mlp(c.d_ff, stack)
                return lp
            lp["router"] = dense(d, c.n_experts, stack)
            lp["experts"] = mlp(c.moe_d_ff, (*stack, c.n_experts))
            if c.n_shared_experts:
                lp["shared"] = mlp(c.shared_d_ff
                                   or c.moe_d_ff * c.n_shared_experts, stack)
            return lp

        params = {}
        if n_dense:
            params["dense_layers"] = layer((n_dense,), False)
        params["embed"] = normal(c.padded_vocab, d, scale=0.02)
        params["final_norm"] = ones(d)
        if not c.tie_embeddings:
            params["lm_head"] = dense(d, c.padded_vocab, ())
        if n_moe:
            params["moe_layers"] = layer((n_moe,), True)
        if c.mtp_depth:
            params["mtp"] = {"proj": dense(2 * d, d, ()),
                             "block": layer((), False)}
        return cls(cfg, params)

    @classmethod
    def from_jax(cls, cfg: LMConfig, params: dict,
                 device="cuda") -> Transformer:
        """Carry the reference's `init_params(cfg, key)` output (JAX or
        numpy arrays, same pytree) onto ``device``."""
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
        self.dropped = []
        for name, moe, layers in self.stacks:
            for i, lp in enumerate(layers):
                layer_cache = None if cache is None else (
                    cache[name][0][i], cache[name][1][i], cur)
                x = _layer_fwd(lp, self.cfg, x, positions, q_start, moe,
                               layer_cache, use_kernel=use_kernel,
                               drops=self.dropped)
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
    `_sdpa` attention, the dense layers then the MoE layers. ``remat``
    recomputes each layer in the backward."""
    S = tokens.shape[1]
    x = F.embedding(tokens, params["embed"])
    positions = torch.arange(S, device=tokens.device)[None]
    n_dense, n_moe = _depths(cfg)

    def layer(x, stacked, i, moe):
        lp = _map(stacked, lambda t: t[i])
        return _layer_fwd(lp, cfg, x, positions, 0, moe, use_kernel=False)

    for key, moe, n in (("dense_layers", False, n_dense),
                        ("moe_layers", True, n_moe)):
        for i in range(n):
            x = (checkpoint(layer, x, params[key], i, moe,
                            use_reentrant=False) if remat
                 else layer(x, params[key], i, moe))
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

    Returns (loss, metrics). MTP adds the DeepSeek-V3 next-next-token term:
    the tokens and the next ones re-embedded, projected to D, one dense
    block, the shared head against the labels rolled by one; loss + 0.3 x
    its cross-entropy ("mtp_ce")."""
    x = hidden_forward(params, cfg, tokens, remat=remat)
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    main = ce_from_hidden(x, head, labels, cfg)
    metrics = {"ce": main}
    loss = main
    if cfg.mtp_depth and "mtp" in params:
        embed = params["embed"]
        h = torch.cat([F.embedding(tokens, embed),
                       F.embedding(torch.roll(tokens, -1, dims=1), embed)],
                      dim=-1) @ params["mtp"]["proj"]
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
        h = _layer_fwd(params["mtp"]["block"], cfg, h, positions, 0,
                       use_kernel=False)
        mtp = ce_from_hidden(h, head, torch.roll(labels, -1, dims=1), cfg)
        loss = loss + 0.3 * mtp
        metrics["mtp_ce"] = mtp
    metrics["loss"] = loss
    return loss, metrics


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
