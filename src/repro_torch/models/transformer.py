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
batched expert products and gathered back.

On a mesh (`launch.mesh.DeviceMesh`, passed as ``mesh=``; the reference
switches its paths on with the module globals ``MOE_SHARD_MAP`` and
``DECODE_SHARD_MAP``) the reference's hand-written collectives are
`torch.distributed` calls: the expert-parallel MoE layer (`_moe_mlp_ep`:
EP, or expert-TP where the experts do not divide over "model"; one
(T_loc, D) all_reduce a layer, written-out backward), and the split-KV
decodes (`Transformer.decode_step(..., mesh=)`): GQA through the flash
kernel's split route with its log-sum-exp on each rank's slice of the
cache, then one max and one sum all_reduce; MLA's absorbed decode with
`wkv_b` gathered over "model", one max and two sum all_reduces.

Serving on a mesh rank's `lm_rules` blocks (`Transformer.on_blocks`;
the reference jits `prefill` and `decode_step` over the mesh with those
``in_shardings`` and ``ACT_SHARDING``) is tensor-parallel over "model":
each layer gathers its blocks over the data axes alone (`serve_layer`;
deepseek-v3's ``LM_SERVE_FSDP``), the q projections and ``w_in`` /
``w_gate`` are column blocks, ``wo`` and ``w_out`` row blocks followed by
one all_reduce each, the shared expert's partial joins the routed
experts' all_reduce, and the embedding and the head are
vocabulary-parallel. `Transformer.prefill(..., mesh=)` computes the
rank's heads and writes every KV head (or the MLA latent) of the rank's
own cache slots from its rows, so the cache comes out in the split-KV
decode's sequence-sharded layout with no key or value on the wire. A
leaf whose spec keeps it whole over "model" computes whole with no
collective, so whole leaves run the same path.

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
from repro_torch.kernels.flash_attention.ref import attention_lse_ref
from repro_torch.sharding.rules import (AllReduce, Blocks, Gather, P,
                                        Replicated, Shard, batch_axis,
                                        gather_for_compute, model_block_dim)


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


# ---------------------------------------------------------------------------
# tensor parallelism over "model": a mesh rank's `lm_rules` blocks
# ---------------------------------------------------------------------------

def _block(mesh, specs, name) -> bool:
    """Whether leaf ``name`` of a module's spec dict ``specs`` (None: whole
    leaves) is this rank's block over "model" (`model_block_dim`)."""
    return (mesh is not None and specs is not None
            and model_block_dim(specs[name], mesh) is not None)


def _head_cols(w, mesh, specs, name, n_heads: int):
    """(the columns of the head-major projection ``w`` this rank computes
    with, its first head, its last head + 1): its column block, or ``w``
    itself where it is whole. A block that would cut a head raises."""
    if not _block(mesh, specs, name):
        return w, 0, n_heads
    m = mesh.axes_size("model")
    if n_heads % m:
        raise ValueError(f"{n_heads} heads do not divide over {m} model "
                         f"ranks: a block of {name} would cut a head")
    n = n_heads // m
    j = mesh.axis_index("model")
    return w, j * n, (j + 1) * n


def _heads_of(w, mesh, specs, name, n_heads: int, h0: int, h1: int):
    """The columns of heads h0 .. h1 - 1 of the head-major ``w``: this
    rank's block, or cut from ``w`` where it is whole."""
    if _block(mesh, specs, name):
        return _head_cols(w, mesh, specs, name, n_heads)[0]
    per = w.shape[-1] // n_heads
    return w[..., h0 * per:h1 * per]


def _whole_cols(w, mesh, specs, name):
    """``w`` with every column: its blocks gathered over "model" where it
    holds a column block."""
    return mesh.all_gather(w, "model", dim=-1) \
        if _block(mesh, specs, name) else w


def _row_parallel(out, w, mesh, specs, name, col0: int = 0):
    """``out @ w`` over the rows of ``w`` this rank holds. Where ``w`` is
    a row block over "model", the product of ``out``'s matching columns
    (its first column is global column ``col0``) is a partial sum,
    all-reduced over "model"; else ``out`` holds every column."""
    if not _block(mesh, specs, name):
        return out @ w
    r = w.shape[0]
    start = mesh.axis_index("model") * r - col0
    return mesh.all_reduce(out[..., start:start + r] @ w, "model")


def _gather_cols(mesh, parts):
    """Each (..., n_i) tensor of ``parts`` with its columns gathered over
    "model" in rank order, in one all_gather of them packed side by
    side."""
    sizes = [t.shape[-1] for t in parts]
    g = mesh.all_gather(torch.cat(parts, dim=-1), "model", tiled=False)
    return [pc.movedim(0, -2).reshape(*t.shape[:-1], -1)
            for pc, t in zip(g.split(sizes, dim=-1), parts)]


def _project(x, p, names, mesh=None, specs=None) -> list:
    """``x @ p[name]`` for each of ``names``, every column: the products
    with a column block over "model" gathered in one all_gather."""
    out = [x @ p[n] for n in names]
    split = [i for i, n in enumerate(names) if _block(mesh, specs, n)]
    for i, t in zip(split, _gather_cols(mesh, [out[i] for i in split])
                    if split else ()):
        out[i] = t
    return out


def _kv_heads(h0: int, h1: int, group: int) -> tuple[int, int]:
    """(first KV head, last + 1) of q heads h0 .. h1 - 1 in groups of
    ``group``: one KV head shared by the rank's q heads, or whole groups
    (flash and `_sdpa` take equal groups; other cuts raise)."""
    kv0, kv1 = h0 // group, (h1 - 1) // group + 1
    if kv1 - kv0 > 1 and (h0 % group or (h1 - h0) % group):
        raise ValueError(f"q heads {h0} .. {h1 - 1} make no equal groups "
                         f"of their KV heads (groups of {group})")
    return kv0, kv1


def _local_rows(t_loc: int, cur: int, s: int, mesh, seq_axes):
    """(this rank's first slot, the first position it writes, the last +
    1) of ``s`` rows at positions cur .. cur + s - 1 into its ``t_loc``
    slots of a cache split along ``seq_axes``."""
    off = mesh.axis_index(seq_axes) * t_loc
    n = mesh.axes_size(seq_axes) * t_loc
    if not 0 <= cur <= n - s:
        raise ValueError(f"cache of {n} slots cannot take {s} rows at "
                         f"position {cur}")
    return off, max(cur, off), min(cur + s, off + t_loc)


def _gqa_attention(p, cfg: LMConfig, x, positions, q_start, cache=None, *,
                   use_kernel: bool = True, mesh=None, seq_axes=None,
                   specs=None):
    """Attention of one layer. ``cache`` is (ck, cv, cur): the layer's
    (B, T, Hkv, dh) cache tensors, into whose slots cur .. cur + S the new
    keys and values are written in place, and the first slot's index.
    On a ``mesh`` the cache holds this rank's slice of the sequence along
    ``seq_axes``, and the leaves may be its blocks over "model" (``specs``,
    the module's spec dict): a prefill computes its own heads
    (`_gqa_prefill_mesh`); a decode step gathers the new token's q, k and v
    over "model" (one all_gather of the blocks' columns), attends split-KV
    (`_decode_attn_split_kv`) and projects through its row block of
    ``wo``, one all_reduce. Leaves whole over "model" compute whole, with
    no collective."""
    B, S, D = x.shape
    c = cfg
    if mesh is not None and S > 1:
        return _gqa_prefill_mesh(p, c, x, positions, cache, mesh, seq_axes,
                                 specs, use_kernel=use_kernel)
    q, k, v = _project(x, p, ("wq", "wk", "wv"), mesh, specs)
    q = q.reshape(B, S, c.n_heads, c.d_head)
    k = k.reshape(B, S, c.n_kv_heads, c.d_head)
    v = v.reshape(B, S, c.n_kv_heads, c.d_head)
    cos, sin = rope_freqs(positions, c.d_head, c.rope_theta)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    if mesh is not None:
        ck, cv, cur = cache
        off = _write_local_slot((ck, cv), (k, v), cur, mesh, seq_axes)
        out = _decode_attn_split_kv(q, ck, cv, cur - off,
                                    1.0 / math.sqrt(c.d_head), mesh,
                                    seq_axes, use_kernel=use_kernel)
        return _row_parallel(out.reshape(B, S, c.n_heads * c.d_head),
                             p["wo"], mesh, specs, "wo")
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


def _gqa_prefill_mesh(p, cfg: LMConfig, x, positions, cache, mesh,
                      seq_axes, specs, *, use_kernel: bool):
    """One GQA layer of a prefill (from position 0) on a mesh rank, over
    its (B_loc, S, D) rows, which every rank of its model line holds.

    The rank computes the q heads of its ``wq`` column block and the KV
    heads they read, from ``wk`` / ``wv`` whole (their blocks gathered over
    "model": the KV heads need not line up with the ranks), attends over
    them (flash, or `_sdpa` without ``use_kernel``) and projects through
    its row block of ``wo``, one all_reduce. The cache the decode reads
    splits the slots, not the heads: the rank computes every KV head of
    its own slots from its rows of ``x``, so no key or value crosses the
    wire (the bytes moved are ``wk`` and ``wv``)."""
    c = cfg
    B, S, _ = x.shape
    dh, group = c.d_head, c.n_heads // c.n_kv_heads
    ck, cv, cur = cache
    if cur:
        raise ValueError(f"a prefill on a mesh starts at position 0, not "
                         f"{cur}")
    wq, h0, h1 = _head_cols(p["wq"], mesh, specs, "wq", c.n_heads)
    wk, wv = (_whole_cols(p[n], mesh, specs, n) for n in ("wk", "wv"))
    kv0, kv1 = _kv_heads(h0, h1, group)
    cos, sin = rope_freqs(positions, dh, c.rope_theta)
    cols = slice(kv0 * dh, kv1 * dh)
    q = apply_rope((x @ wq).reshape(B, S, h1 - h0, dh), cos, sin)
    k = apply_rope((x @ wk[:, cols]).reshape(B, S, kv1 - kv0, dh), cos, sin)
    v = (x @ wv[:, cols]).reshape(B, S, kv1 - kv0, dh)
    off, lo, hi = _local_rows(ck.shape[1], 0, S, mesh, seq_axes)
    if lo < hi:
        xs = x[:, lo:hi]
        ck[:, lo - off:hi - off] = apply_rope(
            (xs @ wk).reshape(B, hi - lo, c.n_kv_heads, dh),
            cos[:, lo:hi], sin[:, lo:hi])
        cv[:, lo - off:hi - off] = (xs @ wv).reshape(B, hi - lo,
                                                     c.n_kv_heads, dh)
    scale = 1.0 / math.sqrt(dh)
    if use_kernel:
        out = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                              v.transpose(1, 2), causal=True, scale=scale,
                              q_start=0).transpose(1, 2)
    else:
        out = _sdpa(q, k, v, scale, 0, chunk=c.attn_chunk)
    return _row_parallel(out.reshape(B, S, (h1 - h0) * dh), p["wo"], mesh,
                         specs, "wo", h0 * dh)


def _mla_attention(p, cfg: LMConfig, x, positions, q_start, cache=None, *,
                   use_kernel: bool = True, mesh=None, seq_axes=None,
                   specs=None):
    """DeepSeek MLA with the compressed cache: ``cache`` is (cc, cr, cur),
    the layer's (B, T, kv_lora) latent and (B, T, 1, rope) decoupled key,
    into whose slots cur .. cur + S the new entries are written in place.
    The attention reads the slots up to cur + S only: the reference's
    masks give the later ones probability zero. A decode step (S = 1 with a
    cache) attends in the latent space with `wkv_b` absorbed; otherwise the
    latent is expanded into per-head keys and values for `_sdpa`. MLA
    reaches no kernel (``use_kernel`` is accepted for the GQA signature).
    On a ``mesh`` the cache holds this rank's slice of the sequence along
    ``seq_axes``, and ``wq_b``, ``wkv_b`` and ``wo`` may be its blocks over
    "model" (``specs``): a prefill expands and attends over its own heads
    and writes the latent of its own slots, which every rank computes
    whole (``wkv_a`` is whole); a decode step gathers the new token's q
    over "model" and attends split-KV (`_mla_decode_split_kv`); both
    project through the rank's row block of ``wo``, one all_reduce."""
    c = cfg
    B, S, D = x.shape
    H = c.n_heads
    wq_b, h0, h1 = p["wq_b"], 0, H
    if mesh is not None and S > 1:      # a prefill: this rank's heads
        wq_b, h0, h1 = _head_cols(wq_b, mesh, specs, "wq_b", H)
    qin = rmsnorm(x @ p["wq_a"], p["q_norm"], c.norm_eps) \
        if c.q_lora_rank else x
    q = qin @ wq_b
    if S == 1 and _block(mesh, specs, "wq_b"):      # every head, to decode
        q, = _gather_cols(mesh, [q])
    q = q.reshape(B, S, h1 - h0, c.qk_nope_dim + c.qk_rope_dim)
    q_nope, q_rope = q.split([c.qk_nope_dim, c.qk_rope_dim], dim=-1)
    c_kv, k_rope = (x @ p["wkv_a"]).split([c.kv_lora_rank, c.qk_rope_dim],
                                          dim=-1)
    c_kv = rmsnorm(c_kv, p["kv_norm"], c.norm_eps)
    cos, sin = rope_freqs(positions, c.qk_rope_dim, c.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_rope = apply_rope(k_rope[:, :, None, :], cos, sin)   # (B, S, 1, rope)
    wkv_b = p["wkv_b"]
    if mesh is not None:
        cc, cr, cur = cache
        if S > 1 and cur:
            raise ValueError(f"a prefill on a mesh starts at position 0, "
                             f"not {cur}")
        off = _write_local_slot((cc, cr), (c_kv, k_rope), cur, mesh,
                                seq_axes)
        if S == 1:
            out = _mla_decode_split_kv(c, q_nope, q_rope, cc, cr, wkv_b,
                                       cur - off, mesh, seq_axes)
            return _row_parallel(out.reshape(B, S, H * c.v_head_dim),
                                 p["wo"], mesh, specs, "wo")
        wkv_b = _heads_of(wkv_b, mesh, specs, "wkv_b", H, h0, h1)
    elif cache is not None:
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
        w_uk, w_uv = wkv_b.reshape(
            c.kv_lora_rank, H, c.qk_nope_dim + c.v_head_dim).split(
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
        T, n = c_kv.shape[1], h1 - h0
        k_nope, v = (c_kv @ wkv_b).reshape(
            B, T, n, c.qk_nope_dim + c.v_head_dim).split(
            [c.qk_nope_dim, c.v_head_dim], dim=-1)
        k = torch.cat([k_nope, k_rope.expand(B, T, n, c.qk_rope_dim)],
                      dim=-1)
        out = _sdpa(torch.cat([q_nope, q_rope], dim=-1), k, v, scale,
                    q_start, chunk=c.attn_chunk)
    return _row_parallel(out.reshape(B, S, (h1 - h0) * c.v_head_dim),
                         p["wo"], mesh, specs, "wo", h0 * c.v_head_dim)


def decode_axes(mesh, batch: int):
    """(batch axes or None, sequence axes) of a decode step's cache on a
    mesh, as the reference shards it: batch over the data axes and
    sequence over "model" when ``batch`` > 1, else the sequence over
    (data axes..., "model")."""
    dp = batch_axis(mesh)
    dp_t = dp if isinstance(dp, tuple) else (dp,)
    if batch > 1:
        if batch % mesh.axes_size(dp_t):
            raise ValueError(f"a batch of {batch} does not divide over the "
                             f"data axes {dp_t} ({mesh.axes_size(dp_t)})")
        return dp_t, ("model",)
    return None, (*dp_t, "model")


def _write_local_slot(cache, new, cur: int, mesh, seq_axes) -> int:
    """Write the step's S entries (each (B, S, ...), positions cur ..
    cur + S - 1) into this rank's slices of the cache (each (B, T_loc,
    ...)) where they fall in them: the in-place counterpart of the
    reference's masked update over a sequence-sharded cache. Returns the
    slice's first global position."""
    off, lo, hi = _local_rows(cache[0].shape[1], cur, new[0].shape[1], mesh,
                              seq_axes)
    if lo < hi:
        for dst, src in zip(cache, new):
            dst[:, lo - off:hi - off] = src[:, lo - cur:hi - cur]
    return off


def _decode_attn_split_kv(q, ck, cv, lim: int, scale, mesh, seq_axes, *,
                          use_kernel: bool = True):
    """Flash-decoding across ``seq_axes``: q (B, 1, H, dh) over this
    rank's (B, T_loc, Hkv, dh) slice of the cache, whose keys up to local
    index ``lim`` (cur - the slice's offset) are visible. The rank's flash
    kernel (its plain version without ``use_kernel``) gives its normalised
    output and each row's log-sum-exp; a rank whose slice lies wholly past
    cur launches nothing and contributes lse -inf. The ranks combine with
    one max all_reduce of the lse and one sum all_reduce of the outputs
    weighted by exp(lse - max) packed beside their weights."""
    B, _, H, dh = q.shape
    if lim < 0:
        out = q.new_zeros((B, H, 1, dh))
        lse = torch.full((B, H, 1), float("-inf"), device=q.device)
    else:
        args = (q.transpose(1, 2), ck.transpose(1, 2), cv.transpose(1, 2))
        if use_kernel:
            out, lse = flash_attention(*args, causal=True, scale=scale,
                                       q_start=lim, return_lse=True)
        else:
            out, lse = attention_lse_ref(*args, causal=True, scale=scale,
                                         q_start=lim)
    m = mesh.all_reduce(lse, seq_axes, "max")
    w = torch.exp(lse - m)[..., None]
    tot = mesh.all_reduce(torch.cat([out.float() * w, w], dim=-1), seq_axes)
    return (tot[..., :dh] / tot[..., dh:]).to(q.dtype).transpose(1, 2)


def _mla_decode_split_kv(cfg: LMConfig, q_nope, q_rope, cc, cr, wkv_b,
                         lim: int, mesh, seq_axes):
    """Flash-decoding for the absorbed MLA decode (the reference's
    `_mla_decode_split_kv`): this rank's (B, T_loc, kv_lora) latent and
    (B, T_loc, 1, rope) key slices, visible up to local index ``lim``.
    A ``wkv_b`` held as this rank's block over "model" (its `lm_rules`
    storage) is gathered first, once per layer; then one max and two sum
    all_reduces of (B, H, .) partials over ``seq_axes``."""
    c = cfg
    H = c.n_heads
    if wkv_b.shape[1] != H * (c.qk_nope_dim + c.v_head_dim):
        wkv_b = mesh.all_gather(wkv_b, "model", dim=1)
    w_uk, w_uv = wkv_b.reshape(
        c.kv_lora_rank, H, c.qk_nope_dim + c.v_head_dim).split(
        [c.qk_nope_dim, c.v_head_dim], dim=-1)
    scale = 1.0 / math.sqrt(c.qk_nope_dim + c.qk_rope_dim)
    q_lat = torch.einsum("bshd,lhd->bshl", q_nope, w_uk)     # (B,1,H,latent)
    s = (torch.einsum("bshl,btl->bhst", q_lat, cc)
         + torch.einsum("bshr,btur->bhst", q_rope, cr)).float() * scale
    cols = torch.arange(cc.shape[1], device=cc.device)
    s = torch.where(cols <= lim, s, -1e30)                   # (B,H,1,T_loc)
    m = mesh.all_reduce(s.amax(dim=-1), seq_axes, "max")     # (B,H,1)
    pr = torch.exp(s - m[..., None])
    l_g = mesh.all_reduce(pr.sum(dim=-1), seq_axes)          # (B,H,1)
    ctx = mesh.all_reduce(torch.einsum("bhst,btl->bshl", pr.to(cc.dtype), cc),
                          seq_axes)                          # (B,1,H,latent)
    out = torch.einsum("bshl,lhd->bshd", ctx, w_uv)
    return out / l_g.transpose(1, 2)[..., None].clamp(min=1e-30).to(out.dtype)


def moe_capacity(cfg: LMConfig, n_tokens: int) -> int:
    """Slots per expert for a batch of ``n_tokens`` tokens: the reference's
    rule, rounded up to a multiple of 512 from 4,096 tokens on."""
    cap = int(np.ceil(n_tokens * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor))
    cap = max(8, min(cap, n_tokens))
    if n_tokens >= 4096:
        cap = int(np.ceil(cap / 512)) * 512
    return cap


def moe_gates(p, cfg: LMConfig, xt):
    """(gates (T, k) in the input dtype, expert ids (T, k)) of (T, D)
    tokens: the float32 router softmax, its top k with ties in the lower
    expert index first, as `jax.lax.top_k` takes them, renormalised."""
    logits = (xt @ p["router"]).float()                        # (T, E)
    probs, ranked = torch.sort(torch.softmax(logits, dim=-1), dim=-1,
                               descending=True, stable=True)
    gates, idx = probs[:, :cfg.top_k], ranked[:, :cfg.top_k]
    gates = (gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)) \
        .to(xt.dtype)
    return gates, idx


def moe_slots(key, n_experts: int):
    """Each pair's rank within its expert: a stable sort of the flat
    expert ids ``key`` (pairs keyed ``n_experts`` or past rank last), in
    token order within an expert, as the reference's argsort and
    searchsorted rank them."""
    order = torch.sort(key, stable=True).indices
    sorted_key = key[order]
    starts = torch.searchsorted(
        sorted_key, torch.arange(n_experts, device=key.device))
    pos = torch.empty_like(key)
    pos[order] = torch.arange(key.shape[0], device=key.device) \
        - starts[sorted_key.clamp(max=n_experts - 1)]
    return pos


def moe_route(p, cfg: LMConfig, xt):
    """Routing of (T, D) tokens: (gates (T, k) in the input dtype, expert
    ids (T, k), each (token, k) pair's expert and slot as flat (T k,)
    indices — (0, 0) where dropped — and the kept mask). A stable sort of
    the flat expert ids ranks each pair within its expert in token order,
    and the pairs ranked past the capacity drop."""
    gates, idx = moe_gates(p, cfg, xt)
    eid = idx.reshape(-1)
    pos = moe_slots(eid, cfg.n_experts)
    keep = pos < moe_capacity(cfg, xt.shape[0])
    return (gates, idx, torch.where(keep, eid, 0), torch.where(keep, pos, 0),
            keep)


def moe_dispatch(cfg: LMConfig, xt, e_safe, p_safe, keep, *,
                 n_experts: int | None = None, cap: int | None = None):
    """(T, D) tokens into the (E, capacity, D) expert buffer: each kept
    (token, k) pair copied into its own slot, zeros elsewhere. The dropped
    pairs are written to one spare row past the buffer, which nothing
    reads, so every slot is written at most once and the buffer equals the
    reference's (whose dropped pairs add zeros into slot (0, 0)) without
    an accumulating scatter. ``n_experts`` and ``cap`` default to the
    one-device layer's (a mesh rank's are its own)."""
    E = cfg.n_experts if n_experts is None else n_experts
    D = xt.shape[1]
    cap = moe_capacity(cfg, xt.shape[0]) if cap is None else cap
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


def _moe_mlp(p, cfg: LMConfig, x, drops: list | None = None, *,
             mesh=None, split: bool = True, specs=None):
    """Capacity-bounded top-k MoE with scatter dispatch (no (T, E, C)
    one-hot): the kept (token, k) pairs scattered into (E, capacity, D),
    the experts' MLPs as batched products, the pairs gathered back (a
    dropped one reads slot (0, 0) and is zeroed, as in the reference) and
    summed with their gates, the shared expert added. ``drops`` gets the
    count of dropped pairs (a 0-d tensor; no host sync).

    On a ``mesh`` (a `DeviceMesh` rank) ``x`` is this rank's block of the
    tokens along the data axes, the same on every rank of its model
    column, and the routed experts run expert-parallel (`_moe_mlp_ep`).
    ``split=False`` says ``x`` holds every token on every rank: the
    reference's route where the tokens do not divide over the data axes
    (a decode step of one sequence), the one-device layer over the whole
    expert weights. ``p["experts"]`` holds each rank's block under
    `lm_rules` or the whole weights; the router is whole. The shared
    expert is whole, or (``specs``, the layer's spec tree) this rank's
    column and row blocks over "model", whose partial output joins the
    routed experts' before their one all_reduce."""
    c = cfg
    B, S, D = x.shape
    T = B * S
    xt = x.reshape(T, D)
    shared_tp = bool(c.n_shared_experts) and mesh is not None and split \
        and _block(mesh, None if specs is None else specs["shared"], "w_out")
    if mesh is not None and split:
        gates, idx = moe_gates(p, c, xt)
        comb = _moe_mlp_ep(p["experts"], c, xt, gates, idx, mesh, drops,
                           extra=_mlp(p["shared"], xt, c.mlp) if shared_tp
                           else None)
    else:
        w = p["experts"] if mesh is None else _expert_weights(
            p["experts"], c, mesh, "whole")
        gates, _, e_safe, p_safe, keep = moe_route(p, c, xt)
        if drops is not None:
            drops.append((~keep).sum())
        out_e = moe_experts(w, c, moe_dispatch(c, xt, e_safe, p_safe, keep))
        gath = out_e[e_safe, p_safe] * keep[:, None]           # (T k, D)
        comb = (gath.reshape(T, c.top_k, D) * gates[..., None]).sum(dim=1)
    if c.n_shared_experts and not shared_tp:
        comb = comb + _mlp(p["shared"], xt, c.mlp)
    return comb.reshape(B, S, D)


def _model_axis(mesh) -> tuple[str, ...]:
    """The mesh's "model" axis, or none (a column of one)."""
    return ("model",) if "model" in mesh.axis_names else ()


def moe_mesh_mode(cfg: LMConfig, mesh) -> str:
    """"ep" where the experts divide over the model axis (each column
    keeps E / model of them), else "tp" (expert-TP: every column holds
    every expert's d_ff / model slice)."""
    return "ep" if cfg.n_experts % mesh.axes_size(_model_axis(mesh)) == 0 \
        else "tp"


def _expert_weights(w, cfg: LMConfig, mesh, route: str) -> dict:
    """The expert weights as ``route`` computes with them on this rank:
    "ep" (E / model experts whole), "tp" (every expert's d_ff / model
    slice) or "whole". Each dim held as a block (its `lm_rules` storage:
    E or d_ff over "model", the other matrix dim over the data axes) or
    whole is re-gathered (`Gather`, the gradient reduce-scattered) or cut
    (`Shard`, the gradient gathered) to what the route needs."""
    E, D, Fd = cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    mdl, dp = _model_axis(mesh), batch_axis(mesh)
    ep = moe_mesh_mode(cfg, mesh) == "ep"
    # (whole size, storage axes) of each dim
    dims = {"w_in": ((E, mdl if ep else ()), (D, dp), (Fd, () if ep else mdl)),
            "w_out": ((E, mdl if ep else ()), (Fd, dp if ep else mdl),
                      (D, () if ep else dp))}
    dims["w_gate"] = dims["w_in"]
    out = {}
    for name, t in w.items():
        for dim, (full, axes) in enumerate(dims[name]):
            n = mesh.axes_size(axes) if axes else 1
            want_block = route != "whole" and axes == mdl and bool(mdl)
            if t.shape[dim] == full and n > 1 and want_block:
                if full % n:
                    raise ValueError(f"{cfg.name}: experts' {name} dim {dim}"
                                     f" ({full}) does not divide over {axes}")
                t = Shard.apply(t, mesh, axes, dim)
            elif t.shape[dim] != full:
                if t.shape[dim] * n != full:
                    raise ValueError(
                        f"{cfg.name}: experts' {name} of shape "
                        f"{tuple(t.shape)} is neither whole nor a block over "
                        f"{axes} in dim {dim}")
                if not want_block:
                    t = Gather.apply(t, mesh, axes, dim)
        out[name] = t
    return out


def moe_mesh_capacity(cfg: LMConfig, n_local: int) -> int:
    """Slots per expert on a mesh rank with ``n_local`` tokens: the
    reference's local rule, max(8, ceil(T_loc k / E cf)) rounded up to a
    multiple of 8."""
    cap = max(8, int(np.ceil(n_local * cfg.top_k / cfg.n_experts
                             * cfg.capacity_factor)))
    return int(np.ceil(cap / 8)) * 8


def _moe_mlp_ep(w, cfg: LMConfig, xt, gates, idx, mesh, drops=None,
                extra=None):
    """The routed experts on a mesh rank (the reference's
    `_moe_mlp_ep_shard_map`). EP (E % model == 0): this model column
    keeps E / model experts and routes its local tokens' pairs that go to
    them; expert-TP: it holds every expert's d_ff / model slice and
    computes partial outputs for every pair. The pairs are combined to
    tokens on each column, then summed in one (T_loc, D) all_reduce over
    "model" (`AllReduce`), with ``extra`` (another partial (T_loc, D)
    output, the tensor-parallel shared expert's) added first; the tokens
    and gates, the same on every column, sum their gradients over "model"
    (`Replicated`)."""
    c = cfg
    mdl = _model_axis(mesh)
    ep = moe_mesh_mode(c, mesh) == "ep"
    n_cols = mesh.axes_size(mdl)
    e_loc = c.n_experts // n_cols if ep else c.n_experts
    t_loc, D = xt.shape
    cap = moe_mesh_capacity(c, t_loc)
    wl = _expert_weights(w, c, mesh, "ep" if ep else "tp")
    x_in = Replicated.apply(xt, mesh, mdl)
    g_in = Replicated.apply(gates, mesh, mdl)
    eid = idx.reshape(-1)
    if ep:
        local_e = eid - mesh.axis_index(mdl) * e_loc
        mine = (local_e >= 0) & (local_e < e_loc)
    else:
        local_e = eid
        mine = torch.ones_like(eid, dtype=torch.bool)
    pos = moe_slots(torch.where(mine, local_e, e_loc), e_loc)
    keep = mine & (pos < cap)
    if drops is not None:
        drops.append((mine & ~keep).sum())
    e_safe, p_safe = torch.where(keep, local_e, 0), torch.where(keep, pos, 0)
    buf = moe_dispatch(c, x_in, e_safe, p_safe, keep, n_experts=e_loc,
                       cap=cap)
    out_e = moe_experts(wl, c, buf)                 # partial iff expert-TP
    gath = out_e[e_safe, p_safe] * keep[:, None]
    comb = (gath.reshape(t_loc, c.top_k, D) * g_in[..., None]).sum(dim=1)
    if extra is not None:
        comb = comb + extra
    return AllReduce.apply(comb, mesh, mdl)


def _layer_fwd(p, cfg: LMConfig, x, positions, q_start, moe: bool = False,
               cache=None, *, use_kernel: bool = True,
               drops: list | None = None, mesh=None, seq_axes=None,
               split: bool = True, specs=None):
    """One layer. On a ``mesh``: a cache holds this rank's slices along
    ``seq_axes`` (a prefill or a decode step), and the MoE layer runs
    expert-parallel over this rank's tokens (``split``) or the one-device
    route over every token. With ``specs`` (the layer's spec tree) the
    leaves are this rank's blocks over "model" (gathered over the data
    axes where stored there): the layer runs tensor-parallel, the MLP
    with its column blocks of ``w_in`` / ``w_gate`` and its row block of
    ``w_out``, one all_reduce."""
    sp = (lambda k: None) if specs is None else specs.get
    attn = _mla_attention if cfg.attn == "mla" else _gqa_attention
    h = attn(p["attn"], cfg, rmsnorm(x, p["ln1"], cfg.norm_eps), positions,
             q_start, cache, use_kernel=use_kernel,
             mesh=mesh if seq_axes is not None else None, seq_axes=seq_axes,
             specs=sp("attn"))
    x = x + h
    z = rmsnorm(x, p["ln2"], cfg.norm_eps)
    if moe:
        return x + _moe_mlp(p, cfg, z, drops, mesh=mesh, split=split,
                            specs=specs)
    y = _mlp(p["mlp"], z, cfg.mlp)
    if _block(mesh, sp("mlp"), "w_out"):
        y = mesh.all_reduce(y, "model")
    return x + y


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
        the head; the MoE layers and the MTP head follow. On
        ``device="meta"`` it allocates nothing and draws nothing: the
        parameters' shapes and dtypes, for the dry run."""
        dev = resolve_device(device)
        dt = dtype or getattr(torch, cfg.dtype)
        meta = dev.type == "meta"
        gen = None if meta else torch.Generator(device=dev).manual_seed(seed)
        c, d = cfg, cfg.d_model
        n_dense, n_moe = _depths(cfg)

        def normal(*shape, scale, stack=()):
            out = torch.empty((*stack, *shape), dtype=dt, device=dev)
            if meta:            # shapes and dtypes only: nothing to draw
                return out
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

    def on_blocks(self, blocks: Blocks) -> Transformer:
        """The model over a mesh rank's `Blocks` (no whole leaf of its
        own): `loss_fn` on its ``params`` gathers layer by layer;
        `prefill` and `decode_step` on ``blocks.mesh`` serve
        tensor-parallel."""
        return Transformer(self.cfg, blocks)

    def param_tree(self) -> dict:
        """The reference's `init_params` pytree: ``params`` itself."""
        return self.params

    def init_cache(self, batch: int, max_len: int, *, mesh=None):
        """A zero cache in the parameters' dtype on their device; on a
        ``mesh``, this rank's block of it for a decode step of ``batch``
        sequences (`cache_specs`)."""
        if mesh is None:
            return init_cache(self.cfg, batch, max_len,
                              self.params["embed"].dtype, self.device)
        b_ax, t_ax = decode_axes(mesh, batch)
        n_b = mesh.axes_size(b_ax) if b_ax else 1
        n_t = mesh.axes_size(t_ax)
        if max_len % n_t:
            raise ValueError(f"{max_len} cache slots do not divide over "
                             f"{t_ax} ({n_t} ranks)")
        return init_cache(self.cfg, batch // n_b, max_len // n_t,
                          self.params["embed"].dtype, self.device)

    def cache_specs(self, batch: int, mesh) -> dict:
        """The `P` of each cache tensor of a decode step of ``batch``
        sequences on ``mesh``: (layers, batch, slots, ...) with the batch
        over the data axes and the slots over "model" (``batch`` > 1), or
        the slots over (data axes..., "model")."""
        b_ax, t_ax = decode_axes(mesh, batch)
        b_ax = None if b_ax is None else (b_ax[0] if len(b_ax) == 1
                                          else b_ax)
        t_ax = t_ax[0] if len(t_ax) == 1 else t_ax
        shapes = init_cache(self.cfg, 1, 1, device="meta")
        return {k: None if v is None else tuple(
            P(None, b_ax, t_ax, *([None] * (t.dim() - 3))) for t in v)
            for k, v in shapes.items()}

    def _leaf(self, name: str):
        """A leaf outside the layers as a serving pass computes with it: a
        mesh rank's block gathered over the data axes alone, its block over
        "model" kept; else the leaf itself."""
        p = self.params
        if isinstance(p, Blocks):
            return gather_for_compute(p[name], p.specs[name], p.mesh,
                                      data_only=True)
        return p[name]

    def _embed(self, tokens):
        """The tokens' embeddings; vocabulary-parallel where ``embed`` is a
        row block over "model": ids outside the rank's rows read zeros,
        then one all_reduce over "model"."""
        p = self.params
        e = self._leaf("embed")
        if not (isinstance(p, Blocks) and _block(p.mesh, p.specs, "embed")):
            return e[tokens]
        mesh = p.mesh
        n = e.shape[0]
        local = tokens - mesh.axis_index("model") * n
        inside = (local >= 0) & (local < n)
        x = torch.where(inside[..., None], e[local.clamp(0, n - 1)], 0)
        return mesh.all_reduce(x, "model")

    def _run(self, tokens, positions, q_start, cache=None, cur=0, *,
             use_kernel, mesh=None, seq_axes=None, split=True,
             last: bool = False):
        """The layers over the tokens' embeddings, the final norm and the
        head (on the last position alone with ``last``). Over a mesh
        rank's `Blocks` the layers run tensor-parallel (`serve_layer`) and
        a head split over "model" gives this rank's vocabulary block."""
        p = self.params
        specs = p.specs if isinstance(p, Blocks) else None
        x = self._embed(tokens)
        self.dropped = []
        for name, moe, layers in self.stacks:
            lspecs = None if specs is None else layer_specs(
                specs, f"{name}_layers")
            for i, lp in enumerate(layers):
                layer_cache = None if cache is None else (
                    cache[name][0][i], cache[name][1][i], cur)
                x = serve_layer(lp, self.cfg, x, positions, q_start, moe,
                                layer_cache, use_kernel=use_kernel,
                                drops=self.dropped, mesh=mesh,
                                seq_axes=seq_axes, split=split,
                                specs=lspecs)
        if last:
            x = x[:, -1:]
        x = rmsnorm(x, self._leaf("final_norm"), self.cfg.norm_eps)
        head = self._leaf("embed").T if self.cfg.tie_embeddings \
            else self._leaf("lm_head")
        return x @ head

    def forward(self, tokens, *, use_kernel: bool = True):
        """tokens (B, S) -> logits (B, S, padded_vocab)."""
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
        return self._run(tokens, positions, 0, use_kernel=use_kernel)

    def _rank_tokens(self, tokens, mesh, batch: int | None):
        """(this rank's tokens, the whole batch, the cache's batch axes or
        None, its sequence axes) of a pass on ``mesh`` over a batch of
        ``batch`` sequences, of which ``tokens`` is this rank's block;
        with no ``batch``, ``tokens`` is the whole batch and the rank
        takes its rows."""
        whole = batch is None
        batch = tokens.shape[0] if whole else batch
        b_ax, t_ax = decode_axes(mesh, batch)
        n_b = mesh.axes_size(b_ax) if b_ax is not None else 1
        if whole and n_b > 1:
            n = batch // n_b
            tokens = tokens[mesh.axis_index(b_ax) * n:][:n]
        elif not whole and tokens.shape[0] * n_b != batch:
            raise ValueError(f"a block of {tokens.shape[0]} sequences is not "
                             f"a rank's share of {batch} over {b_ax}")
        return tokens, batch, b_ax, t_ax

    def prefill(self, tokens, max_len: int | None = None, *,
                use_kernel: bool = True, mesh=None,
                batch: int | None = None):
        """Prefill pass: (logits (B, S, V), a fresh cache of ``max_len``
        slots (default S) holding the prompt's keys and values in slots
        0 .. S - 1).

        On a ``mesh`` (a `DeviceMesh` rank) ``tokens`` is this rank's
        block of a batch of ``batch`` sequences (its rows over the data
        axes; a batch of one whole), or the whole batch when ``batch`` is
        None. The layers run tensor-parallel over a model on a rank's
        `Blocks` (`on_blocks`), and whole over whole leaves. It returns
        the last position's logits, (B_loc, V) or, over a head split over
        "model", this rank's (B_loc, V / model) block (whole tokens: the
        rows gathered over the data axes), and this rank's block of a
        fresh cache in the layout `cache_specs` gives a decode step of
        ``batch`` sequences, which `decode_step(..., mesh=)` reads on."""
        B, S = tokens.shape
        if mesh is None:
            cache = self.init_cache(B, max_len or S)
            positions = torch.arange(S, device=tokens.device)[None]
            return self._run(tokens, positions, 0, cache, 0,
                             use_kernel=use_kernel), cache
        whole = batch is None
        tokens, batch, b_ax, t_ax = self._rank_tokens(tokens, mesh, batch)
        cache = self.init_cache(batch, max_len or S, mesh=mesh)
        positions = torch.arange(S, device=tokens.device)[None]
        logits = self._run(tokens, positions, 0, cache, 0,
                           use_kernel=use_kernel, mesh=mesh, seq_axes=t_ax,
                           split=self._moe_split(b_ax), last=True)[:, 0]
        if whole and b_ax is not None:
            logits = mesh.all_gather(logits, b_ax)
        return logits, cache

    def _moe_split(self, b_ax) -> bool:
        """Whether the MoE layers on a mesh run expert-parallel: over a
        rank's blocks always (every rank of a batch of one computes the
        same tokens), over whole leaves where the batch splits."""
        return isinstance(self.params, Blocks) or b_ax is not None

    def decode_step(self, cache, tokens, cur_len: int, *,
                    use_kernel: bool = True, mesh=None,
                    batch: int | None = None):
        """One decode step. tokens (B, 1) at position ``cur_len``; cache from
        `init_cache` or `prefill`, written in place at slot ``cur_len``.
        Returns (logits (B, 1, V), cache) — the same cache object.

        On a ``mesh`` (a `DeviceMesh` rank with a "model" axis) the rank
        holds its block of the cache (`init_cache(..., mesh=)`,
        `cache_specs`, or a mesh `prefill`'s): with B > 1 the batch is
        split over the data axes and the slots over "model", with B = 1
        every rank runs the sequence and the slots split over (data,
        model); it attends split-KV and the slot is written on the rank
        that owns ``cur_len``. ``tokens`` is this rank's block of a batch
        of ``batch`` sequences and the logits come back as its block,
        (B_loc, 1, V / model) over a head split over "model"; with no
        ``batch`` every rank gets every token and the logits are gathered
        over the data axes. Over a rank's `Blocks` the layers run
        tensor-parallel; over whole leaves (``wkv_b`` may be its block
        over "model") they compute whole."""
        cur_len = int(cur_len)
        if mesh is not None:
            return self._decode_mesh(cache, tokens, cur_len, mesh,
                                     use_kernel=use_kernel,
                                     batch=batch), cache
        positions = torch.full((tokens.shape[0], 1), cur_len,
                               dtype=torch.int32, device=tokens.device)
        return self._run(tokens, positions, cur_len, cache, cur_len,
                         use_kernel=use_kernel), cache

    def _decode_mesh(self, cache, tokens, cur_len: int, mesh, *,
                     use_kernel: bool, batch: int | None):
        whole = batch is None
        tokens, _, b_ax, t_ax = self._rank_tokens(tokens, mesh, batch)
        positions = torch.full((tokens.shape[0], 1), cur_len,
                               dtype=torch.int32, device=tokens.device)
        logits = self._run(tokens, positions, cur_len, cache, cur_len,
                           use_kernel=use_kernel, mesh=mesh, seq_axes=t_ax,
                           split=self._moe_split(b_ax))
        return mesh.all_gather(logits, b_ax) if whole and b_ax is not None \
            else logits


def serve_layer(lp, cfg: LMConfig, x, positions, q_start, moe: bool,
                cache=None, *, mesh=None, specs=None, **kw):
    """One layer of a serving pass. With ``specs`` (the layer's spec tree)
    ``lp`` holds a mesh rank's blocks: gathered here over the data axes
    alone, where `lm_rules(fsdp=True)` stored a dim there, and freed when
    the layer returns; the blocks over "model" stay and the layer runs
    tensor-parallel (`_layer_fwd`)."""
    if specs is not None:
        lp = _gather_tree(lp, specs, mesh, data_only=True)
    return _layer_fwd(lp, cfg, x, positions, q_start, moe, cache, mesh=mesh,
                      specs=specs, **kw)


# ---------------------------------------------------------------------------
# training: the reference's loss on its plain path
# ---------------------------------------------------------------------------

def _whole(params, *path):
    """The leaf at ``path`` as the model computes with it: gathered where
    ``params`` is a mesh rank's `Blocks`, else the leaf itself."""
    if isinstance(params, Blocks):
        return params.gather(*path)
    for k in path:
        params = params[k]
    return params


def _gather_tree(tree, specs, mesh, *, data_only: bool):
    if isinstance(tree, dict):
        return {k: _gather_tree(v, specs[k], mesh, data_only=data_only)
                for k, v in tree.items()}
    return gather_for_compute(tree, specs, mesh, data_only=data_only)


def train_layer(x, lp, cfg: LMConfig, positions, moe: bool, mesh=None,
                specs=None, gmesh=None):
    """One layer of the training forward (`_sdpa` attention). With
    ``specs``, ``lp`` holds the layer's blocks on ``gmesh``, gathered here
    first: inside the function that ``remat`` checkpoints, so the whole
    layer is freed after the forward, gathered again in the recompute, and
    its gradients reduce-scattered as the backward leaves it. The routed
    experts of an expert-parallel layer (``moe`` on a ``mesh``) gather
    their data dims only and keep the model-axis blocks they compute on
    (`_expert_weights`)."""
    if specs is not None:
        ep = moe and mesh is not None
        lp = {k: _gather_tree(v, specs[k], gmesh,
                              data_only=ep and k == "experts")
              for k, v in lp.items()}
    return _layer_fwd(lp, cfg, x, positions, 0, moe, use_kernel=False,
                      mesh=mesh)


def layer_specs(specs, key: str):
    """One layer's spec tree of the stack ``key``: each stacked leaf's spec
    less its layer dim."""
    return _map(specs[key], lambda s: P(*s[1:]))


def hidden_forward(params, cfg: LMConfig, tokens, *, remat: bool = False,
                   mesh=None):
    """tokens (B, S) -> final hidden states (B, S, D) (pre-head), through
    `_sdpa` attention, the dense layers then the MoE layers. ``remat``
    recomputes each layer in the backward. On a ``mesh`` the tokens are
    this rank's block along the data axes and the MoE layers run
    expert-parallel (`_moe_mlp`). ``params`` may be a mesh rank's `Blocks`:
    the embedding and the final norm are then gathered where they are used
    and each layer's blocks inside its layer (`train_layer`). Each stack is
    split into its layers once, so the backward stacks the layers'
    gradients once."""
    S = tokens.shape[1]
    x = F.embedding(tokens, _whole(params, "embed"))
    positions = torch.arange(S, device=tokens.device)[None]
    n_dense, n_moe = _depths(cfg)
    blocks = isinstance(params, Blocks)
    for key, moe, n in (("dense_layers", False, n_dense),
                        ("moe_layers", True, n_moe)):
        if not n:
            continue
        split = _map(params[key], lambda t: t.unbind(0))
        kw = dict(specs=layer_specs(params.specs, key),
                  gmesh=params.mesh) if blocks else {}
        for i in range(n):
            lp = _map(split, lambda u, i=i: u[i])
            x = (checkpoint(train_layer, x, lp, cfg, positions, moe, mesh,
                            use_reentrant=False, **kw) if remat
                 else train_layer(x, lp, cfg, positions, moe, mesh, **kw))
    return rmsnorm(x, _whole(params, "final_norm"), cfg.norm_eps)


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


def loss_fn(params, cfg: LMConfig, tokens, labels, *, remat: bool = False,
            mesh=None):
    """Causal LM loss; labels == -100 masked; pad-vocab ids masked out.

    Returns (loss, metrics). MTP adds the DeepSeek-V3 next-next-token term:
    the tokens and the next ones re-embedded, projected to D, one dense
    block, the shared head against the labels rolled by one; loss + 0.3 x
    its cross-entropy ("mtp_ce"). On a ``mesh`` (`hidden_forward`) the loss
    is this rank's block's. With `Blocks` for ``params`` the head, the
    embedding, the final norm and the MTP head are gathered where they are
    used (the head once, outside the cross-entropy's chunks) and the
    layers one at a time (`hidden_forward`)."""
    x = hidden_forward(params, cfg, tokens, remat=remat, mesh=mesh)
    head = _whole(params, "embed").T if cfg.tie_embeddings \
        else _whole(params, "lm_head")
    main = ce_from_hidden(x, head, labels, cfg)
    metrics = {"ce": main}
    loss = main
    if cfg.mtp_depth and "mtp" in params:
        embed = head.T if cfg.tie_embeddings else _whole(params, "embed")
        h = torch.cat([F.embedding(tokens, embed),
                       F.embedding(torch.roll(tokens, -1, dims=1), embed)],
                      dim=-1) @ _whole(params, "mtp", "proj")
        positions = torch.arange(tokens.shape[1], device=tokens.device)[None]
        kw = dict(specs=params.specs["mtp"]["block"], gmesh=params.mesh) \
            if isinstance(params, Blocks) else {}
        h = train_layer(h, params["mtp"]["block"], cfg, positions, False,
                        **kw)
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
