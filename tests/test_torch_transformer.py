"""Dense-transformer serving in the PyTorch port against the JAX package:
the flash-attention op (its plain version on the CPU) against the Pallas
kernel in interpret mode and against `attention_ref` at explicit diagonal
offsets, `_sdpa` with and without chunks, the copied configs and token
stream, and `Transformer.from_jax` serving `forward`, `prefill` and
`decode_step` for the three dense smoke configs in float32 (and one bf16
case)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so the test workers running beside
# this one keep their cores
torch.set_num_threads(1)

from repro.configs import granite_3_8b as j_granite_3_8b  # noqa: E402
from repro.configs import granite_20b as j_granite_20b  # noqa: E402
from repro.configs import nemotron_4_15b as j_nemotron  # noqa: E402
from repro.configs import get_arch  # noqa: E402
from repro.data.tokens import token_batches as j_token_batches  # noqa: E402
from repro.kernels.flash_attention.ops import \
    flash_attention as j_flash_attention  # noqa: E402
from repro.kernels.flash_attention.ops import \
    flash_attention_reference  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402

from repro_torch.configs import granite_3_8b, granite_20b  # noqa: E402
from repro_torch.configs import nemotron_4_15b  # noqa: E402
from repro_torch.data.tokens import token_batches  # noqa: E402
from repro_torch.kernels.flash_attention import \
    kernel as fa_kernel  # noqa: E402
from repro_torch.kernels.flash_attention.ops import \
    flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import \
    attention_split_ref  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.runtime.trainer import Trainer  # noqa: E402

RNG = np.random.default_rng(11)
TOL = {"float32": 2e-5, "bfloat16": 3e-2}      # tests/test_kernels.py's
CONFIGS = {"granite-3-8b": (granite_3_8b, j_granite_3_8b),
           "granite-20b": (granite_20b, j_granite_20b),
           "nemotron-4-15b": (nemotron_4_15b, j_nemotron)}
# float32 logits of the smoke models: XLA and PyTorch sum the same float32
# products in other orders (about 1e-6 relative per op); through two layers
# and the head the logits (|logit| <= 4.2) agree within 2.5e-5, the layer-2
# cache entries (|x| <= 24) within 1.1e-4: held at 4x those
LOGIT_TOL = dict(atol=1e-4, rtol=1e-4)
CACHE_RTOL = 2e-5                  # of the cache's largest magnitude


def _pair(shape, dt):
    """The same values as a JAX array and a CPU tensor (bf16 rounds the
    same float32 draw to nearest-even on both sides)."""
    a = RNG.normal(size=shape).astype(np.float32)
    return jnp.asarray(a, dt), torch.from_numpy(a).to(getattr(torch, dt))


def _np(t):
    return t.float().numpy()


# ---------------------------------------------------------------------------
# the flash-attention op
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,H,Hkv,S,T,d,dt,causal", [
    (1, 2, 2, 64, 64, 16, "float32", True),
    (2, 4, 2, 96, 96, 32, "float32", True),
    (1, 2, 1, 33, 70, 16, "float32", True),
    (1, 4, 4, 40, 40, 8, "float32", True),
    (1, 2, 2, 64, 64, 16, "bfloat16", True),
    (1, 2, 2, 32, 48, 16, "float32", False),
    (2, 6, 3, 20, 45, 8, "bfloat16", False),
])
def test_flash_attention_matches_pallas_interpret(B, H, Hkv, S, T, d, dt,
                                                  causal):
    jq, q = _pair((B, H, S, d), dt)
    jk, k = _pair((B, Hkv, T, d), dt)
    jv, v = _pair((B, Hkv, T, d), dt)
    out = flash_attention(q, k, v, causal=causal)
    assert out.shape == (B, H, S, d) and out.dtype == q.dtype
    # the reference op pads T to its block and masks the pad keys only as
    # the causal future, so without causality a ragged T lets the zero pad
    # keys into its softmax (off by 0.025 in float32 at T = 45): there the
    # port, which masks t >= T, is held against the plain reference alone
    if causal or T % 16 == 0:
        ref = np.asarray(j_flash_attention(jq, jk, jv, causal=causal,
                                           block_q=16, block_k=16),
                         np.float32)
        np.testing.assert_allclose(_np(out), ref, atol=TOL[dt])
    np.testing.assert_allclose(
        _np(out), np.asarray(flash_attention_reference(jq, jk, jv,
                                                       causal=causal),
                             np.float32), atol=TOL[dt])


@pytest.mark.parametrize("S,T,q_start,H,Hkv", [
    (8, 40, 0, 4, 2),        # prefill of 8 rows into a 40-slot cache
    (8, 40, 17, 4, 1),       # a chunk mid-cache, MQA
    (1, 40, 37, 6, 2),       # a decode row over a partly filled cache
    (5, 40, 35, 48, 1),      # the last rows of the cache, 48 heads on 1
])
def test_flash_attention_q_start_matches_attention_ref(S, T, q_start, H, Hkv):
    """Row s sees keys t <= q_start + s; the slots past q_start + S hold
    stale values that must not count. The reference's attention_ref sees
    the same problem as the cache cut to q_start + S slots, whose default
    diagonal is the same offset."""
    jq, q = _pair((2, H, S, 16), "float32")
    jk, k = _pair((2, Hkv, T, 16), "float32")
    jv, v = _pair((2, Hkv, T, 16), "float32")
    n = q_start + S
    ref = np.asarray(flash_attention_reference(jq, jk[:, :, :n], jv[:, :, :n]))
    np.testing.assert_allclose(_np(flash_attention(q, k, v, q_start=q_start)),
                               ref, atol=TOL["float32"])


def test_flash_attention_on_transposed_cache_views():
    """The model hands the op (B, T, Hkv, d) cache tensors transposed to
    (B, Hkv, T, d), never a contiguous copy: the result equals the one on
    contiguous inputs."""
    ck = torch.from_numpy(RNG.normal(size=(2, 30, 2, 16)).astype(np.float32))
    cv = torch.from_numpy(RNG.normal(size=(2, 30, 2, 16)).astype(np.float32))
    q = torch.from_numpy(RNG.normal(size=(2, 3, 4, 16)).astype(np.float32))
    kt, vt = ck.transpose(1, 2), cv.transpose(1, 2)
    assert not kt.is_contiguous()
    out = flash_attention(q.transpose(1, 2), kt, vt, q_start=20)
    ref = flash_attention(q.transpose(1, 2).contiguous(), kt.contiguous(),
                          vt.contiguous(), q_start=20)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
    with pytest.raises(ValueError, match="q_start >= 0"):
        flash_attention(q.transpose(1, 2), kt, vt, q_start=-1)


@pytest.mark.parametrize("chunk,q_start", [(0, 0), (4, 0), (0, 5), (4, 5)])
def test_sdpa_matches_reference(chunk, q_start):
    jq, q = _pair((2, 8, 6, 16), "float32")
    jk, k = _pair((2, 8 + q_start, 2, 16), "float32")
    jv, v = _pair((2, 8 + q_start, 2, 16), "float32")
    ref = np.asarray(jtr._sdpa(jq, jk, jv, 0.25, q_start, chunk=chunk))
    out = tr._sdpa(q, k, v, 0.25, q_start, chunk=chunk)
    np.testing.assert_allclose(out.numpy(), ref, atol=TOL["float32"])
    # the flash op computes the same attention in float32
    fl = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), scale=0.25, q_start=q_start)
    np.testing.assert_allclose(fl.transpose(1, 2).numpy(), ref,
                               atol=TOL["float32"])


# ---------------------------------------------------------------------------
# the kernel's route plan and the split-KV path's plain version
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,hkv,rows,t_end,n_sm", [
    (1, 8, 4 * 8192, 8192, 132),     # granite-3-8b prefill of 8,192
    (8, 8, 4, 32761, 132),           # its decode step over 32,761 keys
    (2, 8, 4, 1025, 132),            # the 4-layer float32 check's decode
    (1, 1, 1, 1, 132),
    (1, 2, 16, 100_000, 132),
    (1, 1, 1, 700, 8),
    (300, 1, 1, 5000, 132),          # the unsplit grid fills the card
    (4, 2, 17, 5000, 132),           # 17 rows: more than a split block
])
def test_split_plan_covers_the_keys(b, hkv, rows, t_end, n_sm):
    n_split, chunk = fa_kernel.split_plan(b, hkv, rows, t_end, n_sm)
    assert chunk % fa_kernel.KEY_TILE == 0
    # chunks [c chunk, min((c + 1) chunk, t_end)) in order, none empty,
    # their union [0, t_end) once
    bounds = [min(c * chunk, t_end) for c in range(n_split + 1)]
    assert bounds[0] == 0 and bounds[-1] == t_end
    assert all(lo < hi for lo, hi in zip(bounds, bounds[1:]))
    if rows > fa_kernel.SPLIT_ROWS or b * hkv >= 2 * n_sm:
        assert n_split == 1
    if n_split > 1:
        assert chunk >= fa_kernel.SPLIT_MIN_KEYS
    if (b, rows, t_end) == (1, 4 * 8192, 8192):
        assert n_split == 1
    if (b, rows, t_end) == (8, 4, 32761):
        assert n_split * b * hkv >= 2 * 132


def test_plan_routes_by_shape():
    """The route is chosen by shape and layout before the launch: the
    model's bf16 prefill (strided (B, S, H, d) queries) takes wgmma with
    16-byte (TMA) copies, its decode over a (B, T, Hkv, d) cache the split
    route, float32 prefill and odd head dims the CUDA-core kernel, d 100
    and T under one key tile mma.sync."""
    bf = torch.bfloat16

    def plan(q, k, **kw):
        return fa_kernel.plan(q, k, k, causal=True, n_sm=132, **kw)

    q = torch.empty(1, 8192, 32, 128, dtype=bf).transpose(1, 2)
    k = torch.empty(1, 8192, 8, 128, dtype=bf).transpose(1, 2)
    assert plan(q, k, q_start=0) == ("wgmma", 16, 1, 8192, 8192)
    assert plan(q.float(), k.float(), q_start=0).route == "tile"
    cache = torch.empty(8, 2048, 8, 128, dtype=bf).transpose(1, 2)
    p = plan(torch.empty(8, 32, 1, 128, dtype=bf), cache, q_start=2040)
    assert p.route == "split" and p.vec == 16 and p.t_end == 2041
    assert (p.n_split, p.chunk) == fa_kernel.split_plan(8, 8, 4, 2041)
    assert plan(torch.empty(1, 8, 50, 7, dtype=bf),
                torch.empty(1, 2, 90, 7, dtype=bf), q_start=0).route \
        == "tile"
    assert plan(torch.empty(2, 8, 130, 100, dtype=bf),
                torch.empty(2, 2, 130, 100, dtype=bf), q_start=0)[:2] \
        == ("mma", 8)
    assert plan(torch.empty(1, 8, 40, 128, dtype=bf),
                torch.empty(1, 2, 50, 128, dtype=bf), q_start=10)[:2] \
        == ("mma", 16)
    forced = plan(torch.empty(1, 2, 16, 64, dtype=bf),
                  torch.empty(1, 2, 200, 64, dtype=bf), q_start=50,
                  chunk=64)
    assert forced == ("split", 16, 2, 64, 66)


@pytest.mark.parametrize("chunk", [64, 7])
@pytest.mark.parametrize("causal,at", [(True, "0"), (True, "mid"),
                                       (True, "end"), (False, "0")])
@pytest.mark.parametrize("B,Hkv,G,S,T,d", [
    (1, 2, 1, 33, 70, 16),
    (2, 2, 4, 9, 130, 16),
    (1, 1, 48, 5, 100, 8),           # MQA, G 48
    (2, 3, 4, 1, 77, 32),            # a decode row
])
def test_split_ref_matches_jax_reference(B, Hkv, G, S, T, d, causal, at,
                                         chunk):
    """The split path's plain version, chunk by chunk and merged in chunk
    order, equals the JAX package's reference op. At q_start 0 the chunks
    past key q_start + s lie wholly beyond row s's limit; chunks of 7 keys
    do not divide T. The reference takes the bottom-right diagonal, so it
    sees the cache cut to q_start + S slots."""
    q_start = {"0": 0, "mid": (T - S) // 2 + 3, "end": T - S}[at]
    jq, q = _pair((B, Hkv * G, S, d), "float32")
    jk, k = _pair((B, Hkv, T, d), "float32")
    jv, v = _pair((B, Hkv, T, d), "float32")
    out = attention_split_ref(q, k, v, chunk=chunk, causal=causal,
                              q_start=q_start)
    n = q_start + S if causal else T
    ref = np.asarray(flash_attention_reference(jq, jk[:, :, :n],
                                               jv[:, :, :n], causal=causal))
    np.testing.assert_allclose(_np(out), ref, atol=TOL["float32"])


# ---------------------------------------------------------------------------
# configs and data
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(CONFIGS))
def test_config_copies_and_param_counts(arch):
    mine, ref = CONFIGS[arch]
    for make in ("full", "smoke"):
        cfg, jcfg = getattr(mine, make)(), getattr(ref, make)()
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert (cfg.padded_vocab, cfg.q_dim, cfg.n_params(),
                cfg.active_params()) == (jcfg.padded_vocab, jcfg.q_dim,
                                         jcfg.n_params(),
                                         jcfg.active_params())
    if arch == "granite-3-8b":
        assert granite_3_8b.full().n_params() == 8_373_211_136
        assert granite_3_8b.full().padded_vocab == 49_280


def test_token_batches_copy():
    mine = token_batches(1000, 3, 17, seed=4, n_batches=2)
    ref = j_token_batches(1000, 3, 17, seed=4, n_batches=2)
    for a, b in zip(mine, ref, strict=True):
        for key in ("tokens", "labels"):
            assert a[key].dtype == b[key].dtype == np.int32
            np.testing.assert_array_equal(a[key], b[key])


def test_unported_configs_raise():
    """The MoE and MLA archs were refused here until they were ported; the
    test now holds what is true: both build (`Transformer.random` with the
    reference's leaf count, `init_cache` in the reference's layouts), an
    MTP head comes across through `from_jax`, and the mesh that stayed
    unported after them is ported too: a MoE model trains on a one-rank
    mesh with `lm_rules`' specs, and a spec tree that does not fit its
    parameters is refused."""
    for arch in ("qwen2-moe-a2.7b", "deepseek-v3-671b"):
        jcfg = get_arch(arch).smoke()
        cfg = tr.LMConfig(**dataclasses.asdict(jcfg))
        shapes = jax.eval_shape(lambda key: jtr.init_params(jcfg, key),
                                jax.random.PRNGKey(0))
        model = tr.Transformer.random(cfg, device="cpu")
        assert model.n_params() == sum(a.size
                                       for a in jax.tree.leaves(shapes))
        cache = tr.init_cache(cfg, 1, 4, device="cpu")
        ref = jax.eval_shape(lambda: jtr.init_cache(jcfg, 1, 4))
        for stack in ("dense", "moe"):
            if ref[stack] is None:
                assert cache[stack] is None
            else:
                assert [tuple(t.shape) for t in cache[stack]] == \
                    [a.shape for a in ref[stack]]
    cfg = dataclasses.replace(granite_3_8b.smoke(), mtp_depth=1)
    jp = jtr.init_params(jtr.LMConfig(**dataclasses.asdict(cfg)),
                         jax.random.PRNGKey(0))
    model = tr.Transformer.from_jax(cfg, jp, device="cpu")
    assert sorted(model.params["mtp"]) == ["block", "proj"]
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.sharding.rules import P, lm_rules, make_param_specs
    mesh = make_device_mesh((1, 1), ("data", "model"), device="cpu")
    task = train.build_task("qwen2-moe-a2.7b", 1, 1, 8, False, device="cpu")
    task.param_specs = lambda tree: make_param_specs(
        tree, mesh, lm_rules(mesh, fsdp=True))
    log = Trainer(task, mesh=mesh).run(steps=1)["log"]
    assert np.isfinite(log[0]["loss"])
    task = train.build_task("qwen2-moe-a2.7b", 1, 1, 8, False, device="cpu")
    task.param_specs = {"embed": P("data", None)}
    with pytest.raises(ValueError, match="does not match the parameters"):
        Trainer(task, mesh=mesh).run(steps=1)


def test_random_weights_follow_the_reference_distribution():
    cfg = dataclasses.replace(granite_3_8b.smoke(), dtype="float32",
                              n_layers=3, d_model=128, d_ff=256)
    model = tr.Transformer.random(cfg, seed=0, device="cpu")
    jcfg = jtr.LMConfig(**dataclasses.asdict(cfg))
    shapes = jax.eval_shape(lambda key: jtr.init_params(jcfg, key),
                            jax.random.PRNGKey(0))
    assert model.n_params() == cfg.n_params()
    mine = dict(_flat(model.params))
    ref = dict(_flat(shapes))
    assert mine.keys() == ref.keys()
    for key, t in mine.items():
        assert tuple(t.shape) == ref[key].shape, key
        assert t.dtype == torch.float32
    assert mine["embed"].std().item() == pytest.approx(0.02, rel=0.05)
    assert mine["lm_head"].std().item() == pytest.approx(128 ** -0.5,
                                                         rel=0.05)
    # per-layer fan-in (the reference reads the stack's first axis)
    for key, fan_in in (("dense_layers/attn/wq", 128),
                        ("dense_layers/mlp/w_out", 256)):
        assert mine[key].std().item() == pytest.approx(fan_in ** -0.5,
                                                       rel=0.05)
    for key in ("final_norm", "dense_layers/ln1", "dense_layers/ln2"):
        assert bool((mine[key] == 1).all())
    again = tr.Transformer.random(cfg, seed=0, device="cpu")
    assert all(torch.equal(t, dict(_flat(again.params))[k])
               for k, t in mine.items())


def _flat(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flat(v, f"{prefix}{k}/")
        else:
            yield prefix + k, v


# ---------------------------------------------------------------------------
# the model against the reference, float32 smoke configs
# ---------------------------------------------------------------------------

B, S, EXTRA = 2, 12, 4


@pytest.fixture(scope="module", params=sorted(CONFIGS))
def served(request):
    """(port config, port model from the reference's params, tokens, and
    the reference's forward over S + 1 tokens, prefill of S into S + EXTRA
    slots and decode of token S)."""
    mine, ref = CONFIGS[request.param]
    cfg = dataclasses.replace(mine.smoke(), dtype="float32")
    jcfg = dataclasses.replace(ref.smoke(), dtype="float32")
    params = jtr.init_params(jcfg, jax.random.PRNGKey(0))
    toks = RNG.integers(0, cfg.vocab_size, (B, S + 1)).astype(np.int32)
    jfwd = jtr.forward(params, jcfg, jnp.asarray(toks))
    jpre, jcache = jtr.prefill(params, jcfg, jnp.asarray(toks[:, :S]),
                               max_len=S + EXTRA)
    jdec, jcache2 = jtr.decode_step(params, jcfg, jcache,
                                    jnp.asarray(toks[:, S:]), jnp.int32(S))
    ref_out = {"forward": np.asarray(jfwd), "prefill": np.asarray(jpre),
               "cache": [np.asarray(a) for a in jcache["dense"]],
               "decode": np.asarray(jdec),
               "cache2": [np.asarray(a) for a in jcache2["dense"]]}
    model = tr.Transformer.from_jax(cfg, params, device="cpu")
    return cfg, model, torch.from_numpy(toks), ref_out


def test_from_jax_carries_every_parameter(served):
    cfg, model, _, _ = served
    assert model.n_params() == cfg.n_params()
    assert model.device == torch.device("cpu")


@pytest.mark.parametrize("use_kernel", [True, False])
def test_forward_matches_jax(served, use_kernel):
    cfg, model, toks, ref = served
    logits = model.forward(toks, use_kernel=use_kernel)
    assert logits.shape == (B, S + 1, cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), ref["forward"], **LOGIT_TOL)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_prefill_and_decode_step_match_jax(served, use_kernel):
    cfg, model, toks, ref = served
    logits, cache = model.prefill(toks[:, :S], max_len=S + EXTRA,
                                  use_kernel=use_kernel)
    np.testing.assert_allclose(logits.numpy(), ref["prefill"], **LOGIT_TOL)
    for mine, jax_cache in zip(cache["dense"], ref["cache"]):
        assert tuple(mine.shape) == jax_cache.shape == (
            cfg.n_layers, B, S + EXTRA, cfg.n_kv_heads, cfg.d_head)
        np.testing.assert_allclose(
            mine.numpy(), jax_cache,
            atol=CACHE_RTOL * np.abs(jax_cache).max())
        assert not mine[:, :, S:].any()
    ck = cache["dense"][0]
    ptr = ck.data_ptr()
    lg, cache2 = model.decode_step(cache, toks[:, S:], S,
                                   use_kernel=use_kernel)
    assert cache2 is cache and cache["dense"][0].data_ptr() == ptr
    np.testing.assert_allclose(lg.numpy(), ref["decode"], **LOGIT_TOL)
    for mine, jax_cache in zip(cache["dense"], ref["cache2"]):
        np.testing.assert_allclose(
            mine[:, :, S].numpy(), jax_cache[:, :, S],
            atol=CACHE_RTOL * np.abs(jax_cache).max())
        assert not mine[:, :, S + 1:].any()
    # decode against forward, as tests/test_models_lm.py holds the reference
    fwd = model.forward(toks, use_kernel=use_kernel)[:, S]
    assert (lg[:, 0] - fwd).abs().max().item() < 1e-3


def test_cache_overflow_raises(served):
    _, model, toks, _ = served
    cache = model.init_cache(B, S)
    with pytest.raises(ValueError, match="cannot take"):
        model.decode_step(cache, toks[:, :1], S)


def test_bfloat16_forward_matches_jax():
    """bf16 end to end, tolerances relative to the largest logit (about 4).
    The ported `_sdpa` rounds where the reference rounds, but XLA keeps
    fused elementwise chains in float32 and PyTorch rounds after each op:
    a few bf16 ulps per layer, measured 0.9-2.2% of the largest logit, held
    at 5%. The flash path keeps the probabilities in float32 (the kernel's
    semantics), so it sits as far from the reference's bf16 model as that
    model sits from its own float32 run (measured 4.5-7.6%), held at 15%."""
    cfg = granite_3_8b.smoke()
    jcfg = j_granite_3_8b.smoke()
    params = jtr.init_params(jcfg, jax.random.PRNGKey(3))
    toks = RNG.integers(0, cfg.vocab_size, (2, 10)).astype(np.int32)
    ref = np.asarray(jtr.forward(params, jcfg, jnp.asarray(toks)),
                     np.float32)
    model = tr.Transformer.from_jax(cfg, params, device="cpu")
    assert model.params["embed"].dtype == torch.bfloat16
    assert torch.equal(model.params["embed"].float(),
                       torch.from_numpy(np.asarray(params["embed"],
                                                   np.float32)))
    for use_kernel, share in ((False, 0.05), (True, 0.15)):
        out = model.forward(torch.from_numpy(toks), use_kernel=use_kernel)
        assert out.dtype == torch.bfloat16
        np.testing.assert_allclose(_np(out), ref,
                                   atol=share * np.abs(ref).max())
