"""DeepSeek MLA and the MTP head of the PyTorch port against the JAX
package: `_mla_attention` (expanded prefill, a chunk written mid-cache, the
absorbed decode step) against the reference's on one layer with its latent
cache; deepseek-v3-671b's smoke model (dense MLA layers, MoE layers, MTP)
through `Transformer.from_jax`: forward, `prefill` and `decode_step`
against the reference's, decode against forward, `loss_fn` with the MTP
term and its gradients against `jax.value_and_grad`, the parameter counts
and paths; and the training CLI for the arch."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so the test workers running beside
# this one keep their cores
torch.set_num_threads(1)

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

ARCH = "deepseek-v3-671b"
# float32: XLA and PyTorch sum the same float32 products in other orders
# (about 1e-6 relative per op). Measured: one MLA layer's outputs
# (|y| <= 3.6) agree within 7.2e-7, the smoke model's logits (|logit| <= 4)
# within 2.5e-5, its caches within 4.4e-6 of their largest magnitude, and a
# step's gradients within 3.1e-5 of each leaf's largest |g|
ATTN_ATOL = 2e-5
LOGIT_TOL = dict(atol=2e-4, rtol=1e-4)
CACHE_SHARE = 2e-5             # of the cache's largest magnitude
# one step's loss and gradients: tests/test_torch_train_models.py's dense-LM
# tolerances (relative loss; each leaf within rtol 1e-4 and atol 1e-4 x its
# largest |g|)
LOSS_TOL, GRAD_RTOL, LM_GRAD_SHARE = 1e-6, 1e-4, 1e-4


def smoke_pair(**changes):
    """(port config, reference config, reference params) of the arch's
    smoke config in float32."""
    jcfg = dataclasses.replace(j_get_arch(ARCH).smoke(), dtype="float32",
                               **changes)
    return (tr.LMConfig(**dataclasses.asdict(jcfg)), jcfg,
            jtr.init_params(jcfg, jax.random.PRNGKey(0)))


def tokens(shape, vocab):
    return np.array(jax.random.randint(jax.random.PRNGKey(1), shape, 0,
                                       vocab), np.int32)


def jax_paths(tree) -> dict:
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# one MLA layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("S,cur", [(8, 0), (5, 7), (1, 11)])
def test_mla_attention_matches_reference(S, cur):
    """The layer's attention writing S rows at slot cur of a 16-slot latent
    cache whose earlier slots hold values and whose later ones hold values
    that must not count: (8, 0) is a prefill, (5, 7) a chunk mid-cache
    (expanded K/V), (1, 11) a decode step (the absorbed form)."""
    cfg, jcfg, jp = smoke_pair()
    # dense layer 0, each matrix scaled to its own fan-in (the init reads
    # it off the stack's axis, here 1)
    p = jax.tree.map(lambda a: a[0] / np.sqrt(a.shape[-2]) if a.ndim > 2
                     else a[0], jp["dense_layers"]["attn"])
    r = np.random.default_rng(S)
    x = r.normal(size=(2, S, cfg.d_model)).astype(np.float32)
    cc = r.normal(size=(2, 16, cfg.kv_lora_rank)).astype(np.float32)
    cr = r.normal(size=(2, 16, 1, cfg.qk_rope_dim)).astype(np.float32)
    pos = np.arange(cur, cur + S)[None].repeat(2, 0)
    ref, (jcc, jcr) = jax.jit(
        lambda p, x, cc, cr: jtr._mla_attention(
            p, jcfg, x, jnp.asarray(pos), cur, (cc, cr, cur)))(p, x, cc, cr)
    tp = tr._map(p, lambda a: torch.from_numpy(np.array(a)))
    tcc, tcr = torch.from_numpy(cc.copy()), torch.from_numpy(cr.copy())
    out = tr._mla_attention(tp, cfg, torch.from_numpy(x),
                            torch.from_numpy(pos), cur, (tcc, tcr, cur))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=ATTN_ATOL,
                               rtol=0)
    # the cache written in place: the new rows at cur, the rest untouched
    np.testing.assert_allclose(tcc.numpy(), np.asarray(jcc), rtol=0,
                               atol=CACHE_SHARE * np.abs(cc).max())
    np.testing.assert_allclose(tcr.numpy(), np.asarray(jcr), rtol=0,
                               atol=CACHE_SHARE * np.abs(cr).max())
    assert np.array_equal(tcc.numpy()[:, cur + S:], cc[:, cur + S:])


# ---------------------------------------------------------------------------
# the model (tests/test_models_lm.py through the port)
# ---------------------------------------------------------------------------

def test_smoke_forward_and_train_step():
    cfg, jcfg, jp = smoke_pair()
    model = tr.Transformer.from_jax(cfg, jp, device="cpu")
    assert [(n, len(ls)) for n, _, ls in model.stacks] == [("dense", 1),
                                                            ("moe", 2)]
    toks = tokens((2, 17), cfg.vocab_size)
    ref = np.asarray(jax.jit(lambda p, t: jtr.forward(p, jcfg, t))(
        jp, toks[:, :-1]))
    logits = model.forward(torch.from_numpy(toks[:, :-1]))
    assert logits.shape == (2, 16, cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), ref, **LOGIT_TOL)


def test_prefill_and_absorbed_decode_match_reference():
    """`prefill` into a cache of S + 4 slots and a decode step at S against
    the reference's; at a capacity factor with no drops (capacity = T) the
    decode step's logits equal forward's at S within the reference test's
    1e-3."""
    n_exp, k = j_get_arch(ARCH).smoke().n_experts, j_get_arch(ARCH).smoke().top_k
    cfg, jcfg, jp = smoke_pair(capacity_factor=n_exp / k)
    model = tr.Transformer.from_jax(cfg, jp, device="cpu")
    S = 12
    toks = tokens((2, S + 1), cfg.vocab_size)
    jlg, jcache = jax.jit(lambda p, t: jtr.prefill(p, jcfg, t, max_len=S + 4))(
        jp, toks[:, :S])
    jstep, _ = jax.jit(lambda p, c, t: jtr.decode_step(p, jcfg, c, t,
                                                       jnp.int32(S)))(
        jp, jcache, toks[:, S:])
    lg, cache = model.prefill(torch.from_numpy(toks[:, :S]), max_len=S + 4)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **LOGIT_TOL)
    for stack in ("dense", "moe"):
        for mine, ref in zip(cache[stack], jcache[stack], strict=True):
            ref = np.asarray(ref)
            assert tuple(mine.shape) == ref.shape
            np.testing.assert_allclose(mine.numpy(), ref, rtol=0,
                                       atol=CACHE_SHARE * np.abs(ref).max())
    step, _ = model.decode_step(cache, torch.from_numpy(toks[:, S:]), S)
    assert [int(d) for d in model.dropped] == [0, 0]
    np.testing.assert_allclose(step.numpy(), np.asarray(jstep), **LOGIT_TOL)
    fwd = model.forward(torch.from_numpy(toks))[:, S]
    assert sum(int(d) for d in model.dropped) == 0
    assert float((step[:, 0] - fwd).abs().max()) < 1e-3


@pytest.mark.parametrize("ce_chunk,remat", [(0, False), (4, True)])
def test_loss_with_mtp_and_grads_match_jax(ce_chunk, remat):
    """`loss_fn` with the MTP term ("ce", "mtp_ce", "loss") and one step's
    gradients, every leaf's (the MTP head's too), against
    `jax.value_and_grad` of the reference's, at batch 4 x 16 with masked
    labels."""
    cfg, jcfg, jp = smoke_pair(ce_chunk=ce_chunk)
    toks = tokens((4, 17), cfg.vocab_size)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -100
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: jtr.loss_fn(p, jcfg, jnp.asarray(toks[:, :-1]),
                              jnp.asarray(labels), remat=remat),
        has_aux=True))(jp)
    model = tr.Transformer.from_jax(cfg, jp, device="cpu")
    paths, leaves = zip(*leaves_with_path(model.param_tree()))
    for t in leaves:
        t.requires_grad_(True)
    loss, metrics = tr.loss_fn(model.params, cfg,
                               torch.from_numpy(toks[:, :-1]),
                               torch.from_numpy(labels), remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    assert list(metrics) == ["ce", "mtp_ce", "loss"] and sorted(jm) == \
        sorted(metrics)
    for key in metrics:
        np.testing.assert_allclose(metrics[key].item(), float(jm[key]),
                                   rtol=LOSS_TOL, err_msg=key)
    want = jax_paths(jg)
    assert sorted(want) == sorted(paths)
    assert any(p.startswith("mtp/") for p in paths)
    for path, g in zip(paths, grads):
        top = float(np.abs(want[path]).max())
        np.testing.assert_allclose(g.numpy(), want[path], rtol=GRAD_RTOL,
                                   atol=LM_GRAD_SHARE * top, err_msg=path)


def test_param_counts_match_analytic():
    """The config copies (full and smoke) equal the reference's field for
    field with the same analytic counts; the smoke model's leaves (from the
    reference or drawn by `Transformer.random`) have the reference's paths
    and shapes, MTP included; the analytic count leaves out the MLA norms
    and part of the MTP block (the reference test allows 15%)."""
    spec, jspec = get_arch(ARCH), j_get_arch(ARCH)
    for which in ("full", "smoke"):
        cfg, jcfg = getattr(spec, which)(), getattr(jspec, which)()
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert (cfg.n_params(), cfg.active_params(), cfg.q_dim) == \
            (jcfg.n_params(), jcfg.active_params(), jcfg.q_dim)
    cfg, jcfg, jp = smoke_pair()
    want = {k: v.shape for k, v in jax_paths(jp).items()}
    assert "mtp/block/attn/wkv_b" in want
    for model in (tr.Transformer.from_jax(cfg, jp, device="cpu"),
                  tr.Transformer.random(cfg, seed=0, device="cpu")):
        got = {k: tuple(t.shape)
               for k, t in leaves_with_path(model.param_tree())}
        assert list(got) == list(want) and got == want
        actual = model.n_params()
        assert abs(actual - cfg.n_params()) / actual < 0.15


def test_depth_cut_below_the_dense_layers():
    """deepseek-v3's 3 leading dense layers: a cut to fewer layers must cut
    first_dense_layers too (the reference's stacks would be negative)."""
    cfg = dataclasses.replace(get_arch(ARCH).smoke(), n_layers=2,
                              first_dense_layers=3, dtype="float32")
    with pytest.raises(ValueError, match="first_dense_layers"):
        tr.Transformer.random(cfg, device="cpu")
    cache = tr.init_cache(dataclasses.replace(cfg, first_dense_layers=2), 2,
                          8, device="cpu")
    assert cache["moe"] is None
    assert tuple(cache["dense"][0].shape) == (2, 2, 8, cfg.kv_lora_rank)
    assert tuple(cache["dense"][1].shape) == (2, 2, 8, 1, cfg.qk_rope_dim)


# ---------------------------------------------------------------------------
# the training CLI
# ---------------------------------------------------------------------------

def test_train_cli_on_the_cpu(capsys):
    train.main(["--arch", ARCH, "--device", "cpu", "--steps", "4",
                "--batch", "2", "--seq", "16"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"[{ARCH}] steps 0..3 loss ")
    task = train.build_task(ARCH, 2, 2, 16, False, device="cpu", n_layers=1)
    model = task.init_params(torch.Generator().manual_seed(0))
    assert [(n, len(ls)) for n, _, ls in model.stacks] == [("dense", 1)]
    assert "mtp" in model.params
    loss, metrics = task.loss_fn(model, next(task.batches))
    assert {"ce", "mtp_ce", "loss"} <= set(metrics)
