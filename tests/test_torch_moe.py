"""The MoE language model of the PyTorch port against the JAX package:
`_moe_mlp` (the capacity-bounded top-k dispatch) against the reference's at
a capacity that drops, one that does not, and 4,096 tokens (the capacity
rounded to 512), with the kept (token, k) slots equal exactly;
qwen2-moe-a2.7b's smoke model through `Transformer.from_jax` (forward, a
train step, decode against forward, the parameter counts and paths); the
copied `core/expert_placement` on the reference's two cases; and the
training CLI for the arch."""
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
from repro.core import expert_placement as j_ep  # noqa: E402
from repro.models import transformer as jtr  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.core import expert_placement as ep  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

ARCH = "qwen2-moe-a2.7b"
# float32 outputs: XLA and PyTorch sum the same float32 products in other
# orders (about 1e-6 relative per op); measured, a MoE layer's outputs
# (|y| <= 7.8) agree within 2.4e-6, the smoke model's logits (|logit| <= 4.3)
# within 2.5e-5
MOE_ATOL = 1e-5
LOGIT_TOL = dict(atol=2e-4, rtol=1e-4)
MOE_CFG = dict(name="m", n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
               d_head=16, d_ff=64, vocab_size=64, moe=True, n_experts=8,
               top_k=2, n_shared_experts=1, moe_d_ff=16, shared_d_ff=24,
               dtype="float32")


def smoke_pair(**changes):
    """(port config, reference config, reference params) of the arch's
    smoke config in float32."""
    jcfg = dataclasses.replace(j_get_arch(ARCH).smoke(), dtype="float32",
                               **changes)
    return (tr.LMConfig(**dataclasses.asdict(jcfg)), jcfg,
            jtr.init_params(jcfg, jax.random.PRNGKey(0)))


def jax_paths(tree) -> dict:
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def reference_slots(p, cfg, x):
    """The reference `_moe_mlp`'s routing (src/repro/models/transformer.py,
    the lines from the router logits to e_safe / p_safe), run in JAX:
    (expert ids (T, k), expert of each (token, k) pair, its slot, kept)."""
    T = x.shape[0] * x.shape[1]
    xt = x.reshape(T, -1)
    logits = (xt @ p["router"]).astype(jnp.float32)
    _, idx = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)
    cap = int(np.ceil(T * cfg.top_k / cfg.n_experts * cfg.capacity_factor))
    cap = max(8, min(cap, T))
    if T >= 4096:
        cap = int(np.ceil(cap / 512)) * 512
    eid = idx.reshape(T * cfg.top_k)
    order = jnp.argsort(eid)
    sorted_eid = eid[order]
    starts = jnp.searchsorted(sorted_eid, jnp.arange(cfg.n_experts))
    pos_sorted = jnp.arange(T * cfg.top_k) - starts[sorted_eid]
    pos = jnp.zeros_like(pos_sorted).at[order].set(pos_sorted)
    keep = pos < cap
    return (np.asarray(idx), np.asarray(jnp.where(keep, eid, 0)),
            np.asarray(jnp.where(keep, pos, 0)), np.asarray(keep))


# ---------------------------------------------------------------------------
# the MoE layer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("B,S,cf,cap,drops", [
    (2, 32, 0.5, 8, True),          # 64 tokens, 8 slots an expert: drops
    (2, 32, 4.0, 64, False),        # capacity = T: nothing drops
    (2, 2048, 0.25, 512, True),     # 4,096 tokens: 256 rounded up to 512
])
def test_moe_mlp_matches_reference(B, S, cf, cap, drops):
    jcfg = jtr.LMConfig(**MOE_CFG, capacity_factor=cf)
    cfg = tr.LMConfig(**MOE_CFG, capacity_factor=cf)
    assert tr.moe_capacity(cfg, B * S) == cap
    # layer 0 of the reference's init, each matrix scaled to its own
    # fan-in (the init reads it off the stack's axis, here 1), so that the
    # outputs are of order one
    jp = jax.tree.map(lambda a: a[0] / np.sqrt(a.shape[-2]) if a.ndim > 2
                      else a[0], jtr.init_params(
        jcfg, jax.random.PRNGKey(0))["moe_layers"])
    x = np.random.default_rng(S).normal(size=(B, S, 32)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda p, x: jtr._moe_mlp(p, jcfg, x))(
        jp, jnp.asarray(x)))
    p = tr._map(jp, lambda a: torch.from_numpy(np.array(a)))
    xt = torch.from_numpy(x)
    drops_out = []
    out = tr._moe_mlp(p, cfg, xt, drops_out)
    np.testing.assert_allclose(out.numpy(), ref, atol=MOE_ATOL, rtol=0)
    # the same (token, k) pairs kept, in the same slots
    idx, e_safe, p_safe, keep = reference_slots(jp, jcfg, jnp.asarray(x))
    _, t_idx, t_e, t_p, t_keep = tr.moe_route(p, cfg, xt.reshape(B * S, 32))
    np.testing.assert_array_equal(t_idx.numpy(), idx)
    np.testing.assert_array_equal(t_keep.numpy(), keep)
    np.testing.assert_array_equal(t_e.numpy(), e_safe)
    np.testing.assert_array_equal(t_p.numpy(), p_safe)
    assert int(drops_out[0]) == int((~keep).sum())
    assert (int(drops_out[0]) > 0) == drops
    # the expert buffer equals the reference's scatter (the dropped pairs'
    # zeros added into slot (0, 0)) bit for bit
    ref_buf = jnp.zeros((8, cap, 32)).at[e_safe, p_safe].add(
        jnp.where(keep[:, None], jnp.repeat(x.reshape(-1, 32), 2, axis=0), 0))
    buf = tr.moe_dispatch(cfg, xt.reshape(B * S, 32), t_e, t_p, t_keep)
    np.testing.assert_array_equal(buf.numpy(), np.asarray(ref_buf))


def test_top_k_takes_ties_in_the_lower_expert_first():
    """Equal router probabilities: `jax.lax.top_k` returns the lower expert
    index first; so does the port (a stable descending sort)."""
    cfg = tr.LMConfig(**MOE_CFG)
    router = np.zeros((32, 8), np.float32)
    router[0, [1, 3, 6]] = 1.0                # experts 1, 3 and 6 tie
    x = np.zeros((1, 4, 32), np.float32)
    x[0, :, 0] = [1.0, 0.0, -1.0, 2.0]
    _, idx, *_ = tr.moe_route({"router": torch.from_numpy(router)}, cfg,
                              torch.from_numpy(x[0]))
    _, ref = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x[0] @ router)), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ref))
    assert idx[0].tolist() == [1, 3] and idx[1].tolist() == [0, 1]


# ---------------------------------------------------------------------------
# the model (tests/test_models_lm.py through the port)
# ---------------------------------------------------------------------------

def test_smoke_forward_and_train_step():
    cfg, jcfg, jp = smoke_pair()
    model = tr.Transformer.from_jax(cfg, jp, device="cpu")
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, 17), 0,
                                         cfg.vocab_size), np.int32)
    ref = np.asarray(jax.jit(lambda p, t: jtr.forward(p, jcfg, t))(
        jp, toks[:, :-1]))
    logits = model.forward(torch.from_numpy(toks[:, :-1]))
    assert logits.shape == (2, 16, cfg.padded_vocab)
    np.testing.assert_allclose(logits.numpy(), ref, **LOGIT_TOL)
    tree = model.param_tree()
    leaves = [t.requires_grad_(True) for _, t in leaves_with_path(tree)]
    loss, metrics = tr.loss_fn(tree, cfg, torch.from_numpy(toks[:, :-1]),
                               torch.from_numpy(toks[:, 1:]))
    (jl, jm) = jax.jit(lambda p, t: jtr.loss_fn(p, jcfg, t[:, :-1],
                                                t[:, 1:]))(jp, toks)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    assert sorted(metrics) == sorted(jm) == ["ce", "loss"]
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    assert all(g is not None for g in grads)
    gnorm = sum(float(g.square().sum()) for g in grads)
    assert np.isfinite(gnorm) and gnorm > 0


def test_decode_matches_forward():
    """At a capacity factor with no drops (capacity = T), the decode step's
    logits equal forward's at that position within the reference test's
    1e-3, and the port's prefill, cache and decode equal the reference's."""
    n_exp, k = j_get_arch(ARCH).smoke().n_experts, j_get_arch(ARCH).smoke().top_k
    cfg, jcfg, jp = smoke_pair(capacity_factor=n_exp / k)
    model = tr.Transformer.from_jax(cfg, jp, device="cpu")
    S = 12
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (2, S + 1), 0,
                                         cfg.vocab_size), np.int32)
    jlg, jcache = jax.jit(lambda p, t: jtr.prefill(p, jcfg, t, max_len=S + 4))(
        jp, toks[:, :S])
    jstep, _ = jax.jit(lambda p, c, t: jtr.decode_step(p, jcfg, c, t,
                                                       jnp.int32(S)))(
        jp, jcache, toks[:, S:])
    lg, cache = model.prefill(torch.from_numpy(toks[:, :S]), max_len=S + 4)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), **LOGIT_TOL)
    assert cache["dense"] is None and jcache["dense"] is None
    for mine, ref in zip(cache["moe"], jcache["moe"], strict=True):
        ref = np.asarray(ref)
        np.testing.assert_allclose(mine.numpy(), ref, rtol=0,
                                   atol=2e-5 * np.abs(ref).max())
    step, _ = model.decode_step(cache, torch.from_numpy(toks[:, S:]), S)
    assert [int(d) for d in model.dropped] == [0] * cfg.n_layers
    np.testing.assert_allclose(step.numpy(), np.asarray(jstep), **LOGIT_TOL)
    fwd = model.forward(torch.from_numpy(toks))[:, S]
    assert sum(int(d) for d in model.dropped) == 0
    assert float((step[:, 0] - fwd).abs().max()) < 1e-3


def test_param_counts_match_analytic():
    """The config copies (full and smoke) equal the reference's field for
    field with the same analytic counts (the full model's 14,315,587,584
    parameters); the smoke model's leaves (from the reference or drawn by
    `Transformer.random`) have the reference's paths and shapes."""
    spec, jspec = get_arch(ARCH), j_get_arch(ARCH)
    for which in ("full", "smoke"):
        cfg, jcfg = getattr(spec, which)(), getattr(jspec, which)()
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert (cfg.n_params(), cfg.active_params()) == \
            (jcfg.n_params(), jcfg.active_params())
    assert spec.full().n_params() == 14_315_587_584
    cfg, jcfg, jp = smoke_pair()
    want = {k: v.shape for k, v in jax_paths(jp).items()}
    for model in (tr.Transformer.from_jax(cfg, jp, device="cpu"),
                  tr.Transformer.random(cfg, seed=0, device="cpu")):
        got = {k: tuple(t.shape)
               for k, t in leaves_with_path(model.param_tree())}
        assert list(got) == list(want) and got == want
        actual = model.n_params()
        assert actual == sum(int(np.prod(s)) for s in want.values())
        assert abs(actual - cfg.n_params()) / actual < 0.15


def test_random_experts_draw_at_their_own_fan_in():
    """`Transformer.random` scales an expert's w_in by 1/sqrt(D) and its
    w_out by 1/sqrt(moe_d_ff): neither the expert count nor the depth."""
    cfg = tr.LMConfig(**{**MOE_CFG, "n_layers": 3, "d_model": 256,
                         "moe_d_ff": 64, "n_experts": 4})
    model = tr.Transformer.random(cfg, seed=0, device="cpu")
    ex = model.params["moe_layers"]["experts"]
    assert tuple(ex["w_in"].shape) == (3, 4, 256, 64)
    for key, fan_in in (("w_in", 256), ("w_gate", 256), ("w_out", 64)):
        assert ex[key].std().item() == pytest.approx(fan_in ** -0.5,
                                                     rel=0.05)
    # each expert is drawn on its own
    assert not torch.equal(ex["w_in"][0, 0], ex["w_in"][0, 1])


# ---------------------------------------------------------------------------
# expert placement (tests/test_expert_placement.py's two cases)
# ---------------------------------------------------------------------------

def _skewed_routing(E=64, T=20000, k=4, seed=0):
    """tests/test_expert_placement.py's routing: Zipf-hot experts, each
    token's first expert paired with the one E/2 away."""
    rng = np.random.default_rng(seed)
    base = 1.0 / np.arange(1, E + 1) ** 1.2
    ids = np.zeros((T, k), dtype=np.int64)
    for t in range(T):
        first = rng.choice(E, p=base / base.sum())
        partner = (first + E // 2) % E
        rest = rng.choice(E, size=k - 2, replace=False, p=base / base.sum())
        ids[t] = [first, partner, *rest]
    return ids


def test_expert_placement_copy_matches_reference():
    E, n_cols = 64, 8
    ids = _skewed_routing(E)
    load, co = ep.routing_stats(ids, E)
    j_load, j_co = j_ep.routing_stats(ids, E)
    np.testing.assert_array_equal(load, j_load)
    np.testing.assert_array_equal(co, j_co)
    perm = ep.place_experts(load, co, n_cols)
    np.testing.assert_array_equal(perm, j_ep.place_experts(j_load, j_co,
                                                           n_cols))
    naive = np.arange(E)
    for pl in (naive, perm):
        assert ep.max_column_load(load, pl, n_cols) == \
            j_ep.max_column_load(load, pl, n_cols)
    assert sorted(perm.tolist()) == list(range(E))
    assert ep.max_column_load(load, perm, n_cols) < \
        ep.max_column_load(load, naive, n_cols)


def test_apply_placement_shapes():
    w = np.arange(8 * 2 * 3).reshape(8, 2, 3)
    perm = np.asarray([7, 6, 5, 4, 3, 2, 1, 0])
    ref = j_ep.apply_placement({"w_in": jnp.asarray(w), "b": jnp.ones(8)},
                               perm)
    for tree in ({"w_in": w, "b": np.ones(8)},
                 {"w_in": torch.from_numpy(w), "b": torch.ones(8)}):
        out = ep.apply_placement(tree, perm)
        np.testing.assert_array_equal(np.asarray(out["w_in"]),
                                      np.asarray(ref["w_in"]))
        np.testing.assert_array_equal(np.asarray(out["b"]),
                                      np.asarray(ref["b"]))
    stacked = torch.from_numpy(np.arange(2 * 8 * 2 * 3).reshape(2, 8, 2, 3))
    out = ep.apply_placement({"w": stacked}, perm)["w"]
    assert torch.equal(out[1, 0], stacked[1, 7])


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
    assert [(n, len(ls)) for n, _, ls in model.stacks] == [("moe", 1)]
