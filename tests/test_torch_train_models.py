"""Training forwards of the PyTorch port against the JAX package: one step's
loss and gradients of xDeepFM, the four GNNs (and NequIP's forces) and the
dense LM against `jax.value_and_grad` of the reference's `loss_fn` from the
same carried-across weights and numpy inputs; the segment sum's backward
(`SegmentSum`) against autograd through its plain version; the guard that
keeps the kernels without a backward out of autograd; and the reference's
planted-signal training run."""
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
from repro.data.recsys import click_batches as j_click_batches  # noqa: E402
from repro.models.gnn import egnn as j_egnn  # noqa: E402
from repro.models.gnn import equiformer_v2 as j_eq  # noqa: E402
from repro.models.gnn import gcn as j_gcn  # noqa: E402
from repro.models.gnn import nequip as j_nequip  # noqa: E402
from repro.models.gnn.common import GraphBatch as JGraphBatch  # noqa: E402
from repro.models import transformer as j_lm  # noqa: E402
from repro.models.recsys import xdeepfm as j_xd  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.optim import adamw_update as j_adamw_update  # noqa: E402

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data.recsys import click_batches  # noqa: E402
from repro_torch.kernels.segment_spmm import ops as seg_ops  # noqa: E402
from repro_torch.kernels.segment_spmm.ref import (  # noqa: E402
    segment_spmm_backward, segment_spmm_plan_ref, segment_spmm_ref)
from repro_torch.models import transformer as lm  # noqa: E402
from repro_torch.models.gnn import egnn, equiformer_v2, gcn, nequip  # noqa: E402
from repro_torch.models.gnn.common import GraphBatch  # noqa: E402
from repro_torch.models.recsys import xdeepfm as xd  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update  # noqa: E402
from repro_torch.tree import leaves_with_path, tree_unflatten  # noqa: E402

# one step's gradients: XLA and PyTorch take the same float32 sums in other
# orders; each leaf within rtol 1e-4 and atol 1e-6 x its largest |g|
GRAD_RTOL, GRAD_SHARE = 1e-4, 1e-6
LOSS_TOL = 1e-6           # the loss, relative: one float32 reduction's order
# the GNN losses (float32 energies of order 1-100 squared; gcn's
# cross-entropy ~2): relative
GNN_LOSS_RTOL = 1e-5
# the LM's gradients: the reference's init (`_dense` reads the fan-in off
# the layer-stacked axis, so each matrix is drawn at 1/sqrt(n_layers))
# saturates the attention, and float32 order differences grow: against the
# float64 gradient, XLA's float32 one is 0.1-1.5e-5 of each leaf's largest
# |g| off and the port's 0.2-1.6e-5 (measured); held at 1e-4
LM_GRAD_SHARE = 1e-4


def jax_paths(tree) -> dict:
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def port_grads(model, loss_fn, batch):
    """(loss, metrics, {path: grad}) of one step through the port."""
    tree = model.param_tree()
    paths, leaves = zip(*leaves_with_path(tree))
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = loss_fn(model, batch)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return loss.detach(), metrics, {
        k: (np.zeros(p.shape, np.float32) if g is None else g.numpy())
        for k, p, g in zip(paths, leaves, grads)}


def assert_grads_close(jg: dict, tg: dict, share: float = GRAD_SHARE):
    assert sorted(jg) == sorted(tg)
    for k in jg:
        top = float(np.abs(jg[k]).max())
        np.testing.assert_allclose(tg[k], jg[k], rtol=GRAD_RTOL,
                                   atol=share * top, err_msg=k)


# ---------------------------------------------------------------------------
# xDeepFM
# ---------------------------------------------------------------------------

def test_xdeepfm_loss_and_grads_match_jax():
    """The batch of tests/test_models_recsys.py::test_smoke_train_step."""
    cfg = get_arch("xdeepfm").smoke()
    jcfg = j_get_arch("xdeepfm").smoke()
    jp = j_xd.init_params(jcfg, jax.random.PRNGKey(0))
    batch = next(j_click_batches(jcfg.vocab_sizes, jcfg.n_dense, 32, seed=0))
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p, b: j_xd.loss_fn(p, jcfg, b), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    model = xd.XDeepFM.from_jax(cfg, jp, device="cpu")
    tl, tm, tg = port_grads(
        model, xd.loss_fn, {k: torch.from_numpy(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_TOL)
    assert float(tm["acc"]) == float(jm["acc"])
    assert_grads_close(jax_paths(jg), tg)
    # dense_proj is a parameter the forward never reads: a zero gradient
    assert not tg["dense_proj"].any()


def test_xdeepfm_param_tree_is_the_modules_tensors():
    cfg = get_arch("xdeepfm").smoke()
    model = xd.XDeepFM.random(cfg, torch.Generator().manual_seed(0))
    tree = model.param_tree()
    leaves = dict(leaves_with_path(tree))
    assert sorted(leaves) == sorted(jax_paths(j_xd.init_params(
        j_get_arch("xdeepfm").smoke(), jax.random.PRNGKey(0))))
    # no copies: the tree's leaves are the module's parameters, frozen
    # until a trainer turns them on
    ids = {id(p) for p in model.parameters()}
    assert all(id(t) in ids and not t.requires_grad for t in leaves.values())


def test_training_learns_planted_signal():
    """tests/test_models_recsys.py::test_training_learns_planted_signal
    through the port: AdamW on the plain path, 30 steps at batch 256."""
    cfg = get_arch("xdeepfm").smoke()
    model = xd.XDeepFM.random(cfg, torch.Generator().manual_seed(0))
    tree = model.param_tree()
    leaves = [p for _, p in leaves_with_path(tree)]
    for p in leaves:
        p.requires_grad_(True)
    opt = adamw_init(tree)
    it = click_batches(cfg.vocab_sizes, cfg.n_dense, 256, seed=1)
    losses = []
    for _ in range(30):
        batch = {k: torch.from_numpy(v) for k, v in next(it).items()}
        loss, _ = xd.loss_fn(model, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(leaves, grads)]
        adamw_update(tree_unflatten(tree, grads), opt, tree, lr=1e-3,
                     weight_decay=0.0)
        losses.append(float(loss.detach()))
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


# ---------------------------------------------------------------------------
# GNNs
# ---------------------------------------------------------------------------

def make_graph_np(n=24, e=48, n_graphs=2, d_feat=16, n_classes=4, seed=0):
    """tests/test_models_gnn.py's make_graph, as numpy arrays."""
    r = np.random.default_rng(seed)
    return dict(
        node_feat=r.normal(size=(n, d_feat)).astype(np.float32),
        positions=r.normal(size=(n, 3)).astype(np.float32),
        senders=r.integers(0, n, e).astype(np.int32),
        receivers=r.integers(0, n, e).astype(np.int32),
        edge_mask=np.ones(e, bool), node_mask=np.ones(n, bool),
        labels=r.integers(0, n_classes, n).astype(np.int32),
        label_mask=np.ones(n, bool),
        graph_ids=(np.arange(n) % n_graphs).astype(np.int32),
        n_graphs=n_graphs,
        species=r.integers(0, 5, n).astype(np.int32))


def both_graphs(**kw):
    a = make_graph_np(**kw)
    jg = JGraphBatch(**{k: (v if k == "n_graphs" else jnp.asarray(v))
                        for k, v in a.items()})
    tg = GraphBatch(**{k: (v if k == "n_graphs" else torch.from_numpy(v))
                       for k, v in a.items()})
    return jg, tg


GNNS = {"gcn-cora": (gcn, j_gcn, gcn.GCN),
        "egnn": (egnn, j_egnn, egnn.EGNN),
        "nequip": (nequip, j_nequip, nequip.NequIP),
        "equiformer-v2": (equiformer_v2, j_eq, equiformer_v2.EquiformerV2)}


@pytest.mark.parametrize("arch", sorted(GNNS))
def test_gnn_loss_and_grads_match_jax(arch):
    """tests/test_models_gnn.py::test_smoke_train_step's graph; the port's
    `aggregate` on the CPU takes the plain segment sum."""
    mod, jmod, cls = GNNS[arch]
    cfg, jcfg = get_arch(arch).smoke(), j_get_arch(arch).smoke()
    jg, tg = both_graphs(d_feat=getattr(cfg, "d_in", 16),
                         n_classes=getattr(cfg, "n_classes", 4))
    jp = jmod.init_params(jcfg, jax.random.PRNGKey(0))
    (jl, jm), jgr = jax.jit(jax.value_and_grad(
        lambda p, g: jmod.loss_fn(p, jcfg, g), has_aux=True))(jp, jg)
    model = cls.from_jax(cfg, jp, device="cpu")
    tl, tm, tgr = port_grads(model, mod.loss_fn, tg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=GNN_LOSS_RTOL)
    assert sorted(tm) == sorted(jm)
    assert_grads_close(jax_paths(jgr), tgr)


def test_nequip_forces_match_jax():
    cfg, jcfg = get_arch("nequip").smoke(), j_get_arch("nequip").smoke()
    jg, tg = both_graphs()
    jp = j_nequip.init_params(jcfg, jax.random.PRNGKey(0))
    je, jf = jax.jit(lambda p, g: j_nequip.energy_and_forces(p, jcfg, g))(
        jp, jg)
    model = nequip.NequIP.from_jax(cfg, jp, device="cpu")
    te, tf = nequip.energy_and_forces(model, tg)
    np.testing.assert_allclose(float(te), float(je), rtol=1e-5)
    top = float(np.abs(np.asarray(jf)).max())
    np.testing.assert_allclose(tf.numpy(), np.asarray(jf), rtol=GRAD_RTOL,
                               atol=GRAD_SHARE * top)
    assert tg.positions.grad is None and not tg.positions.requires_grad


# ---------------------------------------------------------------------------
# dense LM
# ---------------------------------------------------------------------------

LM_CFG = dict(name="t", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
              d_head=16, d_ff=64, vocab_size=128, dtype="float32")


@pytest.mark.parametrize("ce_chunk,remat", [(0, False), (4, False),
                                            (4, True)])
def test_lm_loss_and_grads_match_jax(ce_chunk, remat):
    """The dense LM of tests/test_runtime.py at batch 8 x 16 tokens, with
    the chunked cross-entropy off and on, and each layer recomputed."""
    jcfg = j_lm.LMConfig(**LM_CFG, ce_chunk=ce_chunk)
    cfg = lm.LMConfig(**LM_CFG, ce_chunk=ce_chunk)
    jp = j_lm.init_params(jcfg, jax.random.PRNGKey(0))
    r = np.random.default_rng(1)
    toks = r.integers(0, 128, (8, 17)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -100                      # masked labels
    (jl, jm), jgr = jax.jit(jax.value_and_grad(
        lambda p: j_lm.loss_fn(p, jcfg, jnp.asarray(toks[:, :-1]),
                               jnp.asarray(labels), remat=remat),
        has_aux=True))(jp)
    model = lm.Transformer.from_jax(cfg, jp, device="cpu")
    tl, tm, tgr = port_grads(
        model, lambda m, b: lm.loss_fn(m.params, cfg, *b, remat=remat),
        (torch.from_numpy(toks[:, :-1]), torch.from_numpy(labels)))
    np.testing.assert_allclose(float(tl), float(jl), rtol=LOSS_TOL)
    assert sorted(tm) == sorted(jm)
    assert_grads_close(jax_paths(jgr), tgr, LM_GRAD_SHARE)


def test_lm_loss_rejects_unported_layers():
    """Until the MoE layers were ported `hidden_forward` refused a MoE
    config (NotImplementedError); now it takes one: the hidden states of
    the dense LM's widths with two MoE layers equal the reference's
    `hidden_forward`, and parameters without the config's leaves raise
    a KeyError."""
    kw = dict(LM_CFG, name="moe", moe=True, n_experts=4, top_k=2,
              moe_d_ff=16)
    jcfg, cfg = j_lm.LMConfig(**kw), lm.LMConfig(**kw)
    jp = j_lm.init_params(jcfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(2).integers(0, 128, (2, 8)).astype(np.int32)
    ref = np.asarray(jax.jit(lambda p, t: j_lm.hidden_forward(p, jcfg, t))(
        jp, toks))
    model = lm.Transformer.from_jax(cfg, jp, device="cpu")
    out = lm.hidden_forward(model.params, cfg, torch.from_numpy(toks))
    assert tuple(out.shape) == (2, 8, 32)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-4)
    with pytest.raises(KeyError):
        lm.hidden_forward({}, cfg, torch.zeros((1, 4), dtype=torch.int32))


# ---------------------------------------------------------------------------
# the segment sum's backward, and the guard on the other kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("e,n,d", [(300, 40, 5), (64, 7, 1), (1, 3, 2)])
def test_segment_sum_function_backward(monkeypatch, e, n, d):
    """`SegmentSum` (the op's autograd.Function on the card), with the
    kernel replaced by the plain version that reads the plan as it does,
    against autograd through `segment_spmm_ref`: masked edges and
    receivers outside [0, n) get a zero gradient."""
    r = np.random.default_rng(e)
    recv = torch.from_numpy(r.integers(-3, n + 3, e).astype(np.int32))
    mask = torch.from_numpy(r.uniform(size=e) < 0.8)
    vals = torch.from_numpy(r.normal(size=(e, d)).astype(np.float32))
    up = torch.from_numpy(r.normal(size=(n, d)).astype(np.float32))
    monkeypatch.setattr(seg_ops, "segment_spmm_kernel",
                        lambda v, plan, n: segment_spmm_plan_ref(
                            v, plan.order, plan.offsets))
    plan = seg_ops.segment_plan(recv, mask, n)
    v1 = vals.clone().requires_grad_(True)
    out = seg_ops.SegmentSum.apply(v1, plan, n)
    (g1,) = torch.autograd.grad((out * up).sum(), v1)
    v2 = vals.clone().requires_grad_(True)
    ref = segment_spmm_ref(v2, recv, mask, n)
    (g2,) = torch.autograd.grad((ref * up).sum(), v2)
    torch.testing.assert_close(out, ref, rtol=1e-6, atol=1e-6)
    assert torch.equal(g1, g2)        # both gather the same rows exactly
    dead = ~mask | (recv < 0) | (recv >= n)
    assert dead.any() and not g1[dead].any()
    assert torch.equal(segment_spmm_backward(up, recv, mask, n), g1)


@pytest.mark.parametrize("grad_mode", [True, False])
def test_guard_predicate(grad_mode):
    """`forbid_backward` (which gather_rows, bag_sum, cin_layer,
    flash_attention and jaccard_distance call on the card before they
    launch) raises exactly when autograd would record the op."""
    a = torch.zeros(3, requires_grad=True)
    b = torch.zeros(3)
    with torch.set_grad_enabled(grad_mode):
        assert kernels.needs_backward(a, b, None) == grad_mode
        assert not kernels.needs_backward(b, None)
        if grad_mode:
            with pytest.raises(RuntimeError, match="no backward.*plain"):
                kernels.forbid_backward("gather_rows", "plain route", b, a)
        else:
            kernels.forbid_backward("gather_rows", "plain route", b, a)
    with torch.inference_mode():
        assert not kernels.needs_backward(a)


def test_guarded_ops_call_the_guard():
    """Each kernel op without a backward calls the guard on its card path,
    before its kernel (read from the source: the card path cannot run
    here)."""
    import inspect
    from repro_torch.kernels.cin import ops as cin_ops
    from repro_torch.kernels.embedding_bag import ops as emb_ops
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.jaccard import ops as jac_ops
    for fn, kernel in ((emb_ops.gather_rows, "gather_rows_kernel"),
                       (emb_ops.bag_sum, "bag_sum_kernel"),
                       (cin_ops.cin_layer, "cin_layer_kernel"),
                       (fa_ops.flash_attention, "flash_attention_kernel"),
                       (jac_ops.jaccard_distance,
                        "jaccard_distance_kernel")):
        src = inspect.getsource(fn)
        assert "forbid_backward(" in src, fn.__name__
        assert src.index("forbid_backward(") < src.index(kernel + "("), \
            fn.__name__
    # on the CPU the plain versions stay differentiable
    table = torch.randn(6, 4, requires_grad=True)
    out = emb_ops.gather_rows(table, torch.tensor([0, 5, 5]))
    (g,) = torch.autograd.grad(out.sum(), table)
    assert float(g[5].sum()) == 8.0


def test_one_adamw_step_from_grads_matches_jax():
    """The xDeepFM smoke step end to end: gradients, then AdamW with
    clipping, parameters after the step against the reference's."""
    cfg = get_arch("xdeepfm").smoke()
    jcfg = j_get_arch("xdeepfm").smoke()
    jp = j_xd.init_params(jcfg, jax.random.PRNGKey(0))
    batch = next(j_click_batches(jcfg.vocab_sizes, jcfg.n_dense, 64, seed=2))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (_, _), jg = jax.jit(jax.value_and_grad(
        lambda p, b: j_xd.loss_fn(p, jcfg, b), has_aux=True))(jp, jb)
    jp2, _, jm = jax.jit(lambda g, p: j_adamw_update(
        g, j_adamw_init(p), p, lr=1e-2))(jg, jp)
    model = xd.XDeepFM.from_jax(cfg, jp, device="cpu")
    tree = model.param_tree()
    _, _, tg = port_grads(model, xd.loss_fn,
                          {k: torch.from_numpy(v) for k, v in batch.items()})
    paths = [p for p, _ in leaves_with_path(tree)]
    grads = tree_unflatten(tree, [torch.from_numpy(tg[p]) for p in paths])
    _, _, tm = adamw_update(grads, adamw_init(tree), tree, lr=1e-2)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-5)
    # the first step moves each entry by lr x g / (|g| + eps) (+ decay):
    # for a gradient entry near eps, its float32 order difference (within
    # GRAD_SHARE of the leaf's largest |g|) moves the step by up to a few
    # 1e-4 of lr; held at lr / 1000
    want = jax_paths(jp2)
    for p, leaf in leaves_with_path(tree):
        np.testing.assert_allclose(leaf.detach().numpy(), want[p],
                                   rtol=1e-5, atol=1e-2 / 1000, err_msg=p)
