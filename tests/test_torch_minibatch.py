"""The minibatch_lg neighbour-sampler batch through the port's GNNs,
against the JAX package on the CPU.

`make_graph_batch("minibatch_lg", reduced=True)` (4,000 nodes, 40,000
edges, 64 seeds, fan-outs 15 and 10) built by both packages: bit for bit,
and at the cell's analytic pad (`launch.cells.pad_graph_batch`); GCN at
`gcn_cora.smoke()`'s widths with the shape's 602 input features and 41
classes, and EGNN's smoke config, forward on it (through `aggregate`'s op,
its plain version here, and through `use_kernel=False`) against the
reference forwards with weights carried by `from_jax`, within 1e-5 of the
largest magnitude (tests/test_torch_gnn.py's tolerance); GCN's loss and
every gradient of one training step against `jax.value_and_grad`
(tests/test_torch_train_models.py's tolerances), and one AdamW step of
the port's Trainer on the batch with a finite loss.
"""
import dataclasses

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import egnn as j_egnn_cfg  # noqa: E402
from repro.configs import gcn_cora as j_gcn_cfg  # noqa: E402
from repro.data import graphs as j_graphs  # noqa: E402
from repro.models.gnn import egnn as j_egnn  # noqa: E402
from repro.models.gnn import gcn as j_gcn  # noqa: E402

from repro_torch.configs import egnn as egnn_cfg  # noqa: E402
from repro_torch.configs import gcn_cora as gcn_cfg  # noqa: E402
from repro_torch.data import graphs  # noqa: E402
from repro_torch.launch.cells import (GNN_SHAPE_DIMS,  # noqa: E402
                                      pad_graph_batch)
from repro_torch.models.gnn import gcn  # noqa: E402
from repro_torch.models.gnn.egnn import EGNN  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainTask  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

FWD_SHARE = 1e-5                  # tests/test_torch_gnn.py's
GRAD_RTOL, GRAD_SHARE = 1e-4, 1e-6  # tests/test_torch_train_models.py's
GNN_LOSS_RTOL = 1e-5
DIMS = GNN_SHAPE_DIMS["minibatch_lg"]


def _gcn_cfgs():
    """gcn_cora.smoke()'s widths over the shape's features and classes."""
    kw = dict(d_in=DIMS["d_feat"], n_classes=DIMS["n_classes"])
    return (dataclasses.replace(gcn_cfg.smoke(), **kw),
            dataclasses.replace(j_gcn_cfg.smoke(), **kw))


@pytest.fixture(scope="module")
def batches():
    g = graphs.make_graph_batch("minibatch_lg", **DIMS, reduced=True,
                                device="cpu")
    jg = j_graphs.make_graph_batch("minibatch_lg", **DIMS, reduced=True)
    return g, jg


def _share_close(out, ref, what=""):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape and np.isfinite(out).all(), what
    np.testing.assert_allclose(out, ref, rtol=0,
                               atol=FWD_SHARE * np.abs(ref).max(),
                               err_msg=what)


def test_reduced_batch_is_the_references_bit_for_bit(batches):
    g, jg = batches
    for f in dataclasses.fields(g):
        a, b = getattr(g, f.name), getattr(jg, f.name)
        if isinstance(a, torch.Tensor):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                          err_msg=f.name)
        else:
            assert a == b, f.name
    # the sampler's 64 seeds carry the loss
    assert int(g.label_mask.sum()) == 64
    assert g.node_mask.shape[0] % 128 == 0 and g.receivers.shape[0] % 512 == 0


def test_pad_to_the_cell_shape_keeps_the_forward(batches):
    """Padding with masked nodes and edges (the cell's analytic sizes)
    changes no live node's logits."""
    g, jg = batches
    cfg, jcfg = _gcn_cfgs()
    params = jax.jit(j_gcn.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    model = gcn.GCN.from_jax(cfg, params, device="cpu")
    n, e = g.node_mask.shape[0], g.receivers.shape[0]
    big = pad_graph_batch(g, n + 256, e + 1024)
    assert big.node_feat.shape == (n + 256, DIMS["d_feat"])
    assert not big.edge_mask[e:].any() and not big.node_mask[n:].any()
    np.testing.assert_array_equal(model(big)[:n].numpy(), model(g).numpy())
    with pytest.raises(ValueError):
        pad_graph_batch(big, n, e)


@pytest.mark.parametrize("name", ["gcn", "egnn"])
def test_forward_on_minibatch_lg_matches_reference(batches, name):
    g, jg = batches
    if name == "gcn":
        cfg, jcfg = _gcn_cfgs()
        cls, jmod = gcn.GCN, j_gcn
    else:
        cfg, jcfg = egnn_cfg.smoke(), j_egnn_cfg.smoke()
        cls, jmod = EGNN, j_egnn
    params = jax.jit(jmod.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    ref = jax.jit(jmod.forward, static_argnums=1)(params, jcfg, jg)
    model = cls.from_jax(cfg, params, device="cpu")
    for out in (model(g), model(g, use_kernel=False)):
        if name == "egnn":
            _share_close(out[0].numpy(), ref[0], "egnn energy")
            _share_close(out[1].numpy(), ref[1], "egnn positions")
        else:
            assert out.shape == (g.node_mask.shape[0], DIMS["n_classes"])
            _share_close(out.numpy(), ref, "gcn logits")


def _paths(tree) -> dict:
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_gcn_training_step_on_minibatch_lg_matches_jax(batches):
    """One step's loss and gradients against jax.value_and_grad, then one
    step of the port's Trainer on the batch."""
    g, jg = batches
    cfg, jcfg = _gcn_cfgs()
    jp = jax.jit(j_gcn.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    (jl, jm), jgr = jax.jit(jax.value_and_grad(
        lambda p, b: j_gcn.loss_fn(p, jcfg, b), has_aux=True))(jp, jg)
    model = gcn.GCN.from_jax(cfg, jp, device="cpu")
    paths, leaves = zip(*leaves_with_path(model.param_tree()))
    for p in leaves:
        p.requires_grad_(True)
    loss, metrics = gcn.loss_fn(model, g)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(jl),
                               rtol=GNN_LOSS_RTOL)
    assert sorted(metrics) == sorted(jm)
    jgp = _paths(jgr)
    assert sorted(jgp) == sorted(paths)
    for k, gr in zip(paths, grads):
        np.testing.assert_allclose(
            gr.numpy(), jgp[k], rtol=GRAD_RTOL,
            atol=GRAD_SHARE * float(np.abs(jgp[k]).max()), err_msg=k)

    def forever():
        while True:
            yield g
    task = TrainTask(name="gcn-cora",
                     init_params=lambda gen: gcn.GCN.random(cfg, gen),
                     loss_fn=gcn.loss_fn, batches=forever(), lr=1e-3,
                     warmup=1, total_steps=2, device="cpu")
    out = Trainer(task).run(steps=2)
    losses = [r["loss"] for r in out["log"]]
    assert len(losses) == 2 and all(np.isfinite(losses))
