"""Node and edge sharding of the GNN train step on a 2 x 2 mesh of gloo
ranks (one process a rank, on the CPU): each rank computes on its block of
the graph under the reference's `graph_batch_specs` layout (the edge
arrays over "model", the node arrays over "data") through
`models.gnn.common.MeshGraph`, for the four GNNs at small widths in
float32 (`gcn-cora` at 16 channels, `egnn-smoke`, `nequip-smoke`,
`equiformer-v2-smoke`) on a batch of 8 small graphs (256 nodes, 576
edges, the edges shuffled so that every rank's edge block holds live
edges of both node blocks, some edges and nodes padded out); GCN also
on 251 nodes, which do not split over "data" and stay whole on every
rank.

Held against:

- the reference's sharded program: one JAX subprocess on 4 virtual CPU
  devices (XLA_FLAGS must not leak into this process) jits
  `jax.value_and_grad` of each reference `loss_fn` with ``in_shardings``
  of the replicated `gnn_rules` specs and the graph layout; the ranks'
  loss and each leaf's gradient as AdamW takes it (`Trainer._mesh_grads`:
  after the data axes' sum and division) within TOL;
- the port's one-device `loss_fn` and its gradients, within TOL.

A gradient is held by its relative L2 (`_rel`): AdamW's update does not
change when a gradient is scaled, so parameters after a step could not
show a gradient off by a whole factor. A `MetaMesh` rank running the same
step counts the calls and bytes of the gloo rank; the all-gathers are the
node rows each layer reads (no edge array is ever gathered), and no rank
holds a whole node or edge array that the layout splits. The weights are
the reference's `init_params`, carried over by `from_jax`; the ranks
import this module, so JAX is imported only in fixtures and the
subprocess.
"""
import dataclasses
import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import egnn as egnn_cfg  # noqa: E402
from repro_torch.configs import equiformer_v2 as eq_cfg  # noqa: E402
from repro_torch.configs import gcn_cora as gcn_cfg  # noqa: E402
from repro_torch.configs import nequip as nequip_cfg  # noqa: E402
from repro_torch.data.graphs import make_graph_batch  # noqa: E402
from repro_torch.launch import cells  # noqa: E402
from repro_torch.launch.mesh import (MetaMesh,  # noqa: E402
                                     make_production_mesh, spawn)
from repro_torch.models import meta_generator  # noqa: E402
from repro_torch.models.gnn import common  # noqa: E402
from repro_torch.models.gnn.common import GraphBatch, MeshGraph  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainTask  # noqa: E402
from repro_torch.sharding.rules import (Blocks, block_view,  # noqa: E402
                                        gnn_rules, local_slice,
                                        make_param_specs)
from repro_torch.tree import leaves_with_path, tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESH = (2, 2)
AXES = ("data", "model")
# float32 on both sides, the same sums in other orders and over other
# splits: the worst relative L2 measured over every leaf was about 1e-6
TOL = 1e-5
GCN_OVER = dict(d_in=16, n_classes=4)
# name: (config module, overrides, model module, class, nodes, edges)
CASES = {
    "gcn": ("gcn_cora", GCN_OVER, "gcn", "GCN", 256, 576),
    "gcn-whole-nodes": ("gcn_cora", GCN_OVER, "gcn", "GCN", 251, 576),
    "egnn": ("egnn", {}, "egnn", "EGNN", 256, 576),
    "nequip": ("nequip", {}, "nequip", "NequIP", 256, 576),
    "equiformer-v2": ("equiformer_v2", {}, "equiformer_v2", "EquiformerV2",
                      256, 576),
}
CONFIGS = {"gcn_cora": gcn_cfg, "egnn": egnn_cfg, "nequip": nequip_cfg,
           "equiformer_v2": eq_cfg}
TIMEOUT, JOIN = 120.0, 300.0


def case_cfg(name: str):
    cfg_mod, over, *_ = CASES[name]
    return dataclasses.replace(CONFIGS[cfg_mod].smoke(), **over)


def case_module(name: str):
    _, _, mod, cls, *_ = CASES[name]
    m = importlib.import_module("repro_torch.models.gnn." + mod)
    return m, getattr(m, cls)


def case_graph(name: str) -> dict:
    """The batch as numpy arrays: 8 molecules of 30 atoms, the edges
    shuffled, every seventh edge masked out, padded to the case's nodes
    and edges (padded nodes masked, padded edges on node 0)."""
    *_, n, e = CASES[name]
    g = make_graph_batch("molecule", d_feat=16, n_classes=4, seed=3,
                         reduced=True, device="cpu")
    perm = torch.from_numpy(np.random.default_rng(11).permutation(
        g.senders.shape[0]))
    mask = g.edge_mask[perm].clone()
    mask[::7] = False
    g = dataclasses.replace(g, senders=g.senders[perm],
                            receivers=g.receivers[perm], edge_mask=mask)
    g = cells.pad_graph_batch(g, n, e)
    out = {f: getattr(g, f).numpy() for f in cells.NODE_FIELDS
           + cells.EDGE_FIELDS}
    out["n_graphs"] = g.n_graphs
    return out


def torch_graph(arrays: dict, device="cpu") -> GraphBatch:
    return GraphBatch(**{f: torch.from_numpy(arrays[f]).to(device)
                         for f in cells.NODE_FIELDS + cells.EDGE_FIELDS},
                      n_graphs=int(arrays["n_graphs"]))


def mesh_grads(mesh, model, graph: GraphBatch, loss_fn):
    """One mesh step's (metrics, gradients as AdamW takes them {path:
    tensor}) on ``mesh``'s rank over its `graph_block` of ``graph``."""
    specs = make_param_specs(model.param_tree(), mesh, gnn_rules(mesh))
    blocks = tree_map(lambda t, s: local_slice(t.detach(), s, mesh)
                      .clone().requires_grad_(True),
                      model.param_tree(), specs)
    view = block_view(model, Blocks(blocks, specs, mesh))
    task = TrainTask(name="gnn", init_params=None, loss_fn=loss_fn,
                     batches=iter(()), device=mesh.device, param_specs=specs)
    block = cells.graph_block(graph, cells.graph_specs(
        graph.node_mask.shape[0], graph.n_graphs, mesh), mesh)
    ef = {"_": torch.zeros((), device=mesh.device)}
    metrics, grads, _ = Trainer(task, mesh=mesh)._mesh_grads(
        view, blocks, specs, ef, block, batch_is_local=True)
    return block, metrics, dict(leaves_with_path(grads))


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _rank(mesh, inputs):
    out = {}
    for name, (params, arrays) in inputs.items():
        mod, cls = case_module(name)
        model = cls.from_jax(case_cfg(name), params, device="cpu")
        gathered = []
        gather = mesh.all_gather

        def counted(t, axes, dim=0, **kw):
            res = gather(t, axes, dim, **kw)
            gathered.append(tuple(res.shape))
            return res
        mesh.all_gather = counted
        mesh.reset_counts()
        try:
            block, metrics, grads = mesh_grads(mesh, model,
                                               torch_graph(arrays),
                                               mod.loss_fn)
        finally:
            mesh.all_gather = gather
        out[name] = dict(
            loss=float(metrics["loss"]),
            grads={p: g.detach().numpy() for p, g in grads.items()},
            calls=dict(mesh.calls), bytes=dict(mesh.bytes),
            gathered=gathered,
            block={f: tuple(getattr(block, f).shape)
                   for f in cells.NODE_FIELDS + cells.EDGE_FIELDS})
    return out


SCRIPT = r"""
import dataclasses, json, os, sys, types
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import importlib
import numpy as np
import jax, jax.numpy as jnp
from functools import partial
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.launch.cells import graph_batch_specs
from repro.models.gnn.common import GraphBatch
from repro.sharding.rules import _path_str, gnn_rules, make_param_specs

cases, fields = json.loads(sys.argv[1]), json.loads(sys.argv[2])
inp, out_path = np.load(sys.argv[3]), sys.argv[4]
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2),
                         ("data", "model"))
ns = lambda s: NamedSharding(mesh, s)
out = {}
for name, (cfg_mod, over, mod_name, _cls, n, e) in cases.items():
    cfg = dataclasses.replace(
        importlib.import_module("repro.configs." + cfg_mod).smoke(), **over)
    mod = importlib.import_module("repro.models.gnn." + mod_name)
    pshape = jax.eval_shape(partial(mod.init_params, cfg),
                            jax.random.PRNGKey(0))
    flat, treedef = jax.tree_util.tree_flatten_with_path(pshape)
    params = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(inp[f"{name}/w/{_path_str(p)}"]) for p, _ in flat])
    g = GraphBatch(**{f: jnp.asarray(inp[f"{name}/g/{f}"]) for f in fields},
                   n_graphs=int(inp[f"{name}/g/n_graphs"]))
    node_ax = "data" if n % 2 == 0 else None
    gspecs = GraphBatch(
        node_feat=P(node_ax, None), positions=P(node_ax, None),
        senders=P("model"), receivers=P("model"), edge_mask=P("model"),
        node_mask=P(node_ax), labels=P(node_ax), label_mask=P(node_ax),
        graph_ids=P(node_ax), n_graphs=g.n_graphs, species=P(node_ax))
    pspecs = make_param_specs(pshape, mesh, gnn_rules(mesh))
    fn = jax.jit(jax.value_and_grad(lambda p, b: mod.loss_fn(p, cfg, b),
                                    has_aux=True),
                 in_shardings=(jax.tree.map(ns, pspecs), jax.tree.map(
                     ns, gspecs, is_leaf=lambda x: isinstance(x, P))))
    with mesh:
        (loss, _), grads = fn(params, g)
    out[f"{name}/loss"] = np.asarray(loss)
    for p, leaf in jax.tree_util.tree_flatten_with_path(grads)[0]:
        out[f"{name}/grad/{_path_str(p)}"] = np.asarray(leaf)
# the reference's graph_batch_specs on the production meshes (described:
# the function reads axis names and sizes only)
specs = {}
for sizes, axes in (((16, 16), ("data", "model")),
                    ((2, 16, 16), ("pod", "data", "model"))):
    stub = types.SimpleNamespace(axis_names=axes,
                                 shape=dict(zip(axes, sizes)))
    for shape in ("full_graph_sm", "minibatch_lg", "ogb_products",
                  "molecule"):
        _, s = graph_batch_specs(shape, stub)
        specs[f"{shape}/{len(sizes)}"] = {
            f: [list(x) if isinstance(x, tuple) else x
                for x in getattr(s, f)] for f in fields}
np.savez(out_path, **out)
json.dump(specs, open(out_path + ".json", "w"))
print("GNN_REF_OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the reference's npz, its graph_batch_specs, every rank's
    results): the JAX subprocess runs while the ranks do."""
    import jax
    from repro.sharding.rules import _path_str
    inputs = {}
    flat = {}
    for name, (cfg_mod, over, mod_name, *_) in CASES.items():
        jmod = importlib.import_module("repro.models.gnn." + mod_name)
        jcfg = dataclasses.replace(importlib.import_module(
            "repro.configs." + cfg_mod).smoke(), **over)
        params = jmod.init_params(jcfg, jax.random.PRNGKey(0))
        params = jax.tree.map(np.asarray, params)
        arrays = case_graph(name)
        inputs[name] = (params, arrays)
        for p, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
            flat[f"{name}/w/{_path_str(p)}"] = leaf
        for f, a in arrays.items():
            flat[f"{name}/g/{f}"] = np.asarray(a)
    d = tmp_path_factory.mktemp("gnn_sharded")
    np.savez(d / "in.npz", **flat)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", SCRIPT, json.dumps(CASES),
         json.dumps(list(cells.NODE_FIELDS + cells.EDGE_FIELDS)),
         str(d / "in.npz"), str(d / "ref.npz")],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        ranks = spawn(MESH, _rank, inputs, device="cpu", timeout=TIMEOUT,
                      join_timeout=JOIN)
        so, se = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert "GNN_REF_OK" in so, so[-1500:] + se[-3000:]
    ref = dict(np.load(d / "ref.npz"))
    specs = json.loads((d / "ref.npz.json").read_text())
    return inputs, ref, specs, ranks


def _rel(got, want) -> float:
    """||got - want|| / ||want|| (the difference's norm where want is
    0)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    diff = float(np.linalg.norm(got - want))
    top = float(np.linalg.norm(want))
    return diff / top if top else diff


def one_device(name: str, params, arrays):
    """The port's one-device loss and gradients {path: array}."""
    mod, cls = case_module(name)
    model = cls.from_jax(case_cfg(name), params, device="cpu")
    leaves = dict(leaves_with_path(model.param_tree()))
    for t in leaves.values():
        t.requires_grad_(True)
    loss, _ = mod.loss_fn(model, torch_graph(arrays))
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    return float(loss.detach()), {p: (torch.zeros_like(t) if g is None
                                      else g)
                         .numpy() for (p, t), g in zip(leaves.items(),
                                                       grads)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_gradients_match_the_reference(runs, name):
    """Every rank's loss and every leaf's gradient, after the Trainer's
    reductions, against the reference's sharded `value_and_grad`."""
    _, ref, _, ranks = runs
    want = {k.split("/grad/", 1)[1]: v for k, v in ref.items()
            if k.startswith(f"{name}/grad/")}
    assert want
    for r in ranks:
        mine = r[name]
        assert _rel(mine["loss"], ref[f"{name}/loss"]) <= TOL
        assert set(mine["grads"]) == set(want)
        for path, g in want.items():
            assert mine["grads"][path].shape == g.shape, path
            assert _rel(mine["grads"][path], g) <= TOL, (path, _rel(
                mine["grads"][path], g))


@pytest.mark.parametrize("name", sorted(CASES))
def test_loss_and_gradients_match_one_device(runs, name):
    inputs, _, _, ranks = runs
    loss, grads = one_device(name, *inputs[name])
    for r in ranks:
        assert _rel(r[name]["loss"], loss) <= TOL
        for path, g in grads.items():
            assert _rel(r[name]["grads"][path], g) <= TOL, path


@pytest.mark.parametrize("name", sorted(CASES))
def test_meta_mesh_counts_the_ranks_collectives(runs, name):
    """A `MetaMesh` rank of the same coordinates running the same step on
    meta tensors counts the gloo rank's calls and bytes."""
    inputs, _, _, ranks = runs
    mod, cls = case_module(name)
    graph = torch_graph(inputs[name][1])
    meta_graph = dataclasses.replace(graph, **{
        f: torch.empty_like(getattr(graph, f), device="meta")
        for f in cells.NODE_FIELDS + cells.EDGE_FIELDS})
    for rank, r in enumerate(ranks):
        mesh = MetaMesh(MESH, AXES, rank=rank)
        model = cls.random(case_cfg(name), meta_generator(0))
        mesh.reset_counts()
        mesh_grads(mesh, model, meta_graph, mod.loss_fn)
        assert dict(mesh.calls) == r[name]["calls"], rank
        assert dict(mesh.bytes) == r[name]["bytes"], rank
        assert r[name]["calls"]["all_reduce"] > 0


# all-gathers a step: the node rows each layer reads (GCN x; EGNN x and
# h; NequIP and Equiformer-v2 the positions once, then h)
GATHERS = {"gcn": lambda cfg: cfg.n_layers,
           "egnn": lambda cfg: 2 * cfg.n_layers,
           "nequip": lambda cfg: 1 + cfg.n_layers,
           "equiformer-v2": lambda cfg: 1 + cfg.n_layers}


@pytest.mark.parametrize("name", sorted(CASES))
def test_no_rank_holds_a_whole_split_array(runs, name):
    """Each rank's batch is its block; the all-gathers are the node rows
    the layers read, and no edge array is gathered."""
    _, _, _, ranks = runs
    *_, n, e = CASES[name]
    split = n % MESH[0] == 0
    for r in ranks:
        block = r[name]["block"]
        for f in cells.EDGE_FIELDS:
            assert block[f][0] == e // MESH[1], f
        for f in cells.NODE_FIELDS:
            assert block[f][0] == (n // MESH[0] if split else n), f
        gathered = r[name]["gathered"]
        assert all(s[0] != e for s in gathered)
        if split:
            assert all(s[0] == n for s in gathered)
            assert len(gathered) == GATHERS[name](case_cfg(name))
        else:
            assert gathered == []


def test_graph_batch_specs_are_the_references(runs):
    _, _, ref_specs, _ = runs
    for key, want in ref_specs.items():
        shape, ndim = key.split("/")
        _, specs = cells.graph_batch_specs(
            shape, make_production_mesh(multi_pod=ndim == "3"))
        got = {f: [list(x) if isinstance(x, tuple) else x
                   for x in getattr(specs, f)]
               for f in cells.NODE_FIELDS + cells.EDGE_FIELDS}
        assert got == want, key
        assert specs.n_graphs == cells.gnn_full_shapes(shape)["n_graphs"]


def test_graph_block_cuts_each_array():
    mesh = MetaMesh(MESH, AXES, rank=3)
    g = torch_graph(case_graph("gcn"))
    block = cells.graph_block(g, cells.graph_specs(256, g.n_graphs, mesh),
                              mesh)
    assert torch.equal(block.labels, g.labels[128:])
    assert torch.equal(block.senders, g.senders[288:])
    assert block.n_nodes == 256 and block.n_graphs == g.n_graphs
    assert block.node_axes == ("data",) and block.edge_axes == ("model",)
    assert block.labels.untyped_storage().data_ptr() != \
        g.labels.untyped_storage().data_ptr()


def test_mesh_graph_refuses_edges_over_the_data_axes():
    mesh = MetaMesh(MESH, AXES)
    g = torch_graph(case_graph("gcn"))
    bad = dataclasses.replace(
        cells.graph_specs(256, g.n_graphs, mesh), senders=cells.P("data"),
        receivers=cells.P("data"), edge_mask=cells.P("data"))
    with pytest.raises(ValueError, match="edges over others"):
        MeshGraph(cells.graph_block(g, bad, mesh))


def test_one_device_mesh_graph_is_the_plain_functions():
    """On a GraphBatch every operation is the one-device function over
    the same tensors."""
    g = torch_graph(case_graph("egnn"))
    mg = MeshGraph(g, g.edge_mask, use_kernel=False)
    assert torch.equal(mg.edge_mask, g.edge_mask)
    assert torch.equal(mg.receivers,
                       torch.where(g.edge_mask, g.receivers, 0))
    x = torch.randn(256, 3, generator=torch.Generator().manual_seed(0))
    assert mg.rows(x) is x and mg.trainer_loss(x) is x
    scores = torch.randn(576, 2, generator=torch.Generator().manual_seed(1))
    assert torch.equal(mg.edge_softmax(scores), common.edge_softmax(
        scores, g.receivers, g.edge_mask, 256))
    assert torch.equal(mg.aggregate(x[g.senders], reduce="mean"),
                       common.aggregate(x[g.senders], g.receivers,
                                        g.edge_mask, 256, reduce="mean",
                                        use_kernel=False))
    assert torch.equal(mg.pool(x[:, 0]), common.segment_sum(
        x[:, 0], g.graph_ids, g.n_graphs))
