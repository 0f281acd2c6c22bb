"""The port's sharding rules and meshes against the JAX package's.

`make_param_specs` with `lm_rules` (fsdp both ways), `gnn_rules` and
`recsys_rules` on the 16 x 16, 2 x 16 x 16, 2 x 4 and 8 x 1 meshes: the
port's spec tree equals the JAX one, leaf path by leaf path, for the five
LM configs at their assigned (full) sizes, the four GNNs and xDeepFM. The
JAX rules read only ``mesh.shape`` and ``mesh.axis_names``, so a stub
mesh serves them and no 256-device JAX process is needed; the port's side
reads a `MeshShape`. The full configs' shapes come from `jax.eval_shape`
(671B parameters are not built); at the smoke sizes the port's own models'
`param_tree()` is held to the same specs. Also `make_production_mesh`, the
coordinates and lines of `DeviceMesh`, and `local_slice` / `gather_full`
on a 2 x 4 mesh of gloo ranks.
"""
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.configs import get_arch as j_get_arch  # noqa: E402
from repro.sharding import rules as j_rules  # noqa: E402

from repro_torch.configs import ARCH_IDS, get_arch  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.mesh import (MeshShape, make_local_mesh,  # noqa: E402
                                     make_production_mesh, spawn)
from repro_torch.sharding import rules  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "8x1": ((8, 1), ("data", "model"))}


def _j_init(arch_id: str):
    """The reference's init_params of an arch id."""
    import importlib
    fam = j_get_arch(arch_id).family
    mod = {"lm": "repro.models.transformer",
           "recsys": "repro.models.recsys.xdeepfm"}.get(fam)
    if mod is None:
        mod = "repro.models.gnn." + train.GNN_MODULES[arch_id].replace(
            "-", "_")
    return importlib.import_module(mod).init_params


def _j_rules(arch_id: str, mesh, fsdp: bool):
    fam = j_get_arch(arch_id).family
    return {"lm": lambda: j_rules.lm_rules(mesh, fsdp=fsdp),
            "gnn": lambda: j_rules.gnn_rules(mesh),
            "recsys": lambda: j_rules.recsys_rules(mesh)}[fam]()


def _rules(arch_id: str, mesh, fsdp: bool):
    fam = get_arch(arch_id).family
    return {"lm": lambda: rules.lm_rules(mesh, fsdp=fsdp),
            "gnn": lambda: rules.gnn_rules(mesh),
            "recsys": lambda: rules.recsys_rules(mesh)}[fam]()


def _j_specs(arch_id: str, cfg, mesh_key: str, fsdp: bool):
    """{path: spec tuple} of the JAX rules over jax.eval_shape of cfg's
    params, and the shape tree."""
    sizes, names = MESHES[mesh_key]
    stub = types.SimpleNamespace(shape=dict(zip(names, sizes)),
                                 axis_names=names)
    shapes = jax.eval_shape(lambda k: _j_init(arch_id)(cfg, k),
                            jax.random.PRNGKey(0))
    specs = j_rules.make_param_specs(shapes, stub,
                                     _j_rules(arch_id, stub, fsdp))
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {j_rules._path_str(p): tuple(s) for p, s in flat}, shapes


def _port_specs(arch_id: str, tree, mesh_key: str, fsdp: bool) -> dict:
    mesh = MeshShape(*MESHES[mesh_key])
    specs = rules.make_param_specs(tree, mesh, _rules(arch_id, mesh, fsdp))
    return {p: tuple(s) for p, s in leaves_with_path(specs)}


def _shape_tree(shapes):
    """A JAX shape tree as nested dicts and lists of objects with a
    ``shape`` (the port's tree functions' layout)."""
    if isinstance(shapes, dict):
        return {k: _shape_tree(v) for k, v in shapes.items()}
    if isinstance(shapes, (list, tuple)):
        return [_shape_tree(v) for v in shapes]
    if shapes is None:
        return None
    return types.SimpleNamespace(shape=tuple(shapes.shape))


CASES = [(a, fsdp) for a in ARCH_IDS
         for fsdp in ((False, True) if get_arch(a).family == "lm"
                      else (False,))]


@pytest.mark.parametrize("arch_id,fsdp", CASES)
@pytest.mark.parametrize("mesh_key", list(MESHES))
def test_param_specs_equal_jax_at_full_size(arch_id, fsdp, mesh_key):
    """Every leaf's spec of the assigned config equals the JAX rules'."""
    cfg = j_get_arch(arch_id).full()
    want, shapes = _j_specs(arch_id, cfg, mesh_key, fsdp)
    got = _port_specs(arch_id, _shape_tree(shapes), mesh_key, fsdp)
    assert got == want
    if get_arch(arch_id).family == "lm" and mesh_key == "16x16":
        # something is sharded at the assigned size
        assert any(any(e is not None for e in s) for s in got.values())


def _port_model(arch_id: str):
    task = train.build_task(arch_id, 1, 2, 8, False, device="cpu")
    return task.init_params(torch.Generator().manual_seed(0))


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_port_models_param_trees_take_the_same_specs(arch_id):
    """The port's own `param_tree()` at the smoke config (float32, as
    `build_task` builds it) has JAX's leaf paths and shapes, and takes
    the JAX rules' specs on the 2 x 4 mesh with fsdp."""
    import dataclasses
    cfg = j_get_arch(arch_id).smoke()
    if j_get_arch(arch_id).family == "lm":
        cfg = dataclasses.replace(cfg, dtype="float32")
    want, shapes = _j_specs(arch_id, cfg, "2x4", True)
    tree = _port_model(arch_id).param_tree()
    assert {p: tuple(t.shape) for p, t in leaves_with_path(tree)} == {
        j_rules._path_str(p): tuple(s.shape)
        for p, s in jax.tree_util.tree_flatten_with_path(shapes)[0]}
    assert _port_specs(arch_id, tree, "2x4", True) == want


def test_meshes_match_the_reference():
    """make_production_mesh's shapes and names (the reference's
    `jax.make_mesh` calls, src/repro/launch/mesh.py:11-15); a MeshShape's rank
    coordinates run the last axis fastest, as jax.make_mesh lays out its
    devices; make_local_mesh without a process group is one rank."""
    for multi in (False, True):
        got = make_production_mesh(multi_pod=multi)
        sizes = (2, 16, 16) if multi else (16, 16)
        names = ("pod", "data", "model") if multi else ("data", "model")
        assert got.sizes == sizes and got.axis_names == names
        assert got.shape == dict(zip(names, sizes))
        assert got.size == int(np.prod(sizes))
    m = MeshShape((2, 4), ("data", "model"))
    devs = np.arange(8).reshape(2, 4)
    for r in range(8):
        d, c = np.argwhere(devs == r)[0]
        assert m.coords(r) == {"data": d, "model": c}
        assert m.index_of(r, ("data", "model")) == r
        assert m.index_of(r, ("model", "data")) == c * 2 + d
    local = make_local_mesh(device="cpu")
    assert local.shape == {"data": 1} and local.rank == 0
    t = torch.arange(6.0)
    assert torch.equal(local.all_reduce(t, "data"), t)
    assert local.calls == {}
    assert rules.batch_axis(MeshShape((2, 16, 16), ("pod", "data", "model"))
                            ) == j_rules.batch_axis(types.SimpleNamespace(
                                axis_names=("pod", "data", "model")))
    with pytest.raises(ValueError, match="axis"):
        m.axes("pipe")


SPECS = [rules.P("data", "model"), rules.P("model", None),
         rules.P(("data", "model"), None), rules.P(None, ("model", "data")),
         rules.P(None, None)]


def _rank_place(mesh):
    whole = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    out = []
    for spec in SPECS:
        block = rules.local_slice(whole, spec, mesh).clone()
        out.append((block, rules.gather_full(block, spec, mesh)))
    return mesh.axis_index("data"), mesh.axis_index("model"), out, \
        dict(mesh.calls)


def test_local_slice_and_gather_full_on_a_mesh():
    """Each rank's block is its coordinate's slice (tuple axes in the
    tuple's order, first axis slowest) and `gather_full` gives every rank
    the whole tensor back."""
    whole = torch.arange(8 * 16, dtype=torch.float32).reshape(8, 16)
    for d, c, out, calls in spawn((2, 4), _rank_place, device="cpu",
                                  timeout=60.0, join_timeout=200.0):
        for spec, (block, full) in zip(SPECS, out):
            assert torch.equal(full, whole), spec
            k = {"data": d, "model": c}
            want = whole
            for dim, ax in enumerate(spec):
                if ax is None:
                    continue
                axes = ax if isinstance(ax, tuple) else (ax,)
                n = int(np.prod([{"data": 2, "model": 4}[a] for a in axes]))
                i = 0
                for a in axes:
                    i = i * {"data": 2, "model": 4}[a] + k[a]
                step = whole.shape[dim] // n
                want = want.narrow(dim, i * step, step)
            assert torch.equal(block, want), spec
        assert calls == {"all_gather": 5}


def test_local_slice_refuses_a_dim_that_does_not_divide():
    """A batch of 3 rows on 2 data ranks, or a spec naming an axis the
    mesh lacks, raises instead of dropping rows."""
    mesh = MeshShape((2, 1), ("data", "model"))
    mesh.axis_index = lambda axes: 0
    with pytest.raises(ValueError, match="does not divide"):
        rules.local_slice(torch.zeros(3, 4), rules.P("data", None), mesh)
    with pytest.raises(ValueError, match="axis"):
        rules.local_slice(torch.zeros(4, 4), rules.P("pipe", None), mesh)
    assert rules.local_slice(torch.arange(8.0).reshape(4, 2),
                             rules.P("data", None), mesh).shape == (2, 2)
