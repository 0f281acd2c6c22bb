"""The FSDP compute of the port's mesh train step (`Trainer._mesh_step` over
`sharding.rules.Blocks`: each leaf gathered where the loss uses it, a
layer's blocks inside its checkpointed layer, the gradients reduce-scattered
as the backward leaves them and summed over the micro-batches as blocks)
on a 2 x 2 mesh of gloo ranks on the CPU, for granite-3-8b's and
qwen2-moe's smoke configs in float32 (qwen2-moe at a capacity factor with
no drops, its MoE layers expert-parallel), grad_accum 2, one step from the
same weights and batch, held three ways:

- against the reference's sharded program: one JAX subprocess on 4 virtual
  CPU devices (XLA_FLAGS must not leak into this process) jits the body of
  the reference's ZeRO-2 `train_step` (`src/repro/launch/cells.py`):
  `value_and_grad` of `repro.models.transformer.loss_fn` with
  ``remat=True`` over the micro-batches, each micro-batch's gradients and
  their sum constrained to the `lm_rules(fsdp=True)` shardings, the mean,
  then `adamw_update` at the learning rate the port's train cells step
  with (`cell_lr`). Each rank's parameter, ``m`` and ``v`` blocks are its
  spec's slices of the reference's within TOL relative L2 a leaf (the
  moments carry the gradients: 1.7e-6 at most, measured; an element whose
  gradient is near AdamW's eps moves the parameters by the last bits of
  its gradient, one leaf 1.14e-5 from XLA's at a learning rate of 2**-10);
- against the whole-leaf route the FSDP step replaced (`whole_leaf_step`
  below: every leaf gathered whole into the model, the whole gradients
  reduced to the blocks afterwards), within TOL;
- against the port's one-device `Trainer` on the whole batch, within TOL.

On a `MetaMesh` one step's collectives equal the per-layer formula
(`expected_calls`), and no all-gather gives more than one layer's largest
leaf, the embedding or the head. The ranks import this module, so JAX is
imported only in the subprocess.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch import cells  # noqa: E402
from repro_torch.launch.mesh import MetaMesh, spawn  # noqa: E402
from repro_torch.models import transformer as lm  # noqa: E402
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainTask  # noqa: E402
from repro_torch.sharding.rules import (P, data_axes, lm_rules,  # noqa: E402
                                        local_slice, make_param_specs)
from repro_torch.tree import (leaves_with_path, tree_leaves,  # noqa: E402
                              tree_map, tree_unflatten)

ROOT = Path(__file__).resolve().parents[1]
MESH = (2, 2)
ACCUM, MB, SEQ = 2, 4, 16
TOL = 1e-5                # relative L2 a leaf (tests/test_torch_mesh_train)
CASES = {"dense": ("granite-3-8b", {}),
         "moe": ("qwen2-moe-a2.7b", {"capacity_factor": 4.0})}
TIMEOUT, JOIN = 120.0, 300.0


def cell_lr() -> float:
    """The learning rate the train cells' step takes (`launch.cells`: the
    Trainer's schedule at step 1), a float32 value that the schedule gives
    back exactly at step 0 with no warmup."""
    task = cells.build_lm_cell(
        "granite-3-8b", "train_4k", MetaMesh(MESH, ("data", "model")),
        cfg=get_arch("granite-3-8b").smoke(), shape_def=dict(seq=SEQ,
                                                             batch=8),
        knobs=dict(accum=ACCUM, fsdp=True, moments="float32")).parts["task"]
    return float(cosine_schedule(1, peak_lr=task.lr, warmup=task.warmup,
                                 total=task.total_steps))


LR = cell_lr()


def case_cfg(name: str):
    arch, over = CASES[name]
    return dataclasses.replace(get_arch(arch).smoke(), dtype="float32",
                               **over)


def case_inputs(name: str) -> tuple[dict, dict]:
    """(initial weights {path: array}, batch {tokens, labels}) of a case:
    the port's seeded weights, tokens (ACCUM, MB, SEQ) from numpy."""
    cfg = case_cfg(name)
    model = lm.Transformer.random(cfg, seed=3, device="cpu")
    weights = {p: t.numpy().copy()
               for p, t in leaves_with_path(model.param_tree())}
    rng = np.random.default_rng(11)
    toks = rng.integers(0, cfg.vocab_size, (ACCUM, MB, SEQ)).astype(np.int32)
    return weights, {"tokens": toks, "labels": np.roll(toks, -1, axis=-1)}


def make_task(name: str, weights, batch, mesh=None) -> TrainTask:
    """The case's TrainTask: its loss with ``remat`` (the MoE layers
    expert-parallel on a mesh), one batch, the learning rate LR from step
    0; on a ``mesh`` the `lm_rules(fsdp=True)` state and the micro-batches
    split over "data"."""
    cfg = case_cfg(name)

    def init(g):
        m = lm.Transformer.random(cfg, seed=3, device="cpu")
        with torch.no_grad():
            for path, t in leaves_with_path(m.param_tree()):
                t.copy_(torch.from_numpy(weights[path]))
        return m
    task = TrainTask(
        name=name, init_params=init,
        loss_fn=lambda m, b: lm.loss_fn(m.params, cfg, b["tokens"],
                                        b["labels"], remat=True, mesh=mesh),
        batches=iter([{k: torch.from_numpy(v) for k, v in batch.items()}]),
        lr=LR, warmup=0, total_steps=10, grad_accum=ACCUM, device="cpu")
    if mesh is not None:
        task.param_specs = lambda tree: make_param_specs(
            tree, mesh, lm_rules(mesh, fsdp=True))
        task.batch_specs = {"tokens": P(None, "data", None),
                            "labels": P(None, "data", None)}
    return task


def whole_leaf_step(mesh, task: TrainTask) -> dict:
    """One step of the whole-leaf route: every leaf gathered whole into
    the model, the loss differentiated with respect to the whole leaves
    (float32 sums over the micro-batches), then reduced to the blocks (a
    reduce-scatter where a dim is stored over the data axes, else an
    all_reduce and the block) and divided, AdamW on the blocks."""
    tr = Trainer(task, mesh=mesh)
    model = task.init_params(torch.Generator().manual_seed(0))
    tree = model.param_tree()
    specs = tr._specs(tree)
    blocks = tree_map(lambda p, s: local_slice(p.detach(), s, mesh).clone(),
                      tree, specs)
    opt = adamw_init(blocks)
    for p in tree_leaves(tree):
        p.requires_grad_(True)
    batch = tr._local_batch(next(iter(task.batches)))
    _, grads = tr._grads(model, tree_leaves(tree), batch)
    dp = data_axes(mesh)
    n_dp = mesh.axes_size(dp)
    out = []
    for g, spec in zip(grads, tree_leaves(specs)):
        at = [d for d, ax in enumerate(spec) if ax is not None and (
            ax if isinstance(ax, tuple) else (ax,)) == dp]
        if at:
            rest = list(spec)
            rest[at[0]] = None
            block = local_slice(mesh.reduce_scatter(g.contiguous(), dp,
                                                    at[0]), rest, mesh)
        else:
            block = local_slice(mesh.all_reduce(g, dp), spec, mesh)
        out.append(block / n_dp)
    grads = tree_unflatten(specs, out)
    lr = cosine_schedule(0, peak_lr=task.lr, warmup=task.warmup,
                         total=task.total_steps)
    adamw_update(grads, opt, blocks, lr=lr, weight_decay=task.weight_decay,
                 clip_norm=task.clip_norm,
                 grad_norm=tr._mesh_norm(grads, specs))
    return {"params": blocks, "m": opt["m"], "v": opt["v"]}


def _np(tree) -> dict:
    return {p: t.detach().numpy().copy() for p, t in leaves_with_path(tree)}


def _rank(mesh, inputs):
    """Every case on this rank: the FSDP Trainer's one step (its blocks
    and moments, whether the model's tensors held no storage during the
    step) and the whole-leaf route's."""
    out = {}
    for name, (weights, batch) in inputs.items():
        task = make_task(name, weights, batch, mesh)
        seen = []
        loss_fn = task.loss_fn

        def spy(m, b, loss_fn=loss_fn):
            seen.append(type(m.params).__name__)
            return loss_fn(m, b)
        task.loss_fn = spy
        res = Trainer(task, mesh=mesh).run(steps=1)
        tree = res["params"].param_tree()
        exact = all(torch.equal(local_slice(full, s, mesh), blk) for full, s,
                    blk in zip(tree_leaves(tree), tree_leaves(
                        task.param_specs(tree)), tree_leaves(res["blocks"])))
        old = whole_leaf_step(mesh, make_task(name, weights, batch, mesh))
        out[name] = {
            "fsdp": {"params": _np(res["blocks"]), "m": _np(res["opt"]["m"]),
                     "v": _np(res["opt"]["v"])},
            "whole_leaf": {k: _np(v) for k, v in old.items()},
            "loss_saw": sorted(set(seen)), "exact": exact,
            "log": res["log"],
            "specs": {p: tuple(s) for p, s in leaves_with_path(
                task.param_specs(res["params"].param_tree()))}}
    return out


SCRIPT = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from functools import partial
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_arch
from repro.models import transformer as tr
from repro.optim.adamw import adamw_init, adamw_update
from repro.sharding.rules import _path_str, lm_rules, make_param_specs

cases, accum, lr = json.loads(sys.argv[1]), int(sys.argv[2]), \
    float(sys.argv[3])
inp, out_path = np.load(sys.argv[4]), sys.argv[5]
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2),
                         ("data", "model"))
ns = lambda s: NamedSharding(mesh, s)
out = {}
for name, (arch, over) in cases.items():
    cfg = dataclasses.replace(get_arch(arch).smoke(), dtype="float32", **over)
    pshape = jax.eval_shape(partial(tr.init_params, cfg),
                            jax.random.PRNGKey(0))
    flat, treedef = jax.tree_util.tree_flatten_with_path(pshape)
    params = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(inp[f"{name}/w/{_path_str(p)}"]) for p, _ in flat])
    pspecs = make_param_specs(pshape, mesh, lm_rules(mesh, fsdp=True))
    gshard = jax.tree.map(ns, pspecs)
    opt = adamw_init(params, moments_dtype=jnp.float32)
    ospecs = {"step": P(), "m": pspecs, "v": pspecs}
    bspec = {"tokens": P(None, "data", None), "labels": P(None, "data", None)}

    def train_step(params, opt_state, batch):
        def loss_mean(p, mbatch):
            return tr.loss_fn(p, cfg, mbatch["tokens"], mbatch["labels"],
                              remat=True)

        def micro(acc, mbatch):
            (l, m), g = jax.value_and_grad(loss_mean, has_aux=True)(
                params, mbatch)
            g = jax.lax.with_sharding_constraint(g, gshard)
            acc = jax.lax.with_sharding_constraint(
                jax.tree.map(jnp.add, acc, g), gshard)
            return acc, l
        zero = jax.lax.with_sharding_constraint(
            jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32), params),
            gshard)
        grads, losses = jax.lax.scan(micro, zero, batch)
        grads = jax.tree.map(lambda g: g / accum, grads)
        params, opt_state, om = adamw_update(grads, opt_state, params, lr=lr)
        return params, opt_state, losses

    step = jax.jit(train_step, in_shardings=(
        gshard, jax.tree.map(ns, ospecs), jax.tree.map(ns, bspec)))
    batch = {k: jnp.asarray(inp[f"{name}/{k}"]) for k in ("tokens", "labels")}
    p2, o2, loss = step(params, opt, batch)
    for key, tree in (("params", p2), ("m", o2["m"]), ("v", o2["v"])):
        for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
            out[f"{name}/{key}/{_path_str(p)}"] = np.asarray(leaf)
    out[f"{name}/loss"] = np.asarray(loss)      # each micro-batch's
np.savez(out_path, **out)
print("FSDP_REF_OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the reference's npz, every rank's results): the JAX
    subprocess runs while the ranks do."""
    inputs = {name: case_inputs(name) for name in CASES}
    d = tmp_path_factory.mktemp("fsdp")
    flat = {f"{n}/w/{p}": a for n, (w, _) in inputs.items()
            for p, a in w.items()}
    flat.update({f"{n}/{k}": a for n, (_, b) in inputs.items()
                 for k, a in b.items()})
    np.savez(d / "in.npz", **flat)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", SCRIPT, json.dumps(CASES), str(ACCUM),
         repr(LR), str(d / "in.npz"), str(d / "ref.npz")],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        ranks = spawn(MESH, _rank, inputs, device="cpu", timeout=TIMEOUT,
                      join_timeout=JOIN)
        so, se = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert "FSDP_REF_OK" in so, so[-1500:] + se[-3000:]
    return inputs, dict(np.load(d / "ref.npz")), ranks


def _l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _coords(rank: int) -> MetaMesh:
    return MetaMesh(MESH, ("data", "model"), rank=rank)


def _cut(whole: np.ndarray, spec, rank: int) -> np.ndarray:
    return local_slice(torch.from_numpy(whole), P(*spec),
                       _coords(rank)).numpy()


@pytest.mark.parametrize("name", sorted(CASES))
def test_fsdp_step_matches_the_references_zero2_step(runs, name):
    """Each rank's parameter and moment blocks after one step against its
    spec's slices of the reference's sharded program's, TOL a leaf."""
    _, ref, ranks = runs
    for rank, r in enumerate(ranks):
        mine = r[name]
        assert mine["loss_saw"] == ["Blocks"]
        # the Trainer logs the last micro-batch's loss
        last = float(ref[f"{name}/loss"][-1])
        assert abs(mine["log"][0]["loss"] - last) <= TOL * abs(last)
        for key in ("params", "m", "v"):
            for path, blk in mine["fsdp"][key].items():
                want = _cut(ref[f"{name}/{key}/{path}"], mine["specs"][path],
                            rank)
                assert blk.shape == want.shape, (path, blk.shape)
                assert _l2(blk, want) < TOL, (name, rank, key, path)


@pytest.mark.parametrize("name", sorted(CASES))
def test_fsdp_step_matches_the_whole_leaf_route(runs, name):
    _, _, ranks = runs
    for r in ranks:
        for key in ("params", "m", "v"):
            for path, blk in r[name]["fsdp"][key].items():
                assert _l2(blk, r[name]["whole_leaf"][key][path]) < TOL, \
                    (name, key, path)


@pytest.mark.parametrize("name", sorted(CASES))
def test_fsdp_step_matches_one_device(runs, name):
    """The one-device Trainer on the whole batch; its whole parameters and
    moments cut to each rank's blocks."""
    inputs, _, ranks = runs
    weights, batch = inputs[name]
    res = Trainer(make_task(name, weights, batch)).run(steps=1)
    one = {"params": _np(res["params"].param_tree()),
           "m": _np(res["opt"]["m"]), "v": _np(res["opt"]["v"])}
    for rank, r in enumerate(ranks):
        assert abs(r[name]["log"][0]["loss"] - res["log"][0]["loss"]) \
            <= TOL * abs(res["log"][0]["loss"])
        for key in ("params", "m", "v"):
            for path, blk in r[name]["fsdp"][key].items():
                want = _cut(one[key][path], r[name]["specs"][path], rank)
                assert _l2(blk, want) < TOL, (name, rank, key, path)


# ---------------------------------------------------------------------------
# the collectives, counted on a MetaMesh
# ---------------------------------------------------------------------------

def expected_calls(specs, cfg, mesh, accum: int) -> dict:
    """A step's collectives by the layout's formula. Per micro-batch:
    each layer slice of a stacked leaf is gathered in the forward and
    again in the recompute, one all_gather a dim it keeps over axes of
    more than one rank (the routed experts of an expert-parallel layer
    their data dim only), and its gradient reduce-scattered once where a
    dim is over the data axes, else all-reduced over them; the head's
    leaves (embedding, final norm, head) the same, gathered once. Per
    step: one all_reduce of the metrics and one of the norm."""
    dp = set(data_axes(mesh))
    n_dense, n_moe = lm._depths(cfg)
    calls = {"all_gather": 0, "reduce_scatter": 0, "all_reduce": 0}

    def leaf(spec, trips: int, gathers: int, data_only: bool):
        sharded = [ax for ax in spec if ax is not None
                   and mesh.axes_size(ax) > 1]
        on_dp = [ax for ax in sharded
                 if set(ax if isinstance(ax, tuple) else (ax,)) <= dp]
        calls["all_gather"] += trips * gathers * len(
            on_dp if data_only else sharded)
        calls["reduce_scatter" if on_dp else "all_reduce"] += trips

    for path, spec in leaves_with_path(specs):
        key = path.split("/")[0]
        if key in ("dense_layers", "moe_layers"):
            n = n_dense if key == "dense_layers" else n_moe
            leaf(spec[1:], n, 2, data_only="/experts/" in path)
        else:
            leaf(spec, 1, 1, False)
    out = {k: v * accum for k, v in calls.items()}
    out["all_reduce"] += 2
    return out


def _meta_step(name: str):
    """One FSDP step of the case's train cell on a 2 x 2 MetaMesh: (the
    cell, the mesh's calls, each all-gather's output numel)."""
    mesh = MetaMesh(MESH, ("data", "model"))
    cell = cells.build_lm_cell(
        CASES[name][0], "train_4k", mesh, cfg=case_cfg(name),
        shape_def=dict(seq=SEQ, batch=ACCUM * MB),
        knobs=dict(accum=ACCUM, fsdp=True, moments="float32"))
    sizes = []
    gather = mesh.all_gather

    def counted(t, axes, dim=0, **kw):
        out = gather(t, axes, dim, **kw)
        sizes.append(out.numel())
        return out
    mesh.all_gather = counted
    mesh.reset_counts()
    cell.fn(*cell.args)
    return cell, dict(mesh.calls), sizes


def test_meta_mesh_step_counts_the_per_layer_formula():
    cfg = case_cfg("dense")
    cell, calls, _ = _meta_step("dense")
    want = expected_calls(cell.param_specs, cfg, cell.mesh, ACCUM)
    assert calls == want
    # 7 matrices a layer over both axes, 2 layers, forward and recompute,
    # the embedding and the head: 2 x (2 x 2 x 7 x 2 + 2 x 2) per step
    assert want == {"all_gather": 120, "reduce_scatter": 32,
                    "all_reduce": 12}


@pytest.mark.parametrize("name", sorted(CASES))
def test_no_all_gather_is_larger_than_a_layers_leaf(name):
    cell, calls, sizes = _meta_step(name)
    whole = cell.param_leaves()
    layer = max(int(np.prod(shape[1:])) for path, (shape, _, _)
                in whole.items() if path.split("/")[0].endswith("_layers"))
    head = max(int(np.prod(whole[p][0])) for p in ("embed", "lm_head"))
    assert sizes and max(sizes) <= max(layer, head)
    assert len(sizes) == calls["all_gather"]
    # the model the step hands the loss holds the blocks alone
    view = cell.args[0]
    assert view.param_tree() is view.params
    assert all(a is b for a, b in zip(tree_leaves(view.params),
                                      tree_leaves(cell.args[1])))
    for path, blk in leaves_with_path(cell.args[1]):
        assert tuple(blk.shape) != whole[path][0] or not any(
            ax is not None and cell.mesh.axes_size(ax) > 1
            for ax in whole[path][2]), path


def test_trainer_returns_the_whole_trained_parameters(runs):
    """`Trainer.run` on the mesh still hands back the whole trained
    parameters on every rank (the model's freed storage refilled): each
    rank's blocks are exactly their slices."""
    _, _, ranks = runs
    for r in ranks:
        for name in CASES:
            assert r[name]["exact"]
