"""The port's Trainer on a mesh of gloo ranks (one process a rank, on the
CPU) and the elastic checkpoint restore, against the one-device runs:

- the tiny LM of tests/test_runtime.py with `lm_rules(fsdp=True)` and
  xDeepFM's smoke config with `recsys_rules` on a 2 x 2 mesh, the batch
  split over "data", 4 steps: each rank's parameter, ``m`` and ``v``
  blocks are exactly its spec's slices of the gathered state; the logged
  losses and the gathered parameters are within 1e-5 of the JAX `Trainer`
  run on one device from the same weights and batches, and of the port's
  one-device `Trainer` (the tiny LM's parameters by relative L2, see the
  test);
- qwen2-moe's smoke config at a capacity factor with no drops, its MoE
  layers expert-parallel under the Trainer (the loss given the mesh),
  against the port's one-device Trainer;
- int8 error feedback's data-parallel reduction on 2 x 2 (the whole
  batch on every rank) against the one-device EF run;
- a spec tree on the mesh that does not match the parameters is refused;
- tests/test_elastic.py's case value for value: a checkpoint saved from
  one device restores onto 2 x 4 (``w`` over ("data", "model"), ``b``
  over "model") and onto 8 x 1, each rank holding its block;
- a Trainer that stops at step 2 on 2 x 2 (a mesh checkpoint, written
  whole by rank 0) and resumes on 4 x 1 reaches the one-device run's
  step-4 losses and weights.

The ranks import this module, so JAX is imported only in the tests.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.checkpoint import CheckpointManager  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import Prefetcher  # noqa: E402
from repro_torch.data.recsys import click_batches  # noqa: E402
from repro_torch.data.tokens import token_batches  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models import transformer as lm  # noqa: E402
from repro_torch.models.recsys import xdeepfm as xd  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainTask  # noqa: E402
from repro_torch.sharding.rules import (P, gather_full,  # noqa: E402
                                        lm_rules, local_slice,
                                        make_param_specs, recsys_rules)
from repro_torch.tree import leaves_with_path, tree_leaves  # noqa: E402

TIMEOUT, JOIN = 120.0, 400.0
STEPS = 4
TOL = 1e-5
LM_CFG = dict(name="t", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
              d_head=16, d_ff=64, vocab_size=128, dtype="float32")
MOE_CFG = dataclasses.replace(get_arch("qwen2-moe-a2.7b").smoke(),
                              dtype="float32", capacity_factor=4.0)


def _np_tree(tree):
    return {p: t.detach().cpu().numpy().copy()
            for p, t in leaves_with_path(tree)}


def make_task(name: str, mesh=None, weights=None, **kw) -> TrainTask:
    """The tiny LM (tests/test_runtime.py's), xDeepFM's smoke config
    (`launch/train.build_task`'s batches) or qwen2-moe's smoke config;
    ``weights`` ({path: array}) replaces the seeded initial weights; on a
    ``mesh`` the rules' specs and the batch split over "data"."""
    if name in ("lm", "moe"):
        cfg = lm.LMConfig(**LM_CFG) if name == "lm" else MOE_CFG

        def init(g):
            m = lm.Transformer.random(cfg, seed=g.initial_seed(),
                                      device=g.device)
            return _load(m, weights)
        # the MoE layers run expert-parallel on the mesh
        on = mesh if name == "moe" else None
        task = TrainTask(
            name=name, init_params=init,
            loss_fn=lambda m, b: lm.loss_fn(m.params, cfg, b["tokens"],
                                            b["labels"], mesh=on),
            batches=Prefetcher(token_batches(cfg.vocab_size, 8, 16, seed=1),
                               device="cpu"),
            lr=1e-2, warmup=5, total_steps=40, device="cpu", **kw)
        rules = lm_rules
        bspec = {"tokens": P("data", None), "labels": P("data", None)}
    else:
        cfg = get_arch("xdeepfm").smoke()
        task = TrainTask(
            name=name,
            init_params=lambda g: _load(xd.XDeepFM.random(cfg, g), weights),
            loss_fn=xd.loss_fn,
            batches=Prefetcher(click_batches(cfg.vocab_sizes, cfg.n_dense,
                                             64, seed=1), device="cpu"),
            lr=1e-3, warmup=10, total_steps=20, device="cpu", **kw)
        rules = recsys_rules
        bspec = {"sparse": P("data", None), "dense": P("data", None),
                 "label": P("data")}
    if mesh is not None:
        task.param_specs = lambda tree: make_param_specs(
            tree, mesh, rules(mesh, fsdp=True))
        task.batch_specs = bspec
    return task


def _load(model, weights):
    if weights is not None:
        with torch.no_grad():
            for path, t in leaves_with_path(model.param_tree()):
                t.copy_(torch.from_numpy(np.array(weights[path])))
    return model


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _rank_train(mesh, name, weights, steps, split=True, **kw):
    task = make_task(name, mesh, weights, **kw)
    if not split:
        task.batch_specs = None
    tr = Trainer(task, mesh=mesh)
    out = tr.run(steps=steps)
    tree = out["params"].param_tree()
    specs = task.param_specs(tree)
    exact = all(
        torch.equal(local_slice(full.detach(), spec, mesh), blk)
        for full, spec, blk in zip(tree_leaves(tree), tree_leaves(specs),
                                   tree_leaves(out["blocks"])))
    moments = {}
    for k in ("m", "v"):
        whole = [gather_full(b, s, mesh) for b, s in
                 zip(tree_leaves(out["opt"][k]), tree_leaves(specs))]
        moments[k] = all(torch.equal(local_slice(w, s, mesh), b) for w, s, b
                         in zip(whole, tree_leaves(specs),
                                tree_leaves(out["opt"][k])))
        moments[k + "_whole"] = [w.numpy() for w in whole]
    return {"log": out["log"], "params": _np_tree(tree), "exact": exact,
            "moments": moments, "step": int(out["opt"]["step"]),
            "sharded": sum(any(e is not None for e in s)
                           for s in tree_leaves(specs))}


def _rank_refuses(mesh):
    task = make_task("lm", mesh)
    task.param_specs = {"embed": P("model", None)}
    try:
        Trainer(task, mesh=mesh).run(steps=1)
    except ValueError as e:
        return str(e)
    return None


def _rank_restore(mesh, ckpt_dir, specs):
    mgr = CheckpointManager(ckpt_dir, async_write=False)
    like = {"w": torch.zeros(8, 8), "b": torch.zeros(16)}
    step, got = mgr.restore_latest(like, shardings=(mesh, specs))
    return step, {k: v.numpy() for k, v in got.items()}, \
        {k: gather_full(v, specs[k], mesh).numpy() for k, v in got.items()}


def _rank_stop(mesh, ckpt_dir, weights):
    tr = Trainer(make_task("lm", mesh, weights), mesh=mesh,
                 ckpt_dir=ckpt_dir, ckpt_every=2)
    try:
        tr.run(steps=STEPS, fail_at_step=2)
    except RuntimeError as e:
        return str(e)
    return None


def _rank_resume(mesh, ckpt_dir, weights):
    tr = Trainer(make_task("lm", mesh, weights), mesh=mesh,
                 ckpt_dir=ckpt_dir, ckpt_every=100)
    out = tr.run(steps=STEPS)
    return {"log": out["log"], "params": _np_tree(out["params"].param_tree())}


# ---------------------------------------------------------------------------
# the references
# ---------------------------------------------------------------------------

def _jax_run(name: str, steps: int):
    """(log, final params {path: array}, initial weights) of the JAX
    Trainer on one device: the tiny LM and xDeepFM from the reference's
    init_params at seed 0 on the same batches."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_arch as j_get_arch
    from repro.data.recsys import click_batches as j_click
    from repro.data.tokens import token_batches as j_tokens
    from repro.launch import train as j_train
    from repro.models import transformer as j_lm
    from repro.models.recsys import xdeepfm as j_xd
    from repro.runtime.trainer import Trainer as JTrainer
    from repro.runtime.trainer import TrainTask as JTrainTask
    if name == "lm":
        jcfg = j_lm.LMConfig(**LM_CFG)
        params = j_lm.init_params(jcfg, jax.random.PRNGKey(0))
        task = JTrainTask(
            name="tiny", init_params=lambda k: j_lm.init_params(jcfg, k),
            loss_fn=lambda p, b: j_lm.loss_fn(p, jcfg, jnp.asarray(
                b["tokens"]), jnp.asarray(b["labels"])),
            batches=j_tokens(jcfg.vocab_size, 8, 16, seed=1), lr=1e-2,
            warmup=5, total_steps=40)
    else:
        jcfg = j_get_arch("xdeepfm").smoke()
        params = j_xd.init_params(jcfg, jax.random.PRNGKey(0))
        task = j_train.build_task("xdeepfm", 20, 64, 16, False)
        task.batches = j_click(jcfg.vocab_sizes, jcfg.n_dense, 64, seed=1)
    out = JTrainer(task).run(steps=steps)

    def flat(tree):
        return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                         for k in path): np.asarray(leaf)
                for path, leaf in jax.tree_util.tree_flatten_with_path(
                    tree)[0]}
    return out["log"], flat(out["params"]), flat(params)


def _one_device(name: str, weights, steps: int, **kw):
    out = Trainer(make_task(name, None, weights, **kw)).run(steps=steps)
    return out["log"], _np_tree(out["params"].param_tree())


def _gap(a: dict, b: dict) -> float:
    """The largest |a - b| of any leaf over max(its largest |b|, 1)."""
    assert a.keys() == b.keys()
    return max(float(np.abs(a[k] - b[k]).max() / max(np.abs(b[k]).max(),
                                                     1.0)) for k in a)


def _l2(a: dict, b: dict) -> float:
    """The largest relative L2 distance |a - b| / |b| of any leaf."""
    assert a.keys() == b.keys()
    return max(float(np.linalg.norm(a[k] - b[k])
                     / max(np.linalg.norm(b[k]), 1e-30)) for k in a)


def _loss_gap(la, lb) -> float:
    return max(abs(x["loss"] - y["loss"]) / abs(y["loss"])
               for x, y in zip(la, lb))


@pytest.fixture(scope="module")
def jax_runs():
    return {name: _jax_run(name, STEPS) for name in ("lm", "xdeepfm")}


def _rank_2x2(mesh, weights, ckpt_dir):
    """Every 2 x 2 case in one spawn: the three training runs, the
    refusal, and the run that stops at step 2 with a checkpoint."""
    out = {name: _rank_train(mesh, name, weights[name], STEPS)
           for name in ("lm", "xdeepfm", "moe")}
    out["xdeepfm_ef"] = _rank_train(mesh, "xdeepfm", weights["xdeepfm"],
                                    STEPS, split=False,
                                    grad_compression="int8_ef")
    out["refused"] = _rank_refuses(mesh)
    out["stopped"] = _rank_stop(mesh, ckpt_dir, weights["lm"])
    return out


@pytest.fixture(scope="module")
def mesh_runs(jax_runs, tmp_path_factory):
    weights = {name: jax_runs[name][2] for name in ("lm", "xdeepfm")}
    weights["moe"] = _np_tree(make_task("moe").init_params(
        torch.Generator().manual_seed(0)).param_tree())
    ckpt_dir = str(tmp_path_factory.mktemp("mesh_ckpt"))
    ranks = spawn((2, 2), _rank_2x2, weights, ckpt_dir, device="cpu",
                  timeout=TIMEOUT, join_timeout=JOIN)
    return ranks, weights, ckpt_dir


@pytest.mark.parametrize("name", ["lm", "xdeepfm"])
def test_mesh_trainer_matches_one_device(jax_runs, mesh_runs, name):
    """2 x 2 mesh, 4 steps: blocks exact slices of the gathered state on
    every rank; losses within 1e-5 of the JAX Trainer on one device and of
    the port's one-device Trainer. xDeepFM's gathered parameters within
    1e-5 (of max(|w|, 1), every leaf) of both. The tiny LM at lr 1e-2 is
    chaotic (tests/test_torch_trainer.py): Adam's step on a near-zero
    gradient turns float32 order noise into a visible move, so its
    parameters are held by each leaf's relative L2 distance: within 1e-5
    of the port's one-device run (measured 9.1e-6, and 1.2e-5 for one
    embedding entry of 4,096 by max |diff|), and no farther from the JAX
    run than the port's one-device run is plus 1e-5 (that run sits 5.5e-4
    from JAX's after 4 steps, the mesh 5.4e-4)."""
    jlog, jparams, weights = jax_runs[name]
    ranks = [r[name] for r in mesh_runs[0]]
    tlog, tparams = _one_device(name, weights, STEPS)
    for r in ranks:
        assert r["exact"] and r["moments"]["m"] and r["moments"]["v"]
        assert r["step"] == STEPS and r["sharded"] > 0
        assert [x["step"] for x in r["log"]] == list(range(STEPS))
        assert _loss_gap(r["log"], tlog) < TOL
        assert _loss_gap(r["log"], jlog) < TOL
        if name == "lm":
            assert _l2(r["params"], tparams) < TOL
            assert _l2(r["params"], jparams) <= _l2(tparams, jparams) + TOL
        else:
            assert _gap(r["params"], tparams) < TOL
            assert _gap(r["params"], jparams) < TOL
        for k in ("m", "v"):
            for a, b in zip(r["moments"][k + "_whole"],
                            ranks[0]["moments"][k + "_whole"]):
                np.testing.assert_array_equal(a, b)


def test_mesh_trainer_expert_parallel_moe(mesh_runs):
    """qwen2-moe's smoke config (8 experts over the 2 model columns: EP,
    capacity factor 4: no drops on one device nor on a rank), the loss
    given the mesh: 4 steps on 2 x 2 against the one-device Trainer."""
    ranks, weights, _ = mesh_runs
    tlog, tparams = _one_device("moe", weights["moe"], STEPS)
    for r in ranks:
        assert r["moe"]["exact"]
        assert _loss_gap(r["moe"]["log"], tlog) < TOL
        assert _l2(r["moe"]["params"], tparams) < TOL


def test_mesh_trainer_int8_ef_reduction(mesh_runs):
    """int8 error feedback on 2 x 2 with the whole batch on every rank:
    each rank's quantised gradient and scale cross the data axis (an
    all_gather) and are summed and divided; with equal gradients on the
    two data rows that is the one-device EF step, so 4 steps stay within
    1e-5 of the port's one-device EF run."""
    ranks, weights, _ = mesh_runs
    tlog, tparams = _one_device("xdeepfm", weights["xdeepfm"], STEPS,
                                grad_compression="int8_ef")
    for r in ranks:
        ef = r["xdeepfm_ef"]
        assert ef["exact"]
        assert _loss_gap(ef["log"], tlog) < TOL
        assert _gap(ef["params"], tparams) < TOL


def test_mesh_trainer_refuses_specs_that_do_not_fit(mesh_runs):
    for r in mesh_runs[0]:
        assert r["refused"] is not None
        assert "does not match the parameters" in r["refused"]


def test_elastic_restore_across_meshes(tmp_path):
    """tests/test_elastic.py on the port: saved from one device, restored
    onto 2 x 4 then 8 x 1, each rank's block its coordinate's slice, the
    gathered tensors equal to the saved ones."""
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    tree = {"w": torch.arange(64.0).reshape(8, 8), "b": torch.ones(16)}
    mgr.save(100, tree, blocking=True)
    for shape, specs in (((2, 4), {"w": P("data", "model"),
                                   "b": P("model")}),
                         ((8, 1), {"w": P("data", None), "b": P(None)})):
        ranks = spawn(shape, _rank_restore, str(tmp_path), specs,
                      device="cpu", timeout=TIMEOUT, join_timeout=JOIN)
        for r, (step, blocks, whole) in enumerate(ranks):
            assert step == 100
            d, m = divmod(r, shape[1])
            w = np.arange(64.0).reshape(8, 8)
            if shape == (2, 4):
                want_w, want_b = w[4 * d:4 * d + 4, 2 * m:2 * m + 2], \
                    np.ones(4)
            else:
                want_w, want_b = w[d:d + 1], np.ones(16)
            np.testing.assert_array_equal(blocks["w"], want_w)
            np.testing.assert_array_equal(blocks["b"], want_b)
            np.testing.assert_array_equal(whole["w"], w)
            np.testing.assert_array_equal(whole["b"], np.ones(16))


def test_mesh_trainer_resumes_on_another_mesh(mesh_runs):
    """Stop at step 2 on 2 x 2 (the checkpoint written whole), resume on
    4 x 1: the resumed steps 2..3 and the final weights within 1e-5 of the
    one-device run's."""
    ranks, weights, ckpt_dir = mesh_runs
    assert all(r["stopped"] and "simulated node failure at step 2"
               in r["stopped"] for r in ranks)
    assert CheckpointManager(ckpt_dir).all_steps() == [2]
    resumed = spawn((4, 1), _rank_resume, ckpt_dir, weights["lm"],
                    device="cpu", timeout=TIMEOUT, join_timeout=JOIN)
    tlog, tparams = _one_device("lm", weights["lm"], STEPS)
    for r in resumed:
        assert [x["step"] for x in r["log"]] == [2, 3]
        assert _loss_gap(r["log"], tlog[2:]) < TOL
        assert _l2(r["params"], tparams) < TOL
