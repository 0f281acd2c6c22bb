"""The port's training runtime (`runtime.trainer`, `launch.train`) against
the JAX package's: the reference's trainer tests (tests/test_runtime.py)
through the port, and the port's `Trainer` against the JAX `Trainer` from
the same carried-across weights on the same numpy batches: xDeepFM,
gcn-cora and the tiny LM for 20 steps, int8 EF, gradient accumulation,
and a JAX checkpoint resumed by the port. Also the CLI on the CPU."""
import subprocess
import sys
from pathlib import Path

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
from repro.data.tokens import token_batches as j_token_batches  # noqa: E402
from repro.launch import train as j_train  # noqa: E402
from repro.models import transformer as j_lm  # noqa: E402
from repro.models.gnn import gcn as j_gcn  # noqa: E402
from repro.models.recsys import xdeepfm as j_xd  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.optim import adamw_update as j_adamw_update  # noqa: E402
from repro.optim import cosine_schedule as j_cosine  # noqa: E402
from repro.runtime.trainer import Trainer as JTrainer  # noqa: E402
from repro.runtime.trainer import TrainTask as JTrainTask  # noqa: E402

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.data import Prefetcher  # noqa: E402
from repro_torch.data.recsys import click_batches  # noqa: E402
from repro_torch.data.tokens import token_batches  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.models import transformer as lm  # noqa: E402
from repro_torch.models.gnn.gcn import GCN  # noqa: E402
from repro_torch.models.recsys.xdeepfm import XDeepFM  # noqa: E402
from repro_torch.runtime.trainer import Trainer, TrainTask  # noqa: E402
from repro_torch.tree import leaves_with_path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
LM_CFG = dict(name="t", n_layers=2, d_model=32, n_heads=2, n_kv_heads=2,
              d_head=16, d_ff=64, vocab_size=128, dtype="float32")
JCFG, CFG = j_lm.LMConfig(**LM_CFG), lm.LMConfig(**LM_CFG)
# step logs, port against the jitted JAX trainer from the same weights and
# batches: each step's float32 order differences (about 1e-6 relative)
# feed the next; measured worst relative gap over 20 steps of xdeepfm and
# gcn-cora 1.8e-7 and 2.2e-7 (loss), 4.9e-7 (grad_norm, int8 EF); held at
# 1e-4
LOG_RTOL = 1e-4
# The tiny LM at the reference's lr 1e-2 is chaotic: the reference's own
# loss log moves by 3.5e-6 at step 3 and 3% by step 16 when its initial
# weights are scaled by 1 + 2**-22 (two ulps); its clipped gradient's norm
# (about 30) moves sooner (port against JAX: 2.6e-5 at step 0, 4.4e-4 at
# step 3; under int8 EF, where a flipped rounding moves a gradient entry
# by a whole quantum, 1.1e-4 at step 2). Its first LM_TIGHT steps are held
# at LOG_RTOL; over all 20 its largest loss gap to JAX is held within
# LM_SPREAD times the reference's own largest gap under that two-ulp change
# (measured each run), a bound on the run, not on each step. The exact
# 20-step checks are xDeepFM's and GCN's.
LM_TIGHT, LM_SPREAD = 2, 2.0


def make_task(total=40, **kw):
    """tests/test_runtime.py's tiny-LM task through the port."""
    return TrainTask(
        name="tiny", init_params=lambda g: lm.Transformer.random(
            CFG, seed=g.initial_seed(), device=g.device),
        loss_fn=lambda m, b: lm.loss_fn(m.params, CFG, b["tokens"],
                                        b["labels"]),
        batches=Prefetcher(token_batches(CFG.vocab_size, 8, 16, seed=1),
                           device="cpu"),
        lr=1e-2, warmup=5, total_steps=total, device="cpu", **kw)


def lm_pair(total=40, **kw):
    """(JAX task, port task) of the tiny LM from the reference's weights."""
    jp = j_lm.init_params(JCFG, jax.random.PRNGKey(0))
    jt = JTrainTask(
        name="tiny", init_params=lambda k: j_lm.init_params(JCFG, k),
        loss_fn=lambda p, b: j_lm.loss_fn(p, JCFG, jnp.asarray(b["tokens"]),
                                          jnp.asarray(b["labels"])),
        batches=j_token_batches(JCFG.vocab_size, 8, 16, seed=1),
        lr=1e-2, warmup=5, total_steps=total, **kw)
    tt = make_task(total, **kw)
    tt.init_params = lambda g: lm.Transformer.from_jax(CFG, jp, device="cpu")
    return jt, tt


def assert_logs_close(jlog, tlog, keys=("loss", "grad_norm", "lr")):
    assert [r["step"] for r in tlog] == [r["step"] for r in jlog]
    for k in keys:
        np.testing.assert_allclose([r[k] for r in tlog],
                                   [r[k] for r in jlog], rtol=LOG_RTOL,
                                   err_msg=k)
    assert all(sorted(set(t) - {"straggler"}) == sorted(set(j) - {"straggler"})
               for t, j in zip(tlog, jlog))


# ---------------------------------------------------------------------------
# the reference's trainer tests, through the port
# ---------------------------------------------------------------------------

def test_trainer_resume_bit_identical(tmp_path):
    """tests/test_runtime.py::test_trainer_resume_bit_identical, held to
    equality: the resumed run's steps 20..39 and final weights equal the
    clean run's bit for bit."""
    tr = Trainer(make_task(), ckpt_dir=str(tmp_path), ckpt_every=10)
    with pytest.raises(RuntimeError, match="simulated node failure"):
        tr.run(steps=40, fail_at_step=25)
    assert tr.ckpt.all_steps() == [10, 20]
    resumed = Trainer(make_task(), ckpt_dir=str(tmp_path),
                      ckpt_every=10).run(steps=40)
    clean = Trainer(make_task()).run(steps=40)
    assert resumed["log"][0]["step"] == 20
    assert [r["loss"] for r in resumed["log"]] == \
        [r["loss"] for r in clean["log"][20:]]
    for (p, a), (_, b) in zip(leaves_with_path(resumed["params"].params),
                              leaves_with_path(clean["params"].params)):
        assert torch.equal(a, b), p
    assert int(resumed["opt"]["step"]) == int(clean["opt"]["step"]) == 40


def test_trainer_loss_decreases():
    out = Trainer(make_task()).run(steps=30)
    losses = [r["loss"] for r in out["log"]]
    assert losses[-1] < losses[0]
    assert set(out["log"][0]) >= {"loss", "ce", "grad_norm", "lr", "step",
                                  "dt"}


def test_trainer_int8_ef_converges():
    t = make_task()
    t.grad_compression = "int8_ef"
    out = Trainer(t).run(steps=30)
    losses = [r["loss"] for r in out["log"]]
    assert losses[-1] < losses[0]


def test_trainer_refuses_a_mesh_and_no_card():
    """On a mesh the Trainer places its state by the task's spec tree, and
    refuses one that does not match the parameters (a leaf missing, a spec
    of the wrong length, an axis the mesh lacks); without a card the
    default device raises."""
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.sharding.rules import P, replicated
    mesh = make_local_mesh(device="cpu")
    for bad in ({"embed": P("data", None)},
                lambda tree: {**replicated(tree), "embed": P("data")},
                lambda tree: {**replicated(tree),
                              "embed": P("model", None)}):
        t = make_task()
        t.param_specs = bad
        with pytest.raises(ValueError, match="spec"):
            Trainer(t, mesh=mesh).run(steps=1)
    t = make_task()
    t.device = "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            Trainer(t).run(steps=1)


# ---------------------------------------------------------------------------
# the port's Trainer against the JAX Trainer
# ---------------------------------------------------------------------------

def _xdeepfm_pair(compress=False):
    jt = j_train.build_task("xdeepfm", 20, 64, 16, compress)
    tt = train.build_task("xdeepfm", 20, 64, 16, compress, device="cpu")
    jp = j_xd.init_params(j_get_arch("xdeepfm").smoke(),
                          jax.random.PRNGKey(0))
    cfg = get_arch("xdeepfm").smoke()
    tt.init_params = lambda g: XDeepFM.from_jax(cfg, jp, device="cpu")
    return jt, tt


def _gcn_pair(compress=False):
    jt = j_train.build_task("gcn-cora", 20, 8, 16, compress)
    tt = train.build_task("gcn-cora", 20, 8, 16, compress, device="cpu")
    jp = j_gcn.init_params(j_get_arch("gcn-cora").smoke(),
                           jax.random.PRNGKey(0))
    cfg = get_arch("gcn-cora").smoke()
    tt.init_params = lambda g: GCN.from_jax(cfg, jp, device="cpu")
    return jt, tt


@pytest.mark.parametrize("name,compress", [("xdeepfm", False),
                                           ("xdeepfm", True),
                                           ("gcn-cora", False)])
def test_trainer_matches_jax_trainer(name, compress):
    """20 steps of each trainer from the same weights (the reference's
    `init_params` at seed 0 carried across) on the same batches (both
    launchers' `build_task`): loss, acc, grad_norm and lr within LOG_RTOL
    at every step."""
    jt, tt = {"xdeepfm": _xdeepfm_pair, "gcn-cora": _gcn_pair}[name](compress)
    jlog = JTrainer(jt).run(steps=20)["log"]
    tlog = Trainer(tt).run(steps=20)["log"]
    assert_logs_close(jlog, tlog, ("loss", "acc", "grad_norm", "lr"))


@pytest.mark.parametrize("compress", [False, True])
def test_tiny_lm_trainer_matches_jax_trainer(compress):
    """The tiny LM of tests/test_runtime.py, 20 steps from the reference's
    weights: the first LM_TIGHT steps within LOG_RTOL, the run's largest
    loss gap within LM_SPREAD times the reference's own under a two-ulp
    change of its initial weights."""
    ef = "int8_ef" if compress else None
    jt, tt = lm_pair(20, grad_compression=ef)
    jlog = JTrainer(jt).run(steps=20)["log"]
    tlog = Trainer(tt).run(steps=20)["log"]
    assert_logs_close(jlog[:LM_TIGHT], tlog[:LM_TIGHT],
                      ("loss", "ce", "grad_norm", "lr"))
    jt2, _ = lm_pair(20, grad_compression=ef)
    jt2.init_params = lambda k: jax.tree.map(
        lambda a: a * (1 + 2.0 ** -22), j_lm.init_params(JCFG, k))
    jlog2 = JTrainer(jt2).run(steps=20)["log"]

    def gaps(log):
        return np.array([abs(r["loss"] - j["loss"]) / j["loss"]
                         for r, j in zip(log, jlog)])
    assert gaps(tlog).max() <= LM_SPREAD * gaps(jlog2).max(), \
        (gaps(tlog), gaps(jlog2))


def test_jax_checkpoint_resumes_in_the_port(tmp_path):
    """xDeepFM under int8 EF: the JAX trainer checkpoints at step 10 (and
    fails at 12); the port's trainer, from other weights, restores that
    checkpoint (params, AdamW state, EF residual) and runs to 20; its steps
    10..19 match the JAX trainer's clean run within LOG_RTOL."""
    jt, tt = _xdeepfm_pair(compress=True)
    with pytest.raises(RuntimeError):
        JTrainer(jt, ckpt_dir=str(tmp_path), ckpt_every=10).run(
            steps=20, fail_at_step=12)
    tt.init_params = lambda g: XDeepFM.random(get_arch("xdeepfm").smoke(), g)
    tlog = Trainer(tt, ckpt_dir=str(tmp_path), ckpt_every=100).run(
        steps=20)["log"]
    jt2, _ = _xdeepfm_pair(compress=True)
    jlog = JTrainer(jt2).run(steps=20)["log"]
    assert tlog[0]["step"] == 10
    assert_logs_close(jlog[10:], tlog, ("loss", "acc", "grad_norm", "lr"))


def test_grad_accum_matches_the_loop_the_scan_stands_for():
    """grad_accum 2 on xDeepFM batches of 2 micro-batches of 32: the JAX
    Trainer's `lax.scan` refuses its carry (a None beside the metrics
    dict), so the port is held to the jitted reference pieces run as that
    scan means: value_and_grad per micro-batch, the float32 sum over them
    / 2, AdamW; 8 steps within LOG_RTOL."""
    def split(b):
        return {k: v.reshape(2, 32, *v.shape[1:]) for k, v in b.items()}

    jcfg = j_get_arch("xdeepfm").smoke()
    jt, tt = _xdeepfm_pair()
    jt.grad_accum = tt.grad_accum = 2
    jt.batches = (split(b) for b in j_click_batches(
        jcfg.vocab_sizes, jcfg.n_dense, 64, seed=1))
    with pytest.raises(TypeError, match="carry"):
        JTrainer(jt).run(steps=1)

    tt.batches = Prefetcher((split(b) for b in click_batches(
        jcfg.vocab_sizes, jcfg.n_dense, 64, seed=1)), device="cpu")
    tlog = Trainer(tt).run(steps=8)["log"]

    vg = jax.jit(jax.value_and_grad(
        lambda p, b: j_xd.loss_fn(p, jcfg, b), has_aux=True))
    upd = jax.jit(lambda g, s, p, lr: j_adamw_update(g, s, p, lr=lr))
    params = j_xd.init_params(jcfg, jax.random.PRNGKey(0))
    state = j_adamw_init(params)
    it = j_click_batches(jcfg.vocab_sizes, jcfg.n_dense, 64, seed=1)
    for step in range(8):
        b = split(next(it))
        gsum = jax.tree.map(lambda p: jnp.zeros(p.shape, jnp.float32),
                            params)
        for i in range(2):
            (loss, m), g = vg(params, {k: jnp.asarray(v[i])
                                       for k, v in b.items()})
            gsum = jax.tree.map(jnp.add, gsum, g)
        lr = j_cosine(jnp.int32(step), peak_lr=1e-3, warmup=10, total=20)
        params, state, om = upd(jax.tree.map(lambda x: x / 2, gsum), state,
                                params, lr)
        for k, want in (("loss", loss), ("acc", m["acc"]),
                        ("grad_norm", om["grad_norm"])):
            np.testing.assert_allclose(tlog[step][k], float(want),
                                       rtol=LOG_RTOL, err_msg=k)


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["xdeepfm", "gcn-cora", "granite-3-8b"])
def test_train_cli_on_the_cpu(arch, capsys):
    train.main(["--arch", arch, "--device", "cpu", "--steps", "4"])
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith(f"[{arch}] steps 0..3 loss ")


def test_train_cli_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device runs")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         "gcn-cora", "--steps", "1"], capture_output=True, text=True,
        env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        cwd=ROOT, timeout=120)
    assert out.returncode != 0
    assert "CUDA is not available" in out.stderr
