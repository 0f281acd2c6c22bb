"""The training runtime's pieces in the PyTorch port against the JAX
package: the cosine schedule, AdamW (clipping on and off, float32 and
bfloat16 moments), int8 error feedback, checkpoints (round trip, keep-n,
the temp-dir rename, and a checkpoint written by either package restored
by the other), the prefetcher, the parameter-tree helpers and the arch
registry; plus the port's own mirrors of the reference's optimizer
tests (tests/test_runtime.py)."""
import json
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so the test workers running beside
# this one keep their cores
torch.set_num_threads(1)

from repro import configs as j_configs  # noqa: E402
from repro.checkpoint import CheckpointManager as JCheckpointManager  # noqa: E402
from repro.optim import adamw_init as j_adamw_init  # noqa: E402
from repro.optim import adamw_update as j_adamw_update  # noqa: E402
from repro.optim import cosine_schedule as j_cosine  # noqa: E402
from repro.optim.compress import ef_compress as j_ef_compress  # noqa: E402
from repro.optim.compress import ef_decompress as j_ef_decompress  # noqa: E402
from repro.optim.compress import ef_init as j_ef_init  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.checkpoint import (CheckpointManager,  # noqa: E402
                                    tree_from_jax)
from repro_torch.data import Prefetcher  # noqa: E402
from repro_torch.optim import (adamw_init, adamw_update,  # noqa: E402
                               cosine_schedule)
from repro_torch.optim.compress import (ef_compress,  # noqa: E402
                                        ef_decompress, ef_init)
from repro_torch.tree import (leaves_with_path, path_tree,  # noqa: E402
                              tree_leaves, tree_map, tree_unflatten)

RNG = np.random.default_rng(11)


def to_torch(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a, copy=True)), tree)


def j_paths(tree) -> dict:
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def random_tree():
    """Nested dicts and lists with a None (an empty subtree in JAX), keys
    out of sorted order so insertion and leaf order differ."""
    return {"z": RNG.normal(size=(5, 7)).astype(np.float32),
            "b": [RNG.normal(size=(3,)).astype(np.float32), None,
                  {"w": RNG.normal(size=(2, 2, 2)).astype(np.float32)}],
            "a": RNG.normal(size=(4,)).astype(np.float32)}


# ---------------------------------------------------------------------------
# trees
# ---------------------------------------------------------------------------

def test_tree_paths_and_order_are_jax():
    tree = random_tree()
    jt = jax.tree.map(jnp.asarray, tree)
    want = j_paths(jt)
    got = list(leaves_with_path(to_torch(tree)))
    assert [p for p, _ in got] == list(want)     # JAX's leaf order too
    for p, leaf in got:
        np.testing.assert_array_equal(leaf.numpy(), want[p])
    tt = to_torch(tree)
    assert tree_unflatten(tt, tree_leaves(tt))["b"][2]["w"] is tt["b"][2]["w"]
    assert path_tree(tt)["b"] == ["b/0", None, {"w": "b/2/w"}]


# ---------------------------------------------------------------------------
# schedule, AdamW, EF
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("peak,warmup,total", [(1.0, 10, 100),
                                               (3e-4, 20, 200),
                                               (1e-3, 0, 50)])
def test_cosine_schedule_matches_jax(peak, warmup, total):
    """Every step 0..100 within 1e-7 x peak (float32: both round the same
    operations; measured 2.98e-8 at peak 1, an ulp of the cosine)."""
    got = [float(cosine_schedule(s, peak_lr=peak, warmup=warmup,
                                 total=total)) for s in range(101)]
    want = [float(j_cosine(jnp.int32(s), peak_lr=peak, warmup=warmup,
                           total=total)) for s in range(101)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7 * peak)
    assert cosine_schedule(3, peak_lr=peak, warmup=warmup,
                           total=total).dtype == torch.float32


def test_cosine_schedule_shape():
    """tests/test_runtime.py::test_cosine_schedule_shape, through the port."""
    lrs = [float(cosine_schedule(s, peak_lr=1.0, warmup=10, total=100))
           for s in range(100)]
    assert lrs[0] < lrs[9] <= 1.0
    assert lrs[10] == pytest.approx(max(lrs), rel=1e-3)
    assert lrs[-1] < 0.2


@pytest.mark.parametrize("clip,moments", [(1.0, "float32"),
                                          (1e3, "float32"),
                                          (0.0, "float32"),
                                          (1.0, "bfloat16")])
def test_adamw_matches_jax(clip, moments):
    """10 updates of a random tree (clipping active at 1.0: the gradients'
    norm is about 20; idle at 1,000; off at 0) with the reference's jitted
    update on the same gradients: parameters and moments within 1e-6
    relative, or 1e-6 of their leaf's largest magnitude for an entry near
    0 (an entry of m near 0 is the difference of two close products,
    which XLA fuses into one FMA and PyTorch rounds twice: 3.8e-5 relative
    at such an entry; a weight near 0 moves by lr times an update that
    carries it), the step equal and the gradient norm within 1e-6."""
    tree = random_tree()
    jp = jax.tree.map(jnp.asarray, tree)
    js = j_adamw_init(jp, moments_dtype=jnp.dtype(moments))
    tp = to_torch(tree)
    ts = adamw_init(tp, moments_dtype=getattr(torch, moments))
    upd = jax.jit(lambda g, s, p, lr: j_adamw_update(g, s, p, lr=lr,
                                                      clip_norm=clip))
    for i in range(10):
        g = tree_map(lambda a: (RNG.normal(size=a.shape) * 3)
                     .astype(np.float32), tree)
        lr = float(j_cosine(jnp.int32(i), peak_lr=1e-2, warmup=3, total=10))
        jp, js, jm = upd(jax.tree.map(jnp.asarray, g), js, jp, lr)
        _, _, tm = adamw_update(to_torch(g), ts, tp, lr=lr, clip_norm=clip)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
    assert int(ts["step"]) == int(js["step"]) == 10
    for name, jt, tt in (("params", jp, tp), ("m", js["m"], ts["m"]),
                         ("v", js["v"], ts["v"])):
        want = j_paths(jt)
        for p, leaf in leaves_with_path(tt):
            w = want[p].astype(np.float32)
            np.testing.assert_allclose(leaf.float().numpy(), w, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(w).max()),
                                       err_msg=f"{name}/{p}")


def test_adamw_minimizes_quadratic():
    """tests/test_runtime.py::test_adamw_minimizes_quadratic."""
    params = {"w": torch.tensor([3.0, -2.0])}
    opt = adamw_init(params)
    for _ in range(200):
        adamw_update({"w": 2 * params["w"]}, opt, params, lr=5e-2,
                     weight_decay=0.0)
    assert float(params["w"].abs().max()) < 0.1


def test_ef_compress_matches_jax():
    """Against the reference function run op by op: int8 equal, scales
    equal, residual within 1e-7 (measured 0). (Jitted, XLA fuses the
    residual's g - q scale into one FMA, which moves it by up to half an
    ulp of g: 6.9e-7 at |g| ~ 15.)"""
    g = {"a": (RNG.normal(size=(1000,)) * 5).astype(np.float32),
         "b": [RNG.normal(size=(7, 3)).astype(np.float32)],
         "zero": np.zeros(4, np.float32)}
    r = tree_map(lambda a: (RNG.normal(size=a.shape) * 0.01)
                 .astype(np.float32), g)
    jq, js, jr = j_ef_compress(jax.tree.map(jnp.asarray, g),
                               jax.tree.map(jnp.asarray, r))
    tq, ts, tr = ef_compress(to_torch(g), to_torch(r))
    for want, got in ((jq, tq), (js, ts)):
        want = j_paths(want)
        for p, leaf in leaves_with_path(got):
            np.testing.assert_array_equal(leaf.numpy(), want[p], err_msg=p)
    assert all(t.dtype == torch.int8 for t in tree_leaves(tq))
    want = j_paths(jr)
    for p, leaf in leaves_with_path(tr):
        np.testing.assert_allclose(leaf.numpy(), want[p], atol=1e-7)


def test_ef_compression_roundtrip_bounded_error():
    """tests/test_runtime.py::test_ef_compression_roundtrip_bounded_error."""
    g = {"a": torch.from_numpy(RNG.normal(size=(64,)).astype(np.float32))}
    q, s, res2 = ef_compress(g, ef_init(g))
    back = ef_decompress(q, s)
    err = float((back["a"] - g["a"]).abs().max())
    assert err <= float(s["a"])
    torch.testing.assert_close(res2["a"], g["a"] - back["a"], atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_state_carried_from_jax_continues(moments):
    """The reference's AdamW state (bfloat16 moments too) and EF residual
    after 5 jitted steps, carried across by `tree_from_jax` with the
    parameters, continue in the port: 5 more steps on both sides within
    test_adamw_matches_jax's tolerances."""
    tree = random_tree()
    jp = jax.tree.map(jnp.asarray, tree)
    js = j_adamw_init(jp, moments_dtype=jnp.dtype(moments))
    jr = j_ef_init(jp)

    @jax.jit
    def step(g, s, p, r):
        q, sc, r = j_ef_compress(g, r)
        p, s, m = j_adamw_update(j_ef_decompress(q, sc), s, p, lr=1e-2)
        return p, s, r

    grads = [tree_map(lambda a: (RNG.normal(size=a.shape) * 3)
                      .astype(np.float32), tree) for _ in range(10)]
    for g in grads[:5]:
        jp, js, jr = step(jax.tree.map(jnp.asarray, g), js, jp, jr)
    tp, ts, tr = (tree_from_jax(t, device="cpu") for t in (jp, js, jr))
    assert int(ts["step"]) == 5 and ts["step"].dtype == torch.int32
    assert all(m.dtype == getattr(torch, moments)
               for m in tree_leaves(ts["m"]))
    for g in grads[5:]:
        jp, js, jr = step(jax.tree.map(jnp.asarray, g), js, jp, jr)
        q, sc, tr = ef_compress(to_torch(g), tr)
        adamw_update(ef_decompress(q, sc), ts, tp, lr=1e-2)
    for name, jt, tt in (("params", jp, tp), ("m", js["m"], ts["m"]),
                         ("v", js["v"], ts["v"])):
        want = j_paths(jt)
        for p, leaf in leaves_with_path(tt):
            w = want[p].astype(np.float32)
            np.testing.assert_allclose(leaf.float().numpy(), w, rtol=1e-6,
                                       atol=1e-6 * float(np.abs(w).max()),
                                       err_msg=f"{name}/{p}")


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_gc(tmp_path):
    """tests/test_runtime.py::test_checkpoint_roundtrip_and_gc, plus the
    dtypes (int32 step, bfloat16 moments, a 0-d leaf) and the manifest."""
    mgr = CheckpointManager(str(tmp_path), keep_n=2, async_write=False)
    tree = {"a": torch.arange(5), "b": [torch.ones((2, 2)), torch.zeros(3)],
            "step": torch.tensor(7, dtype=torch.int32),
            "m": torch.randn(3, 2).to(torch.bfloat16), "none": None}
    for step in (10, 20, 30):
        mgr.save(step, tree, blocking=True, extra={"note": step})
    assert mgr.all_steps() == [20, 30]
    assert mgr.latest_step() == 30
    got = mgr.restore(30, tree)
    assert got["none"] is None
    for p, leaf in leaves_with_path(tree):
        out = dict(leaves_with_path(got))[p]
        assert out.dtype == leaf.dtype and torch.equal(out, leaf), p
    with open(tmp_path / "step-000000000030" / "manifest.json") as f:
        man = json.load(f)
    assert man["step"] == 30 and man["extra"] == {"note": 30}
    assert man["keys"] == sorted(["a", "b/0", "b/1", "step", "m"])


def test_checkpoint_async_write_copies_on_the_caller(tmp_path):
    """The host copy is taken before save() returns: an in-place update
    right after an async save does not reach the checkpoint; only complete
    step-* directories count, and the temp dir is renamed into place."""
    mgr = CheckpointManager(str(tmp_path), keep_n=3, async_write=True)
    w = torch.zeros(1000)
    mgr.save(1, {"w": w})
    w.add_(1.0)
    mgr.wait()
    assert torch.equal(mgr.restore(1, {"w": w})["w"], torch.zeros(1000))
    # a writer killed before its rename leaves only a temp dir
    os.makedirs(tmp_path / ".tmp-2-1-1")
    os.makedirs(tmp_path / "step-000000000003")       # no manifest yet
    assert mgr.all_steps() == [1]
    names = sorted(os.listdir(tmp_path))
    assert "step-000000000001" in names
    assert not any(n.startswith(".tmp-1-") for n in names)


def test_checkpoint_restore_latest_empty(tmp_path):
    mgr = CheckpointManager(str(tmp_path / "new"))
    assert mgr.restore_latest({"a": torch.zeros(1)}) == (None, None)


def _state_pair():
    """The same trainer-state tree for each package: params with a None
    (Equiformer-v2's m = 0 w2), opt state, ef."""
    params = {"embed": RNG.normal(size=(6, 3)).astype(np.float32),
              "cin": [RNG.normal(size=(2, 3, 4)).astype(np.float32)],
              "so2": [{"w1": np.ones((2, 2), np.float32), "w2": None}],
              "mlp": [{"w": RNG.normal(size=(3, 2)).astype(np.float32),
                       "b": np.zeros(2, np.float32)}]}
    jp = jax.tree.map(jnp.asarray, params)
    jstate = {"params": jp, "opt": j_adamw_init(jp),
              "ef": {"_": jnp.zeros(())}}
    tp = to_torch(params)
    tstate = {"params": tp, "opt": adamw_init(tp),
              "ef": {"_": torch.zeros(())}}
    return jstate, tstate


def test_jax_checkpoint_restores_in_the_port(tmp_path):
    jstate, tstate = _state_pair()
    jstate["opt"]["step"] = jnp.int32(12)
    JCheckpointManager(str(tmp_path), async_write=False).save(12, jstate)
    mgr = CheckpointManager(str(tmp_path))
    step, got = mgr.restore_latest(tstate)
    assert step == 12
    want = j_paths(jstate)
    flat = dict(leaves_with_path(got))
    assert sorted(flat) == sorted(want)
    assert "params/so2/0/w2" not in flat and "opt/step" in flat
    for p, leaf in flat.items():
        assert leaf.numpy().dtype == want[p].dtype, p
        np.testing.assert_array_equal(leaf.numpy(), want[p], err_msg=p)


def test_port_checkpoint_restores_in_jax(tmp_path):
    jstate, tstate = _state_pair()
    tstate["opt"]["step"].fill_(5)
    CheckpointManager(str(tmp_path), async_write=False).save(5, tstate)
    jm = JCheckpointManager(str(tmp_path))
    step, got = jm.restore_latest(jstate)
    assert step == 5 and int(got["opt"]["step"]) == 5
    want = dict(leaves_with_path(tstate))
    flat = j_paths(got)
    assert sorted(flat) == sorted(want)
    for p, arr in flat.items():
        np.testing.assert_array_equal(arr, want[p].numpy(), err_msg=p)


def test_bfloat16_leaves_are_stored_as_jax_stores_them(tmp_path):
    """numpy writes JAX's bfloat16 arrays as raw 16 bits (|V2); the port
    writes the same bytes and reads them back as bfloat16."""
    bits = RNG.integers(0, 1 << 15, 8).astype(np.uint16)
    jarr = jnp.asarray(bits.view(jnp.bfloat16))
    JCheckpointManager(str(tmp_path / "j"), async_write=False).save(
        1, {"m": jarr})
    t = torch.from_numpy(bits.view(np.int16).copy()).view(torch.bfloat16)
    CheckpointManager(str(tmp_path / "t"), async_write=False).save(
        1, {"m": t})
    zj = np.load(tmp_path / "j" / "step-000000000001" / "arrays.npz")["m"]
    zt = np.load(tmp_path / "t" / "step-000000000001" / "arrays.npz")["m"]
    assert zj.dtype == zt.dtype and zj.tobytes() == zt.tobytes()
    got = CheckpointManager(str(tmp_path / "j")).restore(1, {"m": t})["m"]
    assert got.dtype == torch.bfloat16
    assert torch.equal(got.view(torch.int16), t.view(torch.int16))  # NaNs too


# ---------------------------------------------------------------------------
# prefetcher
# ---------------------------------------------------------------------------

def test_prefetcher_depth_and_order():
    """tests/test_runtime.py::test_prefetcher_depth_and_order, and the
    queue's depth: full while the consumer waits, bounded by ``depth``."""
    assert list(Prefetcher(iter(range(100)), depth=4)) == list(range(100))
    gate = threading.Event()

    def slow():
        yield from range(6)
        gate.wait(timeout=30)
    pf = Prefetcher(slow(), depth=4)
    for _ in range(1000):                       # up to 10 s to fill
        if pf.depth == 4:
            break
        threading.Event().wait(0.01)
    assert pf.depth == 4
    assert [next(pf) for _ in range(6)] == list(range(6))
    assert pf.depth == 0                        # ran dry: an input straggler
    gate.set()
    with pytest.raises(StopIteration):
        next(pf)


def test_prefetcher_moves_numpy_batches_on_the_caller():
    """With a device, numpy batches (kept numpy in the worker) arrive as
    tensors on it; other values pass through; an error in the iterator
    surfaces on next()."""
    seen = []

    def gen():
        b = {"x": np.arange(6, dtype=np.int32).reshape(2, 3), "n": 3}
        seen.append(type(b["x"]))
        yield b
        raise ValueError("bad batch")
    pf = Prefetcher(gen(), depth=2, device="cpu")
    b = next(pf)
    assert seen == [np.ndarray]
    assert isinstance(b["x"], torch.Tensor) and b["x"].dtype == torch.int32
    assert torch.equal(b["x"], torch.arange(6, dtype=torch.int32)
                       .reshape(2, 3)) and b["n"] == 3
    with pytest.raises(ValueError, match="bad batch"):
        next(pf)


# ---------------------------------------------------------------------------
# arch registry
# ---------------------------------------------------------------------------

def test_arch_registry_matches_jax():
    """get_arch's family, shapes and both configs for every arch equal the
    reference's (the configs field by field), and all_cells is the
    reference's 40. Until the MoE archs were ported this asserted that they
    raised and that all_cells had the other 32."""
    assert configs.ARCH_IDS == j_configs.ARCH_IDS
    for a in configs.ARCH_IDS:
        spec, jspec = configs.get_arch(a), j_configs.get_arch(a)
        assert (spec.family, spec.shapes) == (jspec.family, jspec.shapes)
        for which in ("full", "smoke"):
            got = getattr(spec, which)()
            want = getattr(jspec, which)()
            assert type(got).__name__ == type(want).__name__
            assert vars(got) == vars(want), (a, which)
    with pytest.raises(KeyError):
        configs.get_arch("nope")
    assert configs.all_cells() == j_configs.all_cells()
    assert len(configs.all_cells()) == 40
