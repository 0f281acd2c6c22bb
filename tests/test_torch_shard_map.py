"""The port's mesh paths of the LM on a 2 x 4 mesh of gloo ranks (one
process a rank, on the CPU) against the JAX package's shard_map paths on 8
virtual CPU devices (tests/test_shard_map_paths.py's cases, and more):

- the expert-parallel MoE layer (`_moe_mlp(..., mesh=)` against
  `_moe_mlp_ep_shard_map` under ``MOE_SHARD_MAP``): SCRIPT_MOE's EP case
  (8 experts over 4 columns, capacity factor 8: no drops) against the JAX
  one-device layer, outputs within 1e-5 of max |out| and every gradient
  (router, experts, shared expert, tokens) at relative error < 1e-5; the
  same at capacity factor 1 (pairs drop: the local capacity rule must keep
  the JAX shard_map's slots) and an expert-TP case shaped as qwen2-moe's
  smoke config with 6 experts (6 % 4 != 0, d_ff 32 % 4 == 0), both against
  the JAX shard_map's outputs and gradients. The expert weights are each
  rank's block under `lm_rules(fsdp=True)`, so the data dim is re-gathered
  and its gradient reduce-scattered;
- the split-KV GQA decode (`Transformer.decode_step(..., mesh=)` against
  `_decode_attn_split_kv` under ``DECODE_SHARD_MAP``): SCRIPT_DECODE's
  batch of 4 (batch over "data", slots over "model") and a batch of 1
  (slots over ("data", "model")), logits within 1e-5 of JAX's and each
  rank's cache block equal to JAX's new cache's after the step;
- the split-KV MLA decode on deepseek-v3's smoke config in float32
  (`_mla_decode_split_kv`, ``wkv_b`` held as each rank's block over
  "model" and gathered), its MoE layers expert-parallel under
  ``MOE_SHARD_MAP`` on the JAX side, logits within 1e-5.

One JAX subprocess (XLA_FLAGS must not leak into this process) writes
every reference to an npz; one spawn of 8 ranks computes every port
result; the tests compare. The ranks import this module, so JAX is
imported only in the subprocess.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.launch.mesh import spawn  # noqa: E402
from repro_torch.models import transformer as tr  # noqa: E402
from repro_torch.sharding.rules import (P, lm_rules,  # noqa: E402
                                        local_slice, make_param_specs)

ROOT = Path(__file__).resolve().parents[1]
MESH = (2, 4)
GROUP_TIMEOUT = 120.0
JOIN_TIMEOUT = 400.0
TOL = 1e-5

BASE_MOE = dict(name="m", n_layers=1, d_model=32, n_heads=2, n_kv_heads=2,
                d_head=16, d_ff=64, vocab_size=64, moe=True, n_experts=8,
                top_k=2, n_shared_experts=1, moe_d_ff=16, shared_d_ff=16,
                first_dense_layers=0, dtype="float32")
TP_MOE = dict(name="qwen2-moe-smoke-6", n_layers=1, d_model=64, n_heads=4,
              n_kv_heads=4, d_head=16, d_ff=128, vocab_size=512, moe=True,
              n_experts=6, top_k=2, n_shared_experts=1, moe_d_ff=32,
              shared_d_ff=128, first_dense_layers=0, capacity_factor=2.0,
              dtype="float32")
MOE_CASES = {"ep": dict(BASE_MOE, capacity_factor=8.0),
             "drops": dict(BASE_MOE, capacity_factor=1.0),
             "tp": TP_MOE}
DECODE_CFG = dict(name="t", n_layers=2, d_model=32, n_heads=4, n_kv_heads=2,
                  d_head=8, d_ff=64, vocab_size=100, dtype="float32")

SCRIPT = r"""
import dataclasses, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_arch
from repro.models import transformer as tr

MOE_CASES, DECODE_CFG, out_path = eval(sys.argv[1]), eval(sys.argv[2]), \
    sys.argv[3]
mesh = jax.make_mesh((2, 4), ("data", "model"))
ns = lambda s: NamedSharding(mesh, s)
info = {"mesh": mesh, "dp": "data", "model": "model"}
res = {}

def save(prefix, tree):
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                       for p in path)
        res[f"{prefix}/{key}" if key else prefix] = np.asarray(leaf)

for name, kw in MOE_CASES.items():
    cfg = tr.LMConfig(**kw)
    params = tr.init_params(cfg, jax.random.PRNGKey(0))
    one = jax.tree.map(lambda a: a[0], params["moe_layers"])
    x = jax.random.normal(jax.random.PRNGKey(2), (4, 16, cfg.d_model))
    def loss(p_, x_):
        return jnp.sum(tr._moe_mlp(p_, cfg, x_) ** 2)
    tr.MOE_SHARD_MAP = None
    save(f"{name}/one", one)
    save(f"{name}/x", x)
    save(f"{name}/ref", tr._moe_mlp(one, cfg, x))
    tr.MOE_SHARD_MAP = info
    with mesh:
        save(f"{name}/out", jax.jit(
            lambda p_, x_: tr._moe_mlp(p_, cfg, x_),
            in_shardings=(None, ns(P("data", None, None))))(one, x))
        save(f"{name}/g_sm", jax.jit(
            jax.grad(loss, argnums=(0, 1)),
            in_shardings=(None, ns(P("data", None, None))))(one, x))
    tr.MOE_SHARD_MAP = None

def decode_case(name, cfg, B, moe_sm):
    # the first 8 slots of a 16-slot cache hold unit-normal entries (what
    # a prefill would write does not matter to the decode step)
    p = tr.init_params(cfg, jax.random.PRNGKey(0))
    toks = jax.random.randint(jax.random.PRNGKey(1), (B, 9), 0,
                              cfg.vocab_size)
    rng = np.random.default_rng(3)
    def filled(a):
        a = np.zeros(a.shape, np.float32)
        a[:, :, :8] = rng.standard_normal(a[:, :, :8].shape)
        return jnp.asarray(a)
    cache = {k: None if v is None else tuple(filled(a) for a in v)
             for k, v in tr.init_cache(cfg, B, 16).items()}
    tr.CACHE_UPDATE = "masked"
    l1, _ = jax.jit(lambda pp, cc, t: tr.decode_step(
        pp, cfg, cc, t, jnp.int32(8)))(p, cache, toks[:, 8:9])
    tr.DECODE_SHARD_MAP = info
    tr.MOE_SHARD_MAP = info if moe_sm else None
    t_ax = "model" if B > 1 else ("data", "model")
    b_ax = "data" if B > 1 else None
    def spec(a):
        return ns(P(None, b_ax, t_ax, *([None] * (a.ndim - 3))))
    cache_sh = {k: None if v is None else tuple(
        jax.device_put(a, spec(a)) for a in v) for k, v in cache.items()}
    with mesh:
        l2, new = jax.jit(lambda pp, cc, t: tr.decode_step(
            pp, cfg, cc, t, jnp.int32(8)))(p, cache_sh, toks[:, 8:9])
    tr.DECODE_SHARD_MAP = tr.MOE_SHARD_MAP = None
    tr.CACHE_UPDATE = "dus"
    save(f"{name}/params", p)
    save(f"{name}/toks", toks)
    save(f"{name}/cache", {k: v for k, v in cache.items() if v is not None})
    save(f"{name}/new", {k: v for k, v in new.items() if v is not None})
    save(f"{name}/l1", l1)
    save(f"{name}/l2", l2)

gqa = tr.LMConfig(**DECODE_CFG)
decode_case("gqa_b4", gqa, 4, False)
decode_case("gqa_b1", gqa, 1, False)
mla = dataclasses.replace(get_arch("deepseek-v3-671b").smoke(),
                          dtype="float32")
decode_case("mla_b4", mla, 4, True)
np.savez(out_path, **res)
print("REFERENCES_OK")
"""


def unflatten(flat: dict, prefix: str) -> dict:
    """The nested dict of the npz entries under ``prefix/``."""
    out: dict = {}
    for key, a in flat.items():
        if not key.startswith(prefix + "/"):
            continue
        parts = key[len(prefix) + 1:].split("/")
        node = out
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = a
    return out


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, copy=True))


def _tree(d):
    return {k: _tree(v) for k, v in d.items()} if isinstance(d, dict) \
        else _t(d)


def _mla_cfg():
    import dataclasses
    return dataclasses.replace(get_arch("deepseek-v3-671b").smoke(),
                               dtype="float32")


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _rank_moe(mesh, flat, name):
    cfg = tr.LMConfig(**MOE_CASES[name])
    one = _tree(unflatten(flat, f"{name}/one"))
    x = _t(flat[f"{name}/x"])
    specs = make_param_specs({"experts": one["experts"]}, mesh,
                             lm_rules(mesh, fsdp=True))["experts"]
    blocks = {k: local_slice(v, specs[k], mesh).clone().requires_grad_()
              for k, v in one["experts"].items()}
    router = one["router"].requires_grad_()
    shared = {k: v.requires_grad_() for k, v in one["shared"].items()}
    n = x.shape[0] // mesh.axes_size("data")
    x_loc = x[mesh.axis_index("data") * n:][:n].clone().requires_grad_()
    drops: list = []
    mesh.reset_counts()
    out = tr._moe_mlp({"router": router, "experts": blocks,
                       "shared": shared}, cfg, x_loc, drops, mesh=mesh)
    counts = (dict(mesh.calls), dict(mesh.bytes))
    (out ** 2).sum().backward()
    return {"out": out.detach(), "x_grad": x_loc.grad,
            "router": router.grad, "shared": {k: v.grad
                                              for k, v in shared.items()},
            "experts": {k: v.grad for k, v in blocks.items()},
            "specs": specs, "drops": int(sum(drops)), "counts": counts,
            "mode": tr.moe_mesh_mode(cfg, mesh)}


def _rank_decode(mesh, flat, name, cfg, b):
    params = _tree(unflatten(flat, f"{name}/params"))
    if cfg.attn == "mla":
        for key in ("dense_layers", "moe_layers"):
            if key in params:
                w = params[key]["attn"]["wkv_b"]
                params[key]["attn"]["wkv_b"] = local_slice(
                    w, P(None, None, "model"), mesh).clone()
    model = tr.Transformer(cfg, params)
    cache = unflatten(flat, f"{name}/cache")
    specs = model.cache_specs(b, mesh)
    local = {k: None if specs[k] is None else tuple(
        local_slice(_t(a), s, mesh).clone()
        for a, s in zip((cache[k]["0"], cache[k]["1"]), specs[k]))
        for k in specs}
    toks = _t(flat[f"{name}/toks"])
    mesh.reset_counts()
    logits, local = model.decode_step(local, toks[:, 8:9], 8, mesh=mesh)
    return {"logits": logits, "cache": local, "specs": specs,
            "counts": (dict(mesh.calls), dict(mesh.bytes))}


def _rank_all(mesh, npz_path):
    with np.load(npz_path) as z:
        flat = {k: z[k] for k in z.files}
    out = {f"moe_{name}": _rank_moe(mesh, flat, name) for name in MOE_CASES}
    gqa = tr.LMConfig(**DECODE_CFG)
    out["gqa_b4"] = _rank_decode(mesh, flat, "gqa_b4", gqa, 4)
    out["gqa_b1"] = _rank_decode(mesh, flat, "gqa_b1", gqa, 1)
    out["mla_b4"] = _rank_decode(mesh, flat, "mla_b4", _mla_cfg(), 4)
    out["coords"] = (mesh.axis_index("data"), mesh.axis_index("model"))
    return out


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    path = tmp_path_factory.mktemp("shard_map") / "refs.npz"
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    out = subprocess.run(
        [sys.executable, "-c", SCRIPT, repr(MOE_CASES), repr(DECODE_CFG),
         str(path)], env=env, capture_output=True, text=True, timeout=420,
        cwd=ROOT)
    assert "REFERENCES_OK" in out.stdout, out.stdout[-1500:] \
        + out.stderr[-3000:]
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return path, flat


@pytest.fixture(scope="module")
def ranks(refs):
    return spawn(MESH, _rank_all, str(refs[0]), device="cpu",
                 timeout=GROUP_TIMEOUT, join_timeout=JOIN_TIMEOUT)


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / (np.abs(b).max() + 1e-9))


def _whole(blocks_by_rank, spec, coords):
    """The whole tensor from each rank's block under ``spec`` on the 2 x 4
    mesh (coords: each rank's (data, model) index)."""
    sizes = {"data": MESH[0], "model": MESH[1]}
    first = np.asarray(blocks_by_rank[0])
    shape = list(first.shape)
    for dim, ax in enumerate(spec):
        if ax is not None:
            shape[dim] *= int(np.prod([sizes[a] for a in (
                ax if isinstance(ax, tuple) else (ax,))]))
    out = np.full(shape, np.nan, first.dtype)
    for blk, (d, m) in zip(blocks_by_rank, coords):
        idx = {"data": d, "model": m}
        sl = []
        for dim, ax in enumerate(spec):
            n = first.shape[dim]
            if ax is None:
                sl.append(slice(None))
                continue
            axes = ax if isinstance(ax, tuple) else (ax,)
            k = 0
            for a in axes:
                k = k * sizes[a] + idx[a]
            sl.append(slice(k * n, (k + 1) * n))
        out[tuple(sl)] = np.asarray(blk)
    assert not np.isnan(out).any()
    return out


# ---------------------------------------------------------------------------
# the tests
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,mode", [("ep", "ep"), ("drops", "ep"),
                                       ("tp", "tp")])
def test_ep_moe_matches_jax_shard_map(refs, ranks, name, mode):
    """Outputs on every rank of a model column equal, the data blocks
    together within 1e-5 of max |out| of the JAX shard_map (and, at no
    drops, of the JAX one-device layer); every gradient at relative error
    < 1e-5; one (T_loc, D) all_reduce over "model" a layer in the forward;
    at capacity factor 1 pairs drop on the port too."""
    _, flat = refs
    rs = [r[f"moe_{name}"] for r in ranks]
    coords = [r["coords"] for r in ranks]
    assert {r["mode"] for r in rs} == {mode}
    for r, (d, m) in zip(rs, coords):
        np.testing.assert_array_equal(r["out"].numpy(),
                                      rs[coords.index((d, 0))]["out"].numpy())
        t_loc, dm = r["out"].shape[0] * r["out"].shape[1], r["out"].shape[2]
        calls, nbytes = r["counts"]
        assert calls.get("all_reduce") == 1
        assert nbytes["all_reduce"] == t_loc * dm * 4
    out = np.concatenate([rs[coords.index((d, 0))]["out"].numpy()
                          for d in range(MESH[0])])
    want = flat[f"{name}/out"]
    assert np.abs(out - want).max() <= TOL * np.abs(want).max()
    if name != "drops":
        ref = flat[f"{name}/ref"]
        assert np.abs(out - ref).max() <= TOL * np.abs(ref).max()
    else:
        assert sum(r["drops"] for r in rs if r) > 0
    g_sm = unflatten(flat, f"{name}/g_sm")
    errs = {}
    for key, spec in rs[0]["specs"].items():
        whole = _whole([r["experts"][key] for r in rs], spec, coords)
        errs[f"experts/{key}"] = _rel(whole, g_sm["0"]["experts"][key])
    col0 = [rs[coords.index((d, 0))] for d in range(MESH[0])]
    errs["router"] = _rel(sum(r["router"].numpy() for r in col0),
                          g_sm["0"]["router"])
    for key in col0[0]["shared"]:
        errs[f"shared/{key}"] = _rel(
            sum(r["shared"][key].numpy() for r in col0),
            g_sm["0"]["shared"][key])
    errs["x"] = _rel(np.concatenate([r["x_grad"].numpy() for r in col0]),
                     flat[f"{name}/g_sm/1"])
    assert max(errs.values()) < TOL, errs


@pytest.mark.parametrize("name,b", [("gqa_b4", 4), ("gqa_b1", 1),
                                    ("mla_b4", 4)])
def test_split_kv_decode_matches_jax(refs, ranks, name, b):
    """Logits on every rank within 1e-5 of max |logit| of the JAX
    shard_map decode and of its one-device decode; each rank's cache block
    after the step within 1e-5 of max |cache| of JAX's new cache's block
    (the slot written on the rank that owns it; a later layer's entries
    carry the earlier layers' float32 order); the all_reduces a layer: one max and one sum
    (GQA) or one max and two sums and one gather of wkv_b (MLA)."""
    _, flat = refs
    coords = [r["coords"] for r in ranks]
    l2, l1 = flat[f"{name}/l2"], flat[f"{name}/l1"]
    for r in ranks:
        lg = r[name]["logits"].numpy()
        assert lg.shape == l2.shape
        assert np.abs(lg - l2).max() <= TOL * np.abs(l2).max()
        assert np.abs(lg - l1).max() <= TOL * np.abs(l1).max()
    new = unflatten(flat, f"{name}/new")
    specs = ranks[0][name]["specs"]
    for key, pair in specs.items():
        if pair is None:
            continue
        for i, spec in enumerate(pair):
            whole = _whole([r[name]["cache"][key][i] for r in ranks], spec,
                           coords)
            want = new[key][str(i)]
            assert np.abs(whole - want).max() <= TOL * np.abs(want).max()
    calls = ranks[0][name]["counts"][0]
    n_layers = 3 if name.startswith("mla") else 2
    if name.startswith("mla"):
        # 3 per MLA layer, and one per expert-parallel MoE layer (2 of 3)
        assert calls["all_reduce"] == 3 * n_layers + 2
        assert calls["all_gather"] == n_layers + 1    # wkv_b, the logits
    else:
        assert calls["all_reduce"] == 2 * n_layers
        assert calls.get("all_gather", 0) == (1 if b > 1 else 0)


# ---------------------------------------------------------------------------
# the flash op's log-sum-exp (the split decode's per-rank partial)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("g,s,t,q_start,causal", [
    (4, 1, 40, 39, True), (4, 1, 40, 7, True), (1, 3, 33, 0, True),
    (48, 1, 20, 19, True), (2, 5, 17, 0, False)])
def test_flash_lse_plain_version(g, s, t, q_start, causal):
    """`attention_lse_ref` (the op's CPU route with ``return_lse``): the
    output equals `attention_ref`'s and the lse equals numpy's
    log-sum-exp of the scaled, masked float64 scores; a row that sees no
    key has lse -inf and output 0."""
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.flash_attention.ref import (attention_lse_ref,
                                                         attention_ref)
    rng = np.random.default_rng(g * 100 + t)
    q = torch.from_numpy(rng.standard_normal((2, 2 * g, s, 16))
                         .astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((2, 2, t, 16))
                         .astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((2, 2, t, 16))
                         .astype(np.float32))
    out, lse = flash_attention(q, k, v, causal=causal, q_start=q_start,
                               return_lse=True)
    np.testing.assert_allclose(out.numpy(), attention_ref(
        q, k, v, causal=causal, q_start=q_start).numpy(), atol=1e-6)
    kk = np.repeat(k.numpy().astype(np.float64), g, axis=1)
    sc = np.einsum("bhsd,bhtd->bhst", q.numpy().astype(np.float64),
                   kk) / 4.0
    if causal:
        vis = np.arange(t)[None, :] <= np.arange(s)[:, None] + q_start
        sc = np.where(vis, sc, -np.inf)
    m = sc.max(axis=-1, keepdims=True)
    want = (m + np.log(np.exp(sc - m).sum(axis=-1, keepdims=True)))[..., 0]
    np.testing.assert_allclose(lse.numpy(), want, rtol=0, atol=1e-5)
    empty_out, empty_lse = attention_lse_ref(q, k[:, :, :0], v[:, :, :0],
                                             causal=False)
    assert torch.equal(empty_out, torch.zeros_like(q))
    assert bool(torch.isneginf(empty_lse).all())


def test_flash_lse_plan_forces_the_split_route():
    """`kernel.plan(..., lse=True)` takes the split route at every shape
    (one chunk where the unsplit grid would fill the card, where the
    ordinary plan picks "tile"), its chunks covering [0, t_end)."""
    from repro_torch.kernels.flash_attention import kernel as fk
    for (b, hkv, g, s, t, qs) in ((4, 8, 4, 1, 8192, 8184),
                                  (64, 8, 4, 1, 2000, 1999),
                                  (1, 2, 16, 1, 64, 0),
                                  (2, 2, 4, 4, 500, 100)):
        q = torch.zeros(b, hkv * g, s, 128)
        k = torch.zeros(b, hkv, t, 128)
        p = fk.plan(q, k, k, causal=True, q_start=qs, lse=True)
        assert p.route == "split"
        assert p.t_end == min(t, qs + s)
        assert (p.n_split - 1) * p.chunk < p.t_end <= p.n_split * p.chunk
    big = fk.plan(torch.zeros(64, 32, 1, 128), torch.zeros(64, 8, 2000, 128),
                  torch.zeros(64, 8, 2000, 128), causal=True, q_start=1999)
    assert big.route == "tile" and big.n_split == 1


@pytest.mark.parametrize("g,s", [(4, 1), (48, 1), (6, 4), (16, 1)])
def test_flash_lse_groups_of_rows(monkeypatch, g, s):
    """The op's card route (`ops._with_lse`) with the kernel's launch
    stood in by its plain version: a KV head's G * S rows past the split
    route's 16 go in groups of query heads, one launch each, and the
    groups' outputs and lse land in their heads."""
    from repro_torch.kernels.flash_attention import ops
    from repro_torch.kernels.flash_attention.ref import attention_lse_ref

    def fake_kernel(q, k, v, *, causal, scale, q_start, route, lse):
        assert route.route == "split" and q.shape[1] // k.shape[1] * \
            q.shape[2] <= 16
        out, ls = attention_lse_ref(q, k, v, causal=causal, scale=scale,
                                    q_start=q_start)
        lse.copy_(ls)
        return out
    monkeypatch.setattr(ops, "flash_attention_kernel", fake_kernel)
    rng = np.random.default_rng(g + s)
    q = torch.from_numpy(rng.standard_normal((2, s, 2 * g, 16))
                         .astype(np.float32)).transpose(1, 2)
    k = torch.from_numpy(rng.standard_normal((2, 2, 50, 16))
                         .astype(np.float32))
    n0 = ops.flash_attention.launches
    out, lse = ops._with_lse(q, k, k, causal=True, scale=0.25, q_start=40)
    want_out, want_lse = attention_lse_ref(q, k, k, scale=0.25, q_start=40)
    assert ops.flash_attention.launches - n0 == -(-g // (16 // s))
    np.testing.assert_allclose(out.numpy(), want_out.numpy(), atol=1e-6)
    np.testing.assert_allclose(lse.numpy(), want_lse.numpy(), atol=1e-6)
