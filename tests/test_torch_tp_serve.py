"""Tensor-parallel LM serving on a 2 x 2 mesh of gloo ranks (one process a
rank, on the CPU): the port's mesh prefill (`Transformer.prefill(...,
mesh=)` over each rank's `lm_rules` blocks and its block of the batch)
and one decode step from the cache it leaves (`decode_step(..., mesh=)`),
for three smoke configs in float32:

- granite-20b-smoke: MQA, its one KV head over two model ranks (``wk`` /
  ``wv`` blocks of half a head, gathered for the prefill);
- granite-3-8b-smoke: GQA, a KV head a model rank;
- deepseek-v3-smoke under `lm_rules(fsdp=True)` (``LM_SERVE_FSDP``): MLA
  with ``wq_b`` / ``wkv_b`` / ``wo`` over "model", the dense and expert
  dims over "data" too, the MoE layers expert-parallel, at a capacity
  factor where no pair drops (the one-device layer's capacity rule differs
  from the mesh's local one where pairs drop).

Held against:

- the reference's sharded program: one JAX subprocess on 4 virtual CPU
  devices (XLA_FLAGS must not leak into this process) jits the reference's
  `prefill` and `decode_step` with ``in_shardings`` from its
  `lm_rules(mesh, fsdp=)`, the tokens under P("data", None), and
  ``ACT_SHARDING``, ``MOE_SHARD_MAP``, ``DECODE_SHARD_MAP`` and
  ``CACHE_UPDATE = "masked"`` set as its `build_lm_cell` sets them; the
  prefill's cache under its `_cache_specs_tree(..., "model")`. The ranks'
  logit blocks put together are within TOL of max |logit| of its logits,
  and each rank's cache block within TOL of max |cache| of the
  reference's block, after the prefill and after the step;
- the port's one-device path within the same bound;
- the same pass over whole leaves on the mesh (one mesh path: no
  tensor-parallel collective where nothing is split).

The collectives a pass counts equal the per-layer formula
(`expected_calls`), and a `MetaMesh` rank running the prefill and decode
cells (`launch.cells`) at the same shapes counts the same calls and bytes.
No rank holds a whole leaf that `lm_rules` splits over "model", but for
the ``wk`` / ``wv`` the prefill gathers and the ``wkv_b`` the MLA decode
gathers. The weights are the port's, drawn from a seed; the ranks import
this module, so JAX is imported only in the subprocess.
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
from repro_torch.sharding.rules import (Blocks, P, data_axes,  # noqa: E402
                                        lm_rules, local_slice,
                                        make_param_specs, model_block_dim)
from repro_torch.tree import leaves_with_path, tree_map  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESH = (2, 2)
B, S, T = 2, 16, 32          # batch, prompt, cache slots
TOL = 1e-5
CASES = {"granite-20b": ("granite-20b", {}),
         "granite-3-8b": ("granite-3-8b", {}),
         "deepseek-v3": ("deepseek-v3-671b", {"capacity_factor": 8.0})}
# leaves a pass gathers whole over "model" by design
GATHERED = ("attn/wk", "attn/wv", "attn/wkv_b")
TIMEOUT, JOIN = 120.0, 300.0


def case_cfg(name: str):
    arch, over = CASES[name]
    return dataclasses.replace(get_arch(arch).smoke(), dtype="float32",
                               **over)


def case_fsdp(name: str) -> bool:
    return cells.LM_SERVE_FSDP.get(CASES[name][0], False)


def case_inputs(name: str) -> tuple[dict, np.ndarray]:
    """(weights {path: array}, tokens (B, S + 1)): the port's seeded
    weights, tokens from numpy."""
    cfg = case_cfg(name)
    model = lm.Transformer.random(cfg, seed=5, device="cpu")
    weights = {p: t.numpy().copy()
               for p, t in leaves_with_path(model.param_tree())}
    rng = np.random.default_rng(17)
    return weights, rng.integers(0, cfg.vocab_size,
                                 (B, S + 1)).astype(np.int32)


def whole_model(name: str, weights) -> lm.Transformer:
    cfg = case_cfg(name)
    model = lm.Transformer.random(cfg, seed=5, device="cpu")
    with torch.no_grad():
        for path, t in leaves_with_path(model.param_tree()):
            t.copy_(torch.from_numpy(weights[path]))
    return model


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

def _serve(mesh, model, toks, batch):
    """The mesh prefill of this rank's tokens, then one decode step from
    its cache: logits, the cache after each, the collectives of each and
    every all-gather's output shape."""
    shapes = []
    gather = mesh.all_gather

    def counted(t, axes, dim=0, **kw):
        out = gather(t, axes, dim, **kw)
        shapes.append(tuple(out.shape))
        return out
    mesh.all_gather = counted
    try:
        mesh.reset_counts()
        with torch.no_grad():
            logits, cache = model.prefill(toks[:, :S], T, mesh=mesh,
                                          batch=batch)
            counts = {"prefill": (dict(mesh.calls), dict(mesh.bytes))}
            after = tree_map(lambda t: t.clone(), cache)
            mesh.reset_counts()
            step, _ = model.decode_step(cache, toks[:, S:], S, mesh=mesh,
                                        batch=batch)
            counts["decode"] = (dict(mesh.calls), dict(mesh.bytes))
    finally:
        mesh.all_gather = gather
    return {"prefill": logits, "decode": step, "cache": after,
            "new": cache, "counts": counts, "gathered": shapes}


def _rank(mesh, inputs):
    out = {"coords": (mesh.axis_index("data"), mesh.axis_index("model"))}
    n = B // mesh.axes_size("data")
    rows = slice(mesh.axis_index("data") * n, (mesh.axis_index("data") + 1)
                 * n)
    for name, (weights, toks) in inputs.items():
        model = whole_model(name, weights)
        specs = make_param_specs(model.param_tree(), mesh,
                                 lm_rules(mesh, fsdp=case_fsdp(name)))
        blocks = tree_map(lambda t, s: local_slice(t, s, mesh).clone(),
                          model.param_tree(), specs)
        tp = model.on_blocks(Blocks(blocks, specs, mesh))
        mine = torch.from_numpy(toks[rows])
        res = _serve(mesh, tp, mine, B)
        res["blocks"] = {p: tuple(t.shape) for p, t in
                         leaves_with_path(blocks)}
        if name == "granite-3-8b":
            res["whole_leaves"] = _serve(mesh, model, mine, B)
        out[name] = res
    return out


SCRIPT = r"""
import dataclasses, json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import numpy as np
import jax, jax.numpy as jnp
from functools import partial
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_arch
from repro.launch.cells import LM_SERVE_FSDP, _cache_specs_tree
from repro.models import transformer as tr
from repro.sharding.rules import _path_str, lm_rules, make_param_specs

cases, (B, S, T) = json.loads(sys.argv[1]), json.loads(sys.argv[2])
inp, out_path = np.load(sys.argv[3]), sys.argv[4]
mesh = jax.sharding.Mesh(np.array(jax.devices()).reshape(2, 2),
                         ("data", "model"))
ns = lambda s: NamedSharding(mesh, s)
info = {"mesh": mesh, "dp": "data", "model": "model"}
out = {}

def save(prefix, tree):
    for p, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        out[f"{prefix}/{_path_str(p)}"] = np.asarray(leaf)

for name, (arch, over) in cases.items():
    cfg = dataclasses.replace(get_arch(arch).smoke(), dtype="float32", **over)
    pshape = jax.eval_shape(partial(tr.init_params, cfg),
                            jax.random.PRNGKey(0))
    flat, treedef = jax.tree_util.tree_flatten_with_path(pshape)
    params = jax.tree_util.tree_unflatten(treedef, [
        jnp.asarray(inp[f"{name}/w/{_path_str(p)}"]) for p, _ in flat])
    pspecs = make_param_specs(pshape, mesh, lm_rules(
        mesh, fsdp=LM_SERVE_FSDP.get(arch, False)))
    psh = jax.tree.map(ns, pspecs)
    toks = jnp.asarray(inp[f"{name}/tokens"])
    cspecs = jax.tree.map(ns, _cache_specs_tree(
        cfg, jax.eval_shape(partial(tr.init_cache, cfg, B, T)), mesh,
        "model"))
    # build_lm_cell's switches: activations batch-over-data, the MoE
    # layers under shard_map
    tr.ACT_SHARDING = ns(P("data", None, None))
    if cfg.moe:
        tr.MOE_SHARDING = ns(P("model", "data", None))
        tr.MOE_WIN_SHARDING = tr.MOE_WOUT_SHARDING = ns(P("model", None,
                                                          None))
        tr.MOE_SHARD_MAP = info
    tr.CACHE_UPDATE, tr.DECODE_SHARD_MAP = "dus", None

    def prefill_step(p, t):
        logits, cache = tr.prefill(p, cfg, t, T)
        return logits[:, -1, :], cache
    with mesh:
        logits, cache = jax.jit(
            prefill_step, in_shardings=(psh, ns(P("data", None))),
            out_shardings=(ns(P("data", "model")), cspecs))(
            params, toks[:, :S])
        tr.CACHE_UPDATE, tr.DECODE_SHARD_MAP = "masked", info
        step, new = jax.jit(
            lambda p, c, t, cur: tr.decode_step(p, cfg, c, t, cur),
            in_shardings=(psh, cspecs, ns(P("data", None)), ns(P())),
            out_shardings=(ns(P("data", None, "model")), cspecs))(
            params, cache, toks[:, S:], jnp.int32(S))
    tr.ACT_SHARDING = tr.MOE_SHARDING = tr.MOE_SHARD_MAP = None
    tr.MOE_WIN_SHARDING = tr.MOE_WOUT_SHARDING = None
    tr.CACHE_UPDATE, tr.DECODE_SHARD_MAP = "dus", None
    out[f"{name}/prefill"] = np.asarray(logits)
    out[f"{name}/decode"] = np.asarray(step)
    save(f"{name}/cache", {k: v for k, v in cache.items() if v is not None})
    save(f"{name}/new", {k: v for k, v in new.items() if v is not None})
np.savez(out_path, **out)
print("TP_REF_OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the reference's npz, every rank's results): the JAX
    subprocess runs while the ranks do."""
    inputs = {name: case_inputs(name) for name in CASES}
    d = tmp_path_factory.mktemp("tp_serve")
    flat = {f"{n}/w/{p}": a for n, (w, _) in inputs.items()
            for p, a in w.items()}
    flat.update({f"{n}/tokens": t for n, (_, t) in inputs.items()})
    np.savez(d / "in.npz", **flat)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    proc = subprocess.Popen(
        [sys.executable, "-c", SCRIPT, json.dumps(CASES),
         json.dumps([B, S, T]), str(d / "in.npz"), str(d / "ref.npz")],
        env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    try:
        ranks = spawn(MESH, _rank, inputs, device="cpu", timeout=TIMEOUT,
                      join_timeout=JOIN)
        so, se = proc.communicate(timeout=300)
    finally:
        proc.kill()
    assert "TP_REF_OK" in so, so[-1500:] + se[-3000:]
    return inputs, dict(np.load(d / "ref.npz")), ranks


def _coords(rank: int) -> MetaMesh:
    return MetaMesh(MESH, ("data", "model"), rank=rank)


def _assemble(blocks, spec) -> np.ndarray:
    """The whole array from each rank's block under ``spec`` (rank
    order)."""
    first = blocks[0]
    mesh = _coords(0)
    shape = [n * (mesh.axes_size(ax) if ax is not None else 1)
             for n, ax in zip(first.shape, spec)]
    out = np.full(shape, np.nan, np.float32)
    for rank, blk in enumerate(blocks):
        idx = tuple(slice(None) if ax is None else slice(
            _coords(rank).axis_index(ax) * n,
            (_coords(rank).axis_index(ax) + 1) * n)
            for n, ax in zip(blk.shape, spec))
        out[idx] = blk
    assert not np.isnan(out).any()
    return out


def _within(got, want, tol=TOL) -> float:
    err = float(np.abs(np.asarray(got) - want).max())
    assert err <= tol * float(np.abs(want).max()), (err, np.abs(want).max())
    return err


@pytest.mark.parametrize("name", sorted(CASES))
def test_prefill_logits_match_the_reference_and_one_device(runs, name):
    """The last position's logits: each rank's (B / data, V / model)
    block, put together, against the reference's sharded prefill and the
    port's one-device prefill."""
    inputs, ref, ranks = runs
    got = _assemble([r[name]["prefill"].numpy() for r in ranks],
                    P("data", "model"))
    _within(got, ref[f"{name}/prefill"])
    weights, toks = inputs[name]
    with torch.no_grad():
        one, _ = whole_model(name, weights).prefill(
            torch.from_numpy(toks[:, :S]), T)
    _within(got, one[:, -1].numpy())


@pytest.mark.parametrize("name", sorted(CASES))
def test_decode_from_the_prefill_cache_matches(runs, name):
    """One step at position S from the cache the mesh prefill left: the
    ranks' (B / data, 1, V / model) blocks against the reference's sharded
    step from its own prefill's cache and the port's one-device step."""
    inputs, ref, ranks = runs
    got = _assemble([r[name]["decode"].numpy() for r in ranks],
                    P("data", None, "model"))
    _within(got, ref[f"{name}/decode"])
    weights, toks = inputs[name]
    model = whole_model(name, weights)
    with torch.no_grad():
        _, cache = model.prefill(torch.from_numpy(toks[:, :S]), T)
        one, _ = model.decode_step(cache, torch.from_numpy(toks[:, S:]), S)
    _within(got, one.numpy())


@pytest.mark.parametrize("name", sorted(CASES))
def test_cache_blocks_match_the_references(runs, name):
    """Each rank's cache block (the prefill's, then after the step) in
    the layout `Transformer.cache_specs` gives, which for a batch over the
    data axes is the reference's `_cache_specs_tree(..., "model")`: its
    block of the reference's cache."""
    _, ref, ranks = runs
    cfg = case_cfg(name)
    specs = lm.Transformer.random(cfg, device="meta").cache_specs(
        B, _coords(0))
    for key, pair in specs.items():
        if pair is None:
            continue
        for i, spec in enumerate(pair):
            for when in ("cache", "new"):
                want = ref[f"{name}/{when}/{key}/{i}"]
                top = float(np.abs(want).max())
                for rank, r in enumerate(ranks):
                    blk = r[name][when][key][i].numpy()
                    cut = local_slice(torch.from_numpy(want), spec,
                                      _coords(rank)).numpy()
                    assert blk.shape == cut.shape
                    assert np.abs(blk - cut).max() <= TOL * top, \
                        (key, i, when, rank)


@pytest.mark.parametrize("name", sorted(CASES))
def test_no_rank_holds_a_whole_split_leaf(runs, name):
    """Every leaf that `lm_rules` splits over "model" is a block on each
    rank, and no all-gather of a pass gives one whole, but for the
    ``wk`` / ``wv`` and ``wkv_b`` the path gathers by design."""
    inputs, _, ranks = runs
    cfg = case_cfg(name)
    model = lm.Transformer.random(cfg, device="meta")
    specs = make_param_specs(model.param_tree(), _coords(0),
                             lm_rules(_coords(0), fsdp=case_fsdp(name)))
    whole = dict((p, tuple(t.shape)) for p, t in
                 leaves_with_path(model.param_tree()))
    split = {p for p, s in leaves_with_path(specs)
             if model_block_dim(s, _coords(0)) is not None}
    assert any(p.endswith("attn/wo") for p in split)
    forbidden = {whole[p][1:] if p.split("/")[0].endswith("_layers")
                 else whole[p] for p in split
                 if not p.endswith(GATHERED)}
    for r in ranks:
        for p in split:
            assert r[name]["blocks"][p] != whole[p], p
        assert not forbidden & set(r[name]["gathered"]), name


# ---------------------------------------------------------------------------
# the collectives: the per-layer formula, the MetaMesh twin
# ---------------------------------------------------------------------------

def expected_calls(kind: str, specs, cfg, mesh) -> dict:
    """A pass's collectives by the layout's formula. Each leaf a pass
    uses is gathered once over the data axes where a dim is stored there
    (one all_gather; the embedding, the final norm and the head once, a
    layer's leaves once a layer). The vocabulary-parallel embedding is one
    all_reduce. A layer: GQA prefill, ``wk`` and ``wv`` gathered over
    "model" and ``wo``'s all_reduce; GQA decode, one all_gather of the
    new token's q, k and v blocks, the split-KV max and sum and ``wo``'s
    all_reduce; MLA prefill, ``wo``'s all_reduce; MLA decode, q and
    ``wkv_b`` gathered, the split max and two sums and ``wo``'s
    all_reduce; then one all_reduce for the MLP, or for the routed experts
    with the shared expert's partial joined."""
    dp = set(data_axes(mesh))

    def data_gathers(tree) -> int:
        return sum(any(ax is not None and set(
            ax if isinstance(ax, tuple) else (ax,)) <= dp
            and mesh.axes_size(ax) > 1 for ax in s)
            for _, s in leaves_with_path(tree))

    prefill = kind == "prefill"
    ag = data_gathers({k: specs[k] for k in ("embed", "final_norm",
                                              "lm_head")})
    ar = 1
    n_dense, n_moe = lm._depths(cfg)
    for key, n in (("dense_layers", n_dense), ("moe_layers", n_moe)):
        if not n:
            continue
        ag += n * data_gathers(lm.layer_specs(specs, key))
        if cfg.attn == "mla":
            ag += n * (0 if prefill else 2)
            ar += n * (1 if prefill else 4)
        else:
            ag += n * (2 if prefill else 1)
            ar += n * (1 if prefill else 3)
        ar += n
    return {"all_gather": ag, "all_reduce": ar}


def _meta_cells(name: str, rank: int) -> dict:
    """The prefill and decode cells of the case on a `MetaMesh` rank at
    the ranks' shapes: each pass's calls and bytes."""
    out = {}
    for kind, shape, sd in (("prefill", "prefill_32k", dict(seq=S, batch=B)),
                            ("decode", "decode_32k", dict(seq=T, batch=B))):
        mesh = _coords(rank)
        cell = cells.build_lm_cell(CASES[name][0], shape, mesh,
                                   cfg=case_cfg(name), shape_def=sd)
        mesh.reset_counts()
        cell.fn(*cell.args)
        out[kind] = (dict(mesh.calls), dict(mesh.bytes), cell.param_specs)
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_collectives_follow_the_per_layer_formula(runs, name):
    _, _, ranks = runs
    cfg = case_cfg(name)
    for rank, r in enumerate(ranks):
        meta = _meta_cells(name, rank)
        for kind in ("prefill", "decode"):
            calls, nbytes = r[name]["counts"][kind]
            assert calls == expected_calls(kind, meta[kind][2], cfg,
                                           _coords(rank)), (kind, calls)
            assert (calls, nbytes) == meta[kind][:2], kind


def test_whole_leaves_run_the_same_mesh_path(runs):
    """A model over whole leaves on the mesh runs the same pass with no
    tensor-parallel collective: the prefill none at all, the step the
    split-KV max and sum a layer; its logits equal the blocks' within
    TOL."""
    _, _, ranks = runs
    cfg = case_cfg("granite-3-8b")
    for r in ranks:
        tp, whole = r["granite-3-8b"], r["granite-3-8b"]["whole_leaves"]
        assert whole["counts"]["prefill"][0] == {}
        assert whole["counts"]["decode"][0] == {
            "all_reduce": 2 * cfg.n_layers}
        for kind in ("prefill", "decode"):
            want = tp[kind].numpy()
            v = want.shape[-1]
            m = r["coords"][1]
            _within(whole[kind].numpy()[..., m * v:(m + 1) * v], want)


@pytest.mark.parametrize("h0,h1,group,want", [
    (0, 2, 4, (0, 1)),                # two q heads share one KV head
    (6, 9, 48, (0, 1)),               # granite-20b's 48 on 16 ranks: 3
    (4, 8, 4, (1, 2)),                # one whole group
    (0, 8, 4, (0, 2)),                # two whole groups
    (6, 12, 6, (1, 2)),               # nemotron's 48 heads over 8: 6 a rank
    (0, 3, 1, (0, 3)),                # one KV head a q head
    (2, 6, 4, None),                  # halves of two groups: refused
])
def test_kv_heads_of_a_ranks_q_heads(h0, h1, group, want):
    if want is None:
        with pytest.raises(ValueError, match="no equal groups"):
            lm._kv_heads(h0, h1, group)
    else:
        assert lm._kv_heads(h0, h1, group) == want


def test_model_block_dim_reads_the_spec():
    mesh = MetaMesh((2, 2), ("data", "model"))
    assert model_block_dim(P("data", "model"), mesh) == 1
    assert model_block_dim(P("model", None), mesh) == 0
    assert model_block_dim(P(None, "data"), mesh) is None
    assert model_block_dim(None, mesh) is None
    assert model_block_dim(P(None, "model"),
                           MetaMesh((4, 1), ("data", "model"))) is None
    assert model_block_dim(P("data"), MetaMesh((4,), ("data",))) is None
