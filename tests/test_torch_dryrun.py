"""The dry run on the meta device (`launch/{cells,components,dryrun}`,
`engine.federated.lower_engine`, `launch.mesh.MetaMesh`, the kernel ops'
meta branches) against the JAX package's dry run and against real runs.

- The cells: one JAX subprocess on 512 virtual devices calls the
  reference's `build_cell` (no lowering, no compile) for the 40 cells on
  16 x 16 and one cell a family on 2 x 16 x 16 and writes each cell's kind,
  MODEL_FLOPS, meta, every parameter leaf's shape, dtype and
  PartitionSpec, and each argument's shard bytes; the port's cells match
  exactly, but for the arguments ``meta["layout"]`` names.
- Components: `lm_component_costs` recombined equals the whole meta
  program, FLOPs and collective bytes, exactly, for 2-layer smoke LMs
  (dense, MoE, MLA with MTP) at accum 2 on a 2 x 2 `MetaMesh`, every shape.
- Meta against real: the smoke LM's and xDeepFM's training steps on a
  1 x 1 mesh give the same dispatcher FLOPs, argument bytes and live-bytes
  peak on meta tensors as over a real CPU run; a `MetaMesh` rank counts
  the calls and bytes of a real 2 x 2 gloo `DeviceMesh` rank over one mesh
  Trainer step of the smoke LM.
- The kernel ops on meta tensors: outputs of the plain versions' shapes
  and dtypes, no launch counted, `kernels.meta_cost` by the bound
  formulas.
- Engine rows: `lower_engine`'s gathers against the reference's
  `lower_engine` + `collective_bytes` in a 4-device JAX subprocess (LUBM
  0.05, random placement, every template with a cut step): the same cut
  steps, one packed gather per step where the reference's program has two.
- The CLI in-process: records with the reference's keys and ``fits``.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.kernels.cin import ops as cin_ops  # noqa: E402
from repro_torch.kernels.embedding_bag import ops as emb_ops  # noqa: E402
from repro_torch.kernels.flash_attention import ops as flash_ops  # noqa: E402
from repro_torch.kernels.jaccard import ops as jac_ops  # noqa: E402
from repro_torch.kernels.kg_join import ops as join_ops  # noqa: E402
from repro_torch.kernels.kg_scan import ops as scan_ops  # noqa: E402
from repro_torch.kernels.segment_spmm import ops as seg_ops  # noqa: E402
from repro_torch.launch import cells, components, dryrun  # noqa: E402
from repro_torch.launch.mesh import (MetaMesh, make_device_mesh,  # noqa: E402
                                     make_production_mesh, spawn)
from repro_torch.tree import tree_leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# one cell a family on the multi-pod mesh
MULTIPOD = [("granite-3-8b", "train_4k"), ("qwen2-moe-a2.7b", "decode_32k"),
            ("gcn-cora", "minibatch_lg"), ("xdeepfm", "serve_p99")]
REF_KEYS = ("arch", "shape", "kind", "mesh", "n_chips", "model_flops",
            "flops", "bytes_accessed", "argument_size_bytes",
            "output_size_bytes", "temp_size_bytes", "peak_bytes_per_device",
            "collectives", "adjusted", "meta")

SCRIPT_CELLS = r'''
import os, sys, json
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=512"
import jax, numpy as np
from jax.sharding import NamedSharding
from repro.configs import all_cells
from repro.launch.cells import build_cell
from repro.launch.mesh import make_production_mesh
from repro.sharding.rules import _path_str
NAMES = {"train": ("params", "opt_state", "batch"),
         "prefill": ("params", "tokens"),
         "decode": ("params", "cache", "tokens", "cur"),
         "forward": ("params", "batch"),
         "retrieval": ("params", "query", "cand_ids")}
is_ns = lambda x: isinstance(x, NamedSharding)
def spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in s]
def shard_bytes(arg, sh):
    leaves = [l for l in jax.tree.leaves(arg) if hasattr(l, "shape")]
    shs = [s for s in jax.tree.leaves(sh, is_leaf=is_ns) if is_ns(s)]
    assert len(leaves) == len(shs)
    return int(sum(int(np.prod(s.shard_shape(l.shape))) * l.dtype.itemsize
                   for l, s in zip(leaves, shs)))
out = {}
todo = [(a, s, False) for a, s in all_cells()] + \
    [(a, s, True) for a, s in json.loads(sys.argv[1])]
for arch, shape, mp in todo:
    cell = build_cell(arch, shape, make_production_mesh(multi_pod=mp))
    flat = jax.tree_util.tree_flatten_with_path(cell.args[0])[0]
    shs = jax.tree.leaves(cell.in_shardings[0], is_leaf=is_ns)
    out[f"{arch}/{shape}/{'2x16x16' if mp else '16x16'}"] = dict(
        kind=cell.kind, model_flops=cell.model_flops,
        meta={k: v for k, v in cell.meta.items()
              if isinstance(v, (int, float, str, bool, dict))},
        leaves={_path_str(p): [list(l.shape), str(l.dtype), spec(s.spec)]
                for (p, l), s in zip(flat, shs)},
        arg_bytes={n: shard_bytes(a, s) for n, a, s in
                   zip(NAMES[cell.kind], cell.args, cell.in_shardings)})
json.dump(out, open(sys.argv[2], "w"))
print("CELLS_OK")
'''

SCRIPT_ENGINE = r'''
import os, sys, json, re
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
from repro.core.partitioner import random_partition
from repro.engine.federated import ShardedKG, lower_engine
from repro.engine.planner import make_plan
from repro.kg.generator import generate_lubm
from repro.kg.workloads import lubm_queries
from repro.launch.dryrun import collective_bytes
mesh = jax.make_mesh((1, 4), ("data", "model"))
store = generate_lubm(1, scale=0.05, seed=0)
qs = lubm_queries()
part = random_partition(store, qs, n_shards=4)
kg = ShardedKG.build(part)
out = {"cap": kg.cap, "rows": {}}
pat = re.compile(r"=\s*pred\[([0-9,]*)\][^=]*?all-gather(-start)?\(")
for q in qs:
    plan = make_plan(q, part)
    if not plan.cut_steps:
        continue
    hlo = lower_engine(plan, (kg.n_shards, kg.cap), mesh,
                       axis="model").compile().as_text()
    masks = []
    for line in hlo.splitlines():
        m = pat.search(line.strip())
        if m:
            dims = [int(d) for d in m.group(1).split(",") if d]
            masks.append(int(__import__("math").prod(dims)))
    out["rows"][q.name] = dict(coll=collective_bytes(hlo),
                               n_gathers=plan.n_gathers,
                               n_distributed_joins=len(plan.cut_steps),
                               mask_rows=sorted(masks))
json.dump(out, open(sys.argv[1], "w"))
print("ENGINE_OK")
'''


def _subprocess(script, *args, ok: str):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", script, *args], env=env,
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT)
    assert ok in out.stdout, out.stdout[-1500:] + out.stderr[-3000:]


def _norm(x):
    return json.loads(json.dumps(x))


def _mesh(multi_pod: bool) -> MetaMesh:
    shp = make_production_mesh(multi_pod=multi_pod)
    return MetaMesh(shp.sizes, shp.axis_names)


# ---------------------------------------------------------------------------
# the cells against the reference's build_cell
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_cells(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun") / "cells.json"
    _subprocess(SCRIPT_CELLS, json.dumps(MULTIPOD), str(path),
                ok="CELLS_OK")
    return json.loads(path.read_text())


def test_cells_match_the_references_build_cell(ref_cells):
    from repro_torch.configs import all_cells
    assert len(all_cells()) == 40
    assert len(ref_cells) == 40 + len(MULTIPOD)
    skipped = {}
    deepseek_serving = 0
    for key, ref in ref_cells.items():
        arch, shape, m = key.split("/")
        cell = cells.build_cell(arch, shape, _mesh(m == "2x16x16"))
        layout = cell.meta.get("layout", {})
        assert cell.kind == ref["kind"], key
        assert cell.model_flops == ref["model_flops"], key
        assert _norm({k: v for k, v in cell.meta.items()
                      if k != "layout"}) == ref["meta"], key
        assert _norm(cell.param_leaves()) == ref["leaves"], key
        mine = cell.arg_bytes()
        for name, b in ref["arg_bytes"].items():
            if name in layout:
                skipped[name] = skipped.get(name, 0) + 1
                continue
            assert mine[name] == b, (key, name)
        if cell.kind == "train":
            # the step's arguments are the reference's shards (the model
            # a view over the same blocks)
            apart = [n for n in ref["arg_bytes"] if n in layout]
            held = {id(t.untyped_storage()) for t in tree_leaves(
                cell.args[1])}
            assert all(id(t.untyped_storage()) in held for t in
                       tree_leaves(cell.args[0].param_tree())), key
            assert sum(mine[n] for n in ref["arg_bytes"] if n not in apart) \
                == sum(b for n, b in ref["arg_bytes"].items()
                       if n not in apart), key
        if arch == "deepseek-v3-671b" and cell.kind != "train":
            # the serving cells hand each rank its lm_rules(fsdp=True)
            # blocks: the reference's shard bytes
            assert "params" not in layout
            assert mine["params"] == ref["arg_bytes"]["params"], key
            deepseek_serving += 1
    assert deepseek_serving == 3
    # the divergences named: xDeepFM's whole tables and the decode step's
    # position (each GNN cell's batch is its graph_batch_specs block)
    assert skipped == {"params": 4, "cur": 11}


def test_lm_constants_are_the_references(ref_cells):
    # the knobs and the micro-batch halving (meta["mb"]) on both meshes
    for key, ref in ref_cells.items():
        if key.split("/")[1] == "train_4k":
            assert ref["meta"]["knobs"] == cells.LM_TRAIN_KNOBS[
                key.split("/")[0]]
    # 1,024 seeds + 15,360 + 153,600 sampled nodes (a multiple of 128
    # already), 168,960 edges
    assert cells.gnn_full_shapes("minibatch_lg") == dict(
        n=169_984, e=168_960, n_graphs=1)
    with pytest.raises(KeyError):
        cells.gnn_full_shapes("nope")


def test_cache_update_dus_raises():
    with pytest.raises(NotImplementedError, match="in place"):
        dryrun.main(["--arch", "granite-3-8b", "--shape", "decode_32k",
                     "--cache-update", "dus"])
    # nothing is left switched: the same process builds decode cells after
    assert cells.build_cell("granite-3-8b", "decode_32k",
                            _mesh(False)).kind == "decode"


# ---------------------------------------------------------------------------
# components, meta against real, collectives
# ---------------------------------------------------------------------------

SMOKE_SHAPES = {"train_4k": dict(seq=32, batch=8),
                "prefill_32k": dict(seq=64, batch=4),
                "decode_32k": dict(seq=64, batch=4),
                "long_500k": dict(seq=64, batch=1)}
KNOBS = dict(accum=2, fsdp=True, moments="float32")


def _smoke_lm(arch, shape, mesh, **kw):
    return cells.build_lm_cell(arch, shape, mesh,
                               cfg=get_arch(arch).smoke(),
                               shape_def=kw.get("sd", SMOKE_SHAPES[shape]),
                               knobs=KNOBS)


@pytest.mark.parametrize("arch", ["granite-3-8b", "qwen2-moe-a2.7b",
                                  "deepseek-v3-671b"])
@pytest.mark.parametrize("shape", sorted(SMOKE_SHAPES))
def test_components_recombine_to_the_whole_program(arch, shape):
    mesh = MetaMesh((2, 2), ("data", "model"))
    cell = _smoke_lm(arch, shape, mesh)
    assert cell.parts.get("accum", 2) == 2
    mesh.reset_counts()
    whole = dryrun.account(cell.fn, cell.args)
    coll = mesh.hlo_collectives()
    comp = components.lm_component_costs(arch, shape, mesh, cell=cell)
    adj = comp["adjusted"]
    assert adj["flops"] == whole["flops"] > 0
    assert adj["collectives"] == {k: float(v) for k, v in
                                  coll["per_kind_bytes"].items()}
    assert adj["collective_total"] == coll["total_bytes"]
    n_dense, n_moe = comp["trips"]["n_dense"], comp["trips"]["n_moe"]
    assert ("layer_moe" in comp["components"]) == (n_moe > 0)
    assert n_dense + n_moe == get_arch(arch).smoke().n_layers


def test_matrix_vector_products_count_their_flops():
    """`FLOP_EXTRA`: the retrieval cell's ``cand @ q`` is 2 N D, and a
    smoke train cell, which has no such product, counts what
    `FlopCounterMode` alone counts."""
    mesh = _mesh(False)
    cell = cells.build_cell("xdeepfm", "retrieval_cand", mesh)
    rec = dryrun.account(cell.fn, cell.args)
    n_loc, d = cell.args[2].shape[0], get_arch("xdeepfm").full().embed_dim
    assert rec["dispatch_flops"] == 2 * n_loc * d == rec["flops"]
    meta = MetaMesh((2, 2), ("data", "model"))
    train = _smoke_lm("granite-3-8b", "train_4k", meta)
    with_extra = dryrun.account(train.fn, train.args)["dispatch_flops"]
    train = _smoke_lm("granite-3-8b", "train_4k", meta)
    plain = dryrun.FlopCounterMode(display=False)
    with plain:
        train.fn(*train.args)
    assert with_extra == plain.get_total_flops() > 0
    one = torch.empty(64, device="meta")
    with dryrun.FlopCounterMode(display=False,
                                custom_mapping=dryrun.FLOP_EXTRA) as fc:
        torch.dot(one, one)
        torch.mv(torch.empty(1000, 64, device="meta"), one)
    assert fc.get_total_flops() == 2 * 64 + 2 * 1000 * 64


def _real_vs_meta(build):
    meta_cell = build(MetaMesh((1, 1), ("data", "model")))
    real_cell = build(make_device_mesh((1, 1), ("data", "model"),
                                       device="cpu"))
    meta = dryrun.account(meta_cell.fn, meta_cell.args)
    real = dryrun.account(real_cell.fn, real_cell.make_args("cpu"))
    return meta, real


@pytest.mark.parametrize("arch", ["granite-3-8b", "xdeepfm"])
def test_meta_run_equals_the_real_cpu_run(arch):
    if arch == "xdeepfm":
        meta, real = _real_vs_meta(lambda m: cells.build_recsys_cell(
            arch, "train_batch", m, cfg=get_arch(arch).smoke(), batch=64))
    else:
        meta, real = _real_vs_meta(
            lambda m: _smoke_lm(arch, "train_4k", m,
                                sd=dict(seq=32, batch=4)))
    for k in ("dispatch_flops", "argument_size_bytes", "temp_size_bytes",
              "peak_bytes_per_device", "output_size_bytes"):
        assert meta[k] == real[k] > 0, k
    assert meta["kernel_flops"] == real["kernel_flops"] == 0


def _rank_train_counts(mesh):
    torch.manual_seed(0)
    cell = _smoke_lm("granite-3-8b", "train_4k", mesh)
    mesh.reset_counts()
    cell.fn(*cell.make_args("cpu"))
    return dict(mesh.calls), dict(mesh.bytes), mesh.rank


def test_meta_mesh_counts_equal_a_gloo_ranks():
    ranks = spawn((2, 2), _rank_train_counts, device="cpu", timeout=120.0,
                  join_timeout=300.0)
    for calls, nbytes, rank in ranks:
        meta = MetaMesh((2, 2), ("data", "model"), rank=rank)
        cell = _smoke_lm("granite-3-8b", "train_4k", meta)
        meta.reset_counts()
        dryrun.account(cell.fn, cell.args)
        assert dict(meta.calls) == calls and dict(meta.bytes) == nbytes
        assert calls["reduce_scatter"] > 0 and calls["all_gather"] > 0


def test_meta_mesh_hlo_convention():
    mesh = MetaMesh((2, 4), ("data", "model"), rank=5)
    assert mesh.axis_index("data") == 1 and mesh.axis_index("model") == 1
    x = torch.empty((8, 6), dtype=torch.bfloat16, device="meta")
    assert mesh.all_gather(x, "model", 1).shape == (8, 24)
    assert mesh.all_gather(x, ("data", "model"), tiled=False).shape \
        == (8, 8, 6)
    assert mesh.all_reduce(x, "data").dtype == torch.bfloat16
    assert mesh.reduce_scatter(x, "model").shape == (2, 6)
    assert mesh.gather_to_root(x) is None
    c = mesh.hlo_collectives()
    # output bytes in the tensor's own dtype (2 bytes for bfloat16)
    assert c["per_kind_bytes"] == {"all-gather": 8 * 24 * 2 + 8 * 8 * 6 * 2,
                                   "all-reduce": 96, "reduce-scatter": 24,
                                   "all-to-all": 0, "collective-permute": 0}
    assert c["per_kind_count"]["all-gather"] == 2
    assert mesh.calls == {"all_gather": 2, "all_reduce": 1,
                          "reduce_scatter": 1, "gather": 1}
    assert mesh.bytes["reduce_scatter"] == 96      # the input, as DeviceMesh
    one = MetaMesh((1, 1), ("data", "model"))
    assert one.all_gather(x, "model") is x and not one.calls


# ---------------------------------------------------------------------------
# the kernel ops on meta tensors
# ---------------------------------------------------------------------------

def _meta(t):
    return None if t is None else torch.empty_strided(
        t.shape, t.stride(), dtype=t.dtype, device="meta")


G = torch.Generator().manual_seed(0)


def _ints(shape, hi):
    return torch.randint(0, hi, shape, generator=G, dtype=torch.int32)


def _sorted_keys(shape, hi):
    return torch.sort(_ints(shape, hi), dim=-1).values


def _flash_pairs(s, t, q_start):
    return int(np.minimum(t, q_start + np.arange(s) + 1).sum())


# name: (op, its launches counter, args, kwargs, (ops, bytes) by formula)
def _cases():
    tr, va = _ints((3, 40, 3), 9), torch.rand(3, 40, generator=G) < 0.7
    spo = _ints((3, 3), 9) - 1
    eq = torch.zeros(3, 3, dtype=torch.bool)
    keys, rkey = _sorted_keys((2, 3, 50), 90), _ints((2, 20), 90)
    tmask = torch.rand(2, 20, generator=G) < 0.5
    table, tm = _ints((2, 8, 3), 5), torch.ones(2, 8, dtype=torch.bool)
    matches, mm = _ints((2, 12, 3), 5), torch.ones(2, 12, dtype=torch.bool)
    kind = torch.tensor([[1, 2, 0]] * 2, dtype=torch.int32)
    col = torch.tensor([[0, 1, 0]] * 2, dtype=torch.int32)
    q = torch.randn(2, 8, 5, 16, generator=G)
    k, v = torch.randn(2, 2, 40, 16, generator=G), \
        torch.randn(2, 2, 40, 16, generator=G)
    xk, x0 = torch.randn(4, 6, 10, generator=G), \
        torch.randn(4, 5, 10, generator=G)
    w = torch.randn(7, 6, 5, generator=G)
    emb, ids = torch.randn(30, 10, generator=G), _ints((12,), 30)
    bag_ids, bag_w = _ints((6, 4), 30), torch.rand(6, 4, generator=G)
    vals = torch.randn(50, 7, generator=G)
    recv, emask = _ints((50,), 20), torch.rand(50, generator=G) < 0.8
    m01 = (torch.rand(9, 33, generator=G) < 0.4).float()
    rows, lead = 3 * 40, 3
    search = 2 * 3 * 20
    return {
        "scan_hits": (scan_ops.scan_hits, (tr, va, spo, eq), {},
                      (rows * 20, va.numel() + tr.numel() * 4 + 36 + 9
                       + rows + rows * 4)),
        "scan_hits_mask": (scan_ops.scan_hits, (None, va), {},
                           (rows * 2, va.numel() + rows * 4)),
        "scan_select": (scan_ops.scan_select, (tr, va, 16, spo, eq),
                        {"with_hit": False},
                        (rows * 20, va.numel() + tr.numel() * 4 + 36 + 9
                         + lead * (16 * 5 + 4))),
        "join_ranges": (join_ops.join_ranges, (keys, rkey), {},
                        (search * 2 * 6 * 3, keys.numel() * 4
                         + rkey.numel() * 4 + 8 * search)),
        "join_select": (join_ops.join_select, (keys, rkey, tmask, 4, 30), {},
                        (search * 2 * 6 * 3, keys.numel() * 4
                         + rkey.numel() * 4 + tmask.numel() + 8 * search
                         + 2 * (30 * 5 + 4))),
        "compat_matrix": (join_ops.compat_matrix,
                          (table, tm, matches, mm, kind, col), {},
                          (3 * 2 * 8 * 12, 4 * (48 + 72 + 12) + 16 + 24
                           + 2 * 8 * 12)),
        "compat_select": (join_ops.compat_select,
                          (table, tm, matches, mm, kind, col, 20), {},
                          (3 * 2 * 8 * 12, 4 * (48 + 72 + 12) + 16 + 24
                           + 2 * (8 + 20 * 5 + 4))),
        "jaccard_distance": (jac_ops.jaccard_distance, (m01,), {},
                             (9 * 10 * 33, 4 * 9 * 33 + 4 * 81)),
        "gather_rows": (emb_ops.gather_rows, (emb, ids), {},
                        (0, 4 * 12 + 2 * 4 * 12 * 10)),
        "bag_sum": (emb_ops.bag_sum, (emb, bag_ids, bag_w), {},
                    (2 * 6 * 4 * 10, 4 * 24 * 2 + 4 * (24 * 10 + 60))),
        "cin_layer": (cin_ops.cin_layer, (xk, x0, w), {},
                      (6 * 4 * 7 * 10 * 6 * 5,
                       4 * (240 + 200 + 210 + 280))),
        "flash_attention": (flash_ops.flash_attention, (q, k, v),
                            {"q_start": 30},
                            (4 * 2 * 8 * 16 * _flash_pairs(5, 40, 30),
                             4 * (2 * 2 * 8 * 5 * 16
                                  + 2 * 2 * 2 * 35 * 16))),
        "flash_attention_lse": (flash_ops.flash_attention, (q, k, v),
                                {"q_start": 3, "return_lse": True},
                                (4 * 2 * 8 * 16 * _flash_pairs(5, 40, 3),
                                 4 * (2 * 2 * 8 * 5 * 16
                                      + 2 * 2 * 2 * 8 * 16)
                                 + 4 * 2 * 8 * 5)),
        "segment_spmm": (seg_ops.segment_spmm, (vals, recv, emask, 20), {},
                         (50 * 7, 4 * 350 + 200 + 50 + 4 * 140)),
    }


@pytest.mark.parametrize("name", sorted(_cases()))
def test_kernel_op_meta_branch(name):
    op, args, kw, (ops, n_bytes) = _cases()[name]
    ref = op(*args, **kw)                          # the plain version
    metas = tuple(_meta(a) if isinstance(a, torch.Tensor) else a
                  for a in args)
    launches = op.launches
    kernels.meta_cost.reset()
    out = op(*metas, **kw)
    refs = ref if isinstance(ref, tuple) else (ref,)
    outs = out if isinstance(out, tuple) else (out,)
    assert len(outs) == len(refs)
    for o, r in zip(outs, refs):
        if r is None:
            assert o is None
            continue
        assert o.device.type == "meta"
        assert (tuple(o.shape), o.dtype) == (tuple(r.shape), r.dtype)
    assert op.launches == launches
    key = name.replace("_mask", "").replace("_lse", "")
    assert kernels.meta_cost.calls == {key: 1}
    assert (kernels.meta_cost.ops, kernels.meta_cost.bytes) == (ops, n_bytes)


def test_segment_spmm_meta_plan_and_backward():
    """The GNN path on meta: a meta plan (no host read), the op under
    autograd, its backward through the plain gather."""
    recv = torch.empty(50, dtype=torch.int32, device="meta")
    mask = torch.empty(50, dtype=torch.bool, device="meta")
    plan = seg_ops.segment_plan(recv, mask, 20)
    assert plan.order.shape == (50,) and plan.offsets.shape == (21,)
    assert plan.n_pieces == 0
    vals = torch.empty(50, 7, device="meta", requires_grad=True)
    out = seg_ops.segment_spmm(vals, recv, mask, 20, plan=plan)
    (g,) = torch.autograd.grad(out.sum(), vals)
    assert out.shape == (20, 7) and g.shape == (50, 7)


# ---------------------------------------------------------------------------
# engine rows
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_engine(tmp_path_factory):
    path = tmp_path_factory.mktemp("dryrun") / "engine.json"
    _subprocess(SCRIPT_ENGINE, str(path), ok="ENGINE_OK")
    return json.loads(path.read_text())


def test_lower_engine_counts_the_references_gathers(ref_engine):
    from repro_torch.core.partitioner import random_partition
    from repro_torch.engine.federated import ShardedKG, lower_engine
    from repro_torch.engine.planner import make_plan
    from repro_torch.kg.generator import generate_lubm
    from repro_torch.kg.workloads import lubm_queries
    store = generate_lubm(1, scale=0.05, seed=0)
    qs = lubm_queries()
    part = random_partition(store, qs, n_shards=4)
    kg = ShardedKG.build(part)
    assert kg.cap == ref_engine["cap"]
    seen = 0
    for q in qs:
        plan = make_plan(q, part)
        low = lower_engine(plan, (kg.n_shards, kg.cap))
        ref = ref_engine["rows"].get(q.name)
        if ref is None:
            assert not plan.cut_steps
            assert low["collectives"]["total_bytes"] == 0
            continue
        seen += 1
        assert plan.n_gathers == ref["n_gathers"]
        assert len(plan.cut_steps) == ref["n_distributed_joins"]
        rc, mine = ref["coll"], low["collectives"]
        # the reference gathers the matches (s32[S, C, 3]) and the mask
        # (pred[S, C]) apart: 13 bytes a row in two all-gathers; the port
        # packs the mask as a fourth int32 column: 16 bytes in one
        masks = ref["mask_rows"]
        assert rc["per_kind_count"]["all-gather"] == 2 * len(masks)
        assert rc["per_kind_bytes"]["all-gather"] == 13 * sum(masks)
        assert mine["per_kind_count"]["all-gather"] == len(masks) \
            == low["gathers"] == len(plan.cut_steps)
        assert mine["per_kind_bytes"]["all-gather"] == 16 * sum(masks) \
            == low["gathered_bytes"]
        for kind in ("all-reduce", "reduce-scatter", "all-to-all",
                     "collective-permute"):
            assert mine["per_kind_count"][kind] == 0 \
                == rc["per_kind_count"][kind]
        assert low["flops"] > 0
    assert seen >= 5


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("multipod", [False, True])
def test_cli_records(tmp_path, multipod, capsys):
    out = tmp_path / "dry.jsonl"
    recs = []
    for arch, shape in (("gcn-cora", "molecule"), ("xdeepfm", "serve_p99")):
        recs += dryrun.main(["--arch", arch, "--shape", shape, "--out",
                             str(out)] + (["--multipod"] if multipod
                                          else []))
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert lines == _norm(recs) and len(lines) == 2
    for rec in lines:
        assert "error" not in rec, rec.get("trace")
        assert set(REF_KEYS) <= set(rec)
        assert rec["n_chips"] == (512 if multipod else 256)
        assert rec["mesh"] == ("2x16x16" if multipod else "16x16")
        assert rec["flops"] > 0 and rec["kernel_flops"] > 0
        assert 0 < rec["peak_bytes_per_device"] <= \
            dryrun.H100_TOTAL_MEMORY == rec["device_bytes"]
        assert rec["fits"] is True
        assert rec["peak_bytes_per_device"] == \
            rec["argument_size_bytes"] + rec["temp_size_bytes"]
    gcn, xdfm = lines
    # GCN's gradients summed over the data axes; xDeepFM's forward has no
    # collective and launches its three CIN layers and the gather
    assert gcn["collectives"]["per_kind_count"]["all-reduce"] > 0
    assert gcn["kernel_calls"] == {"segment_spmm": 2}
    assert xdfm["collectives"]["total_bytes"] == 0
    assert xdfm["kernel_calls"] == {"gather_rows": 1, "cin_layer": 3}
    assert "kernel_calls" in capsys.readouterr().out


def test_cli_lm_record_counts_the_whole_program():
    # the record's mesh counts are the whole step's, read before
    # `lm_component_costs` re-runs its parts on the same mesh
    arch, shape = "qwen2-moe-a2.7b", "decode_32k"
    rec, = dryrun.main(["--arch", arch, "--shape", shape])
    assert "error" not in rec, rec.get("trace")
    assert rec["adjusted"] is not None
    shp = make_production_mesh(multi_pod=False)
    mesh = MetaMesh(shp.sizes, shp.axis_names)
    cell = cells.build_cell(arch, shape, mesh)
    dryrun.account(cell.fn, cell.args)
    assert rec["mesh_calls"] == dict(mesh.calls)
    assert rec["mesh_bytes"] == dict(mesh.bytes)
    assert rec["collectives"] == mesh.hlo_collectives()
    assert rec["mesh_calls"]["all_reduce"] > get_arch(arch).full().n_layers


def test_cli_records_a_failing_cell_and_goes_on(tmp_path, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("boom")
    monkeypatch.setattr(dryrun, "run_cell", boom)
    recs = dryrun.main(["--arch", "xdeepfm", "--shape", "serve_p99",
                        "--both-meshes"])
    assert [r["mesh"] for r in recs] == ["16x16", "2x16x16"]
    assert all(r["error"] == "RuntimeError: boom" for r in recs)
