"""The PyTorch port's copied, framework-free modules against the JAX
package: generators, WawPart partitioning, shard blocks, plans, buckets and
sort permutations must be identical. Also: the port never imports JAX or
the JAX package, and never falls back from the card to the CPU."""
import ast
import dataclasses
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the test workers running beside
# this one keep their cores
torch.set_num_threads(1)

from repro.core.partitioner import wawpart_partition as j_wawpart  # noqa: E402
from repro.engine.batch import bucket_plans as j_bucket_plans  # noqa: E402
from repro.engine.batch import shard_perms as j_shard_perms  # noqa: E402
from repro.engine.federated import ShardedKG as JShardedKG  # noqa: E402
from repro.engine.oracle import evaluate_bgp as j_evaluate  # noqa: E402
from repro.engine.planner import make_plan as j_make_plan  # noqa: E402
from repro.kg import generator as j_gen  # noqa: E402
from repro.kg import workloads as j_work  # noqa: E402

from repro_torch.core.partitioner import (centralized_partition,  # noqa: E402
                                          random_partition, wawpart_partition)
from repro_torch.engine.batch import (bucket_plans,  # noqa: E402
                                      resolve_device, shard_perms)
from repro_torch.engine.federated import ShardedKG  # noqa: E402
from repro_torch.engine.oracle import evaluate_bgp  # noqa: E402
from repro_torch.engine.planner import make_plan  # noqa: E402
from repro_torch.kg import generator, workloads  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

DATASETS = {
    "lubm-0.05": (lambda g: g.generate_lubm(1, scale=0.05, seed=0),
                  lambda w: w.lubm_queries()),
    "lubm-0.1": (lambda g: g.generate_lubm(1, scale=0.1, seed=0),
                 lambda w: w.lubm_queries()),
    "bsbm-120": (lambda g: g.generate_bsbm(120, seed=0),
                 lambda w: w.bsbm_queries()),
}


@pytest.fixture(scope="module", params=sorted(DATASETS))
def both(request):
    """(port store, port queries, JAX-package store, JAX-package queries)."""
    make_store, make_queries = DATASETS[request.param]
    return (make_store(generator), make_queries(workloads),
            make_store(j_gen), make_queries(j_work))


def _plan_tuple(p):
    return (p.query.name, p.ppn, p.n_shards, p.n_vars, p.var_names,
            p.table_cap, p.n_params, tuple(map(dataclasses.astuple, p.steps)),
            p.meta["order"], p.meta["homes"])


def test_store_and_workload_copies(both):
    st, qs, jst, jqs = both
    assert st.triples.dtype == jst.triples.dtype == np.int32
    np.testing.assert_array_equal(st.triples, jst.triples)
    assert len(st.dictionary) == len(jst.dictionary)
    assert [st.dictionary.term_of(i) for i in range(len(st.dictionary))] \
        == [jst.dictionary.term_of(i) for i in range(len(jst.dictionary))]
    assert [repr(q) for q in qs] == [repr(q) for q in jqs]


def test_partition_shards_plans_buckets_perms(both):
    st, qs, jst, jqs = both
    part = wawpart_partition(st, qs, n_shards=3)
    jpart = j_wawpart(jst, jqs, n_shards=3)
    np.testing.assert_array_equal(part.assign_triples(),
                                  jpart.assign_triples())
    np.testing.assert_array_equal(part.shard_sizes, jpart.shard_sizes)
    assert part.meta["labels"] == jpart.meta["labels"]

    kg, jkg = ShardedKG.build(part), JShardedKG.build(jpart)
    np.testing.assert_array_equal(kg.triples, jkg.triples)
    np.testing.assert_array_equal(kg.valid, jkg.valid)
    assert (kg.n_shards, kg.cap) == (jkg.n_shards, jkg.cap)
    np.testing.assert_array_equal(shard_perms(kg), j_shard_perms(jkg))

    plans = [make_plan(q, part) for q in qs]
    jplans = [j_make_plan(q, jpart) for q in jqs]
    assert [_plan_tuple(p) for p in plans] == [_plan_tuple(p) for p in jplans]
    buckets, jbuckets = bucket_plans(plans), j_bucket_plans(jplans)
    assert [dataclasses.astuple(b.signature) for b in buckets] \
        == [dataclasses.astuple(b.signature) for b in jbuckets]
    for b, jb in zip(buckets, jbuckets):
        assert b.n_params == jb.n_params
        assert [_plan_tuple(p) for p in b.plans] \
            == [_plan_tuple(p) for p in jb.plans]
        for pd, jpd in zip(b.pdata, jb.pdata):
            for f in pd._fields:
                a, ja = getattr(pd, f), np.asarray(getattr(jpd, f))
                assert a.dtype == ja.dtype, f
                np.testing.assert_array_equal(a, ja, err_msg=f)
    for q, jq in zip(qs, jqs):
        np.testing.assert_array_equal(evaluate_bgp(st, q),
                                      j_evaluate(jst, jq))


@pytest.mark.parametrize("method", ["random", "centralized"])
def test_baseline_partitions_match(method):
    from repro.core.partitioner import (centralized_partition as j_central,
                                        random_partition as j_random)
    st = generator.generate_lubm(1, scale=0.05, seed=0)
    jst = j_gen.generate_lubm(1, scale=0.05, seed=0)
    qs, jqs = workloads.lubm_queries(), j_work.lubm_queries()
    if method == "random":
        part = random_partition(st, qs, n_shards=3, seed=0)
        jpart = j_random(jst, jqs, n_shards=3, seed=0)
    else:
        part, jpart = centralized_partition(st, qs), j_central(jst, jqs)
    np.testing.assert_array_equal(part.assign_triples(),
                                  jpart.assign_triples())
    np.testing.assert_array_equal(ShardedKG.build(part).triples,
                                  JShardedKG.build(jpart).triples)


def test_sharded_kg_from_arrays_and_to_device():
    st = generator.generate_lubm(1, scale=0.05, seed=0)
    jst = j_gen.generate_lubm(1, scale=0.05, seed=0)
    jkg = JShardedKG.build(j_wawpart(jst, j_work.lubm_queries(), n_shards=3))
    kg = ShardedKG.from_arrays(np.asarray(jkg.triples), np.asarray(jkg.valid))
    assert (kg.n_shards, kg.cap) == (jkg.n_shards, jkg.cap)
    np.testing.assert_array_equal(
        kg.triples,
        ShardedKG.build(wawpart_partition(st, workloads.lubm_queries(),
                                          n_shards=3)).triples)
    tr, va = kg.to_device("cpu")
    assert tr.dtype == torch.int32 and va.dtype == torch.bool
    np.testing.assert_array_equal(tr.numpy(), jkg.triples)
    with pytest.raises(ValueError, match="n_shards"):
        ShardedKG.from_arrays(kg.triples[..., :2], kg.valid)


def _units(unit_shard: dict) -> list:
    return sorted((dataclasses.astuple(u), s) for u, s in unit_shard.items())


def test_adaptive_copies_move_the_same_units(both):
    """incremental_repartition, MigrationPlan and its apply_kg, and the
    workload tracker give the JAX package's placement, row deltas, shard
    blocks and window for the same inputs (a full re-run too)."""
    from repro.adaptive.migrate import MigrationPlan as JMigrationPlan
    from repro.adaptive.repartition import (
        full_repartition as j_full, incremental_repartition as j_incremental)
    from repro.adaptive.stats import WorkloadTracker as JTracker
    from repro.adaptive.stats import plan_shards as j_plan_shards
    from repro.launch.serve import two_phase_weights as j_two_phase

    from repro_torch.adaptive import (MigrationPlan, WorkloadTracker,
                                      full_repartition,
                                      incremental_repartition, plan_shards)
    from repro_torch.launch.serve import two_phase_weights

    st, qs, jst, jqs = both
    part = wawpart_partition(st, qs, n_shards=3)
    jpart = j_wawpart(jst, jqs, n_shards=3)
    (_, wb), (_, jwb) = two_phase_weights(qs), j_two_phase(jqs)
    assert wb == jwb
    res = incremental_repartition(part, qs, wb, budget_frac=0.15)
    jres = j_incremental(jpart, jqs, jwb, budget_frac=0.15)
    assert res.mode == jres.mode
    assert _units(res.part.unit_shard) == _units(jres.part.unit_shard)
    assert [dataclasses.astuple(u) for u in res.moved_units] \
        == [dataclasses.astuple(u) for u in jres.moved_units]
    assert (res.moved_triples, res.budget_triples, res.cost_before,
            res.cost_after) == (jres.moved_triples, jres.budget_triples,
                                jres.cost_before, jres.cost_after)

    mig = MigrationPlan.build(part, res.part)
    jmig = JMigrationPlan.build(jpart, jres.part)
    np.testing.assert_array_equal(mig.old_assign, jmig.old_assign)
    np.testing.assert_array_equal(mig.new_assign, jmig.new_assign)
    assert (mig.n_shards, mig.n_moved, mig.moved_fraction) \
        == (jmig.n_shards, jmig.n_moved, jmig.moved_fraction)
    deltas, jdeltas = mig.shard_deltas(), jmig.shard_deltas()
    assert sorted(deltas) == sorted(jdeltas)
    for k in deltas:
        np.testing.assert_array_equal(deltas[k], jdeltas[k])
    kg = mig.apply_kg(ShardedKG.build(part), res.part)
    jkg = jmig.apply_kg(JShardedKG.build(jpart), jres.part)
    np.testing.assert_array_equal(kg.triples, jkg.triples)
    np.testing.assert_array_equal(kg.valid, jkg.valid)
    assert (kg.n_shards, kg.cap) == (jkg.n_shards, jkg.cap)
    with pytest.raises(ValueError, match="same triple store"):
        MigrationPlan.build(part, wawpart_partition(
            generator.generate_lubm(1, scale=0.05, seed=1), qs, n_shards=3))

    full = full_repartition(st, qs, wb, n_shards=3, old_part=part)
    jfull = j_full(jst, jqs, jwb, n_shards=3, old_part=jpart)
    assert (full.mode, full.moved_triples) == (jfull.mode,
                                               jfull.moved_triples)
    np.testing.assert_array_equal(full.part.assign_triples(),
                                  jfull.part.assign_triples())

    tracker, jtracker = WorkloadTracker(window=16), JTracker(window=16)
    for i in range(40):
        q, jq = qs[i % len(qs)], jqs[i % len(jqs)]
        p, jp = make_plan(q, part), j_make_plan(jq, jpart)
        assert plan_shards(p) == j_plan_shards(jp)
        tracker.observe(q.name, cut_joins=len(p.cut_steps),
                        shards=plan_shards(p))
        jtracker.observe(jq.name, cut_joins=len(jp.cut_steps),
                         shards=j_plan_shards(jp))
    snap, jsnap = tracker.snapshot(), jtracker.snapshot()
    assert dataclasses.astuple(snap) == dataclasses.astuple(jsnap)
    assert snap.imbalance(3) == jsnap.imbalance(3)
    assert snap.frequencies == jsnap.frequencies


def test_classify_copies_agree_on_every_error_type():
    from repro.engine.federated import CapacityOverflowError as JOverflow
    from repro.faults import errors as jerrors

    from repro_torch.engine.federated import CapacityOverflowError
    from repro_torch.faults import errors

    faults = sorted(n for n, v in vars(errors).items()
                    if isinstance(v, type) and issubclass(v, Exception))
    assert faults == sorted(n for n, v in vars(jerrors).items()
                            if isinstance(v, type)
                            and issubclass(v, Exception))
    assert len(faults) == 7
    pairs = [(getattr(errors, n)("x"), getattr(jerrors, n)("x"))
             for n in faults]

    class Overflow(CapacityOverflowError):
        pass

    class JOverflowSub(JOverflow):
        pass

    pairs += [(CapacityOverflowError("x"), JOverflow("x")),
              (Overflow("x"), JOverflowSub("x"))]
    pairs += [(e, e) for e in (ValueError(), TypeError(), KeyError(),
                               IndexError(), RuntimeError(), OSError(),
                               ZeroDivisionError())]
    kinds = [errors.classify(e) for e, _ in pairs]
    assert kinds == [jerrors.classify(e) for _, e in pairs]
    assert kinds[:len(faults)] == ["transient"] * len(faults)
    assert kinds[len(faults):len(faults) + 6] == ["permanent"] * 6
    assert kinds[-3:] == ["transient"] * 3


def _fields(cls) -> list:
    return [(f.name, repr(f.default), repr(f.default_factory()) if
             f.default_factory is not dataclasses.MISSING else None)
            for f in dataclasses.fields(cls)]


def test_fault_and_adaptive_copies_public_values():
    """The copied fault and adaptive modules export the reference's names,
    and their value types carry its fields and defaults."""
    import inspect

    from repro import adaptive as j_adaptive
    from repro import faults as j_faults
    from repro.adaptive import controller as j_controller
    from repro.adaptive import drift as j_drift
    from repro.adaptive import replicate as j_replicate

    from repro_torch import adaptive, faults
    from repro_torch.adaptive import controller, drift, replicate

    assert faults.__all__ == j_faults.__all__
    assert set(j_adaptive.__all__) <= set(adaptive.__all__)
    for mod, jmod in ((faults.inject, j_faults.inject),
                      (faults.retry, j_faults.retry),
                      (faults.degraded, j_faults.degraded),
                      (controller, j_controller), (drift, j_drift),
                      (replicate, j_replicate)):
        names = sorted(n for n, v in vars(jmod).items()
                       if not n.startswith("__")
                       and getattr(v, "__module__", None) == jmod.__name__)
        assert names == sorted(
            n for n, v in vars(mod).items() if not n.startswith("__")
            and getattr(v, "__module__", None) == mod.__name__), jmod
        for name in names:
            got, want = getattr(mod, name), getattr(jmod, name)
            if dataclasses.is_dataclass(want):
                assert _fields(got) == _fields(want), name
            else:
                assert str(inspect.signature(got)) \
                    == str(inspect.signature(want)), name
    assert drift.SEVERITIES == j_drift.SEVERITIES
    det, jdet = drift.DriftDetector(), j_drift.DriftDetector()
    assert vars(det) == vars(jdet)
    assert faults.FaultInjector().injected \
        == j_faults.FaultInjector().injected
    assert dataclasses.astuple(faults.RetryPolicy()) \
        == dataclasses.astuple(j_faults.RetryPolicy())
    assert dataclasses.asdict(controller.AdaptiveConfig()) \
        == dataclasses.asdict(j_controller.AdaptiveConfig())


# ---------------------------------------------------------------------------
# isolation and no-fallback guarantees
# ---------------------------------------------------------------------------

def _imported_roots(path: Path) -> set[str]:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and \
                node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    checked = {f.relative_to(ROOT).as_posix() for f in files}
    assert {f"src/repro_torch/{m}.py" for m in (
        "engine/local", "engine/federated", "core/rewriter", "configs/lubm",
        "configs/bsbm", "obs/metrics", "obs/trace", "obs/telemetry",
        "adaptive/stats", "adaptive/migrate", "adaptive/repartition",
        "adaptive/replicate", "adaptive/drift", "adaptive/controller",
        "faults/errors", "faults/inject", "faults/retry",
        "faults/degraded", "launch/mesh", "launch/serve", "engine/batch",
        "sharding/__init__", "sharding/rules")} <= checked
    for f in files:
        bad = _imported_roots(f) & {"jax", "jaxlib", "repro", "flax", "optax"}
        assert not bad, f"{f.relative_to(ROOT)} imports {sorted(bad)}"


def test_cuda_device_without_a_card_raises(monkeypatch):
    from repro_torch.engine.batch import run_batched
    from repro_torch.launch.serve import WorkloadServer, main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    st = generator.generate_lubm(1, scale=0.05, seed=0)
    qs = workloads.lubm_queries()
    part = wawpart_partition(st, qs, n_shards=3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        WorkloadServer(qs, part)                 # device defaults to cuda
    (bucket, *_) = bucket_plans([make_plan(q, part) for q in qs])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_batched(bucket, ShardedKG.build(part))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        main(["--scale", "0.05", "--requests", "4"])

    from repro_torch.configs.xdeepfm import smoke
    from repro_torch.core.distance import jaccard_distance_matrix
    from repro_torch.core.hac import linkage_torch
    from repro_torch.models.recsys.xdeepfm import XDeepFM
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        jaccard_distance_matrix(qs, use_kernel=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        linkage_torch(np.ones((3, 3)))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        XDeepFM.from_jax(smoke(), {})

    from repro_torch.configs import granite_3_8b
    from repro_torch.models.transformer import Transformer, init_cache
    lm = granite_3_8b.smoke()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Transformer.random(lm)                   # device defaults to cuda
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Transformer.from_jax(lm, {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_cache(lm, 1, 8)


class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports a device that is neither the CPU, the card
    nor meta (each of which has its own branch in the ops)."""

    @property
    def device(self):
        return torch.device("xla")


def _elsewhere(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype).as_subclass(_Elsewhere)


def test_kernel_ops_raise_off_cpu_instead_of_falling_back():
    """A tensor that is neither on the CPU nor on the meta device goes to
    the kernel's launcher, which refuses anything that is not a CUDA
    tensor — it never runs the plain version instead. (A meta tensor has
    its own branch, held in tests/test_torch_dryrun.py.)"""
    from repro_torch.kernels.cin.ops import cin_layer
    from repro_torch.kernels.embedding_bag.ops import gather_rows
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.jaccard.ops import jaccard_distance
    from repro_torch.kernels.kg_join.ops import compat_matrix, join_ranges
    from repro_torch.kernels.kg_scan.ops import scan_hits, scan_select

    tr = _elsewhere((2, 8, 3), torch.int32)
    va = _elsewhere((2, 8), torch.bool)
    spo = _elsewhere((2, 3), torch.int32)
    with pytest.raises(ValueError, match="CUDA tensor"):
        scan_hits(tr, va, spo)
    with pytest.raises(ValueError, match="CUDA tensor"):
        scan_select(tr, va, 4, spo)
    with pytest.raises(ValueError, match="CUDA tensor"):
        scan_select(None, va, 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        scan_hits(tr, va, spo, with_cum=False)
    with pytest.raises(ValueError, match="CUDA tensor"):
        scan_select(tr, va, 4, spo, with_hit=False)
    with pytest.raises(ValueError, match="CUDA tensor"):
        join_ranges(spo, spo)
    with pytest.raises(ValueError, match="CUDA tensor"):
        compat_matrix(tr, va, tr, va, spo, spo)
    f32 = _elsewhere((4, 3, 5))
    with pytest.raises(ValueError, match="CUDA tensor"):
        jaccard_distance(f32[0])
    with pytest.raises(ValueError, match="CUDA tensor"):
        gather_rows(f32[0], spo[0])
    with pytest.raises(ValueError, match="CUDA tensor"):
        cin_layer(f32, f32, f32[:, :, :3])
    qkv = _elsewhere((1, 2, 4, 8), torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention(qkv, qkv[:, :1], qkv[:, :1])
    with pytest.raises(ValueError, match="CUDA tensor"):
        flash_attention(qkv, qkv, qkv, causal=False, q_start=0)
    assert scan_hits.launches == scan_select.launches \
        == join_ranges.launches == compat_matrix.launches \
        == jaccard_distance.launches == gather_rows.launches \
        == cin_layer.launches == flash_attention.launches == 0
