"""The port's query rewriter (paper §3.2, Table 1) and KG engine configs
against the JAX package's copies, and the paper's end-to-end claims
(tests/test_system.py) through the port's per-query engine."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the test workers running beside
# this one keep their cores
torch.set_num_threads(1)

from repro.configs import bsbm as j_bsbm_cfg  # noqa: E402
from repro.configs import lubm as j_lubm_cfg  # noqa: E402
from repro.core import partitioner as j_partitioner  # noqa: E402
from repro.core import rewriter as j_rewriter  # noqa: E402
from repro.kg import generator as j_gen  # noqa: E402
from repro.kg import workloads as j_work  # noqa: E402

from repro_torch.configs import bsbm as bsbm_cfg  # noqa: E402
from repro_torch.configs import lubm as lubm_cfg  # noqa: E402
from repro_torch.core import partitioner, rewriter  # noqa: E402
from repro_torch.engine.federated import ShardedKG, run_vmapped  # noqa: E402
from repro_torch.engine.oracle import evaluate_bgp  # noqa: E402
from repro_torch.engine.planner import make_plan  # noqa: E402
from repro_torch.kg import generator, workloads  # noqa: E402

DATASETS = {
    "lubm-0.1": (lambda g: g.generate_lubm(1, scale=0.1, seed=0),
                 lambda w: w.lubm_queries()),
    "bsbm-120": (lambda g: g.generate_bsbm(120, seed=0),
                 lambda w: w.bsbm_queries()),
}


def _partition(pkg, method, store, qs):
    if method == "wawpart":
        return pkg.wawpart_partition(store, qs, n_shards=3)
    if method == "random":
        return pkg.random_partition(store, qs, n_shards=3, seed=0)
    return pkg.centralized_partition(store, qs)


def _plan_tuple(p):
    return (repr(p.query), p.ppn, [sorted(h) for h in p.pattern_homes],
            p.remote_patterns, p.n_distributed_joins, p.n_service_blocks,
            p.is_local)


@pytest.mark.parametrize("method", ["wawpart", "random", "centralized"])
@pytest.mark.parametrize("dataset", sorted(DATASETS))
def test_rewrite_and_sparql_match_the_reference(dataset, method):
    make_store, make_queries = DATASETS[dataset]
    st, jst = make_store(generator), make_store(j_gen)
    qs, jqs = make_queries(workloads), make_queries(j_work)
    part = _partition(partitioner, method, st, qs)
    jpart = _partition(j_partitioner, method, jst, jqs)
    plans = rewriter.workload_plans(qs, part)
    jplans = j_rewriter.workload_plans(jqs, jpart)
    assert [_plan_tuple(p) for p in plans] == [_plan_tuple(p) for p in jplans]
    for q, jq, p, jp in zip(qs, jqs, plans, jplans):
        assert _plan_tuple(rewriter.rewrite(q, part)) == _plan_tuple(p)
        assert rewriter.to_sparql(p) == j_rewriter.to_sparql(jp)
        eps = [f"http://ep{i}/sparql" for i in range(3)]
        assert rewriter.to_sparql(p, eps) == j_rewriter.to_sparql(jp, eps)
        assert ("SERVICE" in rewriter.to_sparql(p)) == (not p.is_local)
    if method == "centralized":
        assert all(p.is_local for p in plans)
    elif dataset.startswith("lubm"):
        assert any(not p.is_local for p in plans)


def test_engine_configs_match_the_reference():
    for mine, ref in ((lubm_cfg, j_lubm_cfg), (bsbm_cfg, j_bsbm_cfg)):
        for make in ("full", "smoke"):
            assert dataclasses.asdict(getattr(mine, make)()) == \
                dataclasses.asdict(getattr(ref, make)())
    assert bsbm_cfg.KGEngineConfig is lubm_cfg.KGEngineConfig
    assert [f.name for f in dataclasses.fields(lubm_cfg.KGEngineConfig)] \
        == [f.name for f in dataclasses.fields(j_lubm_cfg.KGEngineConfig)]


def _gather_bytes(plans, kg):
    """Static cross-shard traffic a workload needs under a placement."""
    return sum(kg.n_shards * step.scan_cap * 3 * 4
               for plan in plans for step in plan.steps if step.gather)


def test_end_to_end_lubm_through_the_port():
    """tests/test_system.py::test_end_to_end_lubm: every template on
    WawPart, random and centralized placements gives the oracle's answers
    through run_vmapped; WawPart moves fewer gathered bytes than random and
    federates no more queries."""
    st = generator.generate_lubm(1, scale=0.1, seed=0)
    queries = workloads.lubm_queries()
    ww = partitioner.wawpart_partition(st, queries, n_shards=3)
    rnd = partitioner.random_partition(st, queries, n_shards=3, seed=0)
    cen = partitioner.centralized_partition(st, queries)
    kgs = {p.method: ShardedKG.build(p) for p in (ww, rnd, cen)}
    plans = {p.method: [] for p in (ww, rnd, cen)}
    assert len(plans) == 3
    for q in queries:
        oracle = evaluate_bgp(st, q)
        for part in (ww, rnd, cen):
            plan = make_plan(q, part)
            rows, n, ovf = run_vmapped(plan, kgs[part.method],
                                       backend="cuda", device="cpu")
            assert not ovf, (q.name, part.method)
            np.testing.assert_array_equal(rows, oracle,
                                          err_msg=f"{q.name} {part.method}")
            plans[part.method].append(plan)
    assert _gather_bytes(plans[ww.method], kgs[ww.method]) \
        < _gather_bytes(plans[rnd.method], kgs[rnd.method])
    n_fed = {p.method: sum(not fp.is_local
                           for fp in rewriter.workload_plans(queries, p))
             for p in (ww, rnd)}
    assert n_fed[ww.method] <= n_fed[rnd.method]
