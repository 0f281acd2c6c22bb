"""The port's per-query federated engine (`make_engine`, `run_vmapped`)
against the JAX package's, bit for bit: on the reference's own shard
blocks (ShardedKG.from_arrays), every template's whole table, mask and
overflow flag equal the JAX engine under ``jax.vmap(axis_name="shards")``
for both join implementations and both port backends ("torch", and "cuda"
whose kernel ops run their plain versions on CPU tensors), and the
extracted rows equal the reference's and `evaluate_bgp`. Also the
parameter batch, seeded random stores and queries, and the capacity
checks of tests/test_federated_caps.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the test workers running beside
# this one keep their cores
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.core import features as j_features  # noqa: E402
from repro.core import partitioner as j_partitioner  # noqa: E402
from repro.engine import federated as j_fed  # noqa: E402
from repro.engine.planner import make_plan as j_make_plan  # noqa: E402
from repro.kg import generator as j_gen  # noqa: E402
from repro.kg import query as j_query  # noqa: E402
from repro.kg import triples as j_triples  # noqa: E402
from repro.kg import workloads as j_work  # noqa: E402

from repro_torch.core import features, partitioner  # noqa: E402
from repro_torch.engine.federated import (AXIS,  # noqa: E402
                                          CapacityOverflowError, ShardedKG,
                                          _extract, make_engine, run_vmapped)
from repro_torch.engine.oracle import evaluate_bgp  # noqa: E402
from repro_torch.engine.planner import make_plan  # noqa: E402
from repro_torch.kg import generator, query, triples, workloads  # noqa: E402
from repro_torch.kg.query import Query, TriplePattern as T, c, v  # noqa: E402

BACKENDS = ("torch", "cuda")

CASES = {
    "lubm-wawpart": ("lubm", "wawpart"),
    "lubm-random": ("lubm", "random"),
    "lubm-centralized": ("lubm", "centralized"),
    "bsbm-wawpart": ("bsbm", "wawpart"),
}


def _partition(pkg, method, store, qs):
    if method == "wawpart":
        return pkg.wawpart_partition(store, qs, n_shards=3)
    if method == "random":
        return pkg.random_partition(store, qs, n_shards=3, seed=0)
    return pkg.centralized_partition(store, qs)


def _build(dataset, method):
    """(store, queries, partition, kg, JAX queries, JAX partition, JAX
    kg): LUBM 0.1 or BSBM 120, the port's blocks the reference's own."""
    if dataset == "lubm":
        st = generator.generate_lubm(1, scale=0.1, seed=0)
        jst = j_gen.generate_lubm(1, scale=0.1, seed=0)
        qs, jqs = workloads.lubm_queries(), j_work.lubm_queries()
    else:
        st, jst = generator.generate_bsbm(120, seed=0), \
            j_gen.generate_bsbm(120, seed=0)
        qs, jqs = workloads.bsbm_queries(), j_work.bsbm_queries()
    part = _partition(partitioner, method, st, qs)
    jpart = _partition(j_partitioner, method, jst, jqs)
    jkg = j_fed.ShardedKG.build(jpart)
    kg = ShardedKG.from_arrays(np.asarray(jkg.triples), np.asarray(jkg.valid))
    return st, qs, part, kg, jqs, jpart, jkg


def _jax_engine(jplan, **kw):
    return jax.jit(jax.vmap(j_fed.make_engine(jplan, **kw),
                            in_axes=(0, 0, None), axis_name=j_fed.AXIS))


def _same_tables(port, ref, what):
    for a, b, name in zip(port, ref, ("table", "mask", "overflow")):
        a, b = a.numpy(), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (what, name)
        np.testing.assert_array_equal(a, b, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("impl", ["expand", "sorted"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_every_template_matches_the_jax_engine(case, impl):
    st, qs, part, kg, jqs, jpart, jkg = _build(*CASES[case])
    tr, va = kg.to_device("cpu")
    gathers = 0
    for q, jq in zip(qs, jqs):
        plan, jplan = make_plan(q, part), j_make_plan(jq, jpart)
        assert plan.ppn == jplan.ppn and plan.n_gathers == jplan.n_gathers
        gathers += plan.n_gathers
        p = np.zeros((max(1, plan.n_params),), np.int32)
        ref = _jax_engine(jplan, join_impl=impl)(jkg.triples, jkg.valid, p)
        j_rows, j_n, j_ovf = j_fed._extract(jplan, *ref)
        oracle = evaluate_bgp(st, q)
        for backend in BACKENDS:
            out = make_engine(plan, join_impl=impl, backend=backend)(
                tr, va, torch.from_numpy(p))
            _same_tables(out, ref, f"{q.name} {backend}")
            rows, n, ovf = run_vmapped(plan, kg, join_impl=impl,
                                       backend=backend, device="cpu")
            assert rows.dtype == np.int32 and (n, ovf) == (j_n, j_ovf)
            np.testing.assert_array_equal(rows, j_rows)
        assert not ovf, q.name
        np.testing.assert_array_equal(rows, oracle, err_msg=q.name)
    # WawPart and random placements federate some step; one shard never
    assert (gathers > 0) == (part.n_shards > 1)


def test_batched_params_serving():
    """LUBM-Q1 with its course constant a parameter, served for a batch of
    parameter vectors: (B, S, …) tables equal the JAX engine vmapped over
    the batch inside the shard vmap, and each instance equals the oracle
    (tests/test_engine.py::test_batched_params_serving)."""
    st, qs, part, kg, jqs, jpart, jkg = _build("lubm", "wawpart")
    d = st.dictionary
    courses = [t for t in ("ub:U0_Dept0_GraduateCourse0",
                           "ub:U0_Dept0_GraduateCourse1",
                           "ub:U0_Dept1_GraduateCourse0") if t in d]
    assert len(courses) >= 2
    pvals = np.asarray([[d.id_of(t)] for t in courses], np.int32)
    tr, va = kg.to_device("cpu")
    for impl in ("expand", "sorted"):
        plan = make_plan(qs[0], part, params={(1, 2): 0}, cap_margin=4.0)
        jplan = j_make_plan(jqs[0], jpart, params={(1, 2): 0},
                            cap_margin=4.0)
        engine = j_fed.make_engine(jplan, join_impl=impl)
        fn = jax.vmap(jax.vmap(engine, in_axes=(None, None, 0)),
                      in_axes=(0, 0, None), axis_name=j_fed.AXIS)
        ref = tuple(np.swapaxes(np.asarray(x), 0, 1)          # (B, S, …)
                    for x in jax.jit(fn)(jkg.triples, jkg.valid, pvals))
        for backend in BACKENDS:
            out = make_engine(plan, join_impl=impl, backend=backend)(
                tr, va, torch.from_numpy(pvals))
            _same_tables(out, ref, f"{impl} {backend}")
            assert not out[2].any()
            for bi, course in enumerate(courses):
                inst = Query("inst", (qs[0].patterns[0],
                                      T(qs[0].patterns[1].s,
                                        qs[0].patterns[1].p, c(course))))
                rows, _, _ = _extract(plan, *(o[bi] for o in out))
                np.testing.assert_array_equal(rows, evaluate_bgp(st, inst))
            rows, _, _ = run_vmapped(plan, kg, pvals[1], join_impl=impl,
                                     backend=backend, device="cpu")
            np.testing.assert_array_equal(
                rows, _extract(plan, *(o[1] for o in out))[0])


def _random_store_and_query(rng, pkg_triples, pkg_query):
    """A seeded stand-in for tests/test_engine.py's hypothesis strategy:
    up to 40 triples over 6 terms and 1-3 predicates, 1-3 patterns."""
    preds = [f"p{i}" for i in range(rng.integers(1, 4))]
    terms = [f"t{i}" for i in range(6)]
    rows = [(terms[rng.integers(6)], preds[rng.integers(len(preds))],
             terms[rng.integers(6)]) for _ in range(rng.integers(5, 41))]
    names = ["x", "y", "z"] + terms[:2]
    pats = []
    for _ in range(rng.integers(1, 4)):
        s, o = names[rng.integers(5)], names[rng.integers(5)]
        p = preds[rng.integers(len(preds))]
        term = (lambda t: pkg_query.v(t) if t in ("x", "y", "z")
                else pkg_query.c(t))
        pats.append(pkg_query.TriplePattern(term(s), pkg_query.c(p),
                                            term(o)))
    return (pkg_triples.TripleStore.from_string_triples(rows),
            pkg_query.Query("hq", tuple(pats)))


@pytest.mark.parametrize("seed", range(10))
def test_random_stores_and_queries_match_the_jax_engine(seed):
    k = 1 + seed % 3
    store, q = _random_store_and_query(np.random.default_rng(seed), triples,
                                       query)
    jstore, jq = _random_store_and_query(np.random.default_rng(seed),
                                         j_triples, j_query)
    part = partitioner.wawpart_partition(store, [q], n_shards=k)
    jpart = j_partitioner.wawpart_partition(jstore, [jq], n_shards=k)
    jkg = j_fed.ShardedKG.build(jpart)
    kg = ShardedKG.from_arrays(np.asarray(jkg.triples), np.asarray(jkg.valid))
    plan = make_plan(q, part, cap_margin=3.0)
    jplan = j_make_plan(jq, jpart, cap_margin=3.0)
    tr, va = kg.to_device("cpu")
    p = np.zeros((max(1, plan.n_params),), np.int32)
    for impl in ("expand", "sorted"):
        ref = _jax_engine(jplan, join_impl=impl)(jkg.triples, jkg.valid, p)
        for backend in BACKENDS:
            out = make_engine(plan, join_impl=impl, backend=backend)(
                tr, va, torch.from_numpy(p))
            _same_tables(out, ref, f"{q} {impl} {backend}")
        rows, _, ovf = _extract(plan, *out)
        if not ovf:   # capacity violations are flagged, not silent
            np.testing.assert_array_equal(rows, evaluate_bgp(store, q))


# ---------------------------------------------------------------------------
# capacities (tests/test_federated_caps.py)
# ---------------------------------------------------------------------------

def _tiny(pkg_triples, pkg_query, pkg_features, pkg_partitioner):
    """12 p-triples whose data units land on 2 shards, a distractor
    predicate, and a single-pattern query that must gather cross-shard."""
    Q, TP = pkg_query.Query, pkg_query.TriplePattern
    rows = [(f"s{i}", "p", f"o{i % 4}") for i in range(12)]
    rows += [(f"s{i}", "q", "o0") for i in range(8)]
    store = pkg_triples.TripleStore.from_string_triples(rows)
    q = Q("GQ", (TP(pkg_query.v("X"), pkg_query.c("p"), pkg_query.v("Y")),))
    helpers = [Q(f"H{i}", (TP(pkg_query.v("X"), pkg_query.c("p"),
                              pkg_query.c(f"o{i}")),)) for i in range(4)]
    cat = pkg_features.build_unit_catalog(store, [q] + helpers)
    units = sorted(cat.units, key=repr)
    unit_shard = {u: i % 2 for i, u in enumerate(units)}
    sizes = np.zeros(2, dtype=np.int64)
    for u, s in unit_shard.items():
        sizes[s] += cat.sizes.get(u, 0)
    return store, q, pkg_partitioner.Partitioning(2, unit_shard, cat, sizes,
                                                  method="manual")


@pytest.fixture(scope="module")
def tiny():
    store, q, part = _tiny(triples, query, features, partitioner)
    _, jq, jpart = _tiny(j_triples, j_query, j_features, j_partitioner)
    plan, jplan = make_plan(q, part), j_make_plan(jq, jpart)
    assert plan.n_gathers and jplan.n_gathers
    jkg = j_fed.ShardedKG.build(jpart)
    kg = ShardedKG.from_arrays(np.asarray(jkg.triples), np.asarray(jkg.valid))
    return store, q, part, plan, kg, jq, jpart, jplan, jkg


def _both(plan, kg, jplan, jkg, **kw):
    """The port's result on both backends, held equal to the reference's."""
    ref = j_fed.run_vmapped(jplan, jkg, **kw)
    for backend in BACKENDS:
        rows, n, ovf = run_vmapped(plan, kg, backend=backend, device="cpu",
                                   **kw)
        assert (n, ovf) == (ref[1], ref[2])
        np.testing.assert_array_equal(rows, ref[0])
    return rows, n, ovf


def test_gather_cap_above_matches_is_lossless(tiny):
    store, q, part, plan, kg, jq, jpart, jplan, jkg = tiny
    oracle = evaluate_bgp(store, q)
    for cap in (oracle.shape[0], oracle.shape[0] + 1, 64):
        rows, _, ovf = _both(plan, kg, jplan, jkg, gather_cap=cap)
        assert not ovf, cap
        np.testing.assert_array_equal(rows, oracle)


def test_gather_cap_overflow_trips_exactly_at_capacity(tiny):
    store, q, part, plan, kg, jq, jpart, jplan, jkg = tiny
    n_matches = evaluate_bgp(store, q).shape[0]
    assert n_matches >= 3
    for cap in (1, n_matches - 1):
        assert _both(plan, kg, jplan, jkg, gather_cap=cap)[2], cap
    assert not _both(plan, kg, jplan, jkg, gather_cap=n_matches)[2]


def test_scan_cap_overflow_propagates(tiny):
    store, q, part, plan, kg, jq, jpart, jplan, jkg = tiny
    caps = ([2], plan.table_cap)
    assert _both(make_plan(q, part, capacities=caps), kg,
                 j_make_plan(jq, jpart, capacities=caps), jkg)[2]
    rows, _, ovf = _both(plan, kg, jplan, jkg)
    assert not ovf
    np.testing.assert_array_equal(rows, evaluate_bgp(store, q))


@pytest.mark.parametrize("impl", ["expand", "sorted"])
def test_table_cap_overflow_propagates(impl):
    st, qs, part, kg, jqs, jpart, jkg = _build("lubm", "wawpart")
    q = Query("ALL", (T(v("X"), c("rdf:type"), v("Y")),))
    jq = j_query.Query("ALL", (j_query.TriplePattern(
        j_query.v("X"), j_query.c("rdf:type"), j_query.v("Y")),))
    assert evaluate_bgp(st, q).shape[0] > 8
    caps = ([s.scan_cap for s in make_plan(q, part).steps], 8)
    assert _both(make_plan(q, part, capacities=caps), kg,
                 j_make_plan(jq, jpart, capacities=caps), jkg,
                 join_impl=impl)[2]


def test_bad_gather_cap_is_rejected(tiny):
    store, q, part, plan, kg, *_ = tiny
    for bad in (0, -3, 2.5, True):
        with pytest.raises(ValueError, match="gather_cap must be a positive"):
            run_vmapped(plan, kg, gather_cap=bad, device="cpu")


def test_strict_overflow_raises_with_the_reference_message(tiny):
    store, q, part, plan, kg, jq, jpart, jplan, jkg = tiny
    with pytest.raises(j_fed.CapacityOverflowError) as ref:
        j_fed.run_vmapped(jplan, jkg, gather_cap=1, strict=True)
    for backend in BACKENDS:
        with pytest.raises(CapacityOverflowError,
                           match="'GQ'.*vmapped.*truncated") as err:
            run_vmapped(plan, kg, gather_cap=1, strict=True, backend=backend,
                        device="cpu")
        assert str(err.value) == str(ref.value)
        rows, _, ovf = run_vmapped(plan, kg, strict=True, backend=backend,
                                   device="cpu")
        assert not ovf
        np.testing.assert_array_equal(rows, evaluate_bgp(store, q))


def test_cuda_without_a_card_raises_and_nothing_falls_back(tiny, monkeypatch):
    """run_vmapped defaults to the card and raises without one; the engine
    on tensors that are not on the CPU goes to the kernels' ops and never
    runs the plain versions instead: on meta tensors (the dry run's
    device) every step takes the kernels' meta branches, which launch
    nothing and count their work (the ops' own launchers refuse any other
    device but CUDA: tests/test_torch_shared.py)."""
    from repro_torch import kernels
    from repro_torch.kernels.kg_join import ops as join_ops
    from repro_torch.kernels.kg_scan import ops as scan_ops
    store, q, part, plan, kg, *_ = tiny
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_vmapped(plan, kg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_vmapped(plan, kg, backend="torch", device="cuda")
    meta = torch.device("meta")
    tr = torch.zeros(kg.triples.shape, dtype=torch.int32, device=meta)
    va = torch.zeros(kg.valid.shape, dtype=torch.bool, device=meta)
    p = torch.zeros((1,), dtype=torch.int32, device=meta)
    ops = (scan_ops.scan_select, join_ops.compat_select,
           join_ops.join_select, join_ops.join_ranges)
    for impl in ("expand", "sorted"):
        launches = [op.launches for op in ops]
        kernels.meta_cost.reset()
        out = make_engine(plan, join_impl=impl)(tr, va, p)
        assert all(t.device.type == "meta" for t in out)
        # the one pattern's scan, and its join with no shared variable
        # (the expand join's selection under both join_impl)
        assert dict(kernels.meta_cost.calls) == {"scan_select": 1,
                                                 "compat_select": 1}
        assert [op.launches for op in ops] == launches
    with pytest.raises(ValueError, match="backend"):
        make_engine(plan, backend="jnp")
    assert AXIS == j_fed.AXIS
