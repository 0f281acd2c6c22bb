"""The port's multi-device engines on a mesh of gloo ranks (one process a
shard, on the CPU) against the JAX package's single-device engines: the
engine-level counterpart of tests/test_batch_sharded.py's SCRIPT_DIFF and
of the engine part of SCRIPT_PALLAS.

For every bucket of LUBM 0.05 under WawPart and random placements (3
shards), both joins and both port backends ("torch", and "cuda" whose
kernel ops run their plain versions on CPU tensors), the raw (table, mask,
overflow) that `make_sharded_batched_engine` returns on every rank equal
the jitted JAX vmapped engine's bit for bit, every answer equals
`evaluate_bgp`, each rank counts `bucket_collectives(sig)` gathers a call
and calls the kernel ops as often as the single-device engine does. The
same holds for seeded random stores and queries on 2 shards, and
`run_sharded` equals the JAX `run_vmapped`. The in-process cases are the
mesh validations of tests/test_batch_sharded.py and
tests/test_federated_caps.py on a mesh of one.

The ranks come from `repro_torch.launch.mesh.spawn` (``device="cpu"``),
with a process-group timeout and a join timeout of their own. They import
this module to find their functions, so JAX is imported only inside the
fixtures and tests that hold the port against it.
"""
import dataclasses
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the test workers running beside
# this one keep their cores
torch.set_num_threads(1)

from repro_torch.core import features, partitioner  # noqa: E402
from repro_torch.engine.batch import (EngineCache, assemble_batch,  # noqa: E402
                                      bucket_collectives, bucket_plans,
                                      extract_batch, kg_tensors,
                                      make_batched_engine,
                                      make_sharded_batched_engine,
                                      run_sharded_batched, shard_perms)
from repro_torch.engine.federated import (CapacityOverflowError,  # noqa: E402
                                          ShardedKG, run_sharded,
                                          run_vmapped)
from repro_torch.engine.oracle import evaluate_bgp  # noqa: E402
from repro_torch.engine.planner import make_plan  # noqa: E402
from repro_torch.kg import generator, query, triples, workloads  # noqa: E402
from repro_torch.launch.mesh import (EngineMesh, make_engine_mesh,  # noqa: E402
                                     spawn)
from repro_torch.sharding.rules import kg_local  # noqa: E402

BACKENDS = ("torch", "cuda")
JOINS = ("expand", "sorted")
PLACEMENTS = ("wawpart", "random")
OPS = ("scan_hits", "scan_select", "join_ranges", "join_select",
       "compat_matrix", "compat_select")
GROUP_TIMEOUT = 60.0      # seconds a collective may wait for a rank
JOIN_TIMEOUT = 300.0      # seconds a spawn's processes get in all
TEMPLATES = (0, 10)       # run_sharded's templates, as SCRIPT_PALLAS's
MAX_PER_ROW = 192


def _jax():
    """The JAX package's modules the references need (imported here, not
    at the top: the ranks import this module)."""
    import jax.numpy as jnp

    from repro.core import features as j_features
    from repro.core import partitioner as j_partitioner
    from repro.engine import batch as j_batch
    from repro.engine import federated as j_fed
    from repro.engine import planner as j_planner
    from repro.kg import generator as j_gen
    from repro.kg import query as j_query
    from repro.kg import triples as j_triples
    from repro.kg import workloads as j_work
    return types.SimpleNamespace(
        jnp=jnp, features=j_features, partitioner=j_partitioner,
        batch=j_batch, fed=j_fed, planner=j_planner, gen=j_gen,
        query=j_query, triples=j_triples, work=j_work)


class OpCalls:
    """Counts the calls of the engine's kernel ops (on a CUDA tensor, one
    launch each; on the CPU they run their plain versions, so the calls
    are what the launches would be)."""

    def __enter__(self):
        from repro_torch.kernels.kg_join import ops as join_ops
        from repro_torch.kernels.kg_scan import ops as scan_ops
        self.counts = dict.fromkeys(OPS, 0)
        self._saved = []
        for mod in (scan_ops, join_ops):
            for name in OPS:
                fn = getattr(mod, name, None)
                if fn is None:
                    continue

                def counted(*a, _fn=fn, _name=name, **kw):
                    self.counts[_name] += 1
                    return _fn(*a, **kw)

                self._saved.append((mod, name, fn))
                setattr(mod, name, counted)
        return self

    def reset(self) -> None:
        self.counts = dict.fromkeys(OPS, 0)

    def __exit__(self, *exc):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)


def _requests(bucket):
    return [(i, None) for i in range(len(bucket.plans))]


def _engine_calls(mesh, kg, buckets, backends=BACKENDS):
    """Every bucket through the mesh engine, each join and backend: the
    raw outputs, the gathers and gathered bytes counted, and the op calls
    of each call."""
    out = {}
    tr, va, pe = kg_local(kg, mesh, shard_perms(kg))
    with OpCalls() as calls:
        for join in JOINS:
            for backend in backends:
                rows = []
                for b in buckets:
                    fn = make_sharded_batched_engine(
                        b.signature, mesh, join_impl=join, backend=backend)
                    pd, params = assemble_batch(b, _requests(b))
                    calls.reset()
                    mesh.reset_counts()
                    t, m, o = fn(tr, va, pe, pd, params)
                    rows.append({"raw": (t.numpy(), m.numpy(), o.numpy()),
                                 "gathers": mesh.collectives,
                                 "bytes": mesh.gathered_bytes,
                                 "calls": dict(calls.counts)})
                out[(join, backend)] = rows
    return out


def _rank_lubm(mesh, cases, squeezed):
    """One rank of the LUBM 0.05 run (3 shards): the engine calls of each
    placement, run_sharded_batched's answers (WawPart, sorted),
    run_sharded of two templates, and the strict runs of a squeezed
    plan."""
    out = {"engine": {}, "rank": mesh.rank, "size": mesh.size}
    for label, (kg, buckets, plans) in cases.items():
        out["engine"][label] = _engine_calls(mesh, kg, buckets)
    kg, buckets, plans = cases["wawpart"]
    cache = EngineCache()
    out["answers"] = [run_sharded_batched(b, kg, mesh, join_impl="sorted",
                                          cache=cache, backend="cuda")
                      for b in buckets]
    out["cache"] = (cache.misses, cache.hits)
    runs = {}
    for i in TEMPLATES:
        for join in JOINS:
            for backend in BACKENDS:
                mesh.reset_counts()
                res = run_sharded(plans[i], kg, mesh, join_impl=join,
                                  max_per_row=MAX_PER_ROW, backend=backend)
                runs[(i, join, backend)] = (res, mesh.collectives)
    out["run_sharded"] = runs
    errors = []
    (bucket,) = bucket_plans([squeezed])
    for run in (lambda: run_sharded_batched(bucket, kg, mesh, strict=True,
                                            backend="cuda"),
                lambda: run_sharded(squeezed, kg, mesh, strict=True)):
        try:
            run()
            errors.append(None)
        except CapacityOverflowError as exc:
            errors.append(str(exc))
    out["strict"] = errors
    return out


def _rank_small(mesh, trials, tiny, caps):
    """One rank of the 2-shard run: the engine calls of each random
    trial, and run_sharded of the tiny gather query at each gather_cap."""
    out = {"trials": [_engine_calls(mesh, kg, buckets)
                      for kg, buckets in trials]}
    plan, kg = tiny
    out["gather_cap"] = {cap: run_sharded(plan, kg, mesh, gather_cap=cap,
                                          backend="cuda")
                         for cap in caps}
    return out


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

def _partition(pkg, method, store, qs):
    if method == "wawpart":
        return pkg.wawpart_partition(store, qs, n_shards=3)
    return pkg.random_partition(store, qs, n_shards=3, seed=0)


@pytest.fixture(scope="module")
def jx():
    return _jax()


@pytest.fixture(scope="module")
def lubm(jx):
    """LUBM 0.05 under both placements, the port's and the reference's
    side by side, and the mesh run's per-rank results."""
    st = generator.generate_lubm(1, scale=0.05, seed=0)
    jst = jx.gen.generate_lubm(1, scale=0.05, seed=0)
    qs, jqs = workloads.lubm_queries(), jx.work.lubm_queries()
    world, cases = {}, {}
    for method in PLACEMENTS:
        part = _partition(partitioner, method, st, qs)
        jpart = _partition(jx.partitioner, method, jst, jqs)
        jkg = jx.fed.ShardedKG.build(jpart)
        kg = ShardedKG.build(part)
        np.testing.assert_array_equal(kg.triples, np.asarray(jkg.triples))
        np.testing.assert_array_equal(kg.valid, np.asarray(jkg.valid))
        plans = [make_plan(q, part) for q in qs]
        jplans = [jx.planner.make_plan(q, jpart) for q in jqs]
        buckets = bucket_plans(plans)
        jbuckets = jx.batch.bucket_plans(jplans)
        assert [dataclasses.astuple(b.signature) for b in buckets] \
            == [dataclasses.astuple(b.signature) for b in jbuckets]
        world[method] = (part, kg, plans, buckets, jkg, jplans, jbuckets)
        cases[method] = (kg, buckets, plans)
    plan = make_plan(qs[0], world["wawpart"][0])
    squeezed = make_plan(qs[0], world["wawpart"][0],
                         capacities=([2] * len(plan.steps), plan.table_cap))
    # the ranks run while this process computes the references (a thread
    # waits on them)
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, 3, _rank_lubm, cases, squeezed,
                            device="cpu", timeout=GROUP_TIMEOUT,
                            join_timeout=JOIN_TIMEOUT)
        jcache = jx.batch.EngineCache()
        jraws = {(method, join): [_jax_raw(jx, jcache, w[4], jb, join)
                                  for jb in w[6]]
                 for method, w in world.items() for join in JOINS}
        jkg, jplans = world["wawpart"][4], world["wawpart"][5]
        vmapped = {(i, join): jx.fed.run_vmapped(jplans[i], jkg,
                                                 join_impl=join,
                                                 max_per_row=MAX_PER_ROW)
                   for i in TEMPLATES for join in JOINS}
        return types.SimpleNamespace(store=st, qs=qs, jqs=jqs, world=world,
                                     jraws=jraws, vmapped=vmapped,
                                     ranks=ranks.result())


def _random_trial(pkg_triples, pkg_query, pkg_partitioner, trial):
    """SCRIPT_DIFF's seeded random store (40 triples) and three random
    BGPs, randomly placed on 2 shards."""
    Q, TP, v, c = (pkg_query.Query, pkg_query.TriplePattern, pkg_query.v,
                   pkg_query.c)
    terms = [f"e{i}" for i in range(12)]
    preds = [f"p{i}" for i in range(3)]
    r = np.random.default_rng(trial)
    rows = [(terms[r.integers(12)], preds[r.integers(3)],
             terms[r.integers(12)]) for _ in range(40)]
    st = pkg_triples.TripleStore.from_string_triples(rows)
    vars_ = [v("X"), v("Y"), v("Z")]
    queries = []
    for qi in range(3):
        pats = []
        for _ in range(int(r.integers(1, 4))):
            s = vars_[r.integers(2)] if r.random() < 0.8 \
                else c(terms[r.integers(2)])
            o = vars_[r.integers(3)] if r.random() < 0.7 \
                else c(terms[r.integers(2)])
            pats.append(TP(s, c(preds[r.integers(3)]), o))
        queries.append(Q(f"RQ{trial}_{qi}", tuple(pats)))
    part = pkg_partitioner.random_partition(st, queries, n_shards=2,
                                            seed=trial)
    return st, queries, part


def _tiny(pkg_triples, pkg_query, pkg_features, pkg_partitioner):
    """tests/test_federated_caps.py's tiny store: 12 p-triples whose data
    units land on 2 shards and a single-pattern query that must gather
    cross-shard."""
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
def tiny(jx):
    store, q, part = _tiny(triples, query, features, partitioner)
    _, jq, jpart = _tiny(jx.triples, jx.query, jx.features, jx.partitioner)
    plan, jplan = make_plan(q, part), jx.planner.make_plan(jq, jpart)
    assert plan.n_gathers and jplan.n_gathers
    return store, q, part, plan, ShardedKG.build(part), jplan, \
        jx.fed.ShardedKG.build(jpart)


def _gather_caps(tiny):
    n = evaluate_bgp(tiny[0], tiny[1]).shape[0]
    return (1, n - 1, n, n + 1, 64)


@pytest.fixture(scope="module")
def small(jx, tiny):
    """The 2-shard run: the random trials and the tiny gather query."""
    trials, jtrials = [], []
    for trial in range(3):
        st, qs, part = _random_trial(triples, query, partitioner, trial)
        _, jqs, jpart = _random_trial(jx.triples, jx.query, jx.partitioner,
                                      trial)
        buckets = bucket_plans([make_plan(q, part) for q in qs])
        jbuckets = jx.batch.bucket_plans([jx.planner.make_plan(q, jpart)
                                          for q in jqs])
        trials.append((ShardedKG.build(part), buckets))
        jtrials.append((st, jx.fed.ShardedKG.build(jpart), jbuckets))
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(spawn, 2, _rank_small, trials,
                            (tiny[3], tiny[4]), _gather_caps(tiny),
                            device="cpu", timeout=GROUP_TIMEOUT,
                            join_timeout=JOIN_TIMEOUT)
        jcache = jx.batch.EngineCache()
        jraws = [{join: [_jax_raw(jx, jcache, jkg, jb, join)
                         for jb in jbuckets] for join in JOINS}
                 for _, jkg, jbuckets in jtrials]
        capped = {cap: jx.fed.run_vmapped(tiny[5], tiny[6], gather_cap=cap)
                  for cap in _gather_caps(tiny)}
        return trials, jtrials, jraws, capped, ranks.result()


# ---------------------------------------------------------------------------
# references
# ---------------------------------------------------------------------------

def _jax_raw(jx, jcache, jkg, jbucket, join):
    """The jitted JAX vmapped engine's raw (table, mask, overflow) for
    every member of a bucket."""
    fn = jcache.get(jbucket.signature, join_impl=join)
    pd, params = jx.batch.assemble_batch(jbucket, _requests(jbucket))
    out = fn(jx.jnp.asarray(jkg.triples), jx.jnp.asarray(jkg.valid),
             jx.jnp.asarray(jx.batch.shard_perms(jkg)), pd, params)
    return tuple(np.asarray(t) for t in out)


def _single_calls(kg, buckets, join):
    """The single-device engine's op calls per bucket ("cuda" backend)."""
    tr, va, pe = kg_tensors(kg, None, "cpu")
    calls_per = []
    with OpCalls() as calls:
        for b in buckets:
            fn = make_batched_engine(b.signature, join_impl=join,
                                     backend="cuda")
            pd, params = assemble_batch(b, _requests(b))
            calls.reset()
            fn(tr, va, pe, pd, params)
            calls_per.append(dict(calls.counts))
    return calls_per


def _check_raw(ranks, key, jraws, buckets, store):
    """Every rank's raw outputs equal the reference's, bit for bit, and
    their answers equal the oracle."""
    for b, jraw, i in zip(buckets, jraws, range(len(buckets))):
        for rank in ranks:
            raw = rank[key][i]["raw"]
            for got, want in zip(raw, jraw):
                assert got.dtype == want.dtype and got.shape == want.shape
                np.testing.assert_array_equal(got, want)
        for (rows, _, ovf), plan in zip(
                extract_batch(b, _requests(b), *ranks[0][key][i]["raw"]),
                b.plans):
            assert not ovf, plan.query.name
            np.testing.assert_array_equal(rows,
                                          evaluate_bgp(store, plan.query))


# ---------------------------------------------------------------------------
# LUBM 0.05, 3 ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", PLACEMENTS)
@pytest.mark.parametrize("join", JOINS)
def test_every_bucket_equals_the_jax_engine_on_every_rank(lubm, method,
                                                          join):
    buckets = lubm.world[method][3]
    ranks = [r["engine"][method] for r in lubm.ranks]
    for backend in BACKENDS:
        _check_raw(ranks, (join, backend), lubm.jraws[(method, join)],
                   buckets, lubm.store)


@pytest.mark.parametrize("method", PLACEMENTS)
@pytest.mark.parametrize("join", JOINS)
def test_counted_gathers_equal_bucket_collectives(lubm, method, join):
    part, kg, plans, buckets, *_ = lubm.world[method]
    cuts = [bucket_collectives(b.signature) for b in buckets]
    assert sum(cuts) > 0
    for r, rank in enumerate(lubm.ranks):
        assert (rank["rank"], rank["size"]) == (r, 3)
        for backend in BACKENDS:
            calls = rank["engine"][method][(join, backend)]
            assert [c["gathers"] for c in calls] == cuts
            for c, b in zip(calls, buckets):
                sig, n = b.signature, len(b.plans)
                caps = [min(cap, kg.cap) for cap, g in zip(
                    sig.scan_caps, sig.gather_bits) if g]
                # the matches and their mask, 4 int32 a row, from 3 ranks
                assert c["bytes"] == sum(n * 3 * cap * 16 for cap in caps)


@pytest.mark.parametrize("method", PLACEMENTS)
@pytest.mark.parametrize("join", JOINS)
def test_rank_launches_equal_the_single_device_engine(lubm, method, join):
    part, kg, plans, buckets, *_ = lubm.world[method]
    want = _single_calls(kg, buckets, join)
    assert sum(sum(c.values()) for c in want) > 0
    for rank in lubm.ranks:
        assert [c["calls"] for c in
                rank["engine"][method][(join, "cuda")]] == want
        assert all(not any(c["calls"].values()) for c in
                   rank["engine"][method][(join, "torch")])


def test_run_sharded_batched_answers_on_every_rank(lubm):
    part, kg, plans, buckets, *_ = lubm.world["wawpart"]
    for rank in lubm.ranks:
        assert rank["cache"] == (len(buckets), 0)
        for b, res in zip(buckets, rank["answers"]):
            for (rows, n, ovf), plan in zip(res, b.plans):
                want = evaluate_bgp(lubm.store, plan.query)
                assert not ovf and n == want.shape[0], plan.query.name
                np.testing.assert_array_equal(rows, want)


@pytest.mark.parametrize("join", JOINS)
def test_run_sharded_equals_run_vmapped(lubm, join):
    plans = lubm.world["wawpart"][2]
    for i in TEMPLATES:
        ref = lubm.vmapped[(i, join)]
        assert not ref[2]
        np.testing.assert_array_equal(
            ref[0], evaluate_bgp(lubm.store, plans[i].query))
        for rank in lubm.ranks:
            for backend in BACKENDS:
                (rows, n, ovf), gathers = \
                    rank["run_sharded"][(i, join, backend)]
                assert (n, ovf) == (ref[1], ref[2])
                assert rows.dtype == np.int32
                np.testing.assert_array_equal(rows, np.asarray(ref[0]))
                assert gathers == plans[i].n_gathers


def test_strict_sharded_runs_raise_on_every_rank(lubm):
    for rank in lubm.ranks:
        batched, per_query = rank["strict"]
        for msg in (batched, per_query):
            assert msg is not None and "sharded" in msg \
                and "overflow" in msg and "'LUBM-Q1'" in msg


# ---------------------------------------------------------------------------
# random stores and queries, and the tiny gather query, 2 ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("trial", range(3))
def test_random_bgps_on_two_shards_equal_the_jax_engine(small, trial):
    trials, jtrials, jraws, _, ranks = small
    buckets, st = trials[trial][1], jtrials[trial][0]
    for join in JOINS:
        per_rank = [r["trials"][trial] for r in ranks]
        for backend in BACKENDS:
            _check_raw(per_rank, (join, backend), jraws[trial][join],
                       buckets, st)
            for rank in per_rank:
                assert [c["gathers"] for c in rank[(join, backend)]] == \
                    [bucket_collectives(b.signature) for b in buckets]


def test_gather_cap_on_the_mesh_equals_the_jax_engine(tiny, small):
    store, q = tiny[:2]
    capped, ranks = small[3:]
    for cap in _gather_caps(tiny):
        ref = capped[cap]
        for rank in ranks:
            rows, n, ovf = rank["gather_cap"][cap]
            assert (n, ovf) == (ref[1], ref[2]), cap
            np.testing.assert_array_equal(rows, np.asarray(ref[0]))
    oracle = evaluate_bgp(store, q)
    assert ranks[0]["gather_cap"][1][2]
    assert not ranks[0]["gather_cap"][oracle.shape[0]][2]


# ---------------------------------------------------------------------------
# in process: validation on a mesh of one, no fallback
# ---------------------------------------------------------------------------

def test_mesh_validation_rejects_bad_axes(lubm):
    plans = lubm.world["wawpart"][2]
    sig = bucket_plans([plans[0]])[0].signature
    one = make_engine_mesh(1, device="cpu")
    with pytest.raises(ValueError, match="one device per shard"):
        make_sharded_batched_engine(sig, one)
    data = make_engine_mesh(1, device="cpu", axis_name="data")
    with pytest.raises(ValueError, match="shard axis"):
        make_sharded_batched_engine(sig, data)
    with pytest.raises(ValueError, match="one device per shard"):
        EngineCache().get(sig, mesh=one)


def test_run_sharded_rejects_mismatched_mesh(tiny):
    store, q, part, plan, kg, *_ = tiny                # 2 shards
    with pytest.raises(ValueError, match="one device per shard"):
        run_sharded(plan, kg, make_engine_mesh(1, device="cpu"))
    with pytest.raises(ValueError, match="shard axis"):
        run_sharded(plan, kg, make_engine_mesh(1, device="cpu",
                                               axis_name="data"))


def test_gather_cap_validated_identically_on_both_paths(tiny):
    """run_vmapped and run_sharded reject an invalid gather_cap with the
    same ValueError, before the mesh is read (a dummy mesh suffices)."""
    store, q, part, plan, kg, *_ = tiny
    for bad in (0, -3, 2.5, True):
        with pytest.raises(ValueError, match="gather_cap must be a positive"):
            run_vmapped(plan, kg, gather_cap=bad, device="cpu")
        with pytest.raises(ValueError, match="gather_cap must be a positive"):
            run_sharded(plan, kg, object(), gather_cap=bad)


def test_strict_sharded_single_shard_mesh(tiny):
    """A 1-shard centralized plan on a mesh of one (no process group):
    strict overflow behaves as on the vmapped path, and the answer
    equals evaluate_bgp."""
    store, q = tiny[:2]
    cpart = partitioner.centralized_partition(store, [q])
    ckg = ShardedKG.build(cpart)
    cplan = make_plan(q, cpart)
    mesh = make_engine_mesh(1, device="cpu")
    squeezed = make_plan(q, cpart, capacities=([2], cplan.table_cap))
    for backend in BACKENDS:
        with pytest.raises(CapacityOverflowError, match="'GQ'.*sharded"):
            run_sharded(squeezed, ckg, mesh, strict=True, backend=backend)
        rows, _, ovf = run_sharded(cplan, ckg, mesh, strict=True,
                                   backend=backend)
        assert not ovf
        np.testing.assert_array_equal(rows, evaluate_bgp(store, q))
    assert mesh.collectives == 0


def test_the_engine_cache_keys_the_mesh(tiny):
    store, q, part, plan, kg, *_ = tiny
    cpart = partitioner.centralized_partition(store, [q])
    (bucket,) = bucket_plans([make_plan(q, cpart)])
    one = make_engine_mesh(1, device="cpu")
    cache = EngineCache()
    plain = cache.get(bucket.signature, backend="torch")
    meshed = cache.get(bucket.signature, backend="torch", mesh=one)
    assert plain is not meshed and callable(meshed.local)
    assert cache.get(bucket.signature, backend="torch", mesh=one) is meshed
    assert (cache.misses, cache.hits, len(cache)) == (2, 1, 2)
    ckg = ShardedKG.build(cpart)
    tr, va, pe = kg_local(ckg, one)
    np.testing.assert_array_equal(pe.numpy(), shard_perms(ckg))
    pd, params = assemble_batch(bucket, [(0, None)])
    for a, b in zip(meshed(tr, va, pe, pd, params),
                    plain(*kg_tensors(ckg, None, "cpu"), pd, params)):
        assert torch.equal(a, b)


def test_kg_local_holds_the_ranks_block(lubm):
    kg = lubm.world["random"][1]
    perms = shard_perms(kg)
    for r in range(3):
        mesh = EngineMesh(3, r, torch.device("cpu"))
        tr, va, pe = kg_local(kg, mesh)
        np.testing.assert_array_equal(tr.numpy(), kg.triples[r:r + 1])
        np.testing.assert_array_equal(va.numpy(), kg.valid[r:r + 1])
        np.testing.assert_array_equal(pe.numpy(), perms[r:r + 1])
        assert pe.dtype == torch.int64
        np.testing.assert_array_equal(kg_local(kg, mesh, perms)[2].numpy(),
                                      perms[r:r + 1])
    with pytest.raises(ValueError, match="3 shards, the mesh 2 ranks"):
        kg_local(kg, EngineMesh(2, 0, torch.device("cpu")))


def test_nccl_with_too_few_cards_raises():
    with pytest.raises(ValueError, match="one CUDA card per rank"):
        make_engine_mesh(3, device="cpu", backend="nccl")
    with pytest.raises(ValueError, match="one CUDA card per rank"):
        spawn(3, _rank_small, backend="nccl", device="cpu")
    with pytest.raises(ValueError, match="backend must be one of"):
        make_engine_mesh(1, device="cpu", backend="mpi")


def test_mesh_entry_points_default_to_cuda_and_raise_without_a_card(
        monkeypatch, tiny):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        make_engine_mesh(1)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        spawn(2, _rank_small)
    with pytest.raises(RuntimeError, match="needs an initialised process"):
        make_engine_mesh(2, device="cpu")
