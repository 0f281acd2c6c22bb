"""The port's adaptive layer against the JAX package's: drift detection,
the adaptive controller on the server, migration and hot cut-edge
replication, case by case as tests/test_adaptive.py and the replication
cases of tests/test_answer_cache.py run them.

Drift units and the replication planner are compared value for value.
Each server case runs once through the JAX server and once through the
port per backend (``device="cpu"``) under a FakeClock, and what it
observes must be equal: every result (bit for bit), the controller's
events, the migrate and replicate_hot reports, ``stats``,
``telemetry.snapshot()`` and the Chrome trace events. Each case also
asserts what its JAX original asserts, on both sides.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the test workers running beside
# this one keep their cores
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.adaptive import drift as j_drift  # noqa: E402
from repro.adaptive import replicate as j_replicate  # noqa: E402
from repro.adaptive import stats as j_stats  # noqa: E402
from repro.adaptive.controller import \
    AdaptiveConfig as JAdaptiveConfig  # noqa: E402
from repro.adaptive.repartition import \
    incremental_repartition as j_incremental  # noqa: E402
from repro.core import partitioner as j_partitioner  # noqa: E402
from repro.engine import federated as j_federated  # noqa: E402
from repro.engine.batch import EngineCache as JEngineCache  # noqa: E402
from repro.engine.planner import make_plan as j_make_plan  # noqa: E402
from repro.kg import workloads as j_work  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.obs import Telemetry as JTelemetry  # noqa: E402

from repro_torch.adaptive import drift, replicate, stats  # noqa: E402
from repro_torch.adaptive.controller import AdaptiveConfig  # noqa: E402
from repro_torch.adaptive.repartition import \
    incremental_repartition  # noqa: E402
from repro_torch.core import partitioner  # noqa: E402
from repro_torch.engine import federated  # noqa: E402
from repro_torch.engine.batch import EngineCache  # noqa: E402
from repro_torch.engine.oracle import evaluate_bgp  # noqa: E402
from repro_torch.engine.planner import make_plan  # noqa: E402
from repro_torch.kg import generator, workloads  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.obs import Telemetry  # noqa: E402

BACKENDS = ("torch", "cuda")


class FakeClock:
    """Deterministic clock the cases advance by hand."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


class _ReadyServer(jserve.WorkloadServer):
    """The JAX server, waiting for each dispatch before it goes on."""

    def _flush(self, *args, **kwargs):
        super()._flush(*args, **kwargs)
        if self._inflight:
            jax.block_until_ready(self._inflight[-1].out)


@dataclasses.dataclass
class Side:
    """One package's server factory and modules for the cases."""

    mod: object             # launch.serve
    partitioner: object     # core.partitioner
    config: object          # AdaptiveConfig
    repartition: object     # incremental_repartition
    qs: list
    wa: dict
    wb: dict
    parts: dict             # "weighted" (phase A's mix) | "uniform"
    make: object            # make(part, **kw) -> server on a FakeClock


@pytest.fixture(scope="module")
def world(lubm_small):
    st = generator.generate_lubm(1, scale=0.2, seed=0)
    np.testing.assert_array_equal(st.triples, lubm_small.triples)
    qs, jqs = workloads.lubm_queries(), j_work.lubm_queries()
    wa, wb = serve.two_phase_weights(qs)
    jwa, jwb = jserve.two_phase_weights(jqs)
    assert (wa, wb) == (jwa, jwb)
    parts = {"weighted": partitioner.wawpart_partition(
                 st, qs, n_shards=3, query_weights=wa),
             "uniform": partitioner.wawpart_partition(st, qs, n_shards=3)}
    jparts = {"weighted": j_partitioner.wawpart_partition(
                  lubm_small, jqs, n_shards=3, query_weights=jwa),
              "uniform": j_partitioner.wawpart_partition(lubm_small, jqs,
                                                         n_shards=3)}
    jcache = JEngineCache()

    def jmake(part, **kw):
        kw.setdefault("cache", jcache)
        return _ReadyServer(jqs, part, telemetry=JTelemetry(trace=True),
                            pipeline=jserve.PipelineConfig(
                                clock=FakeClock()), **kw)

    jside = Side(jserve, j_partitioner, JAdaptiveConfig, j_incremental, jqs,
                 jwa, jwb, jparts, jmake)
    sides = {}
    for backend in BACKENDS:
        cache = EngineCache()

        def make(part, _cache=cache, _backend=backend, **kw):
            kw.setdefault("cache", _cache)
            kw.setdefault("backend", _backend)
            return serve.WorkloadServer(
                qs, part, device="cpu", telemetry=Telemetry(trace=True),
                pipeline=serve.PipelineConfig(clock=FakeClock()), **kw)

        sides[backend] = Side(serve, partitioner, AdaptiveConfig,
                              incremental_repartition, qs, wa, wb, parts,
                              make)
    return jside, sides, {}


def _result(res):
    if res is None:
        return None
    rows, n, ovf = res
    rows = np.asarray(rows)
    return (rows.dtype.str, rows.shape, rows.tobytes(), int(n), bool(ovf))


def _results(results):
    return [_result(r) for r in results]


def _final(srv, log):
    return {"log": log, "stats": srv.stats,
            "snapshot": srv.telemetry.snapshot(),
            "trace": srv.telemetry.trace.to_chrome()["traceEvents"],
            "epoch": srv.epoch,
            "unit_shard": sorted(map(repr, srv.part.unit_shard.items())),
            "replicas": sorted(map(repr, srv.part.replicas.items())),
            "cuts": srv.collective_counts()}


def _weighted_distributed(s, part):
    return s.partitioner.workload_join_stats(
        s.qs, part, query_weights=s.wb)["weighted_distributed"]


# ---- the server cases ----------------------------------------------------

def case_adaptive_improves_on_drift(s):
    part = s.parts["weighted"]
    cfg = s.config(window=64, check_every=32, min_requests=32,
                   budget_frac=0.15)
    srv = s.make(part, adaptive=cfg)
    static = s.make(part)
    stream = s.mod.drifting_stream(s.qs, [(96, s.wa), (160, s.wb)], seed=0)
    got = []
    for i in range(0, len(stream), 32):
        res_a = srv.serve(stream[i:i + 32])
        res_s = static.serve(stream[i:i + 32])
        assert _results(res_a) == _results(res_s)
        got += res_a
    assert srv.adaptive.n_migrations >= 1
    assert srv.epoch == srv.adaptive.n_migrations
    assert _weighted_distributed(s, srv.part) \
        < _weighted_distributed(s, part)
    return _final(srv, [_results(got),
                        [dataclasses.asdict(e) for e in srv.adaptive.events],
                        srv.adaptive.baseline,
                        dataclasses.astuple(srv.tracker.snapshot())])


def case_warmup_and_pause_do_not_feed_tracker(s):
    srv = s.make(s.parts["weighted"], adaptive=s.config())
    stream = s.mod.request_stream(s.qs, 16)
    srv.warmup(stream)
    log = [len(srv.adaptive.tracker)]
    with srv.tracking_paused():
        srv.serve(stream)
    log.append(len(srv.adaptive.tracker))
    srv.serve(stream)
    log.append(len(srv.adaptive.tracker))
    assert log == [0, 0, 16]
    assert srv.tracker is srv.adaptive.tracker
    return _final(srv, log)


def case_migrated_server_matches_fresh(s):
    part = s.parts["weighted"]
    res = s.repartition(part, s.qs, s.wb, budget_frac=0.15)
    assert res.mode == "incremental"
    srv = s.make(part)
    stream = s.mod.request_stream(s.qs, 28)
    before = srv.serve(stream)
    report = srv.migrate(res.part)
    assert srv.epoch == 1 and report["epoch"] == 1
    assert report["n_moved"] == res.moved_triples
    assert report["plans_rewritten"] + report["plans_reused"] == len(s.qs)
    assert 0 < report["plans_rewritten"] < len(s.qs)
    after = srv.serve(stream)
    want = s.make(res.part).serve(stream)
    assert _results(after) == _results(want) == _results(before)
    return _final(srv, [report, _results(after)])


def case_migration_reuses_engine_signatures(s):
    part = s.parts["weighted"]
    res = s.repartition(part, s.qs, s.wb, budget_frac=0.15)
    srv = s.make(part)
    stream = s.mod.request_stream(s.qs, 28)
    srv.serve(stream)
    compiles_before = srv.n_compiles
    report = srv.migrate(res.part)
    srv.serve(stream)
    # only buckets whose signature changed may build anew (the cache is
    # shared across a side's cases, so the count itself is not compared)
    assert srv.n_compiles - compiles_before <= report["signatures_new"]
    assert report["signatures_reused"] >= 1
    return _final(srv, [report])


def case_replicate_hot_drops_collectives(s):
    srv = s.make(s.parts["uniform"])
    stream = s.mod.request_stream(s.qs, 28)
    before = srv.serve(stream)
    srv.serve(stream)
    assert srv.stats["cache_hits"] == 28
    rep = srv.replicate_hot()
    assert srv.epoch == 1 and rep["epoch"] == 1
    assert rep["replicated_triples"] > 0 and rep["plans_rewritten"] > 0
    drops = [b - a for b, a in zip(rep["collectives_before"],
                                   rep["collectives_after"])]
    assert all(d >= 0 for d in drops) and any(d > 0 for d in drops)
    srv.reset_stats()
    after = srv.serve(stream)
    assert srv.stats["cache_hits"] == 0        # the epoch bump dropped it
    for a, b in zip(before, after):
        assert np.array_equal(a[0], b[0]) and a[1] == b[1]
    return _final(srv, [rep, _results(after)])


def case_replicated_results_across_backends(s):
    srv = s.make(s.parts["uniform"], answer_cache=False)
    stream = s.mod.request_stream(s.qs, len(s.qs))
    base = srv.serve(stream)
    rep = srv.replicate_hot()
    other = s.make(srv.part, answer_cache=False, params_spec=srv.params_spec)
    got = other.serve(stream)
    for a, b in zip(base, got):
        assert np.array_equal(a[0], b[0]) and a[1] == b[1]
    return _final(other, [rep, _results(got)])


CASES = {f.__name__[5:]: f for f in (
    case_adaptive_improves_on_drift,
    case_warmup_and_pause_do_not_feed_tracker,
    case_migrated_server_matches_fresh,
    case_migration_reuses_engine_signatures,
    case_replicate_hot_drops_collectives,
    case_replicated_results_across_backends)}


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_case_matches_the_jax_server(world, case, backend):
    jside, sides, jax_runs = world
    if case not in jax_runs:
        jax_runs[case] = CASES[case](jside)
    got, want = CASES[case](sides[backend]), jax_runs[case]
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], (case, key)


def test_migrated_servers_agree_across_backends(lubm_tiny):
    """The migration path gives the same answers on both backends and on
    a fresh server of the new placement (the JAX original holds jnp
    against pallas)."""
    st = generator.generate_lubm(1, scale=0.05, seed=0)
    qs = workloads.lubm_queries()
    wa, wb = serve.two_phase_weights(qs)
    part = partitioner.wawpart_partition(st, qs, n_shards=3,
                                         query_weights=wa)
    res = incremental_repartition(part, qs, wb, budget_frac=0.15)
    stream = serve.request_stream(qs, 16)
    servers = {b: serve.WorkloadServer(qs, part, backend=b, device="cpu")
               for b in BACKENDS}
    first = {b: _results(srv.serve(stream)) for b, srv in servers.items()}
    assert first["torch"] == first["cuda"]
    for srv in servers.values():
        srv.migrate(res.part)
        assert srv.epoch == 1
    fresh = serve.WorkloadServer(qs, res.part, backend="cuda", device="cpu")
    after = [_results(s.serve(stream)) for s in (*servers.values(), fresh)]
    assert after[0] == after[1] == after[2] == first["cuda"]


# ---- drift and tracker units, value for value ----------------------------

def _snap_of(mod, counts, window=1000):
    tr = mod.WorkloadTracker(window=window)
    for n, c in counts.items():
        for _ in range(c):
            tr.observe(n)
    return tr.snapshot()


def test_tracker_and_total_variation_match():
    tr, jtr = stats.WorkloadTracker(window=4), j_stats.WorkloadTracker(
        window=4)
    for name in ("a", "a", "b", "c", "c", "c"):
        tr.observe(name, cut_joins=1, shards=(0, 1))
        jtr.observe(name, cut_joins=1, shards=(0, 1))
    assert dataclasses.astuple(tr.snapshot()) \
        == dataclasses.astuple(jtr.snapshot())
    assert tr.snapshot().counts == {"b": 1, "c": 3}
    u = stats.uniform_baseline(["a", "b", "c", "d"])
    assert u == j_stats.uniform_baseline(["a", "b", "c", "d"])
    pairs = [(u, u), ({"a": 1.0}, {"b": 1.0}), (u, {"a": 1.0}),
             ({"a": 0.3, "b": 0.7}, {"b": 0.2, "c": 0.8})]
    tvs = [drift.total_variation(p, q) for p, q in pairs]
    assert tvs == [j_drift.total_variation(p, q) for p, q in pairs]
    assert tvs[:2] == [0.0, 1.0] and abs(tvs[2] - 0.75) < 1e-12


DRIFT_CASES = [({"a": 50, "b": 50}, None), ({"a": 80, "b": 20}, None),
               ({"a": 100}, None), ({"a": 5}, None),
               ({"a": 60, "b": 20, "z": 20}, None),
               ({"a": 60, "b": 20, "z": 20}, {"a", "b", "z"})]


def test_drift_detector_matches():
    det = drift.DriftDetector(threshold=0.2, full_threshold=0.5,
                              min_requests=10)
    jdet = j_drift.DriftDetector(threshold=0.2, full_threshold=0.5,
                                 min_requests=10)
    base = stats.uniform_baseline(["a", "b"])
    got = [det.check(base, _snap_of(stats, c), known=k)
           for c, k in DRIFT_CASES]
    want = [jdet.check(base, _snap_of(j_stats, c), known=k)
            for c, k in DRIFT_CASES]
    assert [dataclasses.astuple(r) for r in got] \
        == [dataclasses.astuple(r) for r in want]
    assert [r.severity for r in got] == ["none", "incremental", "full",
                                         "none", "full", "incremental"]
    assert [r.drifted for r in got] == [r.drifted for r in want]
    assert drift.SEVERITIES == j_drift.SEVERITIES
    for kw in (dict(threshold=0.6, full_threshold=0.5),
               dict(unseen_mass_threshold=0.0)):
        with pytest.raises(ValueError) as e:
            drift.DriftDetector(**kw)
        with pytest.raises(ValueError) as je:
            j_drift.DriftDetector(**kw)
        assert str(e.value) == str(je.value)


def test_adaptive_config_defaults_match():
    assert dataclasses.asdict(AdaptiveConfig()) \
        == dataclasses.asdict(JAdaptiveConfig())


# ---- streams -------------------------------------------------------------

def test_request_streams_match(world):
    jside, sides, _ = world
    qs, jqs, wa, wb = sides["torch"].qs, jside.qs, jside.wa, jside.wb
    assert serve.request_stream(qs, 2 * len(qs)) \
        == jserve.request_stream(jqs, 2 * len(jqs))
    s1 = serve.request_stream(qs, 400, weights=wa, seed=7)
    assert s1 == jserve.request_stream(jqs, 400, weights=wa, seed=7)
    assert s1 != serve.request_stream(qs, 400, weights=wa, seed=8)
    heavy = {q.name for i, q in enumerate(qs) if i < len(qs) // 2}
    assert sum(1 for n, _ in s1 if n in heavy) > 300
    with pytest.raises(ValueError, match="zero total mass"):
        serve.request_stream(qs, 4, weights={q.name: 0.0 for q in qs})
    for seed in (0, 1, 3):
        d = serve.drifting_stream(qs, [(50, wa), (50, wb)], seed=seed)
        assert d == jserve.drifting_stream(jqs, [(50, wa), (50, wb)],
                                           seed=seed)
    a = serve.drifting_stream(qs, [(80, wa), (80, wa)], seed=0)
    b = serve.drifting_stream(qs, [(80, wa), (80, wa)], seed=1)
    assert a[80:] != b[:80] and a[:80] != a[80:] and a != b


# ---- hot cut-edge replication planning -----------------------------------

def _cand(c):
    return (repr(c.feature), c.target, tuple(map(repr, c.units)), c.triples,
            c.weight, c.queries, c.score)


@pytest.mark.parametrize("weights", ["uniform", "phase_b", "one_hot"])
@pytest.mark.parametrize("budget", [(4, 0.25), (1, 0.25), (8, 0.001)])
def test_replication_plan_matches(world, weights, budget):
    jside, sides, _ = world
    s = sides["torch"]
    qw = {"uniform": None, "phase_b": s.wb,
          "one_hot": {s.qs[10].name: 3.0}}[weights]
    top_k, frac = budget
    rep = replicate.plan_hot_replication(s.parts["uniform"], s.qs, qw,
                                         top_k=top_k, budget_frac=frac)
    jrep = j_replicate.plan_hot_replication(jside.parts["uniform"], jside.qs,
                                            qw, top_k=top_k,
                                            budget_frac=frac)
    assert [_cand(c) for c in rep.candidates] \
        == [_cand(c) for c in jrep.candidates]
    assert [_cand(c) for c in rep.chosen] == [_cand(c) for c in jrep.chosen]
    assert sorted(map(repr, rep.replicas.items())) \
        == sorted(map(repr, jrep.replicas.items()))
    assert (rep.budget_triples, rep.total_triples) \
        == (jrep.budget_triples, jrep.total_triples)
    assert len(rep.chosen) <= top_k
    assert rep.total_triples <= rep.budget_triples


def test_replicated_triples_never_duplicate_result_rows(world):
    """The raw pre-unique table at the PPN shard holds every solution row
    once with and without replication, as the JAX engine's does: the
    extraction's np.unique would hide a double-counted binding."""
    jside, sides, _ = world
    s = sides["torch"]
    part, jpart = s.parts["uniform"], jside.parts["uniform"]
    report = replicate.plan_hot_replication(part, s.qs)
    jreport = j_replicate.plan_hot_replication(jpart, jside.qs)
    part2, jpart2 = part.with_replicas(report.replicas), \
        jpart.with_replicas(jreport.replicas)
    kg2, jkg2 = federated.ShardedKG.build(part2), \
        j_federated.ShardedKG.build(jpart2)
    np.testing.assert_array_equal(kg2.triples, jkg2.triples)
    tr, va = kg2.to_device("cpu")
    affected = {name for c in report.chosen for name in c.queries}
    assert affected
    for q, jq in zip(s.qs, jside.qs):
        if q.name not in affected:
            continue
        plan, jplan = make_plan(q, part2), j_make_plan(jq, jpart2)
        assert plan.n_gathers < make_plan(q, part).n_gathers
        p = np.zeros((max(1, plan.n_params),), np.int32)
        fn = jax.jit(jax.vmap(j_federated.make_engine(
            jplan, join_impl="sorted", max_per_row=256),
            in_axes=(0, 0, None), axis_name="shards"))
        jtable, jmask, jovf = (np.asarray(a) for a in
                               fn(jkg2.triples, jkg2.valid, p))
        for backend in BACKENDS:
            table, mask, ovf = federated.make_engine(
                plan, join_impl="sorted", max_per_row=256,
                backend=backend)(tr, va, torch.from_numpy(p))
            assert not bool(ovf[plan.ppn])
            raw = table[plan.ppn][mask[plan.ppn]].numpy()[:, :plan.n_vars]
            jraw = jtable[jplan.ppn][jmask[jplan.ppn]][:, :jplan.n_vars]
            np.testing.assert_array_equal(raw, jraw, err_msg=q.name)
            uniq, counts = np.unique(raw, axis=0, return_counts=True)
            assert counts.max() == 1, f"{q.name}: duplicated result rows"
            np.testing.assert_array_equal(
                uniq, evaluate_bgp(part.catalog.store, q), err_msg=q.name)
        assert not bool(jovf[jplan.ppn])


def test_cli_replicate_adaptive_drift_on_the_cpu(capsys):
    serve.main(["--scale", "0.05", "--requests", "128", "--batch", "16",
                "--device", "cpu", "--replicate", "--adaptive", "--drift",
                "--seed", "0", "--check"])
    out = capsys.readouterr().out
    rep = next(line for line in out.splitlines() if "replicated " in line)
    assert "unit copies" in rep and "collectives [" in rep
    assert "adaptive: epoch=" in out and "migrations" in out
    assert "oracle: 128/128 answers equal evaluate_bgp" in out
    assert "overflows=0" in out


@pytest.mark.parametrize("backend", BACKENDS)
def test_migration_after_replication_rereads_dropped_replicas(backend):
    """A repartition drops the replicas replicate_hot() added, so migrate
    re-plans the templates whose plans read them on their primary shard,
    and every answer stays the oracle's. (The JAX server's migrate keeps
    those plans, since their units' primary homes did not move, and at
    LUBM 0.05 answers LUBM-Q11 and LUBM-Q12 with no rows after it.)"""
    st = generator.generate_lubm(1, scale=0.05, seed=0)
    qs = workloads.lubm_queries()
    wa, wb = serve.two_phase_weights(qs)
    part = partitioner.wawpart_partition(st, qs, n_shards=3,
                                         query_weights=wa)
    srv = serve.WorkloadServer(qs, part, backend=backend, device="cpu",
                               answer_cache=False)
    rep = srv.replicate_hot()
    assert rep["queries_affected"]
    res = incremental_repartition(srv.part, qs, wb, budget_frac=0.15)
    assert res.mode == "incremental" and not res.part.replicas
    report = srv.migrate(res.part)
    assert report["plans_rewritten"] >= len(rep["queries_affected"])
    stream = serve.request_stream(qs, len(qs))
    want = serve.WorkloadServer(qs, res.part, backend=backend, device="cpu",
                                answer_cache=False).serve(stream)
    got = srv.serve(stream)
    assert _results(got) == _results(want)
    for (name, _), (rows, n, ovf) in zip(stream, got):
        q = next(q for q in qs if q.name == name)
        assert not ovf and n == len(rows)
        np.testing.assert_array_equal(rows, evaluate_bgp(st, q),
                                      err_msg=name)
