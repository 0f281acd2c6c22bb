"""The port's fault layer against the JAX package's, case by case: every
case of tests/test_faults.py (seeded chaos with and without retry, retry
exhaustion, the absolute retry deadline, the backoff window, parity with
an empty injector, a shard-down window, mark_shard_down over replicas,
the fast shed, migration refused while degraded, an aborted migration,
the adaptive controller under aborts, the capped engine cache, shutdown
and the empty server) under the same plans, seeds and FakeClock.

Each server case runs once through the JAX server and once through the
port per backend (``device="cpu"``), and everything it observes must be
equal: every ticket's result (bit for bit), error type, attempts, epoch,
flush reason and stamps, the reports of migrate / replicate_hot /
mark_shard_down, ``stats``, ``telemetry.snapshot()``, the Chrome trace
events and the injector's ``injected`` tallies. Each case also asserts
what its JAX original asserts, on both sides. The pure units (the chaos
grammar, classify, backoff, the no-op injector, degraded placement) are
compared value for value.

The JAX side waits for each dispatch (``_ReadyServer``): its readiness
poll races XLA's asynchronous CPU execution, and the backoff-window case
needs the batch retired by the pump() that dispatched it.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the test workers running beside
# this one keep their cores
torch.set_num_threads(1)

import jax  # noqa: E402

from repro import faults as j_faults  # noqa: E402
from repro.adaptive import controller as j_controller  # noqa: E402
from repro.adaptive.repartition import \
    incremental_repartition as j_incremental  # noqa: E402
from repro.core import partitioner as j_partitioner  # noqa: E402
from repro.engine import batch as j_batch  # noqa: E402
from repro.engine import federated as j_federated  # noqa: E402
from repro.kg import workloads as j_work  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.obs import Telemetry as JTelemetry  # noqa: E402

from repro_torch import faults  # noqa: E402
from repro_torch.adaptive import controller  # noqa: E402
from repro_torch.adaptive.repartition import \
    incremental_repartition  # noqa: E402
from repro_torch.core import partitioner  # noqa: E402
from repro_torch.engine import batch, federated  # noqa: E402
from repro_torch.kg import generator, workloads  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.obs import Telemetry  # noqa: E402

BACKENDS = ("torch", "cuda")


class FakeClock:
    """Deterministic monotonic clock the tests advance by hand; with
    ``tick`` it also advances by that much on every read, so the stamps
    depend on where the server reads it."""

    def __init__(self, tick: float = 0.0):
        self.t = 0.0
        self.tick = tick

    def __call__(self):
        t = self.t
        self.t += self.tick
        return t

    def advance(self, dt):
        self.t += dt


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
    faults: object          # the faults package
    controller: object      # adaptive.controller
    partitioner: object     # core.partitioner
    batch: object           # engine.batch
    federated: object       # engine.federated
    repartition: object     # incremental_repartition
    qs: list
    part: object
    make: object            # make(clock, trace=True, **kw) -> server


@pytest.fixture(scope="module")
def world(lubm_tiny):
    st = generator.generate_lubm(1, scale=0.05, seed=0)
    np.testing.assert_array_equal(st.triples, lubm_tiny.triples)
    qs, jqs = workloads.lubm_queries(), j_work.lubm_queries()
    part = partitioner.wawpart_partition(st, qs, n_shards=3)
    jpart = j_partitioner.wawpart_partition(lubm_tiny, jqs, n_shards=3)
    jcache = j_batch.EngineCache()

    def jmake(clock, trace=True, **kw):
        pipe = {k: kw.pop(k) for k in ("deadline_ms", "max_batch")
                if k in kw}
        kw.setdefault("cache", jcache)
        return _ReadyServer(jqs, jpart, telemetry=JTelemetry(trace=trace),
                            pipeline=jserve.PipelineConfig(clock=clock,
                                                           **pipe), **kw)

    jside = Side(jserve, j_faults, j_controller, j_partitioner, j_batch,
                 j_federated, j_incremental, jqs, jpart, jmake)
    sides = {}
    for backend in BACKENDS:
        cache = batch.EngineCache()

        def make(clock, trace=True, _cache=cache, _backend=backend, **kw):
            pipe = {k: kw.pop(k) for k in ("deadline_ms", "max_batch")
                    if k in kw}
            kw.setdefault("cache", _cache)
            return serve.WorkloadServer(
                qs, part, backend=_backend, device="cpu",
                telemetry=Telemetry(trace=trace),
                pipeline=serve.PipelineConfig(clock=clock, **pipe), **kw)

        sides[backend] = Side(serve, faults, controller, partitioner, batch,
                              federated, incremental_repartition, qs, part,
                              make)
    return jside, sides, {}


def _result(res):
    if res is None:
        return None
    rows, n, ovf = res
    rows = np.asarray(rows)
    return (rows.dtype.str, rows.shape, rows.tobytes(), int(n), bool(ovf))


def _ticket(t):
    return (t.name, t.seq, t.done, t.flush_reason, t.epoch, t.cache_hit,
            t.t_enqueue, t.t_flush, t.t_dispatch, t.t_done, t.attempts,
            type(t.error).__name__ if t.error is not None else None,
            type(t.error.__cause__).__name__
            if t.error is not None and t.error.__cause__ is not None
            else None,
            _result(t.result))


def _final(srv, tickets, log):
    return {"log": log, "tickets": [_ticket(t) for t in tickets],
            "stats": srv.stats,
            "snapshot": srv.telemetry.snapshot(),
            "trace": srv.telemetry.trace.to_chrome()["traceEvents"],
            "injected": None if srv.faults is None
            else dict(srv.faults.injected),
            "epoch": srv.epoch, "degraded": srv.degraded,
            "shed_templates": sorted(srv.shed_templates),
            "depth": srv.queue_depth(), "inflight": srv.n_inflight}


def _stream(qs, n):
    return [(qs[i % len(qs)].name, None) for i in range(n)]


def _eq(a, b):
    return _result(a) == _result(b)


# ---- the cases: each takes a Side and returns what it observed ----------

def case_chaos_dispatch_retry(s):
    reqs = _stream(s.qs, 20)
    ref = s.make(FakeClock(), trace=False, deadline_ms=None).serve(reqs)
    srv = s.make(FakeClock(tick=0.0005), deadline_ms=None,
                 faults=s.faults.FaultPlan(seed=5, dispatch_fail_rate=0.5),
                 retry=s.faults.RetryPolicy(max_attempts=8))
    tickets = [srv.submit(n, p, _pump=False) for n, p in reqs]
    srv.drain()
    assert srv.faults.injected["dispatch"] > 0, "schedule never fired"
    for a, t in zip(ref, tickets):
        assert t.result is not None and _eq(a, t.result)
    st = srv.stats
    assert st["retries"] > 0 and st["shed"] == 0
    assert st["served"] == len(reqs)
    return _final(srv, tickets, [])


def case_chaos_no_retry(s):
    reqs = _stream(s.qs, 16)
    srv = s.make(FakeClock(tick=0.0005), deadline_ms=None,
                 faults=s.faults.FaultPlan(seed=1, dispatch_fail_rate=1.0,
                                           max_dispatch_failures=2))
    tickets = [srv.submit(n, p, _pump=False) for n, p in reqs]
    srv.drain()
    errs = [t for t in tickets if t.error is not None]
    assert errs and all(isinstance(t.error, s.faults.InjectedDispatchError)
                        for t in errs)
    assert all(t.done and t.result is None for t in errs)
    st = srv.stats
    assert st["shed"] == len(errs) and st["served"] == len(reqs)
    return _final(srv, tickets, [])


def case_retry_exhaustion(s):
    reqs = _stream(s.qs, 8)
    srv = s.make(FakeClock(tick=0.0005), deadline_ms=None,
                 faults=s.faults.FaultPlan(dispatch_fail_rate=1.0),
                 retry=s.faults.RetryPolicy(max_attempts=3))
    tickets = [srv.submit(n, p, _pump=False) for n, p in reqs]
    srv.drain()
    assert all(isinstance(t.error, s.faults.RetryExhaustedError)
               for t in tickets)
    assert all(t.attempts == 3 for t in tickets)
    assert all(isinstance(t.error.__cause__, s.faults.InjectedDispatchError)
               for t in tickets)
    srv.telemetry.check_invariants()
    return _final(srv, tickets, [])


def case_retry_absolute_deadline(s):
    ck = FakeClock()
    srv = s.make(ck, deadline_ms=None,
                 faults=s.faults.FaultPlan(dispatch_fail_rate=1.0),
                 retry=s.faults.RetryPolicy(max_attempts=50,
                                            deadline_ms=5.0))
    t = srv.submit(s.qs[0].name, None, _pump=False)
    ck.advance(0.010)               # past the 5 ms absolute budget
    srv.drain()
    assert isinstance(t.error, s.faults.DeadlineExceededError)
    st = srv.stats
    assert st["timeouts"] == 1 and st["shed"] == 1
    return _final(srv, [t], [])


def case_backoff_window(s):
    ck = FakeClock()
    srv = s.make(ck, deadline_ms=1.0, max_batch=4,
                 faults=s.faults.FaultPlan(dispatch_fail_rate=1.0,
                                           max_dispatch_failures=1),
                 retry=s.faults.RetryPolicy(max_attempts=5, base_ms=2.0,
                                            cap_ms=2.0))
    t = srv.submit(s.qs[0].name, None, _pump=False)
    ck.advance(0.002)               # deadline expires -> flush fails once
    log = [("pump", srv.pump(), t.done, srv.stats["retries"])]
    assert not t.done and srv.stats["retries"] == 1
    log.append(("pump", srv.pump(), t.done))   # inside the backoff window
    assert not t.done
    ck.advance(0.010)               # backoff (<= 2 ms jittered) elapsed
    log.append(("pump", srv.pump(), t.done))
    assert t.done and t.error is None
    log.append(("drain", srv.drain()))
    return _final(srv, [t], log)


def case_empty_injector_parity(s):
    reqs = _stream(s.qs, 12)
    plain = s.make(FakeClock(), deadline_ms=None)
    armed = s.make(FakeClock(), deadline_ms=None,
                   faults=s.faults.FaultPlan(), retry=s.faults.RetryPolicy())
    ra, rb = plain.serve(reqs), armed.serve(reqs)
    for a, b in zip(ra, rb):
        assert _eq(a, b)
    assert plain.stats == armed.stats
    assert plain.telemetry.snapshot() == armed.telemetry.snapshot()
    return _final(armed, [], [[_result(r) for r in rb]])


def case_shard_down_window(s):
    reqs = _stream(s.qs, 14)
    ck = FakeClock()
    srv = s.make(ck, deadline_ms=None,
                 faults=s.faults.FaultPlan(shard_down=((1, 1.0, 2.0),)))
    ref = srv.serve(reqs)                      # healthy; arms the injector
    assert srv.degraded is None
    ck.advance(1.5)                            # inside the down window
    got = srv.serve(reqs)
    assert srv.degraded == 1
    shed = srv.shed_templates
    lost = s.faults.uncovered_templates(
        s.qs, *s.faults.degraded_placement(s.part, 1))
    assert shed == lost
    for (name, _), a, b in zip(reqs, ref, got):
        if name in shed:
            assert b is None
        else:
            assert _eq(a, b)                   # exact from re-homed rows
    st = srv.stats
    assert st["shard_down"] == 1
    assert st["shed"] == sum(1 for n, _ in reqs if n in shed)
    log = [("down", sorted(shed), srv.epoch, [_result(r) for r in got])]
    ck.advance(1.0)                            # window closed -> restore
    back = srv.serve(reqs)
    assert srv.degraded is None and not srv.shed_templates
    for a, b in zip(ref, back):
        assert _eq(a, b)
    log.append(("up", srv.epoch, [_result(r) for r in back]))
    return _final(srv, [], log)


def case_shard_down_over_replicas(s):
    reqs = _stream(s.qs, 10)
    srv = s.make(FakeClock(), deadline_ms=None)
    ref = srv.serve(reqs)
    rep = srv.replicate_hot()                  # spare capacity for failover
    queued = [srv.submit(n, p, _pump=False) for n, p in reqs]
    down = srv.mark_shard_down(1)
    shed = set(down["shed_templates"])
    for t in queued:
        if t.name in shed:
            assert t.done and isinstance(t.error, s.faults.ShardDownError)
    with pytest.raises(RuntimeError, match="already degraded"):
        srv.mark_shard_down(0)
    srv.drain()
    for (name, _), a, t in zip(reqs, ref, queued):
        if name not in shed:
            assert t.error is None and _eq(a, t.result)
    if any(t.error is None for t in queued):
        assert srv.stats["degraded_served"] > 0
    up = srv.mark_shard_up()
    assert up["epoch"] == srv.epoch and srv.mark_shard_up() is None
    back = srv.serve(reqs)
    for a, b in zip(ref, back):
        assert _eq(a, b)
    return _final(srv, queued, [("replicate", rep), ("down", down),
                                ("up", up)])


def case_submit_sheds_fast(s):
    results = []
    for shard in range(3):
        srv = s.make(FakeClock(), deadline_ms=None)
        rep = srv.mark_shard_down(shard)
        tickets = [srv.submit(n, None) for n in rep["shed_templates"]]
        for t in tickets:
            assert t.done and isinstance(t.error, s.faults.ShardDownError)
            assert t.result is None and t.flush_reason == "shed"
        assert srv.queue_depth() == 0
        srv.drain()
        results.append(_final(srv, tickets, [("down", rep)]))
    assert any(r["tickets"] for r in results), \
        "every template covered around every shard"
    return {"shards": results}


def case_migration_refused_while_degraded(s):
    srv = s.make(FakeClock(), deadline_ms=None)
    down = srv.mark_shard_down(2)
    res = s.repartition(s.part, s.qs, {q.name: 1.0 for q in s.qs},
                        budget_frac=0.2)
    epoch = srv.epoch
    with pytest.raises(s.faults.MigrationAbortedError, match="refused"):
        srv.migrate(res.part if res.mode != "noop" else s.part)
    assert srv.epoch == epoch
    assert srv.stats["migration_aborts"] == 1
    return _final(srv, [], [("down", down), ("mode", res.mode)])


def case_migration_abort_rolls_back(s):
    reqs = _stream(s.qs, 12)
    srv = s.make(FakeClock(), answer_cache=False, deadline_ms=None,
                 faults=s.faults.FaultPlan(abort_migrations=1))
    ref = srv.serve(reqs)
    res = s.repartition(s.part, s.qs, {q.name: 1.0 for q in s.qs},
                        budget_frac=0.25)
    assert res.mode != "noop"
    queued = [srv.submit(n, p, _pump=False) for n, p in reqs]
    with pytest.raises(s.faults.MigrationAbortedError, match="injected"):
        srv.migrate(res.part)
    assert srv.epoch == 0                      # rollback: no swap
    assert srv.stats["migration_aborts"] == 1
    assert srv.queue_depth() == len(reqs)
    srv.drain()
    assert all(t.done and t.error is None for t in queued)
    for a, t in zip(ref, queued):
        assert _eq(a, t.result)
    mig = srv.migrate(res.part)                # the abort budget is spent
    assert mig["epoch"] == 1 and srv.epoch == 1
    after = srv.serve(reqs)
    for a, b in zip(ref, after):
        assert _eq(a, b)
    return _final(srv, queued, [("migrate", mig)])


def case_adaptive_survives_abort(s):
    wa, wb = s.mod.two_phase_weights(s.qs)
    stream = s.mod.drifting_stream(s.qs, [(96, wa), (96, wb)], seed=0)
    cfg = s.controller.AdaptiveConfig(window=64, check_every=32,
                                      min_requests=32)
    srv = s.make(FakeClock(), deadline_ms=None, adaptive=cfg,
                 faults=s.faults.FaultPlan(abort_migrations=99))
    results = []
    for i in range(0, len(stream), 32):
        results += srv.serve(stream[i:i + 32])      # must not raise
    assert srv.epoch == 0                           # every prepare aborted
    aborted = [e for e in srv.adaptive.events if e.mode == "aborted"]
    if srv.faults.injected["migration_abort"]:
        assert aborted and all(e.migration is None for e in aborted)
        assert srv.stats["migration_aborts"] == \
            srv.faults.injected["migration_abort"]
    return _final(srv, [], [
        [dataclasses.asdict(e) for e in srv.adaptive.events],
        [_result(r) for r in results]])


def case_engine_cache_lru(s):
    buckets = s.batch.bucket_plans([s.mod.make_plan(q, s.part)
                                    for q in s.qs])
    assert len(buckets) >= 3
    cache = s.batch.EngineCache(capacity=2)
    a, b, c = (bk.signature for bk in buckets[:3])
    log = []
    for sig in (a, b, a, c, a, b):
        cache.get(sig)
        log.append((len(cache), cache.hits, cache.misses, cache.evictions))
    assert log[1][3] == 0 and log[3][3] == 1
    assert log[4][2] == 3 and log[5][2:] == (4, 2)
    with pytest.raises(ValueError, match="capacity"):
        s.batch.EngineCache(capacity=0)
    assert s.batch.EngineCache().capacity is None
    return {"log": log}


def case_engine_cache_evictions(s):
    srv = s.make(FakeClock(), deadline_ms=None,
                 cache=s.batch.EngineCache(capacity=1))
    srv.serve(_stream(s.qs, len(s.qs)))
    assert srv.cache.evictions > 0
    assert srv.stats["engine_cache_evictions"] == srv.cache.evictions
    return _final(srv, [], [(srv.cache.misses, srv.cache.evictions)])


def case_shutdown_no_grace(s):
    reqs = _stream(s.qs, 6)
    srv = s.make(FakeClock(), deadline_ms=None)
    tickets = [srv.submit(n, p, _pump=False) for n, p in reqs]
    out = srv.shutdown(grace_s=0.0)
    assert out == {"drained": 0, "shed": len(reqs)}
    assert all(isinstance(t.error, s.faults.ShutdownError) for t in tickets)
    assert srv.queue_depth() == 0 and srv.n_inflight == 0
    assert srv.stats["shed"] == len(reqs)
    return _final(srv, tickets, [out])


def case_shutdown_with_grace(s):
    reqs = _stream(s.qs, 6)
    srv = s.make(FakeClock(), answer_cache=False, deadline_ms=None)
    ref = srv.serve(reqs)
    tickets = [srv.submit(n, p, _pump=False) for n, p in reqs]
    out = srv.shutdown(grace_s=30.0)
    assert out["shed"] == 0 and out["drained"] == len(reqs)
    for a, t in zip(ref, tickets):
        assert t.error is None and _eq(a, t.result)
    return _final(srv, tickets, [out])


def case_empty_server(s):
    srv = s.make(FakeClock())
    ls = srv.latency_stats()
    assert ls["n"] == 0 and ls["p99_ms"] == 0.0
    assert srv.latency_stats(per_bucket=True)["per_bucket"] == {}
    log = [srv.drain(), srv.pump(), srv.shutdown()]
    assert log == [0, 0, {"drained": 0, "shed": 0}]
    assert srv.stats["served"] == 0
    return _final(srv, [], log)


CASES = {f.__name__[5:]: f for f in (
    case_chaos_dispatch_retry, case_chaos_no_retry, case_retry_exhaustion,
    case_retry_absolute_deadline, case_backoff_window,
    case_empty_injector_parity, case_shard_down_window,
    case_shard_down_over_replicas, case_submit_sheds_fast,
    case_migration_refused_while_degraded, case_migration_abort_rolls_back,
    case_adaptive_survives_abort, case_engine_cache_lru,
    case_engine_cache_evictions, case_shutdown_no_grace,
    case_shutdown_with_grace, case_empty_server)}


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


# ---- pure units, value for value ----------------------------------------

CHAOS_SPECS = ("dispatch=0.25/3,down=1@0.5:2.0,delay=0.1:0.2;0.4:0.5,"
               "abort=2,seed=7", "", "dispatch=0.3/4,seed=7",
               "down=0@0:1,down=2@1.5:3", "delay=0:0.25", "abort=1",
               " dispatch=1 , seed=3 ")
BAD_SPECS = ("explode=1", "dispatch", "down=1@x:2")


def test_chaos_grammar_matches():
    for spec in CHAOS_SPECS:
        got, want = faults.FaultPlan.parse(spec), \
            j_faults.FaultPlan.parse(spec)
        assert dataclasses.astuple(got) == dataclasses.astuple(want), spec
        assert got.empty == want.empty
    plan = faults.FaultPlan.parse(CHAOS_SPECS[0])
    assert plan.max_dispatch_failures == 3 and plan.abort_migrations == 2
    assert plan.flush_delay == ((0.1, 0.2), (0.4, 0.5))
    for spec in BAD_SPECS:
        with pytest.raises(ValueError) as got:
            faults.FaultPlan.parse(spec)
        with pytest.raises(ValueError) as want:
            j_faults.FaultPlan.parse(spec)
        assert str(got.value) == str(want.value), spec


def test_classify_matches_on_serving_and_card_errors():
    errors = [federated.CapacityOverflowError("full"), ValueError("bad"),
              KeyError("no template"), faults.InjectedDispatchError("c"),
              faults.ShardDownError("down"), RuntimeError("wobble"),
              torch.cuda.OutOfMemoryError("out of memory")]
    kinds = [faults.classify(e) for e in errors]
    assert kinds == [j_faults.classify(e) for e in errors]
    assert kinds == ["permanent"] * 3 + ["transient"] * 4
    assert faults.classify(j_federated.CapacityOverflowError("x")) \
        == "permanent"


@pytest.mark.parametrize("seed", [0, 3, 4])
@pytest.mark.parametrize("window", [(1.0, 50.0), (1.0, 8.0), (2.0, 2.0),
                                    (0.0, 0.5)])
def test_backoff_matches(seed, window):
    base, cap = window
    pol = faults.RetryPolicy(base_ms=base, cap_ms=cap, seed=seed)
    jpol = j_faults.RetryPolicy(base_ms=base, cap_ms=cap, seed=seed)
    assert dataclasses.astuple(pol) == dataclasses.astuple(jpol)
    prev = jprev = None
    for attempt in range(0, 9):
        b, jb = pol.backoff_s(attempt, prev), jpol.backoff_s(attempt, jprev)
        assert b == jb and b > 0
        assert b <= max(cap, base, 1e-3) / 1e3 + 1e-12
        prev, jprev = b, jb
    for attempt in range(1, 5):
        assert pol.backoff_s(attempt) == jpol.backoff_s(attempt)


def test_injectors_fire_the_same_schedule():
    plans = [("seed=5", dict(seed=5, dispatch_fail_rate=0.5)),
             ("capped", dict(seed=1, dispatch_fail_rate=1.0,
                             max_dispatch_failures=2)),
             ("windows", dict(flush_delay=((0.1, 0.2),),
                              shard_down=((1, 0.5, 2.0),),
                              abort_migrations=2)),
             ("empty", {})]
    for label, kw in plans:
        inj = faults.FaultInjector(faults.FaultPlan(**kw))
        jinj = j_faults.FaultInjector(j_faults.FaultPlan(**kw))
        assert inj.enabled == jinj.enabled, label
        got, want = [], []
        for side, out in ((inj, got), (jinj, want)):
            side.observe(3.0)
            for i in range(40):
                now = 3.0 + 0.07 * i
                try:
                    side.on_dispatch(i % 5)
                    fired = None
                except Exception as exc:    # the injected error, by type
                    fired = (type(exc).__name__, str(exc))
                try:
                    side.check_migration_abort()
                    aborted = None
                except Exception as exc:
                    aborted = type(exc).__name__
                out.append((fired, aborted, side.flush_delayed(i, now),
                            side.shard_down_now(now)))
            out.append(dict(side.injected))
        assert got == want, label
    noop = faults.FaultInjector(faults.FaultPlan())
    assert not noop.enabled and noop.injected == {
        "dispatch": 0, "shard_down": 0, "migration_abort": 0}


def test_degraded_placement_matches_on_a_fake_catalog():
    class _Cat:
        sizes = {"a": 5, "b": 3, "c": 2}

    got = faults.degraded_placement(partitioner.Partitioning(
        3, {"a": 0, "b": 0, "c": 1}, _Cat(), np.array([8, 2, 0]),
        method="test", replicas={"a": frozenset({2})}), 0)
    want = j_faults.degraded_placement(j_partitioner.Partitioning(
        3, {"a": 0, "b": 0, "c": 1}, _Cat(), np.array([8, 2, 0]),
        method="test", replicas={"a": frozenset({2})}), 0)
    for (dpart, lost), (jdpart, jlost) in ((got, want),):
        assert dpart.unit_shard == jdpart.unit_shard == {"a": 2, "b": 0,
                                                         "c": 1}
        assert lost == jlost == frozenset({"b"})
        assert dpart.replicas == jdpart.replicas == {}
        assert dpart.shard_sizes.tolist() == jdpart.shard_sizes.tolist() \
            == [3, 2, 5]
        assert dpart.meta == jdpart.meta
    with pytest.raises(ValueError, match="not in 0..2"):
        faults.degraded_placement(got[0], 9)


def test_degraded_placement_matches_over_replicas(world):
    """Around every shard of the WawPart placement, before and after hot
    replication: the same re-homed units, lost units, sizes and shed
    templates."""
    from repro.adaptive.replicate import plan_hot_replication as j_plan

    from repro_torch.adaptive.replicate import plan_hot_replication

    jside, sides, _ = world
    s = sides["torch"]
    rep = plan_hot_replication(s.part, s.qs)
    jrep = j_plan(jside.part, jside.qs)
    assert rep.replicas
    parts = [(s.part, jside.part),
             (s.part.with_replicas(rep.replicas),
              jside.part.with_replicas(jrep.replicas))]
    for part, jpart in parts:
        for shard in range(3):
            dpart, lost = faults.degraded_placement(part, shard)
            jdpart, jlost = j_faults.degraded_placement(jpart, shard)
            assert sorted(map(repr, dpart.unit_shard.items())) \
                == sorted(map(repr, jdpart.unit_shard.items()))
            assert sorted(map(repr, lost)) == sorted(map(repr, jlost))
            assert dpart.shard_sizes.tolist() == jdpart.shard_sizes.tolist()
            assert faults.uncovered_templates(s.qs, dpart, lost) \
                == j_faults.uncovered_templates(jside.qs, jdpart, jlost)


def test_cli_chaos_on_the_cpu(capsys):
    serve.main(["--scale", "0.05", "--requests", "28", "--batch", "14",
                "--device", "cpu", "--no-cache", "--chaos",
                "dispatch=0.3/4,seed=7", "--check"])
    out = capsys.readouterr().out
    # the four failures the cap allows fire while warmup serves the stream
    # (warmup's retries are not in the timed loop's stats)
    chaos = next(line for line in out.splitlines() if "chaos:" in line)
    assert "injected dispatch_failures=4 shard_down=0" in chaos
    assert "shed=0 timeouts=0" in chaos
    assert "oracle: 28/28 answers equal evaluate_bgp" in out
    assert "overflows=0" in out
