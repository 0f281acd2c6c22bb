"""The port's continuous-batching pipeline against the JAX package's, case by
case under one schedule: every FakeClock case of tests/test_pipeline.py
(deadline flush of one request, full flush, fill-only, drain barrier,
cache hit, migration mid-queue, per-bucket latency stats and their stamp
guard, shard-load gauges) and shutdown with no grace and with a budget.

Each case runs once through the JAX server and once through the port per
backend (``device="cpu"``), and everything it observes must be equal:
every ticket's result (bit for bit), done flag, flush reason, epoch,
cache-hit flag and timestamps, each pump()/drain() return, ``stats``,
``latency_stats``, ``telemetry.snapshot()`` and the Chrome trace events.

On CPU tensors the port's batches are ready as soon as they are
dispatched. The JAX server's readiness poll races XLA's asynchronous CPU
execution, so its side here waits for each dispatch before the pipeline
moves on (``_ReadyServer``): its pump() then retires exactly what the
port's does.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the test workers running beside
# this one keep their cores
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.adaptive.repartition import \
    incremental_repartition as j_incremental  # noqa: E402
from repro.core.partitioner import wawpart_partition as j_wawpart  # noqa: E402
from repro.engine.batch import EngineCache as JEngineCache  # noqa: E402
from repro.kg import workloads as j_work  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.obs import Telemetry as JTelemetry  # noqa: E402

from repro_torch.adaptive.repartition import \
    incremental_repartition  # noqa: E402
from repro_torch.core.partitioner import wawpart_partition  # noqa: E402
from repro_torch.engine.batch import EngineCache, fetch_outputs  # noqa: E402
from repro_torch.faults import ShutdownError  # noqa: E402
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


class Side:
    """One package's server factory and helpers for the cases."""

    def __init__(self, mod, qs, part, make, repartition):
        self.mod, self.qs, self.part = mod, qs, part
        self.make, self.repartition = make, repartition


@pytest.fixture(scope="module")
def world(lubm_small):
    st = generator.generate_lubm(1, scale=0.2, seed=0)
    np.testing.assert_array_equal(st.triples, lubm_small.triples)
    qs, jqs = workloads.lubm_queries(), j_work.lubm_queries()
    part = wawpart_partition(st, qs, n_shards=3)
    jpart = j_wawpart(lubm_small, jqs, n_shards=3)
    jcache = JEngineCache()

    def jmake(clock, trace=True, part=jpart, **kw):
        pipe = {k: kw.pop(k) for k in ("deadline_ms", "max_batch")
                if k in kw}
        return _ReadyServer(jqs, part, cache=jcache,
                            telemetry=JTelemetry(trace=trace),
                            pipeline=jserve.PipelineConfig(clock=clock,
                                                           **pipe), **kw)

    jside = Side(jserve, jqs, jpart, jmake, j_incremental)
    sides = {}
    for backend in BACKENDS:
        cache = EngineCache()

        def make(clock, trace=True, part=part, _cache=cache,
                 _backend=backend, **kw):
            pipe = {k: kw.pop(k) for k in ("deadline_ms", "max_batch")
                    if k in kw}
            return serve.WorkloadServer(
                qs, part, cache=_cache, backend=_backend, device="cpu",
                telemetry=Telemetry(trace=trace),
                pipeline=serve.PipelineConfig(clock=clock, **pipe), **kw)

        sides[backend] = Side(serve, qs, part, make, incremental_repartition)
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
            _result(t.result))


def _final(srv, tickets, log):
    return {"log": log, "tickets": [_ticket(t) for t in tickets],
            "stats": srv.stats,
            "latency": srv.latency_stats(per_bucket=True),
            "snapshot": srv.telemetry.snapshot(),
            "trace": srv.telemetry.trace.to_chrome()["traceEvents"],
            "depth": srv.queue_depth(), "inflight": srv.n_inflight}


# ---- the cases: each takes a Side and returns what it observed ----------

def case_deadline_single(s):
    clock = FakeClock()
    srv = s.make(clock, answer_cache=False, deadline_ms=10.0, max_batch=64)
    tickets, log = [], []
    for q in (s.qs[0], s.qs[7]):
        t = srv.submit(q.name)
        tickets.append(t)
        log.append(("queued", t.done, srv.queue_depth()))
        log.append(("pump", srv.pump(), srv.queue_depth()))
        clock.advance(0.011)                  # past the 10 ms budget
        log.append(("pump", srv.pump(), srv.queue_depth(), t.done))
        log.append(("drain", srv.drain()))
    return _final(srv, tickets, log)


def case_full_flush(s):
    srv = s.make(FakeClock(), answer_cache=False, deadline_ms=None,
                 max_batch=4)
    tickets = [srv.submit(s.qs[0].name) for _ in range(7)]
    log = [("submitted", srv.stats, srv.queue_depth(), srv.n_inflight),
           ("drain", srv.drain())]
    return _final(srv, tickets, log)


def case_fill_only(s):
    clock = FakeClock()
    srv = s.make(clock, answer_cache=False, deadline_ms=None, max_batch=64)
    t = srv.submit(s.qs[0].name)
    clock.advance(3600.0)
    log = [("pump", srv.pump(), srv.queue_depth(), t.done),
           ("drain", srv.drain())]
    return _final(srv, [t], log)


def case_drain_barrier(s):
    srv = s.make(FakeClock(), answer_cache=False, deadline_ms=None,
                 max_batch=64)
    stream = s.mod.request_stream(s.qs, 17)     # several buckets, partial
    tickets = [srv.submit(n, p, _pump=False) for n, p in stream]
    log = [("queued", srv.queue_depth()), ("drain", srv.drain()),
           ("again", srv.drain())]
    return _final(srv, tickets, log)


def case_cache_hit(s):
    clock = FakeClock()
    srv = s.make(clock, deadline_ms=None, max_batch=64)
    name = s.qs[3].name
    first = srv.serve([(name, None)])           # fills the cache
    clock.advance(0.004)
    t = srv.submit(name, _pump=False)
    log = [("first", [_result(r) for r in first]),
           ("hit", srv.queue_depth(), srv.latency_stats()["n"])]
    clock.advance(0.002)
    again = srv.serve([(name, None)])
    log.append(("again", [_result(r) for r in again]))
    return _final(srv, [t], log)


def case_migration_mid_queue(s):
    clock = FakeClock()
    _wa, wb = s.mod.two_phase_weights(s.qs)
    res = s.repartition(s.part, s.qs, wb, budget_frac=0.15)
    srv = s.make(clock, answer_cache=False, deadline_ms=None, max_batch=64)
    stream = s.mod.request_stream(s.qs, 14)
    tickets = [srv.submit(n, p, _pump=False) for n, p in stream]
    clock.advance(0.003)
    report = srv.migrate(res.part)              # bump while all are queued
    clock.advance(0.002)
    log = [("migrate", report, srv.epoch, srv.queue_depth()),
           ("drain", srv.drain()),
           ("unit_shard", sorted(map(repr, res.part.unit_shard.items())))]
    return _final(srv, tickets, log)


def case_latency_per_bucket(s):
    clock = FakeClock(tick=0.0005)
    srv = s.make(clock, answer_cache=False, deadline_ms=None, max_batch=64)
    stream = [(s.qs[i % len(s.qs)].name, None) for i in range(10)]
    srv.serve(stream)
    log = [("plain", srv.latency_stats()),
           ("routed", sorted({srv.route[n][0] for n, _ in stream}))]
    # rows with missing stamps: done/enqueue-less rows are skipped, a
    # flush-less row only drops out of the queue/service legs
    srv._latencies.append((0, 1.0, None, None, None))
    srv._latencies.append((0, None, None, None, 2.0))
    srv._latencies.append((0, 1.0, None, None, 1.5))
    return _final(srv, [], log)


def case_shard_load(s):
    srv = s.make(FakeClock(), answer_cache=False)
    stream = s.mod.request_stream(s.qs, 24)
    srv.serve(stream)
    snap = srv.tracker.snapshot()
    log = [("window", snap.total, dict(snap.counts), dict(snap.shard_load),
            snap.imbalance(s.part.n_shards))]
    with srv.tracking_paused():
        srv.serve(stream[:4])
    log.append(("paused", srv.tracker.snapshot().total))
    return _final(srv, [], log)


def _queued_across_buckets(s, srv):
    """Six requests of one template (full flushes of four go in flight)
    and one of each other template."""
    name = s.qs[0].name
    tickets = [srv.submit(name) for _ in range(6)]
    tickets += [srv.submit(q.name) for q in s.qs[1:]]
    return tickets


def case_shutdown_no_grace(s):
    srv = s.make(FakeClock(), answer_cache=False, deadline_ms=None,
                 max_batch=4)
    tickets = _queued_across_buckets(s, srv)
    log = [("before", srv.queue_depth(), srv.n_inflight,
            srv.stats["served"]), ("shutdown", srv.shutdown(grace_s=0))]
    return _final(srv, tickets, log)


def case_shutdown_budget(s):
    clock = FakeClock(tick=0.001)               # every read is 1 ms later
    srv = s.make(clock, answer_cache=False, deadline_ms=None, max_batch=4)
    tickets = _queued_across_buckets(s, srv)
    log = [("before", srv.queue_depth(), srv.n_inflight,
            srv.stats["served"]), ("shutdown", srv.shutdown(grace_s=0.006))]
    return _final(srv, tickets, log)


CASES = {f.__name__[5:]: f for f in (
    case_deadline_single, case_full_flush, case_fill_only,
    case_drain_barrier, case_cache_hit, case_migration_mid_queue,
    case_latency_per_bucket, case_shard_load, case_shutdown_no_grace,
    case_shutdown_budget)}


def _run(world, case, backend):
    jside, sides, jax_runs = world
    if case not in jax_runs:
        jax_runs[case] = CASES[case](jside)
    return CASES[case](sides[backend]), jax_runs[case]


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("case", sorted(CASES))
def test_case_matches_the_jax_pipeline(world, case, backend):
    got, want = _run(world, case, backend)
    for key in want:
        assert got[key] == want[key], (case, key)
    assert got["depth"] == got["inflight"] == 0


def test_case_outcomes(world):
    """What the cases must show on their own, not only agree on."""
    run = {c: _run(world, c, "cuda")[0] for c in CASES}
    by = {c: {n: r["stats"][n] for n in ("flush_full", "flush_deadline",
                                          "flush_drain", "shed",
                                          "cache_hits")}
          for c, r in run.items()}
    assert [t[3] for t in run["deadline_single"]["tickets"]] \
        == ["deadline", "deadline"]
    assert by["deadline_single"]["flush_deadline"] == 2
    assert by["full_flush"]["flush_full"] == 1
    assert by["full_flush"]["flush_drain"] == 1
    assert run["full_flush"]["log"][0][2] == 3          # 3 still queued
    assert run["fill_only"]["log"][0][1:] == (0, 1, False)
    assert run["drain_barrier"]["log"] == [("queued", 17), ("drain", 17),
                                           ("again", 0)]
    (hit,) = run["cache_hit"]["tickets"]
    assert hit[3] == "hit" and hit[5] and hit[12] is not None
    mig = run["migration_mid_queue"]
    assert mig["log"][0][1]["epoch"] == mig["log"][0][2] == 1
    assert mig["log"][0][3] == 14 and mig["log"][1] == ("drain", 14)
    assert all(t[4] == 1 for t in mig["tickets"])
    lat = run["latency_per_bucket"]["latency"]
    assert lat["n"] == 11
    assert sum(b["n"] for b in lat["per_bucket"].values()) == 11
    assert set(lat["per_bucket"]) == set(run["latency_per_bucket"]["log"][1][1])
    gauges = {int(g["labels"]["shard"]): g["value"] for g in
              run["shard_load"]["snapshot"]["shard_requests"]["series"]}
    window = run["shard_load"]["log"][0]
    assert window[1] == 24 and run["shard_load"]["log"][1] == ("paused", 24)
    assert gauges == {sh: window[3].get(sh, 0) for sh in range(3)}
    for case in ("shutdown_no_grace", "shutdown_budget"):
        r = run[case]
        out = r["log"][1][1]
        shed = [t for t in r["tickets"] if t[11] is not None]
        assert {t[11] for t in shed} == {"ShutdownError"}
        assert all(t[12] is None and t[3] in ("shed", "drain")
                   for t in shed)
        assert out["shed"] == len(shed) == r["stats"]["shed"]
        before = r["log"][0]
        assert before[3] + out["drained"] + out["shed"] == len(r["tickets"])
        assert all(t[2] for t in r["tickets"])         # in flight completed
    assert run["shutdown_no_grace"]["log"][1][1]["drained"] == 0
    assert 0 < run["shutdown_budget"]["log"][1][1]["drained"]
    assert run["shutdown_budget"]["log"][1][1]["shed"] > 0


def test_serve_is_submit_plus_drain(world):
    """serve() returns what submit + drain deliver, through the pipeline
    counters (one drain flush per bucket touched)."""
    _, sides, _ = world
    s = sides["cuda"]
    srv = s.make(FakeClock(), trace=False, answer_cache=False)
    stream = s.mod.request_stream(s.qs, 14)
    res = srv.serve(stream)
    st = srv.stats
    assert st["flush_drain"] == len({srv.route[n][0] for n, _ in stream})
    assert st["served"] == 14 and srv.queue_depth() == srv.n_inflight == 0
    other = s.make(FakeClock(), trace=False, answer_cache=False)
    tickets = [other.submit(n, p, _pump=False) for n, p in stream]
    other.drain()
    assert [_result(r) for r in res] == [_result(t.result) for t in tickets]


@pytest.mark.parametrize("kw", ["mesh"])
def test_unported_layers_are_refused(world, kw):
    """The mesh is ported (tests/test_torch_serve_sharded.py); what the
    server refuses is a mesh that is not the port's own EngineMesh, such
    as the JAX package's."""
    _, sides, _ = world
    s = sides["torch"]
    with pytest.raises(TypeError, match="EngineMesh"):
        serve.WorkloadServer(s.qs, s.part, device="cpu", **{kw: object()})


def test_fetch_outputs_on_cpu_tensors_is_ready_without_an_event():
    out = (torch.arange(6, dtype=torch.int32).reshape(2, 3),
           torch.tensor([True, False]), torch.tensor([False, False]))
    fetch = fetch_outputs(out)
    assert fetch.event is None and fetch.ready()
    assert all(h is t for h, t in zip(fetch.host, out))
    table, tmask, overflow = fetch.wait()
    np.testing.assert_array_equal(table, out[0].numpy())
    assert tmask.dtype == np.bool_ and overflow.shape == (2,)


def test_shutdown_error_is_typed(world):
    _, sides, _ = world
    s = sides["torch"]
    srv = s.make(FakeClock(), trace=False, deadline_ms=None)
    t = srv.submit(s.qs[0].name)
    assert srv.shutdown(grace_s=0) == {"drained": 0, "shed": 1}
    assert isinstance(t.error, ShutdownError) and t.result is None


def test_cli_pipeline_on_the_cpu(capsys, tmp_path):
    trace, prom = tmp_path / "trace.json", tmp_path / "metrics.prom"
    serve.main(["--scale", "0.05", "--requests", "28", "--batch", "14",
                "--device", "cpu", "--pipeline", "--no-cache", "--check",
                "--arrival-ms", "0.5", "--trace-out", str(trace),
                "--metrics-out", str(prom)])
    out = capsys.readouterr().out
    assert "overflows=0" in out and "oracle: 28/28" in out
    assert "latency: p50=" in out and "queue_depth=0 inflight=0" in out
    assert trace.stat().st_size > 0
    assert "# TYPE served counter" in prom.read_text()
