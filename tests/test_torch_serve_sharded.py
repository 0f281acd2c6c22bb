"""The port's mesh-routed server (rank 0 serves, the other gloo ranks run
`serve_worker`, one process a shard, on the CPU) against the JAX
package's single-device server on the same stream: the server-level
counterpart of tests/test_batch_sharded.py's SCRIPT_SERVER,
SCRIPT_MIGRATE, SCRIPT_REPLICATE, SCRIPT_PIPELINE and SCRIPT_FAULTS at
LUBM 0.08 under WawPart (3 shards).

Each scenario runs once in the test process through the JAX server (its
vmap path; ``_ReadyServer`` waits for each dispatch, so its pump() retires
what the port's does) and once on rank 0 of one 3-rank mesh per port
backend, and everything the JAX script asserts is asserted against the
JAX run: every answer bit for bit, the FakeClock stamps, the counters,
the reports of migrate / replicate_hot / mark_shard_down, the telemetry
snapshot and trace. On the mesh the counted gathers of each dispatch
equal the bucket's `cut_collectives` gauge on every rank, and drop after
`replicate_hot()` as its `collectives_after` says. Also: a rank that dies
fails rank 0 within the group's timeout, `record_engine_costs`, and the
CLI's ``--sharded``.

The ranks import this module to find their functions, so JAX is imported
only in the fixtures that run the reference.
"""
import json
import os
import subprocess
import sys
import time
import types
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the test workers running beside
# this one keep their cores
torch.set_num_threads(1)

from repro_torch import faults as p_faults  # noqa: E402
from repro_torch.adaptive.repartition import \
    incremental_repartition  # noqa: E402
from repro_torch.core.partitioner import wawpart_partition  # noqa: E402
from repro_torch.engine.batch import (EngineCache,  # noqa: E402
                                      bucket_collectives, engine_cost)
from repro_torch.kg import generator, workloads  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.launch.mesh import SpawnError, spawn  # noqa: E402
from repro_torch.obs import Telemetry  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
SCALE = 0.08
SHARDS = 3
BACKENDS = ("torch", "cuda")
GROUP_TIMEOUT = 60.0      # seconds a collective may wait for a rank
JOIN_TIMEOUT = 400.0      # seconds a spawn's processes get in all
STREAM = 32               # requests of SCRIPT_SERVER / MIGRATE / REPLICATE
PIPE_N = 20               # SCRIPT_PIPELINE's submits, and its trace run's 8
TRACE_N = 8
FAULT_STREAM = 28


class FakeClock:
    """Deterministic monotonic clock the scenarios advance by hand."""

    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


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


def _gathers(side, before):
    """Gathers the mesh counted since ``before`` (None off the mesh)."""
    return None if side.mesh is None else side.mesh.collectives - before


def _count(side):
    return 0 if side.mesh is None else side.mesh.collectives


# ---------------------------------------------------------------------------
# the scenarios, run by both packages' servers (``side``: one package's
# server factory, placements and fault types)
# ---------------------------------------------------------------------------

def scenario_server(side):
    """SCRIPT_SERVER: a round-robin stream of 32 requests, dedup on."""
    srv = side.make(side.part)
    c0 = _count(side)
    res = srv.serve(side.stream)
    return {"results": [_result(r) for r in res], "stats": srv.stats,
            "cuts": srv.collective_counts(), "gathers": _gathers(side, c0)}


def scenario_migrate(side):
    """SCRIPT_MIGRATE: migrate() to an incremental repartition, then the
    answers of a server built on the new placement."""
    srv = side.make(side.part)
    before = srv.serve(side.stream)
    rep = srv.migrate(side.res.part)
    after = srv.serve(side.stream)
    fresh = side.make(side.res.part).serve(side.stream)
    return {"mode": side.res.mode, "moved": side.res.moved_triples,
            "report": rep, "epoch": srv.epoch,
            "before": [_result(r) for r in before],
            "after": [_result(r) for r in after],
            "fresh": [_result(r) for r in fresh], "stats": srv.stats}


def scenario_replicate(side):
    """SCRIPT_REPLICATE: replicate_hot() between two serves; the gathers
    each serve counts on the mesh."""
    srv = side.make(side.part)
    c0 = _count(side)
    before = srv.serve(side.stream)
    g_before = _gathers(side, c0)
    rep = srv.replicate_hot()
    c1 = _count(side)
    after = srv.serve(side.stream)
    return {"report": rep, "epoch": srv.epoch,
            "before": [_result(r) for r in before],
            "after": [_result(r) for r in after], "stats": srv.stats,
            "gathers": (g_before, _gathers(side, c1))}


def scenario_pipeline(side):
    """SCRIPT_PIPELINE's deadline-flushed partial buckets under a
    FakeClock, then its traced run with the telemetry gauges; on the
    mesh, one request per bucket after it, each dispatch's gathers."""
    out = {}
    clock = FakeClock()
    srv = side.make(side.part, clock=clock, trace=False, deadline_ms=1.0,
                    max_batch=64, answer_cache=False)
    tickets = []
    for name, pv in side.stream[:PIPE_N]:
        tickets.append(srv.submit(name, pv))
        clock.t += 0.002
        srv.pump()
    srv.drain()
    out["deadline"] = {"tickets": [_ticket(t) for t in tickets],
                       "stats": srv.stats, "latency": srv.latency_stats(),
                       "depth": srv.queue_depth(),
                       "inflight": srv.n_inflight}
    clock = FakeClock()
    srv = side.make(side.part, clock=clock, trace=True, deadline_ms=1.0,
                    max_batch=64, answer_cache=False)
    tickets = []
    for name, pv in side.stream[:TRACE_N]:
        tickets.append(srv.submit(name, pv))
        clock.t += 0.002
        srv.pump()
    srv.drain()
    snap = srv.tracker.snapshot()
    tele = srv.telemetry
    out["traced"] = {
        "tickets": [_ticket(t) for t in tickets],
        "snapshot": tele.snapshot(),
        "trace": tele.trace.to_chrome()["traceEvents"],
        "shard_load": dict(snap.shard_load), "total": snap.total,
        "imbalance": tele.registry["shard_load_imbalance"].get(),
        "gauges": [tele.registry["cut_collectives"].get(bucket=str(bi))
                   for bi in range(len(srv.buckets))],
        "cuts": [bucket_collectives(b.signature) for b in srv.buckets]}
    if side.mesh is not None:
        probes = []
        for b in srv.buckets:
            c0 = side.mesh.collectives
            srv.submit(b.plans[0].query.name, None, _pump=False)
            srv.drain()
            probes.append(side.mesh.collectives - c0)
        out["probes"] = probes
    return out


def scenario_faults(side):
    """SCRIPT_FAULTS: chaos with retry on a replicated placement, the
    degraded window, migrate refused while degraded, restore, and an
    injected abort mid-prepare."""
    F = side.faults
    stream = side.stream[:FAULT_STREAM]
    out = {}
    sm = side.make(side.part, answer_cache=False)
    out["replicate"] = sm.replicate_hot()
    out["healthy"] = [_result(r) for r in sm.serve(stream)]
    chaos = side.make(sm.part, answer_cache=False, cache=sm.cache,
                      faults=F.FaultPlan(seed=2, dispatch_fail_rate=0.4),
                      retry=F.RetryPolicy(max_attempts=8))
    out["chaos"] = [_result(r) for r in chaos.serve(stream)]
    out["chaos_stats"] = chaos.stats
    out["injected"] = dict(chaos.faults.injected)
    out["down"] = sm.mark_shard_down(1)
    tickets = [sm.submit(n, p, _pump=False) for n, p in stream]
    sm.drain()
    out["degraded"] = [(type(t.error).__name__ if t.error else None,
                        _result(t.result)) for t in tickets]
    out["degraded_stats"] = sm.stats
    try:
        sm.migrate(sm.part)
        out["refused"] = None
    except F.MigrationAbortedError as exc:
        out["refused"] = str(exc)
    out["up"] = sm.mark_shard_up()
    out["restored"] = [_result(r) for r in sm.serve(stream)]
    mg = side.make(side.part, answer_cache=False, cache=sm.cache,
                   faults=F.FaultPlan(abort_migrations=1))
    queued = [mg.submit(n, p, _pump=False) for n, p in stream]
    try:
        mg.migrate(side.res.part)
        out["aborted"] = None
    except F.MigrationAbortedError as exc:
        out["aborted"] = type(exc).__name__
    out["abort_epoch"] = mg.epoch
    out["abort_stats"] = dict(mg.stats)
    out["depth"] = mg.queue_depth()
    mg.drain()
    out["queued"] = [(type(t.error).__name__ if t.error else None,
                      _result(t.result)) for t in queued]
    out["migrate"] = mg.migrate(side.res.part)
    out["migrated"] = [_result(r) for r in mg.serve(stream)]
    out["final_stats"] = mg.stats
    return out


SCENARIOS = {"server": scenario_server, "migrate": scenario_migrate,
             "replicate": scenario_replicate, "pipeline": scenario_pipeline,
             "faults": scenario_faults}


def _world(pkg_gen, pkg_work, wawpart, repartition, two_phase):
    st = pkg_gen.generate_lubm(1, scale=SCALE, seed=0)
    qs = pkg_work.lubm_queries()
    part = wawpart(st, qs, n_shards=SHARDS)
    res = repartition(part, qs, two_phase(qs)[1], budget_frac=0.15)
    return st, qs, part, res


def _port_side(mesh, backend):
    st, qs, part, res = _world(generator, workloads, wawpart_partition,
                               incremental_repartition,
                               serve.two_phase_weights)
    cache = EngineCache()

    def make(part, clock=None, trace=False, cache=cache, **kw):
        pipe = {k: kw.pop(k) for k in ("deadline_ms", "max_batch")
                if k in kw}
        if clock is not None:
            pipe["clock"] = clock
        return serve.WorkloadServer(
            qs, part, cache=cache, backend=backend, mesh=mesh,
            telemetry=Telemetry(trace=trace),
            pipeline=serve.PipelineConfig(**pipe), **kw)

    return types.SimpleNamespace(
        make=make, part=part, res=res, faults=p_faults, mesh=mesh,
        stream=serve.request_stream(qs, STREAM))


def _rank_serve(mesh):
    """Rank 0 runs every scenario per backend on the mesh's server; the
    other ranks work until it stops them."""
    if mesh.rank:
        return serve.serve_worker(mesh)
    try:
        out = {}
        for backend in BACKENDS:
            side = _port_side(mesh, backend)
            out[backend] = {name: run(side) for name, run in
                            SCENARIOS.items()}
            srv = side.make(side.part)
            out[backend]["costs"] = srv.record_engine_costs()
            out[backend]["gauges"] = (
                [srv.telemetry.registry["engine_flops"].get(bucket=str(b))
                 for b in range(srv.n_buckets)],
                [srv.telemetry.registry["engine_bytes"].get(bucket=str(b))
                 for b in range(srv.n_buckets)])
            out[backend]["cap"] = srv.kg.cap
            out[backend]["sigs"] = [b.signature for b in srv.buckets]
        out["collectives"] = mesh.collectives
        out["gathered_bytes"] = mesh.gathered_bytes
        return out
    finally:
        serve.stop_workers(mesh)


def _rank_dies(mesh):
    """Rank 2 exits once the group is up; rank 0's first dispatch must
    fail, well within the group's timeout."""
    import torch.distributed as dist
    dist.barrier()
    if mesh.rank == 2:
        os._exit(3)
    if mesh.rank == 1:
        return serve.serve_worker(mesh)
    side = _port_side(mesh, "cuda")
    srv = side.make(side.part)
    t0 = time.monotonic()
    try:
        srv.serve(side.stream)
    except RuntimeError as exc:
        return ("error", type(exc).__name__, str(exc),
                time.monotonic() - t0)
    return ("served", None, None, time.monotonic() - t0)


def _rank_fails_once(mesh):
    """Rank 0's shard raises once, after the dispatch went out, under a
    RetryPolicy: the mesh is out of step, so the failed attempt breaks it
    and every retry raises at once; the tickets resolve typed, and rank 0
    returns without waiting on the other ranks."""
    if mesh.rank:
        return serve.serve_worker(mesh)
    side = _port_side(mesh, "cuda")
    srv = side.make(side.part, answer_cache=False,
                    retry=p_faults.RetryPolicy(max_attempts=3))
    dispatch, failed = srv._mesh_dispatch, []

    def failing_once(local, bucket, st):
        def shard(*args):
            if not failed:
                failed.append(bucket.signature)
                raise RuntimeError("rank 0's shard failed")
            return local(*args)
        return dispatch(shard, bucket, st)

    srv._mesh_dispatch = failing_once
    t0 = time.monotonic()
    tickets = [srv.submit(n, p, _pump=False) for n, p in side.stream]
    srv.drain()
    elapsed = time.monotonic() - t0
    serve.stop_workers(mesh)
    return ([type(t.error).__name__ for t in tickets], srv.stats,
            mesh.broken, mesh.closed, elapsed)


# ---------------------------------------------------------------------------
# fixtures
# ---------------------------------------------------------------------------

def _jax_runs():
    """Every scenario through the JAX server's vmap path."""
    import jax

    from repro import faults as j_faults
    from repro.adaptive.repartition import incremental_repartition as j_inc
    from repro.core.partitioner import wawpart_partition as j_wawpart
    from repro.engine.batch import EngineCache as JEngineCache
    from repro.kg import generator as j_gen
    from repro.kg import workloads as j_work
    from repro.launch import serve as jserve
    from repro.obs import Telemetry as JTelemetry

    class ReadyServer(jserve.WorkloadServer):
        """The JAX server, waiting for each dispatch before it goes on."""

        def _flush(self, *args, **kwargs):
            super()._flush(*args, **kwargs)
            if self._inflight:
                jax.block_until_ready(self._inflight[-1].out)

    st, qs, part, res = _world(j_gen, j_work, j_wawpart, j_inc,
                               jserve.two_phase_weights)
    jcache = JEngineCache()

    def make(part, clock=None, trace=False, cache=jcache, **kw):
        pipe = {k: kw.pop(k) for k in ("deadline_ms", "max_batch")
                if k in kw}
        if clock is not None:
            pipe["clock"] = clock
        return ReadyServer(qs, part, cache=cache,
                           telemetry=JTelemetry(trace=trace),
                           pipeline=jserve.PipelineConfig(**pipe), **kw)

    side = types.SimpleNamespace(
        make=make, part=part, res=res, faults=j_faults, mesh=None,
        stream=jserve.request_stream(qs, STREAM))
    return {name: run(side) for name, run in SCENARIOS.items()}


@pytest.fixture(scope="module")
def runs():
    """Every scenario on rank 0 of one 3-rank mesh (both backends) with
    the workers' summaries, and through the JAX server: the ranks run
    while the test process runs the JAX side (a thread waits on them)."""
    with ThreadPoolExecutor(1) as pool:
        mesh = pool.submit(spawn, SHARDS, _rank_serve, device="cpu",
                           timeout=GROUP_TIMEOUT, join_timeout=JOIN_TIMEOUT)
        jax_side = _jax_runs()
        return mesh.result(), jax_side


@pytest.fixture(scope="module")
def mesh_runs(runs):
    return runs[0]


@pytest.fixture(scope="module")
def jax_runs(runs):
    return runs[1]


@pytest.fixture(scope="module")
def oracle():
    from repro_torch.engine.oracle import evaluate_bgp
    st = generator.generate_lubm(1, scale=SCALE, seed=0)
    qs = workloads.lubm_queries()
    return {q.name: _result((evaluate_bgp(st, q), 0, False))[:3] for q in qs}


def _stream_names():
    return [n for n, _ in serve.request_stream(workloads.lubm_queries(),
                                               STREAM)]


# ---------------------------------------------------------------------------
# the scenarios against the JAX server
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_mesh_server_equals_the_jax_server(mesh_runs, jax_runs, oracle,
                                           backend):
    got, want = mesh_runs[0][backend]["server"], jax_runs["server"]
    assert got["results"] == want["results"]
    assert got["stats"] == want["stats"]
    assert got["stats"]["executed"] == 14 and got["stats"]["served"] == 32
    assert got["cuts"] == want["cuts"] and any(c > 0 for c in got["cuts"])
    assert got["gathers"] == sum(got["cuts"])     # one dispatch a bucket
    for name, res in zip(_stream_names(), got["results"]):
        assert res[:3] == oracle[name] and not res[4], name


@pytest.mark.parametrize("backend", BACKENDS)
def test_mesh_migrate_equals_the_jax_server(mesh_runs, jax_runs, backend):
    got, want = mesh_runs[0][backend]["migrate"], jax_runs["migrate"]
    assert got["mode"] == want["mode"] == "incremental"
    assert got["moved"] == want["moved"]
    assert got["report"] == want["report"]
    assert got["report"]["n_moved"] == got["moved"]
    assert got["epoch"] == 1
    for key in ("before", "after", "fresh", "stats"):
        assert got[key] == want[key], key
    assert got["after"] == got["fresh"] == got["before"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_mesh_replicate_drops_the_counted_gathers(mesh_runs, jax_runs,
                                                  backend):
    got, want = mesh_runs[0][backend]["replicate"], jax_runs["replicate"]
    assert got["report"] == want["report"]
    rep = got["report"]
    assert got["epoch"] == 1 and rep["replicated_triples"] > 0
    assert sum(rep["collectives_after"]) < sum(rep["collectives_before"])
    assert got["gathers"] == (sum(rep["collectives_before"]),
                              sum(rep["collectives_after"]))
    assert got["before"] == got["after"] == want["before"] == want["after"]
    assert got["stats"] == want["stats"]


@pytest.mark.parametrize("backend", BACKENDS)
def test_mesh_pipeline_stamps_equal_the_jax_server(mesh_runs, jax_runs,
                                                   backend):
    got = mesh_runs[0][backend]["pipeline"]["deadline"]
    want = jax_runs["pipeline"]["deadline"]
    assert got == want
    assert got["stats"]["flush_deadline"] > 0
    assert got["depth"] == 0 and got["inflight"] == 0
    assert all(t[2] for t in got["tickets"])
    assert got["latency"]["n"] == PIPE_N and got["latency"]["p99_ms"] > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_mesh_telemetry_equals_the_jax_server(mesh_runs, jax_runs, backend):
    got = mesh_runs[0][backend]["pipeline"]["traced"]
    want = jax_runs["pipeline"]["traced"]
    assert got == want
    evs = got["trace"]
    begins = {e["id"] for e in evs if e["ph"] == "b"}
    ends = {e["id"] for e in evs if e["ph"] == "e"}
    assert begins == ends == {t[1] for t in got["tickets"]}
    assert got["gauges"] == [float(c) for c in got["cuts"]]
    assert got["total"] == TRACE_N


@pytest.mark.parametrize("backend", BACKENDS)
def test_counted_gathers_equal_the_cut_collectives_gauges(mesh_runs,
                                                          backend):
    run = mesh_runs[0][backend]["pipeline"]
    assert run["probes"] == run["traced"]["cuts"] == [
        int(g) for g in run["traced"]["gauges"]]
    assert sum(run["probes"]) > 0


def test_every_rank_counted_the_same_gathers(mesh_runs):
    rank0, workers = mesh_runs[0], mesh_runs[1:]
    assert workers[0] == workers[1]
    assert sum(workers[0]["collectives"]) == rank0["collectives"] > 0
    assert workers[0]["gathered_bytes"] == rank0["gathered_bytes"] > 0
    # a state is sent once, before the first dispatch that reads it
    assert workers[0]["dispatches"] > workers[0]["states"] > 0


@pytest.mark.parametrize("backend", BACKENDS)
def test_mesh_faults_equal_the_jax_server(mesh_runs, jax_runs, oracle,
                                          backend):
    got, want = mesh_runs[0][backend]["faults"], jax_runs["faults"]
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == want[key], key
    assert got["healthy"] == got["chaos"] == got["restored"] \
        == got["migrated"]
    assert got["injected"]["dispatch"] > 0
    assert got["chaos_stats"]["retries"] > 0
    assert got["chaos_stats"]["shed"] == 0
    shed = set(got["down"]["shed_templates"])
    names = _stream_names()[:FAULT_STREAM]
    for name, (err, res), ok in zip(names, got["degraded"], got["healthy"]):
        if name in shed:
            assert err == "ShardDownError" and res is None
        else:
            assert err is None and res == ok, name
    stats = got["degraded_stats"]
    assert stats["shard_down"] == 1
    assert stats["served"] == (stats["cache_hits"] + stats["executed"]
                               + stats["deduped"] + stats["shed"])
    assert got["refused"] is not None
    assert got["aborted"] == "MigrationAbortedError"
    assert got["abort_epoch"] == 0
    assert got["abort_stats"]["migration_aborts"] == 1
    assert got["depth"] == FAULT_STREAM
    assert [r for _, r in got["queued"]] == got["healthy"]
    assert got["migrate"]["epoch"] == 1
    for name, res in zip(names, got["healthy"]):
        assert res[:3] == oracle[name], name


# ---------------------------------------------------------------------------
# record_engine_costs
# ---------------------------------------------------------------------------

def test_record_engine_costs_on_one_device_and_on_the_mesh(mesh_runs):
    st = generator.generate_lubm(1, scale=SCALE, seed=0)
    qs = workloads.lubm_queries()
    part = wawpart_partition(st, qs, n_shards=SHARDS)
    srv = serve.WorkloadServer(qs, part, device="cpu")
    costs = srv.record_engine_costs()
    assert list(costs) == ["flops", "bytes"]
    assert len(costs["flops"]) == len(costs["bytes"]) == srv.n_buckets
    reg = srv.telemetry.registry
    assert [reg["engine_flops"].get(bucket=str(b))
            for b in range(srv.n_buckets)] == costs["flops"]
    assert [reg["engine_bytes"].get(bucket=str(b))
            for b in range(srv.n_buckets)] == costs["bytes"]
    assert all(f > 0 for f in costs["flops"])
    for backend in BACKENDS:
        run = mesh_runs[0][backend]
        assert run["gauges"] == (run["costs"]["flops"],
                                 run["costs"]["bytes"])
        assert run["cap"] == srv.kg.cap
        assert run["costs"]["flops"] == costs["flops"]
        for b, sig, mb, one in zip(srv.buckets, run["sigs"],
                                   run["costs"]["bytes"], costs["bytes"]):
            assert sig == b.signature
            gathered = sum(SHARDS * 1 * SHARDS * min(c, srv.kg.cap) * 16
                           for c, g in zip(sig.scan_caps, sig.gather_bits)
                           if g)
            assert mb == one + gathered


def test_engine_cost_of_a_single_step_bucket_by_hand():
    """One cut step of one pattern on 2 shards, counted by hand from
    engine_cost's docstring: the first step's scan and its compaction of
    the 2 shards' matches straight into the table."""
    from repro_torch.engine.batch import BucketSignature
    sig = BucketSignature(
        n_shards=2, n_steps=1, n_vars=2, table_cap=16, scan_caps=(8,),
        fanout_caps=(8,), verify_masks=((False, False, False),),
        gather_bits=(True,), sorted_bits=(False,), eq_bits=(False,),
        param_bits=(False,), noop_bits=(False,), new_modes=("all",))
    # 2 instances (1 request x 2 shards), N = 64 rows a block, C = 8
    outputs = 2 * (4 * 16 * 2 + 16 + 1)          # table, mask, overflow
    scan = 2 * 13 * 64 + 2 * 12 + 2 * (5 * 8 + 4)
    seed = 2 * (16 + 5 * 16 + 4)                 # 2 x 8 candidates
    assert engine_cost(sig, 64) == {
        "flops": 2 * 64 * 3 + 2 * 16, "bytes": outputs + scan + seed}

    class Mesh:
        size = 2
    gathered = 2 * 1 * 2 * 8 * 16                # each rank gets 2 x 8 rows
    assert engine_cost(sig, 64, mesh=Mesh()) == {
        "flops": 2 * 64 * 3 + 2 * 16,
        "bytes": outputs + scan + seed + gathered}


# ---------------------------------------------------------------------------
# failures, validation, the CLI
# ---------------------------------------------------------------------------

def test_a_rank_that_dies_fails_rank_0_within_the_group_timeout():
    timeout = 30.0
    with pytest.raises(SpawnError) as err:
        spawn(SHARDS, _rank_dies, device="cpu", timeout=timeout,
              join_timeout=JOIN_TIMEOUT)
    status, kind, msg, elapsed = err.value.results[0]
    assert status == "error" and kind == "RuntimeError", msg
    assert elapsed < timeout
    assert err.value.errors[0] is None          # rank 0 returned its report
    assert err.value.errors[2] is not None      # rank 2's exit is reported


def test_an_error_in_rank_0s_shard_breaks_the_mesh_at_once():
    timeout = 30.0
    with pytest.raises(SpawnError) as err:
        spawn(SHARDS, _rank_fails_once, device="cpu", timeout=timeout,
              join_timeout=JOIN_TIMEOUT)
    errors, stats, broken, closed, elapsed = err.value.results[0]
    assert err.value.errors[0] is None          # rank 0 returned its report
    assert set(errors) == {"RetryExhaustedError"}, errors
    assert stats["shed"] == stats["served"] == len(errors)
    assert "out of step since RuntimeError: rank 0's shard failed" in broken
    assert closed and elapsed < timeout
    # the other ranks were left in a collective rank 0 never joined
    assert all(e is not None for e in err.value.errors[1:])


def test_the_server_runs_on_rank_0_only():
    from repro_torch.launch.mesh import EngineMesh
    st = generator.generate_lubm(1, scale=0.05, seed=0)
    qs = workloads.lubm_queries()
    part = wawpart_partition(st, qs, n_shards=SHARDS)
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="rank 0 of its mesh"):
        serve.WorkloadServer(qs, part, mesh=EngineMesh(SHARDS, 1, cpu))
    with pytest.raises(ValueError, match="one device per shard"):
        serve.WorkloadServer(qs, part, mesh=EngineMesh(2, 0, cpu))
    with pytest.raises(ValueError, match="the other ranks"):
        serve.serve_worker(EngineMesh(SHARDS, 0, cpu))
    one = EngineMesh(1, 0, cpu)
    serve.stop_workers(one)
    assert one.closed


def test_cli_sharded_runs_on_the_cpu(tmp_path):
    metrics = tmp_path / "metrics.json"
    env = {**os.environ, "PYTHONPATH": str(REPO / "src")}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--sharded", "--scale", "0.05", "--requests", "28", "--batch", "14",
         "--no-cache", "--check", "--metrics-out", str(metrics),
         "--dist-timeout", "60"],
        env=env, capture_output=True, text=True, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-2000:]
    assert "torch.distributed mesh {'shards': 3} (gloo, 3 ranks" \
        in out.stdout, out.stdout
    assert "oracle: 28/28 answers equal evaluate_bgp" in out.stdout
    assert "mesh cut gathers on rank 0:" in out.stdout
    snap = json.loads(metrics.read_text())
    assert "engine_flops" in json.dumps(snap)
    bad = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--sharded", "--dist-backend", "nccl"],
        env=env, capture_output=True, text=True, timeout=120, cwd=REPO)
    assert bad.returncode == 2 and "one CUDA card per rank" in bad.stderr
