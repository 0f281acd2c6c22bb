"""The port's observability copies against the JAX package's: the metrics
registry (snapshots, Prometheus text and its parser, snapshot_delta), the
trace recorder, the serving schema and Telemetry's invariant check give
equal output for the same calls; the server's ``dispatch/bucket{i}``
ranges reach ``torch.profiler`` when annotation is on."""
import json

import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the test workers running beside
# this one keep their cores
torch.set_num_threads(1)

from repro import obs as jobs  # noqa: E402

from repro_torch import obs  # noqa: E402
from repro_torch.core.partitioner import wawpart_partition  # noqa: E402
from repro_torch.kg import generator, workloads  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

PACKAGES = (jobs, obs)


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _registry_calls(m):
    """One script of registry calls; returns what it observed."""
    reg = m.MetricsRegistry()
    reg.counter("served", "requests answered", ("template",))
    reg.gauge("depth", "queued", ("b",))
    reg.histogram("lat_ms", "latency", (), buckets=(1.0, 5.0, 10.0))
    reg.gauge("epoch")
    reg["served"].inc(4, template="q1")
    reg["served"].inc(1, template='we"ird\nname')
    reg["depth"].set(5, b="0")
    reg["lat_ms"].observe(0.5)
    reg["lat_ms"].observe(3.0)
    reg["epoch"].set(2)
    old = reg.snapshot()
    reg["served"].inc(2, template="q1")
    reg["served"].inc(1, template="q2")         # new series: from zero
    reg["depth"].set(9, b="0")
    reg["lat_ms"].observe(100.0)
    reg["epoch"].set(float("inf"))
    new = reg.snapshot()
    text = reg.to_prometheus()
    out = {"old": old, "new": new, "text": text,
           "parsed": m.parse_prometheus(text),
           "delta": m.snapshot_delta(new, old), "json": reg.to_json(),
           "total": reg.total("served")}
    # a stale snapshot whose histogram layout changed counts from zero
    stale = json.loads(json.dumps(old))
    stale["lat_ms"] = {"kind": "histogram", "series": [
        {"labels": {}, "cumulative": [5], "sum": 1.0, "count": 5}]}
    out["stale_delta"] = m.snapshot_delta(new, stale)
    reg.reset()
    out["after_reset"] = reg.snapshot()
    errors = []
    for bad in (lambda: reg["served"].inc(),
                lambda: reg["served"].inc(template="q", shard="0"),
                lambda: reg["served"].inc(-1, template="q"),
                lambda: reg.gauge("served", "conflict")):
        with pytest.raises(m.MetricError) as exc:
            bad()
        errors.append(str(exc.value))
    out["errors"] = errors
    return out


def test_registry_copies_agree():
    want, got = (_registry_calls(m) for m in PACKAGES)
    assert got == want
    buckets = {s[0]["le"]: s[1] for s in got["parsed"]["lat_ms_bucket"]}
    assert buckets == {"1": 1.0, "5": 2.0, "10": 2.0, "+Inf": 3.0}
    by_t = {s["labels"]["template"]: s["value"]
            for s in got["delta"]["served"]["series"]}
    assert by_t == {"q1": 2, 'we"ird\nname': 0, "q2": 1}


@pytest.mark.parametrize("label", [
    "plain", 'quote" inside', "new\nline", "back\\slash",
    "back\\slash then n", r"\n", "\\\n", 'all \\ of " them\ntogether',
    "trailing\\"])
def test_prometheus_label_round_trip_agrees(label):
    texts = []
    for m in PACKAGES:
        reg = m.MetricsRegistry()
        reg.counter("served", "s", ("template",))
        reg["served"].inc(1, template=label)
        text = reg.to_prometheus()
        assert m.parse_prometheus(text)["served"] == [({"template": label},
                                                       1.0)]
        texts.append(text)
    assert texts[0] == texts[1]


def _trace_calls(m):
    clock = FakeClock()
    rec = m.TraceRecorder(clock, max_events=6)
    rec.async_begin("ticket/q", 7, args={"epoch": 0})
    clock.advance(0.001)
    with rec.span("flush/drain", tid="bucket0", args={"n": 2}):
        clock.advance(0.002)
    rec.complete("stage", 0.0015, 0.0025, tid="bucket0")
    rec.instant("migration", args={"epoch": 1})
    clock.advance(0.001)
    rec.async_end("ticket/q", 7)
    for _ in range(3):
        rec.instant("x")                        # past max_events: dropped
    off = m.TraceRecorder(clock, enabled=False)
    off.instant("x")
    return rec.to_chrome(), rec.dropped, len(off)


def test_trace_recorder_copies_agree():
    want, got = (_trace_calls(m) for m in PACKAGES)
    assert got == want
    chrome, dropped, n_off = got
    assert [e["ph"] for e in chrome["traceEvents"]][:2] == ["b", "X"]
    assert dropped == 2 and n_off == 0


def test_serving_schema_and_telemetry_copies_agree():
    assert obs.SERVING_SCHEMA == jobs.SERVING_SCHEMA
    assert obs.COUNTER_NAMES == jobs.COUNTER_NAMES
    snaps = []
    for m in PACKAGES:
        clock = FakeClock()
        tele = m.Telemetry(trace=True, clock=clock)
        tele.bind_clock(lambda: 99.0)           # a pinned clock stays
        tele.count("served", template="q")
        tele.count("executed", bucket="0")
        tele.gauge("queue_depth", 3, bucket="0")
        tele.observe("request_latency_ms", 12.5)
        tele.trace.instant("migration")
        old = tele.snapshot()
        tele.count("served", 2, template="q")
        tele.count("cache_hits", 2, template="q")
        snaps.append((tele.snapshot(), tele.delta_since(old),
                      tele.trace.to_chrome(), tele.total("served")))
        tele.check_invariants()
    assert snaps[0] == snaps[1]


@pytest.mark.parametrize("m", PACKAGES, ids=("jax", "torch"))
def test_check_invariants_fires_on_a_broken_counter(m):
    tele = m.Telemetry()
    tele.count("served", template="q")
    with pytest.raises(RuntimeError, match="served == cache_hits"):
        tele.check_invariants()
    tele.count("executed", bucket="0")
    tele.check_invariants()
    tele.count("timeouts", template="q")        # a timeout with no shed
    with pytest.raises(RuntimeError, match="every timeout is a shed"):
        tele.check_invariants()


@pytest.fixture(scope="module")
def small_server_parts():
    st = generator.generate_lubm(1, scale=0.05, seed=0)
    qs = workloads.lubm_queries()
    return qs, wawpart_partition(st, qs, n_shards=3)


@pytest.mark.parametrize("annotate", [True, False])
def test_annotation_reaches_torch_profiler(small_server_parts, annotate):
    qs, part = small_server_parts
    srv = serve.WorkloadServer(qs, part, device="cpu",
                               telemetry=obs.Telemetry(annotate=annotate))
    stream = serve.request_stream(qs, 14)
    srv.warmup(stream)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        srv.serve(stream)
    keys = {e.key for e in prof.key_averages()}
    ranges = {k for k in keys if k.startswith("dispatch/bucket")}
    if annotate:
        assert ranges == {f"dispatch/bucket{i}"
                          for i in range(srv.n_buckets)}
    else:
        assert not ranges


def test_reset_stats_keeps_state_gauges(small_server_parts):
    qs, part = small_server_parts
    srv = serve.WorkloadServer(qs, part, device="cpu",
                               telemetry=obs.Telemetry(trace=True))
    srv.serve(serve.request_stream(qs, 4))
    assert srv.stats["served"] == 4 and len(srv.telemetry.trace) > 0
    srv.reset_stats()
    assert all(v == 0 for v in srv.stats.values())
    assert len(srv.telemetry.trace) == 0 and srv.latency_stats()["n"] == 0
    gauges = srv.telemetry.registry["cut_collectives"]
    assert [gauges.get(bucket=str(bi)) for bi in range(srv.n_buckets)] \
        == [float(c) for c in srv.collective_counts()]
    srv.drain()
