"""The port's WorkloadServer against the JAX package's on one request
stream: identical results and identical counters, every member of
`Counter` (served / executed / deduped / cache_hits / cache_misses, the
flush reasons and the fault-layer counters), with the answer cache and
dedup on and off, and warmup bypassing the cache."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the test workers running beside
# this one keep their cores
torch.set_num_threads(1)

from repro.core.partitioner import wawpart_partition as j_wawpart  # noqa: E402
from repro.engine.batch import EngineCache as JEngineCache  # noqa: E402
from repro.kg import generator as j_gen  # noqa: E402
from repro.kg import workloads as j_work  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402

from repro_torch.core.partitioner import wawpart_partition  # noqa: E402
from repro_torch.engine.oracle import evaluate_bgp  # noqa: E402
from repro_torch.kg import generator, workloads  # noqa: E402
from repro_torch.launch import serve  # noqa: E402

COUNTERS = tuple(c.value for c in serve.Counter)


@pytest.fixture(scope="module")
def served():
    st = generator.generate_lubm(1, scale=0.05, seed=0)
    jst = j_gen.generate_lubm(1, scale=0.05, seed=0)
    qs, jqs = workloads.lubm_queries(), j_work.lubm_queries()
    part = wawpart_partition(st, qs, n_shards=3)
    jpart = j_wawpart(jst, jqs, n_shards=3)
    # skewed, seeded traffic: repeats inside a batch (dedup) and across
    # batches (answer cache)
    weights = {q.name: float(i % 4 + 1) for i, q in enumerate(qs)}
    stream = serve.request_stream(qs, 64, weights=weights, seed=7)
    assert stream == jserve.request_stream(jqs, 64, weights=weights, seed=7)
    return st, qs, part, jqs, jpart, stream, JEngineCache()


def test_counter_members_match_the_jax_server():
    assert COUNTERS == tuple(c.value for c in jserve.Counter)
    assert len(COUNTERS) == 15


def _counters(srv):
    return {k: srv.stats[k] for k in COUNTERS}


def _serve_all(srv, stream, batch=16):
    out = []
    for i in range(0, len(stream), batch):
        out += srv.serve(stream[i:i + batch])
    return out


def _same(res, ref):
    assert len(res) == len(ref)
    for (rows, n, ovf), (jrows, jn, jovf) in zip(res, ref):
        assert n == jn and ovf == jovf
        np.testing.assert_array_equal(rows, np.asarray(jrows))


@pytest.mark.parametrize("cache,dedup", [(True, True), (False, True)])
def test_results_and_counters_match_the_jax_server(served, cache, dedup):
    st, qs, part, jqs, jpart, stream, jcache = served
    srv = serve.WorkloadServer(qs, part, answer_cache=cache, dedup=dedup,
                               device="cpu")
    jsrv = jserve.WorkloadServer(jqs, jpart, answer_cache=cache, dedup=dedup,
                                 cache=jcache)
    res, ref = _serve_all(srv, stream), _serve_all(jsrv, stream)
    _same(res, ref)
    assert _counters(srv) == {k: jsrv.stats[k] for k in COUNTERS}
    s = srv.stats
    assert s["served"] == len(stream) == \
        s["cache_hits"] + s["executed"] + s["deduped"]
    if cache:
        assert s["cache_hits"] > 0
    if dedup:
        assert s["deduped"] > 0
    for (name, _), (rows, _, ovf) in zip(stream, res):
        q = next(q for q in qs if q.name == name)
        assert not ovf
        np.testing.assert_array_equal(rows, evaluate_bgp(st, q))


def test_warmup_bypasses_the_cache_and_reset_stats(served):
    _, qs, part, jqs, jpart, stream, jcache = served
    srv = serve.WorkloadServer(qs, part, backend="torch", device="cpu")
    jsrv = jserve.WorkloadServer(jqs, jpart, cache=jcache)
    for s in (srv, jsrv):
        s.warmup(stream[:8])
        assert s.stats["cache_hits"] == s.stats["cache_misses"] == 0
        s.reset_stats()
        assert all(v == 0 for v in s.stats.values())
        s.serve(stream[:8])
        assert s.stats["cache_hits"] == 0            # warmup filled nothing
        s.warmup(stream[:8])
        assert s.stats["cache_hits"] == 0            # and reads nothing
        s.serve(stream[:8])
    assert _counters(srv) == {k: jsrv.stats[k] for k in COUNTERS}
    assert srv.stats["cache_hits"] == 8
    assert srv.n_compiles <= srv.n_buckets
    assert srv.collective_counts() == jsrv.collective_counts()


def test_lru_capacity_and_errors(served):
    _, qs, part, *_ = served
    srv = serve.WorkloadServer(qs, part, answer_cache=2, device="cpu")
    stream = [(qs[i].name, None) for i in range(4)]
    srv.serve(stream)
    assert len(srv._answers) == 2              # LRU evicted the older half
    srv.serve([stream[3]])
    assert srv.stats["cache_hits"] == 1
    srv.serve([stream[0]])                     # evicted: must re-miss
    assert srv.stats["cache_misses"] == 5
    with pytest.raises(KeyError):
        srv.serve([("NOPE", None)])
    with pytest.raises(ValueError, match="n_params"):
        srv.serve([(qs[0].name, np.asarray([1, 2], np.int32))])
    with pytest.raises(ValueError, match="backend"):
        serve.WorkloadServer(qs, part, backend="pallas", device="cpu")


def test_cli_on_the_cpu(capsys):
    serve.main(["--dataset", "lubm", "--scale", "0.05", "--requests", "28",
                "--batch", "14", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "overflows=0" in out and "answer cache: 14/28 hits" in out
    assert "backend=cuda, device=cpu" in out
    serve.main(["--scale", "0.05", "--requests", "14", "--batch", "14",
                "--device", "cpu", "--no-cache", "--no-dedup",
                "--backend", "torch", "--join", "expand"])
    out = capsys.readouterr().out
    assert "overflows=0" in out and "14/14 instances executed" in out


def _event(action, addr, size, where=None):
    frames = [{"filename": "/usr/lib/python3/site-packages/torch/x.py",
               "line": 3, "name": "empty"}]
    if where is not None:
        frames.append({"filename": f"/tree/src/repro_torch/{where}",
                       "line": 7, "name": "f"})
    return {"action": action, "addr": addr, "size": size, "frames": frames}


def test_peak_blocks_replays_allocator_events():
    """--memory-peak's replay: the peak after the loop's first event, at
    "free_requested" (a block whose free waits on a stream is no longer
    allocated), with the live blocks grouped by their repro_torch line."""
    events = [_event("alloc", 1, 1000, "engine/batch.py"),       # before
              _event("free_requested", 1, 1000),
              _event("alloc", 2, 300, "engine/batch.py"),        # first = 2
              _event("alloc", 3, 200, "engine/batch.py"),
              _event("alloc", 4, 50),
              _event("free_requested", 2, 300),
              _event("free_completed", 2, 300),
              _event("alloc", 5, 400, "kernels/kg_join/kernel.py"),
              _event("free_requested", 5, 400)]
    peak, n_live, groups = serve.peak_blocks(events, 2)
    assert (peak, n_live) == (650, 3)
    assert groups == {"kernels/kg_join/kernel.py:7 f": [400, 1],
                      "engine/batch.py:7 f": [200, 1],
                      "(no repro_torch frame)": [50, 1]}
    assert serve.peak_blocks(events, 0)[:2] == (1000, 1)
    with pytest.raises(SystemExit):
        serve.main(["--scale", "0.05", "--device", "cpu", "--memory-peak"])
