"""The port's batched bucket engine against the JAX package's, bit for bit:
for every LUBM bucket at two scales and both join implementations, the
port's run_batched(device="cpu") on the reference's own shard blocks
(ShardedKG.from_arrays) gives the solutions, counts and overflow flags of
the reference's run_batched(backend="jnp") — on both port backends ("torch"
primitives, and the "cuda" composition whose kernel ops run their plain
versions on CPU tensors). Parameterized and deduped requests mirror
tests/test_engine_batch.py."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the test workers running beside
# this one keep their cores
torch.set_num_threads(1)

from repro.core.partitioner import wawpart_partition as j_wawpart  # noqa: E402
from repro.engine.batch import EngineCache as JEngineCache  # noqa: E402
from repro.engine.batch import bucket_plans as j_bucket_plans  # noqa: E402
from repro.engine.batch import run_batched as j_run_batched  # noqa: E402
from repro.engine.federated import ShardedKG as JShardedKG  # noqa: E402
from repro.engine.planner import make_plan as j_make_plan  # noqa: E402
from repro.kg import generator as j_gen  # noqa: E402
from repro.kg import workloads as j_work  # noqa: E402

from repro_torch.core.partitioner import wawpart_partition  # noqa: E402
from repro_torch.engine.batch import (EngineCache, assemble_batch,  # noqa: E402
                                      bucket_plans, canonical_params,
                                      dedup_requests, pad_requests_pow2,
                                      run_batched, shard_perms, stage_batch)
from repro_torch.engine.federated import (CapacityOverflowError,  # noqa: E402
                                          ShardedKG)
from repro_torch.engine.oracle import evaluate_bgp  # noqa: E402
from repro_torch.engine.planner import make_plan  # noqa: E402
from repro_torch.kg import generator, workloads  # noqa: E402
from repro_torch.kg.query import Query, TriplePattern as T, c, v  # noqa: E402

BACKENDS = ("torch", "cuda")


def _setup(scale):
    st = generator.generate_lubm(1, scale=scale, seed=0)
    jst = j_gen.generate_lubm(1, scale=scale, seed=0)
    qs, jqs = workloads.lubm_queries(), j_work.lubm_queries()
    part = wawpart_partition(st, qs, n_shards=3)
    jpart = j_wawpart(jst, jqs, n_shards=3)
    jkg = JShardedKG.build(jpart)
    kg = ShardedKG.from_arrays(np.asarray(jkg.triples), np.asarray(jkg.valid))
    return st, qs, part, kg, jqs, jpart, jkg


@pytest.fixture(scope="module", params=[0.05, 0.1])
def lubm_pair(request):
    return _setup(request.param)


@pytest.fixture(scope="module")
def lubm_01():
    return _setup(0.1)


def _same(res, ref):
    assert len(res) == len(ref)
    for (rows, n, ovf), (jrows, jn, jovf) in zip(res, ref):
        assert n == jn and ovf == jovf
        assert rows.dtype == np.int32
        np.testing.assert_array_equal(rows, np.asarray(jrows))


@pytest.mark.parametrize("impl", ["sorted", "expand"])
def test_every_bucket_matches_the_jax_engine(lubm_pair, impl):
    st, qs, part, kg, jqs, jpart, jkg = lubm_pair
    buckets = bucket_plans([make_plan(q, part) for q in qs])
    jbuckets = j_bucket_plans([j_make_plan(q, jpart) for q in jqs])
    assert len(buckets) == len(jbuckets) == 5
    perms = shard_perms(kg)
    jcache, cache = JEngineCache(), EngineCache()
    for b, jb in zip(buckets, jbuckets):
        ref = j_run_batched(jb, jkg, join_impl=impl, cache=jcache)
        for backend in BACKENDS:
            res = run_batched(b, kg, join_impl=impl, cache=cache,
                              perms=perms, backend=backend, device="cpu")
            _same(res, ref)
        for (rows, _, ovf), plan in zip(res, b.plans):
            assert not ovf, plan.query.name
            np.testing.assert_array_equal(rows, evaluate_bgp(st, plan.query))
    assert cache.misses == 2 * len(buckets)          # one per backend


def _q13_bucket(part, store, params, j=False):
    """LUBM-Q13 (alumni of <uni>) with the object of pattern 1 as a
    runtime parameter, as tests/test_engine_batch.py builds it."""
    qs = (j_work if j else workloads).lubm_queries()
    plan = (j_make_plan if j else make_plan)(qs[12], part, params=params,
                                             cap_margin=4.0)
    (bucket,) = (j_bucket_plans if j else bucket_plans)([plan])
    return qs[12], bucket


@pytest.mark.parametrize("backend", BACKENDS)
def test_parameterized_and_deduped_requests(lubm_01, backend):
    st, qs, part, kg, jqs, jpart, jkg = lubm_01
    d = st.dictionary
    template, bucket = _q13_bucket(part, st, {(1, 2): 0})
    _, jbucket = _q13_bucket(jpart, None, {(1, 2): 0}, j=True)
    unis = [t for t in (f"ub:University{i}" for i in range(4)) if t in d]
    assert unis
    pvs = [np.asarray([d.id_of(u)], np.int32) for u in unis]
    requests = [(0, pv) for _ in range(3) for pv in pvs] + [(0, None)] * 2
    ref = j_run_batched(jbucket, jkg, requests, join_impl="sorted")
    naive = run_batched(bucket, kg, requests, join_impl="sorted",
                        backend=backend, device="cpu")
    deduped = run_batched(bucket, kg, requests, join_impl="sorted",
                          backend=backend, device="cpu", dedup=True)
    _same(naive, ref)
    _same(deduped, ref)
    for (rows, _, ovf), (_, pv) in zip(naive, requests[:len(pvs)]):
        uni = d.term_of(int(pv[0]))
        inst = Query(template.name, (
            template.patterns[0],
            T(template.patterns[1].s, template.patterns[1].p, c(uni))))
        assert not ovf
        np.testing.assert_array_equal(rows, evaluate_bgp(st, inst))


def test_batch_assembly_and_dedup_match_the_reference(lubm_01):
    from repro.engine.batch import assemble_batch as j_assemble
    from repro.engine.batch import dedup_requests as j_dedup

    st, qs, part, kg, jqs, jpart, jkg = lubm_01
    d = st.dictionary
    uid = next(d.id_of(t) for t in (f"ub:University{i}" for i in range(4))
               if t in d and d.id_of(t) != 0)
    _, bucket = _q13_bucket(part, st, {(1, 2): 0, (0, 2): 1})
    _, jbucket = _q13_bucket(jpart, None, {(1, 2): 0, (0, 2): 1}, j=True)
    requests = [(0, np.asarray([uid], np.int32)),
                (0, np.asarray([uid, 0], np.int32)),
                (0, np.asarray([0], np.int32)), (0, None)]
    for width, n_unique in ((None, 4), (bucket.n_params, 2)):
        (unique, inverse), (j_unique, j_inverse) = \
            dedup_requests(requests, width), j_dedup(requests, width)
        assert inverse == j_inverse and len(unique) == n_unique
        assert all(a[0] == b[0] and a[1] is b[1]
                   for a, b in zip(unique, j_unique))
    assert canonical_params(None, 2) == canonical_params(
        np.zeros(2, np.int32), 2)
    padded = pad_requests_pow2(requests[:3])
    assert len(padded) == 4 and padded[3] == (0, None)
    pd, params = assemble_batch(bucket, padded)
    jpd, jparams = j_assemble(jbucket, padded)
    for f in pd._fields:
        np.testing.assert_array_equal(getattr(pd, f).numpy(),
                                      np.asarray(getattr(jpd, f)))
    np.testing.assert_array_equal(params.numpy(), np.asarray(jparams))
    spd, sparams = stage_batch(bucket, padded, device="cpu")
    assert sparams.device.type == "cpu" and torch.equal(sparams, params)
    with pytest.raises(ValueError, match="3 params.*n_params=2"):
        assemble_batch(bucket, [(0, np.asarray([1, 2, 3], np.int32))])
    with pytest.raises(ValueError, match="empty"):
        assemble_batch(bucket, [])


def test_strict_overflow_raises(lubm_01):
    st, qs, part, kg, *_ = lubm_01
    q = Query("ALL", (T(v("X"), c("rdf:type"), v("Y")),))
    ref = make_plan(q, part)
    squeezed = make_plan(q, part,
                         capacities=([s.scan_cap for s in ref.steps], 8))
    (bucket,) = bucket_plans([squeezed])
    for backend in BACKENDS:
        (_, _, ovf), = run_batched(bucket, kg, backend=backend, device="cpu")
        assert ovf
        with pytest.raises(CapacityOverflowError, match="batched"):
            run_batched(bucket, kg, strict=True, backend=backend,
                        device="cpu")


@pytest.mark.parametrize("impl", ["expand", "sorted"])
def test_edge_queries(impl):
    """0-var asks, never-match constants, semijoin steps, intra-pattern
    equality — the plan shapes most likely to break data-driven joins."""
    from repro_torch.kg.triples import TripleStore

    triples = [(f"s{i}", "p", f"o{i % 3}") for i in range(9)]
    triples += [("s0", "q", "o9")]
    store = TripleStore.from_string_triples(triples)
    qs = [Query("ASK-HIT", (T(c("s0"), c("p"), c("o0")),)),
          Query("ASK-MISS", (T(c("s1"), c("p"), c("o0")),)),
          Query("UNKNOWN", (T(v("X"), c("nosuch"), v("Y")),)),
          Query("MIX", (T(v("X"), c("p"), v("Y")),
                        T(c("s0"), c("q"), c("o9")))),
          Query("SELFEQ", (T(v("X"), c("p"), v("X")),))]
    part = wawpart_partition(store, qs, n_shards=3)
    kg = ShardedKG.build(part)
    for b in bucket_plans([make_plan(q, part) for q in qs]):
        res = {be: run_batched(b, kg, join_impl=impl, backend=be,
                               device="cpu") for be in BACKENDS}
        for i, plan in enumerate(b.plans):
            oracle = evaluate_bgp(store, plan.query)
            for be in BACKENDS:
                rows, n, ovf = res[be][i]
                assert not ovf and n == oracle.shape[0], plan.query.name
                np.testing.assert_array_equal(rows, oracle)


def test_engine_cache_keying(lubm_01):
    from repro_torch.engine.primitives import KernelBlocks

    _, qs, part, *_ = lubm_01
    sig = bucket_plans([make_plan(qs[0], part)])[0].signature
    cache = EngineCache(capacity=3)
    f_cuda = cache.get(sig)
    f_torch = cache.get(sig, backend="torch")
    assert cache.misses == 2 and f_cuda is not f_torch
    assert cache.get(sig, kernel_blocks=KernelBlocks()) is f_cuda
    cache.get(sig, kernel_blocks=KernelBlocks(scan_rows=64))
    cache.get(sig, join_impl="sorted")
    assert cache.misses == 4 and cache.evictions == 1 and len(cache) == 3
    with pytest.raises(ValueError, match="backend"):
        cache.get(sig, backend="jnp")
    with pytest.raises(ValueError, match="capacity"):
        EngineCache(capacity=0)
