"""The port's batched bucket engine on BSBM, against the JAX package's:
BSBM 120 over 3 WawPart shards, every bucket, both join implementations
and both port backends ("torch", and "cuda" whose kernel ops run their
plain versions on CPU tensors): solutions, counts and overflow flags equal
the reference's run_batched bit for bit, and the oracle."""
import dataclasses

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
from repro_torch.engine.batch import (EngineCache, bucket_plans,  # noqa: E402
                                      run_batched, shard_perms)
from repro_torch.engine.federated import ShardedKG  # noqa: E402
from repro_torch.engine.oracle import evaluate_bgp  # noqa: E402
from repro_torch.engine.planner import make_plan  # noqa: E402
from repro_torch.kg import generator, workloads  # noqa: E402


@pytest.fixture(scope="module")
def bsbm():
    st, jst = generator.generate_bsbm(120, seed=0), \
        j_gen.generate_bsbm(120, seed=0)
    qs, jqs = workloads.bsbm_queries(), j_work.bsbm_queries()
    part = wawpart_partition(st, qs, n_shards=3)
    jpart = j_wawpart(jst, jqs, n_shards=3)
    jkg = JShardedKG.build(jpart)
    kg = ShardedKG.from_arrays(np.asarray(jkg.triples), np.asarray(jkg.valid))
    return st, qs, part, kg, jqs, jpart, jkg


@pytest.mark.parametrize("impl", ["sorted", "expand"])
def test_every_bsbm_bucket_matches_the_jax_engine(bsbm, impl):
    st, qs, part, kg, jqs, jpart, jkg = bsbm
    buckets = bucket_plans([make_plan(q, part) for q in qs])
    jbuckets = j_bucket_plans([j_make_plan(q, jpart) for q in jqs])
    assert len(buckets) == len(jbuckets) > 1
    perms = shard_perms(kg)
    jcache, cache = JEngineCache(), EngineCache()
    for b, jb in zip(buckets, jbuckets):
        assert dataclasses.astuple(b.signature) == \
            dataclasses.astuple(jb.signature)
        ref = j_run_batched(jb, jkg, join_impl=impl, cache=jcache)
        for backend in ("torch", "cuda"):
            res = run_batched(b, kg, join_impl=impl, cache=cache,
                              perms=perms, backend=backend, device="cpu")
            assert len(res) == len(ref)
            for (rows, n, ovf), (jrows, jn, jovf) in zip(res, ref):
                assert (n, ovf) == (jn, jovf) and rows.dtype == np.int32
                np.testing.assert_array_equal(rows, np.asarray(jrows))
        for (rows, _, ovf), plan in zip(res, b.plans):
            assert not ovf, plan.query.name
            np.testing.assert_array_equal(rows, evaluate_bgp(st, plan.query))
