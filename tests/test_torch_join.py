"""The merge join's select epilogue (`kg_join.join_select`) against the JAX
package, bit for bit, and the kg_join kernel's plan.

`join_select`'s plain version (the CPU path of its op, and the yardstick
its CUDA kernel is held against on the card by chip_smoke.py) is held
against the JAX merge join's own route: `repro.engine.primitives`'s jnp
`join_ranges`, the pair mask as `src/repro/engine/batch.py` builds it, then
`select_cap`. The engine's merge join, which now takes `join_select` on
steps that verify no second column and builds no pair mask there, is held
against the JAX engine's tables, masks and overflow flags for every bucket
at LUBM 0.1, also with a small fan-out cap and table cap so that both
overflows occur."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the test workers running beside
# this one keep their cores
torch.set_num_threads(1)

from repro.core.partitioner import wawpart_partition as j_wawpart  # noqa: E402
from repro.engine import primitives as jp  # noqa: E402
from repro.engine.batch import EngineCache as JEngineCache  # noqa: E402
from repro.engine.batch import assemble_batch as j_assemble  # noqa: E402
from repro.engine.batch import bucket_plans as j_bucket_plans  # noqa: E402
from repro.engine.batch import shard_perms as j_shard_perms  # noqa: E402
from repro.engine.federated import ShardedKG as JShardedKG  # noqa: E402
from repro.engine.planner import make_plan as j_make_plan  # noqa: E402
from repro.kg import generator as j_gen  # noqa: E402
from repro.kg import workloads as j_work  # noqa: E402

from repro_torch.core.partitioner import wawpart_partition  # noqa: E402
from repro_torch.engine import batch as port_batch  # noqa: E402
from repro_torch.engine import primitives as tp  # noqa: E402
from repro_torch.engine.batch import (EngineCache, bucket_plans,  # noqa: E402
                                      kg_tensors, shard_perms, stage_batch)
from repro_torch.engine.federated import ShardedKG  # noqa: E402
from repro_torch.engine.planner import make_plan  # noqa: E402
from repro_torch.kernels.kg_join import kernel as tkernel  # noqa: E402
from repro_torch.kernels.kg_join import ops as tjoin  # noqa: E402
from repro_torch.kg import generator, workloads  # noqa: E402

INT_MAX = np.int32(2**31 - 1)
BACKENDS = ("torch", "cuda")


def T(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def same(port, ref):
    """Bit-identical, including dtype (int32 stays int32)."""
    ref = np.asarray(ref)
    out = port.numpy()
    assert out.dtype == ref.dtype, (out.dtype, ref.dtype)
    np.testing.assert_array_equal(out, ref)


def jax_route(keys, rkey, tmask, k: int, cap: int):
    """One instance's merge-join selection as the JAX engine computes it
    (src/repro/engine/batch.py, _join_merge): the ranges, counts, the
    (row, block, slot) pair mask, then select_cap of it flattened."""
    sb, r = keys.shape[0], rkey.shape[0]
    lo, hi = jp.join_ranges(jnp.asarray(keys), jnp.asarray(rkey),
                            backend="jnp")
    tm = jnp.asarray(tmask)
    counts = jnp.where(tm[None, :], hi - lo, 0)
    offs = jnp.arange(k)[None, None, :]
    pair_ok = ((offs < counts[:, :, None]) & tm[None, :, None]) \
        .transpose(1, 0, 2).reshape(r, sb * k)
    return (lo, counts, *jp.select_cap(pair_ok.reshape(-1), cap))


# (keys lead, rkey lead, tmask lead, S_b, C, R, K, largest key): keys drawn
# from [-1, largest key] (-1 is the unbound sentinel), 20% INT_MAX padding,
# row keys from [-1, largest key + 3]
SELECT_CASES = {
    "sb1_k_below_c": ((4,), (4,), (4,), 1, 40, 30, 3, 30),
    "sb3_k_equals_c": ((3,), (3,), (3,), 3, 8, 25, 8, 6),
    "sb3_fanout_above_k": ((3,), (3,), (3,), 3, 64, 40, 2, 3),
    "broadcast_leading_dims": ((2, 1), (1, 3), (2, 3), 3, 33, 17, 4, 12),
    "keys_shared_by_all": ((), (2, 2), (2, 2), 2, 50, 20, 5, 20),
    "one_row_one_key": ((2,), (2,), (2,), 1, 1, 1, 1, 2),
}


@pytest.mark.parametrize("case", list(SELECT_CASES))
def test_join_select_plain_equals_jax_route(case):
    """lo, counts, order, omask and total of the op (plain version on CPU
    tensors) and of the torch primitive equal the JAX route per instance,
    at caps 1, total - 1, total, total + 1, R, R * S_b * K and beyond.
    The first instance is all dead, the last all live; one key block is
    all padding; repeated keys give fan-outs above K."""
    lk, lr, lt, sb, c, r, k, hi_key = SELECT_CASES[case]
    rng = np.random.default_rng(sum(map(ord, case)))
    keys = rng.integers(-1, hi_key + 1, (*lk, sb, c)).astype(np.int32)
    keys = np.where(rng.uniform(size=keys.shape) < 0.2, INT_MAX, keys)
    keys = np.sort(keys, axis=-1).astype(np.int32)
    if sb > 1:
        keys[..., 1, :] = INT_MAX                 # an empty key block
    rkey = rng.integers(-1, hi_key + 4, (*lr, r)).astype(np.int32)
    tmask = rng.uniform(size=(*lt, r)) < 0.7
    lead = np.broadcast_shapes(lk, lr, lt)
    flat_t = tmask.reshape(-1, r)
    if flat_t.shape[0] > 1:
        flat_t[0] = False                         # an all-dead instance
        flat_t[-1] = True                         # an all-live instance
    kb = np.broadcast_to(keys, (*lead, sb, c)).reshape(-1, sb, c)
    rb = np.broadcast_to(rkey, (*lead, r)).reshape(-1, r)
    tb = np.broadcast_to(tmask, (*lead, r)).reshape(-1, r)
    n = r * sb * k
    totals = [int(np.asarray(jax_route(kb[i], rb[i], tb[i], k, n)[4]))
              for i in range(kb.shape[0])]
    assert totals[0] == 0                         # the dead instance
    t = totals[len(totals) // 2]
    for cap in sorted({1, max(t - 1, 1), max(t, 1), t + 1, r, n, n + 5}):
        out = tjoin.join_select(T(keys), T(rkey), T(tmask), k, cap)
        prim = tp.join_select(T(keys), T(rkey), T(tmask), k, cap,
                              backend="torch")
        m = min(cap, n)
        assert out[0].shape == out[1].shape == (*lead, sb, r)
        assert out[2].shape == out[3].shape == (*lead, m)
        assert out[4].shape == tuple(lead)
        for a, b in zip(out, prim):
            assert torch.equal(a, b)
        flat = [x.reshape(-1, *x.shape[len(lead):]) for x in out]
        for i in range(kb.shape[0]):
            for port, ref in zip(flat, jax_route(kb[i], rb[i], tb[i], k,
                                                 cap)):
                same(port[i], ref)
    # counts above K, and a row key of -1 that finds keys of -1
    counts = tjoin.join_select(T(keys), T(rkey), T(tmask), k, n)[1]
    if case == "sb3_fanout_above_k":
        assert int(counts.max()) > k


def test_join_select_op_on_cpu_launches_nothing():
    rng = np.random.default_rng(3)
    keys = T(np.sort(rng.integers(0, 5, (2, 3, 16)).astype(np.int32), -1))
    rkey = T(rng.integers(0, 6, (2, 8)).astype(np.int32))
    tmask = T(rng.uniform(size=(2, 8)) < 0.5)
    before = (tjoin.join_select.launches, tjoin.join_ranges.launches)
    out = tjoin.join_select(keys, rkey, tmask, 4, 8)
    lo, hi = tjoin.join_ranges(keys, rkey)
    assert torch.equal(out[0], lo)
    assert torch.equal(out[1], torch.where(tmask[:, None], hi - lo, 0))
    assert (tjoin.join_select.launches, tjoin.join_ranges.launches) == before


@pytest.mark.parametrize("instances,sb,c,r", [
    (1, 1, 1, 1), (2, 3, 1000, 200), (3, 8, 0, 513), (5, 2, 16383, 77),
    (24, 3, 16384, 32768), (24, 1, 16384, 32768), (24, 3, 16385, 32768),
    (24, 3, 65536, 32768), (24, 1, 201326592, 32768), (1, 40, 70000, 1)])
def test_join_plan_covers_every_row_once(instances, sb, c, r):
    """kernel.plan is pure and cached; the tree keeps at most KEY_BUDGET
    keys in shared memory, by the smallest shift (the splitter route past
    the budget); each tiling covers every (instance, row) once, whole
    warps, its shared memory within the card's; the main path's shapes
    stage each key block few times."""
    p = tkernel.plan(instances, sb, c, r)
    assert tkernel.plan(instances, sb, c, r) is p
    tkernel.plan.cache_clear()
    assert tkernel.plan(instances, sb, c, r) == p
    assert p.levels == c.bit_length()
    assert p.staged == c >> p.shift <= tkernel.KEY_BUDGET
    assert p.shift == 0 or c >> (p.shift - 1) > tkernel.KEY_BUDGET
    assert p.route == ("shared" if c <= tkernel.KEY_BUDGET else "splitter")
    tree = -(-(p.staged + p.levels - p.shift) * 4 // 16) * 16
    threads = tkernel.THREADS
    for t, per_block, smem in (
            (p.ranges, instances * sb, tree),
            (p.select, instances, p.select.tile_rows * sb * 4)):
        assert t.tile_rows == threads * t.rows_per_thread
        assert (t.tiles_per_instance - 1) * t.tile_rows < r \
            <= t.tiles_per_instance * t.tile_rows
        assert t.blocks == per_block * t.tiles_per_instance
        assert t.smem_bytes == smem <= tkernel.SMEM_BYTES
        if r * t.tile_rows <= 10**6:
            # thread j of tile q takes rows q * tile + j + threads * m
            rows = np.concatenate([
                q * t.tile_rows + j + threads * np.arange(t.rows_per_thread)
                for q in range(t.tiles_per_instance)
                for j in range(threads)])
            assert np.array_equal(np.sort(rows[rows < r]), np.arange(r))
    assert p.ranges.rows_per_thread % tkernel.ILP == 0
    if (instances, sb, c, r) == (24, 3, 16384, 32768):
        # 72 key blocks of 64 KB, each staged 8 times (37.7 MB through L2);
        # 16 select tiles an instance: the counts go through device memory
        assert (p.ranges.rows_per_thread, p.ranges.blocks) == (16, 576)
        assert (p.select.rows_per_thread, p.select.blocks) == (8, 384)
    if p.ranges.blocks < tkernel.RANGES_MIN_BLOCKS:
        assert p.ranges.rows_per_thread == tkernel.ILP
    if p.select.blocks < tkernel.SELECT_MIN_BLOCKS:
        assert p.select.rows_per_thread <= tkernel.ILP


def test_join_plan_limits():
    for bad in ((0, 1, 10, 10), (1, 0, 10, 10), (1, 1, 10, 0),
                (1, 1, 2**31, 10), (1, 1, 10, 2**31), (1, 65536, 10, 10)):
        with pytest.raises(ValueError, match="kg_join"):
            tkernel.plan(*bad)
    with pytest.raises(ValueError, match="shared memory"):
        tkernel.plan(1, 1000, 16384, 32768)
    with pytest.raises(ValueError, match="grid"):
        tkernel.plan(2**30, 4, 16, 32768)


def _setup(scale):
    st = generator.generate_lubm(1, scale=scale, seed=0)
    jst = j_gen.generate_lubm(1, scale=scale, seed=0)
    qs, jqs = workloads.lubm_queries(), j_work.lubm_queries()
    part = wawpart_partition(st, qs, n_shards=3)
    jpart = j_wawpart(jst, jqs, n_shards=3)
    jkg = JShardedKG.build(jpart)
    kg = ShardedKG.from_arrays(np.asarray(jkg.triples), np.asarray(jkg.valid))
    return qs, part, kg, jqs, jpart, jkg


@pytest.fixture(scope="module")
def lubm_01():
    return _setup(0.1)


def _squeezed(make, q, part, table_cap):
    """The plan of q with its scan caps and a table cap of table_cap."""
    plan = make(q, part)
    if table_cap is None:
        return plan
    return make(q, part, capacities=([s.scan_cap for s in plan.steps],
                                     table_cap))


@pytest.mark.parametrize("max_per_row,table_cap", [(None, None), (2, 8)])
def test_merge_join_buckets_match_the_jax_engine(lubm_01, monkeypatch,
                                                 max_per_row, table_cap):
    """Every bucket of LUBM 0.1 under the merge join: the port's engine
    tables, masks and overflow flags equal the JAX engine's, on both
    backends. The first case runs every template as planned (no overflow);
    the second caps the fan-out at 2 and the table at 8 rows, so that
    both the fan-out overflow and total > R occur in join_select."""
    qs, part, kg, jqs, jpart, jkg = lubm_01
    buckets = bucket_plans([_squeezed(make_plan, q, part, table_cap)
                            for q in qs])
    jbuckets = j_bucket_plans([_squeezed(j_make_plan, q, jpart, table_cap)
                               for q in jqs])
    assert len(buckets) == len(jbuckets)
    seen = {"select": 0, "fanout": 0, "total": 0}
    select = port_batch.join_select

    def spy(keys, rkey, tmask, k, cap, **kw):
        out = select(keys, rkey, tmask, k, cap, **kw)
        seen["select"] += 1
        seen["fanout"] += int((out[1].amax(dim=(-2, -1)) > k).any())
        seen["total"] += int((out[4] > cap).any())
        return out

    monkeypatch.setattr(port_batch, "join_select", spy)
    perms, jperms = shard_perms(kg), j_shard_perms(jkg)
    jcache, cache = JEngineCache(), EngineCache()
    tr, va, pe = kg_tensors(kg, perms, "cpu")
    n_sorted = 0
    for b, jb in zip(buckets, jbuckets):
        n_sorted += sum(b.signature.sorted_bits[1:])
        requests = [(i, None) for i in range(len(b.plans))]
        jfn = jcache.get(jb.signature, join_impl="sorted",
                         max_per_row=max_per_row)
        jpd, jparams = j_assemble(jb, requests)
        ref = jfn(jnp.asarray(jkg.triples), jnp.asarray(jkg.valid),
                  jnp.asarray(jperms), jpd, jparams)
        for backend in BACKENDS:
            fn = cache.get(b.signature, join_impl="sorted",
                           max_per_row=max_per_row, backend=backend)
            pd, params = stage_batch(b, requests, device="cpu")
            out = fn(tr, va, pe, pd, params)
            for port, r in zip(out, ref):
                same(port, r)
    assert n_sorted > 0 and seen["select"] > 0
    if table_cap is None:
        assert seen["fanout"] == seen["total"] == 0
    else:
        assert seen["fanout"] > 0 and seen["total"] > 0
