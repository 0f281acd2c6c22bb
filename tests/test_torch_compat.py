"""The expand join's selection (`compat_select`) against the JAX package,
bit for bit, and the compat kernels' plan.

`compat_select` returns what the expand join reads from the compatibility
matrix: the semijoin's rows (``tmask & compat.any(-1)``) and the
expansion's first ``cap`` pairs (``select_cap`` of the flattened matrix).
Its torch primitive and its op (the plain version on CPU tensors, which is
the yardstick its CUDA kernel is held against on the card by
chip_smoke.py) are held against the JAX package's jnp `compat_matrix`,
`select_cap` and `.any`, instance by instance, at every cap from 1 to past
R * C."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the test workers running beside
# this one keep their cores
torch.set_num_threads(1)

from repro.engine import primitives as jp  # noqa: E402

from repro_torch.engine import primitives as tp  # noqa: E402
from repro_torch.kernels.kg_join import kernel as tkernel  # noqa: E402
from repro_torch.kernels.kg_join import ops as tjoin  # noqa: E402


def T(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


@jax.jit
def jax_compat(table, tmask, matches, mmask, kind, col):
    """(compat (I, R, C), keep (I, R)) by the JAX package's jnp compat
    matrix, one instance at a time."""
    def one(t, tm, m, mm, k, c):
        compat = jp.compat_matrix(t, tm, m, mm, k, c, backend="jnp")
        return compat, tm & compat.any(axis=-1)
    return jax.vmap(one)(table, tmask, matches, mmask, kind, col)


@functools.lru_cache(maxsize=None)
def jax_select(cap: int):
    return jax.jit(jax.vmap(lambda m: jp.select_cap(m, cap)))


# name: (leading dims of table, tmask, matches, mmask, kind and col; R, C,
# V). "engine" is the batched engine's layout: (requests, shards)
# instances, matches shared by the requests, kind and col by the shards.
CASES = {
    "one_instance": (((1,),) * 6, 37, 45, 4),
    "engine_24": (((8, 3), (8, 3), (1, 3), (1, 3), (8, 1), (8, 1)), 17,
                  70, 3),
    "every_kind": (((27,),) * 6, 9, 33, 3),
    "one_row": (((3,),) * 6, 1, 64, 2),
    "one_column": (((3,),) * 6, 40, 1, 5),
}


def make_case(name):
    """Inputs from numpy: values in [-1, 3) so that pairs match, 70% live
    masks, col in [-2, V + 2) (clipped by the predicate). Where there are
    several instances, instance 0 has no live row and the last one no live
    match; in "every_kind" instance i takes kinds (i // 9, i // 3 % 3,
    i % 3)."""
    leads, r, c, v = CASES[name]
    rng = np.random.default_rng(sum(map(ord, name)))
    lt, ltm, lm, lmm, lk, lc = leads
    table = rng.integers(-1, 3, (*lt, r, v)).astype(np.int32)
    tmask = rng.uniform(size=(*ltm, r)) < 0.7
    matches = rng.integers(-1, 3, (*lm, c, 3)).astype(np.int32)
    mmask = rng.uniform(size=(*lmm, c)) < 0.7
    kind = rng.integers(0, 3, (*lk, 3)).astype(np.int32)
    col = rng.integers(-2, v + 2, (*lc, 3)).astype(np.int32)
    if name == "every_kind":
        i = np.arange(27)
        kind = np.stack([i // 9, i // 3 % 3, i % 3], -1).astype(np.int32)
    if tmask.reshape(-1, r).shape[0] > 1:
        tmask.reshape(-1, r)[0] = False
        mmask.reshape(-1, c)[-1] = False
    return table, tmask, matches, mmask, kind, col


@pytest.mark.parametrize("name", list(CASES))
def test_compat_select_equals_jax(name):
    """keep, order, omask and total of the torch primitive and of the op
    (its plain version on CPU tensors) equal the JAX compat matrix's
    ``select_cap`` and ``.any`` per instance, at caps 1, total - 1, total,
    total + 1, R, R * C and beyond; the op's shapes are the broadcast
    leading dims'."""
    args = make_case(name)
    r, c = args[0].shape[-2], args[2].shape[-2]
    lead = np.broadcast_shapes(*(a.shape[:a.ndim - n]
                                 for a, n in zip(args, (2, 1, 2, 1, 1, 1))))
    flat = [np.broadcast_to(a, (*lead, *a.shape[a.ndim - n:]))
            .reshape(-1, *a.shape[a.ndim - n:])
            for a, n in zip(args, (2, 1, 2, 1, 1, 1))]
    compat, keep = jax_compat(*flat)
    totals = np.asarray(compat).reshape(len(flat[0]), -1).sum(-1)
    if len(totals) > 1:
        assert totals[0] == 0 and totals[-1] == 0   # dead rows, dead matches
    t = int(totals[len(totals) // 2])
    n = r * c
    for cap in sorted({1, max(t - 1, 1), max(t, 1), t + 1, r, n, n + 5}):
        prim = tp.compat_select(*map(T, args), cap, backend="torch")
        out = tjoin.compat_select(*map(T, args), cap)
        m = min(cap, n)
        assert out[0].shape == (*lead, r)
        assert out[1].shape == out[2].shape == (*lead, m)
        assert out[3].shape == tuple(lead)
        assert [x.dtype for x in out] == [torch.bool, torch.int32,
                                          torch.bool, torch.int32]
        for a, b in zip(out, prim):
            assert torch.equal(a, b)
        ref = (keep, *jax_select(cap)(jnp.reshape(compat, (-1, n))))
        for port, want in zip(out, ref):
            want = np.asarray(want)
            got = port.reshape(-1, *port.shape[len(lead):]).numpy()
            assert got.dtype == want.dtype, (got.dtype, want.dtype)
            np.testing.assert_array_equal(got, want)


def test_compat_select_matches_the_matrix_it_replaces():
    """The op's pairs are the set entries of `compat_matrix`, row-major:
    order // C and order % C index set entries, and keep is the rows with
    one."""
    args = [T(a) for a in make_case("engine_24")]
    c = args[2].shape[-2]
    compat = tjoin.compat_matrix(*args)
    keep, order, omask, total = tjoin.compat_select(*args, 10**6)
    assert torch.equal(total, compat.flatten(-2).sum(-1, dtype=torch.int32))
    assert torch.equal(keep, compat.any(-1))
    hit = torch.gather(compat.flatten(-2), -1, order.long())
    assert torch.equal(hit & omask, omask)
    assert bool((order.diff(dim=-1)[omask[..., 1:]] > 0).all())
    assert int((order[omask] % c).max()) < c


def test_compat_ops_on_cpu_launch_nothing():
    args = [T(a) for a in make_case("one_column")]
    before = (tjoin.compat_select.launches, tjoin.compat_matrix.launches)
    tjoin.compat_select(*args, 8)
    tjoin.compat_matrix(*args)
    assert (tjoin.compat_select.launches,
            tjoin.compat_matrix.launches) == before


@pytest.mark.parametrize("instances,r,c,v", [
    (1, 1, 1, 1), (24, 256, 768, 4), (6, 4096, 8192, 6), (3, 513, 300, 6),
    (24, 32768, 49152, 4), (2, 33, 131072, 3), (1, 70000, 257, 2)])
def test_compat_plan_covers_every_tile_once(instances, r, c, v):
    """kernel.compat_plan is pure and cached; the blocks of the matrix (and
    count and write) launch cover every (instance, 32-row tile, 256-column
    segment) once, a warp a tile; the plan takes the most tiles and then
    segments a block that still give two blocks an SM; the scan launch has
    a block per tile, the write launch one per tiles and segment; shared
    memory within the card's."""
    p = tkernel.compat_plan(instances, r, c, v)
    assert tkernel.compat_plan(instances, r, c, v) is p
    tkernel.compat_plan.cache_clear()
    assert tkernel.compat_plan(instances, r, c, v) == p
    seg = tkernel.COMPAT_SEG
    assert (p.segments - 1) * seg < c <= p.segments * seg
    assert (p.tiles_per_instance - 1) * 32 < r <= p.tiles_per_instance * 32
    rw, sc = p.tiles_per_block, p.chunk_segments
    assert 1 <= rw <= tkernel.COMPAT_TILES and 1 <= sc <= tkernel.COMPAT_CHUNK
    rblocks = -(-p.tiles_per_instance // rw)
    chunks = -(-p.segments // sc)
    assert p.blocks == instances * rblocks * chunks
    assert p.scan_blocks == instances * p.tiles_per_instance
    if p.blocks <= 20000:
        # block b: chunk b % chunks of tile group b // chunks; warp w: a tile
        got = [(b // chunks // rblocks, b // chunks % rblocks * rw + w,
                b % chunks * sc + q)
               for b in range(p.blocks) for w in range(rw) for q in range(sc)]
        got = [x for x in got if x[1] < p.tiles_per_instance
               and x[2] < p.segments]
        assert sorted(got) == [(i, t, s) for i in range(instances)
                               for t in range(p.tiles_per_instance)
                               for s in range(p.segments)]
    if p.blocks < tkernel.COMPAT_MIN_BLOCKS:
        assert (rw, sc) == (1, 1)
    assert p.write_blocks == instances * rblocks * p.segments
    assert p.count_smem == sc * tkernel.COMPAT_SEG_BYTES
    assert p.matrix_smem == p.count_smem + rw * tkernel.COMPAT_TILE_BYTES \
        <= tkernel.SMEM_BYTES
    assert p.write_smem == tkernel.COMPAT_SEG_BYTES \
        + rw * tkernel.COMPAT_TILE_BYTES
    if (instances, r, c) == (24, 256, 768):
        # the expand path's largest call at LUBM 0.1: 288 blocks of 2 tiles
        assert (rw, sc, p.blocks) == (2, 1, 288)
    if (instances, r, c) == (6, 4096, 8192):
        assert (rw, sc, p.blocks, p.scan_blocks) == (8, 4, 768, 768)


def test_compat_plan_limits():
    for bad in ((0, 1, 1, 1), (1, 0, 1, 1), (1, 1, 0, 1), (1, 1, 1, 0),
                (1, 1, tkernel.COMPAT_MAX_SEGS * tkernel.COMPAT_SEG + 1, 1),
                (1, 2**31, 1, 1), (1, 1, 1, 2**31)):
        with pytest.raises(ValueError):
            tkernel.compat_plan(*bad)
    p = tkernel.compat_plan(1, 1, tkernel.COMPAT_MAX_SEGS
                            * tkernel.COMPAT_SEG, 1)
    assert p.segments == tkernel.COMPAT_MAX_SEGS


def test_expand_join_cli_check_agrees_with_the_oracle(capsys):
    """The serving CLI's --check on the expand join, whose every step
    selects through compat_select: each served answer equals the oracle."""
    from repro_torch.launch import serve
    serve.main(["--scale", "0.05", "--join", "expand", "--requests", "28",
                "--batch", "14", "--no-cache", "--device", "cpu", "--check"])
    out = capsys.readouterr().out
    assert "oracle: 28/28 answers equal evaluate_bgp" in out
    assert "overflows=0" in out
