"""The port's scan/join primitives and kernel modules against the JAX
package, bit for bit: each port function (with leading batch dims) is held
against the JAX jnp primitive and the JAX Pallas op (interpret mode on the
CPU, as tests/test_kernels.py runs it), on the random inputs and edge
shapes of tests/test_kernels.py. On CPU tensors the port's kernel ops run
their plain versions; the CUDA kernels themselves are held against those
plain versions on the card by chip_smoke.py."""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the test workers running beside
# this one keep their cores
torch.set_num_threads(1)

from repro.engine import primitives as jp  # noqa: E402
from repro.kernels.kg_join import ops as jjoin  # noqa: E402
from repro.kernels.kg_scan import ops as jscan  # noqa: E402

from repro_torch.engine import primitives as tp  # noqa: E402
from repro_torch.kernels.kg_join import ops as tjoin  # noqa: E402
from repro_torch.kernels.kg_scan import kernel as tscan_kernel  # noqa: E402
from repro_torch.kernels.kg_scan import ops as tscan  # noqa: E402

INT_MAX = np.int32(2**31 - 1)
BACKENDS = ("torch", "cuda")
SCAN_CASES = [([5, -1, 7], [0, 0, 0]), ([-1, -1, -1], [1, 0, 0]),
              ([-2, 3, -1], [0, 0, 0]), ([4, -1, -1], [0, 1, 1]),
              ([-1, -1, -1], [0, 0, 0])]


def T(a):
    return torch.from_numpy(np.ascontiguousarray(np.asarray(a)))


def same(port, ref):
    """Bit-identical, including dtype (int32 stays int32)."""
    ref = np.asarray(ref)
    out = port.numpy()
    assert out.dtype == ref.dtype, (out.dtype, ref.dtype)
    np.testing.assert_array_equal(out, ref)


def caps_around(total: int, n: int) -> list[int]:
    """k = 1, total - 1, total, n and n + 7 (at least 1)."""
    return sorted({1, max(total - 1, 1), max(total, 1), n, n + 7})


def same_selection(port, refs, b):
    """scan_select's (idx, sel, total) of instance b against each JAX
    (idx, sel, total)."""
    for ref in refs:
        for out, r in zip(port, ref):
            same(out[b], r)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n,block_rows", [(64, 1024), (1000, 256),
                                          (4096, 1024), (9, 8), (1, 8)])
def test_scan_hits_batched(n, block_rows, backend):
    """scan_hits and scan_select over the engine's (B, S, N) layout, the
    triples broadcast over the requests and the patterns over the shards,
    against the JAX jnp scan and the Pallas scan (interpret mode), and the
    selection against the JAX select_from_cum of both. Pattern 2 never
    matches (an all-false instance); shard 1 is all valid, so pattern 4
    matches every row there (an all-true instance)."""
    rng = np.random.default_rng(n)
    triples = rng.integers(-1, 30, (2, n, 3)).astype(np.int32)   # 2 shards
    valid = rng.uniform(size=(2, n)) < 0.8
    valid[1] = True
    spo = np.array([c for c, _ in SCAN_CASES], np.int32)[:, None]  # (5,1,3)
    eq = np.array([g for _, g in SCAN_CASES], bool)[:, None]
    B = len(SCAN_CASES)
    hit, cum = tp.scan_hits(T(triples), T(valid), T(spo), T(eq),
                            backend=backend)
    assert hit.shape == cum.shape == (B, 2, n)
    assert cum.dtype == torch.int32 and hit.dtype == torch.bool
    refs = {}
    for b in range(B):
        for s in range(2):
            args = (jnp.asarray(triples[s]), jnp.asarray(valid[s]),
                    jnp.asarray(spo[b, 0]), jnp.asarray(eq[b, 0]))
            h_j, c_j = jp.scan_hits(*args, backend="jnp")
            h_p, c_p = jscan.scan_hits(*args, block_rows=block_rows)
            for ref_h, ref_c in ((h_j, c_j), (h_p, c_p)):
                same(hit[b, s], ref_h)
                same(cum[b, s], ref_c)
            refs[b, s] = (c_j, c_p)
    assert not hit[2].any() and hit[4, 1].all()
    for cap in caps_around(int(cum[0, 0, -1]), n):
        h2, *sel = tp.scan_select(T(triples), T(valid), cap, T(spo), T(eq),
                                  backend=backend)
        assert torch.equal(h2, hit) and sel[0].dtype == torch.int32
        assert sel[0].shape == sel[1].shape == (B, 2, min(cap, n))
        h3, *sel3 = tp.scan_select(T(triples), T(valid), cap, T(spo),
                                   T(eq), backend=backend, with_hit=False)
        assert h3 is None
        for a, b in zip(sel3, sel):
            assert torch.equal(a, b)
        for b in range(B):
            for s in range(2):
                same_selection(
                    [x[b] for x in sel],
                    [jp.select_from_cum(c, cap) for c in refs[b, s]], s)
    # the hit mask alone
    h_o, c_o = tp.scan_hits(T(triples), T(valid), T(spo), T(eq),
                            backend=backend, with_cum=False)
    assert c_o is None and torch.equal(h_o, hit)
    # eq=None and the predicate-free prefix sum of a mask
    h_n, c_n = tp.scan_hits(T(triples[0]), T(valid[0]), T(spo[2, 0]),
                            backend=backend)
    h_j, c_j = jp.scan_hits(jnp.asarray(triples[0]), jnp.asarray(valid[0]),
                            jnp.asarray(spo[2, 0]), backend="jnp")
    same(h_n, h_j)
    same(c_n, c_j)
    for cap in caps_around(int(c_j[-1]), n):
        h2, *sel = tp.scan_select(T(triples[0]), T(valid[0]), cap,
                                  T(spo[2, 0]), backend=backend)
        same(h2, h_j)
        same_selection([x[None] for x in sel],
                       [jp.select_from_cum(c_j, cap)], 0)
    h_m, c_m = tp.scan_hits(None, T(valid), backend=backend)
    assert h_m is not None and torch.equal(h_m, T(valid))
    same(c_m, np.cumsum(valid, axis=-1, dtype=np.int32))
    # the mask-only form, its leading dim expanded over the requests
    for cap in caps_around(int(c_m[0, -1]), n):
        h2, *sel = tp.scan_select(None, T(valid).expand(3, 2, n), cap,
                                  backend=backend)
        assert h2 is None and sel[0].shape == (3, 2, min(cap, n))
        for s in range(2):
            same_selection([x[2] for x in sel],
                           [jp.select_cap(jnp.asarray(valid[s]), cap)], s)


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("n", [1, 9, 64, 1000, 4096])
def test_select_and_compact_batched(n, backend):
    rng = np.random.default_rng(100 + n)
    mask = rng.uniform(size=(4, n)) < 0.4
    mask[1] = False                                  # an all-empty instance
    mask[3] = True                                   # an all-full instance
    rows = rng.integers(0, 50, (4, n, 3)).astype(np.int32)
    cum = np.cumsum(mask, axis=-1, dtype=np.int32)
    for cap in sorted({5, *caps_around(int(cum[0, -1]), n)}):
        idx, sel, total = tp.select_cap(T(mask), cap, backend=backend)
        idx2, sel2, total2 = tp.select_from_cum(T(cum), cap)
        h3, idx3, sel3, total3 = tscan.scan_select(None, T(mask), cap)
        assert h3 is None
        m, mm, ovf = tp.compact(T(rows), T(mask), cap, backend=backend)
        assert idx.dtype == torch.int32 and total.dtype == torch.int32
        for b in range(4):
            j_idx, j_sel, j_total = jp.select_cap(jnp.asarray(mask[b]), cap)
            for port in ((idx, sel, total), (idx2, sel2, total2),
                         (idx3, sel3, total3)):
                same(port[0][b], j_idx)
                same(port[1][b], j_sel)
                same(port[2][b], j_total)
            j_m, j_mm, j_ovf = jp.compact(jnp.asarray(rows[b]),
                                          jnp.asarray(mask[b]), cap)
            same(m[b], j_m)
            same(mm[b], j_mm)
            same(ovf[b], j_ovf)


def _sorted_keys(rng, lead, c):
    keys = np.sort(rng.integers(-1, 40, (*lead, c)).astype(np.int32), -1)
    keys = np.where(rng.uniform(size=keys.shape) < 0.2, INT_MAX, keys)
    return np.sort(keys, axis=-1).astype(np.int32)  # INT_MAX invalid padding


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("sb,C,R,br,bc", [(1, 64, 32, 256, 512),
                                          (3, 1000, 200, 64, 128),
                                          (8, 128, 513, 256, 512)])
def test_join_ranges_both_conventions(sb, C, R, br, bc, backend):
    rng = np.random.default_rng(sb * 1000 + C)
    keys = _sorted_keys(rng, (2, sb), C)                  # 2 instances
    rkey = rng.integers(-1, 45, (2, R)).astype(np.int32)
    lo, hi = tp.join_ranges(T(keys), T(rkey), backend=backend)
    assert lo.shape == hi.shape == (2, sb, R) and lo.dtype == torch.int32
    lo1, hi1 = tp.join_ranges(T(keys[:, 0]), T(rkey), backend=backend)
    assert lo1.shape == (2, R) and hi1.dtype == torch.int32
    for b in range(2):
        k, r = jnp.asarray(keys[b]), jnp.asarray(rkey[b])
        for ref in (jp.join_ranges(k, r, backend="jnp"),
                    jjoin.join_ranges(k, r, block_rows=br, block_cols=bc)):
            same(lo[b], ref[0])
            same(hi[b], ref[1])
        ref1 = jjoin.join_ranges(k[0], r)                  # (C,) convention
        same(lo1[b], ref1[0])
        same(hi1[b], ref1[1])
        same(lo1[b], jp.join_ranges(k[0], r, backend="jnp")[0])


@pytest.mark.parametrize("backend", BACKENDS)
@pytest.mark.parametrize("R,V,C", [(32, 4, 64), (200, 1, 17), (513, 6, 300)])
def test_compat_matrix_batched(R, V, C, backend):
    rng = np.random.default_rng(R + V + C)
    table = rng.integers(-1, 20, (3, R, V)).astype(np.int32)
    tmask = rng.uniform(size=(3, R)) < 0.7
    matches = rng.integers(-1, 20, (3, C, 3)).astype(np.int32)
    mmask = rng.uniform(size=(3, C)) < 0.7
    kind = rng.integers(0, 3, (3, 3)).astype(np.int32)
    kind[0] = 1                                   # every position joins
    col = rng.integers(-1, V + 1, (3, 3)).astype(np.int32)  # clipped edges
    out = tp.compat_matrix(T(table), T(tmask), T(matches), T(mmask), T(kind),
                           T(col), backend=backend)
    assert out.shape == (3, R, C) and out.dtype == torch.bool
    for b in range(3):
        args = [jnp.asarray(a[b]) for a in (table, tmask, matches, mmask,
                                            kind, col)]
        same(out[b], jp.compat_matrix(*args, backend="jnp"))
        same(out[b], jjoin.compat_matrix(*args))


def test_kernel_ops_on_cpu_use_the_plain_version_and_launch_nothing():
    rng = np.random.default_rng(5)
    tr = T(rng.integers(0, 9, (4, 128, 3)).astype(np.int32))
    va = T(rng.uniform(size=(4, 128)) < 0.9)
    spo = T(np.array([-1, 3, -1], np.int32))
    before = (tscan.scan_hits.launches, tscan.scan_select.launches,
              tjoin.join_ranges.launches, tjoin.compat_matrix.launches)
    hit, cum = tscan.scan_hits(tr, va, spo)
    h_r, c_r = tp.scan_hits(tr, va, spo, backend="torch")
    assert torch.equal(hit, h_r) and torch.equal(cum, c_r)
    out = tscan.scan_select(tr, va, 50, spo)
    for a, b in zip(out, tp.scan_select(tr, va, 50, spo, backend="torch")):
        assert torch.equal(a, b)
    h_o, c_o = tscan.scan_hits(tr, va, spo, with_cum=False)
    assert c_o is None and torch.equal(h_o, h_r)
    with pytest.raises(ValueError, match="needs the triples"):
        tscan.scan_hits(None, va, with_cum=False)
    keys = T(_sorted_keys(rng, (4,), 64))
    lo, hi = tjoin.join_ranges(keys, tr[..., 0])
    assert torch.equal(lo, tp.join_ranges(keys, tr[..., 0])[0])
    out = tjoin.compat_matrix(tr, va, tr, va, spo.expand(4, 3),
                              spo.expand(4, 3).clamp(min=0))
    assert out.shape == (4, 128, 128)
    assert (tscan.scan_hits.launches, tscan.scan_select.launches,
            tjoin.join_ranges.launches, tjoin.compat_matrix.launches) \
        == before


def test_kernel_blocks_and_backend_validation():
    with pytest.raises(ValueError, match="scan_rows"):
        tp.KernelBlocks(scan_rows=0)
    with pytest.raises(ValueError, match="join_cols"):
        tp.KernelBlocks(join_cols=True)
    with pytest.raises(ValueError, match="backend"):
        tp.check_backend("pallas")
    with pytest.raises(ValueError, match="KernelBlocks"):
        tp.check_backend("cuda", (64, 64, 64))
    assert tp.check_backend("torch") == tp.KernelBlocks()
    np.testing.assert_array_equal(tp.eq_gates(((2, 0),)),
                                  jp.eq_gates(((2, 0),)))
    for shared, new in ((((0, 1),), ((2, 0),)), ((), ((0, 5), (2, 1)))):
        for a, b in zip(tp.static_kind_col(shared, new, 3),
                        jp.static_kind_col(shared, new, 3)):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n,instances", [(1, 1), (9, 3), (511, 2),
                                         (513, 24), (8191, 1), (8193, 192),
                                         (36800, 24), (100003, 192),
                                         (700001, 192), (201326592, 3)])
def test_scan_plan_covers_every_row_once(n, instances):
    """kernel.plan: tiles instance-major, each row of each instance in
    exactly one tile, one status word a tile, 16-row loads, whole warps."""
    p = tscan_kernel.plan(n, instances)
    assert p.threads % 32 == 0 and 32 <= p.threads <= 512
    assert p.rows_per_thread % 16 == 0 and p.rows_per_thread <= 128
    assert p.tile_rows == p.threads * p.rows_per_thread
    assert p.tiles == instances * p.tiles_per_instance == p.status_words
    # tile t: instance t // per, rows [(t % per) * tile, … + tile) ∩ [0, n)
    per = p.tiles_per_instance
    assert (per - 1) * p.tile_rows < n <= per * p.tile_rows
    if n * instances < 10**6:
        t = np.arange(p.tiles)
        inst, local = t // per, t % per
        assert np.all(np.diff(inst) >= 0)             # instance-major
        cover = np.zeros((instances, n), np.int64)
        for i, lo in zip(inst, local * p.tile_rows):
            cover[i, lo:lo + p.tile_rows] += 1
        assert np.all(cover == 1)


def test_scan_plan_limits():
    p = tscan_kernel.plan(36800, 65535)
    assert p.tiles == 65535 * p.tiles_per_instance
    with pytest.raises(ValueError, match="65535 instances"):
        tscan_kernel.plan(36800, 65536)
    p = tscan_kernel.plan(2**31 - 1, 1)
    assert p.tiles_per_instance == -(-(2**31 - 1) // p.tile_rows)
    with pytest.raises(ValueError, match="rows per instance"):
        tscan_kernel.plan(2**31, 1)
