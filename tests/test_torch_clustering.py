"""WawPart's query clustering in the PyTorch port against the JAX package:
the Jaccard kernel's op (its plain version on the CPU) against the Pallas
kernel in interpret mode and the jnp reference, the distance matrix's
kernel path, `linkage_torch` against `linkage_jax`, and the partition
taken from the kernel's distances."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so the test workers running beside
# this one keep their cores
torch.set_num_threads(1)

from repro.core.distance import \
    jaccard_distance_matrix as j_distance_matrix  # noqa: E402
from repro.core.hac import linkage_jax  # noqa: E402
from repro.core.partitioner import wawpart_partition as j_wawpart  # noqa: E402
from repro.kernels.jaccard.ops import (jaccard_distance as j_jaccard,  # noqa: E402
                                       jaccard_distance_reference)
from repro.kg import generator as j_gen  # noqa: E402
from repro.kg import workloads as j_work  # noqa: E402

from repro_torch.core.distance import (feature_matrix,  # noqa: E402
                                       jaccard_distance_matrix)
from repro_torch.core.hac import LINKAGES, linkage_torch  # noqa: E402
from repro_torch.core.partitioner import wawpart_partition  # noqa: E402
from repro_torch.kernels.jaccard import kernel as jaccard_kernel  # noqa: E402
from repro_torch.kernels.jaccard.ops import jaccard_distance  # noqa: E402
from repro_torch.kernels.jaccard.ref import jaccard_pack_ref  # noqa: E402
from repro_torch.kg import generator, workloads  # noqa: E402

RNG = np.random.default_rng(7)

WORKLOADS = {
    "lubm": (lambda w: w.lubm_queries(),
             lambda g: g.generate_lubm(1, scale=0.05, seed=0)),
    "bsbm": (lambda w: w.bsbm_queries(),
             lambda g: g.generate_bsbm(120, seed=0)),
}


def _random_distances(q: int, f: int, seed: int) -> np.ndarray:
    m = (np.random.default_rng(seed).uniform(size=(q, f)) < 0.3)
    return jaccard_distance(torch.from_numpy(m.astype(np.float32))).numpy()


@pytest.mark.parametrize("q,f", [(3, 5), (14, 23), (64, 64), (130, 257)])
def test_jaccard_op_equals_pallas_kernel_and_reference(q, f):
    m = (RNG.uniform(size=(q, f)) < 0.3).astype(np.float32)
    out = jaccard_distance(torch.from_numpy(m))
    assert out.dtype == torch.float32 and out.shape == (q, q)
    np.testing.assert_array_equal(out.numpy(), np.asarray(j_jaccard(m)))
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(jaccard_distance_reference(m)))


def _rows_with_ties(q: int, f: int, seed: int) -> np.ndarray:
    """A 0/1 matrix with empty rows and duplicated rows."""
    m = (np.random.default_rng(seed).uniform(size=(q, f)) < 0.3)
    m = m.astype(np.float32)
    m[::5] = 0.0
    if q > 2:
        m[1::7] = m[2]
        m[-1] = m[0]
    return m


@pytest.mark.parametrize("q,f", [(1, 1), (9, 15), (40, 17), (130, 33)])
def test_jaccard_op_with_empty_and_duplicate_rows_equals_pallas(q, f):
    """Empty feature sets (distance 0 to each other, 1 to any other set)
    and identical rows (distance 0): bit-equal to the Pallas kernel in
    interpret mode, and symmetric."""
    m = _rows_with_ties(q, f, seed=q)
    out = jaccard_distance(torch.from_numpy(m)).numpy()
    np.testing.assert_array_equal(out, np.asarray(j_jaccard(m)))
    np.testing.assert_array_equal(out, out.T)
    if q >= 9:
        assert out[0, 5] == 0.0 and out[2, 1] == 0.0 and out[0, -1] == 0.0


@pytest.mark.parametrize("f", [1, 15, 17, 4859])
def test_jaccard_pack_ref_matches_numpy(f):
    """The pack pass: an int8 copy zero-padded to 16-byte rows (4,864
    columns at F = 4,859) and the int32 row counts."""
    m = _rows_with_ties(23, f, seed=f)
    packed, counts = jaccard_pack_ref(torch.from_numpy(m))
    fp = -(-f // 16) * 16
    assert jaccard_kernel.packed_width(f) == fp
    assert packed.dtype == torch.int8 and packed.shape == (23, fp)
    want = np.zeros((23, fp), np.int8)
    want[:, :f] = m
    np.testing.assert_array_equal(packed.numpy(), want)
    assert counts.dtype == torch.int32
    np.testing.assert_array_equal(counts.numpy(), m.sum(axis=1))
    assert jaccard_kernel.packed_width(4859) == 4864


@pytest.mark.parametrize("q", [1, 127, 128, 129, 16380])
def test_jaccard_triangle_covers_each_upper_tile_once(q):
    """The product's blocks map to the tiles (i, j), i <= j, of the
    (Q / 128)^2 grid, each once, consecutive blocks sharing tile j."""
    t = -(-q // jaccard_kernel.TILE)
    n = jaccard_kernel.n_tiles(q)
    assert n == t * (t + 1) // 2
    tiles = [jaccard_kernel.triangle_tile(b) for b in range(n)]
    assert sorted(tiles) == [(i, j) for i in range(t) for j in range(i, t)]
    assert all(a[1] <= b[1] for a, b in zip(tiles, tiles[1:]))


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_distance_matrix_kernel_path(name):
    make_queries, _ = WORKLOADS[name]
    d = jaccard_distance_matrix(make_queries(workloads), use_kernel=True,
                                device="cpu")
    jd = j_distance_matrix(make_queries(j_work), use_kernel=True)
    assert d.dtype == np.float32
    np.testing.assert_array_equal(d, jd)
    np.testing.assert_allclose(d, jaccard_distance_matrix(
        make_queries(workloads)), atol=1e-6)


@pytest.mark.parametrize("linkage", LINKAGES)
@pytest.mark.parametrize("case", ["lubm", "bsbm", "lubm-420", "random-90"])
def test_linkage_torch_matches_linkage_jax(case, linkage):
    if case in WORKLOADS:
        dist = jaccard_distance_matrix(WORKLOADS[case][0](workloads),
                                       use_kernel=True, device="cpu")
    elif case == "lubm-420":     # 30 parameterised copies: many exact ties
        qs = [q for u in range(6) for d in range(5)
              for q in workloads.lubm_queries(u, d)]
        dist = jaccard_distance_matrix(qs, use_kernel=True, device="cpu")
    else:
        dist = _random_distances(90, 17, seed=3)
    z = linkage_torch(dist, linkage, device="cpu")
    jz = linkage_jax(dist, linkage)
    assert z.dtype == jz.dtype == np.float64 and z.shape == jz.shape
    if linkage == "average":
        np.testing.assert_array_equal(z[:, [0, 1, 3]], jz[:, [0, 1, 3]])
        np.testing.assert_allclose(z[:, 2], jz[:, 2], rtol=0, atol=1e-6)
    else:
        np.testing.assert_array_equal(z, jz)


def test_linkage_torch_leaves_its_input_alone():
    dist = _random_distances(12, 6, seed=1)
    before = dist.copy()
    linkage_torch(dist, "single", device="cpu")
    linkage_torch(torch.from_numpy(dist), "average", device="cpu")
    np.testing.assert_array_equal(dist, before)
    assert linkage_torch(dist[:1, :1], device="cpu").shape == (0, 4)
    with pytest.raises(ValueError, match="unknown linkage"):
        linkage_torch(dist, "ward", device="cpu")


def _shards(part) -> dict[str, int]:
    """unit -> shard, keyed by the unit's repr (each package has its own
    DataUnit class)."""
    return {repr(u): s for u, s in part.unit_shard.items()}


@pytest.mark.parametrize("name", sorted(WORKLOADS))
def test_partition_from_kernel_distances(name):
    make_queries, make_store = WORKLOADS[name]
    qs, jqs = make_queries(workloads), make_queries(j_work)
    st, jst = make_store(generator), make_store(j_gen)
    part = wawpart_partition(st, qs, n_shards=3, dist_matrix=(
        jaccard_distance_matrix(qs, use_kernel=True, device="cpu")))
    jpart = j_wawpart(jst, jqs, n_shards=3,
                      dist_matrix=j_distance_matrix(jqs, use_kernel=True))
    assert _shards(part) == _shards(jpart)
    assert part.meta["labels"] == jpart.meta["labels"]
    # the same partition as the default numpy distances
    host = wawpart_partition(st, qs, n_shards=3)
    assert part.unit_shard == host.unit_shard
    assert part.meta["labels"] == host.meta["labels"]
    np.testing.assert_array_equal(part.assign_triples(),
                                  jpart.assign_triples())


def test_feature_matrix_of_a_production_workload_is_sparse():
    """The membership matrix the chip run clusters: 16,380 instances of the
    14 LUBM templates, about 3.3 features each."""
    qs = [q for u in range(78) for d in range(15)
          for q in workloads.lubm_queries(u, d)]
    m, feats = feature_matrix(qs)
    assert m.shape == (16380, len(feats)) == (16380, 4859)
    assert set(np.unique(m)) == {0.0, 1.0}
    assert 3.2 < m.sum(axis=1).mean() < 3.4
