"""GNN serving in the PyTorch port against the JAX package: the segment_spmm
and bag_sum ops (their plain versions on the CPU) against the Pallas ops in
interpret mode and the reference oracles, the copied graph pipeline (bit
for bit), the SO(3) helpers, and GCN, EGNN, NequIP and Equiformer-v2
carried over by `from_jax` against the reference forwards."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so the test workers running beside
# this one keep their cores
torch.set_num_threads(1)

from repro.configs import egnn as j_egnn_cfg  # noqa: E402
from repro.configs import equiformer_v2 as j_eq_cfg  # noqa: E402
from repro.configs import gcn_cora as j_gcn_cfg  # noqa: E402
from repro.configs import nequip as j_nequip_cfg  # noqa: E402
from repro.data import graphs as j_graphs  # noqa: E402
from repro.kernels.embedding_bag.ops import bag_sum as j_bag_sum  # noqa: E402
from repro.kernels.embedding_bag.ops import bag_sum_reference  # noqa: E402
from repro.kernels.segment_spmm.ops import \
    segment_spmm as j_segment_spmm  # noqa: E402
from repro.kernels.segment_spmm.ops import \
    segment_spmm_reference  # noqa: E402
from repro.models.gnn import egnn as j_egnn  # noqa: E402
from repro.models.gnn import equiformer_v2 as j_eq  # noqa: E402
from repro.models.gnn import gcn as j_gcn  # noqa: E402
from repro.models.gnn import nequip as j_nequip  # noqa: E402
from repro.models.gnn import so3 as j_so3  # noqa: E402

from repro_torch.configs import egnn as egnn_cfg  # noqa: E402
from repro_torch.configs import equiformer_v2 as eq_cfg  # noqa: E402
from repro_torch.configs import gcn_cora as gcn_cfg  # noqa: E402
from repro_torch.configs import nequip as nequip_cfg  # noqa: E402
from repro_torch.data import graphs  # noqa: E402
from repro_torch.kernels.embedding_bag.ops import bag_sum  # noqa: E402
from repro_torch.kernels.segment_spmm import ops as seg_ops  # noqa: E402
from repro_torch.kernels.segment_spmm.kernel import PIECE  # noqa: E402
from repro_torch.kernels.segment_spmm.ops import (segment_plan,  # noqa: E402
                                                  segment_spmm)
from repro_torch.models.gnn import common, so3  # noqa: E402
from repro_torch.models.gnn.egnn import EGNN  # noqa: E402
from repro_torch.models.gnn.equiformer_v2 import EquiformerV2  # noqa: E402
from repro_torch.models.gnn.gcn import GCN  # noqa: E402
from repro_torch.models.gnn.nequip import NequIP  # noqa: E402

RNG = np.random.default_rng(7)
SPMM_TOL = {"float32": 1e-4, "bfloat16": 0.15}    # tests/test_kernels.py's
# float32 forwards: XLA and PyTorch sum the same float32 products in other
# orders (about 1e-6 relative per op). Measured worst |diff| / max |ref|:
# GCN 3.6e-7 (full_graph_sm) and 4.6e-7 (ogb_products), EGNN 2.1e-7
# (energies) and 3.0e-7 (positions), NequIP 1.8e-7, Equiformer-v2 1.6e-7;
# held at 1e-5 of the largest magnitude.
FWD_SHARE = 1e-5
# name: (port class, reference module, port config, reference config,
# graph shape)
MODELS = {
    "gcn-full_graph_sm": (GCN, j_gcn, lambda: gcn_cfg.full("full_graph_sm"),
                          lambda: j_gcn_cfg.full("full_graph_sm"),
                          "full_graph_sm"),
    "gcn-ogb_products": (GCN, j_gcn, lambda: gcn_cfg.full("ogb_products"),
                         lambda: j_gcn_cfg.full("ogb_products"),
                         "ogb_products"),
    "egnn": (EGNN, j_egnn, egnn_cfg.smoke, j_egnn_cfg.smoke, "molecule"),
    "nequip": (NequIP, j_nequip, nequip_cfg.smoke, j_nequip_cfg.smoke,
               "molecule"),
    "equiformer-v2": (EquiformerV2, j_eq, eq_cfg.smoke, j_eq_cfg.smoke,
                      "molecule"),
}
# segment sums per forward, per layer: GCN one per layer, EGNN two (the
# coordinate mean and the message sum), NequIP and Equiformer-v2 one
AGGREGATES_PER_LAYER = {"gcn": 1, "egnn": 2, "nequip": 1, "equiformer-v2": 1}


def _share_close(out, ref, share=FWD_SHARE, what=""):
    out, ref = np.asarray(out, np.float64), np.asarray(ref, np.float64)
    assert out.shape == ref.shape, what
    assert np.isfinite(out).all(), what
    top = np.abs(ref).max()
    np.testing.assert_allclose(out, ref, rtol=0, atol=share * top,
                               err_msg=what)


# ---------------------------------------------------------------------------
# the two ops
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("E,D,N,dt,live", [
    (100, 16, 50, "float32", 0.9), (1000, 64, 300, "float32", 0.9),
    (64, 7, 10, "float32", 0.9), (256, 32, 100, "bfloat16", 0.9),
    (515, 7, 131, "float32", 0.9), (300, 12, 40, "float32", 0.0),
])
def test_segment_spmm_equals_pallas_op(E, D, N, dt, live):
    """tests/test_kernels.py's sweep plus E and N off the TPU blocks and
    an all-masked case: the port's op (its plain version here) against the
    Pallas op in interpret mode and against `segment_spmm_reference`."""
    vals = RNG.normal(size=(E, D)).astype(np.float32)
    recv = RNG.integers(0, N, E).astype(np.int32)
    mask = RNG.uniform(size=E) < live
    jv = jnp.asarray(vals, dt)
    tv = torch.from_numpy(vals).to(getattr(torch, dt))
    out = segment_spmm(tv, torch.from_numpy(recv), torch.from_numpy(mask), N)
    assert out.dtype == tv.dtype and out.shape == (N, D)
    out = out.float().numpy()
    tol = SPMM_TOL[dt]
    for ref in (j_segment_spmm(jv, recv, mask, N),
                segment_spmm_reference(jv, recv, mask, N)):
        np.testing.assert_allclose(out, np.asarray(ref, np.float32),
                                   atol=tol, rtol=tol)
    if live == 0.0:
        assert not out.any()


def test_segment_spmm_drops_receivers_out_of_range():
    """As `jax.ops.segment_sum` drops them; masked NaN messages never
    reach the output."""
    vals = RNG.normal(size=(40, 5)).astype(np.float32)
    recv = RNG.integers(-3, 13, 40).astype(np.int32)
    mask = RNG.uniform(size=40) < 0.8
    vals[~mask] = np.nan
    out = segment_spmm(torch.from_numpy(vals), torch.from_numpy(recv),
                       torch.from_numpy(mask), 10)
    ref = segment_spmm_reference(np.where(mask[:, None], vals, 0), recv,
                                 mask, 10)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def _plan_case(case: str):
    """(receivers, mask, n_nodes) for a segment plan case, from numpy."""
    n = 40
    if case == "no_edges":
        return np.zeros(0, np.int32), np.zeros(0, bool), n
    e = 600
    recv = RNG.integers(0, n, e).astype(np.int32)
    mask = RNG.uniform(size=e) < 0.9
    if case == "all_masked":
        mask[:] = False
    elif case == "out_of_range":
        recv = RNG.integers(-5, n + 5, e).astype(np.int32)
        recv[:4] = [-1, n, np.iinfo(np.int32).min, np.iinfo(np.int32).max]
    elif case == "hub":
        # node 7 gets 3 PIECEs and a ragged tail of live edges
        recv = np.concatenate([recv, np.full(3 * PIECE + 17, 7, np.int32)])
        mask = np.concatenate([mask, np.ones(3 * PIECE + 17, bool)])
    elif case in ("degree_piece", "degree_piece_plus_1"):
        # node 5 gets exactly PIECE (or PIECE + 1) live edges, interleaved
        # with the others and with masked edges to it
        k = PIECE + (case == "degree_piece_plus_1")
        recv = np.where(recv == 5, 6, recv)
        recv = np.concatenate([recv, np.full(k + 9, 5, np.int32)])
        mask = np.concatenate([mask, np.ones(k + 9, bool)])
        mask[np.flatnonzero(recv == 5)[:9]] = False
        perm = RNG.permutation(recv.shape[0])
        recv, mask = recv[perm], mask[perm]
    elif case == "sorted":
        recv = np.sort(np.concatenate([recv, np.full(2 * PIECE, 3, np.int32)]))
        mask = RNG.uniform(size=recv.shape[0]) < 0.9
    return recv, mask, n


def _assert_pieces(plan, offsets, piece):
    """The plan's pieces cover every range longer than ``piece`` once, in
    edge order, each of at most ``piece`` edges."""
    split = np.flatnonzero(np.diff(offsets) > piece)
    np.testing.assert_array_equal(plan.split_node.numpy(), split)
    sp = plan.split_pieces.numpy()
    assert sp[0] == 0 and sp[-1] == plan.n_pieces
    starts, nodes = plan.piece_start.numpy(), plan.piece_node.numpy()
    for s, v in enumerate(split):
        at = offsets[v]
        for p in range(sp[s], sp[s + 1]):
            assert nodes[p] == v and starts[p] == at
            end = min(at + piece, offsets[v + 1])
            assert 0 < end - at <= piece
            at = end
        assert at == offsets[v + 1]


PLAN_CASES = ["masked_10pct", "all_masked", "no_edges", "out_of_range", "hub",
              "degree_piece", "degree_piece_plus_1", "sorted"]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_segment_plan_matches_numpy(case):
    """The plan's order is numpy's stable argsort of the live receivers
    (masked and out-of-range edges last), its offsets numpy's searchsorted
    of the sorted live receivers, and its pieces cover every range longer
    than PIECE once, in edge order, each of at most PIECE edges."""
    recv, mask, n = _plan_case(case)
    builds = segment_plan.builds
    plan = segment_plan(torch.from_numpy(recv), torch.from_numpy(mask), n,
                        assume_sorted=case == "sorted")
    assert segment_plan.builds == builds + 1
    assert (plan.n_edges, plan.n_nodes, plan.piece) == (recv.shape[0], n,
                                                        PIECE)
    live = mask & (recv >= 0) & (recv < n)
    keys = np.where(live, recv, np.iinfo(np.int32).max)
    order = np.argsort(keys, kind="stable")
    assert plan.order.dtype == torch.int32
    np.testing.assert_array_equal(plan.order.numpy(), order)
    offsets = np.searchsorted(keys[order][:live.sum()], np.arange(n + 1))
    assert plan.offsets.dtype == torch.int64
    np.testing.assert_array_equal(plan.offsets.numpy(), offsets)
    _assert_pieces(plan, offsets, PIECE)
    deg = np.diff(offsets)
    if case == "hub":
        assert plan.n_split == 1 and plan.n_pieces == 4
    if case.startswith("degree_piece"):
        assert deg[5] == PIECE + (case == "degree_piece_plus_1")
        assert plan.n_split == (case == "degree_piece_plus_1")


@pytest.mark.parametrize("piece", [1, 5, 64])
def test_piece_table_cuts_ranges_at_any_piece(piece):
    """`piece_table` (which the plan cuts at PIECE, and which the tuning
    sweep cuts at other sizes) covers each longer range once, in order."""
    recv, mask, n = _plan_case("hub")
    plan = segment_plan(torch.from_numpy(recv), torch.from_numpy(mask), n)
    table = seg_ops.piece_table(plan.offsets, piece)
    assert table["piece"] == piece
    _assert_pieces(dataclasses.replace(plan, **table),
                   plan.offsets.numpy(), piece)


@pytest.mark.parametrize("case", PLAN_CASES)
def test_segment_spmm_with_plan_equals_pallas_op(case):
    """`segment_spmm(..., plan=segment_plan(...))` on the CPU runs the
    plain version that reads the plan as the kernel does: it equals the
    Pallas op in interpret mode and `segment_spmm_reference` within 1e-4."""
    recv, mask, n = _plan_case(case)
    vals = RNG.normal(size=(recv.shape[0], 12)).astype(np.float32)
    tr, tm = torch.from_numpy(recv), torch.from_numpy(mask)
    plan = segment_plan(tr, tm, n, assume_sorted=case == "sorted")
    out = segment_spmm(torch.from_numpy(vals), tr, tm, n, plan=plan)
    assert out.dtype == torch.float32 and out.shape == (n, 12)
    refs = [segment_spmm_reference(vals, recv, mask, n)]
    if recv.shape[0]:      # the Pallas op's grid needs an edge block
        refs.append(j_segment_spmm(vals, recv, mask, n,
                                   assume_sorted=case == "sorted"))
    else:
        assert not out.any()
    for ref in refs:
        np.testing.assert_allclose(out.numpy(), np.asarray(ref),
                                   atol=SPMM_TOL["float32"],
                                   rtol=SPMM_TOL["float32"])


@pytest.mark.parametrize("V,D,B,bag,weighted", [
    (500, 10, 16, 4, True), (200, 32, 8, 7, True), (300, 17, 5, 39, False)])
def test_bag_sum_equals_pallas_op(V, D, B, bag, weighted):
    table = RNG.normal(size=(V, D)).astype(np.float32)
    ids = RNG.integers(0, V, (B, bag)).astype(np.int32)
    w = RNG.normal(size=(B, bag)).astype(np.float32) if weighted else None
    out = bag_sum(torch.from_numpy(table), torch.from_numpy(ids),
                  None if w is None else torch.from_numpy(w))
    assert out.dtype == torch.float32 and out.shape == (B, D)
    for ref in (j_bag_sum(table, ids, w), bag_sum_reference(table, ids, w)):
        np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5)


def test_bag_sum_bf16_table_and_jnp_take_ids():
    """A bf16 table is summed in float32 and rounded once; ids follow
    jnp.take as `gather_rows` does (negative wraps, out of range is NaN)."""
    table = RNG.normal(size=(50, 6)).astype(np.float32)
    ids = np.array([[0, 49, -1], [-50, 7, 7], [3, 50, 1]], np.int32)
    w = RNG.normal(size=(3, 3)).astype(np.float32)
    tb = torch.from_numpy(table).to(torch.bfloat16)
    out = bag_sum(tb, torch.from_numpy(ids), torch.from_numpy(w))
    assert out.dtype == torch.bfloat16
    exp = (tb.float().numpy()[ids[:2] % 50] * w[:2, :, None]).sum(1)
    np.testing.assert_allclose(out[:2].float().numpy(), exp, rtol=2 ** -8,
                               atol=1e-6)
    assert torch.isnan(out[2]).all()


class _Elsewhere(torch.Tensor):
    """A CPU tensor that reports a device that is neither the CPU, the card
    nor meta (each of which has its own branch in the ops)."""

    @property
    def device(self):
        return torch.device("xla")


def test_kernel_ops_raise_off_cpu_instead_of_falling_back():
    """Off the CPU and off the meta device (its own branch, held in
    tests/test_torch_dryrun.py) the ops go to the kernels' launchers,
    which refuse anything that is not a CUDA tensor."""
    meta = torch.device("meta")
    vals = torch.zeros((8, 4)).as_subclass(_Elsewhere)
    recv = torch.zeros((8,), dtype=torch.int32).as_subclass(_Elsewhere)
    mask = torch.ones((8,), dtype=torch.bool).as_subclass(_Elsewhere)
    with pytest.raises(ValueError, match="CUDA tensor"):
        segment_spmm(vals, recv, mask, 3)
    # a plan is taken only for its E and N, with the very receivers and
    # mask it was built from, on any device
    r = torch.zeros((8,), dtype=torch.int32)
    m = torch.ones((8,), dtype=torch.bool)
    plan = segment_plan(r, m, 3)
    with pytest.raises(ValueError, match="CUDA tensor"):
        segment_spmm(vals, r, m, 3, plan=plan)
    for e, n in ((9, 3), (8, 4)):
        for device in (meta, torch.device("cpu")):
            with pytest.raises(ValueError, match="segment plan built for"):
                segment_spmm(torch.zeros((e, 4), device=device), r, m, n,
                             plan=plan)
    for other in ((r, m.clone()), (r.clone(), m), (r, m & (r > 0))):
        for device in (meta, torch.device("cpu")):
            with pytest.raises(ValueError, match="built from other"):
                segment_spmm(torch.zeros((8, 4), device=device), *other, 3,
                             plan=plan)
    ids = torch.zeros((2, 3), dtype=torch.int32).as_subclass(_Elsewhere)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bag_sum(vals, ids)
    with pytest.raises(ValueError, match="CUDA tensor"):
        bag_sum(vals, ids, torch.ones((2, 3)).as_subclass(_Elsewhere))


# ---------------------------------------------------------------------------
# configs, graph pipeline, SO(3) helpers
# ---------------------------------------------------------------------------

def test_config_copies():
    for mine, ref in ((gcn_cfg, j_gcn_cfg), (egnn_cfg, j_egnn_cfg),
                      (nequip_cfg, j_nequip_cfg), (eq_cfg, j_eq_cfg)):
        assert mine.SHAPES == ref.SHAPES and mine.FAMILY == ref.FAMILY
        assert dataclasses.asdict(mine.smoke()) == \
            dataclasses.asdict(ref.smoke())
    assert gcn_cfg.SHAPE_DIMS == j_gcn_cfg.SHAPE_DIMS
    for shape in gcn_cfg.SHAPES:
        assert dataclasses.asdict(gcn_cfg.full(shape)) == \
            dataclasses.asdict(j_gcn_cfg.full(shape))
    for mine, ref in ((egnn_cfg, j_egnn_cfg), (nequip_cfg, j_nequip_cfg),
                      (eq_cfg, j_eq_cfg)):
        assert dataclasses.asdict(mine.full()) == \
            dataclasses.asdict(ref.full())


@pytest.mark.parametrize("shape", ["full_graph_sm", "minibatch_lg",
                                   "ogb_products", "molecule"])
def test_graph_batches_equal_the_reference(shape):
    dims = gcn_cfg.SHAPE_DIMS[shape]
    g = graphs.make_graph_batch(shape, **dims, seed=3, reduced=True,
                                device="cpu")
    jg = j_graphs.make_graph_batch(shape, **dims, seed=3, reduced=True)
    assert g.n_graphs == jg.n_graphs and g.device == torch.device("cpu")
    for f in (f.name for f in dataclasses.fields(g) if f.name != "n_graphs"):
        a, b = getattr(g, f), np.asarray(getattr(jg, f))
        assert a.numpy().dtype == b.dtype, f
        np.testing.assert_array_equal(a.numpy(), b, err_msg=f)
    assert graphs.GNN_SHAPE_SIZES == j_graphs.GNN_SHAPE_SIZES


def test_sampler_and_csr_copies():
    s, r = graphs.synthetic_graph(500, 3000, seed=5)
    js, jr = j_graphs.synthetic_graph(500, 3000, seed=5)
    np.testing.assert_array_equal(s, js)
    np.testing.assert_array_equal(r, jr)
    csr = graphs.CSRGraph.from_edges(s, r, 500)
    jcsr = j_graphs.CSRGraph.from_edges(js, jr, 500)
    np.testing.assert_array_equal(csr.indptr, jcsr.indptr)
    np.testing.assert_array_equal(csr.indices, jcsr.indices)
    seeds = np.arange(0, 500, 37)
    a = graphs.neighbor_sample(csr, seeds, [5, 3], np.random.default_rng(1))
    b = j_graphs.neighbor_sample(jcsr, seeds, [5, 3],
                                 np.random.default_rng(1))
    for x, y in zip(a, b, strict=True):
        np.testing.assert_array_equal(x, y)


def test_so3_helpers_equal_the_reference():
    L = 6
    for l1 in range(L + 1):
        for l2 in range(L + 1):
            for l3 in range(abs(l1 - l2), min(l1 + l2, L) + 1):
                np.testing.assert_array_equal(so3.real_cg(l1, l2, l3),
                                              j_so3.real_cg(l1, l2, l3))
    assert [so3.irrep_dim(k) for k in range(7)] == \
        [j_so3.irrep_dim(k) for k in range(7)]
    assert so3.lm_index(3, -2) == j_so3.lm_index(3, -2)
    vec = RNG.normal(size=(40, 3)).astype(np.float32)
    vec[0] = [0.0, 0.0, 1.5]                     # on the z axis
    tv = torch.from_numpy(vec)
    np.testing.assert_allclose(
        so3.spherical_harmonics(tv, L).numpy(),
        np.asarray(jax.jit(j_so3.spherical_harmonics, static_argnums=1)(
            jnp.asarray(vec), L)),
        atol=2e-5)
    rot = so3.rotation_to_z(tv)
    jrot = jax.jit(j_so3.rotation_to_z)(jnp.asarray(vec))
    np.testing.assert_allclose(rot.numpy(), np.asarray(jrot), atol=1e-6)
    ds = so3.wigner_d_blocks(rot, L)
    jds = jax.jit(j_so3.wigner_d_blocks, static_argnums=1)(jrot, L)
    for l, (d, jd) in enumerate(zip(ds, jds, strict=True)):
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), atol=1e-5,
                                   err_msg=f"l={l}")
    feat = RNG.normal(size=(40, (L + 1) ** 2, 4)).astype(np.float32)
    np.testing.assert_allclose(
        so3.rotate_irreps(torch.from_numpy(feat), ds, L).numpy(),
        np.asarray(j_so3.rotate_irreps(jnp.asarray(feat), jds, L)),
        atol=1e-4)


def test_common_helpers_equal_the_reference():
    """edge_softmax, degrees, aggregate(reduce="mean") and graph_targets
    against `repro.models.gnn.common` on a batch with masked edges."""
    from repro.models.gnn import common as jc
    dims = gcn_cfg.SHAPE_DIMS["molecule"]
    g = graphs.make_graph_batch("molecule", **dims, seed=1, reduced=True,
                                device="cpu")
    jg = j_graphs.make_graph_batch("molecule", **dims, seed=1, reduced=True)
    e, n = g.receivers.shape[0], g.node_mask.shape[0]
    mask = RNG.uniform(size=e) < 0.8
    scores = RNG.normal(size=(e, 3)).astype(np.float32) * 4
    msgs = RNG.normal(size=(e, 4, 2)).astype(np.float32)
    tm = torch.from_numpy(mask)
    np.testing.assert_allclose(
        common.edge_softmax(torch.from_numpy(scores), g.receivers, tm,
                            n).numpy(),
        np.asarray(jc.edge_softmax(jnp.asarray(scores), jg.receivers,
                                   jnp.asarray(mask), n)), atol=1e-6)
    np.testing.assert_array_equal(
        common.degrees(g.receivers, tm, n).numpy(),
        np.asarray(jc.degrees(jg.receivers, jnp.asarray(mask), n)))
    for use_kernel in (True, False):
        np.testing.assert_allclose(
            common.aggregate(torch.from_numpy(msgs), g.receivers, tm, n,
                             reduce="mean", use_kernel=use_kernel).numpy(),
            np.asarray(jc.aggregate(jnp.asarray(msgs), jg.receivers,
                                    jnp.asarray(mask), n, reduce="mean")),
            atol=1e-6)
    np.testing.assert_allclose(common.graph_targets(g).numpy(),
                               np.asarray(jc.graph_targets(jg)), atol=1e-6)


# ---------------------------------------------------------------------------
# the four models
# ---------------------------------------------------------------------------

def _model_case(name):
    cls, jmod, make_cfg, make_jcfg, shape = MODELS[name]
    cfg, jcfg = make_cfg(), make_jcfg()
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    dims = gcn_cfg.SHAPE_DIMS[shape]
    g = graphs.make_graph_batch(shape, **dims, seed=0, reduced=True,
                                device="cpu")
    jg = j_graphs.make_graph_batch(shape, **dims, seed=0, reduced=True)
    params = jax.jit(jmod.init_params, static_argnums=0)(
        jcfg, jax.random.PRNGKey(0))
    return cls, jmod, cfg, jcfg, g, jg, params


@pytest.fixture(scope="module", params=sorted(MODELS))
def case(request):
    return (request.param, *_model_case(request.param))


def test_from_jax_carries_every_parameter(case):
    name, cls, _, cfg, _, _, _, params = case
    model = cls.from_jax(cfg, params, device="cpu")
    leaves = jax.tree.leaves(params)
    mine = [p for p in model.parameters() if p.numel()]
    assert len(mine) == len(leaves), name
    assert sorted(float(np.asarray(x, np.float64).sum()) for x in leaves) \
        == sorted(float(p.double().sum()) for p in mine)
    for p in model.parameters():
        assert p.dtype == torch.float32 and not p.requires_grad


def test_forward_matches_reference(case):
    """Each model's forward, through `aggregate`'s op and through its
    plain version, against the reference forward on the same batch."""
    name, cls, jmod, cfg, jcfg, g, jg, params = case
    model = cls.from_jax(cfg, params, device="cpu")
    # jit: the reference's eager op-by-op dispatch takes 10 s here
    ref = jax.jit(jmod.forward, static_argnums=1)(params, jcfg, jg)
    builds = segment_plan.builds
    outs = [model(g), model(g, use_kernel=False)]
    assert segment_plan.builds == builds + 1, name   # one per forward
    for out in outs:
        if name == "egnn":
            _share_close(out[0].numpy(), ref[0], what=f"{name} energy")
            _share_close(out[1].numpy(), ref[1], what=f"{name} positions")
        else:
            _share_close(out.numpy(), ref, what=name)
    if name.startswith("gcn"):
        assert outs[0].shape == (g.node_feat.shape[0], cfg.n_classes)
    elif name == "egnn":
        assert outs[0][0].shape == (g.n_graphs,)
    else:
        assert outs[0].shape == (g.n_graphs,)


def test_forward_builds_one_plan_for_its_segment_sums(case, monkeypatch):
    """With the kernel, a forward builds one segment plan and hands it to
    every `aggregate` call (each sums through the plain version that reads
    the plan); the plain path builds none."""
    name, cls, _, cfg, _, g, _, params = case
    model = cls.from_jax(cfg, params, device="cpu")
    calls = []
    plain = seg_ops.segment_spmm_plan_ref
    monkeypatch.setattr(seg_ops, "segment_spmm_plan_ref",
                        lambda *a: calls.append(1) or plain(*a))
    expected = AGGREGATES_PER_LAYER[
        "gcn" if name.startswith("gcn") else name] * cfg.n_layers
    builds = segment_plan.builds
    model(g)
    assert segment_plan.builds == builds + 1, name
    assert len(calls) == expected, name
    model(g, use_kernel=False)
    assert segment_plan.builds == builds + 1 and len(calls) == expected


def test_random_init_follows_the_reference_shapes(case):
    name, cls, jmod, cfg, jcfg, g, _, _ = case
    shapes = [tuple(s.shape) for s in jax.tree.leaves(jax.eval_shape(
        lambda k: jmod.init_params(jcfg, k), jax.random.PRNGKey(0)))]
    a = cls.random(cfg, torch.Generator().manual_seed(0))
    b = cls.random(cfg, torch.Generator().manual_seed(0))
    mine = [tuple(p.shape) for p in a.parameters() if p.numel()]
    assert sorted(mine) == sorted(shapes), name
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    out = a(g)
    out = out[0] if isinstance(out, tuple) else out
    assert bool(torch.isfinite(out).all())


def test_equiformer_v2_energy_is_rotation_invariant():
    """The reference's invariance test (tests/test_models_gnn.py) on the
    port: a random rotation and translation of the positions leaves the
    energies unchanged within 1e-4."""
    _, _, cfg, jcfg, g, _, params = _model_case("equiformer-v2")
    cfg = dataclasses.replace(cfg, l_max=4)
    params = j_eq.init_params(dataclasses.replace(jcfg, l_max=4),
                              jax.random.PRNGKey(1))
    model = EquiformerV2.from_jax(cfg, params, device="cpu")
    q, _ = np.linalg.qr(np.random.default_rng(3).normal(size=(3, 3)))
    if np.linalg.det(q) < 0:
        q[:, 0] *= -1
    moved = dataclasses.replace(
        g, positions=g.positions @ torch.from_numpy(q.T.astype(np.float32))
        + 1.5)
    e1, e2 = model(g), model(moved)
    assert float((e1 - e2).abs().max()) < 1e-4


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        graphs.make_graph_batch("molecule", d_feat=16, n_classes=4,
                                reduced=True)          # device defaults to cuda
    for name in sorted(MODELS):
        cls, _, make_cfg, _, _ = MODELS[name]
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            cls.from_jax(make_cfg(), {})
