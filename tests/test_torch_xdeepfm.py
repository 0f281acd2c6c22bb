"""xDeepFM serving in the PyTorch port against the JAX package: the
gather_rows and CIN ops (their plain versions on the CPU) against the
Pallas kernels in interpret mode, the copied config and data modules,
`XDeepFM.from_jax`, and the lookup, CIN and forward with and without the
kernels, at the smoke config."""
import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# small tensors: one intra-op thread, so the test workers running beside
# this one keep their cores
torch.set_num_threads(1)

from repro.configs import xdeepfm as j_configs  # noqa: E402
from repro.data.recsys import click_batches as j_click_batches  # noqa: E402
from repro.kernels.cin.ops import (cin_layer as j_cin_layer,  # noqa: E402
                                   cin_layer_reference)
from repro.kernels.embedding_bag.ops import \
    gather_rows as j_gather_rows  # noqa: E402
from repro.kernels.embedding_bag.ops import \
    gather_rows_reference  # noqa: E402
from repro.models.recsys import xdeepfm as jxd  # noqa: E402

from repro_torch.configs import xdeepfm as configs  # noqa: E402
from repro_torch.data.recsys import click_batches  # noqa: E402
from repro_torch.kernels.cin import kernel as cin_kernel  # noqa: E402
from repro_torch.kernels.cin.ops import cin_layer  # noqa: E402
from repro_torch.kernels.cin.ref import cin_layer_split_ref  # noqa: E402
from repro_torch.kernels.embedding_bag.ops import gather_rows  # noqa: E402
from repro_torch.models.recsys import xdeepfm as xd  # noqa: E402

RNG = np.random.default_rng(7)
CIN_TOL = dict(atol=5e-4, rtol=1e-4)        # tests/test_kernels.py's


@pytest.fixture(scope="module")
def smoke():
    """(config, JAX params, port model carried from them, one click batch of
    16)."""
    cfg, jcfg = configs.smoke(), j_configs.smoke()
    assert cfg.__dict__ == jcfg.__dict__
    params = jxd.init_params(jcfg, jax.random.PRNGKey(0))
    model = xd.XDeepFM.from_jax(cfg, params, device="cpu")
    batch = next(click_batches(cfg.vocab_sizes, cfg.n_dense, 16, seed=0))
    return cfg, jcfg, params, model, batch


def test_configs_vocab_and_data_copies():
    assert xd.default_vocab_sizes(39) == jxd.default_vocab_sizes(39)
    assert sum(xd.default_vocab_sizes(39)) == 26_367_531
    assert configs.full().__dict__ == j_configs.full().__dict__
    for cfg in (configs.full(), configs.smoke()):
        np.testing.assert_array_equal(xd.field_offsets(cfg),
                                      jxd.field_offsets(cfg))
    cfg = configs.smoke()
    mine = click_batches(cfg.vocab_sizes, cfg.n_dense, 32, seed=3,
                         n_batches=2)
    ref = j_click_batches(cfg.vocab_sizes, cfg.n_dense, 32, seed=3,
                          n_batches=2)
    for a, b in zip(mine, ref, strict=True):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_from_jax_carries_every_parameter(smoke):
    cfg, _, params, model, _ = smoke
    flat = {"embed": params["embed"], "lin_embed": params["lin_embed"],
            "dense_proj": params["dense_proj"], "cin_out": params["cin_out"]}
    for i, w in enumerate(params["cin"]):
        flat[f"cin.{i}"] = w
    for i, layer in enumerate(params["mlp"]):
        flat[f"mlp_w.{i}"], flat[f"mlp_b.{i}"] = layer["w"], layer["b"]
    mine = dict(model.named_parameters())
    assert mine.keys() == flat.keys()
    for name, p in mine.items():
        assert p.dtype == torch.float32 and not p.requires_grad, name
        np.testing.assert_array_equal(p.numpy(), np.asarray(flat[name]),
                                      err_msg=name)
    np.testing.assert_array_equal(model.offsets.numpy(),
                                  jxd.field_offsets(cfg))


def test_random_init_follows_the_reference_shapes():
    cfg = configs.smoke()
    shapes = jax.tree.map(lambda a: a.shape, jax.eval_shape(
        lambda k: jxd.init_params(cfg, k), jax.random.PRNGKey(0)))
    a = xd.XDeepFM.random(cfg, torch.Generator().manual_seed(0))
    b = xd.XDeepFM.random(cfg, torch.Generator().manual_seed(0))
    assert tuple(a.embed.shape) == shapes["embed"]
    assert [tuple(w.shape) for w in a.cin] == [tuple(s)
                                               for s in shapes["cin"]]
    assert [tuple(w.shape) for w in a.mlp_w] == [tuple(layer["w"])
                                                 for layer in shapes["mlp"]]
    for (n, p), (_, q) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(p, q), n
    batch = next(click_batches(cfg.vocab_sizes, cfg.n_dense, 4, seed=0))
    logits = a(torch.from_numpy(batch["sparse"]),
               torch.from_numpy(batch["dense"]), use_kernel=True)
    assert logits.shape == (4,) and bool(torch.isfinite(logits).all())


@pytest.mark.parametrize("V,D,N", [(500, 10, 64), (128, 128, 16),
                                   (1000, 17, 200), (300, 1, 70),
                                   (300, 3, 70), (300, 16, 70),
                                   (300, 33, 70)])
def test_gather_rows_equals_pallas_kernel(V, D, N):
    """Random ids in [0, V) and, after them, negative and out-of-range ids:
    the in-range rows equal the Pallas kernel's, and every row equals the
    reference's `jnp.take` (a negative id counts from the end, an id
    outside [-V, V) gives a row of NaN)."""
    table = RNG.normal(size=(V, D)).astype(np.float32)
    wild = np.array([-1, -V, V, -V - 1, 2 * V + 3, RNG.integers(-V, 0)])
    ids = np.concatenate([RNG.integers(0, V, N), wild]).astype(np.int32)
    out = gather_rows(torch.from_numpy(table), torch.from_numpy(ids))
    assert out.shape == (N + wild.shape[0], D)
    np.testing.assert_array_equal(out.numpy()[:N],
                                  np.asarray(j_gather_rows(table, ids[:N])))
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(gather_rows_reference(table,
                                                                   ids)))
    assert np.isnan(out.numpy()[N + 2:N + 5]).all()


def test_gather_rows_out_of_range_ids_follow_jnp_take():
    table = RNG.normal(size=(50, 6)).astype(np.float32)
    ids = np.array([0, 49, -1, -50, 50, -51, 7], np.int32)
    out = gather_rows(torch.from_numpy(table), torch.from_numpy(ids))
    np.testing.assert_array_equal(out.numpy(),
                                  np.asarray(gather_rows_reference(table,
                                                                   ids)))
    assert np.isnan(out.numpy()[[4, 5]]).all()


@pytest.mark.parametrize("B,H,F,D,K", [(12, 20, 39, 10, 50),
                                       (8, 39, 39, 10, 200),
                                       (16, 7, 13, 8, 20)])
def test_cin_layer_matches_pallas_kernel(B, H, F, D, K):
    xk = RNG.normal(size=(B, H, D)).astype(np.float32)
    x0 = RNG.normal(size=(B, F, D)).astype(np.float32)
    w = RNG.normal(size=(K, H, F)).astype(np.float32)
    out = cin_layer(*(torch.from_numpy(a) for a in (xk, x0, w))).numpy()
    assert out.shape == (B, K, D)
    np.testing.assert_allclose(out, np.asarray(j_cin_layer(xk, x0, w)),
                               **CIN_TOL)
    np.testing.assert_allclose(out, np.asarray(cin_layer_reference(xk, x0,
                                                                   w)),
                               **CIN_TOL)


@pytest.mark.parametrize("B,H,F,D,K", [(4, 39, 39, 10, 200),
                                       (4, 200, 39, 10, 200),
                                       (16, 7, 13, 8, 20)])
def test_cin_split_arithmetic_matches_jax(B, H, F, D, K):
    """The CUDA kernel's arithmetic (z and w split into bf16 hi and lo,
    three products into float32) at the served widths and at ragged ones,
    on inputs made as the on-card checks make them, against the JAX plain
    version and the Pallas kernel in interpret mode at the op's
    tolerance."""
    xk = RNG.normal(size=(B, H, D)).astype(np.float32)
    x0 = RNG.normal(size=(B, F, D)).astype(np.float32)
    w = (RNG.normal(size=(K, H, F)) / np.sqrt(H * F)).astype(np.float32)
    out = cin_layer_split_ref(*(torch.from_numpy(a)
                                for a in (xk, x0, w))).numpy()
    assert out.shape == (B, K, D) and out.dtype == np.float32
    np.testing.assert_allclose(out, np.asarray(cin_layer_reference(xk, x0,
                                                                   w)),
                               **CIN_TOL)
    np.testing.assert_allclose(out, np.asarray(j_cin_layer(xk, x0, w)),
                               **CIN_TOL)


@pytest.mark.parametrize("B,H,F,D,K", [(512, 39, 39, 10, 200),
                                       (512, 200, 39, 10, 200),
                                       (33, 200, 39, 10, 200),
                                       (16, 7, 13, 8, 20), (3, 1, 1, 1, 1),
                                       (5, 3, 4, 300, 9),
                                       (7, 5, 17, 3, 260),
                                       (6, 300, 120, 10, 210)])
def test_cin_plan_covers_every_output_once(B, H, F, D, K):
    """The blocks of `kernel.plan` (row tiles of whole examples, or of one
    example's dims when D exceeds the row tile, by column tiles; 64-row
    tiles where H + F leave no room for 128) cover every (b, d, k) of the
    output exactly once, each block within its row tile and the
    shared-memory limit."""
    p = cin_kernel.plan(B, H, F, D, K)
    assert p.rows in cin_kernel.ROWS and p.cols in cin_kernel.COLS
    assert p.examples * p.d_span <= p.rows
    assert p.smem == cin_kernel.smem_bytes(p.rows, p.cols, p.stages, H, F)
    assert p.smem <= cin_kernel.SMEM_LIMIT and p.stages >= 2
    hits = np.zeros((B, D, K), np.int32)
    for r in range(p.row_tiles):
        for c in range(p.col_tiles):
            b0, d0, k0 = p.tile(r, c)
            hits[b0:b0 + p.examples, d0:d0 + p.d_span, k0:k0 + p.cols] += 1
    assert (hits == 1).all()


def test_cin_plan_at_the_served_batches():
    """serve_p99 (512 requests) splits K = 200 into three column tiles of
    72, so that the 43 row tiles of 12 examples fill the card; serve_bulk
    (262,144) keeps one column tile of 200, so each z value is built once.
    A shape whose staged rows fit no block raises."""
    for h in (39, 200):
        p99 = cin_kernel.plan(512, h, 39, 10, 200)
        assert (p99.rows, p99.cols, p99.row_tiles, p99.col_tiles) == \
            (128, 72, 43, 3)
        assert p99.blocks >= 0.95 * cin_kernel.SMS
        bulk = cin_kernel.plan(262144, h, 39, 10, 200)
        assert (bulk.rows, bulk.cols, bulk.col_tiles) == (128, 200, 1)
        assert bulk.row_tiles == -(-262144 // 12)
    with pytest.raises(ValueError, match="fits in"):
        cin_kernel.plan(4, 900, 39, 10, 200)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_lookup_cin_and_forward_match_jax(smoke, use_kernel):
    cfg, jcfg, params, model, batch = smoke
    sparse = torch.from_numpy(batch["sparse"])
    dense = torch.from_numpy(batch["dense"])
    jsparse = jax.numpy.asarray(batch["sparse"])
    emb = model.embedding_lookup(sparse, use_kernel=use_kernel)
    jemb = jxd.embedding_lookup(params, jcfg, jsparse, use_kernel=use_kernel)
    np.testing.assert_array_equal(emb.numpy(), np.asarray(jemb))
    # the reference's init leaves each CIN layer's features about 1e-2 of
    # the previous layer's (layer 1 near 1e-3), far below the logits'
    # tolerance: hold each layer at a tolerance set by its own magnitude,
    # and again on embeddings scaled to unit variance at the op's tolerance
    for x0, atol in ((emb, None), (emb / emb.std(), CIN_TOL["atol"])):
        mine = model.cin_forward(x0, use_kernel=use_kernel).numpy()
        ref = np.asarray(jxd.cin_forward(params, jcfg,
                                         jax.numpy.asarray(x0.numpy()),
                                         use_kernel=use_kernel))
        assert mine.shape == ref.shape == (16, sum(cfg.cin_layers))
        start = 0
        for i, h in enumerate(cfg.cin_layers):
            a, b = mine[:, start:start + h], ref[:, start:start + h]
            scale = float(np.abs(b).max())
            assert scale > 0, f"CIN layer {i} is zero"
            np.testing.assert_allclose(
                a, b, rtol=CIN_TOL["rtol"],
                atol=1e-5 * scale if atol is None else atol,
                err_msg=f"CIN layer {i}")
            start += h
    logits = model(sparse, dense, use_kernel=use_kernel)
    assert logits.shape == (16,)
    np.testing.assert_allclose(
        logits.numpy(),
        np.asarray(jxd.forward(params, jcfg, jsparse,
                               jax.numpy.asarray(batch["dense"]),
                               use_kernel=use_kernel)),
        atol=1e-3, rtol=1e-4)


def test_retrieval_scores_match_jax(smoke):
    _, jcfg, params, model, _ = smoke
    q = RNG.normal(size=(jcfg.n_sparse * jcfg.embed_dim,)).astype(np.float32)
    ids = np.arange(0, 1000, 3)
    np.testing.assert_allclose(
        model.retrieval_scores(torch.from_numpy(q),
                               torch.from_numpy(ids)).numpy(),
        np.asarray(jxd.retrieval_scores(params, jcfg, jax.numpy.asarray(q),
                                        jax.numpy.asarray(ids))),
        atol=1e-6, rtol=1e-5)
