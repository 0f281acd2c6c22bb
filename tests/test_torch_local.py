"""The port's per-query primitives (`repro_torch.engine.local`) against the
JAX package's (`repro.engine.local`, backend "jnp"), bit for bit: matches,
tables and masks including their dead rows, and the overflow flags. Inputs
are numpy arrays from a seed; both port backends run ("torch", and "cuda",
whose kernel ops use their plain versions on CPU tensors)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# tiny tensors: one intra-op thread, so the test workers running beside
# this one keep their cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.engine import local as jlocal  # noqa: E402

from repro_torch.engine import local, primitives  # noqa: E402

BACKENDS = ("torch", "cuda")

# the reference functions, jitted with their static arguments (one compile
# per case where eager jnp compiles every op)
j_scan = jax.jit(jlocal.scan_shard, static_argnums=(5, 6))
j_join = jax.jit(jlocal.join_step, static_argnums=(4, 5))
j_sorted = jax.jit(jlocal.join_step_sorted, static_argnums=(4, 5),
                   static_argnames=("max_per_row",))


def _np(*xs):
    return tuple(np.asarray(x) for x in xs)


def _t(*xs):
    return tuple(torch.from_numpy(np.ascontiguousarray(x)) for x in xs)


def _equal(port, ref):
    assert len(port) == len(ref)
    for a, b in zip(port, ref):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _shard(rng, n, hi=6):
    triples = rng.integers(0, hi, (n, 3)).astype(np.int32)
    triples[rng.random(n) < 0.1] = -1              # padded rows
    valid = (triples[:, 0] >= 0) & (rng.random(n) < 0.9)
    return triples, valid


# (s, p, o, eqs): wildcards, constants, never-match, intra-pattern equality
PATTERNS = [(-1, -1, -1, ()), (-1, 2, -1, ()), (1, -1, 3, ()),
            (-1, -1, -1, ((0, 2),)), (-1, 1, -1, ((0, 1), (1, 2))),
            (-1, -2, -1, ()), (5, 5, 5, ())]


@pytest.mark.parametrize("n", [1, 40, 300])
def test_scan_shard_matches_the_reference(n):
    rng = np.random.default_rng(n)
    triples, valid = _shard(rng, n)
    overflows = set()
    for s, p, o, eqs in PATTERNS:
        # caps below and above the hits, at the shard's rows and past them
        for cap in (1, 8, n, 2 * n + 64):
            ref = _np(*j_scan(jnp.asarray(triples),
                                         jnp.asarray(valid), s, p, o, eqs,
                                         cap))
            overflows.add(bool(ref[2]))
            for backend in BACKENDS:
                out = local.scan_shard(*_t(triples, valid), s, p, o, eqs,
                                       cap, backend=backend)
                _equal(out, ref)
    assert overflows == ({False, True} if n > 1 else {False, True} & {
        False, bool(valid.any())})
    empty = np.zeros_like(valid)                 # no valid row at all
    for cap in (1, n + 5):
        ref = _np(*j_scan(jnp.asarray(triples), jnp.asarray(empty), -1, -1,
                          -1, (), cap))
        for backend in BACKENDS:
            _equal(local.scan_shard(*_t(triples, empty), -1, -1, -1, (), cap,
                                    backend=backend), ref)


def test_scan_shard_batched_over_shards_and_params():
    """(B, 1) patterns against (S, N, 3) shards: every (request, shard)
    instance equals the reference's scan of that shard."""
    rng = np.random.default_rng(7)
    S, N, B, cap = 3, 50, 4, 16
    shards = [_shard(rng, N) for _ in range(S)]
    triples = np.stack([t for t, _ in shards])
    valid = np.stack([v for _, v in shards])
    objs = np.asarray([0, 2, 4, -1], np.int32)
    for backend in BACKENDS:
        m, mm, ovf = local.scan_shard(
            *_t(triples, valid), -1, 1, torch.from_numpy(objs)[:, None], (),
            cap, backend=backend)
        assert m.shape == (B, S, cap, 3) and ovf.shape == (B, S)
        for b in range(B):
            for s in range(S):
                ref = _np(*j_scan(
                    jnp.asarray(triples[s]), jnp.asarray(valid[s]), -1, 1,
                    int(objs[b]), (), cap))
                _equal((m[b, s], mm[b, s], ovf[b, s]), ref)


def _join_inputs(rng, R, V, C, live=0.6, mlive=0.8, hi=5):
    table = rng.integers(0, hi, (R, V)).astype(np.int32)
    tmask = rng.random(R) < live
    table[~tmask] = rng.integers(-1, hi, (int((~tmask).sum()), V))
    matches = rng.integers(0, hi, (C, 3)).astype(np.int32)
    mmask = rng.random(C) < mlive
    return table, tmask, matches, mmask


# (shared, new) of a step over a V = 3 table: semijoins, expansions on one
# and two shared columns, a cartesian expansion, two new variables
STEPS = [(((0, 0),), ()), (((0, 0), (2, 1)), ()),
         (((0, 0),), ((2, 1),)), (((2, 2),), ((0, 0), (1, 1))),
         (((0, 0), (2, 1)), ((1, 2),)), ((), ((0, 1),)),
         ((), ((0, 0), (2, 2)))]
# the merge join's own steps (a shared and a new variable), and a semijoin
# that falls back to join_step
SORTED_STEPS = [STEPS[0], STEPS[2], STEPS[3], STEPS[4]]
# (R, C, live, mlive): overflow of R, all rows dead, all matches dead
SHAPES = [(8, 12, 0.6, 0.8), (4, 30, 0.9, 0.9), (8, 12, 0.0, 0.8),
          (8, 12, 0.6, 0.0), (1, 1, 1.0, 1.0)]


@pytest.mark.parametrize("shape", SHAPES)
def test_join_step_matches_the_reference(shape):
    R, C, live, mlive = shape
    rng = np.random.default_rng(R * 100 + C)
    for k, (shared, new) in enumerate(STEPS):
        args = _join_inputs(rng, R, 3, C, live, mlive)
        ref = _np(*j_join(*(jnp.asarray(a) for a in args), shared,
                                    new))
        for backend in BACKENDS:
            out = local.join_step(*_t(*args), shared, new, backend=backend)
            _equal(out, ref)


@pytest.mark.parametrize("shape", SHAPES)
def test_join_step_sorted_matches_the_reference(shape):
    """Ties in the sort key (keys from 5 values), max_per_row below and
    above the fan-out, one and two shared columns."""
    R, C, live, mlive = shape
    rng = np.random.default_rng(R * 100 + C + 1)
    flags = set()
    for shared, new in SORTED_STEPS:
        for max_per_row in (1, 3, 64):
            args = _join_inputs(rng, R, 3, C, live, mlive)
            ref = _np(*j_sorted(
                *(jnp.asarray(a) for a in args), shared, new,
                max_per_row=max_per_row))
            flags.add(bool(ref[2]))
            for backend in BACKENDS:
                out = local.join_step_sorted(*_t(*args), shared, new,
                                             max_per_row=max_per_row,
                                             backend=backend)
                _equal(out, ref)
    if live and mlive and C > R:
        assert flags == {False, True}       # fan-out or R overflow occurs


@pytest.mark.parametrize("sorted_join", [False, True])
def test_joins_broadcast_over_leading_dims(sorted_join):
    """A (B, S) table against matches gathered once and broadcast over the
    shard dim (a stride-0 view), as the engine's cut steps make them:
    every instance equals the reference's join of its own inputs."""
    rng = np.random.default_rng(11)
    B, S, R, V, C = 2, 3, 8, 3, 24
    tables, tmasks = [], []
    for _ in range(B * S):
        t, tm, _, _ = _join_inputs(rng, R, V, C)
        tables.append(t)
        tmasks.append(tm)
    table = np.stack(tables).reshape(B, S, R, V)
    tmask = np.stack(tmasks).reshape(B, S, R)
    matches = rng.integers(0, 5, (B, 1, C, 3)).astype(np.int32)
    mmask = rng.random((B, 1, C)) < 0.8
    tt, tm, mt, mmt = _t(table, tmask, matches, mmask)
    mt, mmt = mt.expand(B, S, C, 3), mmt.expand(B, S, C)
    for shared, new in (SORTED_STEPS if sorted_join else STEPS):
        for backend in BACKENDS:
            if sorted_join:
                out = local.join_step_sorted(tt, tm, mt, mmt, shared, new,
                                             max_per_row=3, backend=backend)
            else:
                out = local.join_step(tt, tm, mt, mmt, shared, new,
                                      backend=backend)
            for b in range(B):
                for s in range(S):
                    args = (jnp.asarray(table[b, s]), jnp.asarray(tmask[b, s]),
                            jnp.asarray(matches[b, 0]),
                            jnp.asarray(mmask[b, 0]))
                    ref = _np(*(j_sorted(*args, shared, new, max_per_row=3)
                                if sorted_join
                                else j_join(*args, shared, new)))
                    _equal(tuple(o[b, s] for o in out), ref)


def test_exports_match_the_reference():
    assert local.NOMATCH == int(jlocal.NOMATCH)
    assert local.__all__ == jlocal.__all__
    assert local.compact is primitives.compact
