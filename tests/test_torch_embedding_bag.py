"""The bag-sum kernel's lane plan (`embedding_bag.kernel.bag_plan`).

The plan is pure and decides the CUDA kernel's whole layout, so it is held
here on the CPU: its load width, lanes a row, rows a step and bags a warp
at D 1, 6, 10, 17, 32, 300 in float32 and bfloat16, and, by walking the
kernel's index arithmetic (csrc/embedding_bag.cu, bag_sum_warp) in Python,
that every (slot, vector) of each bag is read by exactly one lane and that
the shuffle tree adds every row slot's partial sum into slot 0 once."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.embedding_bag.kernel import bag_plan  # noqa: E402

DTYPES = (torch.float32, torch.bfloat16)
CHUNKS = 2          # chunks of ids a lane holds at once, as kBagChunks


def reads(p, d: int, bag: int):
    """{(group, slot, vector): count} of the loads bag_sum_warp makes for
    one warp, and {(group, vector): the row slots summed into slot 0}."""
    span = p.lanes * p.rows
    nvec = d // p.width
    loads, sums = {}, {}
    for v0 in range(0, nvec, p.lanes):
        acc = {}
        for lane in range(32):
            g, t = divmod(lane, span)
            rslot, q = divmod(t, p.lanes)
            if g >= p.groups or v0 + q >= nvec:
                continue
            acc[lane] = {rslot}
            # windows of CHUNKS chunks of span slots; lane t of the group
            # holds slot w0 + ch * span + t
            for w0 in range(0, bag, CHUNKS * span):
                n = min(CHUNKS * span, bag - w0)
                for s in range(-(-n // p.rows)):
                    ch, within = divmod(s, p.lanes)
                    slot = s * p.rows + rslot
                    holder = within * p.rows + rslot
                    assert ch * span + holder == slot and holder < span
                    if slot < n:
                        key = (g, w0 + slot, v0 + q)
                        loads[key] = loads.get(key, 0) + 1
        top = 1
        while top < p.rows:
            top *= 2
        off = top // 2
        while off:
            new = {k: set(v) for k, v in acc.items()}
            for lane, got in acc.items():
                rslot = (lane % span) // p.lanes
                if rslot < off and rslot + off < p.rows:
                    new[lane] |= acc[lane + off * p.lanes]
            acc = new
            off //= 2
        for lane, got in acc.items():
            g, t = divmod(lane, span)
            if t < p.lanes:
                sums[(g, v0 + t)] = got
    return loads, sums


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [1, 6, 10, 17, 32, 300])
def test_bag_plan_covers_every_row_vector_once(d, dtype):
    esize = 4 if dtype == torch.float32 else 2
    for bag in (1, 3, 39, 100):
        p = bag_plan(d, bag, dtype)
        assert bag_plan(d, bag, dtype) is p
        # the widest power-of-two load, at most 16 bytes, that splits a row
        assert p.vector_bytes == p.width * esize
        assert (d * esize) % p.vector_bytes == 0 and p.vector_bytes <= 16
        assert p.vector_bytes == 16 or (d * esize) % (2 * p.vector_bytes)
        nvec = d // p.width
        assert p.lanes == min(nvec, 32)
        assert p.lanes * p.rows * p.groups <= 32
        if nvec > 32:
            assert (p.rows, p.groups) == (1, 1)
        else:
            assert p.rows == min(32 // nvec, bag)
            assert p.groups == 32 // (p.lanes * p.rows)
        loads, sums = reads(p, d, bag)
        want = {(g, j, q) for g in range(p.groups) for j in range(bag)
                for q in range(nvec)}
        assert set(loads) == want and set(loads.values()) == {1}
        assert set(sums) == {(g, q) for g in range(p.groups)
                             for q in range(nvec)}
        assert all(s == set(range(p.rows)) for s in sums.values())


def test_bag_plan_at_the_xdeepfm_width():
    """D = 10 float32 rows of 40 bytes: 8-byte loads, 5 lanes a row, 6 rows
    a step (30 lanes), a bag of 39 a warp; a table one row into a larger
    one (4-byte aligned) takes 4-byte loads."""
    p = bag_plan(10, 39, torch.float32)
    assert (p.width, p.vector_bytes, p.lanes, p.rows, p.groups) == \
        (2, 8, 5, 6, 1)
    assert bag_plan(10, 39, torch.float32, 4).vector_bytes == 4
    assert bag_plan(10, 39, torch.bfloat16).vector_bytes == 4
    # small rows and bags share a warp
    assert bag_plan(1, 4, torch.float32).groups == 8


def test_bag_plan_limits():
    for bad in ((0, 3, torch.float32), (4, -1, torch.float32),
                (4, 3, torch.float16)):
        with pytest.raises(ValueError):
            bag_plan(*bad)
    assert bag_plan(4, 0, torch.float32).rows == 1


def test_bag_sum_op_on_cpu_launches_nothing():
    from repro_torch.kernels.embedding_bag import ops
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(size=(9, 10)).astype(np.float32))
    ids = torch.from_numpy(rng.integers(-9, 9, (4, 39)).astype(np.int32))
    before = ops.bag_sum.launches
    out = ops.bag_sum(table, ids)
    assert out.shape == (4, 10) and ops.bag_sum.launches == before
