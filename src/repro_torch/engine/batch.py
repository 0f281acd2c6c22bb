"""Batched multi-query serving: plan bucketing + one engine per bucket.

Plans are padded to shape buckets (same step count, per-step scan caps,
table cap) and their steps are encoded as small integer tensors, so one
engine executes every plan in a bucket and a whole batch of (plan, params)
requests runs as one pass of batched tensor operations.

Per-request runtime data (`PlanData`, one row per plan step):
  consts (L,3)  term id per triple position, -1 wildcard / -2 never-match
  pidx   (L,3)  params-vector index per position, -1 = use the constant
  eq     (L,3)  intra-pattern equality gates for pairs (0,1),(0,2),(1,2)
  kind   (L,3)  0 = unused position, 1 = shared (join) var, 2 = new var
  col    (L,3)  binding-table column of the position's variable
  owner  (L,S)  shards owning the pattern's feature (mask before the gather)
  noop   (L,)   padding step: the join is computed then discarded (identity)

What stays static lives in the bucket signature and keys the engine cache:
shard count, step count, table width/cap, per-step scan caps, plus
per-step structure bits that let the engine drop work no member plan needs
— `gather` (any member needs the cross-shard gather), `sorted` (every
member joins on a shared variable, so the merge join applies), `eq` /
`param` / `noop`, and `new_mode` ("all" / "none" / "mixed": whether member
steps bind new variables, which selects the expansion, semijoin, or both
join outcomes).

The engine's tensors carry the request batch and the shards as explicit
leading dims ``(B, S, …)``: every (request, shard) pair is one instance of
the scan/join primitives (`engine/primitives`), and a cut step's gather is
an ``expand`` of the matches across a gathered-shard dim, so every instance
sees all S blocks. The primitives run on the "torch" backend (plain
PyTorch) or the "cuda" backend (the hand-written kg_scan / kg_join
kernels); results are bit-identical.

On a mesh (`repro_torch.launch.mesh.EngineMesh`, one rank per shard) the
same engine runs on every rank over the rank's own shard (a shard dim of
1), and a cut step's gather is one real ``all_gather`` of the matches and
their mask packed together, in the same shard-major order: the gathers
per call are `bucket_collectives(sig)` (`make_sharded_batched_engine`,
`run_sharded_batched`).
"""
from __future__ import annotations

import math
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.engine.federated import (AXIS, ShardedKG, check_gather_cap,
                                          check_mesh, gather_matches,
                                          gather_outputs, raise_on_overflow,
                                          resolve_device)
from repro_torch.engine.planner import PhysicalPlan, pad_plan
from repro_torch.engine.primitives import (EQ_PAIRS, INT_MAX, KernelBlocks,
                                           check_backend, compact,
                                           compat_select, join_ranges,
                                           join_select, pair_mask, scan_hits,
                                           scan_select, select_cap, take,
                                           take_rows)
from repro_torch.sharding.rules import kg_local

_INT_MAX = int(INT_MAX)


class PlanData(NamedTuple):
    """Per-plan step structure as arrays (leading batch axis once stacked)."""
    consts: np.ndarray  # (..., L, 3) int32
    pidx: np.ndarray    # (..., L, 3) int32
    eq: np.ndarray      # (..., L, 3) bool
    kind: np.ndarray    # (..., L, 3) int32
    col: np.ndarray     # (..., L, 3) int32
    owner: np.ndarray   # (..., L, S) bool
    noop: np.ndarray    # (..., L) bool


@dataclass(frozen=True)
class BucketSignature:
    """Everything the bucket engine specializes on."""
    n_shards: int
    n_steps: int
    n_vars: int                      # binding-table width (>= 1)
    table_cap: int
    scan_caps: tuple[int, ...]
    fanout_caps: tuple[int, ...]     # merge-join window width per step
    verify_masks: tuple[tuple[bool, bool, bool], ...]  # positions any member
                                     # verifies as a 2nd+ shared column
    gather_bits: tuple[bool, ...]
    sorted_bits: tuple[bool, ...]
    eq_bits: tuple[bool, ...]
    param_bits: tuple[bool, ...]
    noop_bits: tuple[bool, ...]
    new_modes: tuple[str, ...]       # "all" | "none" | "mixed"


def bucket_collectives(sig: BucketSignature) -> int:
    """Number of cross-shard gather sites of the bucket engine: one per
    step where any member plan's pattern owners are not covered by its
    PPN. The WawPart objective (minimize partition cuts) is exactly
    minimizing this count."""
    if sig.n_shards <= 1:
        return 0
    return sum(1 for g in sig.gather_bits if g)


@dataclass
class PlanBucket:
    """One shape bucket: a signature plus the member plans padded to it.

    ``plans`` are the bucket's members (noop-padded to ``signature.n_steps``),
    ``n_params`` the widest member's params vector (requests zero-pad to it),
    and ``pdata`` the per-plan numpy ``PlanData`` the engine consumes.
    """

    signature: BucketSignature
    plans: list[PhysicalPlan]        # padded to the signature's shape
    n_params: int                    # params-vector width (>= 1)
    pdata: list[PlanData] = field(default_factory=list)  # per-plan, numpy


def _plan_data(plan: PhysicalPlan, sig: BucketSignature) -> PlanData:
    L, S = sig.n_steps, sig.n_shards
    consts = np.full((L, 3), -2, np.int32)
    pidx = np.full((L, 3), -1, np.int32)
    eq = np.zeros((L, 3), bool)
    kind = np.zeros((L, 3), np.int32)
    col = np.zeros((L, 3), np.int32)
    owner = np.zeros((L, S), bool)
    noop = np.zeros((L,), bool)
    for i, step in enumerate(plan.steps):
        if step.is_noop:
            noop[i] = True
            continue
        consts[i] = step.consts
        for pos, p_i in step.param_slots:
            pidx[i, pos] = p_i
        for k, pair in enumerate(EQ_PAIRS):
            if pair in step.eqs:
                eq[i, k] = True
        for pos, c_ in step.shared:
            kind[i, pos], col[i, pos] = 1, c_
        for pos, c_ in step.new:
            kind[i, pos], col[i, pos] = 2, c_
        for s in step.owners:
            owner[i, s] = True
    return PlanData(consts, pidx, eq, kind, col, owner, noop)


def _pad_level(n: int, levels: tuple[int, ...]) -> int:
    for lvl in levels:
        if n <= lvl:
            return lvl
    return n  # longer than every level: its own bucket size


DEFAULT_STEP_LEVELS = (1, 2, 3, 4, 6, 8, 12, 16)


def bucket_plans(plans: list[PhysicalPlan], *,
                 step_levels: tuple[int, ...] = DEFAULT_STEP_LEVELS,
                 ) -> list[PlanBucket]:
    """Group plans into shape buckets and pad members to the bucket shape.

    Plans are grouped by (n_shards, step count rounded up to a level); within
    a group, per-step scan caps, the table cap, and the table width are lifted
    to the group maximum, which *is* the bucket signature — identical
    signatures from different workloads share one engine.
    """
    groups: dict[tuple[int, int], list[PhysicalPlan]] = {}
    for p in plans:
        key = (p.n_shards, _pad_level(len(p.steps), step_levels))
        groups.setdefault(key, []).append(p)

    buckets: list[PlanBucket] = []
    for (S, L), members in sorted(groups.items()):
        scan_caps, fanout_caps, gather_bits, sorted_bits = [], [], [], []
        eq_bits, param_bits, noop_bits, new_modes = [], [], [], []
        verify_masks = []
        for i in range(L):
            steps = [p.steps[i] for p in members if i < len(p.steps)]
            real = [s for s in steps if not s.is_noop]  # members may arrive
            # pre-padded (pad_plan); their no-op steps must not shape the
            # structure bits, only the capacity maxima
            scan_caps.append(max([s.scan_cap for s in steps] or [8]))
            fanout_caps.append(max([s.block_fanout_cap for s in real] or [8]))
            vm = [False, False, False]
            for s in real:
                for pos, _ in s.shared[1:]:
                    vm[pos] = True
            verify_masks.append(tuple(vm))
            gather_bits.append(any(s.gather for s in real))
            sorted_bits.append(bool(real) and all(s.shared for s in real))
            eq_bits.append(any(s.eqs for s in real))
            param_bits.append(any(s.param_slots for s in real))
            noop_bits.append(len(real) < len(members))
            with_new = sum(1 for s in real if s.new)
            new_modes.append("all" if real and with_new == len(real) else
                             "none" if with_new == 0 else "mixed")
        n_vars = max(1, max(p.n_vars for p in members))
        table_cap = max(p.table_cap for p in members)
        sig = BucketSignature(
            n_shards=S, n_steps=L, n_vars=n_vars, table_cap=table_cap,
            scan_caps=tuple(scan_caps), fanout_caps=tuple(fanout_caps),
            verify_masks=tuple(verify_masks), gather_bits=tuple(gather_bits),
            sorted_bits=tuple(sorted_bits), eq_bits=tuple(eq_bits),
            param_bits=tuple(param_bits), noop_bits=tuple(noop_bits),
            new_modes=tuple(new_modes))
        padded = [pad_plan(p, L, scan_caps=scan_caps, table_cap=table_cap)
                  for p in members]
        n_params = max(1, max(p.n_params for p in members))
        bucket = PlanBucket(signature=sig, plans=padded, n_params=n_params)
        bucket.pdata = [_plan_data(p, sig) for p in padded]
        buckets.append(bucket)
    return buckets


def shard_perms(kg: ShardedKG) -> np.ndarray:
    """(S, 3, N) int32: per shard, the stable sort permutation of its triple
    block by each triple position. The merge join materializes matches
    through the join-key position's permutation, so its keys are sorted
    *by construction* and no step sorts at run time."""
    S, N = kg.n_shards, kg.cap
    perms = np.empty((S, 3, N), np.int32)
    for s in range(S):
        for pos in range(3):
            perms[s, pos] = np.argsort(kg.triples[s, :, pos], kind="stable")
    return perms


# ---------------------------------------------------------------------------
# data-driven engine primitives; leading dims (…) are (batch, shard)
# ---------------------------------------------------------------------------

def _zeros_flag(like: torch.Tensor) -> torch.Tensor:
    """A (…,) False flag over ``like``'s leading instance dims."""
    return torch.zeros(like.shape[:-1], dtype=torch.bool, device=like.device)


def _materialize(triples, valid, spo, eq, cap: int, *, backend: str):
    """Scan the pattern and compact matching rows to (…, min(cap, N), 3) in
    shard order; when the static cap covers the whole shard the selection
    is skipped and the hit mask itself is the match mask."""
    if cap >= triples.shape[-2]:
        hit, _ = scan_hits(triples, valid, spo, eq, backend=backend,
                           with_cum=False)
        return triples, hit, _zeros_flag(hit)
    _, idx, mm, total = scan_select(triples, valid, cap, spo, eq,
                                    backend=backend, with_hit=False)
    return take_rows(triples, idx), mm, total > cap


def _materialize_view(triples, perm, hit, cap: int, *, backend: str):
    """Compact matching rows to (…, min(cap, N), 3), ordered by the pos0
    column through ``perm`` (…, N) — the runtime-selected per-position sort
    permutation — valid rows first, so the pos0 keys of the valid prefix
    are sorted."""
    n = perm.shape[-1]
    idx, mm, total = select_cap(torch.gather(hit, -1, perm), min(cap, n),
                                backend=backend)
    m = take_rows(triples, torch.gather(perm, -1, idx.long()))
    ovf = (total > cap) if cap < n else _zeros_flag(hit)
    return m, mm, ovf


def _scatter_new(out, values, kind, col, n_vars: int):
    """Write matched values (three (…, R) tensors) into their
    (runtime-chosen) new-var columns of out (…, R, V)."""
    colids = torch.arange(n_vars, device=out.device)
    for pos in range(3):
        hot = (kind[..., pos, None] == 2) & (
            colids == col[..., pos, None].clamp(0, n_vars - 1))   # (…, V)
        out = torch.where(hot[..., None, :], values[pos][..., :, None], out)
    return out


def _mix(new_mode: str, kind, expansion, semijoin):
    """Select the (table, mask, overflow) outcome per the bucket's new_mode;
    "mixed" picks per instance by whether its step binds a new var."""
    if new_mode == "all":
        return expansion()
    if new_mode == "none":
        return semijoin()
    te, me, oe = expansion()
    ts, ms, os_ = semijoin()
    has_new = (kind == 2).any(dim=-1)                            # (…,)
    return (torch.where(has_new[..., None, None], te, ts),
            torch.where(has_new[..., None], me, ms),
            torch.where(has_new, oe, os_))


def _seed_join(table, matches, mmask, kind, col, new_mode: str, *,
               backend: str):
    """Step-0 join: the table holds only the seed row, so the 'join' is a
    compaction of the matches straight into the table columns — avoids the
    R x C compat matrix exactly where C is largest (unselective first
    scans). Bit-equivalent to the general joins on a seed table."""
    R, V = table.shape[-2:]

    def expansion():
        if matches.shape[-2] <= R:       # matches fit: no selection needed
            m, mm = matches, mmask
            ovf = _zeros_flag(mmask)
        else:
            idx, mm, total = select_cap(mmask, R, backend=backend)
            m = take_rows(matches, idx)
            ovf = total > R
        if m.shape[-2] < R:
            pad = R - m.shape[-2]
            m = torch.nn.functional.pad(m, (0, 0, 0, pad), value=-1)
            mm = torch.nn.functional.pad(mm, (0, pad), value=False)
        out = _scatter_new(torch.full_like(table, -1),
                           [m[..., pos] for pos in range(3)], kind, col, V)
        return out, mm, ovf

    def semijoin():                      # fully-constant first pattern
        tm = torch.zeros(table.shape[:-1], dtype=torch.bool,
                         device=table.device)
        tm[..., 0] = mmask.any(dim=-1)
        return table, tm, _zeros_flag(mmask)

    return _mix(new_mode, kind, expansion, semijoin)


def _join_data(table, tmask, matches, mmask, kind, col, new_mode: str, *,
               backend: str):
    """Expand-and-filter join with the join structure as runtime data. One
    `compat_select` (of the R x C compatibility matrix, its first R pairs
    and its rows with any pair; under "cuda" the kg_join compat kernels,
    which write no matrix) serves both epilogues, which are
    backend-independent."""
    R, V = table.shape[-2:]
    C = matches.shape[-2]
    # a semijoin reads only keep: it selects no pair
    cap = 0 if new_mode == "none" else R
    keep, order, omask, total = compat_select(table, tmask, matches, mmask,
                                              kind, col, cap, backend=backend)

    def expansion():
        r_idx, c_idx = order // C, order % C
        vals = [take(matches[..., pos], c_idx) for pos in range(3)]
        out = _scatter_new(take_rows(table, r_idx), vals, kind, col, V)
        return out, omask, total > R

    def semijoin():
        return table, keep, _zeros_flag(tmask)

    return _mix(new_mode, kind, expansion, semijoin)


def _join_merge(table, tmask, m_blocks, mm_blocks, pos0, kind, col,
                new_mode: str, *, max_per_row: int,
                verify_mask: tuple[bool, bool, bool], backend: str):
    """Merge join against per-shard match blocks whose pos0 keys are sorted
    (valid prefix) by construction — a range search per block locates each
    table row's candidate range, up to max_per_row candidates *per block*
    are expanded, and the remaining shared columns verify during expansion.
    Fan-out beyond max_per_row sets the overflow flag.

    table (…, R, V), tmask (…, R), m_blocks (…, S_b, C, 3), mm_blocks
    (…, S_b, C), pos0 (…,) int64, kind/col (…, 3) — one block per gathered
    shard, or a single block for PPN-local steps. verify_mask flags the
    positions some member verifies as a 2nd+ shared column: only those
    force the (R, S_b*K) pair mask and its candidate gathers. A step
    without them builds no mask: its expansion is one `join_select` (the
    searches and the compaction of the (row, block, slot) pairs, straight
    from the clipped counts) and its semijoin reads the counts.
    """
    R, V = table.shape[-2:]
    Sb, C = mm_blocks.shape[-2:]
    lead = table.shape[:-2]
    K = min(max_per_row, C)
    if K < 1:
        raise ValueError(f"max_per_row must be at least 1, got {max_per_row}")
    is_sh = kind == 1
    first = torch.argmax(is_sh.to(torch.int32), dim=-1, keepdim=True)
    col0 = torch.gather(col, -1, first).clamp(0, V - 1)          # (…, 1)

    pos_idx = pos0.reshape(*lead, 1, 1, 1).expand(*lead, Sb, C, 1)
    keys = torch.where(mm_blocks, torch.gather(m_blocks, -1, pos_idx)[..., 0],
                       _INT_MAX)                                 # (…, Sb, C)
    rkey = torch.gather(table, -1, col0[..., None].expand(*lead, R, 1))[..., 0]
    verify = any(verify_mask)
    selected = None
    if verify or new_mode == "none":
        lo, hi = join_ranges(keys, rkey, backend=backend)        # (…, Sb, R)
        counts = torch.where(tmask[..., None, :], hi - lo, 0)
    else:
        lo, counts, *selected = join_select(keys, rkey, tmask, K, R,
                                            backend=backend)
    overflow_fanout = counts.amax(dim=(-2, -1)) > K
    m_flat = m_blocks.reshape(*lead, Sb * C, 3)
    lo_flat = lo.reshape(*lead, Sb * R)

    def cand_idx(order):
        """Flat int32 indices into m_flat for pair slots `order` (…, X)."""
        blk = (order % (Sb * K)) // K
        within = order % K
        row = order // (Sb * K)
        src = (take(lo_flat, blk * R + row) + within).clamp(0, C - 1)
        return blk * C + src

    if verify:
        # (row, block, slot) order directly; counts is already 0 on dead
        # rows, so the reference's extra `& tmask` pass changes nothing
        pair_ok = pair_mask(counts, K)                           # (…, R, SbK)
        # every candidate slot, laid out as (…, R, S_b, K) without a gather
        offs = torch.arange(K, dtype=torch.int32, device=table.device)
        blk_base = torch.arange(Sb, dtype=torch.int32,
                                device=table.device)[:, None] * C
        idx_all = (lo.transpose(-2, -1)[..., None] + offs).clamp(0, C - 1)
        idx_all = (idx_all + blk_base).reshape(*lead, R * Sb * K)
        for pos in range(3):
            if not verify_mask[pos]:
                continue
            chk = is_sh[..., pos] & (pos0 != pos)                 # (…,)
            cc = col[..., pos, None].clamp(0, V - 1)
            tv = torch.gather(table, -1, cc[..., None].expand(*lead, R, 1))
            vals = take(m_flat[..., pos], idx_all).reshape(*lead, R, Sb * K)
            pair_ok = pair_ok & (~chk[..., None, None] | (vals == tv))

    def expansion():
        # select surviving (row, candidate) pairs first, THEN gather their
        # match values — R gathers instead of R*S_b*K
        if selected is None:
            flat = pair_ok.reshape(*lead, R * Sb * K)
            order, omask, total = select_cap(flat, R, backend=backend)
        else:
            order, omask, total = selected
        vals = take_rows(m_flat, cand_idx(order))                # (…, R, 3)
        out = _scatter_new(take_rows(table, order // (Sb * K)),
                           [vals[..., pos] for pos in range(3)], kind, col, V)
        return out, omask, total > R

    def semijoin():
        if verify:
            return table, tmask & pair_ok.any(dim=-1), _zeros_flag(tmask)
        # a row joins iff some block holds a candidate: with K >= 1 the
        # pair mask has a set slot for (row, block) iff counts > 0
        return (table, tmask & (counts > 0).any(dim=-2),
                _zeros_flag(tmask))

    t2, m2, ovf = _mix(new_mode, kind, expansion, semijoin)
    return t2, m2, ovf | overflow_fanout


# ---------------------------------------------------------------------------
# bucket engine
# ---------------------------------------------------------------------------

def _gather_matches(m, mm, mesh, *, blocks: bool):
    """A cut step's gather of every shard's owner-masked matches (…, S_i,
    C, 3) / (…, S_i, C), shard-major: (…, S_i, S, C, …) blocks for the
    merge join, or (…, S_i, S·C, …) for the other joins.

    Without a mesh S_i = S and every instance sees one copy of all S
    blocks (an expand, the all_gather under a shard-axis vmap). On a mesh
    S_i = 1 and the ranks' blocks arrive by one counted all_gather
    (`federated.gather_matches`)."""
    if mesh is None:
        B, S, C = mm.shape
        m = m[:, None].expand(B, S, S, C, 3)
        mm = mm[:, None].expand(B, S, S, C)
    else:
        m, mm = gather_matches(mesh, m, mm)
    if blocks:
        return m, mm
    B, Si, S, C = mm.shape
    return m.reshape(B, Si, S * C, 3), mm.reshape(B, Si, S * C)


def make_batched_engine(sig: BucketSignature, *, join_impl: str = "expand",
                        max_per_row: int | None = None,
                        gather_cap: int | None = None,
                        backend: str = "cuda",
                        kernel_blocks: KernelBlocks | None = None,
                        mesh=None):
    """Build engine(triples, valid, perms, pdata, params) ->
    (table, mask, overflow) for one bucket signature. The engine is
    plan-agnostic: every member plan of any bucket with this signature runs
    through it.

    Arguments are tensors on one device: triples (S, N, 3) int32, valid
    (S, N) bool, perms (S, 3, N) int64 (from `shard_perms`), a PlanData of
    (B, …) tensors and params (B, P) int32. Results: table (B, S, R, V)
    int32, mask (B, S, R) bool, overflow (B, S) bool — one row per
    (request, shard) instance, as the JAX package's vmapped engine.

    gather_cap (post-gather compaction) applies to the expand/base join
    path; the merge join keeps gathered matches in per-shard blocks.
    max_per_row: ceiling on the merge-join window width (default: the
    signature's data-sized per-step fan-out caps).
    backend: "torch" runs the plain primitives; "cuda" routes the scan
    (fused predicate with its compaction), the compactions, the
    candidate-range search (with the merge join's pair compaction,
    `join_select`) and the expand join's selection (`compat_select`, with
    no compat matrix) through the kg_scan / kg_join kernels (plain
    versions on CPU tensors), bit-identically. On "cuda" the
    merge path scans the permuted view directly, so one select launch of
    the scan both matches and compacts it.

    mesh: an `EngineMesh` of ``sig.n_shards`` ranks. Every rank then calls
    the engine with its own shard's blocks (triples (1, N, 3), valid
    (1, N), perms (1, 3, N), from `sharding.rules.kg_local`) and the same
    PlanData and params, and gets its own rows: (B, 1, R, V), (B, 1, R),
    (B, 1). Its kernels run over B instances where the single-device
    engine's run over B·S, so each rank launches them as often.
    """
    check_gather_cap(gather_cap)
    check_backend(backend, kernel_blocks)
    S, L, V, R = sig.n_shards, sig.n_steps, sig.n_vars, sig.table_cap
    S_loc = S if mesh is None else 1

    def engine(triples, valid, perms, pd: PlanData, params):
        """A batch of requests interpreted against the sharded KG."""
        dev = triples.device
        B = params.shape[0]
        N = triples.shape[-2]
        table = torch.full((B, S_loc, R, V), -1, dtype=torch.int32,
                           device=dev)
        tmask = torch.zeros((B, S_loc, R), dtype=torch.bool, device=dev)
        tmask[..., 0] = True
        overflow = torch.zeros((B, S_loc), dtype=torch.bool, device=dev)
        tr = triples.expand(B, S_loc, N, 3)
        shard = torch.arange(S_loc, device=dev)
        mine = slice(None) if mesh is None \
            else slice(mesh.rank, mesh.rank + 1)

        for i in range(L):
            cap = sig.scan_caps[i]
            spo = pd.consts[:, i]                                # (B, 3)
            if sig.param_bits[i]:
                pidx = pd.pidx[:, i]
                at = pidx.clamp(0, params.shape[1] - 1).long()
                spo = torch.where(pidx >= 0, torch.gather(params, 1, at), spo)
            spo = spo[:, None]                                   # (B, 1, 3)
            eq = pd.eq[:, i, None] if sig.eq_bits[i] else None
            va = valid.expand(B, S_loc, N)
            gather = sig.gather_bits[i] and S > 1
            if gather:
                # owner gate folded into the validity mask so the fused
                # scan's hit-count already reflects it (== hit & owner)
                va = va & pd.owner[:, i, mine, None]
            merge = (i > 0 and join_impl == "sorted" and sig.sorted_bits[i])
            kind, col = pd.kind[:, i, None], pd.col[:, i, None]  # (B, 1, 3)
            kind, col = kind.expand(B, S_loc, 3), col.expand(B, S_loc, 3)

            if merge:   # matches per block, pos0-key-sorted by construction
                pos0 = torch.argmax((pd.kind[:, i] == 1).to(torch.int32),
                                    dim=-1)                      # (B,)
                perm = perms[shard[None, :], pos0[:, None]]      # (B, S, N)
                if backend == "cuda":
                    tp = take_rows(tr, perm)
                    _, idx, mm, total = scan_select(
                        tp, torch.gather(va, -1, perm), min(cap, N), spo, eq,
                        backend=backend, with_hit=False)
                    m = take_rows(tp, idx)
                    step_ovf = (total > cap) if cap < N \
                        else _zeros_flag(mm)
                else:
                    hit, _ = scan_hits(tr, va, spo, eq, backend=backend)
                    m, mm, step_ovf = _materialize_view(tr, perm, hit, cap,
                                                        backend=backend)
                if gather:                       # every instance sees all S
                    m, mm = _gather_matches(m, mm, mesh, blocks=True)
                else:
                    m, mm = m[:, :, None], mm[:, :, None]
                K = sig.fanout_caps[i] if max_per_row is None \
                    else min(max_per_row, sig.fanout_caps[i])
                t2, m2, ovf_j = _join_merge(
                    table, tmask, m, mm, pos0[:, None].expand(B, S_loc),
                    kind, col, sig.new_modes[i], max_per_row=K,
                    verify_mask=sig.verify_masks[i], backend=backend)
            else:
                m, mm, step_ovf = _materialize(tr, va, spo, eq, cap,
                                               backend=backend)
                if gather:
                    C = m.shape[-2]
                    m, mm = _gather_matches(m, mm, mesh, blocks=False)
                    if gather_cap is not None and gather_cap < S * C:
                        m, mm, ovf_g = compact(m, mm, gather_cap,
                                               backend=backend)
                        step_ovf = step_ovf | ovf_g
                if i == 0:
                    t2, m2, ovf_j = _seed_join(table, m, mm, kind, col,
                                               sig.new_modes[i],
                                               backend=backend)
                else:
                    t2, m2, ovf_j = _join_data(table, tmask, m, mm, kind, col,
                                               sig.new_modes[i],
                                               backend=backend)
            if sig.noop_bits[i]:         # some member pads here: gate
                noop = pd.noop[:, i, None]                       # (B, 1)
                table = torch.where(noop[..., None, None], table, t2)
                tmask = torch.where(noop[..., None], tmask, m2)
                overflow = overflow | (~noop & (step_ovf | ovf_j))
            else:
                table, tmask = t2, m2
                overflow = overflow | step_ovf | ovf_j
        return table, tmask, overflow

    return engine


def make_sharded_batched_engine(sig: BucketSignature, mesh, *,
                                join_impl: str = "expand",
                                max_per_row: int | None = None,
                                gather_cap: int | None = None,
                                backend: str = "cuda",
                                kernel_blocks: KernelBlocks | None = None):
    """The mesh counterpart of the single-device bucket engine: the same
    call, fn(triples, valid, perms, pdata, params) -> (table, mask,
    overflow), with the same (B, S, …) result on every rank, but the shard
    axis is the mesh's ranks. Each rank passes its own shard's blocks
    (`sharding.rules.kg_local`), scans and joins run rank-locally, only
    the steps whose owner metadata marks a partition cut gather across
    the ranks (`bucket_collectives(sig)` counted gathers a call), and one
    gather of the outputs restores the single-device layout.

    ``fn.local`` is the engine without that last gather: each rank's own
    (B, 1, …) rows (the mesh-routed server collects them on rank 0).
    Raises ValueError when the mesh has no "shards" axis of exactly
    ``sig.n_shards`` ranks.
    """
    check_mesh(mesh, sig.n_shards, AXIS)
    local = make_batched_engine(sig, join_impl=join_impl,
                                max_per_row=max_per_row,
                                gather_cap=gather_cap, backend=backend,
                                kernel_blocks=kernel_blocks, mesh=mesh)

    def fn(triples, valid, perms, pd: PlanData, params):
        """One rank's blocks in, every rank's rows out (B, S, …)."""
        return gather_outputs(mesh, *local(triples, valid, perms, pd,
                                           params))

    fn.local = local
    return fn


class EngineCache:
    """Engine cache: one bucket engine per (signature, options).

    `misses` counts engine builds and `hits` lookups that found one. The
    execution backend and its kernel tile sizes key the cache: a torch
    engine and a cuda engine for one signature never collide.

    `capacity` bounds the cache with LRU eviction (``None`` = unbounded);
    `evictions` counts engines dropped. A mesh keys the cache too: the
    single-device engine and a mesh's engine for one signature cache side
    by side.
    """

    def __init__(self, capacity: int | None = None) -> None:
        if capacity is not None and capacity < 1:
            raise ValueError(f"EngineCache capacity must be >= 1 or None, "
                             f"got {capacity}")
        self._fns: OrderedDict = OrderedDict()
        self.capacity = capacity
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, sig: BucketSignature, *, join_impl: str = "expand",
            max_per_row: int | None = None, gather_cap: int | None = None,
            mesh=None, backend: str = "cuda",
            kernel_blocks: KernelBlocks | None = None):
        """Return the engine for ``(sig, options)``, building on miss.

        ``mesh=None`` returns the single-device engine; a mesh returns
        `make_sharded_batched_engine`'s for that mesh. Raises ValueError
        on an unknown backend or a non-``KernelBlocks`` tiling (via
        ``check_backend``), or a mesh that does not fit the signature. A
        hit refreshes the entry's LRU position when the cache is capped.
        """
        blocks = check_backend(backend, kernel_blocks)
        key = (sig, join_impl, max_per_row, gather_cap, mesh, backend,
               blocks)
        fn = self._fns.get(key)
        if fn is None:
            self.misses += 1
            if mesh is not None:
                fn = make_sharded_batched_engine(
                    sig, mesh, join_impl=join_impl, max_per_row=max_per_row,
                    gather_cap=gather_cap, backend=backend,
                    kernel_blocks=blocks)
            else:
                fn = make_batched_engine(sig, join_impl=join_impl,
                                         max_per_row=max_per_row,
                                         gather_cap=gather_cap,
                                         backend=backend,
                                         kernel_blocks=blocks)
            self._fns[key] = fn
            while self.capacity is not None \
                    and len(self._fns) > self.capacity:
                self._fns.popitem(last=False)
                self.evictions += 1
        else:
            self.hits += 1
            self._fns.move_to_end(key)
        return fn

    def __len__(self) -> int:
        """Engines currently held."""
        return len(self._fns)

    def __bool__(self) -> bool:
        """Always truthy: an empty cache is still a cache."""
        return True


# ---------------------------------------------------------------------------
# batch assembly + execution
# ---------------------------------------------------------------------------

def canonical_params(pv: np.ndarray | None, n_params: int) -> bytes:
    """The padded param vector a request executes with, as hashable bytes.

    `assemble_batch` zero-pads every request to the bucket's n_params, so
    `[5]`, `[5, 0]` and — when n_params is 0 — `None` all execute
    identically; canonicalizing here keeps dedup and the answer cache keyed
    on what actually runs. Raises ValueError on vectors longer than the
    bucket width (they cannot execute at all)."""
    vec = np.zeros((n_params,), np.int32)
    if pv is not None:
        pv = np.asarray(pv, np.int32).reshape(-1)
        if pv.shape[0] > n_params:
            raise ValueError(
                f"request has {pv.shape[0]} params but the bucket executes "
                f"with n_params={n_params}; extra values would be dropped")
        vec[:pv.shape[0]] = pv
    return vec.tobytes()


def pad_requests_pow2(requests: list[tuple[int, np.ndarray | None]],
                      ) -> list[tuple[int, np.ndarray | None]]:
    """Pad a request batch to a power-of-two length with ``(plan 0, no
    params)`` fillers at the tail, so the batch axis takes few distinct
    sizes. Extraction truncates to the real requests, so the fillers are
    never observable in results."""
    n_pad = 1 << max(0, len(requests) - 1).bit_length()
    return requests + [(0, None)] * (n_pad - len(requests))


def assemble_batch(bucket: PlanBucket,
                   requests: list[tuple[int, np.ndarray | None]],
                   ) -> tuple[PlanData, torch.Tensor]:
    """Stack (plan_idx, params) requests into (PlanData[B,...], params[B,P])
    CPU tensors.

    Raises ValueError on an empty request list or (via
    ``canonical_params``) on a param vector wider than the bucket width.
    """
    if not requests:
        raise ValueError("empty request batch")
    P = bucket.n_params
    stacked = PlanData(*(torch.from_numpy(np.stack(
        [getattr(bucket.pdata[idx], f) for idx, _ in requests]))
        for f in PlanData._fields))
    pvecs = np.empty((len(requests), P), np.int32)
    for r, (_, pv) in enumerate(requests):
        pvecs[r] = np.frombuffer(canonical_params(pv, P), np.int32)
    return stacked, torch.from_numpy(pvecs)


def stage_batch(bucket: PlanBucket,
                requests: list[tuple[int, np.ndarray | None]], *,
                device="cuda", mesh=None) -> tuple[PlanData, torch.Tensor]:
    """Assemble a request batch and start its host-to-device transfer:
    on a CUDA device from pinned host memory with ``non_blocking=True``, so
    the copies are in flight when the engine is called. Under a ``mesh``
    the batch goes to this rank's device (every rank runs the same batch).
    Raises ValueError (from ``assemble_batch``) on an empty or oversized
    batch."""
    dev = mesh.device if mesh is not None else resolve_device(device)
    pd, params = assemble_batch(bucket, requests)
    if dev.type != "cuda":
        return PlanData(*(t.to(dev) for t in pd)), params.to(dev)
    return (PlanData(*(t.pin_memory().to(dev, non_blocking=True)
                       for t in pd)),
            params.pin_memory().to(dev, non_blocking=True))


class OutputFetch(NamedTuple):
    """An engine call's (table, tmask, overflow) on their way to the host.

    On a CUDA device ``host`` holds pinned host tensors that copies issued
    with ``non_blocking=True`` fill, ``event`` is the CUDA event recorded
    on the current stream after them, and ``device`` keeps the engine's
    outputs referenced until the batch completes. On the CPU ``host`` is
    the outputs themselves and there is no event: the batch is ready."""

    host: tuple
    event: object
    device: tuple

    def ready(self) -> bool:
        """Whether the copies have landed; never blocks."""
        return self.event is None or self.event.query()

    def wait(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Block until the copies have landed; the host arrays."""
        if self.event is not None:
            self.event.synchronize()
        return tuple(t.numpy() for t in self.host)


def fetch_outputs(out) -> OutputFetch:
    """Start the device-to-host leg of a dispatch: copy the engine's
    (table, tmask, overflow) into pinned host tensors with
    ``non_blocking=True`` and record a CUDA event after the copies, so the
    caller polls (``ready``) or waits (``wait``) instead of issuing a
    synchronous ``.cpu()``. CPU tensors are returned as they are."""
    out = tuple(out)
    if out[0].device.type != "cuda":
        return OutputFetch(out, None, ())
    host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                 for t in out)
    for h, t in zip(host, out):
        h.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return OutputFetch(host, event, out)


def engine_cost(sig: BucketSignature, n_rows: int, *, batch: int = 1,
                join_impl: str = "expand", gather_cap: int | None = None,
                mesh=None) -> dict[str, float]:
    """Integer operations and bytes of one bucket engine call, counted
    from the signature and the shapes: ``batch`` requests over
    ``sig.n_shards`` shard blocks of ``n_rows`` rows (the port's
    counterpart of XLA's cost analysis, which it has no access to).

    Each (request, shard) instance, per step, with C = min(scan cap, N),
    R the table cap and V its width:

    * the scan: reads the block (13 N bytes a shard, once for every
      request) and the pattern (12 bytes), writes C selected rows (5 C +
      4 bytes: index and mask, and the total) or, where C = N, the hit
      mask (N bytes); 3 compares a row, 3 more where the step has an
      equality gate;
    * a cut step (``gather_bits``, S > 1) joins against the S blocks' C
      rows, compacted to gather_cap when that is smaller;
    * a merge join (``join_impl="sorted"`` and ``sorted_bits``, past the
      first step) reads the S_b key blocks (4 bytes a key) and R row keys
      and the row mask (5 R), writes lo and the counts (8 bytes a row and
      block) and R pairs (5 R + 4); 2 ceil(log2(C + 1)) compares a row and
      block;
    * another join reads the table (4 R V + R) and the C' candidate
      matches (13 C'), writes the kept rows (R) and R pairs (5 R + 4);
      one compare a (row, candidate) pair; the first step compacts the
      candidates alone (C' bytes read, 5 R + 4 written, C' operations).

    On a mesh, the bytes that the cut gathers deliver (every rank
    receives the S blocks of C rows, 16 bytes a row) are added. The counts
    do not depend on the device.
    """
    S, R, V = sig.n_shards, sig.table_cap, sig.n_vars
    inst = batch * S
    ops = 0.0
    nbytes = float(inst * (4 * R * V + R + 1))          # the outputs
    for i in range(sig.n_steps):
        C = min(sig.scan_caps[i], n_rows)
        eq = sig.eq_bits[i]
        nbytes += S * 13 * n_rows + inst * (12 + (3 if eq else 0))
        nbytes += inst * (n_rows if C >= n_rows else 5 * C + 4)
        ops += inst * n_rows * (6 if eq else 3)
        gather = sig.gather_bits[i] and S > 1
        if gather and mesh is not None:
            nbytes += S * batch * S * C * 16
        if i > 0 and join_impl == "sorted" and sig.sorted_bits[i]:
            sb = S if gather else 1
            nbytes += inst * (sb * C * 4 + 5 * R + sb * R * 8 + 5 * R + 4)
            ops += inst * sb * R * 2 * math.ceil(math.log2(C + 1))
            continue
        cand = S * C if gather else C
        if gather and gather_cap is not None:
            cand = min(cand, gather_cap)
        if i == 0:
            nbytes += inst * (cand + 5 * R + 4)
            ops += inst * cand
        else:
            nbytes += inst * (4 * R * V + R + 13 * cand + R + 5 * R + 4)
            ops += inst * R * cand
    return {"flops": ops, "bytes": nbytes}


def extract_batch(bucket: PlanBucket,
                  requests: list[tuple[int, np.ndarray | None]],
                  table, tmask, overflow):
    """Per-request (solutions, count, overflow), PPN shard, sorted + deduped
    (mirrors the oracle's output so results compare bit-identically)."""
    table = np.asarray(table)
    tmask = np.asarray(tmask)
    overflow = np.asarray(overflow)
    out = []
    for r, (idx, _) in enumerate(requests):
        plan = bucket.plans[idx]
        t = table[r, plan.ppn]
        m = tmask[r, plan.ppn]
        ov = bool(overflow[r, plan.ppn])
        rows = t[m][:, :plan.n_vars]
        rows = np.unique(rows, axis=0) if rows.shape[0] \
            else rows.reshape(0, plan.n_vars)
        out.append((rows.astype(np.int32), int(rows.shape[0]), ov))
    return out


def dedup_requests(requests: list[tuple[int, np.ndarray | None]],
                   n_params: int | None = None,
                   ) -> tuple[list[tuple[int, np.ndarray | None]], list[int]]:
    """Collapse identical (plan, params) requests to one executed instance.

    Returns (unique, inverse) with requests[i] equivalent to
    unique[inverse[i]]. n_params (the bucket width) keys requests on their
    *padded* param vector, so `[5]` and `[5, 0]` collapse too; without it
    only byte-identical vectors match."""
    seen: dict[tuple[int, bytes | None], int] = {}
    unique: list[tuple[int, np.ndarray | None]] = []
    inverse: list[int] = []
    for idx, pv in requests:
        if n_params is None:
            raw = None if pv is None else np.asarray(pv, np.int32).tobytes()
            key = (idx, raw)
        else:
            key = (idx, canonical_params(pv, n_params))
        j = seen.get(key)
        if j is None:
            j = seen[key] = len(unique)
            unique.append((idx, pv))
        inverse.append(j)
    return unique, inverse


def extract_fanout(bucket: PlanBucket, unique, inverse: list[int],
                   table, tmask, overflow):
    """extract_batch on the unique instances, fanned back to request order."""
    res = extract_batch(bucket, unique, table, tmask, overflow)
    return [res[j] for j in inverse]


def kg_tensors(kg: ShardedKG, perms: np.ndarray | None, device):
    """(triples, valid, perms) of ``kg`` on ``device``; perms as int64."""
    tr, va = kg.to_device(device)
    if perms is None:
        perms = shard_perms(kg)
    return tr, va, torch.from_numpy(perms).to(device).long()


def run_batched(bucket: PlanBucket, kg: ShardedKG,
                requests: list[tuple[int, np.ndarray | None]] | None = None,
                *, join_impl: str = "expand", max_per_row: int | None = None,
                gather_cap: int | None = None, cache: EngineCache | None = None,
                perms: np.ndarray | None = None, dedup: bool = False,
                strict: bool = False, backend: str = "cuda",
                kernel_blocks: KernelBlocks | None = None, device="cuda",
                mesh=None):
    """Execute a batch of requests against one bucket on ``device``.

    requests defaults to one zero-params request per member plan. perms
    (from shard_perms(kg)) can be passed in to amortize the per-shard sort
    permutations across calls. dedup=True collapses identical (plan,
    params) requests to one executed instance. strict=True raises
    CapacityOverflowError on any request's overflow flag. backend selects
    the primitives ("torch" | "cuda" — bit-identical results). Returns the
    list of per-request (solutions, count, overflow).

    mesh: run on an `EngineMesh` instead, one rank per shard (SPMD: every
    rank calls with the same arguments, runs its own shard on
    ``mesh.device`` and returns the same list; ``device`` is not read).
    """
    check_gather_cap(gather_cap)
    dev = mesh.device if mesh is not None else resolve_device(device)
    if requests is None:
        requests = [(i, None) for i in range(len(bucket.plans))]
    exec_reqs, inverse = dedup_requests(requests, bucket.n_params) if dedup \
        else (requests, None)
    cache = cache if cache is not None else EngineCache()
    fn = cache.get(bucket.signature, join_impl=join_impl,
                   max_per_row=max_per_row, gather_cap=gather_cap, mesh=mesh,
                   backend=backend, kernel_blocks=kernel_blocks)
    pd, params = stage_batch(bucket, exec_reqs, device=dev)
    if mesh is None:
        tr, va, pe = kg_tensors(kg, perms, dev)
    else:
        tr, va, pe = kg_local(kg, mesh, perms)
    table, tmask, overflow = (t.cpu().numpy()
                              for t in fn(tr, va, pe, pd, params))
    if inverse is None:
        out = extract_batch(bucket, exec_reqs, table, tmask, overflow)
    else:
        out = extract_fanout(bucket, exec_reqs, inverse, table, tmask,
                             overflow)
    if strict:
        path = "batched" if mesh is None else "sharded"
        for (_, _, ovf), (idx, _) in zip(out, requests):
            raise_on_overflow(ovf, bucket.plans[idx].query.name, path)
    return out


def run_sharded_batched(bucket: PlanBucket, kg: ShardedKG, mesh,
                        requests: list[tuple[int, np.ndarray | None]] | None
                        = None, **kw):
    """A bucket batch on a mesh, one rank per shard: `run_batched` with
    ``mesh`` (SPMD; every rank gets the same results), the named entry
    point as `federated.run_sharded` is for single plans."""
    return run_batched(bucket, kg, requests, mesh=mesh, **kw)
