"""Federated query execution across the shard axis (paper §3.2 + §4): the
shard blocks of the federated KG, the per-query engine, and the capacity
checks shared by the engines.

Each shard holds its padded triple block. A plan step whose pattern data
lives off the query's primary processing node (PPN) gathers candidate
matches across the shard axis — the tensor analogue of a SERVICE call;
steps whose data is PPN-local never communicate.

The per-query engine (`make_engine`) is the paper's execution path: one
query plan, its steps composed from `engine/local`. Its tensors carry the
shards as an explicit leading dim (and any batch of parameter vectors as
a further one before it), so a cut step's gather is the owner-masked
matches of every shard laid out shard-major and broadcast to every shard
row — the result of an ``all_gather`` under a shard-axis vmap.

On a mesh (`repro_torch.launch.mesh.EngineMesh`, one rank per shard) the
same engine holds the rank's own shard (a shard dim of 1) and a cut
step's gather is a real ``all_gather`` across the ranks, in the same
shard-major order; `run_sharded` runs it SPMD on every rank.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.core.partitioner import Partitioning
from repro_torch.engine.local import (compact, join_step, join_step_sorted,
                                      scan_shard)
from repro_torch.engine.planner import PhysicalPlan
from repro_torch.engine.primitives import check_backend

AXIS = "shards"


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises RuntimeError when a CUDA device
    is asked for and none is available (nothing falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} requested but CUDA is not available; "
            "pass device='cpu' to run on the CPU")
    return dev


class CapacityOverflowError(RuntimeError):
    """A static capacity (scan cap, table cap, gather_cap, or merge-join
    window) was exceeded at run time: the result set is truncated. Raised by
    the runners under ``strict=True``; otherwise the condition is reported
    through the returned overflow flag."""


def check_gather_cap(gather_cap) -> None:
    """Validate a gather_cap argument before any work happens.

    A non-positive capacity would compact every cross-shard gather down to
    nothing — results would be silently empty/truncated rather than an error
    (the overflow flag fires, but only at run time, per request).
    """
    if gather_cap is None:
        return
    if isinstance(gather_cap, bool) or not isinstance(
            gather_cap, (int, np.integer)) or gather_cap < 1:
        raise ValueError(
            f"gather_cap must be a positive int or None, got {gather_cap!r}")


def check_mesh(mesh, n_shards: int, axis_name: str) -> None:
    """A mesh engine's shard axis must be a mesh axis of exactly the
    plan's shard count: each rank holds one shard block (the engines read
    their rank's block), so a smaller axis would silently drop shards and
    a missing axis names no rank per shard."""
    if axis_name not in mesh.axis_names:
        raise ValueError(f"mesh has axes {mesh.axis_names}, engine shard "
                         f"axis {axis_name!r} is not one of them")
    if mesh.shape[axis_name] != n_shards:
        raise ValueError(
            f"mesh axis {axis_name!r} has {mesh.shape[axis_name]} ranks "
            f"but the plan has {n_shards} shards; mesh execution needs "
            "exactly one device per shard (one rank each)")


def pack_outputs(table, tmask, overflow) -> torch.Tensor:
    """An engine's (table (…, R, V), tmask (…, R), overflow (…,)) as one
    int32 tensor (…, R·V + R + 1), so that one collective moves all
    three."""
    lead = table.shape[:-2]
    return torch.cat([table.reshape(*lead, -1),
                      tmask.to(torch.int32).reshape(*lead, -1),
                      overflow.to(torch.int32).reshape(*lead, 1)], dim=-1)


def unpack_outputs(packed: torch.Tensor, r: int, v: int):
    """The inverse of `pack_outputs` for a table of ``r`` rows by ``v``
    columns."""
    lead = packed.shape[:-1]
    return (packed[..., :r * v].reshape(*lead, r, v),
            packed[..., r * v:r * v + r].bool(),
            packed[..., -1].bool())


def gather_matches(mesh, m, mm):
    """A cut step's gather on a mesh: every rank's matches (…, C, 3) and
    mask (…, C), stacked in rank order as (…, S, C, 3) / (…, S, C) on every
    rank. The two go packed in one int32 tensor (the mask as a fourth
    column), so a cut step is one counted all_gather."""
    packed = torch.cat([m, mm[..., None].to(torch.int32)], dim=-1)
    g = torch.stack(mesh.cut_gather(packed), dim=-3)
    return g[..., :3].contiguous(), g[..., 3].bool()


def gather_outputs(mesh, table, tmask, overflow):
    """Every rank's (…, 1, R, V) / (…, 1, R) / (…, 1) outputs laid out
    shard-major as (…, S, R, V) / (…, S, R) / (…, S) on every rank, the
    single-device layout: one all_gather of the three packed."""
    if mesh.size == 1:
        return table, tmask, overflow
    r, v = table.shape[-2:]
    parts = mesh.all_gather(pack_outputs(table, tmask, overflow))
    return unpack_outputs(torch.cat(parts, dim=-2), r, v)


def raise_on_overflow(overflow, query_name: str, path: str) -> None:
    """Shared strict-mode check: one error message for every execution path
    (vmapped / sharded / batched), so callers can match on it."""
    if bool(np.asarray(overflow)):
        raise CapacityOverflowError(
            f"query {query_name!r}: static capacity overflow on the {path} "
            "path — results are truncated; raise the plan's scan/table caps, "
            "gather_cap, or max_per_row")


@dataclass
class ShardedKG:
    triples: np.ndarray   # (n_shards, cap, 3) int32, padded with -1
    valid: np.ndarray     # (n_shards, cap) bool
    n_shards: int
    cap: int

    @staticmethod
    def build(part: Partitioning, *, pad_multiple: int = 64,
              min_cap: int = 0) -> "ShardedKG":
        """Materialize per-shard triple blocks: each shard's primary rows
        (`assign_triples`, every triple exactly once) followed by any
        replicated rows (`part.replica_rows`). min_cap lets a caller keep
        the pre-replication block shape so built engines stay valid."""
        store = part.catalog.store
        assign = part.assign_triples()
        n = part.n_shards
        extra = part.replica_rows() if part.replicas else {}
        sizes = [int((assign == s).sum()) + len(extra.get(s, ()))
                 for s in range(n)]
        cap = max(8, min_cap,
                  int(np.ceil(max(sizes) / pad_multiple)) * pad_multiple)
        tr = np.full((n, cap, 3), -1, dtype=np.int32)
        va = np.zeros((n, cap), dtype=bool)
        for s in range(n):
            rows = store.triples[assign == s]
            rep = extra.get(s)
            if rep is not None:
                rows = np.concatenate([rows, store.triples[rep]])
            tr[s, :rows.shape[0]] = rows
            va[s, :rows.shape[0]] = True
        return ShardedKG(tr, va, n, cap)

    @staticmethod
    def from_arrays(triples, valid) -> "ShardedKG":
        """Shard blocks from existing (n_shards, cap, 3) triples and
        (n_shards, cap) valid arrays, e.g. another build of the same
        partitioning. Raises ValueError on mismatched shapes."""
        tr = np.ascontiguousarray(np.asarray(triples, dtype=np.int32))
        va = np.ascontiguousarray(np.asarray(valid, dtype=bool))
        if tr.ndim != 3 or tr.shape[2] != 3 or va.shape != tr.shape[:2]:
            raise ValueError(f"triples {tr.shape} / valid {va.shape} are not "
                             "(n_shards, cap, 3) / (n_shards, cap)")
        return ShardedKG(tr, va, tr.shape[0], tr.shape[1])

    def to_device(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(triples, valid) as tensors on ``device``."""
        return (torch.from_numpy(self.triples).to(device),
                torch.from_numpy(self.valid).to(device))


# ---------------------------------------------------------------------------
# per-query engine
# ---------------------------------------------------------------------------

def make_engine(plan: PhysicalPlan, *, join_impl: str = "expand",
                max_per_row: int = 64, gather_cap: int | None = None,
                backend: str = "cuda", kernel_blocks=None, mesh=None):
    """Build engine(triples, valid, params) -> (table, mask, overflow).

    triples (S, N, 3) int32 and valid (S, N) bool are the shard blocks;
    params (…, P) int32 one parameter vector, or a batch of them with
    leading dims (…). Results: table (…, S, R, V) int32, mask (…, S, R)
    bool, overflow (…, S) bool — one row per (request, shard), as the JAX
    package's engine under ``vmap(axis_name="shards")``.

    join_impl: "expand" — paper-faithful expand-and-filter join;
               "sorted" — sort-merge join (fan-out up to max_per_row).
    gather_cap: post-gather compaction size (default: keep S * scan_cap).
    backend: "torch" — plain PyTorch primitives; "cuda" — the kg_scan /
    kg_join kernels (plain versions on CPU tensors), bit-identical.
    kernel_blocks is validated as in the JAX package (the kernels fix
    their own tiles).

    mesh: an `EngineMesh` of ``plan.n_shards`` ranks. Each rank then
    passes its own shard block (triples (1, N, 3), valid (1, N)) and gets
    its own rows (…, 1, R, V) / (…, 1, R) / (…, 1); a cut step gathers
    every rank's owner-masked matches with one counted ``all_gather``, in
    the single-device engine's shard-major order.
    """
    check_backend(backend, kernel_blocks)
    S = plan.n_shards
    S_loc = S if mesh is None else 1
    R, V = plan.table_cap, max(1, plan.n_vars)
    steps = [step for step in plan.steps if not step.is_noop]

    def engine(triples: torch.Tensor, valid: torch.Tensor,
               params: torch.Tensor):
        dev = triples.device
        lead = tuple(params.shape[:-1])
        table = torch.full((*lead, S_loc, R, V), -1, dtype=torch.int32,
                           device=dev)
        tmask = torch.zeros((*lead, S_loc, R), dtype=torch.bool, device=dev)
        tmask[..., 0] = True
        overflow = torch.zeros((*lead, S_loc), dtype=torch.bool, device=dev)

        for step in steps:
            spo = [torch.tensor(v, dtype=torch.int32, device=dev)
                   for v in step.consts]
            for pos, pidx in step.param_slots:
                spo[pos] = params[..., pidx]
            s_, p_, o_ = (v[..., None] for v in torch.broadcast_tensors(*spo))
            m, mm, ovf = scan_shard(triples, valid, s_, p_, o_, step.eqs,
                                    step.scan_cap, backend=backend)
            overflow = overflow | ovf

            if step.gather and S > 1:
                # the all_gather: every shard's owner-masked matches in
                # shard-major order, one copy read by every shard row (the
                # scan's leading dims are the params' only where the step
                # reads a parameter; elsewhere they broadcast)
                owner = torch.tensor([i in step.owners for i in range(S)],
                                     device=dev)
                C = S * step.scan_cap
                mlead = m.shape[:-3]
                if mesh is None:
                    m = m.reshape(*mlead, 1, C, 3)
                    mm = (mm & owner[:, None]).reshape(*mlead, 1, C)
                else:   # every rank's block, in rank order
                    m, mm = gather_matches(mesh, m, mm & owner[mesh.rank])
                    m = m.reshape(*mlead, 1, C, 3)
                    mm = mm.reshape(*mlead, 1, C)
                if gather_cap is not None and gather_cap < C:
                    m, mm, ovf2 = compact(m, mm, gather_cap,
                                          backend=backend)
                    overflow = overflow | ovf2
                m = m.expand(*mlead, S_loc, *m.shape[-2:])
                mm = mm.expand(*mlead, S_loc, mm.shape[-1])

            if join_impl == "sorted":
                table, tmask, ovf3 = join_step_sorted(
                    table, tmask, m, mm, step.shared, step.new,
                    max_per_row=max_per_row, backend=backend)
            else:
                table, tmask, ovf3 = join_step(table, tmask, m, mm,
                                               step.shared, step.new,
                                               backend=backend)
            overflow = overflow | ovf3
        return table, tmask, overflow

    return engine


def run_vmapped(plan: PhysicalPlan, kg: ShardedKG,
                params: np.ndarray | None = None, *,
                join_impl: str = "expand", max_per_row: int = 64,
                gather_cap: int | None = None, strict: bool = False,
                backend: str = "cuda", kernel_blocks=None, device="cuda"):
    """Run one query plan with every shard as a leading dim on one device
    (the counterpart of the JAX package's shard-axis vmap). Returns the
    PPN shard's (solutions, count, overflow); strict=True raises
    CapacityOverflowError instead of returning a truncated result."""
    check_gather_cap(gather_cap)
    dev = resolve_device(device)
    engine = make_engine(plan, join_impl=join_impl, max_per_row=max_per_row,
                         gather_cap=gather_cap, backend=backend,
                         kernel_blocks=kernel_blocks)
    p = np.zeros((max(1, plan.n_params),), np.int32) if params is None \
        else np.asarray(params, np.int32)
    triples, valid = kg.to_device(dev)
    res = _extract(plan, *engine(triples, valid, torch.from_numpy(p).to(dev)))
    if strict:
        raise_on_overflow(res[2], plan.query.name, "vmapped")
    return res


def run_sharded(plan: PhysicalPlan, kg: ShardedKG, mesh,
                params: np.ndarray | None = None, *,
                join_impl: str = "expand", max_per_row: int = 64,
                gather_cap: int | None = None, axis: str | None = None,
                strict: bool = False, backend: str = "cuda",
                kernel_blocks=None):
    """Run one query plan on a mesh, one rank per shard (the counterpart
    of the JAX package's ``shard_map`` run).

    SPMD: every rank calls it with the same arguments. Each rank runs the
    engine over its own block of ``kg`` on ``mesh.device``, cut steps
    gather across the ranks, and one gather of the outputs brings the
    PPN's row to every rank, so every rank returns the same (solutions,
    count, overflow). strict=True raises CapacityOverflowError (the
    message names the sharded path) instead of returning a truncated
    result. Raises ValueError on an invalid gather_cap (before the mesh
    is read) and on a mesh without one rank per shard.
    """
    from repro_torch.sharding.rules import kg_local

    check_gather_cap(gather_cap)
    axis = axis or AXIS
    check_mesh(mesh, plan.n_shards, axis)
    engine = make_engine(plan, join_impl=join_impl, max_per_row=max_per_row,
                         gather_cap=gather_cap, backend=backend,
                         kernel_blocks=kernel_blocks, mesh=mesh)
    p = np.zeros((max(1, plan.n_params),), np.int32) if params is None \
        else np.asarray(params, np.int32)
    triples, valid, _ = kg_local(kg, mesh)
    out = engine(triples, valid, torch.from_numpy(p).to(mesh.device))
    res = _extract(plan, *gather_outputs(mesh, *out))
    if strict:
        raise_on_overflow(res[2], plan.query.name, "sharded")
    return res


def lower_engine(plan: PhysicalPlan, kg_shape: tuple[int, int], mesh=None,
                 *, join_impl: str = "expand", max_per_row: int = 64,
                 axis: str = "model") -> dict:
    """Count (not run) the per-query engine of ``plan`` on a mesh: the
    dry run's count of the paper's distributed-join bytes, as the
    reference lowers its engine for the production mesh.

    Rank 0 of a `launch.mesh.MetaEngineMesh` of ``kg_shape[0]`` ranks
    runs `make_engine(..., mesh=)` with the kernels' route on meta
    shard blocks, (cap, 3) int32 triples and (cap,) bool valid, with
    ``kg_shape = (n_shards, cap)``. ``mesh`` (a production mesh, or None)
    only names the axis the shards lie along; its size there must be
    ``n_shards``. Returns {"collectives": the gathers by the reference's
    HLO convention (`MetaEngineMesh.hlo_collectives`), "gathers" and
    "gathered_bytes" (`EngineMesh`'s count), "flops" (the kernels' meta
    operations)}. Each cut step is one all_gather of the rank's
    owner-masked matches with the mask packed as a fourth int32 column
    (`gather_matches`): 16 bytes a row where the reference's lowered
    program gathers the matches (12) and the mask (1) apart."""
    from repro_torch import kernels
    from repro_torch.launch.mesh import MetaEngineMesh
    n, cap = kg_shape
    if mesh is not None and int(mesh.shape[axis]) != n:
        raise ValueError(f"{n} shards on a mesh axis {axis!r} of "
                         f"{mesh.shape[axis]}")
    meta = MetaEngineMesh(n, axis_name=axis)
    engine = make_engine(plan, join_impl=join_impl, max_per_row=max_per_row,
                         backend="cuda", mesh=meta)
    kernels.meta_cost.reset()
    engine(torch.empty((1, cap, 3), dtype=torch.int32, device="meta"),
           torch.empty((1, cap), dtype=torch.bool, device="meta"),
           torch.empty((max(1, plan.n_params),), dtype=torch.int32,
                       device="meta"))
    return {"collectives": meta.hlo_collectives(),
            "gathers": meta.collectives,
            "gathered_bytes": meta.gathered_bytes,
            "flops": kernels.meta_cost.ops}


def _extract(plan: PhysicalPlan, table, tmask, overflow):
    """Pull the PPN shard's solutions, dedup, sort (matching the oracle).
    table (S, R, V), tmask (S, R), overflow (S,): the PPN's rows go to
    the host in one copy."""
    t, m, ov = table[plan.ppn], tmask[plan.ppn], overflow[plan.ppn]
    host = torch.cat([t.reshape(-1), m.to(torch.int32),
                      ov.to(torch.int32).reshape(1)]).cpu().numpy()
    r, v = t.shape
    t = host[:r * v].reshape(r, v)
    m = host[r * v:r * v + r].astype(bool)
    ov = bool(host[-1])
    rows = t[m][:, :plan.n_vars]   # drop the dummy column of 0-var queries
    rows = np.unique(rows, axis=0) if rows.shape[0] \
        else rows.reshape(0, plan.n_vars)
    return rows.astype(np.int32), int(rows.shape[0]), ov
