"""The engines' mesh: one process (rank) per shard on ``torch.distributed``.

The JAX package lays the shard blocks one per device along the mesh axis
``"shards"`` and runs the engines under ``shard_map``, where a cut step's
``all_gather`` is a real collective. The port runs one rank per shard in
a process group: each rank holds its own shard block, launches the
kernels over its own instances, and meets the other ranks only at the
collectives the engines issue.

`EngineMesh` is the port's counterpart of that mesh: its axis name and
size, this process's rank and device, and the process group. It carries
the collectives the engines and the mesh-routed server use, and counts
the cut gathers (`collectives`, `gathered_bytes`): the number of gathers
per engine call is the bucket's WawPart cut count, as the JAX tests count
``all_gather`` ops in the lowered program.

`spawn` starts one process per rank, joins them into a group and runs a
function on each with its mesh. Gloo runs several ranks on one card (each
rank's tensors on ``cuda:0`` when there are fewer cards than ranks; gloo
moves the gathered bytes through host memory); NCCL needs a card per
rank. A mesh of size 1 needs no process group.

The models' mesh is N-dimensional: `MeshShape` holds axis names and sizes
(the reference's `make_production_mesh`, 16 x 16 ``("data", "model")`` or
2 x 16 x 16 ``("pod", "data", "model")``, as a description the sharding
rules read without starting a rank), and `DeviceMesh` is one rank of such
a mesh on ``torch.distributed``: its coordinate (rank-major, the last axis
fastest, as JAX lays devices on `jax.make_mesh`), a process group per line
of every combination of axes, and the collectives along an axis or a tuple
of axes (`all_gather`, `all_reduce` sum and max, `reduce_scatter`), each
counted in calls and bytes. `spawn` with a tuple shape starts one.

`MetaMesh` and `MetaEngineMesh` are one chosen rank of such meshes on
PyTorch's ``meta`` device, with no process group, for the dry run
(`launch.dryrun`): their collectives have the real meshes' signatures and
result shapes, return meta tensors, and count what they would move.
"""
from __future__ import annotations

import datetime
import itertools
import math
import os
import pickle
import shutil
import tempfile
import time
import traceback
from collections import Counter
from pathlib import Path
from typing import Callable

import torch

AXIS = "shards"
# the collective kinds of the reference's HLO count (`collective_bytes`)
HLO_KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute")
BACKENDS = ("gloo", "nccl")
ENGINE_SOURCES = ("kg_scan.cu", "kg_join.cu", "kg_compat.cu")
MODEL_SOURCES = ("flash_attention.cu",)


def _dist():
    import torch.distributed as dist
    return dist


def check_dist_backend(backend: str, n_shards: int) -> None:
    """Raise ValueError on an unknown backend, and on NCCL with fewer cards
    than ranks (NCCL refuses two ranks on one card; nothing switches to
    gloo in its place)."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if backend == "nccl" and torch.cuda.device_count() < n_shards:
        raise ValueError(
            f"backend 'nccl' needs one CUDA card per rank: {n_shards} ranks, "
            f"{torch.cuda.device_count()} cards; use backend='gloo' to run "
            "several ranks on one card")


class _Wire:
    """What every collective hands the backend: the tensor itself, or a
    pinned host copy of it under gloo on CUDA (``_host``)."""

    device: torch.device
    _host: bool

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """The tensor handed to the backend: ``t`` itself, or a pinned
        host copy of it under gloo on CUDA."""
        if not self._host:
            return t.contiguous()
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        return host

    def _unwire(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.device, non_blocking=True) if self._host else t

    def _empty(self, like: torch.Tensor) -> torch.Tensor:
        if self._host:
            return torch.empty(like.shape, dtype=like.dtype, pin_memory=True)
        return torch.empty_like(like)


class EngineMesh(_Wire):
    """One rank's view of the shard mesh.

    ``axis_names`` and ``shape`` read as a JAX mesh's do (one axis);
    ``rank`` is this process's shard, ``device`` where its blocks live.
    The collectives run on the default process group, rooted at rank 0
    where they have a root.
    With gloo on CUDA tensors every collective goes through pinned host
    memory, in one place (`_wire` / `_unwire`): gloo moves bytes between
    host buffers only, and PyTorch's own distributed tests hold gloo's
    CUDA broadcast and all_reduce but run CUDA all_gather and gather on
    NCCL alone.

    ``collectives`` counts the cut gathers (`cut_gather`) and
    ``gathered_bytes`` the bytes they deliver to this rank, the gathered
    tensor whole; the other collectives (commands, the outputs' gather)
    are not counted. ``closed`` is set once the server on rank 0 has
    stopped the other ranks (`repro_torch.launch.serve.stop_workers`),
    ``broken`` (a description) once a dispatch failed with the ranks out
    of step.
    """

    def __init__(self, size: int, rank: int, device: torch.device, *,
                 backend: str = "gloo", axis_name: str = AXIS):
        if not 0 <= rank < size:
            raise ValueError(f"rank {rank} outside a mesh of {size}")
        self.size = size
        self.rank = rank
        self.device = torch.device(device)
        self.backend = backend
        self.axis_name = axis_name
        self.collectives = 0
        self.gathered_bytes = 0
        self.closed = False
        self.broken: str | None = None
        self._keys = 0
        self._host = backend == "gloo" and self.device.type == "cuda"

    @property
    def axis_names(self) -> tuple[str, ...]:
        return (self.axis_name,)

    @property
    def shape(self) -> dict[str, int]:
        return {self.axis_name: self.size}

    def __repr__(self) -> str:
        return (f"EngineMesh({self.shape}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend!r})")

    def new_key(self) -> int:
        """A fresh key for a state sent to the other ranks."""
        self._keys += 1
        return self._keys

    def reset_counts(self) -> None:
        self.collectives = 0
        self.gathered_bytes = 0

    # ---- collectives ---------------------------------------------------

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``t`` (equal shapes on every rank), in rank order,
        on every rank: one all_gather (none on a mesh of one)."""
        if self.size == 1:
            return [t]
        w = self._wire(t)
        parts = [self._empty(w) for _ in range(self.size)]
        _dist().all_gather(parts, w)
        return [self._unwire(p) for p in parts]

    def cut_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        """`all_gather` at a cut step of an engine, counted."""
        parts = self.all_gather(t)
        self.collectives += 1
        self.gathered_bytes += t.numel() * t.element_size() * self.size
        return parts

    def gather(self, t: torch.Tensor) -> list[torch.Tensor] | None:
        """Every rank's ``t`` in rank order on rank 0 (None on the
        others): one gather."""
        if self.size == 1:
            return [t]
        w = self._wire(t)
        parts = [self._empty(w) for _ in range(self.size)] \
            if self.rank == 0 else None
        _dist().gather(w, parts, dst=0)
        return None if parts is None else [self._unwire(p) for p in parts]

    def broadcast_object(self, obj=None):
        """Rank 0's picklable ``obj`` on every rank (tensors in it go as
        CPU tensors)."""
        if self.size == 1:
            return obj
        box = [obj]
        _dist().broadcast_object_list(box, src=0)
        return box[0]


class HloCounts:
    """Collectives counted as the reference counts them in a lowered
    program (`collective_bytes`): by HLO kind, each the bytes of its
    output in the tensor's own dtype, and the number of them."""

    def _hlo_reset(self) -> None:
        self.per_kind_bytes = {k: 0 for k in HLO_KINDS}
        self.per_kind_count = {k: 0 for k in HLO_KINDS}

    def _hlo(self, kind: str, out_bytes: int) -> None:
        self.per_kind_bytes[kind] += int(out_bytes)
        self.per_kind_count[kind] += 1

    def hlo_collectives(self) -> dict:
        """``{"per_kind_bytes", "per_kind_count", "total_bytes"}``, the
        keys of the reference's `collective_bytes`."""
        return {"per_kind_bytes": dict(self.per_kind_bytes),
                "per_kind_count": dict(self.per_kind_count),
                "total_bytes": sum(self.per_kind_bytes.values())}


def _meta_like(t: torch.Tensor, shape=None) -> torch.Tensor:
    return torch.empty(tuple(t.shape if shape is None else shape),
                       dtype=t.dtype, device="meta")


class MetaEngineMesh(EngineMesh, HloCounts):
    """Rank ``rank`` of an engine mesh of ``size`` ranks on the meta
    device: no process group; a gather returns meta tensors of every
    rank's shape (this rank's own tensor at its place). ``collectives``
    and ``gathered_bytes`` count the cut gathers as `EngineMesh` does;
    `hlo_collectives` counts every gather by the reference's HLO
    convention."""

    def __init__(self, size: int, rank: int = 0, *, axis_name: str = AXIS):
        super().__init__(size, rank, torch.device("meta"), backend="meta",
                         axis_name=axis_name)
        self._hlo_reset()

    def __repr__(self) -> str:
        return f"MetaEngineMesh({self.shape}, rank={self.rank})"

    def reset_counts(self) -> None:
        super().reset_counts()
        self._hlo_reset()

    def all_gather(self, t: torch.Tensor) -> list[torch.Tensor]:
        if self.size == 1:
            return [t]
        self._hlo("all-gather", t.numel() * t.element_size() * self.size)
        return [t if r == self.rank else _meta_like(t)
                for r in range(self.size)]

    def gather(self, t: torch.Tensor) -> list[torch.Tensor] | None:
        if self.size == 1:
            return [t]
        if self.rank != 0:
            return None
        return [t if r == 0 else _meta_like(t) for r in range(self.size)]

    def broadcast_object(self, obj=None):
        return obj


def make_engine_mesh(n_shards: int, *, device="cuda", backend: str = "gloo",
                     axis_name: str = AXIS) -> EngineMesh:
    """This process's mesh of ``n_shards`` ranks over the initialised
    default process group (rank = the group's rank). A mesh of one needs
    no group.

    On CUDA each rank uses ``cuda:<rank>`` when there are at least as many
    cards as ranks, else ``cuda:0`` (several gloo ranks on one card).
    Raises ValueError on NCCL with fewer cards than ranks, on a group of
    another size or backend, and RuntimeError when ``device`` is CUDA and
    no card is available (nothing falls back to the CPU).
    """
    from repro_torch.engine.federated import resolve_device
    check_dist_backend(backend, n_shards)
    dev = resolve_device(device)
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("backend 'nccl' needs device 'cuda'")
    dist = _dist()
    if dist.is_available() and dist.is_initialized():
        size, rank = dist.get_world_size(), dist.get_rank()
        if size != n_shards:
            raise ValueError(f"the process group has {size} ranks, the mesh "
                             f"{n_shards} shards")
        if dist.get_backend() != backend:
            raise ValueError(f"the process group runs {dist.get_backend()!r}"
                             f", the mesh asks for {backend!r}")
    elif n_shards == 1:
        size, rank = 1, 0
    else:
        raise RuntimeError(f"a mesh of {n_shards} shards needs an "
                           "initialised process group (see spawn)")
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank
                           if torch.cuda.device_count() >= size else 0)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return EngineMesh(size, rank, dev, backend=backend, axis_name=axis_name)


class MeshShape:
    """A mesh's axis names and sizes, and the coordinates of its ranks.

    ``shape`` maps each axis to its size and ``axis_names`` lists the
    axes, as a JAX mesh's do, so the sharding rules read either. Rank r
    sits at ``coords(r)``: r unravelled over the sizes, the last axis
    fastest."""

    def __init__(self, sizes, axis_names):
        sizes, axis_names = tuple(int(n) for n in sizes), tuple(axis_names)
        if len(sizes) != len(axis_names) or len(set(axis_names)) \
                != len(axis_names) or min(sizes, default=0) < 1:
            raise ValueError(f"a mesh needs one size >= 1 per distinct axis, "
                             f"got sizes {sizes} for axes {axis_names}")
        self.sizes = sizes
        self.axis_names = axis_names
        self.shape = dict(zip(axis_names, sizes))
        self.size = math.prod(sizes)

    def __repr__(self) -> str:
        return f"MeshShape({self.shape})"

    def axes(self, axes) -> tuple[str, ...]:
        """``axes`` (a name or a tuple of names) as a tuple, each checked."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        for a in axes:
            if a not in self.shape:
                raise ValueError(f"axis {a!r} is not one of the mesh's "
                                 f"{self.axis_names}")
        return axes

    def axes_size(self, axes) -> int:
        return math.prod(self.shape[a] for a in self.axes(axes))

    def coords(self, rank: int) -> dict[str, int]:
        out = {}
        for a, n in zip(reversed(self.axis_names), reversed(self.sizes)):
            rank, out[a] = divmod(rank, n)
        return out

    def index_of(self, rank: int, axes) -> int:
        """Rank ``rank``'s index along ``axes`` taken together, the first
        axis slowest (the reference's ``off * size + axis_index``)."""
        c, idx = self.coords(rank), 0
        for a in self.axes(axes):
            idx = idx * self.shape[a] + c[a]
        return idx


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """The reference's production mesh: 16 x 16 ("data", "model"), or
    2 x 16 x 16 ("pod", "data", "model") across two pods, as a
    description (no rank is started)."""
    if multi_pod:
        return MeshShape((2, 16, 16), ("pod", "data", "model"))
    return MeshShape((16, 16), ("data", "model"))


class DeviceMesh(MeshShape, _Wire):
    """One rank of an N-dimensional mesh on ``torch.distributed``.

    Every rank builds, in the same order, one process group per line of
    every combination of axes whose size is above one (the ranks that
    differ only along those axes); the whole mesh is the default group.
    The collectives run along an axis or a tuple of axes; along axes of
    size one they are the identity and count nothing. Pieces gathered
    along a tuple of axes come in the tuple's order (first axis slowest).
    Under gloo on CUDA every collective goes through pinned host memory
    (`_Wire`), and the card holds only each collective's result (the host
    gathers, converts and sums); bfloat16 gathers as its raw bytes and
    bfloat16 sums and maxima in float32, cast back. A reduce-scatter sums
    each block in the line's order (one all_to_all_single, then a sum on
    the rank), so its result does not depend on the tensor's size, as a
    ring's does: a layer's slice reduce-scattered alone sums as it would
    inside its stack. ``calls`` and ``bytes`` count each
    collective by name (the bytes it delivers to this rank: the gathered
    tensor whole, the reduced tensor, the scattered input; a gather to
    rank 0 counts what rank 0 receives and what each other rank sends)."""

    def __init__(self, sizes, axis_names, rank: int, device, *,
                 backend: str = "gloo"):
        super().__init__(sizes, axis_names)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.device = torch.device(device)
        self.backend = backend
        self.calls: Counter = Counter()
        self.bytes: Counter = Counter()
        self._host = backend == "gloo" and self.device.type == "cuda"
        self._groups: dict[tuple[str, ...], tuple] = {}
        if self.size == 1:
            return
        dist = _dist()
        for k in range(1, len(self.axis_names) + 1):
            for combo in itertools.combinations(self.axis_names, k):
                if self.axes_size(combo) == 1:
                    continue
                if k == len(self.axis_names):
                    self._groups[combo] = (dist.group.WORLD,
                                           tuple(range(self.size)))
                    continue
                for line in self._lines(combo):
                    group = dist.new_group(list(line))
                    if rank in line:
                        self._groups[combo] = (group, line)

    def _lines(self, combo) -> list[tuple[int, ...]]:
        """The rank sets that differ only along ``combo``, in a fixed
        order."""
        lines: dict = {}
        for r in range(self.size):
            c = self.coords(r)
            key = tuple(c[a] for a in self.axis_names if a not in combo)
            lines.setdefault(key, []).append(r)
        return [tuple(v) for _, v in sorted(lines.items())]

    def __repr__(self) -> str:
        return (f"DeviceMesh({self.shape}, rank={self.rank}, "
                f"device={self.device}, backend={self.backend!r})")

    def axis_index(self, axes) -> int:
        """This rank's index along ``axes`` (a name or a tuple)."""
        return self.index_of(self.rank, axes)

    def reset_counts(self) -> None:
        self.calls.clear()
        self.bytes.clear()

    def _line(self, axes):
        """(group, members in order of ``axes``' combined index), or None
        where ``axes`` span one rank."""
        axes = tuple(a for a in self.axes(axes) if self.shape[a] > 1)
        if not axes:
            return None
        group, members = self._groups[tuple(a for a in self.axis_names
                                            if a in axes)]
        return group, sorted(members, key=lambda r: self.index_of(r, axes))

    def _count(self, name: str, t: torch.Tensor, factor: int = 1) -> None:
        self.calls[name] += 1
        self.bytes[name] += t.numel() * t.element_size() * factor

    def all_gather(self, t: torch.Tensor, axes, dim: int = 0, *,
                   tiled: bool = True) -> torch.Tensor:
        """Every rank's ``t`` along ``axes``, concatenated along ``dim``
        (``tiled``) or stacked in a new leading dim, on every rank of the
        line."""
        line = self._line(axes)
        if line is None:
            return t if tiled else t[None]
        group, members = line
        self._count("all_gather", t, len(members))
        raw = t.contiguous().view(torch.uint8) \
            if t.dtype == torch.bfloat16 else t
        w = self._wire(raw)
        parts = [self._empty(w) for _ in members]
        _dist().all_gather(parts, w, group=group)
        # the backend orders the parts by rank
        by_rank = dict(zip(sorted(members), parts))
        pieces = [by_rank[r] for r in members]
        if t.dtype == torch.bfloat16:
            pieces = [p.view(torch.bfloat16) for p in pieces]
        if not self._host:
            return torch.cat(pieces, dim) if tiled else torch.stack(pieces)
        shape = list(t.shape)
        if tiled:
            shape[dim] *= len(members)
        else:
            shape.insert(0, len(members))
        out = torch.empty(shape, dtype=t.dtype, device=self.device)
        views = out.split(t.shape[dim], dim) if tiled else out.unbind(0)
        for v, p in zip(views, pieces):
            v.copy_(p, non_blocking=True)
        return out

    def all_reduce(self, t: torch.Tensor, axes, op: str = "sum"
                   ) -> torch.Tensor:
        """The sum (or maximum) of every rank's ``t`` along ``axes``, on
        every rank of the line; a new tensor."""
        if op not in ("sum", "max"):
            raise ValueError(f"all_reduce op must be 'sum' or 'max', got "
                             f"{op!r}")
        line = self._line(axes)
        if line is None:
            return t.clone()
        self._count("all_reduce", t)
        group, _ = line
        w = self._wire(t)
        if t.dtype == torch.bfloat16:
            w = w.float()
        elif w.data_ptr() == t.data_ptr():
            w = w.clone()
        dist = _dist()
        dist.all_reduce(w, op=dist.ReduceOp.SUM if op == "sum"
                        else dist.ReduceOp.MAX, group=group)
        return self._unwire(w.to(t.dtype))

    def reduce_scatter(self, t: torch.Tensor, axes, dim: int = 0
                       ) -> torch.Tensor:
        """This rank's block along ``dim`` of the sum of every rank's
        ``t`` along ``axes`` (``dim`` divides by the line's size): each
        rank receives only its own block's sum."""
        line = self._line(axes)
        if line is None:
            return t
        group, members = line
        n = len(members)
        if t.shape[dim] % n:
            raise ValueError(f"reduce_scatter of dim {dim} ({t.shape[dim]}) "
                             f"over {n} ranks")
        self._count("reduce_scatter", t)
        # block i goes to the line's i-th rank in rank order, and block i
        # of what comes back is that rank's
        by_rank = dict(zip(members, t.chunk(n, dim)))
        ordered = [by_rank[r] for r in sorted(members)]
        k = ordered[0].numel()
        kw = dict(pin_memory=True) if self._host else dict(device=t.device)
        send = torch.empty(n * k, dtype=t.dtype, **kw)
        for i, blk in enumerate(ordered):
            send[i * k:(i + 1) * k].view(blk.shape).copy_(blk)
        recv = torch.empty_like(send)
        raw = (lambda x: x.view(torch.uint8)) \
            if t.dtype == torch.bfloat16 else (lambda x: x)
        _dist().all_to_all_single(raw(recv), raw(send), group=group)
        got = dict(zip(sorted(members), recv.view(n, *ordered[0].shape)))
        first = got[members[0]]
        acc = first.float() if t.dtype == torch.bfloat16 else first.clone()
        for r in members[1:]:
            acc += got[r]
        return self._unwire(acc.to(t.dtype))

    def gather_to_root(self, t: torch.Tensor) -> list | None:
        """Every rank's ``t`` (equal shapes), in rank order, as host
        tensors on rank 0 (None on the others): one gather over the whole
        mesh."""
        if self.size == 1:
            return [t.cpu()]
        self._count("gather", t, self.size if self.rank == 0 else 1)
        raw = t.contiguous().view(torch.uint8) \
            if t.dtype == torch.bfloat16 else t
        w = self._wire(raw)
        parts = [self._empty(w) for _ in range(self.size)] \
            if self.rank == 0 else None
        _dist().gather(w, parts, dst=0)
        if parts is None:
            return None
        return [(p.view(torch.bfloat16) if t.dtype == torch.bfloat16
                 else p).cpu() for p in parts]

    def barrier(self) -> None:
        """Every rank of the mesh meets here (uncounted)."""
        if self.size > 1:
            _dist().barrier()


class MetaMesh(MeshShape, HloCounts):
    """Rank ``rank`` (default 0) of an N-dimensional mesh of any size on
    the meta device, with no process group: the dry run's mesh.

    `axis_index`, `all_gather`, `all_reduce`, `reduce_scatter`,
    `gather_to_root` and `barrier` take `DeviceMesh`'s arguments and give
    its result shapes and dtypes, as meta tensors, so the model paths'
    autograd collectives (`sharding.rules`) run on it unchanged. Along
    axes of size one they are the identity, as on `DeviceMesh`, and count
    nothing. ``calls`` and ``bytes`` count by name as `DeviceMesh` does
    (the gathered tensor whole, the reduced tensor, the scattered input, a
    gather to rank 0 what rank 0 receives or the others send);
    `hlo_collectives` counts by the reference's HLO convention (the
    output's bytes in its own dtype: a bfloat16 sum is 2 bytes an
    element, whatever a backend's wire carries). The port issues no
    all-to-all and no collective-permute; those stay 0."""

    def __init__(self, sizes, axis_names, rank: int = 0):
        super().__init__(sizes, axis_names)
        if not 0 <= rank < self.size:
            raise ValueError(f"rank {rank} outside a mesh of {self.size}")
        self.rank = rank
        self.device = torch.device("meta")
        self.backend = "meta"
        self.calls: Counter = Counter()
        self.bytes: Counter = Counter()
        self._hlo_reset()

    def __repr__(self) -> str:
        return f"MetaMesh({self.shape}, rank={self.rank})"

    def axis_index(self, axes) -> int:
        return self.index_of(self.rank, axes)

    def reset_counts(self) -> None:
        self.calls.clear()
        self.bytes.clear()
        self._hlo_reset()

    def _count(self, name: str, t: torch.Tensor, factor: int = 1) -> None:
        self.calls[name] += 1
        self.bytes[name] += t.numel() * t.element_size() * factor

    def all_gather(self, t: torch.Tensor, axes, dim: int = 0, *,
                   tiled: bool = True) -> torch.Tensor:
        n = self.axes_size(axes)
        if n == 1:
            return t if tiled else t[None]
        self._count("all_gather", t, n)
        self._hlo("all-gather", t.numel() * t.element_size() * n)
        if not tiled:
            return _meta_like(t, (n, *t.shape))
        shape = list(t.shape)
        shape[dim] *= n
        return _meta_like(t, shape)

    def all_reduce(self, t: torch.Tensor, axes, op: str = "sum"
                   ) -> torch.Tensor:
        if op not in ("sum", "max"):
            raise ValueError(f"all_reduce op must be 'sum' or 'max', got "
                             f"{op!r}")
        if self.axes_size(axes) == 1:
            return t.clone()
        self._count("all_reduce", t)
        self._hlo("all-reduce", t.numel() * t.element_size())
        return _meta_like(t)

    def reduce_scatter(self, t: torch.Tensor, axes, dim: int = 0
                       ) -> torch.Tensor:
        n = self.axes_size(axes)
        if n == 1:
            return t
        if t.shape[dim] % n:
            raise ValueError(f"reduce_scatter of dim {dim} ({t.shape[dim]}) "
                             f"over {n} ranks")
        self._count("reduce_scatter", t)
        self._hlo("reduce-scatter", t.numel() * t.element_size() // n)
        shape = list(t.shape)
        shape[dim] //= n
        return _meta_like(t, shape)

    def gather_to_root(self, t: torch.Tensor) -> list | None:
        if self.size == 1:
            return [t]
        self._count("gather", t, self.size if self.rank == 0 else 1)
        if self.rank != 0:
            return None
        return [t if r == 0 else _meta_like(t) for r in range(self.size)]

    def barrier(self) -> None:
        """Nothing to meet: the other ranks do not run."""


def make_device_mesh(sizes, axis_names, *, device="cuda",
                     backend: str = "gloo") -> DeviceMesh:
    """This process's rank of a mesh of ``sizes`` over ``axis_names`` on
    the initialised default process group (whose size must be the mesh's;
    a mesh of one needs no group). Devices as `make_engine_mesh` picks
    them."""
    shape = MeshShape(sizes, axis_names)
    base = make_engine_mesh(shape.size, device=device, backend=backend)
    return DeviceMesh(shape.sizes, shape.axis_names, base.rank, base.device,
                      backend=backend)


def make_local_mesh(*, device="cuda", backend: str = "gloo") -> DeviceMesh:
    """The reference's local mesh: one "data" axis over the local ranks
    (the initialised process group's, or this process alone)."""
    dist = _dist()
    n = dist.get_world_size() if dist.is_available() \
        and dist.is_initialized() else 1
    return make_device_mesh((n,), ("data",), device=device, backend=backend)


class SpawnError(RuntimeError):
    """One or more ranks of a `spawn` failed. ``results`` holds each
    rank's return value (None where it failed) and ``errors`` each
    rank's traceback or exit status (None where it returned)."""

    def __init__(self, results: list, errors: list):
        self.results = results
        self.errors = errors
        failed = [r for r, e in enumerate(errors) if e is not None]
        first = errors[failed[0]]
        super().__init__(f"ranks {failed} of {len(errors)} failed; rank "
                         f"{failed[0]}:\n{first}")


def _rank_main(rank: int, shape, fn, args, backend: str, device,
               timeout: float, run_dir: str) -> None:
    """One rank: join the group, build the mesh (an `EngineMesh` for an
    int ``shape``, a `DeviceMesh` for a (sizes, axis names) pair), run
    ``fn`` and write its result (or its traceback) to ``run_dir``."""
    n_shards = shape if isinstance(shape, int) else math.prod(shape[0])
    out = Path(run_dir) / f"rank{rank}.pkl"
    try:
        if backend == "gloo":
            os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        dist = _dist()
        dist.init_process_group(
            backend, init_method=f"file://{run_dir}/rendezvous", rank=rank,
            world_size=n_shards, timeout=datetime.timedelta(seconds=timeout))
        mesh = (make_engine_mesh(n_shards, device=device, backend=backend)
                if isinstance(shape, int) else
                make_device_mesh(*shape, device=device, backend=backend))
        payload = ("ok", fn(mesh, *args))
    except BaseException:
        payload = ("error", traceback.format_exc())
    with open(out.with_suffix(".tmp"), "wb") as f:
        pickle.dump(payload, f)
    os.replace(out.with_suffix(".tmp"), out)
    if payload[0] != "ok":
        os._exit(1)
    _dist().destroy_process_group()


def spawn(n_shards, fn: Callable, *args, backend: str = "gloo",
          device="cuda", timeout: float = 60.0,
          join_timeout: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on new processes, one a rank, and return
    their results in rank order.

    An int ``n_shards`` starts that many ranks of the engines' 1-D
    `EngineMesh`; a pair of sizes starts a ("data", "model") `DeviceMesh`
    of those sizes, one rank per coordinate. ``fn`` and ``args`` are
    pickled (``fn`` by its import path). Each process joins a gloo or NCCL
    group through a file rendezvous in a fresh temporary directory, with
    ``timeout`` seconds on every collective; on the CPU it runs one
    intra-op thread. The kernels the ranks run (the engine's for a 1-D
    mesh, flash attention for a `DeviceMesh`) are built once here, before
    the ranks start.

    A rank that fails does not hang the others: a collective with a dead
    peer fails on the live ranks, at the latest after ``timeout``. The
    processes get ``join_timeout`` seconds in all, and a failure's peers
    ``timeout`` more to report theirs; processes still running then are
    terminated. Raises `SpawnError` when a rank raised, exited non-zero or
    was terminated, ValueError for NCCL with too few cards and
    RuntimeError for a CUDA device without a card.
    """
    from repro_torch.engine.federated import resolve_device
    if isinstance(n_shards, int):
        shape, n_ranks = n_shards, n_shards
    else:
        shape = (tuple(n_shards), ("data", "model"))
        n_ranks = MeshShape(*shape).size
    check_dist_backend(backend, n_ranks)
    if resolve_device(device).type == "cuda":
        from repro_torch import kernels
        kernels.build(ENGINE_SOURCES if isinstance(shape, int)
                      else MODEL_SOURCES)
    ctx = torch.multiprocessing.get_context("spawn")
    run_dir = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, shape, fn, args, backend, str(device),
                               timeout, run_dir))
             for r in range(n_ranks)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + join_timeout
        while any(p.is_alive() for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                deadline = min(deadline, time.monotonic() + timeout + 10)
            if time.monotonic() > deadline:
                break
            time.sleep(0.05)
        results, errors = [], []
        for r, p in enumerate(procs):
            if p.is_alive():
                p.terminate()
                p.join(10)
                results.append(None)
                errors.append(f"rank {r} still running after the deadline; "
                              "terminated")
                continue
            p.join()
            path = Path(run_dir) / f"rank{r}.pkl"
            if not path.exists():
                results.append(None)
                errors.append(f"rank {r} exited with status {p.exitcode} "
                              "and no result")
                continue
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            results.append(value if status == "ok" else None)
            errors.append(None if status == "ok" else value)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        shutil.rmtree(run_dir, ignore_errors=True)
    if any(e is not None for e in errors):
        raise SpawnError(results, errors)
    return results
