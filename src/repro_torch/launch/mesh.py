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
"""
from __future__ import annotations

import datetime
import os
import pickle
import shutil
import tempfile
import time
import traceback
from pathlib import Path
from typing import Callable

import torch

AXIS = "shards"
BACKENDS = ("gloo", "nccl")
ENGINE_SOURCES = ("kg_scan.cu", "kg_join.cu", "kg_compat.cu")


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


class EngineMesh:
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


def _rank_main(rank: int, n_shards: int, fn, args, backend: str, device,
               timeout: float, run_dir: str) -> None:
    """One rank: join the group, build the mesh, run ``fn`` and write
    its result (or its traceback) to ``run_dir``."""
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
        mesh = make_engine_mesh(n_shards, device=device, backend=backend)
        payload = ("ok", fn(mesh, *args))
    except BaseException:
        payload = ("error", traceback.format_exc())
    with open(out.with_suffix(".tmp"), "wb") as f:
        pickle.dump(payload, f)
    os.replace(out.with_suffix(".tmp"), out)
    if payload[0] != "ok":
        os._exit(1)
    _dist().destroy_process_group()


def spawn(n_shards: int, fn: Callable, *args, backend: str = "gloo",
          device="cuda", timeout: float = 60.0,
          join_timeout: float = 600.0) -> list:
    """Run ``fn(mesh, *args)`` on ``n_shards`` new processes, one a rank,
    and return their results in rank order.

    ``fn`` and ``args`` are pickled (``fn`` by its import path). Each
    process joins a gloo or NCCL group through a file rendezvous in a
    fresh temporary directory, with ``timeout`` seconds on every
    collective; on the CPU it runs one intra-op thread. The engine's
    kernels are built once here, before the ranks start.

    A rank that fails does not hang the others: a collective with a dead
    peer fails on the live ranks, at the latest after ``timeout``. The
    processes get ``join_timeout`` seconds in all, and a failure's peers
    ``timeout`` more to report theirs; processes still running then are
    terminated. Raises `SpawnError` when a rank raised, exited non-zero or
    was terminated, ValueError for NCCL with too few cards and
    RuntimeError for a CUDA device without a card.
    """
    from repro_torch.engine.federated import resolve_device
    check_dist_backend(backend, n_shards)
    if resolve_device(device).type == "cuda":
        from repro_torch import kernels
        kernels.build(ENGINE_SOURCES)
    ctx = torch.multiprocessing.get_context("spawn")
    run_dir = tempfile.mkdtemp(prefix="repro_torch_mesh_")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n_shards, fn, args, backend, str(device),
                               timeout, run_dir))
             for r in range(n_shards)]
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
