"""Fault-tolerant checkpointing: atomic, async, keep-N.

The port of the reference's `checkpoint/manager.py`, in its format:
checkpoints are written as a flat npz (leaf path -> host array, the paths
the reference's `tree_flatten_with_path` gives: ``params/embed``,
``opt/m/mlp/0/w``, ``opt/step``, ``ef/_``) plus a json manifest, to a temp
dir renamed into place (atomic on POSIX) — a killed writer never corrupts
the latest checkpoint. An optional background thread overlaps
serialization with the next train steps (async checkpointing). A
checkpoint written by either package restores in the other: bfloat16
leaves are stored as their raw 16 bits (npz dtype ``|V2``), as numpy
writes JAX's bfloat16 arrays.

The host copies are taken on the caller's thread (the trainer updates its
tensors in place after). Restore is mesh-agnostic, as the reference's:
the arrays are keyed by logical path, so a checkpoint written on one
topology restores onto another (the elastic-rescale path). On a mesh
(``shardings=(mesh, spec tree)``, a `DeviceMesh` rank and a tree of
`sharding.rules.P` of the tree's structure) `save` gathers each leaf from
the ranks' blocks and rank 0 writes the one-device layout, and `restore`
gives each rank its block of each leaf.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.tree import (leaves_with_path, tree_leaves, tree_map,
                              tree_unflatten)


def to_host(leaf) -> np.ndarray:
    """A copy of ``leaf`` as a host numpy array; bfloat16 as raw |V2."""
    if not isinstance(leaf, torch.Tensor):
        return np.array(leaf, copy=True)
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view("V2")
    return t.numpy()


def from_host(a: np.ndarray, device) -> torch.Tensor:
    """A stored array as a tensor on ``device``; |V2 as bfloat16."""
    a = np.asarray(a)
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(a.view(np.int16).copy()) \
            .view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def tree_from_jax(tree, *, device="cuda"):
    """A tree of the reference's arrays (JAX or numpy: an AdamW state, an
    EF residual, parameters) as tensors on ``device``, in their dtypes,
    bfloat16 included; None stays None. The models carry their parameters
    with their own `from_jax`."""
    dev = torch.device(device)
    return tree_map(lambda a: from_host(a, dev), tree)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {path: to_host(leaf) for path, leaf in leaves_with_path(tree)}


def _unflatten(tree_like, flat: dict, device):
    return tree_unflatten(tree_like, [from_host(flat[path], device)
                                      for path, _ in
                                      leaves_with_path(tree_like)])


class CheckpointManager:
    def __init__(self, directory: str, *, keep_n: int = 3,
                 async_write: bool = True):
        self.dir = directory
        self.keep_n = keep_n
        self.async_write = async_write
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # ---- save -----------------------------------------------------------
    def save(self, step: int, tree, *, blocking: bool = False,
             extra: dict | None = None, shardings=None):
        """Write ``tree`` as step ``step``. With ``shardings`` every rank
        of the mesh calls it with its blocks: each leaf's blocks are
        gathered to rank 0 (host memory), which puts them together and
        alone writes; a blocking save ends with every rank past the
        write."""
        if shardings is not None:
            from repro_torch.sharding.rules import assemble
            mesh, specs = shardings
            whole = []
            for leaf, spec in zip(tree_leaves(tree), tree_leaves(specs)):
                blocks = mesh.gather_to_root(leaf.detach())
                whole.append(None if blocks is None
                             else assemble(blocks, spec, mesh))
                del blocks
            if mesh.rank == 0:
                self.save(step, tree_unflatten(tree, whole),
                          blocking=blocking, extra=extra)
            if blocking:
                mesh.barrier()
            return
        flat = _flatten(tree)   # host copies happen on the caller thread
        if self.async_write and not blocking:
            self.wait()
            self._thread = threading.Thread(
                target=self._write, args=(step, flat, extra), daemon=True)
            self._thread.start()
        else:
            self.wait()  # never race a pending async write of the same step
            self._write(step, flat, extra)

    _seq = 0

    def _write(self, step: int, flat: dict, extra: dict | None):
        CheckpointManager._seq += 1
        tmp = os.path.join(
            self.dir, f".tmp-{step}-{os.getpid()}-{CheckpointManager._seq}")
        os.makedirs(tmp, exist_ok=True)
        np.savez(os.path.join(tmp, "arrays.npz"), **flat)
        manifest = {"step": step, "time": time.time(),
                    "keys": sorted(flat), "extra": extra or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
        final = os.path.join(self.dir, f"step-{step:012d}")
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        self._gc()

    def wait(self):
        if self._thread is not None and self._thread.is_alive():
            self._thread.join()

    def _gc(self):
        steps = self.all_steps()
        for s in steps[:-self.keep_n]:
            shutil.rmtree(os.path.join(self.dir, f"step-{s:012d}"),
                          ignore_errors=True)

    # ---- restore --------------------------------------------------------
    def all_steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step-"):
                if os.path.exists(os.path.join(self.dir, name,
                                               "manifest.json")):
                    out.append(int(name.split("-")[1]))
        return sorted(out)

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, tree_like, *, device="cpu",
                shardings=None):
        """A tree of the structure of ``tree_like`` holding the step's
        arrays, as tensors on ``device``, in the dtypes they were saved in.
        With ``shardings`` each leaf is this rank's block under its spec,
        on the mesh's device (the mesh may differ from the one that wrote
        the checkpoint: elastic)."""
        path = os.path.join(self.dir, f"step-{step:012d}", "arrays.npz")
        if shardings is None:
            with np.load(path) as z:
                flat = {k: z[k] for k in z.files}
            return _unflatten(tree_like, flat, torch.device(device))
        from repro_torch.sharding.rules import local_slice
        mesh, specs = shardings
        spec_of = dict(leaves_with_path(specs))
        blocks = []
        with np.load(path) as z:    # one leaf in host memory at a time
            for key, _ in leaves_with_path(tree_like):
                whole = from_host(z[key], "cpu")
                blocks.append(local_slice(whole, spec_of[key], mesh).to(
                    mesh.device, copy=True))
                del whole
        return tree_unflatten(tree_like, blocks)

    def restore_latest(self, tree_like, *, device="cpu", shardings=None):
        step = self.latest_step()
        if step is None:
            return None, None
        return step, self.restore(step, tree_like, device=device,
                                  shardings=shardings)
