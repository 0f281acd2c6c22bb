"""Fault-tolerant training runtime.

The port of the reference's `runtime/trainer.py`:
  * checkpoint/restart — auto-resume from the latest checkpoint; a preempted
    run (tests kill it mid-step) continues losslessly;
  * straggler watchdog — per-step wall time EMA; steps slower than
    watchdog_factor x EMA are logged with the input-queue depth so input-side
    stalls (prefetcher ran dry) are distinguished from compute stalls;
  * gradient accumulation over the batch's leading micro-batch axis;
  * optional int8 error-feedback gradient compression.

A step: the cosine LR, the loss and its gradients (`torch.autograd.grad`
over the parameter tree's leaves; under ``grad_accum > 1`` a loop over the
micro-batches stands for the reference's `lax.scan`, summing the gradients
in float32, then dividing), int8 EF, then AdamW in place. The parameters
live in a model whose `param_tree()` is the reference's pytree of its own
tensors; the trainer turns their gradients on and updates them in place,
so the model it returns is the trained one.

On a mesh (``Trainer(mesh=...)``, a `launch.mesh.DeviceMesh` rank; every
rank runs the same Trainer) the state is placed by ``task.param_specs``, a
tree of `sharding.rules.P` (or a function of the parameter tree that
returns one), as the reference's `_shard_state` places it: each rank keeps
its spec's block of every parameter and of AdamW's ``m`` and ``v`` (ZeRO:
the moments mirror the parameters), the step counter on every rank. The
model's whole tensors are freed for the run (their storage refilled with
the trained parameters at its end). A step (FSDP compute, ZeRO-2
gradients, as the reference's cells train) hands the loss a view of the
model over the blocks (`sharding.rules.block_view`): the loss gathers
each leaf where it uses it (`gather_for_compute`; the LM one layer at a
time, inside the layer its ``remat`` recomputes), on this rank's block of
the batch where ``task.batch_specs`` splits it over the data axes (else on
the whole batch; the metrics logged are the ranks' mean, one all_reduce).
The loss is differentiated with respect to the blocks, whose gradients
come out summed over `batch_axis(mesh)` (a reduce-scatter where a dim is
stored over the data axes, else an all_reduce, a leaf a micro-batch) and
are summed over the micro-batches in float32 as blocks, then divided by
the data axes' size; the step clips on the global norm (one all_reduce of
the blocks' squared sums) and updates the blocks. Under
``grad_compression="int8_ef"`` the whole parameters are gathered into the
model's tensors instead, and the data-parallel sum carries each rank's
int8 gradient of the whole leaves and its scale (an all_gather), each rank
keeping its own residual; a checkpoint stores their mean.
``param_specs=None`` on a mesh keeps the state whole on every rank.
A loss that runs its own collectives (the LM's expert-parallel MoE
layers, `models.transformer.loss_fn(..., mesh=)`) closes over the mesh.
Checkpoints are the one-device layout: a run may resume on another mesh.

Where the reference sets ``grad_accum > 1`` its `lax.scan` refuses the
carry it is given (a None beside the metrics dict); the port runs the loop
the scan stands for and keeps the last micro-batch's metrics (ROADMAP,
Queue 3).
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Iterator

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.engine.federated import resolve_device
from repro_torch.optim import adamw_init, adamw_update, cosine_schedule
from repro_torch.optim.compress import ef_compress, ef_decompress, ef_init
from repro_torch.sharding.rules import (Blocks, P, batch_axis,
                                        block_view, check_specs, gather_full,
                                        local_slice, replicated, spec_axes)
from repro_torch.tree import tree_leaves, tree_map, tree_unflatten


@dataclass
class TrainTask:
    """Everything family-specific the trainer needs. ``init_params`` takes
    a `torch.Generator` on ``device`` and returns the model (its
    `param_tree()` holds the parameters); ``loss_fn(model, batch)`` returns
    (scalar loss, metrics dict of scalar tensors)."""
    name: str
    init_params: Callable[[torch.Generator], Any]
    loss_fn: Callable[..., tuple[torch.Tensor, dict]]     # (params, batch)
    batches: Iterator[Any]
    lr: float = 3e-4
    warmup: int = 20
    total_steps: int = 200
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moments_dtype: Any = torch.float32
    grad_accum: int = 1
    grad_compression: str | None = None                # None | "int8_ef"
    device: Any = "cuda"
    param_specs: Any = None                            # P tree, or fn(tree)
    batch_specs: Any = None                            # P tree of the batch


def micro_batch(batch, i: int):
    """Micro-batch ``i`` of a batch whose leaves lead with the micro-batch
    axis (a dict of tensors)."""
    if not isinstance(batch, dict):
        raise TypeError(f"grad_accum needs a dict batch whose tensors lead "
                        f"with the micro-batch axis, got {type(batch)}")
    return {k: v[i] for k, v in batch.items()}


@dataclass
class Trainer:
    task: TrainTask
    mesh: Any = None
    ckpt_dir: str | None = None
    ckpt_every: int = 50
    keep_n: int = 3
    watchdog_factor: float = 3.0
    seed: int = 0
    metrics_log: list = field(default_factory=list)

    def __post_init__(self):
        self.ckpt = (CheckpointManager(self.ckpt_dir, keep_n=self.keep_n)
                     if self.ckpt_dir else None)

    # ------------------------------------------------------------------
    def _grads(self, params, leaves, batch):
        """(metrics, gradients): one per leaf, in the leaf's dtype (float32
        summed over the micro-batches and divided under grad_accum); a
        leaf the loss does not reach gets zeros, as JAX's gradient has."""
        t = self.task

        def one(b):
            loss, metrics = t.loss_fn(params, b)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
            return metrics, [torch.zeros_like(p) if g is None else g
                             for p, g in zip(leaves, grads)]

        if t.grad_accum <= 1:
            return one(batch)
        gsum = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for p in leaves]
        for i in range(t.grad_accum):
            metrics, grads = one(micro_batch(batch, i))
            for acc, g in zip(gsum, grads):
                acc.add_(g)
            del grads
        return metrics, [g.div_(t.grad_accum) for g in gsum]

    def _step(self, params, tree, opt_state, ef_state, batch, step: int):
        t = self.task
        lr = cosine_schedule(step, peak_lr=t.lr, warmup=t.warmup,
                             total=t.total_steps)
        leaves = tree_leaves(tree)
        metrics, grads = self._grads(params, leaves, batch)
        metrics = {k: v.detach() for k, v in metrics.items()}
        grads = tree_unflatten(tree, grads)
        if t.grad_compression == "int8_ef":
            q, scales, ef_state = ef_compress(grads, ef_state)
            grads = ef_decompress(q, scales)
        _, opt_state, om = adamw_update(
            grads, opt_state, tree, lr=lr, weight_decay=t.weight_decay,
            clip_norm=t.clip_norm)
        return ef_state, {**metrics, **om, "lr": lr}

    # ---- the mesh ------------------------------------------------------
    def _specs(self, tree):
        """The parameters' spec tree on the mesh (every leaf whole where
        the task gives none), checked against ``tree``."""
        specs = self.task.param_specs
        if callable(specs):
            specs = specs(tree)
        specs = replicated(tree) if specs is None else specs
        check_specs(tree, specs, self.mesh)
        return specs

    def _state_specs(self, specs, ef_state):
        return {"params": specs, "opt": {"step": P(), "m": specs,
                                         "v": specs},
                "ef": replicated(ef_state)}

    def _dp(self) -> tuple[tuple[str, ...], int]:
        """The mesh's data axes as a tuple, and their size."""
        dp = batch_axis(self.mesh)
        dp = dp if isinstance(dp, tuple) else (dp,)
        return dp, self.mesh.axes_size(dp)

    def _gather_params(self, tree, blocks, specs) -> None:
        """Write the whole parameters, gathered from the blocks, into the
        model's tensors (their storage brought back where it was freed)."""
        with torch.no_grad():
            for full, blk, spec in zip(tree_leaves(tree), tree_leaves(blocks),
                                       tree_leaves(specs)):
                st = full.untyped_storage()
                need = (full.storage_offset() + full.numel()) \
                    * full.element_size()
                if st.nbytes() < need:
                    st.resize_(need)
                full.copy_(gather_full(blk.detach(), spec, self.mesh))

    def _local_batch(self, batch):
        """This rank's block of the batch under ``task.batch_specs`` (the
        whole batch where there are none)."""
        if self.task.batch_specs is None:
            return batch
        return tree_map(lambda b, s: local_slice(b, s, self.mesh), batch,
                        self.task.batch_specs)

    def _ef_grads(self, grads, specs, ef_state):
        """int8 EF's data-parallel reduction of the whole gradients: each
        rank's quantised gradient and scale gathered over the data axes,
        summed, cut to the blocks and divided (returns the new residual
        too)."""
        mesh = self.mesh
        dp, n_dp = self._dp()
        q, scales, ef_state = ef_compress(grads, ef_state)
        grads = tree_map(
            lambda qq, sc: (mesh.all_gather(qq, dp, tiled=False).float()
                            * mesh.all_gather(sc.reshape(1), dp).reshape(
                                -1, *([1] * qq.dim()))).sum(0),
            q, scales)
        out = [local_slice(g, spec, mesh) / n_dp for g, spec in
               zip(tree_leaves(grads), tree_leaves(specs))]
        return tree_unflatten(specs, out), ef_state

    def _mesh_norm(self, grads, specs) -> torch.Tensor:
        """The global norm of the whole gradients from the blocks: each
        block's squared sum over the ranks that hold the same block, one
        all_reduce over the mesh."""
        mesh = self.mesh
        total = 0
        for g, spec in zip(tree_leaves(grads), tree_leaves(specs)):
            copies = mesh.size // mesh.axes_size(spec_axes(spec))
            total = total + torch.sum(torch.square(g.to(torch.float32))) \
                / copies
        total = torch.as_tensor(total, dtype=torch.float32,
                                device=mesh.device).reshape(1)
        return torch.sqrt(mesh.all_reduce(total, mesh.axis_names)[0])

    def _mesh_grads(self, model, blocks, specs, ef_state, batch, *,
                    batch_is_local: bool = False):
        """(metrics, the gradient blocks as AdamW takes them, ef_state) of
        one mesh step; `_mesh_step` states the convention."""
        t = self.task
        batch = batch if batch_is_local else self._local_batch(batch)
        if t.grad_compression == "int8_ef":
            tree = model.param_tree()
            self._gather_params(tree, blocks, specs)
            metrics, grads = self._grads(model, tree_leaves(tree), batch)
            grads, ef_state = self._ef_grads(tree_unflatten(tree, grads),
                                             specs, ef_state)
        else:
            metrics, grads = self._grads(model, tree_leaves(blocks), batch)
            _, n_dp = self._dp()
            grads = tree_unflatten(specs, [g / n_dp if n_dp > 1 else g
                                           for g in grads])
        metrics = self._mesh_metrics({k: v.detach()
                                      for k, v in metrics.items()})
        return metrics, grads, ef_state

    def _mesh_step(self, model, blocks, specs, opt_state, ef_state, batch,
                   step: int, *, batch_is_local: bool = False):
        """One step on the mesh. ``model`` is a view over the blocks
        (`block_view`) whose loss gathers each leaf where it uses it: the
        loss is differentiated with respect to the blocks, whose gradients
        come out summed over the data axes (a reduce-scatter a leaf a
        micro-batch, `gather_for_compute`) and are summed over the
        micro-batches in float32, then divided by the data axes' size.
        Under int8 EF ``model`` holds the whole parameters, gathered into
        it first, and the whole gradients cross the data axes quantised
        (`_ef_grads`). ``batch_is_local`` takes ``batch`` as this rank's
        block already (the dry run hands a rank's blocks).

        The convention: the gradient of the loss a rank hands back is
        the data axes' size times its share of the whole loss's gradient,
        the shares adding up to the whole over the data axes; the sum and
        the division then give the whole loss's gradient. A batch split
        over the data axes into equal blocks meets it with its block's
        mean. A GNN on a graph block (`models.gnn.common.MeshGraph`)
        computes the whole loss on every rank and gets, for each
        replicated leaf, its node block's share of the whole gradient (an
        edge-domain use summed over "model" by `Replicated`), so it hands
        back the loss times the number of node blocks
        (`MeshGraph.trainer_loss`); with the graph whole on every rank
        that number is 1, and every data rank computes the whole
        gradient."""
        t = self.task
        lr = cosine_schedule(step, peak_lr=t.lr, warmup=t.warmup,
                             total=t.total_steps)
        metrics, grads, ef_state = self._mesh_grads(
            model, blocks, specs, ef_state, batch,
            batch_is_local=batch_is_local)
        _, opt_state, om = adamw_update(
            grads, opt_state, blocks, lr=lr, weight_decay=t.weight_decay,
            clip_norm=t.clip_norm, grad_norm=self._mesh_norm(grads, specs))
        return ef_state, {**metrics, **om, "lr": lr}

    def _mesh_metrics(self, metrics: dict) -> dict:
        """The metrics of the whole batch: where the batch is split over
        the data axes, each rank's (means over equal blocks) averaged in
        one all_reduce."""
        dp, n = self._dp()
        if self.task.batch_specs is None or n == 1 or not metrics:
            return metrics
        vals = self.mesh.all_reduce(torch.stack(
            [v.to(torch.float32) for v in metrics.values()]), dp) / n
        return dict(zip(metrics, vals))

    def _saved_ef(self, ef_state):
        """The residual a mesh checkpoint stores: the mean over the data
        axes of the ranks' own."""
        dp, n = self._dp()
        if not self.task.grad_compression or n == 1:
            return ef_state
        return tree_map(lambda r: self.mesh.all_reduce(r, dp) / n, ef_state)

    # ------------------------------------------------------------------
    def run(self, *, steps: int | None = None, resume: bool = True,
            fail_at_step: int | None = None) -> dict:
        """Train. fail_at_step simulates a node failure (tests). On a mesh
        the returned model holds the whole trained parameters on every
        rank, ``blocks`` and ``opt`` this rank's blocks."""
        t = self.task
        dev = resolve_device(t.device)
        mesh = self.mesh
        if mesh is not None and torch.device(mesh.device).type != dev.type:
            raise ValueError(f"the mesh's device {mesh.device} is not the "
                             f"task's {dev}")
        if mesh is not None:
            dev = torch.device(mesh.device)
        steps = steps or t.total_steps
        params = t.init_params(
            torch.Generator(device=dev).manual_seed(self.seed))
        tree = params.param_tree()
        specs = blocks = None
        model = params
        if mesh is not None:
            specs = self._specs(tree)
            blocks = tree_map(lambda p, s: local_slice(
                p.detach(), s, mesh).clone(), tree, specs)
        if mesh is not None and t.grad_compression != "int8_ef":
            # the step computes on the blocks: the whole leaves are freed
            # until the end of the run
            for p in tree_leaves(tree):
                p.untyped_storage().resize_(0)
            for b in tree_leaves(blocks):
                b.requires_grad_(True)
            model = block_view(params, Blocks(blocks, specs, mesh))
        else:
            for p in tree_leaves(tree):
                p.requires_grad_(True)
        state_of = blocks if mesh is not None else tree
        opt_state = adamw_init(state_of, moments_dtype=t.moments_dtype)
        ef_state = (ef_init(tree) if t.grad_compression
                    else {"_": torch.zeros((), device=dev)})
        start = 0

        def live():
            return {"params": state_of, "opt": opt_state, "ef": ef_state}

        shardings = None if mesh is None else (
            mesh, self._state_specs(specs, ef_state))
        if self.ckpt and resume:
            latest = self.ckpt.latest_step()
            if latest is not None:
                saved = self.ckpt.restore(latest, live(), device=dev,
                                          shardings=shardings)
                with torch.no_grad():
                    for dst, src in zip(tree_leaves(live()),
                                        tree_leaves(saved)):
                        dst.copy_(src)
                del saved
                start = latest

        def save(step, **kw):
            if mesh is None:
                self.ckpt.save(step, live(), **kw)
                return
            self.ckpt.save(step, {**live(), "ef": self._saved_ef(ef_state)},
                           shardings=shardings, **kw)

        ema = None
        it = iter(t.batches)
        # skip batches consumed before the checkpoint (deterministic pipeline)
        for _ in range(start):
            next(it)
        for step in range(start, steps):
            batch = next(it)
            t0 = time.perf_counter()
            if mesh is None:
                ef_state, metrics = self._step(params, tree, opt_state,
                                               ef_state, batch, step)
            else:
                ef_state, metrics = self._mesh_step(
                    model, blocks, specs, opt_state, ef_state, batch, step)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            dt = time.perf_counter() - t0
            ema = dt if ema is None else 0.9 * ema + 0.1 * dt
            rec = {k: float(v) for k, v in metrics.items()}
            rec.update(step=step, dt=dt)
            if dt > self.watchdog_factor * ema and step > start + 3:
                depth = getattr(t.batches, "depth", None)
                rec["straggler"] = "input" if depth == 0 else "compute"
            self.metrics_log.append(rec)
            if self.ckpt and (step + 1) % self.ckpt_every == 0:
                save(step + 1)
            if fail_at_step is not None and step + 1 >= fail_at_step:
                self.ckpt and self.ckpt.wait()
                raise RuntimeError(f"simulated node failure at step {step+1}")
        if self.ckpt:
            save(steps, blocking=True)
            self.ckpt.wait()
        if mesh is not None:
            for b in tree_leaves(blocks):
                b.requires_grad_(False)
            self._gather_params(tree, blocks, specs)
        out = {"blocks": blocks} if mesh is not None else {}
        return {**out, "params": params, "opt": opt_state,
                "log": self.metrics_log, "final_loss":
                    self.metrics_log[-1]["loss"] if self.metrics_log else None}
