"""Fault-tolerant training runtime.

The port of the reference's `runtime/trainer.py`, on one device:
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

The reference's jitted step also runs sharded on a mesh (`mesh`,
`param_specs`, ZeRO moments); that is not ported (ROADMAP, Queue 1 item 5)
and `Trainer` raises if a mesh is given. Where the reference sets
``grad_accum > 1`` its `lax.scan` refuses the carry it is given (a None
beside the metrics dict); the port runs the loop the scan stands for and
keeps the last micro-batch's metrics (ROADMAP, Queue 3).
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
from repro_torch.tree import tree_leaves, tree_unflatten


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
        if self.mesh is not None:
            raise NotImplementedError(
                "Trainer(mesh=...): sharded training (param_specs, ZeRO "
                "moments) is not ported yet (ROADMAP, Queue 1 item 5)")
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

    # ------------------------------------------------------------------
    def run(self, *, steps: int | None = None, resume: bool = True,
            fail_at_step: int | None = None) -> dict:
        """Train. fail_at_step simulates a node failure (tests)."""
        t = self.task
        dev = resolve_device(t.device)
        steps = steps or t.total_steps
        params = t.init_params(
            torch.Generator(device=dev).manual_seed(self.seed))
        tree = params.param_tree()
        for p in tree_leaves(tree):
            p.requires_grad_(True)
        opt_state = adamw_init(tree, moments_dtype=t.moments_dtype)
        ef_state = (ef_init(tree) if t.grad_compression
                    else {"_": torch.zeros((), device=dev)})
        start = 0

        if self.ckpt and resume:
            latest = self.ckpt.latest_step()
            if latest is not None:
                live = {"params": tree, "opt": opt_state, "ef": ef_state}
                saved = self.ckpt.restore(latest, live, device=dev)
                with torch.no_grad():
                    for dst, src in zip(tree_leaves(live),
                                        tree_leaves(saved)):
                        dst.copy_(src)
                del saved
                start = latest

        ema = None
        it = iter(t.batches)
        # skip batches consumed before the checkpoint (deterministic pipeline)
        for _ in range(start):
            next(it)
        for step in range(start, steps):
            batch = next(it)
            t0 = time.perf_counter()
            ef_state, metrics = self._step(params, tree, opt_state, ef_state,
                                           batch, step)
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
                self.ckpt.save(step + 1, {"params": tree, "opt": opt_state,
                                          "ef": ef_state})
            if fail_at_step is not None and step + 1 >= fail_at_step:
                self.ckpt and self.ckpt.wait()
                raise RuntimeError(f"simulated node failure at step {step+1}")
        if self.ckpt:
            self.ckpt.save(steps, {"params": tree, "opt": opt_state,
                                   "ef": ef_state}, blocking=True)
            self.ckpt.wait()
        return {"params": params, "opt": opt_state,
                "log": self.metrics_log, "final_loss":
                    self.metrics_log[-1]["loss"] if self.metrics_log else None}
