"""Why one device's Equiformer-v2 gradients differ from call to call on
the card: the leaky_relu kink of the attention scores.

Runs the one-device train step of Equiformer-v2's full config (seed 0)
over the molecule batch: once with PyTorch's deterministic `index_add_`
(the reference), then eight times with its default atomic `index_add_`.
For each atomic call it prints the worst leaves' relative L2 against the
reference and every live attention pre-activation (leaky_relu's input)
whose sign differs from the reference's. Then six more atomic calls with
leaky_relu's slopes frozen to the reference's signs: if the sign flips
are the cause, these agree with the reference at the level of rounding.

Needs a CUDA card; run from the repo root:

    PYTHONPATH=src python tools/equiformer_kink.py
"""
from __future__ import annotations

import contextlib
import sys
import time
import warnings

import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.launch import cells
from repro_torch.models.gnn import equiformer_v2 as eq
from repro_torch.tree import leaves_with_path

LEAKY = F.leaky_relu
PRE: list[torch.Tensor] = []        # this call's pre-activations, by layer
FROZEN: list[torch.Tensor] | None = None


def leaky(x, slope=0.01, *args, **kwargs):
    """leaky_relu that records its input; with FROZEN set, the slope of
    each entry is the one FROZEN's sign gives it."""
    PRE.append(x.detach().clone())
    if FROZEN is not None:
        return torch.where(FROZEN[len(PRE) - 1], x, slope * x)
    return LEAKY(x, slope, *args, **kwargs)


@contextlib.contextmanager
def deterministic():
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            yield
    finally:
        torch.use_deterministic_algorithms(False)


def rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    top = torch.linalg.vector_norm(want.double()).item()
    diff = torch.linalg.vector_norm((got - want).double()).item()
    return diff / top if top else diff


def step(model, leaves, g):
    PRE.clear()
    loss, _ = eq.loss_fn(model, g)
    grads = torch.autograd.grad(loss, list(leaves.values()),
                                allow_unused=True)
    torch.cuda.synchronize()
    return ({p: gr for p, gr in zip(leaves, grads) if gr is not None},
            list(PRE))


def worst(want, got, n=2) -> str:
    errs = {p: rel_l2(got[p], want[p]) for p in want}
    return ", ".join(f"{p} {errs[p]:.3g}"
                     for p in sorted(errs, key=errs.get)[::-1][:n])


def main() -> int:
    global FROZEN
    if not torch.cuda.is_available():
        print("equiformer_kink: needs a CUDA card", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    dev = torch.device("cuda")
    kernels.build()
    torch.backends.cuda.matmul.allow_tf32 = False
    F.leaky_relu = leaky
    g = cells.real_graph_batch("molecule", dev)
    model = eq.EquiformerV2.random(cells.gnn_config("equiformer-v2",
                                                    "molecule"),
                                   torch.Generator(device=dev).manual_seed(0))
    leaves = dict(leaves_with_path(model.param_tree()))
    for t in leaves.values():
        t.requires_grad_(True)
    with deterministic():
        ref, ref_pre = step(model, leaves, g)
    live = g.edge_mask[:, None]
    for li, x in enumerate(ref_pre):
        ax = torch.where(live.expand_as(x), x.abs(), torch.inf)
        print(f"layer {li}: live pre-activations within 1e-6 of 0: "
              f"{int((ax < 1e-6).sum())}, within 1e-5: "
              f"{int((ax < 1e-5).sum())}; smallest |x| {float(ax.min()):.3g}")
    for i in range(8):
        got, pre = step(model, leaves, g)
        flips = []
        for li, (a, b) in enumerate(zip(ref_pre, pre)):
            for e, h in (((a > 0) != (b > 0)) & live).nonzero().tolist():
                flips.append((li, e, h, float(a[e, h]), float(b[e, h])))
        print(f"atomic call {i} against the reference: {worst(ref, got)}; "
              f"sign flips (layer, edge, head, x there, x here): {flips}")
    FROZEN = [x > 0 for x in ref_pre]
    for i in range(6):
        got, _ = step(model, leaves, g)
        print(f"slopes frozen, atomic call {i} against the reference: "
              f"{worst(ref, got)}")
    print(f"{torch.cuda.get_device_name(0)}; {time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
