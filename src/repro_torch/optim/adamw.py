"""AdamW over a parameter tree, updated in place.

The port of the reference's `optim/adamw.py`: the same state tree
({"step", "m", "v"}, moments mirroring the parameters, ``moments_dtype``
bfloat16 to halve their memory), global-norm clipping inside the update,
and the reference's float32 arithmetic in its order. Unlike the
reference's pure function, `adamw_update` writes the new parameters and
moments into the tensors it is given (no second copy of a 26.4M-row
table), under `torch.no_grad()`, and returns those same objects.
"""
from __future__ import annotations

import torch

from repro_torch.tree import tree_leaves, tree_map


def adamw_init(params, *, moments_dtype=torch.float32) -> dict:
    def zeros(p):
        return torch.zeros(p.shape, dtype=moments_dtype, device=p.device)
    dev = tree_leaves(params)[0].device
    return {"step": torch.zeros((), dtype=torch.int32, device=dev),
            "m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum, leaf after leaf in tree order, of each leaf's sum
    of squares in float32."""
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, state, params, *, lr, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, clip_norm=1.0, grad_norm=None):
    """One AdamW step. Returns (params, state, {"grad_norm"}), the params
    and the state's tensors updated in place. ``lr`` is a float or a 0-d
    tensor; the gradients (one per parameter, any float dtype) are
    consumed: a float32 gradient is scaled in place. ``grad_norm``, where
    given, is the norm clipped on (a mesh's blocks do not hold it)."""
    step = state["step"]
    step += 1
    gn = global_norm(grads) if grad_norm is None else grad_norm
    scale = (torch.clamp(clip_norm / torch.clamp(gn, min=1e-12), max=1.0)
             if clip_norm else None)
    s = step.to(torch.float32)
    b1_t = torch.tensor(b1, dtype=torch.float32, device=s.device)
    b2_t = torch.tensor(b2, dtype=torch.float32, device=s.device)
    corr1 = 1.0 - b1_t ** s
    corr2 = 1.0 - b2_t ** s
    lr = float(lr)

    for p, g, m, v in zip(tree_leaves(params), tree_leaves(grads),
                          tree_leaves(state["m"]), tree_leaves(state["v"])):
        g = g.to(torch.float32)
        if scale is not None:
            g.mul_(scale)
        m32 = m.to(torch.float32)
        m32.mul_(b1).add_(g * (1 - b1))                 # m b1 + g (1 - b1)
        v32 = v.to(torch.float32)
        v32.mul_(b2).add_(torch.mul(g, g).mul_(1 - b2))  # v b2 + g g (1 - b2)
        del g
        u = torch.div(m32, corr1).div_(
            torch.div(v32, corr2).sqrt_().add_(eps))
        p32 = p.to(torch.float32)
        u.add_(p32 * weight_decay).mul_(lr)
        if p32 is p:
            p.sub_(u)
        else:
            p.copy_(p32.sub_(u))
        if m32 is not m:
            m.copy_(m32)
        if v32 is not v:
            v.copy_(v32)
    return params, state, {"grad_norm": gn}
