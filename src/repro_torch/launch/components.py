"""Per-component cost accounting of an LM cell, recombined by trip count.

The port of the reference's `launch/components.py`. XLA's cost analysis
counts a while-loop body once, so the reference lowers the scan-free
components of a step (one layer, the head and loss, the optimizer) and
recombines them:

  train:   accum * (L_dense*layer_d + L_moe*layer_m + head) + opt
  prefill: L_dense*layer_d + L_moe*layer_m + head
  decode:  L_dense*layer_d + L_moe*layer_m + head

The port's whole-program meta run has no scan: it runs every layer of
every micro-batch. So here ``adjusted`` EQUALS the whole program's
totals, FLOPs and collective bytes alike, and that equality tests both.
Each component is a meta run (`launch.dryrun.account`) of the piece of
the cell's own step:
  layer_dense / layer_moe — one layer as the step runs it: for train its
      blocks gathered, its forward under `torch.utils.checkpoint` and its
      backward (the recompute and its gathers included, the gradients'
      reduce-scatters); for prefill and decode its blocks gathered over
      the data axes and its tensor-parallel forward (`serve_layer`): the
      prefill's through the flash kernel into the rank's cache slots, the
      decode's cached split-KV step;
  head — everything of a micro-batch but the layers: the embedding, the
      final norm, the head (each gathered from its blocks), the
      cross-entropy (``ce_chunk``) and the MTP term with their backward
      (train), the vocabulary-parallel embedding and the last position's
      logits block (prefill, decode);
  opt — everything once per step: the metrics' collective, the
      gradients' sum over the micro-batches and division, the norm and
      AdamW.
Each gives ``flops`` (the dispatcher's and the kernels'), ``bytes`` (the
sum of every dispatched op's input and output bytes plus the kernels'
meta bytes: not XLA's "bytes accessed"), ``collectives`` (bytes by HLO
kind) and ``collective_total``. Peak memory comes from the whole program.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.launch.cells import build_lm_cell
from repro_torch.sharding.rules import Blocks
from repro_torch.tree import tree_leaves


def _cost(fn, args, mesh) -> dict:
    from repro_torch.launch.dryrun import account
    mesh.reset_counts()
    rec = account(fn, args)
    coll = mesh.hlo_collectives()
    return {"flops": rec["flops"], "bytes": rec["bytes_accessed"],
            "collectives": coll["per_kind_bytes"],
            "collective_total": coll["total_bytes"]}


def _scale(c: dict, k: float) -> dict:
    return {"flops": c["flops"] * k, "bytes": c["bytes"] * k,
            "collectives": {kk: v * k for kk, v in c["collectives"].items()},
            "collective_total": c["collective_total"] * k}


def _add(*cs) -> dict:
    out = {"flops": 0.0, "bytes": 0.0, "collective_total": 0.0,
           "collectives": {}}
    for c in cs:
        out["flops"] += c["flops"]
        out["bytes"] += c["bytes"]
        out["collective_total"] += c["collective_total"]
        for k, v in c["collectives"].items():
            out["collectives"][k] = out["collectives"].get(k, 0.0) + v
    return out


def _no_layers(cfg):
    return dataclasses.replace(cfg, n_layers=0, first_dense_layers=0)


def _meta_like(shape, dtype, grad: bool = False) -> torch.Tensor:
    t = torch.empty(tuple(shape), dtype=dtype, device="meta")
    return t.requires_grad_(grad)


def lm_component_costs(arch_id: str, shape_id: str, mesh, *, cell=None,
                       **overrides) -> dict:
    """{"components", "adjusted", "trips"} of an LM cell on ``mesh`` (a
    `MetaMesh`); ``cell`` reuses a built cell, ``overrides`` pass to
    `cells.build_lm_cell` (cfg, shape_def, knobs)."""
    from repro_torch.models.transformer import (Transformer, _depths, _map,
                                                decode_axes, layer_specs,
                                                loss_fn, serve_layer,
                                                train_layer)
    from repro_torch.runtime.trainer import Trainer, TrainTask
    cell = cell or build_lm_cell(arch_id, shape_id, mesh, **overrides)
    cfg = cell.parts["cfg"]
    if cell.kind == "train":
        model = cell.args[0]
    else:                   # the serving cells take the rank's blocks
        model = Transformer(cfg, Blocks(cell.args[0], cell.param_specs,
                                        mesh))
    params = model.params
    dt = params["embed"].dtype
    n_dense, n_moe = _depths(cfg)
    train = cell.kind == "train"
    comps = {}

    def first_layer(moe: bool) -> dict:
        name = "moe" if moe else "dense"
        return next(lp[0] for nm, _, lp in model.stacks if nm == name)

    if train:
        accum = cell.parts["accum"]
        x_shape = cell.parts["x_shape"]
        s = x_shape[1]
        blocks = params                 # the view's `Blocks`
        specs = blocks.specs

        def layer_cost(moe: bool):
            key = "moe_layers" if moe else "dense_layers"
            lspecs = layer_specs(specs, key)

            def fn(lp, x):
                positions = torch.arange(s, device="meta")[None]
                out = torch.utils.checkpoint.checkpoint(
                    train_layer, x, lp, cfg, positions, moe, mesh,
                    use_reentrant=False, specs=lspecs, gmesh=blocks.mesh)
                leaves = [x] + tree_leaves(lp)
                return torch.autograd.grad(out, leaves,
                                           grad_outputs=torch.ones_like(out),
                                           allow_unused=True)
            lp = _detached(_map(blocks[key], lambda t: t[0]))
            return _cost(fn, (lp, _meta_like(x_shape, dt, True)), mesh)

        def head_fn(p, tokens, labels):
            loss, _ = loss_fn(p, _no_layers(cfg), tokens, labels, remat=True,
                              mesh=mesh)
            leaves = [t for t in tree_leaves(p) if t.requires_grad]
            return torch.autograd.grad(loss, leaves, allow_unused=True)

        batch = cell.args[3]
        mb = {k: v[0] for k, v in batch.items()}
        rest = [k for k in blocks if k not in ("dense_layers", "moe_layers")]
        head_params = Blocks(_detached({k: blocks[k] for k in rest}),
                             {k: specs[k] for k in rest}, blocks.mesh)
        comps_head = _cost(head_fn, (head_params, mb["tokens"],
                                     mb["labels"]), mesh)

        # the once-a-step part: the Trainer's mesh step with a loss that
        # reaches every block with no product and no collective
        task = cell.parts["task"]
        metric_keys = ["ce", "loss"] + (["mtp_ce"] if cfg.mtp_depth
                                        and "mtp" in params else [])

        def zero_loss(m, b):
            loss = sum((t.sum() * 0).float() for t in tree_leaves(
                m.param_tree()))
            return loss, {k: loss for k in metric_keys}
        opt_task = TrainTask(
            name=task.name, init_params=None, loss_fn=zero_loss,
            batches=iter(()), lr=task.lr, grad_accum=accum,
            moments_dtype=task.moments_dtype, device=task.device,
            param_specs=task.param_specs, batch_specs=task.batch_specs)
        trainer = Trainer(opt_task, mesh=mesh)

        def opt_fn(model_, blocks_, opt_state, batch_):
            ef = {"_": torch.zeros((), device="meta")}
            trainer._mesh_step(model_, blocks_, opt_task.param_specs,
                               opt_state, ef, batch_, 1, batch_is_local=True)
        comps["head"] = comps_head
        if n_dense:
            comps["layer_dense"] = layer_cost(False)
        if n_moe:
            comps["layer_moe"] = layer_cost(True)
        comps["opt"] = _cost(opt_fn, (model, cell.args[1], cell.args[2],
                                      batch), mesh)
    else:
        accum = 1
        batch = cell.parts["batch"]
        specs = cell.param_specs
        tokens = cell.args[-1]
        _, t_ax = decode_axes(mesh, batch)
        rest = [k for k in params if k not in ("dense_layers", "moe_layers")]
        zero = Transformer(_no_layers(cfg), Blocks(
            {k: params[k] for k in rest}, {k: specs[k] for k in rest}, mesh))

        def layer_cost(moe: bool, x_shape, positions, cur, cache):
            key = "moe_layers" if moe else "dense_layers"
            ca, cb = (t[0] for t in cache["moe" if moe else "dense"])

            def fn(lp, x, ca_, cb_):
                with torch.no_grad():
                    return serve_layer(lp, cfg, x, positions, cur, moe,
                                       (ca_, cb_, cur), mesh=mesh,
                                       specs=layer_specs(specs, key),
                                       use_kernel=True, drops=[],
                                       seq_axes=t_ax, split=True)
            return _cost(fn, (first_layer(moe), _meta_like(x_shape, dt), ca,
                              cb), mesh)

        if cell.kind == "prefill":
            b, s, _ = cell.parts["x_shape"]
            cache = model.init_cache(batch, s, mesh=mesh)
            layer_args = ((b, s, cfg.d_model),
                          torch.arange(s, device="meta")[None], 0, cache)

            def head_fn(z, toks):
                with torch.no_grad():
                    return z.prefill(toks, mesh=mesh, batch=batch)
        else:
            cur = cell.parts["cur"]
            b_loc = tokens.shape[0]
            layer_args = ((b_loc, 1, cfg.d_model),
                          torch.full((b_loc, 1), cur, dtype=torch.int32,
                                     device="meta"), cur, cell.args[1])

            def head_fn(z, toks):
                with torch.no_grad():
                    return z.decode_step({"dense": None, "moe": None}, toks,
                                         cur, mesh=mesh, batch=batch)[0]
        comps["head"] = _cost(head_fn, (zero, tokens), mesh)
        if n_dense:
            comps["layer_dense"] = layer_cost(False, *layer_args)
        if n_moe:
            comps["layer_moe"] = layer_cost(True, *layer_args)

    nothing = _scale(comps["head"], 0.0)
    total = _add(
        _scale(comps.get("layer_dense", nothing), n_dense * accum),
        _scale(comps.get("layer_moe", nothing), n_moe * accum),
        _scale(comps["head"], accum),
        comps.get("opt", nothing))
    return {"components": comps, "adjusted": total,
            "trips": {"accum": accum, "n_dense": n_dense, "n_moe": n_moe}}


def _detached(tree):
    """Meta leaves of ``tree``'s shapes that require grad, as the Trainer's
    blocks do."""
    if isinstance(tree, dict):
        return {k: _detached(v) for k, v in tree.items()}
    return _meta_like(tree.shape, tree.dtype, True)


