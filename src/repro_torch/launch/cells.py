"""Dry-run cells: (arch x shape) -> one rank's step on a mesh, its inputs
as meta tensors, and the analytic MODEL_FLOPS.

The port of the reference's `launch/cells.py`. The reference returns a
function to jit over the whole production mesh with ``in_shardings``; the
port's cell is the program ONE rank runs: its step on a `MetaMesh` (or
any mesh: a `DeviceMesh` runs the same step for real), its arguments as
that rank's blocks (`make_param_specs` and `local_slice` shapes) or the
whole leaf where the port's path takes it whole, and the spec trees. The
constants are the reference's, copied and held equal by the tests.

The steps are the port's own:
  train   — `runtime.trainer.Trainer`'s mesh step (not `Trainer.run`,
            which reads metrics to the host) on (a view of the model over
            the blocks, the blocks, AdamW's state, the batch): the loss
            with ``remat=True`` over ``accum`` micro-batches, each leaf
            gathered where it is used (the LM a layer at a time) and its
            gradient reduce-scattered as the backward leaves it, the
            float32 sum of the gradient blocks, AdamW. The model's whole
            leaves hold no storage;
  prefill — `Transformer.prefill(..., mesh=)` over the rank's
            `lm_rules` blocks (``LM_SERVE_FSDP``: over the data axes too)
            and its block of the batch: the layers tensor-parallel over
            "model", the last position's logits as the rank's vocabulary
            block, its block of the cache the decode reads;
  decode  — `Transformer.decode_step(..., mesh=)` over the same blocks
            and the rank's block of the tokens, split-KV over the cache's
            sequence axes (`models.transformer.decode_axes`);
  GNN     — the Trainer's mesh step over the rank's block of the graph
            batch of `gnn_full_shapes` (`graph_batch_specs`: its edge
            block over "model", its node block over the data axes);
  recsys  — the Trainer's mesh step, `XDeepFM.forward` through the
            kernels, or `retrieval_scores`.
Where the port's layout on a mesh differs from the reference's GSPMD
layout, ``meta["layout"]`` names the argument and says how; the cell
counts what the port does. The reference's module globals
(``ACT_SHARDING``, ``MOE_SHARD_MAP``, ``DECODE_SHARD_MAP``,
``CACHE_UPDATE``) are ``mesh=`` here, and the port's in-place cache write
is the reference's ``CACHE_UPDATE_MODE = "masked"`` (the dry run's
``--cache-update dus`` raises).

``Cell.make_args(device)`` builds real inputs of the same shapes and
dtypes (seeded), so a cell's step runs for real on the CPU or the card.
"""
from __future__ import annotations

import dataclasses
import importlib
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs import get_arch
from repro_torch.models import meta_generator
from repro_torch.models.gnn.common import GraphBatch, GraphBlock
from repro_torch.optim import adamw_init
from repro_torch.runtime.trainer import Trainer, TrainTask
from repro_torch.sharding.rules import (Blocks, P, batch_axis, block_view,
                                        gnn_rules, lm_rules, local_slice,
                                        make_param_specs, recsys_rules,
                                        whole_shape)
from repro_torch.tree import leaves_with_path, tree_leaves, tree_map

I32, F32 = torch.int32, torch.float32


@dataclass
class Cell:
    arch: str
    shape: str
    kind: str                 # train | prefill | decode | forward | retrieval
    fn: Callable
    args: tuple
    arg_names: tuple
    param_specs: Any          # the P tree the reference's rules give
    specs: dict               # arg name -> P tree of this rank's block
    model_flops: float
    meta: dict
    mesh: Any = None
    make_args: Callable | None = field(default=None, repr=False)
    # the step's pieces that `launch.components` re-runs (config, trips)
    parts: dict = field(default_factory=dict, repr=False)

    def arg_bytes(self) -> dict:
        """Bytes this rank holds for each argument (distinct storages)."""
        return {n: _tree_bytes(a) for n, a in zip(self.arg_names, self.args)}

    def param_leaves(self) -> dict:
        """{path: (shape, dtype name, spec tuple)} of the whole parameter
        tree, under the reference's leaf paths (a train cell's from its
        blocks and their specs)."""
        specs = dict(leaves_with_path(self.param_specs))
        if "params" in self.arg_names:
            tree = self.args[self.arg_names.index("params")]

            def shape(p, t):
                return whole_shape(t, specs[p], self.mesh)
        else:
            tree = self.args[self.arg_names.index("model")].param_tree()

            def shape(p, t):
                return tuple(t.shape)
        return {p: (shape(p, t), str(t.dtype).replace("torch.", ""),
                    tuple(specs[p]))
                for p, t in leaves_with_path(tree)}


def _tree_bytes(tree) -> int:
    if hasattr(tree, "param_tree"):
        tree = tree.param_tree()
    if isinstance(tree, GraphBatch):
        tree = [v for v in vars(tree).values() if isinstance(v, torch.Tensor)]
    seen, total = set(), 0
    for t in tree_leaves(tree):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            if id(st) not in seen:
                seen.add(id(st))
                total += t.numel() * t.element_size()
    return total


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(tuple(int(x) for x in shape), dtype=dtype,
                       device="meta")


def _dp(mesh) -> tuple[tuple[str, ...], int]:
    dp = batch_axis(mesh)
    dp = dp if isinstance(dp, tuple) else (dp,)
    return dp, mesh.axes_size(dp)


def _blocks(tree, specs, mesh, device="meta"):
    """This rank's block of every leaf, each a tensor of its own."""
    def block(t, s):
        b = local_slice(t, s, mesh)
        if t.device.type == "meta":
            return torch.empty(tuple(b.shape), dtype=b.dtype, device=device)
        return b.detach().clone()
    return tree_map(block, tree, specs)


def _train_step(task: TrainTask, mesh):
    """The Trainer's mesh step over a rank's blocks: (model view, blocks,
    opt_state, batch) -> loss."""
    trainer = Trainer(task, mesh=mesh)

    def step(model, blocks, opt_state, batch):
        ef = {"_": torch.zeros((), device=mesh.device)}
        _, metrics = trainer._mesh_step(model, blocks, task.param_specs,
                                        opt_state, ef, batch, 1,
                                        batch_is_local=True)
        return metrics["loss"]
    return step


def _state(model, specs, mesh, moments):
    """(a view over this rank's blocks, the blocks, AdamW's state over
    them) on the model's device, as `Trainer.run` keeps them: the blocks
    turned on for gradients and the model's whole leaves freed."""
    tree = model.param_tree()
    blocks = _blocks(tree, specs, mesh, device=tree_leaves(tree)[0].device)
    for t in tree_leaves(tree):
        t.untyped_storage().resize_(0)
    for b in tree_leaves(blocks):
        b.requires_grad_(True)
    return (block_view(model, Blocks(blocks, specs, mesh)), blocks,
            adamw_init(blocks, moments_dtype=moments))


# ---------------------------------------------------------------------------
# LM cells
# ---------------------------------------------------------------------------

LM_SHAPE_DEFS = {
    "train_4k": dict(seq=4096, batch=256),
    "prefill_32k": dict(seq=32768, batch=32),
    "decode_32k": dict(seq=32768, batch=128),
    "long_500k": dict(seq=524288, batch=1),
}

# grad-accum chosen so saved per-layer activations (mb x S x D bf16 x L)
# stay ~<= 4 GB/device with scan-over-layers remat
LM_TRAIN_KNOBS = {
    "granite-3-8b": dict(accum=8, fsdp=True, moments="float32"),
    "granite-20b": dict(accum=16, fsdp=True, moments="float32"),
    "nemotron-4-15b": dict(accum=8, fsdp=True, moments="float32"),
    "qwen2-moe-a2.7b": dict(accum=8, fsdp=True, moments="float32"),
    "deepseek-v3-671b": dict(accum=16, fsdp=True, moments="bfloat16"),
}
# deepseek params don't fit TP-only at inference: shard over data too
LM_SERVE_FSDP = {"deepseek-v3-671b": True}

LAYOUT_WHOLE_PARAMS = ("whole leaves on every rank: the port serves "
                       "xDeepFM with whole tables, not rows over 'model'")


def _lm_model_flops(cfg, n_tokens: int, *, train: bool) -> float:
    return (6.0 if train else 2.0) * cfg.active_params() * n_tokens


def lm_accum(accum: int, batch: int, mesh) -> int:
    """The knob's accumulation halved until the micro-batch divides over
    the (pod x data) axes."""
    _, dp_sz = _dp(mesh)
    while accum > 1 and (batch // accum) % dp_sz != 0:
        accum //= 2
    return accum


def _lm_tokens(vocab: int, shape, device, seed: int) -> torch.Tensor:
    g = torch.Generator(device="cpu").manual_seed(seed)
    return torch.randint(0, vocab, tuple(shape), generator=g,
                         dtype=I32).to(device)


def build_lm_cell(arch_id: str, shape_id: str, mesh, *, cfg=None,
                  shape_def: dict | None = None,
                  knobs: dict | None = None) -> Cell:
    """An LM cell; ``cfg``, ``shape_def`` and ``knobs`` replace the arch's
    full config, the shape's sizes and the train knobs (the tests' smoke
    cells)."""
    from repro_torch.models.transformer import Transformer, loss_fn
    cfg = cfg or get_arch(arch_id).full()
    sd = shape_def or LM_SHAPE_DEFS[shape_id]
    dp, dp_sz = _dp(mesh)
    B = sd["batch"]

    if shape_id == "train_4k":
        knobs = knobs or LM_TRAIN_KNOBS[arch_id]
        S = sd["seq"]
        accum = lm_accum(knobs["accum"], B, mesh)
        mb = B // accum
        cfg_t = dataclasses.replace(cfg, attn_chunk=0, ce_chunk=512)
        moments = getattr(torch, knobs["moments"])

        def build(device, seed=0):
            model = Transformer.random(cfg_t, seed=seed, device=device)
            specs = make_param_specs(model.param_tree(), mesh,
                                     lm_rules(mesh, fsdp=knobs["fsdp"]))
            view, blocks, opt = _state(model, specs, mesh, moments)
            shp = (accum, mb // dp_sz, S)
            if device == "meta":
                toks, labels = _meta(shp, I32), _meta(shp, I32)
            else:
                toks = _lm_tokens(cfg.vocab_size, shp, device, seed + 1)
                labels = torch.roll(toks, -1, dims=-1)
            return (view, blocks, opt, {"tokens": toks, "labels": labels}), \
                specs

        args, specs = build("meta")
        task = TrainTask(
            name=arch_id, init_params=None,
            loss_fn=lambda m, b: loss_fn(m.params, cfg_t, b["tokens"],
                                         b["labels"], remat=True, mesh=mesh),
            batches=iter(()), lr=1e-4, grad_accum=accum,
            moments_dtype=moments, device=mesh.device, param_specs=specs,
            batch_specs={"tokens": P(None, dp, None),
                         "labels": P(None, dp, None)})
        bspec = {"tokens": P(None, dp, None), "labels": P(None, dp, None)}
        return Cell(arch_id, shape_id, "train", _train_step(task, mesh),
                    args, ("model", "params", "opt_state", "batch"), specs,
                    {"params": specs, "opt_state": {"step": P(), "m": specs,
                                                     "v": specs},
                     "batch": bspec},
                    _lm_model_flops(cfg, B * S, train=True),
                    dict(knobs=knobs, mb=mb),
                    mesh, lambda device: build(device)[0],
                    dict(cfg=cfg_t, accum=accum, task=task,
                         x_shape=(mb // dp_sz, S, cfg.d_model)))

    fsdp = LM_SERVE_FSDP.get(arch_id, False)

    def serving_state(cfg_x, device, seed):
        """(this rank's blocks, the spec tree, the model they came from)
        of the serving weights under `lm_rules`."""
        model = Transformer.random(cfg_x, seed=seed, device=device)
        specs = make_param_specs(model.param_tree(), mesh,
                                 lm_rules(mesh, fsdp=fsdp))
        return _blocks(model.param_tree(), specs, mesh,
                       device=device), specs, model

    if shape_id == "prefill_32k":
        S = sd["seq"]
        cfg_s = dataclasses.replace(cfg, attn_chunk=2048)
        b_loc = B // dp_sz if B % dp_sz == 0 and B > 1 else B

        def build(device, seed=0):
            blocks, specs, _ = serving_state(cfg_s, device, seed)
            toks = _meta((b_loc, S), I32) if device == "meta" else \
                _lm_tokens(cfg.vocab_size, (b_loc, S), device, seed + 1)
            return (blocks, toks), specs

        args, specs = build("meta")

        def prefill_step(params, tokens):
            model = Transformer(cfg_s, Blocks(params, specs, mesh))
            with torch.no_grad():
                return model.prefill(tokens, mesh=mesh, batch=B)

        return Cell(arch_id, shape_id, "prefill", prefill_step, args,
                    ("params", "tokens"), specs,
                    {"params": specs, "tokens": P(dp, None)},
                    _lm_model_flops(cfg, B * S, train=False),
                    dict(attn_chunk=cfg_s.attn_chunk),
                    mesh, lambda device: build(device)[0],
                    dict(cfg=cfg_s, batch=B,
                         x_shape=(b_loc, S, cfg.d_model)))

    # decode shapes
    T = sd["seq"]
    b_loc = B // dp_sz if B > 1 else 1

    def build(device, seed=0):
        blocks, specs, model = serving_state(cfg, device, seed)
        cache = model.init_cache(B, T, mesh=mesh)
        toks = _meta((b_loc, 1), I32) if device == "meta" else \
            _lm_tokens(cfg.vocab_size, (b_loc, 1), device, seed + 1)
        return (blocks, cache, toks), specs, model.cache_specs(B, mesh)

    args, specs, cache_specs = build("meta")

    def decode(params, cache, tokens):
        model = Transformer(cfg, Blocks(params, specs, mesh))
        with torch.no_grad():
            return model.decode_step(cache, tokens, T - 1, mesh=mesh,
                                     batch=B)

    return Cell(arch_id, shape_id, "decode", decode, args,
                ("params", "cache", "tokens"), specs,
                {"params": specs, "cache": cache_specs,
                 "tokens": P(dp if B > 1 else None, None)},
                _lm_model_flops(cfg, B, train=False),
                dict(kv_len=T, layout={
                    "cur": "the position is a Python int (T - 1), not a "
                           "device scalar"}),
                mesh, lambda device: build(device)[0],
                dict(cfg=cfg, batch=B, cur=T - 1))


# ---------------------------------------------------------------------------
# GNN cells
# ---------------------------------------------------------------------------

def gnn_full_shapes(shape_id: str) -> dict:
    """Analytic padded sizes matching data.graphs.make_graph_batch."""
    if shape_id == "full_graph_sm":
        n, e = 2708, 10556 + 2708
    elif shape_id == "ogb_products":
        n, e = 2_449_029, 61_859_140 + 2_449_029
    elif shape_id == "molecule":
        n, e = 30 * 128, 64 * 128
    elif shape_id == "minibatch_lg":
        bn, f1, f2 = 1024, 15, 10
        n = bn + bn * f1 + bn * f1 * f2
        e = bn * f1 + bn * f1 * f2
    else:
        raise KeyError(shape_id)
    n = ((n + 127) // 128) * 128
    e = ((e + 511) // 512) * 512
    return dict(n=n, e=e,
                n_graphs=128 if shape_id == "molecule" else 1)


GNN_SHAPE_DIMS = {
    "full_graph_sm": dict(d_feat=1433, n_classes=7),
    "minibatch_lg": dict(d_feat=602, n_classes=41),
    "ogb_products": dict(d_feat=100, n_classes=47),
    "molecule": dict(d_feat=16, n_classes=4),
}

GNN_MODULES = {"gcn-cora": ("gcn", "GCN"), "egnn": ("egnn", "EGNN"),
               "nequip": ("nequip", "NequIP"),
               "equiformer-v2": ("equiformer_v2", "EquiformerV2")}


def meta_graph_batch(shape_id: str) -> GraphBatch:
    """The graph batch of a shape at `gnn_full_shapes`' sizes, as meta
    tensors."""
    dims, gs = GNN_SHAPE_DIMS[shape_id], gnn_full_shapes(shape_id)
    n, e = gs["n"], gs["e"]
    return GraphBatch(
        node_feat=_meta((n, dims["d_feat"]), F32),
        positions=_meta((n, 3), F32), senders=_meta((e,), I32),
        receivers=_meta((e,), I32), edge_mask=_meta((e,), torch.bool),
        node_mask=_meta((n,), torch.bool), labels=_meta((n,), I32),
        label_mask=_meta((n,), torch.bool), graph_ids=_meta((n,), I32),
        n_graphs=gs["n_graphs"], species=_meta((n,), I32))


NODE_FIELDS = ("node_feat", "positions", "node_mask", "labels",
               "label_mask", "graph_ids", "species")
EDGE_FIELDS = ("senders", "receivers", "edge_mask")


def graph_specs(n_nodes: int, n_graphs: int, mesh) -> GraphBatch:
    """The layout of a graph batch of ``n_nodes`` nodes on ``mesh``, a
    GraphBatch of `P`: the edge arrays split over "model", the node
    arrays over the data axes (`batch_axis`) where ``n_nodes`` divides
    by their size, else whole."""
    dp = batch_axis(mesh)
    node_ax = dp if n_nodes % mesh.axes_size(dp) == 0 else None
    return GraphBatch(
        node_feat=P(node_ax, None), positions=P(node_ax, None),
        senders=P("model"), receivers=P("model"), edge_mask=P("model"),
        node_mask=P(node_ax), labels=P(node_ax), label_mask=P(node_ax),
        graph_ids=P(node_ax), n_graphs=n_graphs, species=P(node_ax))


def graph_batch_specs(shape_id: str, mesh) -> tuple[GraphBatch, GraphBatch]:
    """(the whole batch as meta tensors, its `graph_specs`): the
    reference's `graph_batch_specs`."""
    gs = gnn_full_shapes(shape_id)
    return meta_graph_batch(shape_id), graph_specs(gs["n"], gs["n_graphs"],
                                                   mesh)


def _axes_tuple(ax) -> tuple[str, ...]:
    return () if ax is None else (ax,) if isinstance(ax, str) else tuple(ax)


def graph_block(g: GraphBatch, specs: GraphBatch, mesh) -> GraphBlock:
    """This rank's block of the whole batch ``g`` under ``specs`` (a
    GraphBatch of `P`, as `graph_batch_specs` gives): each array its
    `local_slice`, a tensor of its own (meta tensors of the block's
    shapes for a meta ``g``), ``n_graphs`` carried."""
    def cut(name):
        t = getattr(g, name)
        if t is None:
            return None
        b = local_slice(t, getattr(specs, name), mesh)
        if t.device.type == "meta":
            return _meta(b.shape, b.dtype)
        return b.clone()
    return GraphBlock(
        **{f: cut(f) for f in NODE_FIELDS + EDGE_FIELDS},
        n_graphs=g.n_graphs, mesh=mesh, n_nodes=g.node_mask.shape[0],
        node_axes=_axes_tuple(specs.node_mask[0]),
        edge_axes=_axes_tuple(specs.senders[0]))


def pad_graph_batch(g: GraphBatch, n: int, e: int) -> GraphBatch:
    """``g`` padded to ``n`` nodes and ``e`` edges: the new nodes and edges
    masked out (zeros, edges on node 0), as the reference pads."""
    def pad(t, size):
        if t is None or t.shape[0] == size:
            return t
        if t.shape[0] > size:
            raise ValueError(f"a batch of {t.shape[0]} does not pad to "
                             f"{size}")
        extra = torch.zeros((size - t.shape[0], *t.shape[1:]),
                            dtype=t.dtype, device=t.device)
        return torch.cat([t, extra])
    return dataclasses.replace(
        g, **{k: pad(getattr(g, k), n) for k in NODE_FIELDS},
        **{k: pad(getattr(g, k), e) for k in EDGE_FIELDS})


def real_graph_batch(shape_id: str, device, seed: int = 0) -> GraphBatch:
    """`data.graphs.make_graph_batch` at full size, padded to the cell's
    analytic sizes."""
    from repro_torch.data.graphs import make_graph_batch
    gs = gnn_full_shapes(shape_id)
    g = make_graph_batch(shape_id, seed=seed, device=device,
                         **GNN_SHAPE_DIMS[shape_id])
    return pad_graph_batch(g, gs["n"], gs["e"])


def gnn_config(arch_id: str, shape_id: str):
    if arch_id == "gcn-cora":
        from repro_torch.configs import gcn_cora
        return gcn_cora.full(shape_id)
    return get_arch(arch_id).full()


def build_gnn_cell(arch_id: str, shape_id: str, mesh, *,
                   cfg=None) -> Cell:
    """A GNN train cell: the Trainer's mesh step over this rank's
    replicated `gnn_rules` blocks and its `graph_block` of the batch
    under `graph_batch_specs`. ``make_args(device, batch=)`` cuts the
    given whole batch (else the shape's own, built on ``device``) into
    the rank's block."""
    mod_name, cls_name = GNN_MODULES[arch_id]
    mod = importlib.import_module("repro_torch.models.gnn." + mod_name)
    cls = getattr(mod, cls_name)
    cfg = cfg or gnn_config(arch_id, shape_id)
    gs = gnn_full_shapes(shape_id)
    whole, bspecs = graph_batch_specs(shape_id, mesh)

    def build(device, seed=0, batch=None):
        gen = meta_generator(seed) if device == "meta" else \
            torch.Generator(device=device).manual_seed(seed)
        model = cls.random(cfg, gen)
        specs = make_param_specs(model.param_tree(), mesh, gnn_rules(mesh))
        view, blocks, opt = _state(model, specs, mesh, F32)
        if batch is None:
            batch = whole if device == "meta" else \
                real_graph_batch(shape_id, device, seed)
        return (view, blocks, opt, graph_block(batch, bspecs, mesh)), specs

    args, specs = build("meta")
    task = TrainTask(name=arch_id, init_params=None, loss_fn=mod.loss_fn,
                     batches=iter(()), lr=1e-3, device=mesh.device,
                     param_specs=specs)
    n_par = sum(t.numel() for t in tree_leaves(args[1]))
    return Cell(arch_id, shape_id, "train", _train_step(task, mesh), args,
                ("model", "params", "opt_state", "batch"), specs,
                {"params": specs, "opt_state": {"step": P(), "m": specs,
                                                 "v": specs},
                 "batch": bspecs},
                6.0 * n_par * gs["n"], dict(n_params=n_par, **gs),
                mesh, lambda device, batch=None: build(device,
                                                       batch=batch)[0],
                dict(task=task))


# ---------------------------------------------------------------------------
# recsys cells
# ---------------------------------------------------------------------------

RECSYS_SHAPE_DEFS = {
    "train_batch": dict(batch=65536, kind="train"),
    "serve_p99": dict(batch=512, kind="forward"),
    "serve_bulk": dict(batch=262144, kind="forward"),
    "retrieval_cand": dict(batch=1, n_cand=1_000_000, kind="retrieval"),
}


def _click_batch(cfg, b: int, device, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    sparse = np.stack([rng.integers(0, v, b) for v in cfg.vocab_sizes],
                      axis=1).astype(np.int32)
    return {"sparse": torch.from_numpy(sparse).to(device),
            "dense": torch.from_numpy(rng.normal(
                size=(b, cfg.n_dense)).astype(np.float32)).to(device),
            "label": torch.from_numpy(rng.integers(0, 2, b).astype(
                np.float32)).to(device)}


def build_recsys_cell(arch_id: str, shape_id: str, mesh, *, cfg=None,
                      batch: int | None = None) -> Cell:
    from repro_torch.models.recsys import xdeepfm as xd
    cfg = cfg or get_arch(arch_id).full()
    sd = RECSYS_SHAPE_DEFS[shape_id]
    dp, dp_sz = _dp(mesh)

    def model_of(device, seed):
        gen = meta_generator(seed) if device == "meta" else \
            torch.Generator(device=device).manual_seed(seed)
        return xd.XDeepFM.random(cfg, gen)

    meta_model = model_of("meta", 0)
    specs = make_param_specs(meta_model.param_tree(), mesh,
                             recsys_rules(mesh))
    n_par = sum(t.numel() for t in tree_leaves(meta_model.param_tree()))
    dense_flops = n_par - cfg.total_vocab * 11

    if sd["kind"] == "retrieval":
        n_cand = sd["n_cand"]
        n_loc = n_cand // mesh.axes_size("model")

        def build(device, seed=0):
            model = meta_model if device == "meta" else model_of(device,
                                                                 seed)
            if device == "meta":
                q, cand = _meta((cfg.n_sparse * cfg.embed_dim,), F32), \
                    _meta((n_loc,), I32)
            else:
                g = torch.Generator(device="cpu").manual_seed(seed + 1)
                q = torch.randn((cfg.n_sparse * cfg.embed_dim,),
                                generator=g).to(device)
                cand = torch.randint(0, cfg.total_vocab, (n_loc,),
                                     generator=g, dtype=I32).to(device)
            return (model, q, cand)

        def retrieval(model, query, cand_ids):
            with torch.no_grad():
                return model.retrieval_scores(query, cand_ids)

        return Cell(arch_id, shape_id, "retrieval", retrieval, build("meta"),
                    ("model", "query", "cand_ids"), specs,
                    {"params": specs, "query": P(None),
                     "cand_ids": P("model")},
                    2.0 * n_cand * cfg.embed_dim,
                    dict(n_cand=n_cand,
                         layout={"params": LAYOUT_WHOLE_PARAMS}),
                    mesh, build)

    B = batch or sd["batch"]
    b_loc = B // dp_sz
    bspec = {"sparse": P(dp, None), "dense": P(dp, None), "label": P(dp)}

    def batch_of(device, seed):
        if device == "meta":
            return {"sparse": _meta((b_loc, cfg.n_sparse), I32),
                    "dense": _meta((b_loc, cfg.n_dense), F32),
                    "label": _meta((b_loc,), F32)}
        return _click_batch(cfg, b_loc, device, seed + 1)

    if sd["kind"] == "train":
        def build(device, seed=0):
            model = meta_model if device == "meta" else model_of(device,
                                                                 seed)
            view, blocks, opt = _state(model, specs, mesh, F32)
            return (view, blocks, opt, batch_of(device, seed))

        task = TrainTask(name=arch_id, init_params=None, loss_fn=xd.loss_fn,
                         batches=iter(()), lr=1e-3, device=mesh.device,
                         param_specs=specs, batch_specs=bspec)
        return Cell(arch_id, shape_id, "train", _train_step(task, mesh),
                    build("meta"), ("model", "params", "opt_state", "batch"),
                    specs, {"params": specs,
                            "opt_state": {"step": P(), "m": specs,
                                          "v": specs},
                            "batch": bspec},
                    6.0 * dense_flops * B
                    + 6.0 * B * cfg.n_sparse * cfg.embed_dim,
                    dict(n_params=n_par), mesh, build)

    def build(device, seed=0):
        model = meta_model if device == "meta" else model_of(device, seed)
        b = batch_of(device, seed)
        return (model, {"sparse": b["sparse"], "dense": b["dense"],
                        "label": b["label"]})

    def fwd(model, batch):
        with torch.no_grad():
            return model(batch["sparse"], batch["dense"], use_kernel=True)

    return Cell(arch_id, shape_id, "forward", fwd, build("meta"),
                ("model", "batch"), specs, {"params": specs, "batch": bspec},
                2.0 * dense_flops * B + 2.0 * B * cfg.n_sparse * cfg.embed_dim,
                dict(n_params=n_par, layout={"params": LAYOUT_WHOLE_PARAMS}),
                mesh, build)


# ---------------------------------------------------------------------------

def build_cell(arch_id: str, shape_id: str, mesh) -> Cell:
    fam = get_arch(arch_id).family
    if fam == "lm":
        return build_lm_cell(arch_id, shape_id, mesh)
    if fam == "gnn":
        return build_gnn_cell(arch_id, shape_id, mesh)
    if fam == "recsys":
        return build_recsys_cell(arch_id, shape_id, mesh)
    raise KeyError(fam)
