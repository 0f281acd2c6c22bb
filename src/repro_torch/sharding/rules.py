"""Partition specs per architecture family, and placement on the mesh.

The port of the reference's `sharding/rules.py`: specs are derived from the
parameter tree's paths and shapes, so rules never drift from model code. A
dimension is only sharded when its size divides by the mesh axis's, e.g.
granite's 8 KV heads stay replicated on a 16-wide model axis, while
qwen2-moe's 60 experts take expert-TP over d_ff. ``fsdp=True`` additionally
shards the non-TP dimension of large matrices over the data axes (ZeRO-3
storage), as deepseek-v3-671b needs. A spec is a `P`: one entry per dim,
an axis name, a tuple of names or None, equal to the tuple of its entries.
The port's `param_tree()` hands out its tensors under JAX's leaf paths, so
the reference's regexes apply to the same "/"-joined paths.

On the port's mesh (`launch.mesh.DeviceMesh`) each rank holds its block of
a tensor: `local_slice` cuts it, `gather_full` puts the whole back
together, and the autograd functions below are the model paths'
collectives with their transposes written out. `kg_local` places the
federated KG's shard blocks on the engines' 1-D mesh.
"""
from __future__ import annotations

import re
from typing import Callable

import numpy as np
import torch

from repro_torch.tree import leaves_with_path, path_tree, tree_leaves, tree_map


class P:
    """A partition spec: one entry per dim (an axis name, a tuple of
    names, or None for a dim kept whole). A tuple of one name is that
    name and an empty tuple None, as JAX's PartitionSpec normalises them.
    Equal to the tuple of its entries, and a leaf to the tree functions
    (unlike a tuple)."""

    __slots__ = ("entries",)

    def __init__(self, *entries):
        self.entries = tuple(
            (e[0] if len(e) == 1 else e or None) if isinstance(e, tuple)
            else e for e in entries)

    def __iter__(self):
        return iter(self.entries)

    def __len__(self) -> int:
        return len(self.entries)

    def __getitem__(self, i):
        return self.entries[i]

    def __eq__(self, other) -> bool:
        if isinstance(other, P):
            return self.entries == other.entries
        return isinstance(other, tuple) and self.entries == other

    def __hash__(self) -> int:
        return hash(self.entries)

    def __repr__(self) -> str:
        return f"P{self.entries!r}"


def batch_axis(mesh) -> tuple[str, ...] | str:
    """The combined data-parallel axis ( ('pod','data') on multi-pod )."""
    names = mesh.axis_names
    return tuple(a for a in names if a in ("pod", "data")) or "data"


def _axes(axis) -> tuple[str, ...]:
    return axis if isinstance(axis, tuple) else (axis,)


def _div(shape, i, mesh, axis) -> bool:
    if axis is None or i >= len(shape):
        return False
    size = int(np.prod([mesh.shape[a] for a in _axes(axis)]))
    return shape[i] % size == 0 and shape[i] >= size


def _spec(shape, mesh, *axes) -> P:
    """P placing axes[i] on dim i when divisible, else None."""
    out = []
    for i in range(len(shape)):
        ax = axes[i] if i < len(axes) else None
        out.append(ax if _div(shape, i, mesh, ax) else None)
    return P(*out)


Rule = tuple[str, Callable]


def lm_rules(mesh, *, fsdp: bool = False) -> list[Rule]:
    """Path-regex -> spec rules for the transformer LM family.

    Layer-stacked params have a leading L dim (never sharded)."""
    dp = batch_axis(mesh) if fsdp else None
    mdl = "model"

    def stacked(fn):
        # apply fn to the trailing dims, leading stack dims unsharded
        def g(shape, mesh):
            core = fn(shape[-fn.ndim:], mesh)
            return P(*([None] * (len(shape) - fn.ndim) + list(core)))
        return g

    def mat(d_axis, f_axis, ndim=2):
        def fn(shape, mesh):
            return _spec(shape, mesh, d_axis, f_axis)
        fn.ndim = ndim
        return fn

    def expert_mat(in_dim: bool):
        def fn(shape, mesh):
            if _div(shape, 0, mesh, mdl):              # true EP (deepseek)
                return _spec(shape, mesh, mdl, dp, None)
            # expert-TP (qwen2-moe): ff dim over model + FSDP storage over
            # data; the MoE layer re-gathers the data dim at compute time
            if in_dim:
                return _spec(shape, mesh, None, dp, mdl)    # (E, D, F)
            return _spec(shape, mesh, None, mdl, dp)        # (E, F, D)
        fn.ndim = 3
        return fn

    rules: list[Rule] = [
        (r"embed$", mat(mdl, dp)),
        (r"lm_head$", mat(dp, mdl)),
        (r"final_norm$|ln1$|ln2$|q_norm$|kv_norm$", mat(None, None, ndim=1)),
        (r"attn/(wq|wk|wv)$", stacked(mat(dp, mdl))),
        (r"attn/wo$", stacked(mat(mdl, dp))),
        (r"attn/wq_a$|attn/wkv_a$", stacked(mat(dp, None))),
        (r"attn/wq_b$|attn/wkv_b$", stacked(mat(None, mdl))),
        (r"router$", stacked(mat(dp, None))),
        (r"experts/(w_in|w_gate)$", stacked(expert_mat(True))),
        (r"experts/w_out$", stacked(expert_mat(False))),
        (r"(mlp|shared)/(w_in|w_gate)$", stacked(mat(dp, mdl))),
        (r"(mlp|shared)/w_out$", stacked(mat(mdl, dp))),
        (r"mtp/proj$", mat(dp, mdl)),
    ]
    return rules


def gnn_rules(mesh, **_kw) -> list[Rule]:
    """GNN params are small: replicate weights; data (edges) shards instead."""
    def rep(shape, mesh):
        return P(*([None] * len(shape)))
    return [(r".*", rep)]


def recsys_rules(mesh, **_kw) -> list[Rule]:
    """Embedding tables row-sharded over the model axis (the vocab is the big
    axis); small MLP/CIN weights replicated."""
    def table(shape, mesh):
        return _spec(shape, mesh, "model", None)

    def rep(shape, mesh):
        return P(*([None] * len(shape)))
    return [
        (r"embed$|lin_embed$", table),
        (r".*", rep),
    ]


def make_param_specs(params, mesh, rules: list[Rule]):
    """Map a parameter tree (tensors, or anything with a ``shape``) to a
    tree of `P`, by the first rule whose regex matches the leaf's path."""
    shapes = dict((path, tuple(leaf.shape))
                  for path, leaf in leaves_with_path(params))

    def assign(path):
        shape = shapes[path]
        for pat, fn in rules:
            if re.search(pat, path):
                if hasattr(fn, "ndim"):
                    core = fn(shape[-fn.ndim:], mesh) \
                        if len(shape) >= fn.ndim else P(*([None] * len(shape)))
                    pad = len(shape) - len(core)
                    return P(*([None] * pad + list(core)))
                return fn(shape, mesh)
        return P(*([None] * len(shape)))

    return tree_map(assign, path_tree(params))


def replicated(tree):
    """The spec tree that keeps every leaf of ``tree`` whole."""
    return tree_map(lambda t: P(*([None] * len(t.shape))), tree)


def check_specs(tree, specs, mesh) -> None:
    """Raise ValueError unless ``specs`` has ``tree``'s leaf paths, each a
    `P` with one entry per dim, naming the mesh's axes at most once, on
    dims their sizes divide."""
    have = dict(leaves_with_path(tree))
    want = dict(leaves_with_path(specs)) if specs is not None else {}
    if set(have) != set(want):
        raise ValueError(
            f"the spec tree does not match the parameters: missing "
            f"{sorted(set(have) - set(want))[:4]}, extra "
            f"{sorted(set(want) - set(have))[:4]}")
    for path, leaf in have.items():
        spec = want[path]
        if not isinstance(spec, P) or len(spec) != leaf.dim():
            raise ValueError(f"{path}: spec {spec!r} for a tensor of shape "
                             f"{tuple(leaf.shape)}")
        used = [a for ax in spec if ax is not None for a in _axes(ax)]
        if len(set(used)) != len(used) or not set(used) <= set(
                mesh.axis_names):
            raise ValueError(f"{path}: spec {spec!r} on a mesh of axes "
                             f"{mesh.axis_names}")
        for dim, ax in enumerate(spec):
            if ax is not None and leaf.shape[dim] % mesh.axes_size(ax):
                raise ValueError(f"{path}: dim {dim} of {tuple(leaf.shape)} "
                                 f"does not divide over {ax}")


def spec_axes(spec) -> tuple[str, ...]:
    """Every axis a spec shards over."""
    return tuple(a for ax in spec if ax is not None for a in _axes(ax))


def local_slice(t: torch.Tensor, spec, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``spec``: each
    sharded dim cut into as many blocks as its axes hold ranks, the block
    at the rank's index along them (a view). A dim that does not divide
    raises."""
    for dim, ax in enumerate(spec):
        if ax is not None:
            n = mesh.axes_size(ax)
            if t.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(t.shape)} does not "
                                 f"divide over {ax} ({n} ranks)")
            step = t.shape[dim] // n
            t = t.narrow(dim, mesh.axis_index(ax) * step, step)
    return t


def gather_full(block: torch.Tensor, spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's block under ``spec``: one tiled
    all_gather per sharded dim."""
    for dim, ax in enumerate(spec):
        if ax is not None:
            block = mesh.all_gather(block, ax, dim)
    return block


def assemble(blocks, spec, mesh) -> torch.Tensor:
    """The whole tensor from every rank's block under ``spec``, blocks in
    rank order (`DeviceMesh.gather_to_root`'s list), on the blocks'
    device."""
    first = blocks[0]
    shape = [n * (mesh.axes_size(ax) if ax is not None else 1)
             for n, ax in zip(first.shape, spec)]
    out = first.new_empty(shape)
    for r, blk in enumerate(blocks):
        view = out
        for dim, ax in enumerate(spec):
            if ax is not None:
                n = blk.shape[dim]
                view = view.narrow(dim, mesh.index_of(r, ax) * n, n)
        view.copy_(blk)
    return out


# ---------------------------------------------------------------------------
# the model paths' collectives under autograd
# ---------------------------------------------------------------------------

class AllReduce(torch.autograd.Function):
    """Sum over ``axes`` of partial results that every rank of the line
    then holds whole. Backward: the output's gradient, the same on every
    rank of the line, is each partial's."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        return mesh.all_reduce(x, axes)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class Replicated(torch.autograd.Function):
    """The identity on a tensor that every rank of the line holds and uses
    for its own part. Backward: its gradient is the sum of the parts',
    over ``axes``."""

    @staticmethod
    def forward(ctx, x, mesh, axes):
        ctx.mesh, ctx.axes = mesh, axes
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g.contiguous(), ctx.axes), None, None


class Gather(torch.autograd.Function):
    """The whole of a tensor stored in blocks along ``dim`` over ``axes``
    (a ZeRO re-gather). Backward: the whole tensor's gradient summed over
    the line and cut to this rank's block (a reduce-scatter)."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.reduce_scatter(g.contiguous(), ctx.axes, ctx.dim),
                None, None, None)


class Shard(torch.autograd.Function):
    """This rank's block along ``dim`` over ``axes`` of a tensor every rank
    of the line holds whole. Backward: the blocks' gradients gathered, so
    the whole tensor's gradient is the same on every rank of the line."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        n = mesh.axes_size(axes)
        step = x.shape[dim] // n
        return x.narrow(dim, mesh.axis_index(axes) * step, step)

    @staticmethod
    def backward(ctx, g):
        return (ctx.mesh.all_gather(g.contiguous(), ctx.axes, ctx.dim),
                None, None, None)


class GatherCopies(torch.autograd.Function):
    """The whole of a tensor stored in blocks along ``dim`` over ``axes``
    whose ranks all compute the same thing with it (a model column repeats
    its data block). Backward: this rank's block of the whole gradient,
    with no sum: every rank of the line computed that same gradient, and a
    sum would multiply it by the line's size."""

    @staticmethod
    def forward(ctx, x, mesh, axes, dim):
        ctx.mesh, ctx.axes, ctx.dim = mesh, axes, dim
        return mesh.all_gather(x, axes, dim)

    @staticmethod
    def backward(ctx, g):
        return local_slice(g, [ctx.axes if d == ctx.dim else None
                               for d in range(g.dim())], ctx.mesh), \
            None, None, None


def data_axes(mesh) -> tuple[str, ...]:
    """`batch_axis` as a tuple."""
    return _axes(batch_axis(mesh))


def gather_for_compute(block: torch.Tensor, spec, mesh, *,
                       data_only: bool = False) -> torch.Tensor:
    """The whole tensor a mesh rank computes with, from its block under
    ``spec``, with the transposes of the port's compute layout: the batch
    is split over the data axes only, so every rank of a model column
    computes on the same data block with the same whole weights.

    Let rank (d, m) compute G_d, the gradient of its block's loss with
    respect to the whole tensor W; the gradient of the whole batch's loss
    is sum_d G_d, the same for every m. Its block is then:
      * along a dim stored over the data axes (W is the concatenation of
        the data ranks' blocks W_d): block d of sum_d' G_d', which is a
        reduce-scatter over the data axes (`Gather`);
      * along a dim stored over other axes (W the concatenation of the
        blocks W_m): block m of sum_d G_d; G_d is the same on every rank
        of the line over m, so this is a cut, with no sum
        (`GatherCopies`);
      * the data axes that no dim holds still sum: `Replicated` over them
        (an all_reduce of the block's gradient; a norm's whole gradient).
    The cut and the reduce-scatter act on different dims and commute; the
    data dims are gathered first, so the backward cuts first and
    reduce-scatters only this rank's model-axis block.
    ``data_only`` gathers the data dims alone and leaves the others this
    rank's blocks (the routed experts, which compute on their model-axis
    block). A dim stored over data and other axes at once is refused."""
    dp = data_axes(mesh)
    held = set()
    for ax in spec:
        if ax is None:
            continue
        axes = set(_axes(ax))
        if axes & set(dp) and not axes <= set(dp):
            raise ValueError(f"spec {spec!r} mixes the data axes {dp} with "
                             f"others in one dim")
        held |= axes & set(dp)
    rest = tuple(a for a in dp if a not in held)
    x = block
    if rest and mesh.axes_size(rest) > 1:
        x = Replicated.apply(x, mesh, rest)
    sharded = [(dim, ax) for dim, ax in enumerate(spec)
               if ax is not None and mesh.axes_size(ax) > 1]
    # the data dims first: the backward then cuts before it sums, so the
    # reduce-scatter takes this rank's model-axis block, not the whole
    for dim, ax in sharded:
        if set(_axes(ax)) <= set(dp):
            x = Gather.apply(x, mesh, ax, dim)
    if not data_only:
        for dim, ax in sharded:
            if not set(_axes(ax)) <= set(dp):
                x = GatherCopies.apply(x, mesh, ax, dim)
    return x


def model_block_dim(spec, mesh) -> int | None:
    """The dim of a leaf that ``spec`` holds as this rank's block over
    "model" (the last of a matrix for a column block, the first of its two
    for a row block), or None where the leaf is whole over "model": no dim
    names it, ``spec`` is None, or the axis holds one rank. What a
    tensor-parallel layer reads to tell its column, row and whole leaves
    apart."""
    if spec is None or "model" not in mesh.axis_names \
            or mesh.axes_size("model") == 1:
        return None
    for dim, ax in enumerate(spec):
        if ax is not None and "model" in _axes(ax):
            return dim
    return None


def whole_shape(block, spec, mesh) -> tuple[int, ...]:
    """The shape of the whole tensor whose block under ``spec`` is
    ``block``."""
    return tuple(n * (mesh.axes_size(ax) if ax is not None else 1)
                 for n, ax in zip(block.shape, spec))


class Blocks(dict):
    """This rank's blocks of a parameter tree (the dict itself, nested as
    the tree is) with the spec tree (``specs``) and the ``mesh`` that place
    them: what a mesh step hands its loss in place of whole leaves. A
    model path that finds one gathers each leaf where it uses it
    (`gather_for_compute`)."""

    def __init__(self, tree: dict, specs, mesh):
        super().__init__(tree)
        self.specs = specs
        self.mesh = mesh

    def gather(self, *path) -> torch.Tensor:
        """The whole leaf at ``path`` (keys from the root)."""
        t, s = self, self.specs
        for k in path:
            t, s = t[k], s[k]
        return gather_for_compute(t, s, self.mesh)


class ModuleView:
    """A `torch.nn.Module` model computing on a mesh rank's blocks: a call
    gathers every leaf once (`gather_for_compute`) and runs the module
    with them in place of its own parameters (`torch.func.functional_call`),
    which need hold no storage. `param_tree()` is the blocks."""

    def __init__(self, module: torch.nn.Module, blocks: Blocks):
        self.module = module
        self.blocks = blocks
        names = {id(p): n for n, p in module.named_parameters()}
        self._names = [names[id(p)] for p in tree_leaves(
            module.param_tree())]

    def param_tree(self) -> Blocks:
        return self.blocks

    def buffers(self):
        return self.module.buffers()

    def __call__(self, *args, **kwargs):
        whole = [gather_for_compute(b, s, self.blocks.mesh) for b, s in zip(
            tree_leaves(self.blocks), tree_leaves(self.blocks.specs))]
        return torch.func.functional_call(
            self.module, dict(zip(self._names, whole)), args, kwargs,
            strict=False)


def block_view(model, blocks: Blocks):
    """The model a mesh step's loss computes with over ``blocks``: the
    model's own ``on_blocks(blocks)`` where it has one (the LM gathers
    layer by layer), else a `ModuleView`."""
    on = getattr(model, "on_blocks", None)
    return on(blocks) if on is not None else ModuleView(model, blocks)


def kg_local(kg, mesh, perms=None):
    """Rank ``mesh.rank``'s ``(triples[r:r+1], valid[r:r+1],
    perms[r:r+1])`` of a `ShardedKG` on the mesh's device: int32 (1, N,
    3), bool (1, N) and int64 (1, 3, N).

    ``perms`` (``engine.batch.shard_perms(kg)``, all shards) is sliced
    when given; otherwise the rank sorts its own block by each triple
    position, stably, as `shard_perms` does.
    """
    r, dev = mesh.rank, mesh.device
    if kg.n_shards != mesh.size:
        raise ValueError(f"the KG has {kg.n_shards} shards, the mesh "
                         f"{mesh.size} ranks")
    tr = torch.from_numpy(kg.triples[r:r + 1]).to(dev)
    va = torch.from_numpy(kg.valid[r:r + 1]).to(dev)
    if perms is not None:
        pe = torch.from_numpy(perms[r:r + 1]).to(dev).long()
    else:
        pe = torch.stack([torch.sort(tr[0, :, pos], stable=True).indices
                          for pos in range(3)])[None]
    return tr, va, pe
