"""Dry run on PyTorch's meta device: ``python -m repro_torch.launch.dryrun``.

The port of the reference's `launch/dryrun.py`. The reference lowers and
compiles every (architecture x input-shape) cell for 512 virtual XLA
devices and reads XLA's cost and memory analyses. The port runs each
cell's step (`launch.cells`) as ONE rank's program on a `MetaMesh` of the
production mesh (16 x 16 ("data", "model"), or 2 x 16 x 16 ("pod",
"data", "model") with ``--multipod``): every tensor is a meta tensor, so
nothing is allocated or computed and no card is needed, and the mesh
counts the collectives it would issue. One JSON record per line, with the
reference's keys:

  flops                 — `torch.utils.flop_counter.FlopCounterMode`'s
                          total over the step (forward and backward), with
                          the matrix-vector and vector products it leaves
                          out (`FLOP_EXTRA`), plus the kernels' own
                          operations (`kernels.meta_cost`). It counts
                          matmul-class work (mm, bmm, addmm, mv, dot,
                          attention) only, unlike XLA's count of every
                          operation.
  bytes_accessed        — the sum over every dispatched op of its input and
                          output tensors' bytes, plus the kernels' meta
                          bytes: not XLA's "bytes accessed", which counts
                          after fusion.
  argument_size_bytes   — the bytes of the step's arguments (the rank's
                          blocks, the model's tensors, the batch), each
                          storage once, in the card allocator's 512-byte
                          blocks (as every size below);
  temp_size_bytes       — the peak of the bytes the step allocates and
                          holds at once (live storages, tracked by their
                          untyped storage, so views count once; autograd's
                          saved tensors as the real run keeps them);
  output_size_bytes     — the bytes of the step's outputs it allocated;
  peak_bytes_per_device — arguments + temp: the live-bytes peak of the run;
  collectives           — the mesh's count by the reference's HLO
                          convention (`collective_bytes`: each collective's
                          output bytes in its own dtype, by kind);
  adjusted              — `launch.components.lm_component_costs` for LM
                          cells (equal to the whole program: the port's
                          run counts every layer and every micro-batch);
  trace_s               — the meta run's wall seconds (for the reference's
                          lower_s and compile_s);
  device_bytes, fits    — the card's memory (`H100_TOTAL_MEMORY`) and
                          whether the peak is within it, with no headroom
                          for the CUDA context or the allocator's
                          fragmentation: a peak near the total is a fit
                          on paper only.

A cell that fails is recorded as an error record and the loop goes on.
``--engine`` runs the paper's per-query engines on a meta engine mesh
(`engine.federated.lower_engine`) and counts their gathers.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch granite-3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --out build/dryrun.jsonl
  PYTHONPATH=src python -m repro_torch.launch.dryrun --engine
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
import traceback
import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch import kernels
from repro_torch.launch import cells as _cells
from repro_torch.launch.mesh import MetaMesh, make_production_mesh

# torch.cuda.get_device_properties(0).total_memory of an NVIDIA H100 80GB
# HBM3 (chip_smoke.py asserts the card reads this)
H100_TOTAL_MEMORY = 85_017_493_504


def _mv_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * a_shape[0] * a_shape[1]


def _dot_flop(a_shape, b_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * a_shape[0]


# products `FlopCounterMode`'s registry leaves out (torch 2.13 counts mm,
# bmm, addmm and baddbmm but not a matrix-vector or a vector-vector
# product): (N, D) @ (D,) is 2 N D, (D,) @ (D,) is 2 D
FLOP_EXTRA = {torch.ops.aten.mv: _mv_flop, torch.ops.aten.dot: _dot_flop}
# the CUDA caching allocator hands out blocks in multiples of 512 bytes,
# and max_memory_allocated counts them so: the live bytes count the same
BLOCK = 512


def _blocks(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


def _tensors(obj, out: list) -> list:
    """Every tensor in nested tuples, lists, dicts and dataclasses, and a
    model's (its `param_tree()`, and a module's buffers)."""
    if isinstance(obj, torch.Tensor):
        out.append(obj)
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            _tensors(x, out)
    elif isinstance(obj, dict):
        for x in obj.values():
            _tensors(x, out)
    elif hasattr(obj, "param_tree"):
        _tensors(obj.param_tree(), out)
        if hasattr(obj, "buffers"):         # a module, or a view of one
            out.extend(obj.buffers())
    elif dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        for f in dataclasses.fields(obj):
            _tensors(getattr(obj, f.name), out)
    return out


class Accounting(TorchDispatchMode):
    """Counts, over every op dispatched while it is on, the bytes of its
    inputs and outputs (``bytes``) and the storages it allocates: an
    output storage that is none of the op's inputs' is new, counted live
    (``live``) until it is freed, and ``peak`` is the most live at once,
    each storage in whole 512-byte blocks as the card's allocator counts
    it. Storages registered by `hold` (the arguments) are never counted as
    new. The same counting runs over meta and real tensors."""

    def __init__(self):
        super().__init__()
        self.live = 0
        self.peak = 0
        self.bytes = 0
        self._sizes: dict[int, int] = {}
        self._held: set[int] = set()
        self._keep: list = []

    def hold(self, *trees) -> int:
        """Register the storages of ``trees``' tensors as held before the
        step; returns their bytes, each storage once."""
        total = 0
        for t in _tensors(list(trees), []):
            st = t.untyped_storage()
            if id(st) not in self._held:
                self._held.add(id(st))
                self._keep.append(st)
                total += _blocks(st.nbytes())
        return total

    def _free(self, key: int) -> None:
        self.live -= self._sizes.pop(key, 0)

    def new_bytes(self, tree) -> int:
        """Bytes of ``tree``'s storages that the step allocated."""
        seen = {id(t.untyped_storage()):
                _blocks(t.untyped_storage().nbytes())
                for t in _tensors(tree, [])}
        return sum(n for k, n in seen.items() if k in self._sizes)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins = _tensors((args, kwargs), [])
        outs = _tensors(out, [])
        self.bytes += sum(t.numel() * t.element_size() for t in ins) \
            + sum(t.numel() * t.element_size() for t in outs)
        if outs:
            in_ids = {id(t.untyped_storage()) for t in ins}
            for t in outs:
                st = t.untyped_storage()
                key = id(st)
                if key in in_ids or key in self._sizes or key in self._held:
                    continue
                n = _blocks(st.nbytes())
                self._sizes[key] = n
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(st, self._free, key)
        return out


def account(fn, args) -> dict:
    """Run ``fn(*args)`` under `Accounting`, `FlopCounterMode` and a fresh
    `kernels.meta_cost`: its FLOPs (the dispatcher's, the kernels', and
    their sum), bytes, argument / temp / output bytes and the live peak."""
    kernels.meta_cost.reset()
    acc = Accounting()
    arg_bytes = acc.hold(args)
    counter = FlopCounterMode(display=False, custom_mapping=FLOP_EXTRA)
    t0 = time.perf_counter()
    with counter, acc:
        out = fn(*args)
        out_bytes = acc.new_bytes(out)
    dt = time.perf_counter() - t0
    km = kernels.meta_cost
    disp = int(counter.get_total_flops())
    return {"dispatch_flops": disp, "kernel_flops": km.ops,
            "flops": float(disp + km.ops),
            "bytes_accessed": float(acc.bytes + km.bytes),
            "argument_size_bytes": arg_bytes,
            "output_size_bytes": out_bytes,
            "temp_size_bytes": acc.peak,
            "peak_bytes_per_device": arg_bytes + acc.peak,
            "kernel_calls": dict(km.calls), "trace_s": round(dt, 3)}


def mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.sizes)


def run_cell(arch: str, shape: str, *, multi_pod: bool = False) -> dict:
    """One cell's record on a `MetaMesh` of the production mesh."""
    shp = make_production_mesh(multi_pod=multi_pod)
    mesh = MetaMesh(shp.sizes, shp.axis_names)
    cell = _cells.build_cell(arch, shape, mesh)
    acc = account(cell.fn, cell.args)
    # read before the components re-run parts of the step on the same mesh
    coll = mesh.hlo_collectives()
    calls, nbytes = dict(mesh.calls), dict(mesh.bytes)
    adjusted = None
    from repro_torch.configs import get_arch
    if get_arch(arch).family == "lm":
        from repro_torch.launch.components import lm_component_costs
        adjusted = lm_component_costs(arch, shape, mesh, cell=cell)
    peak = acc["peak_bytes_per_device"]
    return {
        "arch": arch, "shape": shape, "kind": cell.kind,
        "mesh": mesh_name(mesh), "n_chips": mesh.size,
        "model_flops": cell.model_flops,
        "flops": acc["flops"], "bytes_accessed": acc["bytes_accessed"],
        "argument_size_bytes": acc["argument_size_bytes"],
        "output_size_bytes": acc["output_size_bytes"],
        "temp_size_bytes": acc["temp_size_bytes"],
        "peak_bytes_per_device": peak,
        "collectives": coll, "adjusted": adjusted,
        "trace_s": acc["trace_s"],
        "meta": {k: v for k, v in cell.meta.items()
                 if isinstance(v, (int, float, str, bool, dict))},
        "device_bytes": H100_TOTAL_MEMORY,
        "fits": peak <= H100_TOTAL_MEMORY,
        "dispatch_flops": acc["dispatch_flops"],
        "kernel_flops": acc["kernel_flops"],
        "kernel_calls": acc["kernel_calls"],
        "mesh_calls": calls, "mesh_bytes": nbytes,
    }


def run_engine_rows(*, multi_pod: bool = False) -> list:
    """The paper's federated query plans on the production mesh's "model"
    axis: LUBM(1) at scale 0.5 (seed 0) under WawPart and random
    placement over the axis's 16 shards; per query the gathers one rank
    of the meta engine mesh issues, counted."""
    from repro_torch.core.partitioner import (random_partition,
                                              wawpart_partition)
    from repro_torch.engine.federated import ShardedKG, lower_engine
    from repro_torch.engine.planner import make_plan
    from repro_torch.kg.generator import generate_lubm
    from repro_torch.kg.workloads import lubm_queries

    mesh = make_production_mesh(multi_pod=multi_pod)
    n_shards = int(mesh.shape["model"])
    store = generate_lubm(1, scale=0.5, seed=0)
    queries = lubm_queries()
    rows = []
    for method, pfn in [("wawpart", wawpart_partition),
                        ("random", random_partition)]:
        part = pfn(store, queries, n_shards=n_shards)
        kg = ShardedKG.build(part)
        for q in queries:
            plan = make_plan(q, part)
            low = lower_engine(plan, (kg.n_shards, kg.cap), mesh,
                               axis="model")
            rows.append({
                "arch": f"kg-engine-{method}", "shape": q.name,
                "kind": "query", "mesh": mesh_name(mesh),
                "n_gathers": plan.n_gathers,
                "n_distributed_joins": len(plan.cut_steps),
                "flops": float(low["flops"]),
                "collectives": low["collectives"],
            })
    return rows


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--engine", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cache-update", choices=("dus", "masked"),
                    default="masked")
    args = ap.parse_args(argv)
    if args.cache_update == "dus":
        raise NotImplementedError(
            "--cache-update dus: the port writes the decode cache in place "
            "(the reference's 'masked' write, with no collective); a "
            "functional dynamic_update_slice copy of the cache has no "
            "counterpart here (ROADMAP, divergences by design)")

    from repro_torch.configs import all_cells

    records = []
    meshes = [False, True] if args.both_meshes else [args.multipod]

    def emit(rec):
        records.append(rec)
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")

    if args.engine:
        for mp in meshes:
            for rec in run_engine_rows(multi_pod=mp):
                emit(rec)
        return records

    if not args.all and not (args.arch and args.shape):
        ap.error("give --arch and --shape, --all or --engine")
    todo = all_cells() if args.all else [(args.arch, args.shape)]
    for arch, shape in todo:
        for mp in meshes:
            try:
                emit(run_cell(arch, shape, multi_pod=mp))
            except Exception as e:  # record the failure, keep going
                emit({"arch": arch, "shape": shape,
                      "mesh": "2x16x16" if mp else "16x16",
                      "error": f"{type(e).__name__}: {e}",
                      "trace": traceback.format_exc()[-2000:]})
    return records


if __name__ == "__main__":
    main()
