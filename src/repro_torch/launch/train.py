"""Training entry point: ``python -m repro_torch.launch.train --arch <id>``.

The port of the reference's `launch/train.py`: builds the task of the
arch's family (lm, gnn, recsys) and runs the fault-tolerant `Trainer` on
one device, resuming from --ckpt-dir. ``--device`` defaults to the card
(``cuda``; it raises where there is none) and ``--device cpu`` runs on the
CPU. ``--config smoke`` (the default, as the reference trains) takes the
arch's reduced config, ``--config full`` its assigned one: xDeepFM at its
full width (294 M parameters), a GNN's full() on the full-size
full_graph_sm batch, an LM's full() in float32 (128 GB of parameters,
gradients and moments at granite-3-8b: more than one card holds).
``--layers N`` cuts an LM's depth to N layers (a MoE config's leading
dense layers to at most N), so that an arch's full widths fit one card.
"""
from __future__ import annotations

import argparse
import dataclasses
import importlib

from repro_torch.configs import get_arch
from repro_torch.data import Prefetcher
from repro_torch.engine.federated import resolve_device
from repro_torch.runtime.trainer import Trainer, TrainTask

GNN_MODULES = {"gcn-cora": "gcn", "egnn": "egnn", "nequip": "nequip",
               "equiformer-v2": "equiformer_v2"}
GNN_CLASSES = {"gcn-cora": "GCN", "egnn": "EGNN", "nequip": "NequIP",
               "equiformer-v2": "EquiformerV2"}


def build_task(arch_id: str, steps: int, batch: int, seq: int,
               compress: bool, *, device="cuda",
               config: str = "smoke", n_layers: int | None = None) -> TrainTask:
    spec = get_arch(arch_id)
    if config not in ("smoke", "full"):
        raise ValueError(f"config must be 'smoke' or 'full', got {config!r}")
    cfg = spec.full() if config == "full" else spec.smoke()
    dev = resolve_device(device)
    compression = "int8_ef" if compress else None
    if spec.family == "lm":
        from repro_torch.data.tokens import token_batches
        from repro_torch.models.transformer import Transformer, loss_fn
        cfg = dataclasses.replace(cfg, dtype="float32")
        if n_layers is not None:
            cfg = dataclasses.replace(
                cfg, n_layers=n_layers,
                first_dense_layers=min(cfg.first_dense_layers, n_layers))
        return TrainTask(
            name=arch_id,
            init_params=lambda g: Transformer.random(
                cfg, seed=g.initial_seed(), device=g.device),
            loss_fn=lambda m, b: loss_fn(m.params, cfg, b["tokens"],
                                         b["labels"]),
            batches=Prefetcher(token_batches(cfg.vocab_size, batch, seq,
                                             seed=1), device=dev),
            lr=1e-3, warmup=20, total_steps=steps,
            grad_compression=compression, device=dev)
    if spec.family == "gnn":
        from repro_torch.data.graphs import make_graph_batch
        mod = importlib.import_module(
            "repro_torch.models.gnn." + GNN_MODULES[arch_id])
        model_cls = getattr(mod, GNN_CLASSES[arch_id])
        g = make_graph_batch("full_graph_sm", d_feat=getattr(cfg, "d_in", 16),
                             n_classes=getattr(cfg, "n_classes", 4),
                             reduced=config == "smoke", device=dev)

        def batches():
            while True:
                yield g
        return TrainTask(
            name=arch_id,
            init_params=lambda gen: model_cls.random(cfg, gen),
            loss_fn=mod.loss_fn,
            batches=batches(), lr=1e-3, warmup=10, total_steps=steps,
            grad_compression=compression, device=dev)
    # recsys
    from repro_torch.data.recsys import click_batches
    from repro_torch.models.recsys import xdeepfm as xd
    return TrainTask(
        name=arch_id,
        init_params=lambda gen: xd.XDeepFM.random(cfg, gen),
        loss_fn=xd.loss_fn,
        batches=Prefetcher(click_batches(cfg.vocab_sizes, cfg.n_dense, batch,
                                         seed=1), device=dev),
        lr=1e-3, warmup=10, total_steps=steps,
        grad_compression=compression, device=dev)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-8b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--config", default="smoke", choices=("smoke", "full"))
    ap.add_argument("--layers", type=int, default=None,
                    help="cut an LM to this many layers")
    args = ap.parse_args(argv)

    task = build_task(args.arch, args.steps, args.batch, args.seq,
                      args.compress, device=args.device, config=args.config,
                      n_layers=args.layers)
    trainer = Trainer(task, ckpt_dir=args.ckpt_dir,
                      ckpt_every=args.ckpt_every)
    out = trainer.run(steps=args.steps)
    log = out["log"]
    print(f"[{args.arch}] steps {log[0]['step']}..{log[-1]['step']} "
          f"loss {log[0]['loss']:.4f} -> {log[-1]['loss']:.4f} "
          f"({sum(r['dt'] for r in log):.1f}s)")


if __name__ == "__main__":
    main()
