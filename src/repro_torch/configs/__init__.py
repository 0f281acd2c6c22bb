"""Architecture config registry: ``--arch <id>`` resolves here, as in the
reference's `configs/__init__.py`.

Each configs/<id>.py module of an architecture defines:
  full()   — the exact assigned configuration,
  smoke()  — a reduced same-family config for CPU tests,
  FAMILY   — "lm" | "gnn" | "recsys",
  SHAPES   — the arch's assigned input-shape ids.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Any, Callable

ARCH_IDS = [
    "granite-3-8b", "granite-20b", "nemotron-4-15b", "qwen2-moe-a2.7b",
    "deepseek-v3-671b",
    "equiformer-v2", "nequip", "egnn", "gcn-cora",
    "xdeepfm",
]

_MODULES = {a: "repro_torch.configs." + a.replace("-", "_").replace(".", "_")
            for a in ARCH_IDS}

LM_SHAPES = ["train_4k", "prefill_32k", "decode_32k", "long_500k"]
GNN_SHAPES = ["full_graph_sm", "minibatch_lg", "ogb_products", "molecule"]
RECSYS_SHAPES = ["train_batch", "serve_p99", "serve_bulk", "retrieval_cand"]


@dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str
    shapes: tuple[str, ...]
    full: Callable[[], Any]
    smoke: Callable[[], Any]


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id not in _MODULES:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(_MODULES[arch_id])
    return ArchSpec(arch_id=arch_id, family=mod.FAMILY,
                    shapes=tuple(mod.SHAPES), full=mod.full, smoke=mod.smoke)


def all_cells() -> list[tuple[str, str]]:
    """Every assigned (arch x shape) cell — 40 total."""
    cells = []
    for a in ARCH_IDS:
        spec = get_arch(a)
        cells.extend((a, s) for s in spec.shapes)
    return cells
