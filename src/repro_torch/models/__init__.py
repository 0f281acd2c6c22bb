"""Model families of the port."""
from __future__ import annotations

import torch


class MetaGenerator(torch.Generator):
    """A CPU generator whose ``device`` reads as ``meta``.

    The models' ``random(cfg, generator)`` draw on ``generator.device``;
    given this one they build their parameters on the meta device (shapes
    and dtypes, nothing allocated), which the dry run reads. PyTorch has
    no generator of the meta device, and a draw onto meta tensors reads
    none."""

    @property
    def device(self) -> torch.device:
        return torch.device("meta")


def meta_generator(seed: int = 0) -> MetaGenerator:
    """A `MetaGenerator` seeded with ``seed``."""
    g = MetaGenerator()
    g.manual_seed(seed)
    return g
