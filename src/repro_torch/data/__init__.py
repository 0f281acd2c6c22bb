"""Synthetic input streams (numpy, made from a seed) and the background
prefetcher."""
from repro_torch.data.pipeline import Prefetcher

__all__ = ["Prefetcher"]
