"""Background-prefetching pipeline wrapper (input-side straggler mitigation).

The port of the reference's `data/pipeline.py`. SPMD training is
lock-step: a slow input host stalls every chip. The Prefetcher keeps a
bounded queue filled from a worker thread and exports its depth as a
metric — the runtime's watchdog flags steps where the queue ran dry (input
straggler) vs. compute-time anomalies (chip straggler).

The worker thread only runs the iterator (numpy batches stay numpy there).
With ``device`` given, `__next__` moves each batch's numpy arrays to that
device on the caller's thread: on the card through pinned host memory
with a non-blocking copy on the current stream, so the copy is ordered
before the step that reads it.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch


def to_device(item, device: torch.device):
    """A batch's numpy arrays (in a dict, or the item itself) as tensors on
    ``device``; anything else passes through."""
    if isinstance(item, dict):
        return {k: to_device(v, device) for k, v in item.items()}
    if not isinstance(item, np.ndarray):
        return item
    t = torch.from_numpy(np.ascontiguousarray(item))
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


class Prefetcher:
    def __init__(self, iterator, depth: int = 4, *,
                 device: torch.device | str | None = None):
        self._it = iterator
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None
        self._done = False
        self.device = None if device is None else torch.device(device)
        self._t = threading.Thread(target=self._fill, daemon=True)
        self._t.start()

    def _fill(self):
        try:
            for item in self._it:
                self._q.put(item)
        except BaseException as e:   # surfaced on next()
            self._err = e
        finally:
            self._done = True
            self._q.put(None)

    @property
    def depth(self) -> int:
        return self._q.qsize()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is None:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item if self.device is None else to_device(item, self.device)
