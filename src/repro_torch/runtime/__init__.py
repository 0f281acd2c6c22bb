"""The training runtime (`runtime.trainer`)."""
from repro_torch.runtime.trainer import Trainer, TrainTask

__all__ = ["Trainer", "TrainTask"]
