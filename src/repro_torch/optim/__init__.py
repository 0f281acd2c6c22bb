"""Optimizer pieces of the training runtime: AdamW, the LR schedule and
int8 error-feedback gradient compression (`optim.compress`)."""
from repro_torch.optim.adamw import adamw_init, adamw_update
from repro_torch.optim.schedules import cosine_schedule

__all__ = ["adamw_init", "adamw_update", "cosine_schedule"]
