"""Optimizer and LR schedule of the port (the counterpart of
``repro.optim``)."""
from .adamw import AdamWConfig, AdamWState, adamw_init, adamw_update, global_norm
from .schedule import cosine_schedule

__all__ = ["AdamWConfig", "AdamWState", "adamw_init", "adamw_update",
           "cosine_schedule", "global_norm"]
