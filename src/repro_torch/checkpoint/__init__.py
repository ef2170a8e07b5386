"""Checkpoints of the port (the counterpart of ``repro.checkpoint``),
in the reference's layout and key strings."""
from .store import latest_step, load_checkpoint, save_checkpoint

__all__ = ["latest_step", "load_checkpoint", "save_checkpoint"]
