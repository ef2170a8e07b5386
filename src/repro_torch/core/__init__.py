"""Planner core of the PyTorch port: graph IR, H100 cost model, device
spec and the serving half of the pass manager."""
from .dos import DeviceSpec
from .pipeline import KernelPlan, StageTimer, optimize

__all__ = ["DeviceSpec", "KernelPlan", "StageTimer", "optimize"]
