"""Device description for the planner passes (``repro.core.dos``'s
``DeviceSpec``, retargeted to the H100).

The paper describes its target as compute units with a private and a
shared memory tier.  On the H100 a unit is a streaming multiprocessor,
its private tier the shared memory one thread block can use, and the
shared tier device memory.  The DOS split itself follows with ROADMAP
queue 1 item 6.
"""
from __future__ import annotations

import dataclasses

from .costmodel import HBM_BYTES, SMEM_BYTES


@dataclasses.dataclass
class DeviceSpec:
    """Resource description of the target (paper: DSP count + L2/shared mem)."""

    n_units: int = 132               # H100 SXM: streaming multiprocessors
    l2_bytes: int = SMEM_BYTES       # private per-unit memory (shared memory)
    shared_bytes: int = HBM_BYTES    # shared memory (device memory)
    name: str = "h100_sxm"
