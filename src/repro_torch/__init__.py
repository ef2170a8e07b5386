"""PyTorch/CUDA port of the Xenos reproduction, for one NVIDIA H100.

A second package beside the JAX reference (``repro``), mirroring its
layout: ``configs/``, ``models/``, ``kernels/`` (hand-written CUDA for
``sm_90a``, sources in ``csrc/``), ``serving/``, ``core/``, ``launch/``,
``data/`` and ``convert.py``.  It imports torch and numpy and nothing
of JAX or of the reference package.  Entry points run on the card unless
the caller asks for the CPU (``device="cpu"``), as the tests do.
"""
from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a ``torch.device``; CUDA without a card raises — the
    port never falls back to the CPU on its own."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch sees no CUDA device; "
            "pass device='cpu' to run on the host")
    return dev
