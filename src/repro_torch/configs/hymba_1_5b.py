"""hymba-1.5b [hybrid] — parallel attention + mamba heads [arXiv:2411.13676].

Each layer runs attention heads and SSM (Mamba2) heads *in parallel* on the
same normalized input and mean-fuses the two branch outputs with learned
per-branch output norms (Hymba §2.1).  Hymba's attention is sliding-window
in all but three layers; we model the sliding-window layers (window 1024,
arXiv table 9), which is what makes long_500k tractable.  Meta tokens are
not modeled (DESIGN.md §4).
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hymba-1.5b",
    family="hybrid",
    n_layers=32,
    d_model=1600,
    n_heads=25,
    n_kv_heads=5,
    d_ff=5504,
    vocab=32001,
    head_dim=64,
    sliding_window=1024,
    ssm_state=16,
    ssm_expand=2,
    ssm_head_dim=64,
    source="arXiv:2411.13676",
    notes="25 heads do not divide a 16-way model axis (GSPMD pads)",
))
