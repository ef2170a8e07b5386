"""mamba2-370m [ssm] — SSD (state-space duality) [arXiv:2405.21060].

Attention-free: every layer is a Mamba2 block computed with the chunked SSD
algorithm (intra-chunk dual quadratic form + inter-chunk state recurrence).
long_500k decodes with O(1) state per token — the natural sub-quadratic arch.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mamba2-370m",
    family="ssm",
    n_layers=48,
    d_model=1024,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_expand=2,
    ssm_head_dim=64,
    ssm_conv=4,
    ssm_chunk=128,
    source="arXiv:2405.21060",
    notes="vocab 50280 is not 16-divisible; padded to 50432 for the vocab shard",
))
