"""chatglm3-6b [dense] — RoPE 2d, GQA kv=2 [arXiv:2406.12793].

"RoPE 2d": rotary embedding applied to half of every head's dims
(``rope_fraction=0.5``), the GLM convention.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="chatglm3-6b",
    family="dense",
    n_layers=28,
    d_model=4096,
    n_heads=32,
    n_kv_heads=2,
    d_ff=13696,
    vocab=65024,
    head_dim=128,
    rope_fraction=0.5,
    source="arXiv:2406.12793",
    notes="kv=2 over a 16-way model axis: heavy KV padding under outC-first "
          "sharding — a DOS imbalance case study",
))
