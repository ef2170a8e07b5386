"""qwen3-1.7b [dense] — qk_norm, GQA [hf:Qwen/Qwen3-8B]."""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-1.7b",
    family="dense",
    n_layers=28,
    d_model=2048,
    n_heads=16,
    n_kv_heads=8,
    d_ff=6144,
    vocab=151936,
    head_dim=128,
    qk_norm=True,
    rope_theta=1000000.0,
    source="hf:Qwen/Qwen3-8B",
    notes="151936-entry vocabulary: the vocab-sharded embedding/lm-head "
          "dominates the small trunk",
))
