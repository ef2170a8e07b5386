"""chameleon-34b [vlm] — early-fusion, VQ image tokens [arXiv:2405.09818].

The vision frontend (VQ-GAN tokenizer) is a stub per the assignment
carve-out: ``input_specs()`` provides token ids that already interleave text
and image tokens over the shared 65536-entry vocabulary (early fusion).
Chameleon uses query-key normalization for training stability (§2.2 of the
paper) — ``qk_norm=True``.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="chameleon-34b",
    family="vlm",
    n_layers=48,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=65536,
    head_dim=128,
    qk_norm=True,
    rope_theta=10000.0,
    modality="vision_tokens",
    source="arXiv:2405.09818",
    notes="early-fusion VLM; VQ image tokens share the text vocabulary",
))
