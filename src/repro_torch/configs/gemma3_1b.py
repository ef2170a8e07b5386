"""gemma3-1b [dense] — heterogeneous 5:1 sliding/global layer pattern.

The repo's first per-layer *heterogeneous* cache stack: five
sliding-window layers for every global full-attention layer
(``layer_pattern="SSSSSG"`` repeated over the stack), with per-kind RoPE
wavelengths — local layers rotate at theta 10k over their short window,
the sparse global layers at 1M to reach the full context.  The serving
stack leases each kind from its own block pool (ring for 'S', classic
refcounted for 'G'), so long-chat KV is dominated by the handful of
global layers instead of the whole stack.
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma3-1b",
    family="dense",
    n_layers=26,
    d_model=1152,
    n_heads=4,
    n_kv_heads=1,
    d_ff=6912,
    vocab=262144,
    head_dim=256,
    qk_norm=True,
    rope_theta=1000000.0,
    rope_theta_local=10000.0,
    rope_theta_global=1000000.0,
    sliding_window=512,
    layer_pattern="SSSSSG",
    max_len=32768,
    source="hf:google/gemma-3-1b-it",
    notes="5:1 local:global interleave; local layers slide a 512-token "
          "window at theta 10k, global layers attend the whole context "
          "at theta 1M — the mixed cache stack the per-layer serving "
          "path exists for",
))
