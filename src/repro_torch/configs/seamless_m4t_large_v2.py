"""seamless-m4t-large-v2 [audio] — encoder-decoder, multimodal
[arXiv:2308.11596].

The speech frontend (mel-spectrogram + conformer feature extractor) is a
stub per the assignment carve-out: ``input_specs()`` provides precomputed
frame embeddings of shape (batch, src_frames, d_model).  We model the text
decoder (24 layers) attending over a 24-layer encoder.  For the assigned
shapes, seq_len is split evenly between source frames and target tokens.

long_500k is SKIPPED for this arch: full-attention encoder-decoder with no
sub-quadratic variant that would be faithful to the architecture
(DESIGN.md §4).
"""
from .base import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-large-v2",
    family="audio",
    n_layers=24,
    encoder_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,     # full MHA (GQA kv=16 == n_heads)
    d_ff=8192,
    vocab=256206,
    head_dim=64,
    modality="audio_frames",
    source="arXiv:2308.11596",
))
