"""Synthetic inputs, pure numpy: the port's own copy of what it needs
from ``repro.data.pipeline``, drawn the same way, so both packages see
the same frames for a seed."""
from __future__ import annotations

import numpy as np


def audio_batch_stub(batch: int, src_len: int, tgt_len: int, d_model: int,
                     vocab: int, seed: int = 0) -> dict[str, np.ndarray]:
    """The audio-frontend carve-out: precomputed frame embeddings
    ``src`` (batch, src_len, d_model) fp32 in place of the mel +
    conformer feature extractor, and target ``tokens`` / ``labels``
    (batch, tgt_len) int32."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, vocab, size=(batch, tgt_len + 1))
    return {
        "src": rng.normal(size=(batch, src_len, d_model)).astype(np.float32),
        "tokens": toks[:, :-1].astype(np.int32),
        "labels": toks[:, 1:].astype(np.int32),
    }
