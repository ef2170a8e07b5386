"""Data pipeline, pure numpy: the port's own copy of
``repro.data.pipeline``, drawn the same way, so both packages see the
same arrays for a seed.

The synthetic stream is a seeded token process with a sparse bigram
skeleton, so a small LM visibly learns within tens of steps (the
convergence checks).  The file-backed dataset memory-maps a flat
uint16/uint32 token file.  ``make_train_iterator`` slices each global
batch by (shard_index, num_shards), so the shards of one step read
disjoint rows.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class SyntheticLM:
    """Deterministic synthetic language-model stream: each token follows
    one of ``branching`` fixed successors with probability ``follow``,
    else a uniform token."""

    vocab: int
    seq_len: int
    seed: int = 0
    branching: int = 2
    follow: float = 0.9

    def __post_init__(self) -> None:
        rng = np.random.default_rng(self.seed)
        self._succ = rng.integers(0, self.vocab,
                                  size=(self.vocab, self.branching))
        self._rng = np.random.default_rng(self.seed + 1)

    def sample(self, batch: int) -> np.ndarray:
        """(batch, seq_len + 1) int64 tokens."""
        out = np.empty((batch, self.seq_len + 1), np.int64)
        cur = self._rng.integers(0, self.vocab, size=batch)
        for t in range(self.seq_len + 1):
            out[:, t] = cur
            follow = self._rng.random(batch) < self.follow
            pick = self._succ[cur, self._rng.integers(0, self.branching,
                                                      size=batch)]
            fresh = self._rng.integers(0, self.vocab, size=batch)
            cur = np.where(follow, pick, fresh)
        return out


class TokenFileDataset:
    """Flat binary token file, memory-mapped; sequential chunking into
    ``seq_len + 1``-token windows."""

    def __init__(self, path: str | Path, seq_len: int, dtype=np.uint16):
        self.tokens = np.memmap(path, dtype=dtype, mode="r")
        self.seq_len = seq_len
        self.n_seqs = (len(self.tokens) - 1) // seq_len

    def __len__(self) -> int:
        return self.n_seqs

    def get(self, idx: np.ndarray) -> np.ndarray:
        s = self.seq_len
        out = np.empty((len(idx), s + 1), np.int64)
        for i, j in enumerate(idx):
            start = int(j) * s
            out[i] = self.tokens[start:start + s + 1]
        return out


def make_train_iterator(source, global_batch: int, *, shard_index: int = 0,
                        num_shards: int = 1, seed: int = 0,
                        ) -> Iterator[dict[str, np.ndarray]]:
    """Yields {'tokens', 'labels'} (int32, this shard's rows) of each
    global batch: a :class:`SyntheticLM` sample, or ``global_batch``
    random windows of a :class:`TokenFileDataset` drawn from ``seed``."""
    if global_batch % num_shards:
        raise ValueError(f"global batch {global_batch} does not split into "
                         f"{num_shards} shards")
    local = global_batch // num_shards
    lo, hi = shard_index * local, (shard_index + 1) * local
    if isinstance(source, SyntheticLM):
        while True:
            mine = source.sample(global_batch)[lo:hi]
            yield {"tokens": mine[:, :-1].astype(np.int32),
                   "labels": mine[:, 1:].astype(np.int32)}
    else:
        rng = np.random.default_rng(seed)
        while True:
            idx = rng.integers(0, len(source), size=global_batch)
            mine = source.get(idx[lo:hi])
            yield {"tokens": mine[:, :-1].astype(np.int32),
                   "labels": mine[:, 1:].astype(np.int32)}


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
