"""Per-request generation policy: temperature / top-k / top-p sampling.

The counterpart of ``repro.serving.sampling``.  Every row draws with a key
derived only from its request's ``seed`` and emitted-token count —
``fold_in(key(seed), step)`` followed by ``categorical`` — so a request
samples the same tokens whatever slot or batch it lands in.  The port
reproduces JAX's draw bit for bit: threefry2x32 in integer torch ops
(int64 masked to 32 bits, since CUDA torch lacks most uint32 ops), the
partitionable bit layout of ``jax.random.bits`` (counter = the flat
index, bits = hi ^ lo of the hash), ``uniform(minval=tiny, maxval=1)``
from the top 23 bits, and ``categorical`` as the Gumbel argmax in fp32.

``temperature <= 0`` is exact argmax; filtering order is temperature ->
top-k (ties at the k-th value survive) -> top-p (the most likely token
always survives).
"""
from __future__ import annotations

import dataclasses

import torch

_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_TINY = torch.finfo(torch.float32).tiny


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """How one request turns logits into tokens (defaults: greedy)."""

    temperature: float = 0.0
    top_k: int = 0          # keep the k most likely tokens; 0 disables
    top_p: float = 1.0      # keep the smallest set with mass >= p; 1 disables
    seed: int = 0           # per-request PRNG stream (fold_in'd per token)

    def __post_init__(self):
        if self.temperature < 0:
            raise ValueError(f"temperature must be >= 0, got {self.temperature}")
        if self.top_k < 0:
            raise ValueError(f"top_k must be >= 0, got {self.top_k}")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")

    @property
    def greedy(self) -> bool:
        return self.temperature <= 0.0


# ---------------------------------------------------------------------------
# threefry2x32 and the keyed draw
# ---------------------------------------------------------------------------

def threefry2x32(k1: torch.Tensor, k2: torch.Tensor, x0: torch.Tensor,
                 x1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 hash (20 rounds) on int64 tensors holding uint32
    values; arguments broadcast.  Returns the two output words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = (((x1 << r) | (x1 >> (32 - r))) & _M32) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def prng_key(seeds: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.key(seed)`` per row for 32-bit seeds: the key words
    are ``(seed >> 32, seed & 0xFFFFFFFF)`` = ``(0, seed)``."""
    s = seeds.to(torch.int64) & _M32
    return torch.zeros_like(s), s


def fold_in(key: tuple[torch.Tensor, torch.Tensor],
            data: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """``jax.random.fold_in``: hash the counter pair ``(0, data)``."""
    d = data.to(torch.int64) & _M32
    return threefry2x32(key[0], key[1], torch.zeros_like(d), d)


def random_bits(key: tuple[torch.Tensor, torch.Tensor], n: int
                ) -> torch.Tensor:
    """``jax.random.bits(key, (n,))`` per row (partitionable layout):
    (B,) keys -> (B, n) int64 holding uint32 values."""
    k1, k2 = key[0][:, None], key[1][:, None]
    lo = torch.arange(n, dtype=torch.int64, device=k1.device)[None, :]
    y0, y1 = threefry2x32(k1, k2, torch.zeros_like(lo), lo)
    return y0 ^ y1


def gumbel(key: tuple[torch.Tensor, torch.Tensor], n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,))`` in fp32 ("low" mode):
    ``-log(-log(uniform(minval=tiny, maxval=1)))``."""
    bits = random_bits(key, n)
    mantissa = ((bits >> 9) | 0x3F800000).to(torch.int32)
    floats = mantissa.view(torch.float32) - 1.0
    # fills on the device, not copies from the host: no stream sync
    lo = torch.full((), _TINY, dtype=torch.float32, device=bits.device)
    span = torch.full((), 1.0, dtype=torch.float32, device=bits.device) - lo
    u = torch.maximum(lo, floats * span + lo)
    return -torch.log(-torch.log(u))


def categorical(key: tuple[torch.Tensor, torch.Tensor],
                logits: torch.Tensor) -> torch.Tensor:
    """``jax.random.categorical`` per row: argmax of Gumbel noise plus the
    (B, V) logits (first index wins ties)."""
    return torch.argmax(gumbel(key, logits.shape[-1]) + logits, dim=-1)


def keyed_draw(masked: torch.Tensor, seeds: torch.Tensor,
               steps: torch.Tensor) -> torch.Tensor:
    """The serving draw: key ``fold_in(key(seed), step)`` per row."""
    return categorical(fold_in(prng_key(seeds), steps), masked)


# ---------------------------------------------------------------------------
# The reference (two-sort) sampler
# ---------------------------------------------------------------------------

def _policy(logits, seeds, steps, temperature, top_k, top_p):
    dev = logits.device
    return (seeds.to(dev), steps.to(dev), temperature.to(dev, torch.float32),
            top_k.to(dev, torch.int64), top_p.to(dev, torch.float32))


def sample_tokens(logits, seeds, steps, temperature, top_k, top_p, *,
                  vocab: int) -> torch.Tensor:
    """Batched per-row sampling: ``(B, V) -> (B,)`` int32 tokens.

    Per-row ``(B,)`` policy tensors; ``vocab`` is the unpadded vocabulary
    (padded logits are never sampled).  The two-sort filter of the
    reference, vectorized over rows."""
    seeds, steps, temperature, top_k, top_p = _policy(
        logits, seeds, steps, temperature, top_k, top_p)
    rows = logits[..., :vocab].float()
    V = rows.shape[-1]
    greedy_tok = torch.argmax(rows, dim=-1)
    safe_t = torch.where(temperature > 0, temperature, 1.0)
    x = rows / safe_t[:, None]
    kth = torch.sort(x, dim=-1, descending=True).values.gather(
        1, (top_k - 1).clamp(0, V - 1)[:, None])
    x = torch.where((top_k[:, None] <= 0) | (x >= kth), x, -torch.inf)
    probs = torch.softmax(x, dim=-1)
    sp = torch.sort(probs, dim=-1, descending=True).values
    keep = (torch.cumsum(sp, dim=-1) - sp) < top_p.clamp_min(1e-6)[:, None]
    thresh = torch.where(keep, sp, torch.inf).min(dim=-1, keepdim=True).values
    x = torch.where(probs >= thresh, x, -torch.inf)
    sampled = keyed_draw(x, seeds, steps)
    return torch.where(temperature <= 0, greedy_tok, sampled).to(torch.int32)
