"""The port's keyed draw and samplers against the JAX reference.

Bits first: the threefry2x32 hash, ``fold_in`` and the partitionable
``random_bits`` layout must give ``jax.random.bits`` bit for bit before
any sampled stream is compared.  Then, on identical logits, the port's
``sample_tokens`` and ``fused_sample`` must return the reference's tokens.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fused_sampler.ops import fused_sample as jax_fused
from repro.serving.sampling import sample_tokens as jax_sample
from repro_torch.kernels.fused_sampler import ops as t_fs
from repro_torch.serving import sampling as t_s

SEEDS = [0, 1, 7, 4242, 2**31 - 1, 2**32 - 1]
STEPS = [0, 1, 5, 63, 1000, 2**31 - 1]


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_bits_match_jax(seed):
    """``bits(fold_in(key(seed), step))`` bit for bit, every step."""
    keys = t_s.fold_in(t_s.prng_key(torch.full((len(STEPS),), seed)),
                       torch.tensor(STEPS))
    got = t_s.random_bits(keys, 97).numpy().astype(np.uint32)
    for i, step in enumerate(STEPS):
        want = np.asarray(jax.random.bits(
            jax.random.fold_in(jax.random.key(seed), step), (97,)))
        np.testing.assert_array_equal(got[i], want)


def test_gumbel_matches_jax_to_an_ulp():
    """The uniform is built from the same bits; ``log`` implementations
    may round differently, so the noise agrees to a couple of ulps."""
    keys = t_s.fold_in(t_s.prng_key(torch.tensor(SEEDS)),
                       torch.tensor(STEPS))
    got = t_s.gumbel(keys, 257).numpy()
    for i, (seed, step) in enumerate(zip(SEEDS, STEPS)):
        want = np.asarray(jax.random.gumbel(
            jax.random.fold_in(jax.random.key(seed), step), (257,)))
        np.testing.assert_allclose(got[i], want, rtol=1e-6, atol=1e-6)


def _batch(rng, B, V):
    logits = (rng.normal(size=(B, V)) * 3.0).astype(np.float32)
    seeds = rng.integers(0, 2**31, (B,)).astype(np.uint32)
    steps = rng.integers(0, 50, (B,)).astype(np.int32)
    temps = rng.uniform(0.3, 1.5, (B,)).astype(np.float32)
    temps[:: max(B // 3, 1)] = 0.0
    ks = rng.choice([0, 1, 5, V // 2, V], (B,)).astype(np.int32)
    ps = rng.choice([1.0, 0.95, 0.7, 0.3], (B,)).astype(np.float32)
    return logits, seeds, steps, temps, ks, ps


def _torch_args(args):
    logits, seeds, steps, temps, ks, ps = args
    return (torch.from_numpy(logits), torch.from_numpy(seeds.astype(np.int64)),
            torch.from_numpy(steps), torch.from_numpy(temps),
            torch.from_numpy(ks), torch.from_numpy(ps))


@pytest.mark.parametrize("vocab", [17, 96, 128, 512])
def test_sample_tokens_match_reference(vocab):
    """Greedy and sampled rows: the reference sampler's tokens."""
    rng = np.random.default_rng(vocab)
    for _ in range(4):
        args = _batch(rng, 8, vocab)
        want = np.asarray(jax_sample(*map(jnp.asarray, args), vocab=vocab))
        got = t_s.sample_tokens(*_torch_args(args), vocab=vocab).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("vocab", [17, 96, 128, 512])
@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_fused_sample_matches_reference(vocab, backend):
    """The port's fused sampler — one-sort torch filter, or the
    ``fused_mask`` wrapper (its plain version on this host) — returns the
    reference fused sampler's tokens."""
    rng = np.random.default_rng(vocab + 1)
    for _ in range(4):
        args = _batch(rng, 8, vocab)
        want = np.asarray(jax_fused(*map(jnp.asarray, args), vocab=vocab,
                                    backend="jnp"))
        got = t_fs.fused_sample(*_torch_args(args), vocab=vocab,
                                backend=backend).numpy()
        np.testing.assert_array_equal(got, want)


def test_padded_logits_never_sampled():
    rng = np.random.default_rng(3)
    logits, *rest = _batch(rng, 8, 96)
    padded = np.concatenate([logits, np.full((8, 32), 1e9, np.float32)], -1)
    got = t_fs.fused_sample(*_torch_args((padded, *rest)), vocab=96).numpy()
    want = np.asarray(jax_fused(*map(jnp.asarray, (padded, *rest)), vocab=96,
                                backend="jnp"))
    np.testing.assert_array_equal(got, want)
    assert got.max() < 96


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_grid_variant_matches_reference_grid(backend):
    from repro.serving.sampling import sample_token_grid as jax_grid
    rng = np.random.default_rng(5)
    B, K1, V = 4, 5, 96
    logits = (rng.normal(size=(B, K1, V)) * 3.0).astype(np.float32)
    seeds = rng.integers(0, 2**31, (B,)).astype(np.uint32)
    steps = rng.integers(0, 20, (B,)).astype(np.int32)
    temps = rng.uniform(0.3, 1.5, (B,)).astype(np.float32)
    ks = rng.choice([0, 5, 40], (B,)).astype(np.int32)
    ps = rng.choice([1.0, 0.9], (B,)).astype(np.float32)
    args = (logits, seeds, steps, temps, ks, ps)
    want = np.asarray(jax_grid(*map(jnp.asarray, args), vocab=V))
    got = t_fs.fused_sample_grid(*_torch_args(args), vocab=V,
                                 backend=backend).numpy()
    np.testing.assert_array_equal(got, want)
