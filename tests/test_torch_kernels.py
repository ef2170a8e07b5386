"""The port's kernel modules against the JAX reference kernels.

On this host the wrappers run their plain PyTorch versions (CPU tensors);
the same numpy inputs go through the reference's Pallas kernels in
interpret mode and through its ``ref.py`` oracles.  The CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py`` and by ``tests/test_torch_cuda.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as da_ops, ref as da_ref
from repro.kernels.fused_sampler.fused_sampler import fused_mask as jax_mask
from repro.kernels.fused_sampler.ref import masked_logits_ref
from repro_torch.kernels.decode_attention import ops as t_da
from repro_torch.kernels.fused_sampler import ops as t_fs

import jax

TOL = dict(rtol=3e-5, atol=3e-5)


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("B,H,K,D,W,bw", [
    (1, 4, 1, 64, 256, 128), (2, 8, 2, 64, 1024, 256),
    (2, 8, 8, 128, 512, 512), (1, 16, 4, 32, 2048, 1024)])
def test_gqa_decode_plain_matches_reference(B, H, K, D, W, bw):
    rng = np.random.default_rng(B * 1000 + W)
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    kc = rng.normal(size=(B, W, K, D)).astype(np.float32)
    vc = rng.normal(size=(B, W, K, D)).astype(np.float32)
    valid = rng.random((B, W)) < 0.7
    valid[:, 0] = True
    got = t_da.gqa_decode(_t(q), _t(kc), _t(vc), _t(valid)).numpy()
    pallas = da_ops.gqa_decode(jnp.asarray(q), jnp.asarray(kc),
                               jnp.asarray(vc), jnp.asarray(valid),
                               block_w=bw)
    ref = da_ref.gqa_decode_ref(jnp.asarray(q), jnp.asarray(kc),
                                jnp.asarray(vc), jnp.asarray(valid))
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(got, np.asarray(ref), **TOL)


def test_gqa_decode_row_without_valid_slot_is_mean_of_v():
    """Bystander rows rely on this: no valid slot -> mean of V, not NaN."""
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, 4, 32)).astype(np.float32)
    kc = rng.normal(size=(2, 48, 2, 32)).astype(np.float32)
    vc = rng.normal(size=(2, 48, 2, 32)).astype(np.float32)
    valid = np.zeros((2, 48), bool)
    valid[1, :5] = True
    got = t_da.gqa_decode(_t(q), _t(kc), _t(vc), _t(valid)).numpy()
    ref = np.asarray(da_ref.gqa_decode_ref(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc), jnp.asarray(valid)))
    mean_v = vc[0].mean(axis=0)                       # (K, D)
    np.testing.assert_allclose(got[0].reshape(2, 2, 32),
                               np.repeat(mean_v[:, None], 2, 1), **TOL)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("B,H,K,D,bs,M", [
    (1, 4, 1, 64, 16, 4), (2, 8, 2, 64, 8, 8),
    (2, 8, 8, 128, 32, 2), (3, 16, 4, 32, 8, 4)])
def test_gqa_decode_paged_plain_matches_reference(B, H, K, D, bs, M):
    rng = np.random.default_rng(B * 100 + bs)
    P = B * M + 3
    q = rng.normal(size=(B, H, D)).astype(np.float32)
    kp = rng.normal(size=(P, bs, K, D)).astype(np.float32)
    vp = rng.normal(size=(P, bs, K, D)).astype(np.float32)
    perm = rng.permutation(P)
    bt = np.full((B, M), -1, np.int32)
    lengths = rng.integers(0, M * bs + 1, (B,)).astype(np.int32)
    lengths[0] = max(lengths[0], 1)
    idx = 0
    for b in range(B):
        for m in range(-(-int(lengths[b]) // bs)):
            bt[b, m] = perm[idx]
            idx += 1
    got = t_da.gqa_decode_paged(_t(q), _t(kp), _t(vp), _t(bt),
                                _t(lengths)).numpy()
    args = [jnp.asarray(a) for a in (q, kp, vp, bt, lengths)]
    np.testing.assert_allclose(got, np.asarray(da_ops.gqa_decode_paged(*args)),
                               **TOL)
    np.testing.assert_allclose(
        got, np.asarray(da_ref.gqa_decode_paged_ref(*args)), **TOL)


def _policy_batch(rng, B, V):
    """The heterogeneous policy batches of tests/test_fused_sampler.py."""
    logits = (rng.normal(size=(B, V)) * 3.0).astype(np.float32)
    temps = rng.uniform(0.3, 1.5, (B,)).astype(np.float32)
    temps[:: max(B // 3, 1)] = 0.0
    ks = rng.choice([0, 1, 5, V // 2, V], (B,)).astype(np.int32)
    ps = rng.choice([1.0, 0.95, 0.7, 0.3], (B,)).astype(np.float32)
    return logits, temps, ks, ps


def _assert_support_matches(got, want, policy):
    """Equal survivor values, and equal -inf support except on the tokens
    ``nucleus_boundary`` marks: where the mass strictly above a token
    equals p to within summation rounding (1e-5), two summation orders
    may decide it either way."""
    free = t_fs.nucleus_boundary(*(_t(a) for a in policy)).numpy()
    both = np.isfinite(got) & np.isfinite(want)
    np.testing.assert_array_equal(got[both], want[both])
    differ = np.isinf(got) != np.isinf(want)
    assert not (differ & ~free).any(), np.argwhere(differ & ~free)[:8]


@pytest.mark.parametrize("vocab,tied", [(17, False), (96, False),
                                        (128, False), (512, False),
                                        (96, True)])
def test_fused_mask_plain_matches_reference(vocab, tied):
    """Plain ``fused_mask`` vs the Pallas kernel (interpret) and the
    two-sort oracle, on the policy batches of test_fused_sampler.py: the
    same support and survivor values up to the nucleus boundary rounding
    (see ``_assert_support_matches``), p = 1 rows included.  On tied
    logits the reference's own kernel and oracle disagree at the nucleus
    boundary (the oracle keeps a tie group the kernel cuts); the port
    follows the kernel there (ROADMAP queue 3)."""
    rng = np.random.default_rng(vocab + 7 * tied)
    for trial in range(4):
        logits, temps, ks, ps = _policy_batch(rng, 8, vocab)
        if tied:
            logits = np.round(logits * 2 / 3) / 2
        got = t_fs.fused_mask(_t(logits), _t(temps), _t(ks), _t(ps)).numpy()
        pallas = np.asarray(jax_mask(jnp.asarray(logits), jnp.asarray(temps),
                                     jnp.asarray(ks), jnp.asarray(ps),
                                     interpret=True))
        ref = np.asarray(jax.vmap(masked_logits_ref)(
            jnp.asarray(logits), jnp.asarray(temps), jnp.asarray(ks),
            jnp.asarray(ps)))
        policy = (logits, temps, ks, ps)
        _assert_support_matches(got, pallas, policy)
        if not tied:
            _assert_support_matches(got, ref, policy)


def test_nucleus_boundary_marks_only_rounding_ties():
    """The tokens the kernel may decide unlike the reference: at p = 1 the
    tail whose mass an fp32 sum loses, at p < 1 only a token whose
    strictly-greater mass sits on p; never a token past the k-th."""
    x = np.array([[4.0, 3.0, 2.0, 1.0, -30.0, -31.0],
                  [np.log(0.5), np.log(0.3), np.log(0.2), -50.0, -50.0,
                   -60.0],
                  [4.0, 3.0, 2.0, 1.0, -30.0, -31.0]], np.float32)
    temps = np.ones(3, np.float32)
    ks = np.array([0, 0, 4], np.int32)
    ps = np.array([1.0, 0.8, 1.0], np.float32)
    got = t_fs.nucleus_boundary(_t(x), _t(temps), _t(ks), _t(ps)).numpy()
    np.testing.assert_array_equal(got[0], [0, 0, 0, 0, 1, 1])
    # mass above token 2 is 0.8 = p: on the boundary; the -50 tie group
    # has 1.0 above it, far from p
    np.testing.assert_array_equal(got[1], [0, 0, 1, 0, 0, 0])
    np.testing.assert_array_equal(got[2], [0, 0, 0, 0, 0, 0])


def test_fused_mask_rules():
    """T <= 0 scales by 1; k <= 0 keeps all; k clipped to V; p floored."""
    rng = np.random.default_rng(11)
    V = 64
    logits = rng.normal(size=(4, V)).astype(np.float32)
    temps = np.array([0.0, -1.0, 0.5, 1.0], np.float32)
    ks = np.array([0, -2, 3 * V, 1], np.int32)
    ps = np.array([1.0, 1.0, 1.0, 1e-9], np.float32)
    got = t_fs.fused_mask(_t(logits), _t(temps), _t(ks), _t(ps)).numpy()
    np.testing.assert_array_equal(got[0], logits[0])
    np.testing.assert_array_equal(got[1], logits[1])
    np.testing.assert_array_equal(got[2], logits[2] / np.float32(0.5))
    assert np.isfinite(got[3]).sum() == 1
    assert np.argmax(got[3]) == np.argmax(logits[3])
