"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips on a host without an NVIDIA
card: a CUDA kernel has no CPU mode.  The file imports no JAX, so it runs
on a card machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import ops as t_da
from repro_torch.kernels.fused_sampler import ops as t_fs


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


#: element-wise |kernel - plain| <= atol + rtol * |plain|, by input type
TOL = {"float32": dict(rtol=3e-5, atol=3e-5),
       "bfloat16": dict(rtol=2e-2, atol=1e-3)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,G", [(32, 3), (64, 4), (128, 2), (128, 8)])
def test_decode_kernels_match_plain(card, dtype, D, G):
    """Dense (ragged W, a row with no valid slot) and paged (-1 table
    entries, a length-0 row) flash-decode vs the plain masked softmax,
    element by element."""
    dt = getattr(torch, dtype)
    B, K, W = 3, 2, 300
    H = K * G
    rnd = lambda *s: torch.randn(s, generator=card, device="cuda").to(dt)
    q, k, v = rnd(B, H, D), rnd(B, W, K, D), rnd(B, W, K, D)
    valid = torch.rand((B, W), generator=card, device="cuda") < 0.5
    valid[1] = False
    want = t_da.gqa_decode_plain(q, k, v, valid).float()
    got = t_da.gqa_decode(q, k, v, valid).float()
    torch.testing.assert_close(got, want, **TOL[dtype])
    bs, M = 16, 5
    kp, vp = rnd(B * M, bs, K, D), rnd(B * M, bs, K, D)
    bt = torch.arange(B * M, dtype=torch.int32, device="cuda").reshape(B, M)
    bt[2, 3:] = -1
    ln = torch.tensor([80, 0, 40], dtype=torch.int32, device="cuda")
    want = t_da.gqa_decode_paged_plain(q, kp, vp, bt, ln).float()
    got = t_da.gqa_decode_paged(q, kp, vp, bt, ln).float()
    torch.testing.assert_close(got, want, **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("V", [17, 1000, 151936])
def test_fused_mask_kernel_matches_plain(card, V):
    """Equal survivor values and equal -inf support, on heterogeneous
    policies (T = 0, k <= 0, k >= V, p = 1) and on tied logits, except on
    the tokens ``nucleus_boundary`` marks: the kernel decides the nucleus
    in fp64 and keeps every top-k survivor at p >= 1, the plain version
    (the reference's search) in fp32."""
    rng = np.random.default_rng(V)
    B = 8
    temps = torch.tensor([0.0, 0.8, 1.3, 0.5, 0.0, 1.0, 0.8, 2.0],
                         device="cuda")
    ks = torch.tensor([0, 50, V, 1, -3, 5, V // 2, 0], dtype=torch.int32,
                      device="cuda")
    ps = torch.tensor([1.0, 0.95, 0.5, 1.0, 0.3, 0.7, 1.0, 0.9],
                      device="cuda")
    logits = torch.from_numpy(rng.normal(size=(B, V)).astype(np.float32) * 3)
    for rows in (logits, torch.round(logits * 2) / 2):
        rows = rows.cuda()
        got = t_fs.fused_mask(rows, temps, ks, ps)
        want = t_fs.fused_mask_plain(rows, temps, ks, ps)
        free = t_fs.nucleus_boundary(rows, temps, ks, ps)
        differ = torch.isinf(got) != torch.isinf(want)
        assert not (differ & ~free).any()
        both = ~torch.isinf(got) & ~torch.isinf(want)
        assert torch.equal(got[both], want[both])
