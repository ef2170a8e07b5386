"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips on a host without an NVIDIA
card: a CUDA kernel has no CPU mode.  The file imports no JAX, so it runs
on a card machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.decode_attention import ops as t_da
from repro_torch.kernels.fused_sampler import ops as t_fs
from repro_torch.kernels.linked_cbr_pool import ops as t_cb


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


#: cbr_avgpool: |kernel - plain| <= 2e-5 + 2e-5 |plain|, IEEE fp32 both
CBRA_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,W,C,OC", [
    (1, 16, 16, 64, 128), (1, 8, 8, 1024, 1024), (1, 224, 224, 24, 224),
    (2, 7, 9, 3, 10), (3, 33, 31, 40, 70), (1, 2, 2, 1, 1),
    (2, 64, 64, 48, 33), (2, 64, 64, 48, 96), (1, 100, 98, 24, 45),
    (1, 4, 4, 256, 64), (1, 6, 6, 100, 40)])
def test_cbr_avgpool_kernel_matches_plain(card, N, H, W, C, OC):
    """The Figure-5 and Table-4 shapes, odd H and W (floored), C and OC
    off the 32-tiles (scalar and float4 stores), N > 1, and every launch
    shape: wide tiles, and narrow tiles with C split over clusters of 1,
    2, 4 and 8 blocks."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.randn((N, H, W, C), generator=card, device="cuda")
    w = torch.randn((C, OC), generator=card, device="cuda") / C ** 0.5
    b = torch.randn((OC,), generator=card, device="cuda") * 0.1
    kernels.reset_launches()
    got = t_cb.cbr_avgpool(x, w, b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["cbr_avgpool"] == 1
    assert got.shape == (N, H // 2, W // 2, OC)
    torch.testing.assert_close(got, t_cb.cbr_avgpool_plain(x, w, b),
                               **CBRA_TOL)
    conv_layout = t_cb.cbr_avgpool(x, w[None, None], b)
    assert torch.equal(conv_layout, got)


@pytest.mark.cuda
def test_cbr_avgpool_rejects_what_it_does_not_take(card):
    x = torch.randn((1, 4, 4, 8), generator=card, device="cuda")
    w = torch.randn((8, 16), generator=card, device="cuda")
    b = torch.zeros((16,), device="cuda")
    with pytest.raises(ValueError, match="float32"):
        t_cb.cbr_avgpool(x.half(), w, b)
    with pytest.raises(ValueError, match="contiguous"):
        t_cb.cbr_avgpool(x.transpose(1, 2), w, b)
    with pytest.raises(ValueError, match="one CUDA device"):
        t_cb.cbr_avgpool(x, w.cpu(), b)
    with pytest.raises(ValueError, match="1x1"):
        t_cb.cbr_avgpool(x, torch.zeros((3, 3, 8, 16), device="cuda"), b)


@pytest.mark.cuda
def test_cnn_engine_routes_cbra_and_graphs_xenos(card):
    """The routed xenos engine launches the kernel, equals the torch-plan
    engine to 2e-5, its CUDA-graph replays equal the eager run, and the
    three modes agree at the engine tolerance."""
    import numpy as np

    from repro_torch.core import build_engine, init_params, pipeline
    from repro_torch.launch.optimize_graph import cbra_graph
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = cbra_graph("t", (2, 24, 20, 40), 72)
    params = init_params(g, seed=0)
    x = torch.randn((2, 24, 20, 40), generator=card, device="cuda")
    plan, _ = pipeline.select_kernel_plan({"accelerator": "cuda"})
    out = {}
    for name, mode, p, graphed in (("vanilla", "vanilla", None, True),
                                   ("ho", "ho", None, True),
                                   ("torch", "xenos", None, False),
                                   ("eager", "xenos", plan, False),
                                   ("graphed", "xenos", plan, True)):
        eng, _ = build_engine(g, mode, plan=p, graphed=graphed)
        kernels.reset_launches()
        out[name] = [eng(params, x)[0].clone() for _ in range(3)]
        if p is None:
            assert kernels.LAUNCHES["cbr_avgpool"] == 0, name
        else:
            assert kernels.LAUNCHES["cbr_avgpool"] >= 3, name
    for a in out["graphed"]:
        assert torch.equal(a, out["eager"][0])
    torch.testing.assert_close(out["eager"][0], out["torch"][0], **CBRA_TOL)
    for mode in ("ho", "graphed"):
        np.testing.assert_allclose(out[mode][0].cpu().numpy(),
                                   out["vanilla"][0].cpu().numpy(),
                                   rtol=3e-4, atol=1e-6)


def _two_cbra_graph():
    """Two Conv1x1 -> Bn -> Relu -> AvgPool2 branches on one input, each
    an output: each links into a cbra, so the routed xenos engine
    launches cbr_avgpool twice per call."""
    from repro_torch.core import graph as G
    g = G.Graph("two_cbra")
    x = g.add_input("x", (2, 16, 12, 24))
    for out_c in (40, 24):
        g.mark_output(G.pool(g, G.relu(g, G.bn(g, G.conv2d(g, x, out_c, 1))),
                             "avg", 2))
    return g


@pytest.mark.cuda
def test_cnn_engine_graph_counts_what_eager_launches(card):
    """A capture launches nothing and counts in RECORDED; each replay
    adds exactly the launches one eager call makes."""
    from repro_torch.core import build_engine, init_params, pipeline
    g = _two_cbra_graph()
    params = init_params(g, seed=0)
    x = torch.randn((2, 16, 12, 24), generator=card, device="cuda")
    plan, _ = pipeline.select_kernel_plan({"accelerator": "cuda"})
    eager, _ = build_engine(g, "xenos", plan=plan, graphed=False)
    graphed, _ = build_engine(g, "xenos", plan=plan)
    kernels.reset_launches()
    eager(params, x)
    per_call = kernels.LAUNCHES["cbr_avgpool"]
    assert per_call == 2
    graphed(params, x)                 # warm-up + capture + one replay
    recorded = graphed._cuda_graph["launches"]["cbr_avgpool"]
    assert recorded == per_call
    kernels.reset_launches()
    for _ in range(3):
        graphed(params, x)
    assert kernels.LAUNCHES["cbr_avgpool"] == 3 * per_call


@pytest.mark.cuda
def test_cnn_engine_graph_sees_swapped_weights(card):
    """A weight replaced in the same params dict is read by the next
    call (the graph captures again); one written in place is read by the
    next replay."""
    from repro_torch.core import build_engine, init_params, pipeline
    torch.backends.cudnn.allow_tf32 = False
    g = _two_cbra_graph()
    params = init_params(g, seed=0)
    x = torch.randn((2, 16, 12, 24), generator=card, device="cuda")
    plan, _ = pipeline.select_kernel_plan({"accelerator": "cuda"})
    eager, _ = build_engine(g, "xenos", plan=plan, graphed=False)
    graphed, _ = build_engine(g, "xenos", plan=plan)
    before = graphed(params, x)[0].clone()
    name = next(n for n in params if n.endswith(".w"))   # branch 0's conv
    params[name] = torch.randn(params[name].shape, generator=card,
                               device="cuda")
    swapped = graphed(params, x)[0].clone()
    assert not torch.equal(swapped, before)
    assert torch.equal(swapped, eager(params, x)[0])
    params[name].mul_(0.5)
    halved = graphed(params, x)[0].clone()
    assert not torch.equal(halved, swapped)
    assert torch.equal(halved, eager(params, x)[0])
