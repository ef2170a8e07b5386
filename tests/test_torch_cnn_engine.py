"""The port's CNN executor and its ``cbr_avgpool`` plain version against
the JAX reference, on the CPU.

Weights come from the reference's ``init_params`` and cross through
``repro_torch.convert.graph_params_from_numpy``; inputs are seeded numpy
arrays given to both.  Each zoo model, optimized for each engine mode by
its own package's pipeline, gives the reference's outputs at rtol 3e-4
(the reference's engine tolerance: fp32 conv reassociation).  The routed
``cbra`` op under ``KernelPlan(linked_matmul="cuda")`` on CPU tensors runs
the kernel's plain version and equals the reference's Pallas kernel (in
interpret mode) at 2e-5.  The CUDA kernel itself is held against the
plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import cnn_zoo as ref_zoo
from repro.core import build_engine as ref_build_engine
from repro.core import engine as ref_engine
from repro.core import execute as ref_execute
from repro.core import init_params as ref_init_params
from repro.core import optimize as ref_optimize
from repro.core import pipeline as ref_pipeline
from repro.core import graph as RG
from repro.kernels.linked_cbr_pool import ops as ref_cbra_ops
from repro.kernels.linked_cbr_pool import ref as ref_cbra
from repro_torch import kernels
from repro_torch.configs import cnn_zoo as port_zoo
from repro_torch.convert import graph_params_from_numpy
from repro_torch.core import build_engine, engine, execute, init_params
from repro_torch.core import graph as PG
from repro_torch.core import optimize as port_optimize
from repro_torch.core import pipeline as port_pipeline
from repro_torch.kernels.linked_cbr_pool import ops as cbra_ops

ZOO = sorted(ref_zoo.ZOO)
MODEL_TOL = dict(rtol=3e-4, atol=1e-5)
KERNEL_TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(g, seed=0):
    rng = np.random.default_rng(seed)
    return {k: rng.normal(size=g.tensors[k].shape).astype(np.float32)
            for k in g.inputs}


def _np(outs):
    return [np.asarray(o) if not isinstance(o, torch.Tensor) else o.numpy()
            for o in outs]


@pytest.mark.parametrize("mode", ["vanilla", "ho", "xenos"])
@pytest.mark.parametrize("name", ZOO)
def test_zoo_execute_matches_reference(name, mode):
    ref_g, port_g = ref_zoo.build(name), port_zoo.build(name)
    ref_p = ref_init_params(ref_g)
    port_p = graph_params_from_numpy(
        {k: np.asarray(v) for k, v in ref_p.items()}, port_g, device="cpu")
    x = _inputs(ref_g)
    ref_opt, _ = ref_pipeline.optimize_for_mode(ref_g, mode)
    port_opt, _ = port_pipeline.optimize_for_mode(port_g, mode)
    want = _np(ref_execute(ref_opt, ref_p, x, mode=mode))
    got = _np(execute(port_opt, port_p, x, mode=mode))
    assert len(got) == len(want)
    for g_, w_ in zip(got, want):
        assert g_.shape == w_.shape and np.isfinite(g_).all()
        np.testing.assert_allclose(g_, w_, **MODEL_TOL)


@pytest.mark.parametrize("name", ZOO)
def test_init_params_draws_the_references_weights(name):
    ref_p = ref_init_params(ref_zoo.build(name), seed=3)
    port_p = init_params(port_zoo.build(name), seed=3, device="cpu")
    assert list(port_p) == list(ref_p)
    for k in ref_p:
        assert port_p[k].dtype == torch.float32
        np.testing.assert_array_equal(port_p[k].numpy(), np.asarray(ref_p[k]))


def test_graph_params_from_numpy_checks_names_and_shapes():
    g = port_zoo.build("centrenet")
    p = {k: np.asarray(v) for k, v in ref_init_params(ref_zoo.build(
        "centrenet")).items()}
    name = g.params[0]
    with pytest.raises(KeyError, match=name):
        graph_params_from_numpy({k: v for k, v in p.items() if k != name},
                                g, device="cpu")
    bad = dict(p, **{name: p[name][..., :1]})
    with pytest.raises(ValueError, match="shape"):
        graph_params_from_numpy(bad, g, device="cpu")


@pytest.mark.parametrize("hw", [(8, 8), (9, 7), (16, 15), (5, 5)])
@pytest.mark.parametrize("k,stride,depthwise", [
    (3, 2, False), (3, 1, False), (1, 2, False), (5, 2, False),
    (3, 1, True), (3, 2, True)])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_conv_padding_and_depthwise_match_reference(hw, k, stride,
                                                    depthwise, padding):
    """XLA's SAME padding (asymmetric at stride 2: low = total // 2) and
    depthwise HWIO weights, against the reference's ``_conv``."""
    h, w = hw
    rng = np.random.default_rng(h * 100 + w + k)
    C = 6
    x = rng.normal(size=(2, h, w, C)).astype(np.float32)
    wt = rng.normal(size=(k, k, C, 1 if depthwise else 5)).astype(np.float32)
    want = np.asarray(ref_engine._conv(jnp.asarray(x), jnp.asarray(wt),
                                       stride, padding, depthwise))
    got = engine._conv(torch.from_numpy(x), torch.from_numpy(wt), stride,
                       padding, depthwise).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **MODEL_TOL)


@pytest.mark.parametrize("size,k,s,want", [
    (8, 3, 2, (0, 1)), (9, 3, 2, (1, 1)), (8, 3, 1, (1, 1)),
    (8, 1, 2, (0, 0)), (7, 5, 2, (2, 2)), (6, 5, 2, (1, 2))])
def test_same_padding_is_xlas(size, k, s, want):
    assert engine.same_padding(size, k, s) == want


@pytest.mark.parametrize("kind,ksize,hw", [
    ("avg", 2, (8, 8)), ("avg", 2, (7, 9)), ("max", 2, (7, 9)),
    ("max", 3, (9, 9)), ("global_avg", 2, (5, 6))])
def test_pool_floors_like_the_reference(kind, ksize, hw):
    rng = np.random.default_rng(ksize + hw[0])
    x = rng.normal(size=(2, *hw, 4)).astype(np.float32)
    want = np.asarray(ref_engine._pool(jnp.asarray(x), kind, ksize))
    got = engine._pool(torch.from_numpy(x), kind, ksize).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, **KERNEL_TOL)


def test_storage_copies_are_materialized():
    """vanilla/ho store NCHW as a real copy, not a permuted view."""
    x = torch.randn(1, 4, 5, 3)
    s = engine._to_storage(x)
    assert s.shape == (1, 3, 4, 5) and s.is_contiguous()
    assert s.data_ptr() != x.data_ptr()
    back = engine._from_storage(s)
    assert back.is_contiguous() and torch.equal(back, x)


def _cbra_net(G, Graph):
    """The reference's ``cbra_net`` (tests/test_kernels.py)."""
    g = Graph("cbra_net")
    x = g.add_input("x", (1, 8, 8, 16))
    y = G.conv2d(g, x, 32, 1)
    y = G.bn(g, y)
    y = G.relu(g, y)
    y = G.pool(g, y, "avg", 2)
    g.mark_output(y)
    return g


def test_cbra_net_cuda_plan_on_cpu_equals_reference_pallas(monkeypatch):
    ref_g = _cbra_net(RG, RG.Graph)
    port_g = _cbra_net(PG, PG.Graph)
    ref_opt, port_opt = ref_optimize(ref_g), port_optimize(port_g)
    assert [n.op_type for n in port_opt.nodes] == ["cbra"]
    ref_p = ref_init_params(ref_g)
    port_p = graph_params_from_numpy(
        {k: np.asarray(v) for k, v in ref_p.items()}, port_g, device="cpu")
    x = _inputs(ref_g, seed=7)
    pallas = ref_execute(ref_opt, ref_p, x, mode="xenos",
                         plan=ref_pipeline.KernelPlan(linked_matmul="pallas"))
    calls = []
    real = cbra_ops.cbr_avgpool

    def spy(*a):
        calls.append(a[0].shape)
        return real(*a)

    monkeypatch.setattr(cbra_ops, "cbr_avgpool", spy)
    kernels.reset_launches()
    got = execute(port_opt, port_p, x, mode="xenos",
                  plan=port_pipeline.KernelPlan(linked_matmul="cuda"))
    assert calls == [(1, 8, 8, 16)]
    assert kernels.LAUNCHES["cbr_avgpool"] == 0     # plain version on CPU
    np.testing.assert_allclose(got[0].numpy(), np.asarray(pallas[0]),
                               **KERNEL_TOL)
    seed_plan = execute(port_opt, port_p, x, mode="xenos")
    np.testing.assert_allclose(got[0].numpy(), seed_plan[0].numpy(),
                               **KERNEL_TOL)


def test_only_the_kernels_cbra_is_routed():
    """A stride-2 1x1 conv, a 3x3 conv or a max pool keep the torch path."""
    def linked(stride=1, k=1, kind="avg"):
        g = PG.Graph("t")
        x = g.add_input("x", (1, 8, 8, 4))
        y = PG.conv2d(g, x, 8, k, stride=stride)
        y = PG.bn(g, y)
        y = PG.relu(g, y)
        y = PG.pool(g, y, kind, 2)
        g.mark_output(y)
        node, = port_optimize(g).nodes
        return node
    assert engine.links_to_kernel(linked())
    assert not engine.links_to_kernel(linked(stride=2))
    assert not engine.links_to_kernel(linked(k=3))
    assert not engine.links_to_kernel(linked(kind="max"))


@pytest.mark.parametrize("N,H,W,C,OC", [
    (1, 8, 8, 16, 32), (2, 16, 16, 32, 64), (1, 4, 32, 8, 8),
    (2, 7, 9, 3, 10), (1, 5, 6, 24, 33), (3, 9, 11, 40, 7)])
def test_cbr_avgpool_plain_matches_reference(N, H, W, C, OC):
    """The plain version against ``ref.cbr_avgpool_ref`` (the sweep of
    tests/test_kernels.py plus odd H and W, which floor) and, on even
    maps, against the Pallas kernel in interpret mode."""
    rng = np.random.default_rng(N * 1000 + H * 10 + W)
    x = rng.normal(size=(N, H, W, C)).astype(np.float32)
    w = (rng.normal(size=(C, OC)) * 0.1).astype(np.float32)
    b = rng.normal(size=(OC,)).astype(np.float32)
    got = cbra_ops.cbr_avgpool(torch.from_numpy(x), torch.from_numpy(w),
                               torch.from_numpy(b)).numpy()
    want = np.asarray(ref_cbra.cbr_avgpool_ref(jnp.asarray(x), jnp.asarray(w),
                                               jnp.asarray(b)))
    assert got.shape == (N, H // 2, W // 2, OC) == want.shape
    np.testing.assert_allclose(got, want, **KERNEL_TOL)
    if H % 2 == 0 and W % 2 == 0:
        pallas = np.asarray(ref_cbra_ops.cbr_avgpool(
            jnp.asarray(x), jnp.asarray(w), jnp.asarray(b)))
        np.testing.assert_allclose(got, pallas, **KERNEL_TOL)
    conv_layout = cbra_ops.cbr_avgpool(torch.from_numpy(x),
                                       torch.from_numpy(w)[None, None],
                                       torch.from_numpy(b)).numpy()
    np.testing.assert_array_equal(conv_layout, got)


def test_engine_modes_agree_on_a_cbra_graph():
    g = PG.Graph("modes")
    x = g.add_input("x", (2, 10, 12, 8))
    y = PG.conv2d(g, x, 16, 1)
    y = PG.bn(g, y)
    y = PG.bias(g, y)
    y = PG.relu(g, y)
    y = PG.pool(g, y, "avg", 2)
    g.mark_output(y)
    p = init_params(g, seed=1, device="cpu")
    xin = torch.from_numpy(_inputs(g, seed=2)["x"])
    plan, _ = port_pipeline.select_kernel_plan({"accelerator": "cuda"})
    outs = {}
    for mode in ("vanilla", "ho", "xenos"):
        eng, rep = build_engine(g, mode, plan=plan)
        outs[mode] = eng(p, xin)[0]
        assert eng.plan.linked_matmul == "cuda"
    assert rep.passes[-1].name == "dos_split"
    for mode in ("ho", "xenos"):
        np.testing.assert_allclose(outs[mode].numpy(),
                                   outs["vanilla"].numpy(), **MODEL_TOL)


def test_reference_engine_and_port_agree_on_a_figure5_chain():
    """Conv1x1 -> Bn -> Bias -> Relu -> AvgPool through both packages'
    build_engine in xenos mode (the cbra op, seed plan)."""
    from examples.optimize_graph import build_fig5_graph
    from repro_torch.launch.optimize_graph import fig5_graph
    rg, pg = build_fig5_graph(), fig5_graph()
    rp = ref_init_params(rg)
    pp = graph_params_from_numpy({k: np.asarray(v) for k, v in rp.items()},
                                 pg, device="cpu")
    x = _inputs(rg, seed=5)["fm"]
    reng, _ = ref_build_engine(rg, "xenos")
    peng, _ = build_engine(pg, "xenos")
    np.testing.assert_allclose(peng(pp, torch.from_numpy(x))[0].numpy(),
                               np.asarray(reng(rp, jnp.asarray(x))[0]),
                               **KERNEL_TOL)


def test_optimize_graph_launch_runs_on_the_host(capsys):
    from repro_torch.launch import optimize_graph
    assert optimize_graph.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert out.rstrip().endswith("optimize_graph OK")
    assert "linked_matmul=cuda" in out and "PassReport[fig5" in out
