"""The port's ``linked_mlp`` and ``split_matmul`` plain versions and the
paths that route to them, against the JAX reference, on the CPU.

Inputs come from seeded numpy generators and go to both packages.  The
plain versions are held to the reference's Pallas kernels in interpret
mode at ``tests/test_kernels.py``'s sweep shapes and tolerances (fp32
2e-5, bf16 2e-2); ragged shapes, which the reference's wrappers send to
``ref.py``, are held to ``ref.py``.  On CPU tensors a ``cuda`` site runs
its kernel's plain version, so the routed paths are checked here end to
end: the served decoder under ``KernelPlan(linked_matmul="cuda")``
against the reference's prefill and decode logits (rtol 3e-4), and
``bert_s(d=768)`` under the DSP spec, whose FFN matmuls the planner splits
three ways, under ``KernelPlan(split_matmul="cuda")`` against the
reference's ``execute`` (rtol 3e-4, atol 3e-5).  The CUDA kernels
themselves are held to the plain versions on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import cnn_zoo as ref_zoo
from repro.core import execute as ref_execute
from repro.core import init_params as ref_init_params
from repro.core import pipeline as ref_pipeline
from repro.core.dos import DeviceSpec as RefDeviceSpec
from repro.kernels.linked_matmul import linked_matmul as ref_lm
from repro.kernels.linked_matmul import ref as ref_lm_ref
from repro.kernels.split_matmul import split_matmul as ref_sm
from repro_torch import kernels
from repro_torch.configs import cnn_zoo as port_zoo
from repro_torch.convert import graph_params_from_numpy
from repro_torch.core import engine, execute
from repro_torch.core import pipeline as port_pipeline
from repro_torch.core.dos import DeviceSpec, SplitPlan
from repro_torch.core.pipeline import KernelPlan
from repro_torch.kernels.linked_matmul import ops as lm_ops
from repro_torch.kernels.split_matmul import ops as sm_ops
from repro_torch.models.model import Model

from test_torch_model import RTOL, _pair, _run_ref, _run_port, _script

#: tests/test_kernels.py's kernel tolerances
TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
       "bfloat16": dict(rtol=2e-2, atol=2e-2)}
#: the reference's engine tolerance (fp32 reassociation across modes)
ENGINE_TOL = dict(rtol=3e-4, atol=3e-5)


def _mlp_inputs(M, d, ff, seed, scale=0.05):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(M, d)).astype(np.float32),
            (rng.normal(size=(d, ff)) * scale).astype(np.float32),
            (rng.normal(size=(d, ff)) * scale).astype(np.float32),
            (rng.normal(size=(ff, d)) * scale).astype(np.float32))


def _pair_dtype(arrays, dtype):
    """The same numpy arrays as jax and torch tensors of ``dtype``."""
    return ([jnp.asarray(a, getattr(jnp, dtype)) for a in arrays],
            [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays])


def _f32(t):
    return np.asarray(t.float() if isinstance(t, torch.Tensor) else
                      jnp.asarray(t, jnp.float32))


@pytest.mark.parametrize("M,d,ff", [(128, 128, 256), (256, 64, 512),
                                    (512, 256, 1024), (64, 32, 128)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linked_mlp_plain_matches_pallas(M, d, ff, dtype):
    """The plain version against the Pallas kernel (interpret mode) at
    the reference's sweep; the wrapper on CPU tensors is the plain
    version and launches nothing."""
    j, t = _pair_dtype(_mlp_inputs(M, d, ff, seed=M + d + ff), dtype)
    want = ref_lm.linked_mlp(*j, block_m=64, block_ff=128, interpret=True)
    kernels.reset_launches()
    got = lm_ops.linked_mlp(*t)
    assert got.dtype == t[0].dtype and got.shape == (M, d)
    assert kernels.LAUNCHES["linked_mlp"] == 0
    assert torch.equal(got, lm_ops.linked_mlp_plain(*t))
    np.testing.assert_allclose(_f32(got), _f32(want), **TOL[dtype])


@pytest.mark.parametrize("M,d,ff", [(37, 50, 130), (1, 64, 96), (8, 33, 7),
                                    (3, 2, 1)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_linked_mlp_plain_ragged_matches_ref(M, d, ff, dtype):
    """Shapes no block divides, where the reference's wrapper falls back
    to ``ref.py`` (the port's kernel masks them instead); a leading batch
    dim flattens."""
    j, t = _pair_dtype(_mlp_inputs(M, d, ff, seed=7 * M + d), dtype)
    want = ref_lm_ref.linked_mlp_ref(*j)
    got = lm_ops.linked_mlp(t[0][None], *t[1:])
    assert got.shape == (1, M, d)
    np.testing.assert_allclose(_f32(got[0]), _f32(want), **TOL[dtype])


def test_linked_mlp_plain_rounds_h_before_the_down_projection():
    """h is rounded to bf16 before the down matmul (the Pallas body's
    ``h.astype(x.dtype)``), and the down matmul sums in fp32."""
    _, t = _pair_dtype(_mlp_inputs(16, 32, 64, seed=3), "bfloat16")
    x, wg, wu, wd = (a.float() for a in t)
    h = torch.nn.functional.silu(x @ wg) * (x @ wu)
    want = (h.to(torch.bfloat16).float() @ wd).to(torch.bfloat16)
    assert torch.equal(lm_ops.linked_mlp_plain(*t), want)


#: (M, K, N, block_n, block_k): the reference's sweep, a reduced bert_s
#: FFN tile (block_n = N / 3, as the DSP plan splits it) and an inC split
SPLIT_SHAPES = [(128, 256, 512, 128, 128), (64, 64, 64, 64, 64),
                (256, 1024, 256, 256, 256), (32, 96, 384, 128, 96),
                (32, 384, 96, 32, 384), (32, 384, 96, 96, 128)]


@pytest.mark.parametrize("M,K,N,bn,bk", SPLIT_SHAPES)
def test_split_matmul_plain_matches_pallas(M, K, N, bn, bk):
    rng = np.random.default_rng(M * K + N)
    arrays = (rng.normal(size=(M, K)).astype(np.float32),
              (rng.normal(size=(K, N)) * 0.05).astype(np.float32),
              rng.normal(size=(N,)).astype(np.float32))
    want = ref_sm.split_matmul(*map(jnp.asarray, arrays), block_m=M,
                               block_n=bn, block_k=bk, interpret=True)
    kernels.reset_launches()
    got = sm_ops.split_matmul(*map(torch.from_numpy, arrays), block_n=bn,
                              block_k=bk)
    assert kernels.LAUNCHES["split_matmul"] == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL["float32"])


def test_split_matmul_plain_ragged_tiles_sum_in_order():
    """Tiles that do not divide N or K: each N tile is its K tiles summed
    in order, the bias added to the first."""
    rng = np.random.default_rng(11)
    x = torch.from_numpy(rng.normal(size=(5, 23)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(23, 10)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(10,)).astype(np.float32))
    got = sm_ops.split_matmul(x, w, b, block_n=4, block_k=9)
    for n0 in range(0, 10, 4):
        acc = x[:, :9] @ w[:9, n0:n0 + 4] + b[n0:n0 + 4]
        acc = acc + x[:, 9:18] @ w[9:18, n0:n0 + 4]
        acc = acc + x[:, 18:] @ w[18:, n0:n0 + 4]
        assert torch.equal(got[:, n0:n0 + 4], acc)
    np.testing.assert_allclose(got.numpy(), (x @ w + b).numpy(),
                               **TOL["float32"])
    with pytest.raises(ValueError, match="positive"):
        sm_ops.split_matmul(x, w, b, block_n=0, block_k=9)


def _spy_linked(monkeypatch):
    calls = []
    real = lm_ops.linked_mlp

    def spy(x, *w):
        calls.append(tuple(x.shape))
        return real(x, *w)

    monkeypatch.setattr(lm_ops, "linked_mlp", spy)
    return calls


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_linked_plan_model_matches_reference(kv, monkeypatch):
    """Reduced qwen3-1.7b with its SwiGLU MLP routed to ``linked_mlp``:
    every chunk and decode step's logits match the reference's, and every
    layer of every step went through the wrapper."""
    jm, jp, tm, tp = _pair("qwen3-reduced")
    routed = Model(tm.cfg, kernel_plan=KernelPlan(linked_matmul="cuda"),
                   device="cpu")
    calls = _spy_linked(monkeypatch)
    ref = _run_ref(jm, jp, kv)
    got = _run_port(routed, tp, kv)
    script = _script(jm.cfg.vocab)
    assert len(calls) == len(script) * tm.cfg.n_layers
    for i, (step, r, g) in enumerate(zip(script, ref, got)):
        np.testing.assert_allclose(g[step[4]], r[step[4]], **RTOL,
                                   err_msg=f"{kv} step {i} {step[0]}")


def test_linked_plan_prefill_step_forward_and_override(monkeypatch):
    """The one-shot prefill and the forward under the routed plan match
    the reference; ``plan=`` on ``prefill_chunk`` and ``prefill_step``
    routes a default-plan model the same way, call by call."""
    jm, jp, tm, tp = _pair("qwen3-reduced")
    routed = Model(tm.cfg, kernel_plan=KernelPlan(linked_matmul="cuda"),
                   device="cpu")
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jm.cfg.vocab, (3, 12)).astype(np.int32)
    lens = np.asarray([7, 12, 5], np.int32)
    lj, _ = jm.prefill_step(jp, {"tokens": jnp.asarray(toks),
                                 "lengths": jnp.asarray(lens)}, max_len=32)
    fj, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    calls = _spy_linked(monkeypatch)
    batch = {"tokens": torch.from_numpy(toks),
             "lengths": torch.from_numpy(lens)}
    lt, _ = routed.prefill_step(tp, batch, max_len=32)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **RTOL)
    ft, _ = routed.forward(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **RTOL)
    assert len(calls) == 2 * tm.cfg.n_layers
    lo, _ = tm.prefill_step(tp, batch, max_len=32,
                            plan=KernelPlan(linked_matmul="cuda"))
    assert torch.equal(lo, lt) and len(calls) == 3 * tm.cfg.n_layers
    caches = tm.init_caches(3, 32)
    args = (torch.from_numpy(toks[:, :4]), torch.zeros(3, dtype=torch.int32),
            torch.full((3,), 4, dtype=torch.int32))
    over, _ = tm.prefill_chunk(tp, caches, *args,
                               plan=KernelPlan(linked_matmul="cuda"))
    assert calls[-1] == (3, 4, tm.cfg.d_model)
    own, _ = routed.prefill_chunk(tp, routed.init_caches(3, 32), *args)
    assert torch.equal(over, own) and len(calls) == 5 * tm.cfg.n_layers


def test_engine_runs_chunked_prefill_under_its_plan(monkeypatch):
    """``ServingEngine`` passes its plan to the chunk call as well as to
    decode: with ``linked_matmul="cuda"`` the (slots, chunk) prefill
    batches and the (slots, 1) decode batches both reach the wrapper."""
    from repro_torch.serving.engine import Request, ServingEngine
    *_, tm, tp = _pair("qwen3-reduced")
    calls = _spy_linked(monkeypatch)
    eng = ServingEngine(tm, tp, slots=2, max_len=32, chunk=4,
                        prefill_mode="chunked",
                        kernel_plan=KernelPlan(linked_matmul="cuda"))
    rng = np.random.default_rng(2)
    for rid in range(2):
        eng.submit(Request(rid=rid, prompt=rng.integers(
            0, tm.cfg.vocab, 9).astype(np.int32), max_new_tokens=3))
    eng.run()
    d = tm.cfg.d_model
    assert (2, 4, d) in calls and (2, 1, d) in calls
    assert set(calls) <= {(2, 4, d), (2, 1, d)}


def _bert_pair(seq=32):
    ref_g = ref_zoo.bert_s(seq=seq, d=768, n_layers=2)
    port_g = port_zoo.bert_s(seq=seq, d=768, n_layers=2)
    ref_p = ref_init_params(ref_g)
    port_p = graph_params_from_numpy(
        {k: np.asarray(v) for k, v in ref_p.items()}, port_g, device="cpu")
    rng = np.random.default_rng(5)
    x = {k: rng.normal(size=ref_g.tensors[k].shape).astype(np.float32)
         for k in ref_g.inputs}
    return ref_g, ref_p, port_g, port_p, x


@pytest.mark.parametrize("mode", ["ho", "xenos"])
def test_split_plan_bert_s_under_dsp_spec_matches_reference(mode,
                                                            monkeypatch):
    """bert_s(d=768) optimized under the TMS320C6678 spec: the planner
    splits its four FFN matmuls into ``{"K": 3}``; the routed executor
    sends each through ``split_matmul`` with ``block_n = N / 3`` and
    matches the reference's ``execute``."""
    ref_g, ref_p, port_g, port_p, x = _bert_pair()
    ref_opt, _ = ref_pipeline.optimize_for_mode(ref_g, mode,
                                                RefDeviceSpec.tms320c6678())
    port_opt, _ = port_pipeline.optimize_for_mode(port_g, mode,
                                                  DeviceSpec.tms320c6678())
    split = [n.dataflow["split_plan"].param_chunks for n in port_opt.nodes
             if n.op_type == "matmul" and n.params
             and n.dataflow["split_plan"].param_chunks]
    assert split == [{"K": 3}] * 4
    calls = []
    real = sm_ops.split_matmul

    def spy(x, w, b, **kw):
        calls.append((w.shape[1], kw["block_n"], kw["block_k"], w.shape[0]))
        return real(x, w, b, **kw)

    monkeypatch.setattr(sm_ops, "split_matmul", spy)
    want = ref_execute(ref_opt, ref_p, x, mode=mode)
    got = execute(port_opt, port_p, x, mode=mode,
                  plan=KernelPlan(split_matmul="cuda"))
    assert len(calls) == 4
    assert all(bn == N // 3 and bk == K for N, bn, bk, K in calls)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               **ENGINE_TOL)
    plain = execute(port_opt, port_p, x, mode=mode)
    np.testing.assert_allclose(got[0].numpy(), plain[0].numpy(),
                               **TOL["float32"])


def test_split_plan_leaves_what_the_reference_leaves_unsplit(monkeypatch):
    """lstm(d=512)'s gate matmuls get ``{"K": 3}`` under the DSP spec,
    but 3 does not divide 2048: they stay ``x @ w + b`` and never reach
    the wrapper; an ``inC`` plan reaches it with ``block_k = C / inC``."""
    g = port_zoo.lstm(d=512)
    opt, _ = port_pipeline.optimize_for_mode(g, "ho", DeviceSpec.tms320c6678())
    chunks = [n.dataflow["split_plan"].param_chunks for n in opt.nodes
              if n.op_type == "matmul" and n.params]
    assert {"K": 3} in chunks
    calls = []
    monkeypatch.setattr(sm_ops, "split_matmul",
                        lambda *a, **kw: calls.append(kw))
    rng = np.random.default_rng(0)
    ins = {k: rng.normal(size=g.tensors[k].shape).astype(np.float32)
           for k in g.inputs}
    params = engine.init_params(g, seed=0, device="cpu")
    execute(opt, params, ins, mode="ho", plan=KernelPlan(split_matmul="cuda"))
    assert calls == []
    monkeypatch.undo()
    x = torch.from_numpy(rng.normal(size=(6, 64)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(64, 10)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(10,)).astype(np.float32))
    sp = SplitPlan(param_chunks={"inC": 4})
    spied = []
    real = sm_ops.split_matmul

    def spy(*a, **kw):
        spied.append(kw)
        return real(*a, **kw)

    monkeypatch.setattr(sm_ops, "split_matmul", spy)
    got = engine._matmul_split(x, w, b, sp, "cuda")
    assert spied == [{"block_n": 10, "block_k": 16}]
    torch.testing.assert_close(got, engine._matmul_split(x, w, b, sp),
                               **TOL["float32"])
