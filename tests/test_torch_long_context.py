"""Attention past 2048 tokens on the port, against the reference.

``chunked_attention`` (the reference's flash-style double scan, here one
step a kv block over every q block) is held to
``repro.models.attention.chunked_attention`` on the same numpy inputs:
the reference's own sweep (``tests/test_attention_ssm.py``), non-causal,
the fallback to full attention, a band that skips kv blocks, and the
gradient against ``jax.grad`` of the reference's.  Then the switch at
2048 tokens in the model: ``prefill_step(use_chunked=)`` on every
layer, ``loss_fn`` and every gradient of a narrow
two-layer qwen3 at 3072 tokens, and the reduced seamless encoder's
bidirectional self-attention at 3072 frames, each with both packages'
scans engaged (spies).  Last, the sharded attention's kv cotangent on 4
gloo ranks of a ``(data 1, model 4)`` mesh whose 2 kv heads do not split
4 ways: gradients equal one device's, and each rank's kv weight
gradients cost a quarter of the whole weights'.

Tolerances: the kernel-free attention at the reference's own bound
(rtol 2e-4, atol 2e-5); the models at the model tolerance (rtol 3e-4,
atol 3e-5); the mesh against one device at rtol 1e-5
(``test_torch_train_mesh.py``'s: the sums over ranks run in another
order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_ranks as R
from repro.configs.base import get_config as jax_get_config
from repro.models import attention as RA
from repro.models.model import Model as JaxModel
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.distributed.sharding import MeshShape
from repro_torch.launch import mesh as mesh_lib
from repro_torch.models import attention as A
from repro_torch.models.layers import tree_leaves, tree_map
from repro_torch.models.model import Model

from test_torch_encdec import _pair as encdec_pair

#: the reference's bound for its scan against full attention
ATTN = dict(rtol=2e-4, atol=2e-5)
RTOL = dict(rtol=3e-4, atol=3e-5)
LONG = 3072


def _qkv(seed, B, S, H, K, D, T=None):
    rng = np.random.default_rng(seed)
    T = T or S
    return (rng.normal(size=(B, S, H, D)).astype(np.float32),
            rng.normal(size=(B, T, K, D)).astype(np.float32),
            rng.normal(size=(B, T, K, D)).astype(np.float32))


def _both(q, k, v, **kw):
    """(port, reference) ``chunked_attention`` on the same arrays."""
    got = A.chunked_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    want = RA.chunked_attention(*map(jnp.asarray, (q, k, v)), **kw)
    return got.numpy(), np.asarray(want)


def _nk_needed(qc, kc, window, nk):
    return min(nk, -(-(qc + window) // kc) + 1)


@pytest.mark.parametrize("S,qc,kc", [(1024, 256, 256), (2048, 512, 1024),
                                     (512, 128, 512)])
@pytest.mark.parametrize("window", [0, 256])
def test_chunked_matches_reference(S, qc, kc, window):
    """The reference's sweep (``test_attention_ssm.py:23-50``), causal:
    B 2, 4 q / 2 kv heads of 32."""
    q, k, v = _qkv(S + window, 2, S, 4, 2, 32)
    got, want = _both(q, k, v, causal=True, window=window, q_chunk=qc,
                      kv_chunk=kc)
    np.testing.assert_allclose(got, want, **ATTN)


#: name -> (S, T, q_chunk, kv_chunk, causal, window); the band skips
#: blocks where ``nk_needed < nk``
CASES = {
    "non_causal": (1024, 1024, 256, 512, False, 0),
    "non_causal_window": (1024, 1024, 256, 256, False, 256),
    "fallback_s": (1000, 1000, 256, 500, True, 0),
    "fallback_t": (1024, 1024, 256, 384, True, 0),
    "banded_skips": (2048, 2048, 256, 256, True, 128),
    "banded_wide": (2048, 2048, 512, 512, True, 700),
    "cross_lengths": (512, 2048, 256, 512, False, 0),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_chunked_cases_match_reference(name, monkeypatch):
    """Non-causal (with and without a window), the fallback to full
    attention where a chunk does not divide S or T (the port's
    ``full_attention`` then runs: a spy), a band that skips kv blocks
    (``nk_needed`` 3 of 8) and one that reaches them all, and S != T."""
    S, T, qc, kc, causal, window = CASES[name]
    fell_back = []
    full = A.full_attention
    monkeypatch.setattr(A, "full_attention",
                        lambda *a, **kw: fell_back.append(1) or full(*a,
                                                                     **kw))
    q, k, v = _qkv(len(name), 1, S, 4, 2, 16, T)
    got, want = _both(q, k, v, causal=causal, window=window, q_chunk=qc,
                      kv_chunk=kc)
    np.testing.assert_allclose(got, want, **ATTN)
    assert bool(fell_back) == name.startswith("fallback")
    if name == "banded_skips":
        assert _nk_needed(qc, kc, window, T // kc) == 3 < T // kc
    if name == "banded_wide":
        assert _nk_needed(qc, kc, window, T // kc) == T // kc


@pytest.mark.parametrize("window", [0, 128])
def test_chunked_gradient_matches_reference(window):
    """d/dq, d/dk, d/dv of ``sum(out * w)`` through the port's steps
    (autograd) against ``jax.grad`` through the reference's scan: S 512
    in blocks of 128 (banded at window 128), G 2."""
    q, k, v = _qkv(window + 5, 2, 512, 4, 2, 16)
    w = np.random.default_rng(9).normal(size=q.shape).astype(np.float32)
    kw = dict(causal=True, window=window, q_chunk=128, kv_chunk=128)

    def ref_loss(q, k, v):
        return jnp.sum(RA.chunked_attention(q, k, v, **kw) * w)
    want = jax.grad(ref_loss, argnums=(0, 1, 2))(
        *map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_(True)
                  for a in (q, k, v))
    out = A.chunked_attention(tq, tk, tv, **kw)
    got = torch.autograd.grad((out * torch.from_numpy(w)).sum(),
                              (tq, tk, tv))
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **ATTN)


def test_full_attention_q_offset_matches_reference():
    """``full_attention(q_offset=)``: 64 queries at positions 64..127
    over 128 keys, causal with and without a window."""
    q, k, v = _qkv(3, 2, 64, 4, 2, 16, 128)
    for window in (0, 32):
        got = A.full_attention(*map(torch.from_numpy, (q, k, v)),
                               window=window, q_offset=64)
        want = RA.full_attention(*map(jnp.asarray, (q, k, v)),
                                 window=window, q_offset=64)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN)


def _spies(monkeypatch):
    """Record (S, T, causal, scanned) of every ``chunked_attention`` call
    in both packages: ``scanned`` where the chunks divide S and T."""
    seen = {"ref": [], "port": []}

    def spy(real, key):
        def f(q, k, v, **kw):
            S, T = q.shape[1], k.shape[1]
            seen[key].append((S, T, kw.get("causal", True),
                              S % kw.get("q_chunk", 512) == 0
                              and T % kw.get("kv_chunk", 1024) == 0))
            return real(q, k, v, **kw)
        return f
    monkeypatch.setattr(RA, "chunked_attention",
                        spy(RA.chunked_attention, "ref"))
    monkeypatch.setattr(A, "chunked_attention",
                        spy(A.chunked_attention, "port"))
    return seen


def _narrow_pair(S: int):
    """The narrow two-layer qwen3 of ``test_torch_model.py``'s long
    prefill test at ``max_len`` S."""
    jcfg = dataclasses.replace(
        jax_get_config("qwen3-1.7b").reduced(), d_model=64, n_heads=2,
        n_kv_heads=1, head_dim=32, d_ff=128, max_len=S)
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.key(1))
    tm = Model(ModelConfig(**dataclasses.asdict(jcfg)), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def test_loss_and_gradients_past_2048_match_reference(monkeypatch):
    """``loss_fn`` and every gradient leaf at 1 x 3072 tokens: both
    packages' attention blocks take the chunked scan (causal, 6 x 3
    blocks), the port's through autograd (remat on), the reference's
    through ``jax.grad``."""
    jm, jp, tm, tp = _narrow_pair(LONG)
    toks = np.random.default_rng(LONG).integers(
        0, jm.cfg.vocab, (1, LONG + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    seen = _spies(monkeypatch)
    lj, gj = jax.value_and_grad(lambda p: jm.loss_fn(
        p, {k: jnp.asarray(v) for k, v in batch.items()})[0])(jp)
    tp = tree_map(lambda t: t.requires_grad_(True), tp)
    lt, _ = tm.loss_fn(tp, {k: torch.from_numpy(v)
                            for k, v in batch.items()})
    gt = torch.autograd.grad(lt, tree_leaves(tp))
    assert seen["ref"] and set(seen["ref"]) == {(LONG, LONG, True, True)}
    # two layers, and the remat forward again in the backward
    assert seen["port"] == [(LONG, LONG, True, True)] * 4
    np.testing.assert_allclose(float(lt.detach()), float(lj), **RTOL)
    want = jax.tree.leaves(jax.tree.map(np.asarray, gj))
    assert len(want) == len(gt)
    for g, w in zip(gt, want):
        scale = np.abs(w).max()
        np.testing.assert_allclose(g.numpy(), w, rtol=3e-4,
                                   atol=3e-5 * max(scale, 1.0))


@pytest.mark.parametrize("S,use_chunked,scan", [
    (1024, True, True), (LONG, False, False), (LONG, None, True)])
def test_prefill_use_chunked_sets_every_layer(S, use_chunked, scan,
                                              monkeypatch):
    """``prefill_step(use_chunked=)`` is every attention layer's switch:
    True scans below 2048 tokens, False runs full attention past them,
    None switches at 2048 (a spy).  Logits and the first decode step's
    agree with full attention's at the model tolerance."""
    _, _, tm, tp = _narrow_pair(S)
    toks = torch.from_numpy(np.random.default_rng(S).integers(
        0, tm.cfg.vocab, (1, S)))
    nt = torch.tensor([[7]])
    with torch.no_grad():
        lw, cw = tm.prefill_step(tp, {"tokens": toks}, max_len=S,
                                 use_chunked=False)
        dw, _ = tm.serve_step(tp, cw, nt)
        seen = _spies(monkeypatch)
        lg, cg = tm.prefill_step(tp, {"tokens": toks}, max_len=S,
                                 use_chunked=use_chunked)
        dg, _ = tm.serve_step(tp, cg, nt)
    assert seen["port"] == ([(S, S, True, True)] * tm.cfg.n_layers
                            if scan else [])
    np.testing.assert_allclose(lg.numpy(), lw.numpy(), **RTOL)
    np.testing.assert_allclose(dg.numpy(), dw.numpy(), **RTOL)


def test_encoder_self_attention_past_2048_matches_reference(monkeypatch):
    """Reduced seamless's encoder (bidirectional self-attention, its
    attention at one layer's fan-in as ``test_torch_encdec.py`` draws
    it) over 1 x 3072 frames: both packages scan, non-causal."""
    jm, jp, tm, tp = encdec_pair()
    x = np.random.default_rng(1).normal(
        size=(1, LONG, jm.cfg.d_model)).astype(np.float32)
    seen = _spies(monkeypatch)
    want = np.asarray(jm._encode(jp, jnp.asarray(x)))
    with torch.no_grad():
        got = tm._encode(tp, torch.from_numpy(x)).numpy()
    assert seen["ref"] and set(seen["ref"]) == {(LONG, LONG, False, True)}
    assert seen["port"] == [(LONG, LONG, False, True)] * \
        jm.cfg.encoder_layers
    np.testing.assert_allclose(got, want, **RTOL)


# ---------------------------------------------------------------------------
# the kv cotangent on a mesh whose kv heads do not split
# ---------------------------------------------------------------------------

KV_SHAPE = MeshShape({"data": 1, "model": 4})
#: 12 q / 2 kv heads of 16 at d 64: 4 ranks of 3 q heads each read one
#: kv head, sliced locally (12 q heads, not 8: a rank's share of wq's
#: columns would then be as wide as a kv projection's)
KV_CFG = dict(n_heads=12, n_kv_heads=2, head_dim=16, d_model=64, d_ff=96)
KV_BATCHES = {"short": (2, 16), "long": (1, LONG)}


def _kv_cfg():
    return dataclasses.replace(get_config("qwen3-1.7b").reduced(), **KV_CFG)


def _kv_batch(name: str) -> dict:
    B, S = KV_BATCHES[name]
    toks = np.random.default_rng(S).integers(0, 512, (B, S + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return tree.detach().numpy()


@pytest.fixture(scope="module")
def kv_params():
    model = Model(_kv_cfg(), device="cpu")
    return _numpy_tree(model.init(torch.Generator().manual_seed(4)))


@pytest.fixture(scope="module")
def kv_ranks(kv_params, tmp_path_factory):
    cases = {name: {"cfg": dataclasses.asdict(_kv_cfg()),
                    "params": kv_params, "batch": _kv_batch(name)}
             for name in KV_BATCHES}
    return mesh_lib.spawn_ranks(R.kv_grad_rank, 4, args=(cases,),
                                devices=["cpu"] * 4, timeout_s=600.0,
                                store_dir=tmp_path_factory.mktemp("store"),
                                train_shape=KV_SHAPE)


@pytest.mark.parametrize("name", sorted(KV_BATCHES))
def test_sliced_kv_gradients_equal_one_device(name, kv_ranks, kv_params):
    """Every gradient leaf on every rank (gathered whole) within rtol 1e-5
    of the port's one-device gradients; at 3072 tokens each rank's local
    attention takes the chunked scan, as one device's does."""
    model = Model(_kv_cfg(), device="cpu")
    params = tree_map(lambda t: t.requires_grad_(True),
                      params_from_numpy(kv_params, "cpu"))
    batch = {k: torch.from_numpy(v) for k, v in _kv_batch(name).items()}
    loss, _, grads = model._grads(params, batch)
    for r in kv_ranks:
        got = r[name]
        np.testing.assert_allclose(got["loss"], float(loss), rtol=1e-5)
        assert len(got["grads"]) == len(grads)
        for g, w in zip(got["grads"], grads):
            w = w.numpy()
            np.testing.assert_allclose(g, w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max())


@pytest.mark.parametrize("name", sorted(KV_BATCHES))
def test_sliced_kv_weight_gradients_take_a_quarter(name, kv_ranks):
    """``wk`` / ``wv`` split on d over ``"model"`` (their 2 kv heads do
    not split 4 ways): each rank's weight-gradient matmuls (output (d / 4,
    K * hd), ``torch.utils.flop_counter``'s FLOPs at the local shapes)
    cost a quarter of the whole weights' 2 * B * S * d * K * hd, for each
    of the two projections of each layer; none runs at the whole d."""
    cfg = _kv_cfg()
    B, S = KV_BATCHES[name]
    d, cols = cfg.d_model, cfg.n_kv_heads * cfg.resolved_head_dim
    whole = cfg.n_layers * 2 * (2 * B * S * d * cols)
    for r in kv_ranks:
        got = r[name]
        assert got["wk_placements"] == ["Replicate()", "Shard(dim=1)"]
        weight = [(tuple(s), f) for s, f in got["kv_mms"] if s[0] in (
            d, d // 4)]
        assert {s for s, _ in weight} == {(d // 4, cols)}, weight
        assert sum(f for _, f in weight) == whole / 4
