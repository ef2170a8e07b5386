"""The port's model against the JAX reference, weights carried across.

Weights come from ``repro`` ``Model.init`` and cross through numpy
(``repro_torch.convert``).  Under teacher forcing the logits of
``prefill_step``, of every ``prefill_chunk`` and of every ``serve_step``
(dense and paged caches) match the reference at rtol 3e-4, on reduced
``qwen3-1.7b``, reduced ``chatglm3-6b`` (partial RoPE) and the
serving-fuzz ``CFG``.  Inside the port, paged ≡ dense and any chunking ≡
any other chunking hold bit for bit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.models.model import Model as JaxModel
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core.pipeline import KernelPlan
from repro_torch.models.model import Model

from test_serving_fuzz import CFG as FUZZ_CFG

#: rtol: the model-level tolerance; atol: the fp32 kernel one, for logits ~0
RTOL = dict(rtol=3e-4, atol=3e-5)
B, C, MAX_LEN, BS = 3, 4, 32, 8
PROMPT_LENS = (7, 12, 5)


def _configs():
    return {"qwen3-reduced": jax_get_config("qwen3-1.7b").reduced(),
            "chatglm3-reduced": jax_get_config("chatglm3-6b").reduced(),
            "fuzz": FUZZ_CFG}


_PAIRS: dict = {}


def _pair(name):
    """(reference model, reference params, port model, port params)."""
    if name not in _PAIRS:
        jcfg = _configs()[name]
        tcfg = ModelConfig(**dataclasses.asdict(jcfg))
        jm = JaxModel(jcfg)
        jp = jm.init(jax.random.key(0))
        tm = Model(tcfg, device="cpu")
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        _PAIRS[name] = (jm, jp, tm, tp)
    return _PAIRS[name]


def _script(vocab, seed=0):
    """A fixed serving script: chunk ticks until every prompt is in, then
    decode ticks with one bystander row; (kind, tokens, a, b, rows)."""
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, vocab, n) for n in PROMPT_LENS]
    steps = []
    for start in range(0, max(PROMPT_LENS), C):
        toks = np.zeros((B, C), np.int32)
        off = np.zeros((B,), np.int32)
        n_new = np.zeros((B,), np.int32)
        for b, p in enumerate(prompts):
            n = max(0, min(C, len(p) - start))
            if n:
                toks[b, :n] = p[start:start + n]
                off[b], n_new[b] = start, n
        steps.append(("chunk", toks, off, n_new, n_new > 0))
    for i in range(5):
        toks = rng.integers(0, vocab, (B, 1)).astype(np.int32)
        live = np.ones((B,), bool)
        if i == 2:
            live[1] = False
        steps.append(("decode", toks, live, None, live))
    return steps


def _block_rows():
    M = MAX_LEN // BS
    perm = np.random.default_rng(9).permutation(B * M)
    return [perm[b * M:(b + 1) * M].astype(np.int32) for b in range(B)]


def _run_ref(jm, jp, kv):
    if kv == "paged":
        M = MAX_LEN // BS
        caches = jm.init_paged_caches(B, pool_blocks=B * M, block_size=BS,
                                      max_blocks=M)
        bt = caches.kv.block_tables
        for b, row in enumerate(_block_rows()):
            bt = bt.at[:, b].set(jnp.asarray(row))
        caches = caches._replace(kv=caches.kv._replace(block_tables=bt))
    else:
        caches = jm.init_caches(B, MAX_LEN)
    chunk = jax.jit(jm.prefill_chunk)
    decode = jax.jit(lambda p, c, t, live: jm.serve_step(p, c, t, live=live))
    out = []
    for kind, toks, a, b, _ in _script(jm.cfg.vocab):
        if kind == "chunk":
            logits, caches = chunk(jp, caches, jnp.asarray(toks),
                                   jnp.asarray(a), jnp.asarray(b))
        else:
            logits, caches = decode(jp, caches, jnp.asarray(toks),
                                    jnp.asarray(a))
        out.append(np.asarray(logits))
    return out


def _run_port(tm, tp, kv, plan=None, chunk_split=1):
    if kv == "paged":
        M = MAX_LEN // BS
        caches = tm.init_paged_caches(B, pool_blocks=B * M, block_size=BS,
                                      max_blocks=M)
        for b, row in enumerate(_block_rows()):
            caches.kv.block_tables[:, b] = torch.from_numpy(row)
    else:
        caches = tm.init_caches(B, MAX_LEN)
    out = []
    for kind, toks, a, b, _ in _script(tm.cfg.vocab):
        if kind == "chunk":
            # chunk_split > 1 feeds the same tokens in smaller chunks
            sub = C // chunk_split
            for s in range(0, C, sub):
                n = np.clip(b - s, 0, sub).astype(np.int32)
                logits, caches = tm.prefill_chunk(
                    tp, caches, torch.from_numpy(toks[:, s:s + sub]),
                    torch.from_numpy(np.where(n > 0, a + s, 0)
                                     .astype(np.int32)),
                    torch.from_numpy(n))
                if s == 0:
                    first = logits
                last_logits = torch.where(torch.from_numpy(n > 0)[:, None],
                                          logits, first)
                first = last_logits
            logits = last_logits
        else:
            logits, caches = tm.serve_step(tp, caches, torch.from_numpy(toks),
                                           live=torch.from_numpy(a),
                                           plan=plan)
        out.append(logits.numpy())
    return out


@pytest.mark.parametrize("kv", ["dense", "paged"])
@pytest.mark.parametrize("name", ["qwen3-reduced", "fuzz"])
def test_chunk_and_decode_logits_match_reference(name, kv):
    jm, jp, tm, tp = _pair(name)
    ref = _run_ref(jm, jp, kv)
    got = _run_port(tm, tp, kv)
    for i, (step, r, g) in enumerate(zip(_script(jm.cfg.vocab), ref, got)):
        rows = step[4]
        np.testing.assert_allclose(g[rows], r[rows], **RTOL,
                                   err_msg=f"{name} {kv} step {i} {step[0]}")


@pytest.mark.parametrize("name", ["qwen3-reduced", "chatglm3-reduced",
                                  "fuzz"])
def test_prefill_step_and_forward_match_reference(name):
    """One-shot padded prefill (then decode) and the full forward;
    chatglm3 covers partial RoPE (``rope_fraction=0.5``)."""
    jm, jp, tm, tp = _pair(name)
    rng = np.random.default_rng(4)
    S = max(PROMPT_LENS)
    toks = rng.integers(0, jm.cfg.vocab, (B, S)).astype(np.int32)
    lens = np.asarray(PROMPT_LENS, np.int32)
    lj, cj = jm.prefill_step(jp, {"tokens": jnp.asarray(toks),
                                  "lengths": jnp.asarray(lens)},
                             max_len=MAX_LEN)
    lt, ct = tm.prefill_step(tp, {"tokens": torch.from_numpy(toks),
                                  "lengths": torch.from_numpy(lens)},
                             max_len=MAX_LEN)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **RTOL)
    for _ in range(3):
        nt = rng.integers(0, jm.cfg.vocab, (B, 1)).astype(np.int32)
        lj, cj = jm.serve_step(jp, cj, jnp.asarray(nt))
        lt, ct = tm.serve_step(tp, ct, torch.from_numpy(nt))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **RTOL)
    fj, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    ft, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **RTOL)


@pytest.mark.parametrize("name", ["qwen3-reduced", "fuzz"])
def test_paged_equals_dense_bit_for_bit(name):
    """The port's own oracle: paged KV (gather and fold backends) gives
    the dense engine's logits exactly, on every compared row."""
    *_, tm, tp = _pair(name)
    dense = _run_port(tm, tp, "dense")
    for backend in ("gather", "fold"):
        paged = _run_port(tm, tp, "paged",
                          plan=KernelPlan(decode_paged=backend))
        for step, d, p in zip(_script(tm.cfg.vocab), dense, paged):
            np.testing.assert_array_equal(p[step[4]], d[step[4]])


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_chunking_is_bit_invariant_and_matches_one_shot(kv):
    """Chunks of 4 ≡ chunks of 2 ≡ chunks of 1 bit for bit; the one-shot
    ``prefill_step`` agrees to 2e-5, as in the reference (its attention
    reduces over S instead of the cache width)."""
    *_, tm, tp = _pair("qwen3-reduced")
    base = _run_port(tm, tp, kv)
    for split in (2, 4):
        other = _run_port(tm, tp, kv, chunk_split=split)
        for step, x, y in zip(_script(tm.cfg.vocab), base, other):
            np.testing.assert_array_equal(x[step[4]], y[step[4]])
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, tm.cfg.vocab, n) for n in PROMPT_LENS]
    for b, p in enumerate(prompts):
        one, _ = tm.prefill_step(tp, {"tokens": torch.from_numpy(p)[None]},
                                 max_len=MAX_LEN)
        last = max(i for i, s in enumerate(_script(tm.cfg.vocab))
                   if s[0] == "chunk" and s[4][b])
        np.testing.assert_allclose(base[last][b], one[0].numpy(),
                                   rtol=2e-5, atol=2e-6)


def test_cuda_backends_run_their_plain_versions_on_the_host():
    """With CPU tensors the ``cuda`` sites run the kernels' plain
    versions, which agree with the plain-torch sites to fp32 tolerance."""
    *_, tm, tp = _pair("fuzz")
    for kv, plan in (("dense", KernelPlan(decode_dense="cuda")),
                     ("paged", KernelPlan(decode_paged="cuda"))):
        want = _run_port(tm, tp, kv)
        got = _run_port(tm, tp, kv, plan=plan)
        for step, w, g in zip(_script(tm.cfg.vocab), want, got):
            np.testing.assert_allclose(g[step[4]], w[step[4]],
                                       rtol=3e-5, atol=3e-5)


def test_port_init_draws_the_reference_distributions():
    """``Model.init`` on the port: same tree, shapes, ones/zeros leaves,
    and the reference's per-leaf scales (stacked fan-in rule included)."""
    jm, jp, tm, _ = _pair("qwen3-reduced")
    tp = tm.init(torch.Generator().manual_seed(0), device="cpu")
    ref = jax.tree.map(np.asarray, jp)

    def walk(a, b, path=""):
        assert set(a) == set(b), path
        for k in a:
            if isinstance(a[k], dict):
                walk(a[k], b[k], f"{path}/{k}")
                continue
            x, y = a[k].numpy(), b[k]
            assert x.shape == y.shape and x.dtype == y.dtype, f"{path}/{k}"
            if np.all(y == y.flat[0]):
                np.testing.assert_array_equal(x, y)
            else:
                assert abs(x.std() / y.std() - 1) < 0.1, f"{path}/{k}"
    walk(tp, ref)


@pytest.mark.parametrize("S,scan", [(2080, False), (3072, True)])
def test_one_shot_prefill_past_2048_matches_reference(S, scan, monkeypatch):
    """Past 2048 tokens both packages' one-shot prefill calls
    ``chunked_attention`` (the reference's ``attention.py:686``), which
    falls back to ``full_attention`` unless S is a multiple of its 512 /
    1024 chunks: at 2080 both run full attention, at 3072 both their
    flash-style scans (spies on both).  Narrow two-layer config; logits
    of the last position and the cache agree at the model tolerance."""
    jcfg = dataclasses.replace(
        jax_get_config("qwen3-1.7b").reduced(), d_model=64, n_heads=2,
        n_kv_heads=1, head_dim=32, d_ff=128, max_len=S)
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.key(1))
    tm = Model(tcfg, device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    toks = np.random.default_rng(S).integers(0, jcfg.vocab, (1, S)) \
        .astype(np.int32)
    from repro.models import attention as ref_attention
    from repro_torch.models import attention as port_attention
    seen, port_seen = [], []

    def spy(real, out):
        def f(q, k, *a, **kw):
            out.append(q.shape[1] % 512 == 0 and k.shape[1] % 1024 == 0)
            return real(q, k, *a, **kw)
        return f

    monkeypatch.setattr(ref_attention, "chunked_attention",
                        spy(ref_attention.chunked_attention, seen))
    monkeypatch.setattr(port_attention, "chunked_attention",
                        spy(port_attention.chunked_attention, port_seen))
    lj, cj = jm.prefill_step(jp, {"tokens": jnp.asarray(toks)}, max_len=S)
    lt, ct = tm.prefill_step(tp, {"tokens": torch.from_numpy(toks)},
                             max_len=S)
    assert seen and set(seen) == {scan}   # traced once: layers are scanned
    assert port_seen == [scan] * jcfg.n_layers
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **RTOL)
    nt = np.asarray([[7]], np.int32)
    lj, _ = jm.serve_step(jp, cj, jnp.asarray(nt))
    lt, _ = tm.serve_step(tp, ct, torch.from_numpy(nt))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **RTOL)
