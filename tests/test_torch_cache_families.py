"""The attention cache families of the port against the JAX reference.

Sliding windows (the dense ring and the wraparound ring pool), layer
patterns (gemma3's per-layer window and RoPE theta, tuple caches) and
``MixedKVPool`` (a classic lease for the global layers, a ring lease for
the sliding ones).

* **Against the reference** (weights carried across through numpy): the
  logits of every chunked-prefill and decode step under teacher forcing,
  dense and paged, and of the one-shot prefill and the forward, on
  reduced gemma3-1b (pattern ``SG``, window 64, thetas 10k / 1M) and on
  reduced qwen3-1.7b with a 16-token window, at rtol 3e-4; contexts run
  past the window, so every ring wraps.  ``serve_schedule``'s plan for
  the window and mixed options, ``MixedKVPool``'s accounting, and the
  engines' ``kv_growth``.
* **The port's own oracles**, bit for bit, on
  ``tests/test_serving_fuzz.py``'s traces (``make_trace``): ring ≡ dense
  sliding, sliding ≡ full attention within the window, mixed ≡ all-full
  within the window, an all-``S`` pattern ≡ the legacy sliding engine
  past the window, mixed paged ≡ mixed dense; a request preempted after
  its ring wrapped ≡ its solo run (where the reference fails its own
  test); the staged (graph) step ≡ the eager one over tuple caches.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.core import pipeline as ref_pipeline
from repro.models.model import Model as JaxModel
from repro.serving import ServingEngine as JaxEngine
from repro.serving.kv_pool import MixedKVPool as JaxMixedKVPool
from repro.serving.kv_pool import PoolConfig as JaxPoolConfig
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import pipeline as port_pipeline
from repro_torch.models import attention as A
from repro_torch.models.model import Model
from repro_torch.serving import (MixedKVPool, PoolConfig, Request,
                                 ServingEngine)
from repro_torch.serving.speculative import SpecParams

from test_serving_fuzz import (BLOCK, CFG, CHUNK, MAX_LEN, MIXED_CFG,
                               PATTERN_SWA_CFG, SLOTS, SWA_CFG, WINDOW,
                               _within_window_trace, make_trace)

#: rtol: the model-level tolerance; atol: the fp32 kernel one, for logits ~0
RTOL = dict(rtol=3e-4, atol=3e-5)
#: the teacher-forced script: rows, chunk, horizon, block size; prompts
#: past gemma3's reduced window (64) and far past qwen3-swa's (16)
B, C, HORIZON, BS = 3, 8, 128, 8
PROMPT_LENS = (90, 70, 33)


def _configs():
    gemma = jax_get_config("gemma3-1b").reduced()
    qwen = jax_get_config("qwen3-1.7b").reduced()
    return {"gemma3-reduced": gemma,
            "qwen3-swa16": dataclasses.replace(
                qwen, name=f"{qwen.name}-swa16", sliding_window=16)}


_PAIRS: dict = {}


def _pair(name):
    """(reference model, reference params, port model, port params)."""
    if name not in _PAIRS:
        jcfg = _configs()[name]
        jm = JaxModel(jcfg)
        jp = jm.init(jax.random.key(0))
        tm = Model(ModelConfig(**dataclasses.asdict(jcfg)), device="cpu")
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        _PAIRS[name] = (jm, jp, tm, tp)
    return _PAIRS[name]


def test_reduced_gemma3_is_a_mixed_pattern_stack():
    """The reduced gemma3 keeps both layer kinds and both thetas, so the
    parity below runs a sliding and a global layer."""
    *_, tm, _ = _pair("gemma3-reduced")
    assert tm.hetero and tm.cfg.layer_pattern == "SG"
    assert tm.layer_windows == (64, 0)
    assert tm.layer_thetas == (10000.0, 1000000.0)


def _script(vocab, seed=0):
    """Chunk ticks until every prompt is in, then decode ticks with one
    bystander row; (kind, tokens, a, b, rows)."""
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
    for i in range(6):
        toks = rng.integers(0, vocab, (B, 1)).astype(np.int32)
        live = np.ones((B,), bool)
        if i == 2:
            live[1] = False
        steps.append(("decode", toks, live, None, live))
    return steps


def _geometry(cfg):
    """Block rows for every slot: a shuffled classic table over the
    horizon and a shuffled ring table over the window."""
    M, Mr = HORIZON // BS, (cfg.sliding_window // BS
                            if cfg.sliding_window else 0)
    rng = np.random.default_rng(9)
    cls = rng.permutation(B * M)
    ring = rng.permutation(B * Mr) if Mr else None
    return (M, Mr, [cls[b * M:(b + 1) * M].astype(np.int32)
                    for b in range(B)],
            [ring[b * Mr:(b + 1) * Mr].astype(np.int32) for b in range(B)]
            if Mr else None)


def _paged_kw(model):
    """init_paged_caches' geometry for a model's paged kind."""
    M, Mr, _, _ = _geometry(model.cfg)
    if model.hetero:
        return dict(pool_blocks=B * M, block_size=BS, max_blocks=M,
                    ring_pool_blocks=B * Mr, ring_max_blocks=Mr)
    # all-sliding: the ring pool alone
    return dict(pool_blocks=B * Mr, block_size=BS, max_blocks=Mr)


def _run_ref(jm, jp, kv):
    if kv == "paged":
        _, _, cls, ring = _geometry(jm.cfg)
        caches = jm.init_paged_caches(B, **_paged_kw(jm))

        def install(kv_c, per_layer):
            rows = ring if hasattr(kv_c, "positions") else cls
            bt = kv_c.block_tables
            for b, r in enumerate(rows):
                bt = bt.at[b].set(r) if per_layer else bt.at[:, b].set(r)
            return kv_c._replace(block_tables=bt)
        if type(caches) is tuple:
            caches = tuple(c._replace(kv=install(c.kv, True))
                           for c in caches)
        else:
            caches = caches._replace(kv=install(caches.kv, False))
    else:
        caches = jm.init_caches(B, HORIZON)
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


def _run_port(tm, tp, kv):
    if kv == "paged":
        _, _, cls, ring = _geometry(tm.cfg)
        caches = tm.init_paged_caches(B, **_paged_kw(tm))
        per_layer = type(caches) is tuple
        for c in (caches if per_layer else (caches,)):
            rows = ring if hasattr(c.kv, "positions") else cls
            for b, r in enumerate(rows):
                idx = (b,) if per_layer else (slice(None), b)
                c.kv.block_tables[idx] = torch.from_numpy(r)
    else:
        caches = tm.init_caches(B, HORIZON)
    out = []
    for kind, toks, a, b, _ in _script(tm.cfg.vocab):
        if kind == "chunk":
            logits, caches = tm.prefill_chunk(
                tp, caches, torch.from_numpy(toks), torch.from_numpy(a),
                torch.from_numpy(b))
        else:
            logits, caches = tm.serve_step(tp, caches, torch.from_numpy(toks),
                                           live=torch.from_numpy(a))
        out.append(logits.numpy())
    return out


@pytest.mark.parametrize("kv", ["dense", "paged"])
@pytest.mark.parametrize("name", ["gemma3-reduced", "qwen3-swa16"])
def test_chunk_and_decode_logits_match_reference(name, kv):
    """Teacher-forced chunked prefill then decode past the window: dense
    rings (a sliding layer's window-wide) and the paged layouts (gemma3:
    the mixed pool, its global layer classic-paged and its sliding layer
    ring-paged; qwen3-swa16: the ring pool)."""
    jm, jp, tm, tp = _pair(name)
    ref = _run_ref(jm, jp, kv)
    got = _run_port(tm, tp, kv)
    for i, (step, r, g) in enumerate(zip(_script(jm.cfg.vocab), ref, got)):
        rows = step[4]
        np.testing.assert_allclose(g[rows], r[rows], **RTOL,
                                   err_msg=f"{name} {kv} step {i} {step[0]}")


@pytest.mark.parametrize("name", ["gemma3-reduced", "qwen3-swa16"])
def test_prefill_step_and_forward_match_reference(name):
    """One-shot prefill of prompts past the window (a sliding ring keeps
    the last W positions at their slots), then decode, and the full
    forward (every layer at the config's window and theta, as the
    reference's forward runs)."""
    jm, jp, tm, tp = _pair(name)
    rng = np.random.default_rng(4)
    toks = rng.integers(0, jm.cfg.vocab, (B, 80)).astype(np.int32)
    lj, cj = jm.prefill_step(jp, {"tokens": jnp.asarray(toks)},
                             max_len=HORIZON)
    lt, ct = tm.prefill_step(tp, {"tokens": torch.from_numpy(toks)},
                             max_len=HORIZON)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **RTOL)
    if tm.hetero:
        assert [c.kv.k.shape[1] for c in ct] == [64, HORIZON]
    for _ in range(3):
        nt = rng.integers(0, jm.cfg.vocab, (B, 1)).astype(np.int32)
        lj, cj = jm.serve_step(jp, cj, jnp.asarray(nt))
        lt, ct = tm.serve_step(tp, ct, torch.from_numpy(nt))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **RTOL)
    fj, _ = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    ft, _ = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **RTOL)


def test_reset_cache_rows_matches_reference_on_tuple_caches():
    """Recycling a slot clears its positions and length on every layer
    of a layer-pattern stack (a window-wide ring and a horizon-wide one),
    and nothing of the other rows."""
    jm, jp, tm, tp = _pair("gemma3-reduced")
    toks = np.random.default_rng(2).integers(0, jm.cfg.vocab, (B, 70)) \
        .astype(np.int32)
    _, cj = jm.prefill_step(jp, {"tokens": jnp.asarray(toks)},
                            max_len=HORIZON)
    _, ct = tm.prefill_step(tp, {"tokens": torch.from_numpy(toks)},
                            max_len=HORIZON)
    rows = np.array([False, True, False])
    cj = jm.reset_cache_rows(cj, jnp.asarray(rows))
    ct = tm.reset_cache_rows(ct, torch.from_numpy(rows))
    for j, t in zip(cj, ct):
        np.testing.assert_array_equal(t.kv.positions.numpy(),
                                      np.asarray(j.kv.positions))
        np.testing.assert_array_equal(t.kv.length.numpy(),
                                      np.asarray(j.kv.length))
    assert (ct[0].kv.positions[1] == -1).all()
    assert (ct[0].kv.positions[0] >= 0).any()


# -- the port's oracles on the serving-fuzz traces ---------------------------

_MODELS: dict = {}


def _model(jcfg):
    """The port's model of a fuzz config, weights from one seed: configs
    with the same parameter shapes get the same weights."""
    if jcfg.name not in _MODELS:
        m = Model(ModelConfig(**dataclasses.asdict(jcfg)), device="cpu")
        _MODELS[jcfg.name] = (m, m.init(torch.Generator().manual_seed(0)))
    return _MODELS[jcfg.name]


def _engine(model, params, trace, kv, slots=SLOTS, **kw):
    paged = kv == "paged"
    return ServingEngine(model, params, slots=slots, max_len=MAX_LEN,
                         chunk=CHUNK, prefill_mode="chunked",
                         replan_every=10_000, eos_id=trace.eos_id, kv=kv,
                         kv_block_size=BLOCK if paged else None,
                         kv_pool_blocks=trace.pool_blocks if paged else None,
                         **kw)


def run_trace(jcfg, trace, kv, slots=SLOTS, **kw):
    """``test_serving_fuzz.run_trace`` on the port: the streams, with the
    pool's invariants re-derived every tick and the pool drained."""
    model, params = _model(jcfg)
    eng = _engine(model, params, trace, kv, slots, **kw)
    reqs = []

    def step():
        eng.step()
        if eng.pool is not None:
            eng.pool.check_invariants()
    for rid, ev in enumerate(trace.events):
        for _ in range(ev.gap):
            step()
        req = Request(rid=rid, prompt=ev.prompt.copy(),
                      max_new_tokens=ev.max_new, priority=ev.priority,
                      sampling=ev.sampling)
        eng.submit(req)
        reqs.append(req)
    for _ in range(3000):
        if not eng.scheduler.pending():
            break
        step()
    assert not eng.scheduler.pending() and all(r.done for r in reqs)
    if eng.pool is not None:
        assert eng.pool.stats()["blocks_in_use"] == 0
    return [list(r.generated) for r in reqs]


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("seed", [40_000, 40_001, 40_002])
def test_ring_matches_dense_sliding_on_traces(seed, sampled):
    """The reference's ``test_sliding_ring_trace_equivalence`` on the
    port: the ring-paged sliding engine ≡ the dense sliding engine bit
    for bit, contexts past the window (gaps, priorities and preemption,
    gated pools, EOS)."""
    trace = make_trace(seed, sampled=sampled)
    assert run_trace(SWA_CFG, trace, "paged") == \
        run_trace(SWA_CFG, trace, "dense")


@pytest.mark.parametrize("seed", range(3))
def test_sliding_and_mixed_match_full_attention_within_window(seed):
    """While every context fits the window a sliding layer sees what a
    full one sees: the sliding engine (dense, ring) and the mixed stack
    (dense, mixed pool) ≡ the full-attention engine bit for bit."""
    trace = _within_window_trace(seed)
    # the reference's unrolled full config is CFG itself here: the
    # port's stack is a Python loop either way
    full = run_trace(CFG, trace, "dense")
    for jcfg in (SWA_CFG, MIXED_CFG):
        for kv in ("dense", "paged"):
            assert run_trace(jcfg, trace, kv) == full, (jcfg.name, kv)


@pytest.mark.parametrize("seed", range(3))
def test_pattern_sliding_matches_legacy_sliding_past_window(seed):
    """An all-``S`` pattern is the legacy sliding engine through the
    per-layer tuple path: the same streams past the window, dense and
    ring-paged."""
    trace = make_trace(seed, sampled=bool(seed % 2))
    legacy = run_trace(SWA_CFG, trace, "dense")
    for kv in ("dense", "paged"):
        assert run_trace(PATTERN_SWA_CFG, trace, kv) == legacy, kv


@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("seed", [70_000, 70_001, 70_002])
def test_mixed_paged_matches_mixed_dense_on_traces(seed, sampled):
    """The reference's ``test_mixed_trace_equivalence`` on the port: the
    mixed pool (classic + ring leases per request) ≡ the dense mixed
    engine bit for bit."""
    trace = make_trace(seed, sampled=sampled)
    assert run_trace(MIXED_CFG, trace, "paged") == \
        run_trace(MIXED_CFG, trace, "dense")


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_sliding_preemption_restore_matches_solo(kv):
    """The scenario of the reference's failing
    ``test_sliding_preemption_restore_across_slid_window``: a request
    preempted after its ring wrapped (context 20 > window 16, then
    decodes) restores by re-prefilling its folded context.  The port holds
    it to its own unpreempted solo run, dense ring and ring-paged."""
    model, params = _model(SWA_CFG)
    rng = np.random.default_rng(33)
    prompt = rng.integers(0, CFG.vocab, WINDOW + 4).astype(np.int32)
    vip_prompt = rng.integers(0, CFG.vocab, 6).astype(np.int32)
    eng = ServingEngine(model, params, slots=1, max_len=MAX_LEN, chunk=CHUNK,
                        prefill_mode="chunked", replan_every=10_000, kv=kv,
                        kv_block_size=BLOCK if kv == "paged" else None,
                        kv_pool_blocks=8 if kv == "paged" else None)
    eng.scheduler.cfg.preempt = 1  # a 1-slot engine defaults to 0
    low = Request(rid=0, prompt=prompt.copy(), max_new_tokens=8)
    eng.submit(low)
    for _ in range(8):  # 5 prefill ticks (20 at chunk 4), then decodes
        eng.step()
    assert len(low.generated) >= 1 and not low.done
    vip = Request(rid=1, prompt=vip_prompt.copy(), max_new_tokens=2,
                  priority=5)
    eng.submit(vip)
    eng.run()
    assert eng.scheduler.preempted == 1
    assert low.done and len(low.generated) == 8 and vip.done
    if eng.pool is not None:
        eng.pool.check_invariants()
        assert eng.pool.stats()["blocks_in_use"] == 0
    solos = []
    for p, n in ((prompt, 8), (vip_prompt, 2)):
        solo = Request(rid=0, prompt=p.copy(), max_new_tokens=n)
        one = ServingEngine(model, params, slots=1, max_len=MAX_LEN,
                            chunk=CHUNK, prefill_mode="chunked",
                            replan_every=10_000)
        one.submit(solo)
        one.run()
        solos.append(list(solo.generated))
    assert [list(low.generated), list(vip.generated)] == solos


def test_ring_pool_is_window_sized():
    """O(window): a request whose horizon (20 + 8) runs past the window
    leases exactly window // block_size ring blocks, the engine reports
    the window, and the pool drains."""
    model, params = _model(SWA_CFG)
    eng = ServingEngine(model, params, slots=SLOTS, max_len=MAX_LEN,
                        chunk=CHUNK, prefill_mode="chunked", kv="paged",
                        kv_block_size=BLOCK)
    assert eng.stats()["kv_window"] == WINDOW
    assert isinstance(eng.caches.kv, A.PagedRingKVCache)
    assert eng.caches.kv.block_tables.shape[-1] == WINDOW // BLOCK
    req = Request(rid=0, prompt=np.random.default_rng(5).integers(
        0, CFG.vocab, 20).astype(np.int32), max_new_tokens=8)
    eng.submit(req)
    eng.step()
    assert eng.pool.stats()["blocks_in_use"] == WINDOW // BLOCK
    eng.run()
    assert req.done and len(req.generated) == 8
    assert eng.pool.stats()["blocks_in_use"] == 0


def test_mixed_pool_leases_both_kinds():
    """A decoding request of a mixed stack holds a classic lease for the
    horizon and a ring lease of window // block_size blocks, prefix
    sharing saves no prefill (``tokens_saved`` 0), and both drain; the
    engine installs the classic table on the global layer and the ring
    table on the sliding one."""
    model, params = _model(MIXED_CFG)
    eng = ServingEngine(model, params, slots=SLOTS, max_len=MAX_LEN,
                        chunk=CHUNK, prefill_mode="chunked", kv="paged",
                        kv_block_size=BLOCK)
    assert eng.stats()["kv_window"] == WINDOW
    assert isinstance(eng.pool, MixedKVPool)
    assert eng.pool.stats()["kind"] == "mixed"
    ring_c, cls_c = eng.caches
    assert isinstance(ring_c.kv, A.PagedRingKVCache)
    assert isinstance(cls_c.kv, A.PagedKVCache)
    req = Request(rid=0, prompt=np.random.default_rng(5).integers(
        0, CFG.vocab, 20).astype(np.int32), max_new_tokens=8)
    eng.submit(req)
    eng.step()
    st = eng.pool.stats()
    assert st["ring"]["blocks_in_use"] == WINDOW // BLOCK
    assert st["classic"]["blocks_in_use"] >= 1
    np.testing.assert_array_equal(ring_c.kv.block_tables[0].numpy(),
                                  eng.pool.ring_block_table(0))
    np.testing.assert_array_equal(cls_c.kv.block_tables[0].numpy(),
                                  eng.pool.block_table(0))
    eng.run()
    assert req.done and len(req.generated) == 8
    assert eng.pool.tokens_saved == 0
    st = eng.pool.stats()
    assert st["blocks_in_use"] == st["classic"]["blocks_in_use"] \
        == st["ring"]["blocks_in_use"] == 0


def test_mixed_pool_matches_reference_accounting():
    """The port's ``MixedKVPool`` and the reference's give the same leases,
    tables and stats through allocations, shared prompt prefixes, a
    refused admission and frees."""
    rng = np.random.default_rng(8)
    shared = rng.integers(0, 50, 16).astype(np.int32)
    prompts = [np.concatenate([shared, rng.integers(0, 50, n)
                               .astype(np.int32)]) for n in (3, 9, 1)]
    pools = [M(P(block_size=8, pool_blocks=12, max_blocks_per_seq=4),
               P(block_size=8, pool_blocks=4, max_blocks_per_seq=2), 16)
             for M, P in ((MixedKVPool, PoolConfig),
                          (JaxMixedKVPool, JaxPoolConfig))]
    for rid, p in enumerate(prompts):
        seen = []
        for pool in pools:
            ok = pool.can_admit(p, 32)
            got = pool.allocate(rid, p, 32) if ok else None
            if ok:
                pool.note_prefilled(rid, len(p))
                got = (got, pool.block_table(rid).tolist(),
                       pool.ring_block_table(rid).tolist())
            pool.check_invariants()
            seen.append((ok, got, pool.stats()))
        assert seen[0] == seen[1]
        assert seen[0][1] is None or seen[0][1][0][1] == 0
    for pool in pools:
        pool.free(0)
        pool.check_invariants()
    assert pools[0].stats() == pools[1].stats()


@pytest.mark.parametrize("jcfg", [SWA_CFG, MIXED_CFG, PATTERN_SWA_CFG],
                         ids=lambda c: c.name)
def test_spec_refused_for_sliding_and_pattern_stacks(jcfg):
    """Rollback cannot rewind a ring or a tuple cache: speculative
    decoding fails at construction, at submit, and in verify_step and
    rollback_cache_rows."""
    model, params = _model(jcfg)
    with pytest.raises(ValueError, match="speculative decoding"):
        ServingEngine(model, params, slots=SLOTS, max_len=MAX_LEN,
                      chunk=CHUNK, spec=SpecParams(mode="ngram", k=2))
    eng = ServingEngine(model, params, slots=SLOTS, max_len=MAX_LEN,
                        chunk=CHUNK, kv="paged", kv_block_size=BLOCK)
    with pytest.raises(ValueError, match="request 7: speculative"):
        eng.submit(Request(rid=7, prompt=np.arange(4, dtype=np.int32),
                           spec=SpecParams(mode="ngram", k=2)))
    with pytest.raises(NotImplementedError):
        model.verify_step(params, eng.caches,
                          torch.zeros((SLOTS, 2), dtype=torch.long),
                          torch.ones((SLOTS,), dtype=torch.int32))
    with pytest.raises(NotImplementedError):
        model.rollback_cache_rows(eng.caches,
                                  torch.zeros((SLOTS,), dtype=torch.int32),
                                  torch.ones((SLOTS,), dtype=torch.bool))


@pytest.mark.parametrize("options", [
    dict(sliding_window=16),
    dict(sliding_window=16, kv="paged"),
    dict(sliding_window=512, kv="paged", max_len=2048, slots=8),
    dict(sliding_window=512, kv_mixed=True, kv="paged", max_len=2048,
         slots=8),
    dict(sliding_window=16, kv_mixed=True, kv="paged", avg_prompt_len=40.0,
         decode_step_s=0.01, prefill_token_s=0.001),
    dict(sliding_window=24, kv_mixed=True, kv="paged", max_len=96),
    dict(sliding_window=300, kv="paged", max_len=256),
    dict(kv_mixed=True, sliding_window=64),
], ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_serve_schedule_matches_reference_for_window_and_mixed(options):
    """The planner's ``kv_growth``, ring geometry (``kv_window``,
    ``kv_ring_blocks``) and pool geometry equal the reference pass's for
    the window and mixed options."""
    opts = {"slots": 4, "max_len": 32, "replan_every": 32, **options}
    plans = []
    for pipe, graph in ((ref_pipeline, _proxy_graph("repro")),
                        (port_pipeline, _proxy_graph("repro_torch"))):
        _, report = pipe.optimize(graph, passes=("serve_schedule",),
                                  options=opts)
        plans.append(report.passes[-1].summary)
    keys = ("kv_growth", "chunk", "prefill_mode", "kv", "kv_block_size",
            "kv_pool_blocks", "kv_saving", "kv_window", "kv_ring_blocks",
            "kv_block_fallback")
    assert {k: plans[1].get(k) for k in keys} == \
        {k: plans[0].get(k) for k in keys}
    assert plans[1]["kv_growth"] == ("mixed" if options.get("kv_mixed")
                                     else "window")


def _proxy_graph(package):
    import importlib
    mod = importlib.import_module(f"{package}.serving.scheduler")
    return mod.serve_plan_graph("fuzz", 4, 64, 128, 96)


@pytest.mark.parametrize("jcfg,kv", [
    (SWA_CFG, "dense"), (SWA_CFG, "paged"), (MIXED_CFG, "dense"),
    (MIXED_CFG, "paged"), (CFG, "paged")],
    ids=["swa-dense", "swa-ring", "mixed-dense", "mixed-paged",
         "full-paged"])
def test_engine_kv_growth_and_geometry_match_reference(jcfg, kv):
    """An engine of each family reports the reference engine's
    ``kv_growth`` and, paged, its pool's kind, geometry and window."""
    model, params = _model(jcfg)
    jm = JaxModel(jcfg)
    kw = dict(slots=SLOTS, max_len=MAX_LEN, chunk=CHUNK,
              prefill_mode="chunked", kv=kv)
    port = ServingEngine(model, params, **kw).stats()
    ref = JaxEngine(jm, jm.init(jax.random.key(0)), **kw).stats()
    assert port["plan"]["kv_growth"] == ref["plan"]["kv_growth"]
    assert port.get("kv_window") == ref.get("kv_window")
    if kv == "paged":
        for k in ("kind", "pool_blocks", "block_size", "ring", "classic"):
            assert port["kv_pool"].get(k) == ref["kv_pool"].get(k), k


@pytest.mark.parametrize("jcfg", [SWA_CFG, MIXED_CFG], ids=lambda c: c.name)
@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_staged_step_matches_eager_over_ring_and_tuple_caches(jcfg, kv):
    """The staged serving step (``serving/graphs.py``: a CUDA graph on the
    card, the same body eagerly here) over ring and tuple caches ≡ the
    eager engine, sampled, with the zero-live warm-up's buffers: the same
    streams and the same ring positions at the end."""
    trace = make_trace(40_003, sampled=True)
    runs = []
    for graphed in (False, True):
        model, params = _model(jcfg)
        eng = _engine(model, params, trace, kv, graphed=graphed)
        reqs = [Request(rid=i, prompt=ev.prompt.copy(),
                        max_new_tokens=ev.max_new, sampling=ev.sampling)
                for i, ev in enumerate(trace.events)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        ring = [c.kv.positions.clone() for c in
                (eng.caches if type(eng.caches) is tuple else (eng.caches,))
                if hasattr(c.kv, "positions")]
        runs.append(([list(r.generated) for r in reqs], ring))
    assert runs[1][0] == runs[0][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
