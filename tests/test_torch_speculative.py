"""The port's speculative decoding against the reference and against its
own spec-off engine.

* The reference's ``tests/test_speculative.py`` cases replay on the
  port: the proposer and planner cases with their module globals swapped
  for the port's functions, the model and engine cases rewritten for
  torch tensors (rollback ≡ a cache that never saw the junk, bit for
  bit, dense and paged; partial rollback; ``k = 0``; unsupported models;
  ring-wrapping rejection; the draft proposer's oracle and resync; the
  replan adopting ``spec_k``).
* Port ≡ reference on reduced qwen3-1.7b (weights carried across):
  ``propose_ngram`` exactly on seeded random contexts, ``verify_step``
  logits at rtol 3e-4 / atol 3e-5 (dense and paged), and the grid
  samplers' tokens bit for bit on equal logits.
* Spec on ≡ off inside the port on ``tests/test_serving_fuzz.py``'s
  traces: greedy and sampled, dense and paged, n-gram and draft model.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_speculative as ref_spec_tests
from repro.configs.base import get_config as jax_get_config
from repro.kernels.fused_sampler.ops import \
    fused_sample_grid as jax_fused_sample_grid
from repro.models.model import Model as JaxModel
from repro.serving.sampling import sample_token_grid as jax_sample_token_grid
from repro.serving.speculative import propose_ngram as jax_propose_ngram
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.base import get_config
from repro_torch.convert import params_from_numpy
from repro_torch.core.pipeline import SERVE_SPEC_KS, _plan_spec_k
from repro_torch.kernels.fused_sampler.ops import fused_sample_grid
from repro_torch.models.model import Model
from repro_torch.serving import Request, SamplingParams, ServingEngine
from repro_torch.serving.sampling import sample_token_grid, sample_tokens
from repro_torch.serving.speculative import (SPEC_OFF, DraftModelProposer,
                                             SpecParams, SpecStats,
                                             propose_ngram)
from test_serving_fuzz import (BLOCK, CHUNK as FUZZ_CHUNK, DRAFT_CFG,
                               MAX_LEN as FUZZ_MAX_LEN, SLOTS as FUZZ_SLOTS,
                               SPEC_K_MAX, make_trace)
from test_serving_fuzz import CFG as FUZZ_CFG

#: the reference's tiny spec model and engine geometry
CFG = ModelConfig(**dataclasses.asdict(ref_spec_tests.CFG))
SLOTS, MAX_LEN, CHUNK = (ref_spec_tests.SLOTS, ref_spec_tests.MAX_LEN,
                         ref_spec_tests.CHUNK)
RTOL = dict(rtol=3e-4, atol=3e-5)


def _port_model(cfg, seed):
    m = Model(ModelConfig(**dataclasses.asdict(cfg)), device="cpu")
    return m, m.init(torch.Generator().manual_seed(seed))


@pytest.fixture(scope="module")
def tiny():
    return _port_model(CFG, 0)


# -- the reference's proposer and planner cases, replayed ----------------------

NGRAM_TESTS = sorted(n for n in vars(ref_spec_tests)
                     if n.startswith("test_ngram_"))


@pytest.mark.parametrize("name", NGRAM_TESTS + [
    "test_spec_params_validation",
    "test_plan_spec_k_unknown_rate_starts_midrange",
    "test_plan_spec_k_monotone_in_acceptance"])
def test_reference_case_on_port(name, monkeypatch):
    for attr, value in {"propose_ngram": propose_ngram,
                        "SpecParams": SpecParams, "SPEC_OFF": SPEC_OFF,
                        "_plan_spec_k": _plan_spec_k,
                        "SERVE_SPEC_KS": SERVE_SPEC_KS}.items():
        monkeypatch.setattr(ref_spec_tests, attr, value)
    getattr(ref_spec_tests, name)()


@pytest.mark.parametrize("grid", ["reference", "fused"])
def test_grid_keys_equal_sequential_keys(grid):
    """Position ``i`` of the verify grid draws with key ``(seed, emitted +
    i)``: the token a plain decode would sample after ``i`` more
    emissions (both grid samplers)."""
    vocab, B, K1 = 32, 3, 4
    rng = np.random.default_rng(2)
    logits = torch.from_numpy(rng.normal(0, 1, (B, K1, vocab))
                              .astype(np.float32))
    seeds = torch.tensor([11, 22, 33])
    steps = torch.tensor([0, 5, 9])
    temp = torch.full((B,), 0.9)
    top_k = torch.tensor([0, 8, 0], dtype=torch.int32)
    top_p = torch.tensor([1.0, 1.0, 0.9])
    fn = sample_token_grid if grid == "reference" else functools.partial(
        fused_sample_grid, backend="torch")
    got = fn(logits, seeds, steps, temp, top_k, top_p, vocab=vocab)
    for i in range(K1):
        seq = sample_tokens(logits[:, i], seeds, steps + i, temp, top_k,
                            top_p, vocab=vocab)
        assert torch.equal(got[:, i], seq)


# -- rollback == never-wrote-it -------------------------------------------------

def _fresh_caches(model, B, kv):
    if kv == "paged":
        M = MAX_LEN // 8
        c = model.init_paged_caches(B, pool_blocks=B * M + 2, block_size=8,
                                    max_blocks=M)
        # disjoint physical blocks per row, the same table on every layer
        bt = torch.arange(B * M, dtype=torch.int32).reshape(B, M)
        c.kv.block_tables.copy_(bt.expand_as(c.kv.block_tables))
        return c
    return model.init_caches(B, MAX_LEN)


def _prefill(model, params, caches, prompt):
    B, L = prompt.shape
    model.prefill_chunk(params, caches, torch.from_numpy(prompt),
                        torch.zeros((B,), dtype=torch.int32),
                        torch.full((B,), L, dtype=torch.int32))
    return caches


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_rollback_equals_fresh_cache_bitwise(tiny, kv):
    """Junk written by ``verify_step`` and rolled back leaves the next
    decode's logits bit-identical to a cache that never saw it."""
    model, params = tiny
    B, L = 2, 10
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, CFG.vocab, (B, L))
    clean = _prefill(model, params, _fresh_caches(model, B, kv), prompt)
    dirty = _prefill(model, params, _fresh_caches(model, B, kv), prompt)
    junk = torch.from_numpy(rng.integers(0, CFG.vocab, (B, 3)))
    model.verify_step(params, dirty, junk, torch.full((B,), 3))
    model.rollback_cache_rows(dirty, torch.full((B,), L),
                              torch.ones((B,), dtype=torch.bool))
    tok = torch.from_numpy(rng.integers(0, CFG.vocab, (B, 1)))
    live = torch.ones((B,), dtype=torch.bool)
    lc, _ = model.serve_step(params, clean, tok, live=live)
    ld, _ = model.serve_step(params, dirty, tok, live=live)
    assert torch.equal(lc, ld), f"{kv}: rollback left the cache different"


def test_partial_rollback_keeps_accepted_writes(tiny):
    """Rolling back only the rejected tail keeps the accepted positions
    bit-identical to feeding them one at a time through decode steps."""
    model, params = tiny
    B, L = 2, 8
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, CFG.vocab, (B, L))
    toks = torch.from_numpy(rng.integers(0, CFG.vocab, (B, 4)))
    ca = _prefill(model, params, model.init_caches(B, MAX_LEN), prompt)
    model.verify_step(params, ca, toks, torch.full((B,), 4))
    model.rollback_cache_rows(ca, torch.full((B,), L + 2),
                              torch.ones((B,), dtype=torch.bool))
    cb = _prefill(model, params, model.init_caches(B, MAX_LEN), prompt)
    live = torch.ones((B,), dtype=torch.bool)
    for i in range(2):
        model.serve_step(params, cb, toks[:, i:i + 1], live=live)
    probe = torch.from_numpy(rng.integers(0, CFG.vocab, (B, 1)))
    la, _ = model.serve_step(params, ca, probe, live=live)
    lb, _ = model.serve_step(params, cb, probe, live=live)
    assert torch.equal(la, lb)


# -- the engine ----------------------------------------------------------------

def _serve(model, params, reqs, **kw):
    eng = ServingEngine(model, params, slots=SLOTS, max_len=MAX_LEN,
                        chunk=CHUNK, prefill_mode="chunked",
                        replan_every=10_000, **kw)
    rs = [Request(rid=r.rid, prompt=np.asarray(r.prompt).copy(),
                  max_new_tokens=r.max_new_tokens, sampling=r.sampling,
                  spec=r.spec)
          for r in reqs]
    for r in rs:
        eng.submit(r)
    eng.run()
    return [list(r.generated) for r in rs], eng


def test_spec_k0_runs_plain_decode_path(tiny):
    """``k = 0`` takes the plain decode step: no verify, spec-off streams."""
    model, params = tiny
    rng = np.random.default_rng(5)
    reqs = [Request(rid=i, prompt=rng.integers(0, CFG.vocab, 10 + i)
                    .astype(np.int32), max_new_tokens=6,
                    sampling=SamplingParams(temperature=0.7, seed=i)
                    if i % 2 else None)
            for i in range(3)]
    base, _ = _serve(model, params, reqs)
    spec, eng = _serve(model, params, reqs,
                       spec=SpecParams(mode="ngram", k=0))
    assert spec == base
    assert eng.spec_stats == SpecStats()


@pytest.mark.parametrize("arch", ["gemma3-1b", "mamba2-370m", "hymba-1.5b"])
def test_spec_rejects_unsupported_models(tiny, arch):
    """Sliding, SSM and hybrid families cannot roll back; draft mode
    needs a draft model."""
    model, params = tiny
    with pytest.raises(ValueError, match="full-attention"):
        ServingEngine._check_spec_model(get_config(arch).reduced())
    with pytest.raises(ValueError, match="full-attention"):
        ServingEngine._check_spec_model(get_config(arch).reduced(), rid=3)
    with pytest.raises(ValueError, match="draft_model"):
        ServingEngine(model, params, slots=1, max_len=16, chunk=4,
                      spec=SpecParams(mode="draft"))
    eng = ServingEngine(model, params, slots=1, max_len=16, chunk=4)
    with pytest.raises(ValueError, match="no draft model"):
        eng.submit(Request(rid=0, prompt=np.arange(4, dtype=np.int32),
                           spec=SpecParams(mode="draft")))
    swa, _ = _port_model(CFG, 0)
    swa.cfg = dataclasses.replace(CFG, sliding_window=8)
    with pytest.raises(NotImplementedError, match="full-attention"):
        swa.verify_step(params, None, torch.zeros((1, 2), dtype=torch.long),
                        torch.ones((1,)))


def test_spec_dense_rejects_ring_wrapping_requests(tiny):
    """A speculative request past the dense ring's horizon is rejected at
    submit (rollback rewinds by absolute position); spec off still
    wraps."""
    model, params = tiny
    eng = ServingEngine(model, params, slots=1, max_len=16, chunk=4,
                        spec=SpecParams(mode="ngram", k=4))
    with pytest.raises(ValueError, match="horizon"):
        eng.submit(Request(rid=0, prompt=np.arange(12, dtype=np.int32),
                           max_new_tokens=8))
    eng2 = ServingEngine(model, params, slots=1, max_len=16, chunk=4)
    eng2.submit(Request(rid=0, prompt=np.arange(12, dtype=np.int32),
                        max_new_tokens=8))


def test_draft_vocab_must_match_target(tiny):
    model, params = tiny
    small = _port_model(dataclasses.replace(CFG, vocab=32), 1)
    with pytest.raises(ValueError, match="vocab"):
        ServingEngine(model, params, slots=1, max_len=16, chunk=4,
                      spec=SpecParams(mode="draft"), draft_model=small[0],
                      draft_params=small[1])


def test_draft_proposer_oracle_matches_target_greedy(tiny):
    """The target as its own draft proposes what the target picks: every
    draft is accepted and a verify emits several tokens."""
    model, params = tiny
    rng = np.random.default_rng(6)
    reqs = [Request(rid=i, prompt=rng.integers(0, CFG.vocab, 9 + 3 * i)
                    .astype(np.int32), max_new_tokens=8)
            for i in range(2)]
    base, _ = _serve(model, params, reqs)
    spec, eng = _serve(model, params, reqs,
                       spec=SpecParams(mode="draft", k=4),
                       draft_model=model, draft_params=params)
    assert spec == base
    s = eng.spec_stats
    assert s.drafts_proposed > 0
    assert s.drafts_accepted == s.drafts_proposed
    assert s.spec_tokens > s.verify_calls


def test_draft_proposer_resyncs_after_slot_reuse(tiny):
    """A slot changing hands resets and re-feeds the proposer's row; its
    proposals equal a fresh proposer's on the same contexts."""
    model, params = tiny
    proposer = DraftModelProposer(model, params, slots=1, max_len=MAX_LEN,
                                  feed_chunk=4)
    rng = np.random.default_rng(7)
    ctx_a = rng.integers(0, CFG.vocab, 11).astype(np.int64)
    ctx_b = rng.integers(0, CFG.vocab, 7).astype(np.int64)
    d1 = proposer.propose([(0, 1, ctx_a, 3)])[0]
    grown = np.concatenate([ctx_a, d1.astype(np.int64)[:2]])
    d2 = proposer.propose([(0, 1, grown, 3)])[0]
    d3 = proposer.propose([(0, 2, ctx_b, 3)])[0]
    fresh = DraftModelProposer(model, params, slots=1, max_len=MAX_LEN)
    assert fresh.propose([(0, 1, ctx_a, 3)])[0].tolist() == d1.tolist()
    assert fresh.propose([(0, 1, grown, 3)])[0].tolist() == d2.tolist()
    assert fresh.propose([(0, 2, ctx_b, 3)])[0].tolist() == d3.tolist()


def test_engine_replan_adopts_spec_k(tiny):
    """A speculative engine's replan feeds its acceptance rate to
    serve_schedule and adopts the planned draft length."""
    model, params = tiny
    eng = ServingEngine(model, params, slots=SLOTS, max_len=MAX_LEN,
                        chunk=CHUNK, prefill_mode="chunked",
                        replan_every=4, spec=SpecParams(mode="ngram"))
    rng = np.random.default_rng(8)
    for i in range(3):
        eng.submit(Request(rid=i, prompt=rng.integers(0, CFG.vocab, 10)
                           .astype(np.int32), max_new_tokens=8))
    eng.run()
    assert eng.scheduler.cfg.spec_k in SERVE_SPEC_KS
    plan = eng.scheduler.last_plan
    assert plan.get("spec") == "ngram"
    assert plan["spec_k"] == _plan_spec_k(plan["spec_accept_rate"])
    assert eng.stats()["spec"]["verify_calls"] == eng.spec_stats.verify_calls


# -- port == reference ------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
def test_propose_ngram_matches_reference(seed):
    """Seeded random contexts over small vocabularies (so suffixes
    recur): every draft equals the reference's."""
    rng = np.random.default_rng(seed)
    for _ in range(200):
        ctx = rng.integers(0, int(rng.integers(2, 9)),
                           int(rng.integers(0, 40))).astype(np.int32)
        k = int(rng.integers(0, 7))
        lo = int(rng.integers(1, 4))
        hi = int(rng.integers(lo, 6))
        got = propose_ngram(ctx, k, max_ngram=hi, min_ngram=lo)
        want = jax_propose_ngram(ctx, k, max_ngram=hi, min_ngram=lo)
        assert got.dtype == want.dtype and got.tolist() == want.tolist()


@functools.lru_cache(maxsize=None)
def _qwen_pair():
    jcfg = jax_get_config("qwen3-1.7b").reduced()
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.key(0))
    tm = Model(ModelConfig(**dataclasses.asdict(jcfg)), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_verify_step_matches_reference(kv):
    """Reduced qwen3, weights carried across: prefill ragged prompts,
    then verify ragged drafts (one bystander row); the logits of every
    scored position match at rtol 3e-4 / atol 3e-5, and the caches'
    lengths agree."""
    jm, jp, tm, tp = _qwen_pair()
    vocab = tm.cfg.vocab
    B, K1, W, bs = 3, 4, 64, 8
    rng = np.random.default_rng(9)
    lens = np.array([9, 14, 6], np.int32)
    prompt = np.zeros((B, int(lens.max())), np.int32)
    for b, n in enumerate(lens):
        prompt[b, :n] = rng.integers(0, vocab, n)
    toks = rng.integers(0, vocab, (B, K1)).astype(np.int32)
    n_new = np.array([4, 0, 2], np.int32)
    offsets = np.zeros((B,), np.int32)
    if kv == "paged":
        M = W // bs
        bt = np.arange(B * M, dtype=np.int32).reshape(B, M)
        jc = jm.init_paged_caches(B, pool_blocks=B * M, block_size=bs,
                                  max_blocks=M)
        jc = jc._replace(kv=jc.kv._replace(block_tables=jnp.broadcast_to(
            jnp.asarray(bt), jc.kv.block_tables.shape)))
        tc = tm.init_paged_caches(B, pool_blocks=B * M, block_size=bs,
                                  max_blocks=M)
        tc.kv.block_tables.copy_(torch.from_numpy(bt).expand_as(
            tc.kv.block_tables))
    else:
        jc = jm.init_caches(B, W)
        tc = tm.init_caches(B, W)
    _, jc = jm.prefill_chunk(jp, jc, jnp.asarray(prompt),
                             jnp.asarray(offsets), jnp.asarray(lens))
    tm.prefill_chunk(tp, tc, torch.from_numpy(prompt).long(),
                     torch.from_numpy(offsets), torch.from_numpy(lens))
    jl, jc = jm.verify_step(jp, jc, jnp.asarray(toks), jnp.asarray(n_new))
    tl, tc = tm.verify_step(tp, tc, torch.from_numpy(toks).long(),
                            torch.from_numpy(n_new))
    jl = np.asarray(jl)
    assert tl.shape == jl.shape
    for b in range(B):
        np.testing.assert_allclose(tl[b, :n_new[b]].numpy(),
                                   jl[b, :n_new[b]], **RTOL)
    np.testing.assert_array_equal(tc.kv.length.numpy(),
                                  np.asarray(jc.kv.length))


@pytest.mark.parametrize("sampler", ["reference", "fused"])
def test_grid_samplers_match_reference(sampler):
    """Equal logits, mixed per-row policies (greedy, top-k, top-p, both):
    the port's grid tokens equal the reference's bit for bit."""
    B, K1, V, vocab = 6, 5, 160, 150
    rng = np.random.default_rng(10)
    logits = rng.normal(0, 2, (B, K1, V)).astype(np.float32)
    seeds = np.array([0, 7, 99, 12345, 2 ** 31 + 5, 42], np.uint32)
    steps = np.array([0, 3, 11, 1, 64, 5], np.int32)
    temps = np.array([0.0, 0.8, 1.0, 0.5, 1.3, 0.8], np.float32)
    ks = np.array([0, 50, 0, 8, 3, 20], np.int32)
    ps = np.array([1.0, 0.95, 0.9, 1.0, 0.5, 0.8], np.float32)
    jargs = [jnp.asarray(a) for a in (logits, seeds, steps, temps, ks, ps)]
    targs = [torch.from_numpy(a.astype(np.int64) if a.dtype == np.uint32
                              else a)
             for a in (logits, seeds, steps, temps, ks, ps)]
    if sampler == "reference":
        want = jax_sample_token_grid(*jargs, vocab=vocab)
        got = sample_token_grid(*targs, vocab=vocab)
    else:
        want = jax_fused_sample_grid(*jargs, vocab=vocab, backend="jnp")
        got = fused_sample_grid(*targs, vocab=vocab, backend="torch")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- spec on == off on the fuzz traces ---------------------------------------------

@functools.lru_cache(maxsize=None)
def _fuzz_models():
    return _port_model(FUZZ_CFG, 0), _port_model(DRAFT_CFG, 7)


def _run_trace(trace, kv, spec=None, draft=None, graphed=True):
    (model, params), _ = _fuzz_models()
    kw = {}
    if spec is not None:
        kw = dict(spec=spec, spec_k_max=SPEC_K_MAX)
        if draft is not None:
            kw.update(draft_model=draft[0], draft_params=draft[1])
    eng = ServingEngine(model, params, slots=FUZZ_SLOTS,
                        max_len=FUZZ_MAX_LEN, chunk=FUZZ_CHUNK,
                        prefill_mode="chunked", replan_every=10_000,
                        eos_id=trace.eos_id, kv=kv,
                        kv_block_size=BLOCK if kv == "paged" else None,
                        kv_pool_blocks=trace.pool_blocks
                        if kv == "paged" else None, graphed=graphed, **kw)
    reqs = []
    for rid, ev in enumerate(trace.events):
        for _ in range(ev.gap):
            eng.step()
            if eng.pool is not None:
                eng.pool.check_invariants()
        req = Request(rid=rid, prompt=ev.prompt.copy(),
                      max_new_tokens=ev.max_new, priority=ev.priority,
                      sampling=ev.sampling)
        eng.submit(req)
        reqs.append(req)
    steps = 0
    while eng.scheduler.pending() and steps < 3000:
        eng.step()
        steps += 1
        if eng.pool is not None:
            eng.pool.check_invariants()
    assert all(r.done for r in reqs)
    if eng.pool is not None:
        assert eng.pool.stats()["blocks_in_use"] == 0
    return [list(r.generated) for r in reqs], eng


@functools.lru_cache(maxsize=None)
def _baseline(seed, sampled):
    return _run_trace(make_trace(seed, sampled), "dense", graphed=False)[0]


@pytest.mark.parametrize("mode", ["ngram", "draft"])
@pytest.mark.parametrize("kv", ["dense", "paged"])
@pytest.mark.parametrize("seed,sampled", [(0, False), (3, False),
                                          (10_001, True), (10_006, True)])
def test_spec_matches_spec_off_on_fuzz_traces(seed, sampled, kv, mode):
    """Spec replays (aggressive n-gram lookup, or a small draft model from
    another seed: mostly rejected drafts) emit the eager spec-off dense
    streams bit for bit."""
    _, draft = _fuzz_models()
    spec = SpecParams(mode=mode, k=3, min_ngram=1)
    got, eng = _run_trace(make_trace(seed, sampled), kv, spec=spec,
                          draft=draft if mode == "draft" else None)
    assert got == _baseline(seed, sampled)
    assert eng.spec_stats.verify_calls > 0


def test_mixed_per_request_spec_matches_reference():
    """With the reference's weights the port reproduces the reference
    engine on its mixed per-request scenario: the same streams, spec on
    and off, and the same counters (5 drafts proposed, 5 accepted: the
    n-gram row never drafts, which is why the reference's own test,
    requiring a rejection, fails)."""
    from repro.serving import Request as JaxRequest
    from repro.serving import ServingEngine as JaxEngine
    from repro.serving import SamplingParams as JaxSampling
    from repro.serving import SpecParams as JaxSpec
    from test_serving_fuzz import CFG as JCFG
    jm = JaxModel(JCFG)
    jp = jm.init(jax.random.key(0))
    tm = Model(ModelConfig(**dataclasses.asdict(JCFG)), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, JCFG.vocab, n).astype(np.int32)
               for n in (12, 17, 8)]
    out = []
    for model, params, Eng, Req, Spec, Samp in (
            (jm, jp, JaxEngine, JaxRequest, JaxSpec, JaxSampling),
            (tm, tp, ServingEngine, Request, SpecParams, SamplingParams)):
        specs = [Spec(mode="off", k=0), Spec(mode="draft", k=4),
                 Spec(mode="ngram", k=2, min_ngram=1)]
        samplings = [None, None, Samp(temperature=0.8, top_k=12, seed=99)]
        eng = Eng(model, params, slots=FUZZ_SLOTS, max_len=FUZZ_MAX_LEN,
                  chunk=FUZZ_CHUNK, prefill_mode="chunked",
                  replan_every=10_000, spec_k_max=SPEC_K_MAX,
                  draft_model=model, draft_params=params)
        reqs = [Req(rid=i, prompt=p.copy(), max_new_tokens=8,
                    sampling=samplings[i], spec=specs[i])
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        s = eng.spec_stats
        out.append(([list(r.generated) for r in reqs],
                    (s.drafts_proposed, s.drafts_accepted, s.verify_calls,
                     s.verify_positions, s.spec_tokens)))
    assert out[1] == out[0]
    assert out[1][1][:2] == (5, 5)


def test_mixed_per_request_spec_matches_spec_off():
    """The reference's mixed per-request scenario (spec off, an oracle
    draft model, a sampled n-gram row) on both layouts equals the port's
    own spec-off run; the oracle's drafts are accepted.  (The reference
    also requires a rejected draft there and fails: its n-gram row never
    drafts — ROADMAP queue 3.)"""
    (model, params), _ = _fuzz_models()
    rng = np.random.default_rng(42)
    prompts = [rng.integers(0, FUZZ_CFG.vocab, n).astype(np.int32)
               for n in (12, 17, 8)]
    specs = [SpecParams(mode="off", k=0), SpecParams(mode="draft", k=4),
             SpecParams(mode="ngram", k=2, min_ngram=1)]
    samplings = [None, None,
                 SamplingParams(temperature=0.8, top_k=12, seed=99)]

    def run(kv, with_spec):
        eng = ServingEngine(model, params, slots=FUZZ_SLOTS,
                            max_len=FUZZ_MAX_LEN, chunk=FUZZ_CHUNK,
                            prefill_mode="chunked", replan_every=10_000,
                            kv=kv,
                            kv_block_size=BLOCK if kv == "paged" else None,
                            kv_pool_blocks=16 if kv == "paged" else None,
                            spec_k_max=SPEC_K_MAX, draft_model=model,
                            draft_params=params)
        reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=8,
                        sampling=samplings[i],
                        spec=specs[i] if with_spec else None)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        while eng.scheduler.pending():
            eng.step()
            if eng.pool is not None:
                eng.pool.check_invariants()
        return [list(r.generated) for r in reqs], eng.spec_stats

    baseline, _ = run("dense", with_spec=False)
    for kv in ("dense", "paged"):
        got, stats = run(kv, with_spec=True)
        assert got == baseline, f"mixed-spec divergence on {kv}"
        assert 0 < stats.drafts_accepted <= stats.drafts_proposed
