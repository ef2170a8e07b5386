"""The port's serving stack over the recurrent cache families.

The planner, the kernel plan and the engine for ``ssm`` (mamba2) and
``hybrid`` (hymba) stacks against the reference, and the port's own
oracles on ``tests/test_serving_fuzz.py``'s constant-state traces
(``SSM_CFG`` / ``HYBRID_CFG``, ``make_trace``):

* ``serve_schedule``'s ``constant_state`` option (``kv_growth:
  "constant"``, ahead of window and mixed) and the engines' plans equal
  the reference's; ``KernelPlan.ssm_scan`` is ``"torch"`` and nothing
  else; paged KV, padded-batch prefill and speculative decoding are
  refused as the reference refuses them; the one-shot modes batch
  equal-length prompts;
* batched ≡ solo, chunked ≡ one-shot batched (serving chunk =
  ``ssm_chunk``) and preempt-and-restore ≡ solo, on the token streams
  (the reference's oracles, kept fast here: the reference marks its
  batched ≡ solo sweep slow);
* the staged serving step (``serving/graphs.py``: a CUDA graph on the
  card, the same body eagerly here) ≡ the eager engine over SSM caches,
  the graph key reaches the SSM leaves, and a zero-live step (a capture's
  warm-up) moves no bit of any state or register.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.core import pipeline as ref_pipeline
from repro.models.model import Model as JaxModel
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core import pipeline as port_pipeline
from repro_torch.launch import serve as serve_launch
from repro_torch.models import ssm as S
from repro_torch.models import transformer as T
from repro_torch.models.model import Model
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.graphs import tensor_key
from repro_torch.serving.speculative import SpecParams

from test_serving_fuzz import (CHUNK, HYBRID_CFG, MAX_LEN, SLOTS, SSM_CFG,
                               Trace, make_trace)

FAMILIES = {"ssm": SSM_CFG, "hybrid": HYBRID_CFG}
_MODELS: dict = {}


def _model(name):
    """The port's model of a fuzz config, weights from one seed."""
    if name not in _MODELS:
        m = Model(ModelConfig(**dataclasses.asdict(FAMILIES[name])),
                  device="cpu")
        _MODELS[name] = (m, m.init(torch.Generator().manual_seed(0)))
    return _MODELS[name]


def _engine(name, slots=SLOTS, eos_id=-1, **kw):
    model, params = _model(name)
    kw.setdefault("prefill_mode", "chunked")
    return ServingEngine(model, params, slots=slots, max_len=MAX_LEN,
                         chunk=CHUNK, replan_every=10_000, eos_id=eos_id,
                         **kw)


def run_trace(name, trace, slots=SLOTS, **kw):
    """``test_serving_fuzz.run_trace`` on the port (dense KV): the
    streams."""
    eng = _engine(name, slots, trace.eos_id, **kw)
    reqs = []
    for rid, ev in enumerate(trace.events):
        for _ in range(ev.gap):
            eng.step()
        req = Request(rid=rid, prompt=ev.prompt.copy(),
                      max_new_tokens=ev.max_new, priority=ev.priority,
                      sampling=ev.sampling)
        eng.submit(req)
        reqs.append(req)
    for _ in range(3000):
        if not eng.scheduler.pending():
            break
        eng.step()
    assert not eng.scheduler.pending() and all(r.done for r in reqs)
    return [list(r.generated) for r in reqs]


# -- the planner, the kernel plan and the engine against the reference ---------

def _proxy_graph(package):
    import importlib
    mod = importlib.import_module(f"{package}.serving.scheduler")
    return mod.serve_plan_graph("fuzz", 4, 64, 128, 96)


@pytest.mark.parametrize("options", [
    dict(constant_state=True),
    dict(constant_state=True, sliding_window=16),
    dict(constant_state=True, kv_mixed=True, sliding_window=16),
    dict(constant_state=True, decode_step_s=0.01, prefill_token_s=0.001,
         avg_prompt_len=40.0),
], ids=lambda o: "-".join(f"{k}={v}" for k, v in o.items()))
def test_serve_schedule_constant_state_matches_reference(options):
    """``constant_state`` reads ``kv_growth: "constant"`` ahead of the
    window and mixed options, and leaves the rest of the plan as the
    reference's."""
    opts = {"slots": 4, "max_len": 32, "replan_every": 32, **options}
    plans = []
    for pipe, graph in ((ref_pipeline, _proxy_graph("repro")),
                        (port_pipeline, _proxy_graph("repro_torch"))):
        _, report = pipe.optimize(graph, passes=("serve_schedule",),
                                  options=opts)
        plans.append(report.passes[-1].summary)
    keys = ("kv_growth", "chunk", "prefill_mode", "admit", "preempt",
            "replan_every")
    assert {k: plans[1].get(k) for k in keys} == \
        {k: plans[0].get(k) for k in keys}
    assert plans[1]["kv_growth"] == "constant"


def test_ssm_scan_site_is_torch_only():
    """The reference's ``ssm_scan`` site, its ``xla`` become ``torch``:
    the default and the routed plan on either device; any other backend
    raises."""
    assert port_pipeline.KERNEL_SITE_BACKENDS["ssm_scan"] == ("torch",)
    assert set(port_pipeline.KERNEL_SITE_BACKENDS) - {"split_matmul"} \
        == set(ref_pipeline.KERNEL_SITE_BACKENDS)
    assert port_pipeline.KernelPlan().ssm_scan == "torch"
    for acc in ("cpu", "cuda"):
        plan, _ = port_pipeline.select_kernel_plan({"accelerator": acc})
        assert plan.ssm_scan == "torch"
    for bad in ("xla", "cuda"):
        with pytest.raises(port_pipeline.PipelineError, match="ssm_scan"):
            port_pipeline.KernelPlan(ssm_scan=bad)


@pytest.mark.parametrize("name", ["ssm", "hybrid"])
def test_engine_plan_matches_reference(name):
    """An engine reports the reference engine's ``kv_growth``
    ("constant") and window, before and after a replan, and its plan
    routes the SSD scan to torch."""
    model, params = _model(name)
    jm = JaxModel(FAMILIES[name])
    kw = dict(slots=SLOTS, max_len=MAX_LEN, chunk=CHUNK,
              prefill_mode="chunked")
    port = ServingEngine(model, params, replan_every=1, **kw)
    ref = JaxEngine(jm, jm.init(jax.random.key(0)), **kw).stats()
    assert port.stats()["plan"]["kv_growth"] == \
        ref["plan"]["kv_growth"] == "constant"
    assert port.stats().get("kv_window") == ref.get("kv_window")
    assert port.scheduler.constant_state
    assert port.kernel_plan.ssm_scan == "torch"
    port.submit(Request(rid=0, prompt=np.arange(6, dtype=np.int32),
                        max_new_tokens=2))
    port.run()
    assert port.scheduler.last_report is not None
    assert port.stats()["plan"]["kv_growth"] == "constant"


@pytest.mark.parametrize("name", ["ssm", "hybrid"])
def test_paged_kv_is_refused_with_the_reference_error(name):
    model, params = _model(name)
    jm = JaxModel(FAMILIES[name])
    kw = dict(slots=SLOTS, max_len=MAX_LEN, chunk=CHUNK,
              prefill_mode="chunked", kv="paged")
    with pytest.raises(ValueError) as ref:
        JaxEngine(jm, jm.init(jax.random.key(0)), **kw)
    with pytest.raises(ValueError) as port:
        ServingEngine(model, params, **kw)
    assert str(port.value) == str(ref.value)
    assert "constant-state layers hold no pageable KV" in str(port.value)


@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-370m"])
def test_serve_launcher_refuses_paged_kv(arch):
    with pytest.raises(ValueError, match="no pageable KV"):
        serve_launch.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--kv", "paged"])


@pytest.mark.parametrize("arch", ["mamba2-370m", "hymba-1.5b"])
def test_padded_prefill_rejected_for_recurrent_families(arch):
    """The reference's ``test_padded_prefill_rejected_for_recurrent_
    families`` on the port."""
    m = Model(get_config(arch).reduced(), device="cpu")
    with pytest.raises(NotImplementedError, match="padded tail"):
        m.prefill_step(m.init(torch.Generator().manual_seed(0)),
                       {"tokens": torch.zeros((2, 8), dtype=torch.long),
                        "lengths": torch.tensor([4, 8], dtype=torch.int32)})


@pytest.mark.parametrize("name", ["ssm", "hybrid"])
def test_one_shot_admission_groups_equal_length_prompts(name):
    """The batched mode prefills each equal-length group in one call, no
    padded ``lengths``; the streams equal the chunked engine's."""
    eng = _engine(name, slots=4, prefill_mode="batched")
    calls = []
    prefill = eng._prefill

    def spy(params, batch):
        calls.append((tuple(batch["tokens"].shape), "lengths" in batch))
        return prefill(params, batch)
    eng._prefill = spy
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 96, n).astype(np.int32) for n in (5, 7, 5, 7)]
    streams = []
    for e in (eng, _engine(name, slots=4)):
        reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=3)
                for i, p in enumerate(prompts)]
        for r in reqs:
            e.submit(r)
        e.run()
        streams.append([list(r.generated) for r in reqs])
    assert sorted(calls) == [((2, 5), False), ((2, 7), False)]
    assert streams[0] == streams[1]


@pytest.mark.parametrize("name", ["ssm", "hybrid"])
def test_speculative_decoding_is_refused(name):
    """The reference's ``test_spec_rejected_for_non_full_families`` on
    the port, and the model's verify and rollback paths."""
    model, params = _model(name)
    with pytest.raises(ValueError, match="speculative decoding"):
        _engine(name, spec=SpecParams(mode="ngram", k=2))
    eng = _engine(name)
    req = Request(rid=7, prompt=np.arange(4, dtype=np.int32),
                  max_new_tokens=2, spec=SpecParams(mode="ngram", k=2))
    with pytest.raises(ValueError, match="request 7: speculative decoding"):
        eng.submit(req)
    caches = model.init_caches(SLOTS, MAX_LEN)
    with pytest.raises(NotImplementedError):
        model.verify_step(params, caches, torch.zeros((SLOTS, 2),
                                                      dtype=torch.long),
                          torch.full((SLOTS,), 2, dtype=torch.int32))
    with pytest.raises(NotImplementedError):
        model.rollback_cache_rows(caches,
                                  torch.zeros((SLOTS,), dtype=torch.int32),
                                  torch.ones((SLOTS,), dtype=torch.bool))


def test_cache_layout_views_and_bytes():
    """mamba2's stacked cache holds SSM state alone (``kv`` is ()), its
    per-layer views share the stack's storage, the graph key reaches the
    state and register, and ``cache_bytes`` counts them."""
    model = Model(get_config("mamba2-370m").reduced(), device="cpu")
    eng = ServingEngine(model, model.init(torch.Generator().manual_seed(0)),
                        slots=SLOTS, max_len=MAX_LEN, chunk=CHUNK)
    caches = eng.caches
    cfg = model.cfg
    assert caches.kv == () and isinstance(caches.ssm, S.SSMCache)
    assert caches.ssm.state.shape == (cfg.n_layers, SLOTS, cfg.ssm_heads,
                                      cfg.ssm_head_dim, cfg.ssm_state)
    assert caches.ssm.state.dtype == torch.float32
    views = T.layer_views(caches, cfg.n_layers)
    assert views[1].kv == ()
    assert views[1].ssm.conv.data_ptr() == caches.ssm.conv[1].data_ptr()
    ptrs = {k[0] for k in tensor_key(caches)}
    assert {caches.ssm.state.data_ptr(), caches.ssm.conv.data_ptr()} <= ptrs
    assert eng.stats()["cache_bytes"] == {
        "ssm_state": caches.ssm.state.numel() * 4,
        "ssm_conv": caches.ssm.conv.numel() * 4}
    hyb = _engine("hybrid")
    assert set(hyb.stats()["cache_bytes"]) == {"KVCache", "ssm_state",
                                               "ssm_conv"}


# -- the port's oracles on the constant-state traces ----------------------------

@pytest.mark.parametrize("seed,sampled", [(50_000, False), (50_001, True)])
@pytest.mark.parametrize("name", ["ssm", "hybrid"])
def test_batched_matches_solo_on_traces(name, seed, sampled):
    """The reference's ``test_constant_state_trace_equivalence`` on the
    port: every request of a fuzzed trace (gaps, priorities and
    preemption, EOS) replayed alone in a 1-slot engine emits the batched
    engine's stream."""
    trace = make_trace(seed, sampled=sampled)
    batched = run_trace(name, trace)
    for rid, ev in enumerate(trace.events):
        solo = Trace(events=[dataclasses.replace(ev, gap=0, priority=0)],
                     eos_id=trace.eos_id, pool_blocks=trace.pool_blocks)
        assert run_trace(name, solo, slots=1)[0] == batched[rid], rid


@pytest.mark.parametrize("seed", [60_001, 60_002])
@pytest.mark.parametrize("name", ["ssm", "hybrid"])
def test_chunked_matches_one_shot_batched(name, seed):
    """The reference's ``test_constant_state_chunked_prefill_matches_
    batched`` on the port: serving chunk = ``ssm_chunk``, so every chunk
    is one SSD chunk of the one-shot scan."""
    assert FAMILIES[name].ssm_chunk == CHUNK
    trace = make_trace(seed, sampled=False)
    assert run_trace(name, trace, prefill_mode="batched") == \
        run_trace(name, trace)


@pytest.mark.parametrize("name", ["ssm", "hybrid"])
def test_preempt_and_restore_matches_solo(name):
    """A request preempted in decode restores by re-prefilling its folded
    context into a zeroed state and emits its solo stream (the hybrid's
    window wraps: context 20 + decode past window 16)."""
    rng = np.random.default_rng(33)
    prompt = rng.integers(0, 96, 20).astype(np.int32)
    eng = _engine(name, slots=1)
    eng.scheduler.cfg.preempt = 1  # a 1-slot engine defaults to 0
    low = Request(rid=0, prompt=prompt.copy(), max_new_tokens=8)
    eng.submit(low)
    for _ in range(8):       # 5 prefill ticks (20 at chunk 4), then decode
        eng.step()
    assert len(low.generated) >= 1 and not low.done
    vip = Request(rid=1, prompt=rng.integers(0, 96, 6).astype(np.int32),
                  max_new_tokens=2, priority=5)
    eng.submit(vip)
    eng.run()
    assert eng.scheduler.preempted == 1 and low.done and vip.done
    solo = Request(rid=0, prompt=prompt.copy(), max_new_tokens=8)
    ref = _engine(name, slots=1)
    ref.submit(solo)
    ref.run()
    assert list(solo.generated) == list(low.generated)


@pytest.mark.parametrize("name", ["ssm", "hybrid"])
def test_staged_step_matches_eager_over_ssm_caches(name):
    """The staged step ≡ the eager engine, sampled, on a trace with
    preemption: the same streams and the same SSM state at the end; a
    zero-live step moves no bit of any cache leaf."""
    trace = make_trace(50_003, sampled=True)
    runs = []
    for graphed in (False, True):
        eng = _engine(name, graphed=graphed)
        reqs = [Request(rid=i, prompt=ev.prompt.copy(),
                        max_new_tokens=ev.max_new, sampling=ev.sampling,
                        priority=ev.priority)
                for i, ev in enumerate(trace.events)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        runs.append(([list(r.generated) for r in reqs],
                     [t.clone() for t in eng.caches.ssm], eng))
    assert runs[1][0] == runs[0][0]
    for a, b in zip(runs[0][1], runs[1][1]):
        assert torch.equal(a, b)
    eng = runs[1][2]
    before = [t.clone() for t in tensor_leaves(eng.caches)]
    eng._serve(eng.params, eng.caches,
               torch.ones((SLOTS, 1), dtype=torch.long),
               torch.zeros((SLOTS,), dtype=torch.bool))
    assert all(torch.equal(a, b)
               for a, b in zip(before, tensor_leaves(eng.caches)))


def tensor_leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for v in tree for t in tensor_leaves(v)]
