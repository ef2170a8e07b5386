"""The port's serving host modules and engine against the reference.

* The reference's pool and scheduler tests replay on the port's modules
  (their module globals swapped for the port's classes).
* The port engine and the reference engine serve the same
  ``make_trace`` traces (``tests/test_serving_fuzz.py``) in lockstep with
  ``replan_every=10_000``: the same admissions and preemptions tick by
  tick, the same greedy streams, and ``check_invariants`` on every tick.
"""
import dataclasses
import inspect

import jax
import numpy as np
import pytest

import test_kv_pool as ref_pool_tests
import test_serving_scheduler as ref_sched_tests
from repro.models.model import Model as JaxModel
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import pipeline as port_pipeline
from repro_torch.models.model import Model
from repro_torch.serving import Request, ServingEngine, kv_pool as port_pool
from repro_torch.serving import scheduler as port_sched
from test_serving_fuzz import BLOCK, CFG, CHUNK, MAX_LEN, SLOTS, make_trace

POOL_TESTS = sorted(n for n, f in vars(ref_pool_tests).items()
                    if n.startswith("test_") and callable(f))

#: the reference scheduler tests that drive no model: scheduler policy and
#: serve_schedule planning
SCHED_TESTS = [
    "test_batch_admission_fills_all_free_slots_in_one_tick",
    "test_chunk_budget_caps_per_tick_prefill",
    "test_fifo_admission_under_oversubscription",
    "test_priority_admission_overtakes_fifo",
    "test_preemption_evicts_lowest_priority_decode_slot",
    "test_preemption_respects_per_tick_bound_and_equal_priority",
    "test_no_preemption_while_a_free_slot_remains",
    "test_mid_prefill_preemption_recomputes_chunk_budget",
    "test_kv_gate_defers_admission_and_counts_victim_blocks",
    "test_release_hook_fires_on_retire_and_preempt",
    "test_zero_budget_request_retires_without_a_slot",
    "test_emit_never_exceeds_token_budget",
    "test_empty_prompt_rejected_at_submit",
    "test_serve_schedule_plan_roundtrips_through_optimize",
    "test_scheduler_replan_adopts_plan_and_hits_cache",
    "test_serve_schedule_plans_prefill_mode_and_preempt_bound",
    "test_serve_schedule_plans_paged_pool_geometry",
    "test_kv_block_fallback_surfaced_in_pass_report",
    "test_scheduler_adopts_admit_preempt_and_replan_fields",
    "test_scheduler_prefill_mode_adoption_is_gated",
]


def _replay(module, name, monkeypatch, swaps):
    for attr, value in swaps.items():
        monkeypatch.setattr(module, attr, value)
    fn = getattr(module, name)
    if inspect.signature(fn).parameters:
        fn(monkeypatch)
    else:
        fn()


@pytest.mark.parametrize("name", POOL_TESTS)
def test_reference_pool_case_on_port(name, monkeypatch):
    _replay(ref_pool_tests, name, monkeypatch, {
        "kv_pool": port_pool, "KVBlockPool": port_pool.KVBlockPool,
        "PoolConfig": port_pool.PoolConfig, "PoolError": port_pool.PoolError})


@pytest.mark.parametrize("name", SCHED_TESTS)
def test_reference_scheduler_case_on_port(name, monkeypatch):
    _replay(ref_sched_tests, name, monkeypatch, {
        "pipeline": port_pipeline, "Scheduler": port_sched.Scheduler,
        "SchedulerConfig": port_sched.SchedulerConfig,
        "RequestState": port_sched.RequestState, "Request": Request,
        "serve_plan_graph": port_sched.serve_plan_graph})


# -- the engines in lockstep ---------------------------------------------------

@pytest.fixture(scope="module")
def engines_pair():
    jm = JaxModel(CFG)
    jp = jm.init(jax.random.key(0))
    tm = Model(ModelConfig(**dataclasses.asdict(CFG)), device="cpu")
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jm, jp, tm, tp


def _snapshot(eng):
    s = eng.scheduler
    return ([(x.req.rid, x.slot, x.state.value, x.pos)
             for x in s.active if x is not None],
            [x.req.rid for x in s.waiting], s.preempted,
            [x.req.rid for x in s.retired])


def _lockstep(pair, trace, kv):
    jm, jp, tm, tp = pair
    engines, reqs = [], []
    for model, params, Eng, Req in ((jm, jp, JaxEngine, JaxRequest),
                                    (tm, tp, ServingEngine, Request)):
        engines.append(Eng(model, params, slots=SLOTS, max_len=MAX_LEN,
                           chunk=CHUNK, prefill_mode="chunked",
                           replan_every=10_000, eos_id=trace.eos_id, kv=kv,
                           kv_block_size=BLOCK if kv == "paged" else None,
                           kv_pool_blocks=trace.pool_blocks
                           if kv == "paged" else None))
        reqs.append([Req(rid=rid, prompt=ev.prompt.copy(),
                         max_new_tokens=ev.max_new, priority=ev.priority,
                         sampling=ev.sampling)
                     for rid, ev in enumerate(trace.events)])

    def tick():
        for eng in engines:
            eng.step()
            if eng.pool is not None:
                eng.pool.check_invariants()
        ref_state, port_state = (_snapshot(e) for e in engines)
        assert port_state == ref_state

    for rid, ev in enumerate(trace.events):
        for _ in range(ev.gap):
            tick()
        for eng, rs in zip(engines, reqs):
            eng.submit(rs[rid])
    steps = 0
    while engines[0].scheduler.pending() and steps < 3000:
        tick()
        steps += 1
    assert not any(e.scheduler.pending() for e in engines)
    return [[list(r.generated) for r in rs] for rs in reqs]


@pytest.mark.parametrize("kv", ["dense", "paged"])
@pytest.mark.parametrize("seed", [0, 1, 2, 5])
def test_engine_matches_reference_engine(engines_pair, seed, kv):
    """Greedy traces: identical scheduler state every tick and identical
    emitted streams (fp32 logits agree to ~1e-6, far inside every greedy
    margin these traces meet)."""
    ref, port = _lockstep(engines_pair, make_trace(seed, sampled=False), kv)
    assert port == ref


def test_engine_routes_and_reports(engines_pair):
    """The host engine routes through kernel_select (plain torch attention,
    the fused sampler), reports its stages, and rejects what this slice
    does not port."""
    *_, tm, tp = engines_pair
    eng = ServingEngine(tm, tp, slots=SLOTS, max_len=MAX_LEN, chunk=CHUNK,
                        kv="paged", kv_block_size=BLOCK)
    stats = eng.stats()
    assert stats["kernel_plan"]["sampler"] == "fused"
    assert stats["kernel_plan"]["decode_dense"] == "torch"
    assert any(p["name"] == "kernel_select"
               for p in stats["kernel_report"]["passes"])
    with pytest.raises(NotImplementedError, match="item 5"):
        ServingEngine(tm, tp, spec=object())
    with pytest.raises(NotImplementedError, match="item 8"):
        ServingEngine(tm, tp, mesh=object())


@pytest.mark.parametrize("mode", ["batched", "serial"])
def test_one_shot_prefill_modes_match_reference(engines_pair, mode):
    """The batched and serial one-shot prefill modes emit the reference's
    greedy streams."""
    jm, jp, tm, tp = engines_pair
    rng = np.random.default_rng(3)
    prompts = [rng.integers(0, CFG.vocab, n).astype(np.int32)
               for n in (5, 9, 3, 7)]
    out = []
    for model, params, Eng, Req in ((jm, jp, JaxEngine, JaxRequest),
                                    (tm, tp, ServingEngine, Request)):
        eng = Eng(model, params, slots=SLOTS, max_len=MAX_LEN,
                  prefill_mode=mode, replan_every=10_000)
        reqs = [Req(rid=i, prompt=p, max_new_tokens=6)
                for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
        out.append([r.generated for r in reqs])
    assert out[1] == out[0]
