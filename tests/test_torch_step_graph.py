"""The staged serving step (``serving/graphs.py``) on the host.

On the card the per-tick steps (``serve``, ``serve_sample``, ``verify``,
``verify_sample``) are captured as CUDA graphs over static input
buffers; on the CPU the same staged bodies run eagerly on the same
buffers.  These tests hold that staged path to the plain eager engine
(``graphed=False``) bit for bit on ``tests/test_serving_fuzz.py``'s
traces — admissions, preemption, EOS, gated pools and replans, greedy
and sampled, dense and paged, spec off and on — and check the graph key
and the replay launch accounting.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs.base import ModelConfig
from repro_torch.core.pipeline import KernelPlan
from repro_torch.models.layers import tree_map
from repro_torch.models.model import Model
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.graphs import (StaticInputs, StepGraph, StepGraphs,
                                        tensor_key)
from repro_torch.serving.speculative import SpecParams
from test_serving_fuzz import (BLOCK, CFG, CHUNK, MAX_LEN, SLOTS, SPEC_K_MAX,
                               make_trace)


@functools.lru_cache(maxsize=None)
def _model():
    m = Model(ModelConfig(**dataclasses.asdict(CFG)), device="cpu")
    return m, m.init(torch.Generator().manual_seed(0))


def _engine(trace, kv, graphed, spec=None, replan_every=10_000, params=None,
            kernel_plan=None):
    model, p = _model()
    kw = dict(spec=spec, spec_k_max=SPEC_K_MAX) if spec is not None else {}
    kw["kernel_plan"] = kernel_plan
    return ServingEngine(model, params if params is not None else p,
                         slots=SLOTS, max_len=MAX_LEN, chunk=CHUNK,
                         prefill_mode="chunked", replan_every=replan_every,
                         eos_id=trace.eos_id, kv=kv,
                         kv_block_size=BLOCK if kv == "paged" else None,
                         kv_pool_blocks=trace.pool_blocks
                         if kv == "paged" else None, graphed=graphed, **kw)


def _drive(eng, trace, between=None):
    """Run ``trace`` through ``eng``; ``between(eng, tick)`` runs after
    every tick.  Returns the streams and the scheduler's counts."""
    reqs, tick = [], 0

    def step():
        nonlocal tick
        eng.step()
        tick += 1
        if between is not None:
            between(eng, tick)
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
    while eng.scheduler.pending() and tick < 3000:
        step()
    assert all(r.done for r in reqs)
    return [list(r.generated) for r in reqs], eng.scheduler.state_counts()


#: traces with early EOS retirement (6, 10_015), preemption (13, 18,
#: 10_015) and n-gram drafts (13, 18, 10_001)
TRACES = [(6, False), (13, False), (18, False), (10_001, True),
          (10_015, True)]


@pytest.mark.parametrize("spec", [None, "ngram"])
@pytest.mark.parametrize("kv", ["dense", "paged"])
@pytest.mark.parametrize("seed,sampled", TRACES)
def test_staged_step_matches_eager_engine(seed, sampled, kv, spec):
    """Staged ≡ eager: the same streams and the same scheduler history
    (admissions, preemptions, retirements) on a fuzz trace, replanning
    every 3 ticks; with ``spec``, the same speculative counters too."""
    trace = make_trace(seed, sampled)
    sp = SpecParams(mode=spec, k=3, min_ngram=1) if spec else None
    runs = []
    for graphed in (False, True):
        eng = _engine(trace, kv, graphed, spec=sp, replan_every=3)
        streams, counts = _drive(eng, trace)
        runs.append((streams, counts, eng.spec_stats, eng))
    assert runs[1][:3] == runs[0][:3]
    staged = runs[1][3]
    assert staged.stats()["graphed"] and staged.stats()["graphs"]
    assert staged.timer.counts.get("replan", 0) > 0
    assert staged.spec_stats.verify_calls == sum(
        c["replays"] for n, c in staged.graphs.counts.items()
        if n.startswith("verify"))


@pytest.mark.parametrize("spec", [None, "ngram"])
@pytest.mark.parametrize("kv", ["dense", "paged"])
@pytest.mark.parametrize("seed,sampled", [(13, False), (10_001, True)])
def test_staged_reference_sampler_matches_eager(seed, sampled, kv, spec):
    """Under the seed plan (``KernelPlan()``: the reference sampler) the
    staged steps are ``serve`` and ``verify/<K1>`` (logits out, the
    sampler's own dispatch after): staged ≡ eager the same way."""
    trace = make_trace(seed, sampled)
    sp = SpecParams(mode=spec, k=3, min_ngram=1) if spec else None
    runs = []
    for graphed in (False, True):
        eng = _engine(trace, kv, graphed, spec=sp, kernel_plan=KernelPlan())
        streams, counts = _drive(eng, trace)
        runs.append((streams, counts, eng.spec_stats, eng))
    assert runs[1][:3] == runs[0][:3]
    names = set(runs[1][3].graphs.counts)
    assert "serve" in names and not any("sample" in n for n in names)
    assert bool(spec) == any(n.startswith("verify/") for n in names)


def test_staged_traces_cover_preemption_eos_and_verify():
    """The traces above preempt, retire at EOS and draft (staged)."""
    preempted = eos = verify = 0
    for seed, sampled in TRACES:
        trace = make_trace(seed, sampled)
        eng = _engine(trace, "paged", True,
                      spec=SpecParams(mode="ngram", k=3, min_ngram=1))
        streams, _ = _drive(eng, trace)
        preempted += eng.scheduler.preempted
        verify += eng.spec_stats.verify_calls
        eos += sum(1 for s, ev in zip(streams, trace.events)
                   if s and s[-1] == trace.eos_id and len(s) < ev.max_new)
    assert preempted > 0 and eos > 0 and verify > 0


@pytest.mark.parametrize("graphed", [False, True])
@pytest.mark.parametrize("kv", ["dense", "paged"])
@pytest.mark.parametrize("seed,sampled", [(13, False), (10_001, True)])
def test_stats_file_steps_by_width_and_count_sampler_calls(seed, sampled,
                                                           kv, graphed):
    """``stats()["steps"]`` files every decode step under width 1 and
    every verify under its K1 (on the host nothing is captured, so no
    step goes under a ``*_capture`` stage); ``sampler_calls`` counts
    every call of a sampling body, staged or eager."""
    trace = make_trace(seed, sampled)
    eng = _engine(trace, kv, graphed,
                  spec=SpecParams(mode="ngram", k=3, min_ngram=1))
    calls = {"n": 0}

    def counted(fn):
        def call(*a, **kw):
            calls["n"] += 1
            return fn(*a, **kw)
        return call
    for name in ("_serve_sample", "_verify_sample", "_sample_step",
                 "_sample_grid_step"):
        setattr(eng, name, counted(getattr(eng, name)))
    _drive(eng, trace)
    st = eng.stats()
    steps, stages = st["steps"], st["stages"]
    assert st["sampler_calls"] == calls["n"] > 0
    assert set(steps) <= set(range(1, 5)) and 1 in steps
    none = {"calls": 0, "total_s": 0.0}
    for stage, widths in (("decode", [1]), ("verify", range(2, 5))):
        for suffix, n, t in (("", "calls", "total_s"),
                             ("_capture", "captures", "capture_s")):
            got = stages.get(stage + suffix, none)
            want = [steps[w] for w in widths if w in steps]
            assert got["calls"] == sum(w[n] for w in want), stage + suffix
            assert got["total_s"] == pytest.approx(sum(w[t] for w in want))
    verify = sum(w["calls"] + w["captures"] for k, w in steps.items()
                 if k > 1)
    assert verify == eng.spec_stats.verify_calls > 0
    assert sum(w["captures"] for w in steps.values()) == 0
    assert bool(eng.graphs.captures) == graphed


def test_tensor_key_tracks_replacement_not_values():
    a, b = torch.zeros(3), torch.ones((2, 2))
    tree = {"x": a, "y": (b, {"z": b})}
    key = tensor_key(tree)
    a.add_(1.0)                      # written in place: same key
    assert tensor_key(tree) == key
    tree["x"] = a.clone()            # replaced: another key
    assert tensor_key(tree) != key
    tree["x"] = a.to(torch.float64)  # same storage size, another dtype
    assert tensor_key(tree) != key


def test_graph_recaptures_on_replaced_tensor_only():
    """A replaced parameter or cache tensor makes the next step capture
    again (and read it); one written in place does not capture again.
    The streams still equal the eager engine given the same edits."""
    trace = make_trace(9, False)
    model, params = _model()
    runs = []
    for graphed in (False, True):
        own = tree_map(torch.clone, params)   # the edits stay in this run
        captures, done = {}, set()

        def between(eng, tick):
            steps = eng.timer.counts.get("decode", 0)
            if steps >= 3 and "w" not in done:  # replace a layer weight
                done.add("w")
                mlp = eng.params["layers"]["mlp"]
                name = sorted(mlp)[0]
                mlp[name] = mlp[name] * 0.5
            if steps >= 6 and "c" not in done:  # replace a cache tensor
                done.add("c")
                kv = eng.caches.kv
                eng.caches = eng.caches._replace(
                    kv=kv._replace(k=kv.k.clone()))
            if steps >= 9 and "i" not in done:  # write a weight in place
                done.add("i")
                eng.params["final_norm"].mul_(1.5)
            counts = eng.graphs.counts.get("serve_sample")
            captures[steps] = counts["captures"] if counts else 0

        eng = _engine(trace, "dense", graphed, params=own)
        streams, _ = _drive(eng, trace, between)
        runs.append((streams, captures))
    assert runs[1][0] == runs[0][0]
    caps = runs[1][1]
    # one capture, one after each replacement, none for the write in place
    assert (caps[3], caps[4], caps[7], caps[9], max(caps.values())) == (1, 2, 3, 3, 3)


def test_layer_views_follow_a_replaced_leaf():
    """``Model._layers`` memoizes per-layer views; replacing one stacked
    leaf makes it build them again (a stale view would keep reading the
    old weight)."""
    model, params = _model()
    p = model.cast_params(params)
    first = model._layers(p)
    assert model._layers(p) is first
    name = sorted(p["layers"]["attn"])[0]
    p["layers"]["attn"][name] = p["layers"]["attn"][name] * 2
    again = model._layers(p)
    assert again is not first
    assert again[0]["attn"][name].data_ptr() == \
        p["layers"]["attn"][name].data_ptr()


class _FakeGraph:
    def __init__(self):
        self.replays = 0

    def replay(self):
        self.replays += 1


def test_replay_adds_recorded_launches():
    """A replay runs no kernel wrapper, so it adds the launches the
    capture recorded to ``kernels.LAUNCHES`` once per replay."""
    buf = {"x": torch.zeros(2)}
    g = StepGraph(lambda x: x + 1, buf, key=("k",))
    assert g.graph is None and torch.equal(g.replay(), torch.ones(2))
    g.graph, g.outputs = _FakeGraph(), "static"
    g.launches = {"gqa_decode": 28, "linked_mlp": 28, "linked_mlp_tc": 28,
                  "fused_mask": 1}
    before = dict(kernels.LAUNCHES)
    for _ in range(5):
        assert g.replay() == "static"
    assert g.graph.replays == 5
    for name in kernels.LAUNCHES:
        assert kernels.LAUNCHES[name] - before[name] == \
            5 * g.launches.get(name, 0)


def test_step_graphs_capture_per_key_and_count_replays():
    graphs = StepGraphs()
    buf = {"x": torch.zeros(2)}
    calls = []

    def body(x):
        calls.append(1)
        return x * 2
    for key in ("a", "a", "b", "b", "b"):
        graphs.run("step", body, buf, key)
    c = graphs.counts["step"]
    assert (c["captures"], c["replays"]) == (2, 5) and len(calls) == 5


def test_static_inputs_are_fixed_buffers():
    st = StaticInputs(torch.device("cpu"))
    a = st.put("t", np.arange(4, dtype=np.int64))
    b = st.put("t", np.arange(4, 8, dtype=np.int64))
    assert a is b and b.tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError, match="static input"):
        st.put("t", np.zeros(5, np.int64))
    with pytest.raises(ValueError, match="static input"):
        st.put("t", np.zeros(4, np.int32))
    out = st.read(b)
    b.zero_()
    assert out.tolist() == [4, 5, 6, 7]
