"""Measured kernel-site routing on the port against the reference's: the
``timings`` option of ``select_kernel_plan``, the kernel-site bench and its
timings cache (``launch/autotune.py``), the engine's ``kernel_timings``
and ``kernel_plan="off"``, and the ``kernel_tune`` command.

Backends are renamed between the packages (``xla`` -> ``torch``,
``pallas`` -> ``cuda``), and so are the accelerators that route to the
kernels (``tpu`` -> ``cuda``).
"""
import dataclasses
import json
import math

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core import pipeline as ref_pipeline
from repro.launch import autotune as ref_autotune
from repro_torch.configs.base import ModelConfig
from repro_torch.core import pipeline
from repro_torch.core.pipeline import KERNEL_SITE_BACKENDS, KernelPlan
from repro_torch.launch import autotune, kernel_tune
from repro_torch.models.model import Model
from repro_torch.serving import Request, ServingEngine
from test_serving_fuzz import BLOCK, CFG, CHUNK, MAX_LEN, SLOTS, make_trace

RENAME = {"xla": "torch", "pallas": "cuda"}
ACCELERATORS = {"cpu": "cpu", "tpu": "cuda"}   # reference -> port


def _port_key(key: str) -> str:
    site, colon, backend = key.partition(":")
    return f"{site}{colon}{RENAME.get(backend, backend)}"


def _port_detail(detail: dict) -> dict:
    """The reference's decision detail with the port's backend names."""
    out = {}
    for k, v in detail.items():
        if k.endswith("_measured_s"):
            v = {RENAME.get(b, b): s for b, s in v.items()}
        out[k] = ACCELERATORS.get(v, v) if k == "accelerator" else v
    return out


#: every reference (site, backend) key, and keys select_kernel_plan must
#: ignore: an unknown site, a backend a site does not have, no colon
REF_KEYS = [f"{s}:{b}" for s, bs in ref_pipeline.KERNEL_SITE_BACKENDS.items()
            for b in bs]
JUNK_KEYS = ["attention:xla", "decode_ring:pallas", "sampler:cuda_graph",
             "prefill_chunk:pallas", "nocolon"]

geometry = st.fixed_dictionaries({}, optional={
    "slots": st.integers(1, 16), "q_heads": st.sampled_from([4, 8, 16]),
    "kv_heads": st.sampled_from([1, 2, 4]),
    "head_dim": st.sampled_from([32, 64, 128]),
    "max_len": st.sampled_from([64, 256, 2048]),
    "kv_block_size": st.sampled_from([0, 8, 16, 32]),
    "kv_pool_blocks": st.integers(0, 512)})
timings = st.dictionaries(
    st.sampled_from(REF_KEYS + JUNK_KEYS),
    st.floats(1e-7, 1.0, allow_nan=False) | st.sampled_from([1e-5, 2e-5]),
    max_size=12)


@settings(max_examples=60, deadline=None)
@given(geo=geometry, ref_timings=timings,
       acc=st.sampled_from(sorted(ACCELERATORS)))
def test_timed_plan_equals_reference(geo, ref_timings, acc):
    """Equal plans and equal decision detail (``*_measured_s`` included)
    on every drawn dict, ties between equal times included.  One part is
    each package's own: the host's gather/fold roofline prices the two
    lowerings with each package's cost-model constants (the port's are
    the H100's), so where that site is unmeasured on the host each plan
    takes its own modeled argmin, and the modeled seconds differ."""
    ref_plan, ref_detail = ref_pipeline.select_kernel_plan(
        dict(geo, accelerator=acc, timings=ref_timings))
    plan, detail = pipeline.select_kernel_plan(dict(
        geo, accelerator=ACCELERATORS[acc],
        timings={_port_key(k): v for k, v in ref_timings.items()}))
    want = {site: RENAME.get(b, b) for site, b in ref_plan.items()}
    got = plan.as_dict()
    assert got.pop("split_matmul") == (
        "cuda" if ACCELERATORS[acc] == "cuda" else "torch")
    modeled = detail.pop("decode_paged_modeled_s", None)
    ref_modeled = ref_detail.pop("decode_paged_modeled_s", None)
    assert (modeled is None) == (ref_modeled is None)
    if acc == "cpu" and "decode_paged_measured_s" not in detail:
        for choice, model in ((got, modeled), (want, ref_modeled)):
            assert choice.pop("decode_paged") == (
                "gather" if model is None
                else min(("gather", "fold"), key=model.get))
    assert got == want
    assert detail == _port_detail(ref_detail)


@pytest.mark.parametrize("acc", ["cpu", "cuda"])
def test_split_matmul_takes_its_measured_argmin(acc):
    """The port-only site is routed by measurement as the others are."""
    for fast, slow in (("torch", "cuda"), ("cuda", "torch")):
        plan, detail = pipeline.select_kernel_plan({
            "accelerator": acc, "timings": {f"split_matmul:{fast}": 1e-6,
                                            f"split_matmul:{slow}": 2e-6}})
        assert plan.split_matmul == fast
        assert detail["split_matmul_measured_s"] == {fast: 1e-6,
                                                     slow: 2e-6}


def test_mesh_rule_outranks_a_linked_matmul_timing():
    """On a concat-TP mesh a rank's ``linked_mlp`` would return a partial
    sum: ``linked_matmul`` stays ``torch`` however fast the kernel timed,
    and the other sites still follow their timings."""
    t = {"linked_matmul:cuda": 1e-6, "linked_matmul:torch": 1.0,
         "sampler:fused": 1e-6, "sampler:cuda": 1.0}
    one, _ = pipeline.select_kernel_plan({"accelerator": "cuda",
                                          "timings": t})
    plan, detail = pipeline.select_kernel_plan(
        {"accelerator": "cuda", "mesh_shards": 2, "timings": t})
    assert one.linked_matmul == "cuda"
    assert plan.linked_matmul == "torch" and plan.sampler == "fused"
    assert plan.decode_dense == "cuda"
    assert detail["linked_matmul_measured_s"] == {"cuda": 1e-6, "torch": 1.0}


# -- the timings cache --------------------------------------------------------

CACHE = {"decode_dense:torch": 1.25e-4, "decode_paged:fold": 3.5e-5,
         "decode_paged:gather": 2e-5, "sampler:fused": 0.001}


def test_port_cache_reads_in_the_reference(tmp_path):
    path = str(tmp_path / "t.json")
    autotune.save_timings(path, CACHE, meta={"slots": 4})
    text = open(path).read()
    assert text.endswith("}\n")
    assert json.loads(text) == {"timings": CACHE, "meta": {"slots": 4}}
    assert ref_autotune.load_timings(path) == CACHE
    assert autotune.load_timings(path) == CACHE


def test_reference_cache_reads_in_the_port(tmp_path):
    path = str(tmp_path / "t.json")
    ref_autotune.save_timings(path, CACHE, meta={"slots": 4})
    assert autotune.load_timings(path) == CACHE
    autotune.save_timings(str(tmp_path / "p.json"), CACHE,
                          meta={"slots": 4})
    assert open(path).read() == open(tmp_path / "p.json").read()


def test_missing_cache_gives_empty(tmp_path):
    path = str(tmp_path / "absent.json")
    assert autotune.load_timings(path) == {} == \
        ref_autotune.load_timings(path)


# -- the bench ---------------------------------------------------------------

def test_bench_keys_equal_reference():
    """On the host: the reference's keys at ``include_pallas=False``,
    renamed, each a finite positive time."""
    ref = ref_autotune.bench_kernel_sites(iters=2)
    got = autotune.bench_kernel_sites(iters=2, device="cpu")
    assert set(got) == {_port_key(k) for k in ref}
    assert all(math.isfinite(v) and v > 0 for v in got.values())
    bf16 = autotune.bench_kernel_sites(iters=1, device="cpu",
                                       dtype="bfloat16", slots=2,
                                       max_len=16, vocab=64)
    assert set(bf16) == set(got)


def test_bench_refuses_kernels_off_the_card():
    with pytest.raises(ValueError, match="plain versions"):
        autotune.bench_kernel_sites(iters=1, device="cpu", include_cuda=True)
    with pytest.raises(ValueError, match="multiple of kv_block_size"):
        autotune.bench_kernel_sites(iters=1, device="cpu", max_len=20)


def test_time_call_synchronizes_and_averages():
    calls = []
    t = autotune._time_call(lambda x: calls.append(x) or torch.ones(1), 7,
                            iters=5, warmup=2)
    assert calls == [7] * 7 and t > 0


# -- the engine ---------------------------------------------------------------

def _model():
    m = Model(ModelConfig(**dataclasses.asdict(CFG)), device="cpu")
    return m, m.init(torch.Generator().manual_seed(0))


def _engine(model, params, trace, kv="paged", **kw):
    return ServingEngine(model, params, slots=SLOTS, max_len=MAX_LEN,
                         chunk=CHUNK, prefill_mode="chunked",
                         replan_every=10_000, eos_id=trace.eos_id, kv=kv,
                         kv_block_size=BLOCK if kv == "paged" else None,
                         kv_pool_blocks=trace.pool_blocks
                         if kv == "paged" else None, **kw)


def _streams(eng, trace):
    reqs = []
    for rid, ev in enumerate(trace.events):
        for _ in range(ev.gap):
            eng.step()
        reqs.append(Request(rid=rid, prompt=ev.prompt.copy(),
                            max_new_tokens=ev.max_new, priority=ev.priority,
                            sampling=ev.sampling))
        eng.submit(reqs[-1])
    for _ in range(3000):
        if not eng.scheduler.pending():
            break
        eng.step()
    assert all(r.done for r in reqs)
    return [list(r.generated) for r in reqs]


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_engine_takes_the_timed_plan(kv):
    """``kernel_timings`` reach ``select_kernel_plan`` with the engine's
    geometry, sorted; the decision and its measured detail land in
    ``stats()["kernel_report"]``."""
    model, params = _model()
    trace = make_trace(6, sampled=False)
    t = {"sampler:reference": 1e-5, "sampler:fused": 2e-5,
         "decode_paged:fold": 1e-6, "decode_paged:gather": 1e-3,
         "decode_dense:torch": 1e-5, "not_a_site:torch": 0.0}
    eng = _engine(model, params, trace, kv=kv, kernel_timings=t)
    opts = {"accelerator": "cpu", "slots": SLOTS, "max_len": MAX_LEN,
            "q_heads": CFG.n_heads, "kv_heads": CFG.n_kv_heads,
            "head_dim": CFG.resolved_head_dim, "timings": t}
    if kv == "paged":
        opts.update(kv_block_size=eng.pool.cfg.block_size,
                    kv_pool_blocks=eng.pool.cfg.pool_blocks)
    plan, detail = pipeline.select_kernel_plan(opts)
    assert eng.kernel_plan == plan
    assert plan.sampler == "reference" and plan.decode_paged == "fold"
    summary = eng.stats()["kernel_report"]["passes"][-1]["summary"]
    assert summary["sampler_measured_s"] == {"fused": 2e-5,
                                             "reference": 1e-5}
    assert {k: summary[k] for k in detail} == detail
    # no timings: the heuristics (the host's fused sampler)
    assert _engine(model, params, trace, kv=kv).kernel_plan.sampler == \
        "fused"


def test_timed_fold_streams_equal_the_explicit_plan():
    """Timings that pick ``fold`` at the paged site (and the seed path's
    backend everywhere else) give ``KernelPlan(decode_paged="fold")`` and
    its streams bit for bit, sampled requests included."""
    model, params = _model()
    t = {f"{site}:{backend}": 1e-6 if backend == want else 1e-3
         for site, want in KernelPlan(decode_paged="fold").items()
         for backend in KERNEL_SITE_BACKENDS[site]}
    for seed in (13, 10_015):
        trace = make_trace(seed, sampled=True)
        timed = _engine(model, params, trace, kernel_timings=t)
        assert timed.kernel_plan == KernelPlan(decode_paged="fold")
        explicit = _engine(model, params, trace,
                           kernel_plan=KernelPlan(decode_paged="fold"))
        assert _streams(timed, trace) == _streams(explicit, trace)


def test_kernel_plan_off_is_the_seed_path():
    model, params = _model()
    trace = make_trace(6, sampled=False)
    eng = _engine(model, params, trace, kernel_plan="off",
                  kernel_timings={"sampler:fused": 1e-9})
    assert eng.kernel_plan == KernelPlan()
    assert "kernel_report" not in eng.stats()
    with pytest.raises(ValueError, match="'off' or None"):
        _engine(model, params, trace, kernel_plan="on")


# -- the command --------------------------------------------------------------

def test_kernel_tune_cli_on_the_host(tmp_path, capsys):
    out = tmp_path / "t.json"
    rc = kernel_tune.main(["--device", "cpu", "--slots", "2",
                           "--max-len", "32", "--q-heads", "4",
                           "--kv-heads", "2", "--head-dim", "8",
                           "--vocab", "64", "--iters", "2",
                           "--out", str(out)])
    assert rc == 0
    text = capsys.readouterr().out
    assert "routed plan: KernelPlan(" in text and f"wrote {out}" in text
    data = json.loads(out.read_text())
    # the sweep: every SERVE_KV_BLOCK_SIZES entry that tiles 32
    assert sorted(data["meta"]["by_block_size"]) == ["16", "32", "8"]
    assert data["meta"]["kv_block_size"] == 8
    assert data["timings"] == data["meta"]["by_block_size"]["8"]
    timings = autotune.load_timings(str(out))
    assert timings == ref_autotune.load_timings(str(out))
    plan, _ = pipeline.select_kernel_plan({
        "accelerator": "cpu", "slots": 2, "max_len": 32, "q_heads": 4,
        "kv_heads": 2, "head_dim": 8, "kv_block_size": 8,
        "kv_pool_blocks": 8, "timings": timings})
    assert data["meta"]["plan"] == plan.as_dict()
    assert np.isfinite(list(timings.values())).all()
