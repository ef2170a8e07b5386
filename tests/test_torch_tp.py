"""Concat tensor parallelism of the port (``repro_torch.distributed.tp``,
``launch/mesh.py``, the sharded serving step) against the JAX reference.

* **Sharded ≡ one device, bit for bit**: the reference's
  ``test_sharded_engine_matches_single_device`` replayed on the port: the
  fuzz traces ``make_trace`` seeds 0 (greedy) and 10 000 (sampled), dense
  and paged, n-gram speculation off and on, through a 2-rank engine (two
  processes over gloo on the CPU), equal to the port's one-device streams
  and to the reference's under the same weights; and the logits of every
  prefill chunk and decode step of reduced qwen3-1.7b, dense and paged.
* **Refusals equal the reference's**: ``validate_serving_tp`` and the
  engine's (constant-state, layer-pattern, one-shot prefill) by message;
  ``graphed=True`` on a gloo mesh; ``make_serving_mesh`` past the
  visible devices.
* **Specs and slices**: the per-leaf TP dimensions agree with the
  reference's ``serving_param_specs`` on qwen3-1.7b's tree, and with
  ``serving_cache_specs`` on its caches; ``shard_params`` pieces
  concatenate back to every leaf.
* **A rank's decode plan**: the decode kernels take the plan (body,
  query heads a CTA, split count) one device takes at the full kv heads
  (``rank_plan``), so a rank's heads merge their splits in the one-device
  order (qwen3's, gemma3's and chatglm3's shapes on a 132-SM card).
* **Planner**: ``serve_schedule`` / ``_plan_kv_pool`` /
  ``_modeled_decode_paged`` under ``mesh_shards`` 2 and 4 equal the
  reference's; ``select_kernel_plan`` keeps ``linked_matmul`` on
  ``torch`` on a mesh.

Each multi-rank case spawns its ranks once (``launch.mesh.spawn_ranks``)
with a ``FileStore`` under ``tmp_path`` (no TCP port) and a join timeout
of its own.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import test_serving_fuzz as F
import test_torch_ranks as R
from repro.configs.base import get_config as jax_get_config
from repro.core import pipeline as ref_pipeline
from repro.distributed import tp as ref_tp
from repro.models.model import Model as JaxModel
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core import pipeline as port_pipeline
from repro_torch.distributed import tp
from repro_torch.kernels.decode_attention import ops as t_da
from repro_torch.launch.mesh import make_serving_mesh, spawn_ranks
from repro_torch.models import attention
from repro_torch.models.model import Model
from repro_torch.serving import ServingEngine

REPO = Path(__file__).resolve().parent.parent
#: each spawn's own join timeout (s)
RANK_TIMEOUT = 120.0
SPEC = dict(mode="ngram", k=3, min_ngram=1)
#: the replayed traces: (make_trace seed, sampled)
TRACES = ((0, False), (10_000, True))


def _port_cfg(jcfg):
    return ModelConfig(**dataclasses.asdict(jcfg))


#: the fuzz engine geometry (``test_serving_fuzz``)
GEO = dict(slots=F.SLOTS, max_len=F.MAX_LEN, chunk=F.CHUNK, block=F.BLOCK,
           spec_k_max=F.SPEC_K_MAX)


def plain_trace(trace) -> dict:
    """A ``test_serving_fuzz.Trace`` as plain data (what a rank, which
    imports no reference module, unpickles)."""
    return {"eos_id": trace.eos_id, "pool_blocks": trace.pool_blocks,
            "events": [(ev.gap, ev.prompt.tolist(), ev.max_new, ev.priority,
                        dataclasses.asdict(ev.sampling)
                        if ev.sampling is not None else None)
                       for ev in trace.events]}


@pytest.fixture(scope="module")
def fuzz_weights():
    """The reference's fuzz model (``jax.random.key(0)``) and its
    weights as numpy leaves, which the port and every rank load."""
    jm = JaxModel(F.CFG)
    jp = jm.init(jax.random.key(0))
    return jm, jp, jax.tree.map(np.asarray, jp)


@pytest.fixture(scope="module")
def sharded_streams(fuzz_weights, tmp_path_factory):
    *_, np_params = fuzz_weights
    traces = {seed: plain_trace(F.make_trace(seed, sampled=sampled))
              for seed, sampled in TRACES}
    return spawn_ranks(R.trace_rank, 2,
                       args=(dataclasses.asdict(F.CFG), np_params, traces,
                             GEO, SPEC),
                       devices=["cpu", "cpu"], timeout_s=RANK_TIMEOUT,
                       store_dir=tmp_path_factory.mktemp("mesh"))


@pytest.fixture(scope="module")
def reference_streams(fuzz_weights):
    jm, jp, _ = fuzz_weights
    return {f"{seed}/{kv}": F.run_trace(jm, jp, F.make_trace(seed, sampled),
                                        kv)
            for seed, sampled in TRACES for kv in ("dense", "paged")}


@pytest.mark.parametrize("spec", ["plain", "spec"])
@pytest.mark.parametrize("kv", ["dense", "paged"])
@pytest.mark.parametrize("seed,sampled", TRACES, ids=["greedy", "sampled"])
def test_sharded_engine_matches_single_device(fuzz_weights, sharded_streams,
                                              reference_streams, seed,
                                              sampled, kv, spec):
    """A 2-rank engine's streams equal the one-device port's and the
    reference's, bit for bit; both ranks emit the same streams."""
    *_, np_params = fuzz_weights
    model, params = R.build_model(dataclasses.asdict(F.CFG), np_params)
    solo = R.run_trace(model, params,
                       plain_trace(F.make_trace(seed, sampled=sampled)), kv,
                       GEO)
    key = f"{seed}/{kv}/{spec}"
    rank0, rank1 = (r[key] for r in sharded_streams)
    assert rank0 == solo
    assert rank1 == rank0
    assert solo == reference_streams[f"{seed}/{kv}"]


@pytest.fixture(scope="module")
def skewed_replans(fuzz_weights, tmp_path_factory):
    *_, np_params = fuzz_weights
    traces = {seed: plain_trace(F.make_trace(seed, sampled=sampled))
              for seed, sampled in TRACES}
    return spawn_ranks(R.replan_rank, 2,
                       args=(dataclasses.asdict(F.CFG), np_params, traces,
                             GEO, 2, 1000.0),
                       devices=["cpu", "cpu"], timeout_s=RANK_TIMEOUT,
                       store_dir=tmp_path_factory.mktemp("mesh"))


@pytest.mark.parametrize("kv", ["dense", "paged"])
@pytest.mark.parametrize("seed", [s for s, _ in TRACES],
                         ids=["greedy", "sampled"])
def test_sharded_replans_adopt_one_plan(skewed_replans, seed, kv):
    """A mesh replans every 2 ticks while rank 1 times its stages 1000x
    slower: every replan reads rank 0's times on both ranks, so both
    adopt the same plans and emit the same streams (a rank planning from
    its own times picks another chunk, and the gathers stop matching)."""
    (s0, plans0, prefill0), (s1, plans1, prefill1) = (
        r[f"{seed}/{kv}"] for r in skewed_replans)
    assert prefill1 > 100 * prefill0 > 0
    assert len(plans0) >= 2
    assert plans1 == plans0
    assert s1 == s0


# -- logits ------------------------------------------------------------------

#: the teacher-forced script: rows, chunk, prompt lengths, decode steps,
#: horizon, block size
SCRIPT = dict(rows=2, chunk=8, prompts=(13, 6), steps=3, horizon=32, block=8)
QWEN = jax_get_config("qwen3-1.7b").reduced()


@pytest.fixture(scope="module")
def sharded_logits(tmp_path_factory):
    np_params = jax.tree.map(np.asarray,
                             JaxModel(QWEN).init(jax.random.key(1)))
    return np_params, spawn_ranks(
        R.logits_rank, 2, args=(dataclasses.asdict(QWEN), np_params, SCRIPT),
        devices=["cpu", "cpu"], timeout_s=RANK_TIMEOUT,
        store_dir=tmp_path_factory.mktemp("mesh"))


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_sharded_logits_equal_one_device(sharded_logits, kv):
    """Reduced qwen3-1.7b (4 q / 2 kv heads, d_ff 512, fp32): every
    prefill-chunk and decode-step logit of a 2-rank mesh equals the
    one-device model's, bit for bit, on both ranks."""
    np_params, ranks = sharded_logits
    model, params = R.build_model(dataclasses.asdict(QWEN), np_params)
    solo = R.teacher_forced_logits(model, params, kv, SCRIPT)
    for got in (r[kv] for r in ranks):
        assert len(got) == len(solo)
        for a, b in zip(got, solo):
            np.testing.assert_array_equal(a, b)


# -- the card's margin rule --------------------------------------------------

def _chip_smoke():
    import importlib.util
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_margin_counts_the_boundary_only_where_it_lets_the_token_win():
    """``chip_smoke.decision_margin``, the shift that turns a decision
    into another run's token, on a sampled row (T 1, top-k 2; ties at
    the k-th logit kept): a token tied at the boundary ~10 below the
    winner needs ~10; an outsider within tol under the k-th logit whose
    noise beats the winner's needs its admission alone (tol / 2); a
    winner tied at the boundary drops out for free, and then the
    survivor with the most noise needs 0 but the one with the least
    still has to outscore the rest; a greedy row: the logit gap."""
    from repro_torch.serving import SamplingParams
    from repro_torch.serving import sampling as S
    cs = _chip_smoke()
    V, step, sp = 16, 3, SamplingParams(temperature=1.0, top_k=2, seed=7)
    key = S.fold_in(S.prng_key(torch.tensor([sp.seed])),
                    torch.tensor([step]))
    g = S.gumbel(key, V)[0]
    order = torch.argsort(g, descending=True).tolist()
    tol = cs.TOL["bfloat16"]["rtol"] * 10.0

    x = torch.full((V,), -30.0)
    x[0], x[1], x[2] = 10.0, 0.0, 0.0
    margin, got_tol = cs.decision_margin(torch, x, sp, step, 2)
    assert got_tol == pytest.approx(tol)
    assert margin == pytest.approx(min(10.0 + g[0] - g[2], 10.0).item(),
                                   rel=1e-5)
    assert margin > 1.0

    b, a, c = order[0], order[1], order[2]     # b has the most noise
    lead = (g[b] - g[a]).item() / 2            # b would beat a if admitted
    x = torch.full((V,), -30.0)
    x[a], x[c], x[b] = 10.0, 10.0 - lead, 10.0 - lead - tol / 2
    margin, _ = cs.decision_margin(torch, x, sp, step, b)
    assert margin == pytest.approx(tol / 2, rel=1e-5)  # fp32 sums

    a, b, low, top = order[0], order[1], order[-1], order[-2]
    x = torch.full((V,), -30.0)
    x[top], x[a], x[b], x[low] = 0.05, 0.0, 0.0, 0.0   # a wins on the tie
    margin, _ = cs.decision_margin(torch, x, sp, step, b)
    assert margin == 0.0
    margin, _ = cs.decision_margin(torch, x, sp, step, low)
    assert margin == pytest.approx(max(0.0, (g[b] - g[low]).item(),
                                       (0.05 + g[top] - g[low]).item()),
                                   rel=1e-5)
    assert margin > 0.0

    x = torch.full((V,), -30.0)
    x[0], x[1], x[2] = 10.0, 9.5, 9.0
    margin, _ = cs.decision_margin(torch, x, None, 0, 2)
    assert margin == pytest.approx(1.0, rel=1e-5)


# -- refusals ----------------------------------------------------------------

class _FakeMesh:
    """Just enough mesh surface for the reference's validate_serving_tp
    (the port's takes a ``ServingMesh``)."""
    def __init__(self, shards):
        self.shape = {"model": shards}
        self.axis_names = ("model",)


def _refusal(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("arch,change", [
    ("fuzz", dict(n_kv_heads=3, n_heads=6)),
    ("fuzz", dict(n_heads=3, n_kv_heads=1)),
    ("fuzz", dict(d_ff=129)),
    ("fuzz", dict(sliding_window=8)),
    ("mamba2-370m", {}),
    ("hymba-1.5b", {}),
    ("seamless-m4t-large-v2", {}),
    ("gemma3-1b", {}),
], ids=["kv-heads", "heads", "d-ff", "sliding", "ssm", "hybrid",
        "encoder-decoder", "layer-pattern"])
def test_validate_serving_tp_refusals_equal_reference(arch, change):
    jcfg = F.CFG if arch == "fuzz" else jax_get_config(arch).reduced()
    jcfg = dataclasses.replace(jcfg, **change)
    want = _refusal(lambda: ref_tp.validate_serving_tp(jcfg, _FakeMesh(2)))
    got = _refusal(lambda: tp.validate_serving_tp(
        _port_cfg(jcfg), tp.ServingMesh(shards=2)))
    assert got == want


def test_validate_serving_tp_accepts_divisible_configs():
    for cfg in (F.CFG, jax_get_config("qwen3-1.7b")):
        for shards in (1, 2):
            assert tp.validate_serving_tp(
                _port_cfg(cfg), tp.ServingMesh(shards=shards)) == shards
    assert tp.validate_serving_tp(_port_cfg(F.CFG), None) == 1


@pytest.mark.parametrize("prefill_mode", ["batched", "serial"])
def test_engine_refuses_one_shot_prefill_like_reference(fuzz_weights,
                                                        prefill_mode):
    jm, jp, np_params = fuzz_weights
    want = _refusal(lambda: JaxEngine(jm, jp, slots=F.SLOTS,
                                      max_len=F.MAX_LEN, mesh=_FakeMesh(2),
                                      prefill_mode=prefill_mode))
    model, params = R.build_model(dataclasses.asdict(F.CFG), np_params)
    got = _refusal(lambda: ServingEngine(
        model, params, slots=F.SLOTS, max_len=F.MAX_LEN,
        mesh=tp.ServingMesh(shards=2, backend="gloo"),
        prefill_mode=prefill_mode))
    assert got == want


@pytest.mark.parametrize("arch", ["hymba-1.5b", "gemma3-1b"])
def test_engine_refuses_recurrent_and_pattern_stacks_like_reference(arch):
    """hymba (constant-state) and gemma3 (layer pattern): the reference's
    engine refuses them at construction, with the port's same message."""
    jcfg = jax_get_config(arch).reduced()
    jm = JaxModel(jcfg)
    jp = jm.init(jax.random.key(0))
    want = _refusal(lambda: JaxEngine(jm, jp, slots=2, max_len=32,
                                      mesh=_FakeMesh(2)))
    model = Model(_port_cfg(jcfg), device="cpu")
    params = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    got = _refusal(lambda: ServingEngine(
        model, params, slots=2, max_len=32,
        mesh=tp.ServingMesh(shards=2, backend="gloo")))
    assert got == want


@pytest.mark.parametrize("backend,reason", [
    ("gloo", "cannot be captured in a CUDA graph"),
    ("nccl", "not ported")])
def test_sharded_engine_refuses_graphed(fuzz_weights, backend, reason):
    """A sharded engine runs eagerly: graphed=True is refused with the
    reason, and the default resolves to eager."""
    *_, np_params = fuzz_weights
    model, params = R.build_model(dataclasses.asdict(F.CFG), np_params)
    mesh = tp.ServingMesh(shards=2, backend=backend)
    msg = _refusal(lambda: ServingEngine(model, params, slots=F.SLOTS,
                                         max_len=F.MAX_LEN, mesh=mesh,
                                         graphed=True))
    assert reason in msg and "graphed=False" in msg
    eng = ServingEngine(model, params, slots=F.SLOTS, max_len=F.MAX_LEN,
                        mesh=mesh)
    assert eng.graphed is False
    stats = eng.stats()
    assert stats["mesh_shards"] == 2
    assert stats["kernel_plan"]["linked_matmul"] == "torch"


def test_make_serving_mesh_raises_past_visible_devices():
    visible = torch.cuda.device_count()
    with pytest.raises(ValueError, match="visible"):
        make_serving_mesh(visible + 1)
    with pytest.raises(ValueError, match=">= 1 shard"):
        make_serving_mesh(0)
    with pytest.raises(ValueError, match="devices listed"):
        make_serving_mesh(2, devices=["cpu"])
    one = make_serving_mesh(1, devices=["cpu"])
    assert (one.shards, one.rank, one.group) == (1, 0, None)
    x = torch.arange(6.0).reshape(2, 3)
    assert one.gather(x, dim=1) is x


def test_spawn_ranks_fails_on_a_failing_rank(tmp_path):
    with pytest.raises(RuntimeError, match="rank 1 of 2 failed"):
        spawn_ranks(R.fail_on_rank_1, 2, devices=["cpu", "cpu"],
                    timeout_s=RANK_TIMEOUT, store_dir=tmp_path)


# -- specs and slices -------------------------------------------------------

def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def _ref_dim(spec):
    dims = [i for i, a in enumerate(spec) if a == ref_tp.SERVING_AXIS]
    return dims[0] if dims else None


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "qwen3-1.7b-reduced"])
def test_param_dims_equal_reference_specs(arch):
    cfg = jax_get_config("qwen3-1.7b")
    if arch.endswith("reduced"):
        cfg = cfg.reduced()
    ref = ref_tp.serving_param_specs(JaxModel(cfg).param_specs())
    ref = {k: _ref_dim(v) for k, v in _flatten(
        jax.tree.map(lambda s: tuple(s), ref,
                     is_leaf=lambda x: isinstance(
                         x, jax.sharding.PartitionSpec))).items()}
    port = _flatten(tp.serving_param_specs(
        Model(_port_cfg(cfg), device="cpu").param_specs()))
    assert port == ref
    assert port["/layers/attn/wq"] == 2 and port["/layers/mlp/gate"] == 2
    assert port["/layers/attn/wo"] is None \
        and port["/layers/mlp/down"] is None


@pytest.mark.parametrize("shards", [1, 2])
def test_shard_params_pieces_concatenate_to_every_leaf(shards):
    model = Model(_port_cfg(jax_get_config("qwen3-1.7b").reduced()),
                  device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    dims = tp.serving_param_specs(model.param_specs())
    pieces = [tp.shard_params(params, shards, r, dims)
              for r in range(shards)]
    full, flat_dims = _flatten(params), _flatten(dims)
    for name, leaf in full.items():
        parts = [_flatten(p)[name] for p in pieces]
        d = flat_dims[name]
        if d is None or shards == 1:
            assert all(p is leaf for p in parts)
            continue
        assert all(p.is_contiguous() for p in parts)
        assert parts[0].shape[d] == leaf.shape[d] // shards
        assert torch.equal(torch.cat(parts, dim=d), leaf)


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_cache_dims_equal_reference_and_halve_kv(kv):
    """The K/V payloads split on dim 3 (the kv heads), metadata stays
    whole, as the reference's ``serving_cache_specs`` says; a rank's
    caches hold K / 2 heads and half the K/V bytes."""
    cfg = jax_get_config("qwen3-1.7b").reduced()
    jm = JaxModel(cfg)
    model = Model(_port_cfg(cfg), device="cpu")
    if kv == "dense":
        jc, full, half = (jm.init_caches(2, 32), model.init_caches(2, 32),
                          model.init_caches(2, 32, shards=2))
    else:
        geo = dict(pool_blocks=8, block_size=8, max_blocks=4)
        jc, full, half = (jm.init_paged_caches(2, **geo),
                          model.init_paged_caches(2, **geo),
                          model.init_paged_caches(2, **geo, shards=2))
    ref = ref_tp.serving_cache_specs(jc)
    ref_kv = {f: _ref_dim(tuple(getattr(ref.kv, f))) for f in ref.kv._fields}
    dims = tp.serving_cache_dims(full)
    assert {f: getattr(dims.kv, f) for f in dims.kv._fields} == ref_kv
    for f in ("k", "v"):
        a, b = getattr(full.kv, f), getattr(half.kv, f)
        assert b.shape[tp.KV_HEAD_DIM] * 2 == a.shape[tp.KV_HEAD_DIM]
        assert b.numel() * 2 == a.numel()
    for f in full.kv._fields:
        if f not in ("k", "v"):
            assert getattr(half.kv, f).shape == getattr(full.kv, f).shape


# -- planner -----------------------------------------------------------------

def _proxy_graph(package):
    import importlib
    mod = importlib.import_module(f"{package}.serving.scheduler")
    return mod.serve_plan_graph("fuzz", 4, 64, 128, 96)


@pytest.mark.parametrize("shards", [2, 4])
@pytest.mark.parametrize("options", [
    dict(),
    dict(kv="paged"),
    dict(kv="paged", max_len=2048, slots=8),
    dict(kv="paged", avg_prompt_len=40.0, decode_step_s=0.01,
         prefill_token_s=0.001),
    dict(decode_step_s=0.01, prefill_token_s=0.0002),
], ids=["dense", "paged", "paged-2048", "paged-stats", "dense-stats"])
def test_serve_schedule_mesh_shards_matches_reference(options, shards):
    opts = {"slots": 4, "max_len": 64, "replan_every": 32,
            "mesh_shards": shards, **options}
    plans = []
    for pipe, graph in ((ref_pipeline, _proxy_graph("repro")),
                        (port_pipeline, _proxy_graph("repro_torch"))):
        _, report = pipe.optimize(graph, passes=("serve_schedule",),
                                  options=opts)
        plans.append(report.passes[-1].summary)
    keys = ("chunk", "mesh_shards", "prefill_mode", "preempt", "kv",
            "kv_block_size", "kv_pool_blocks", "kv_saving", "kv_growth")
    assert {k: plans[1].get(k) for k in keys} == \
        {k: plans[0].get(k) for k in keys}
    assert plans[1]["mesh_shards"] == shards


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("args", [(4, 64, 32, 0.0), (8, 2048, 64, 300.0),
                                  (4, 256, 16, 10.0), (2, 96, 8, 0.0)])
def test_plan_kv_pool_shards_matches_reference(args, shards):
    assert port_pipeline._plan_kv_pool(*args, shards) == \
        ref_pipeline._plan_kv_pool(*args, shards)


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("geo", [
    dict(slots=4, q_heads=8, kv_heads=4, head_dim=64, max_len=256,
         kv_block_size=16, kv_pool_blocks=64),
    dict(slots=8, q_heads=16, kv_heads=8, head_dim=128, max_len=2048,
         kv_block_size=32, kv_pool_blocks=512),
    dict(slots=2, q_heads=4, kv_heads=2, head_dim=16, max_len=32,
         kv_block_size=8, kv_pool_blocks=8)])
def test_modeled_decode_paged_shards_matches_reference(geo, shards):
    """Both packages price a rank at its own kv and query heads (the
    port's host constants are its own, so the choice is compared, and
    each package's times against its unsharded model at K / shards and
    H / shards heads)."""
    opts = dict(geo, mesh_shards=shards)
    local = dict(geo, kv_heads=geo["kv_heads"] // shards,
                 q_heads=geo["q_heads"] // shards)
    for pipe in (port_pipeline, ref_pipeline):
        assert pipe._modeled_decode_paged(opts) == \
            pipe._modeled_decode_paged(local)
    assert port_pipeline._modeled_decode_paged(opts)[0] == \
        ref_pipeline._modeled_decode_paged(opts)[0]


@pytest.mark.parametrize("shards", [1, 2, 4])
@pytest.mark.parametrize("acc", ["cuda", "cpu"])
def test_select_kernel_plan_keeps_linked_matmul_off_the_kernel_on_a_mesh(
        acc, shards):
    plan, _ = port_pipeline.select_kernel_plan(
        {"accelerator": acc, "mesh_shards": shards})
    want = "cuda" if acc == "cuda" and shards == 1 else "torch"
    assert plan.linked_matmul == want
    assert plan.decode_dense == ("cuda" if acc == "cuda" else "torch")


def test_sharded_swiglu_refuses_the_linked_kernel():
    x = torch.ones(2, 4)
    p = {"gate": torch.ones(4, 4), "up": torch.ones(4, 4),
         "down": torch.ones(8, 4)}
    from repro_torch.models.layers import swiglu
    with pytest.raises(ValueError, match="partial sum"):
        swiglu(p, x, "cuda", tp.ServingMesh(shards=2))


# -- the serve command line -------------------------------------------------

@pytest.mark.parametrize("flags", [["--mesh-shards", "2"],
                                   ["--mesh-shards", "2", "--replicas", "2",
                                    "--kv", "paged"]],
                         ids=["mesh", "mesh-replicas"])
def test_serve_command_spawns_its_ranks(flags):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
         "qwen3-1.7b", "--reduced", "--device", "cpu", "--requests", "4",
         "--max-new", "4", "--rank-timeout", str(RANK_TIMEOUT), *flags],
        capture_output=True, text=True, timeout=RANK_TIMEOUT + 30, env=env,
        cwd=REPO)
    assert out.returncode == 0, out.stderr
    assert "mesh: 2-way concat-TP" in out.stdout
    assert out.stdout.count("served 4 requests") == 1   # rank 0 prints
    if "--replicas" in flags:
        assert "router: 2 replicas" in out.stdout
        assert "per shard: 1 kv heads" in out.stdout


def test_serve_command_fails_past_visible_cards():
    from repro_torch.launch import serve
    assert serve.main(["--arch", "qwen3-1.7b", "--reduced", "--mesh-shards",
                       str(torch.cuda.device_count() + 2)]) == 2


# -- a rank's decode plan (the decode kernels' grid on a mesh) ----------------

@pytest.mark.parametrize("splits", [1, 3, 8, 24, 32, 40, 0, -2])
@pytest.mark.parametrize("D,G", [(128, 2), (256, 4), (64, 1)])
def test_decode_grid_takes_the_split_count_asked_for(D, G, splits):
    """An override plan keeps its body and GT (GT still follows G) and its
    split count, capped by the kernel's two merge levels
    (``max_splits``) and at least one; an fp32 plan caps one merge at
    ``merge_cap``, bf16 at its square."""
    own = t_da.decode_grid(8, 4, G, 2048, 132, D)
    plan = t_da.decode_grid(8, 4, G, 2048, 132, D,
                            plan=t_da.DecodePlan(own.body, own.gt, splits))
    assert (plan.body, plan.gt) == (own.body, own.gt)
    assert own.gt == (G if own.body == "group" else 2 - G % 2)
    assert plan.splits == max(1, min(splits, t_da.max_splits(
        own.body, D, own.gt)))
    fp32 = t_da.decode_grid(8, 4, G, 2048, 132, D, torch.float32)
    assert fp32.body == "heads"
    assert fp32.splits <= t_da.merge_cap("heads", D, fp32.gt)


#: (B, K, G, W, D): qwen3-1.7b's decode (8 kv heads of 128, G 2),
#: gemma3-1b's shape (G 4, head_dim 256: a global layer's horizon, a
#: sliding layer's ring) at two kv heads, and chatglm3-6b's (2 kv heads of
#: 128, G 16: one on a rank of two)
RANK_SHAPES = {"qwen3": (8, 8, 2, 2048, 128),
               "gemma3_global": (8, 2, 4, 2048, 256),
               "gemma3_sliding": (8, 2, 4, 512, 256),
               "chatglm3": (8, 2, 16, 2048, 128)}


@pytest.mark.parametrize("shape", RANK_SHAPES.values(), ids=RANK_SHAPES)
def test_rank_takes_one_device_split_count(shape):
    """On a 132-SM card a 2-rank engine's decode launches take the whole
    plan one device takes at the full kv heads: its body, its query heads
    a CTA and its split count (qwen3: 4 splits, where its own K / 2 would
    take 8; chatglm3: 6, where its own would take 33 in two merge
    levels), in fp32 and bf16, so each head's row is cut into the same
    pieces and merged in the same order; on one device and off the card
    the grid keeps its own."""
    B, K, G, W, D = shape
    for dtype in (torch.bfloat16, torch.float32):
        one = t_da.decode_grid(B, K, G, W, 132, D, dtype)
        rank = t_da.rank_plan(B, K // 2, G, W, 132, D, 2, dtype)
        assert rank == one
        assert t_da.decode_grid(B, K // 2, G, W, 132, D, dtype, rank) == one
        own = t_da.decode_grid(B, K // 2, G, W, 132, D, dtype)
        assert t_da.merge_groups(rank.splits, t_da.merge_cap(
            rank.body, D, rank.gt)) == t_da.merge_groups(
                one.splits, t_da.merge_cap(one.body, D, one.gt))
    if shape == RANK_SHAPES["qwen3"]:
        assert (one.splits, own.splits) == (4, 8)
    if shape == RANK_SHAPES["chatglm3"]:
        # one merge of 6 pieces on one device; the rank's own 8 units
        # would take two merge levels of 33 splits
        bf = t_da.rank_plan(B, K // 2, G, W, 132, D, 2)
        assert bf == ("group", 16, 6)
        assert t_da.decode_grid(B, K // 2, G, W, 132, D).splits == 33
    q = torch.zeros((B, K // 2 * G, D))
    assert attention.rank_plan(q, K // 2, W, 2) is None   # a CPU tensor
    assert attention.rank_plan(q, K // 2, W, 1) is None
