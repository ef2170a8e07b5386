"""The port's MoE family against the JAX reference.

* **The pieces** (``repro_torch.models.moe``): ``moe_block``,
  ``_moe_local``, ``load_balance_loss`` and ``moe_reference`` on the cases
  of ``tests/test_moe_optim.py``: at capacity factor 8 within that test's
  rtol 2e-4 / atol 2e-5; at 0.05, where the capacity drops assignments,
  the same assignments kept as the reference's (an equal output); with a
  tied router column, ``lax.top_k``'s choice among the ties.
* **The model** (weights carried across through numpy): the reference's
  ``test_prefill_decode_matches_forward`` replayed on the port for
  olmoe-1b-7b, and the logits of ``forward``, ``prefill_step``, every
  ``prefill_chunk`` and ``serve_step`` of a teacher-forced script (dense
  and paged) and ``verify_step`` against the reference's at rtol 3e-4, on
  reduced olmoe-1b-7b and reduced arctic-480b (its dense SwiGLU
  residual).
* **The serving oracles** on an MoE twin of the fuzz ``CFG`` (4 experts,
  top 2) and ``make_trace``'s traces: paged ≡ dense, n-gram speculation
  (k 3) ≡ off and preempt-and-restore ≡ solo, bit for bit; chunked ≡
  one-shot at rtol 2e-5; the port's greedy streams ≡ the reference
  engine's on the same weights wherever the top-1 / top-2 margin exceeds
  the tolerance; the serve command in-process, dense and paged; and the
  concat-TP refusal of the reference, by message.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import get_config as jax_get_config
from repro.distributed import tp as ref_tp
from repro.models import moe as JM
from repro.models.model import Model as JaxModel
from repro.serving import Request as JaxRequest
from repro.serving import ServingEngine as JaxEngine
from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.distributed import tp as port_tp
from repro_torch.launch import serve as serve_launch
from repro_torch.models import moe as TM
from repro_torch.models.model import Model
from repro_torch.serving import Request, ServingEngine
from repro_torch.serving.speculative import SpecParams

from test_serving_fuzz import BLOCK, CFG, CHUNK, MAX_LEN, SLOTS, make_trace
from test_torch_model import B, PROMPT_LENS, _run_port, _run_ref, _script
from test_torch_model import MAX_LEN as SCRIPT_LEN
from test_torch_recurrent import _per_layer_fan_in

RTOL = dict(rtol=3e-4, atol=3e-5)
#: tests/test_moe_optim.py's tolerance between the dispatch and the oracle
MOE_TOL = dict(rtol=2e-4, atol=2e-5)
#: the MoE twin of the serving-fuzz config
MOE_CFG = dataclasses.replace(CFG, name="fuzz-moe", family="moe",
                              n_experts=4, top_k=2)


def _moe_cfg(E=4, k=2, cf=8.0):
    """tests/test_moe_optim.py's config: reduced olmoe, E experts top k."""
    cfg = jax_get_config("olmoe-1b-7b").reduced()
    return dataclasses.replace(cfg, n_experts=E, top_k=k, capacity_factor=cf)


def _moe_case(seed, B_, S_, tie=False):
    """The reference test's draws (router N(0,1), experts 0.05 N(0,1), x
    N(0,1)), from ``seed``; ``tie`` makes router column 3 a copy of
    column 1, so every token's logits tie there."""
    cfg = _moe_cfg()
    d, ff = cfg.d_model, cfg.d_ff
    rng = np.random.default_rng(seed)
    p = {"router": rng.normal(size=(d, 4)).astype(np.float32),
         "gate": (rng.normal(size=(4, d, ff)) * 0.05).astype(np.float32),
         "up": (rng.normal(size=(4, d, ff)) * 0.05).astype(np.float32),
         "down": (rng.normal(size=(4, ff, d)) * 0.05).astype(np.float32)}
    if tie:
        p["router"][:, 3] = p["router"][:, 1]
    x = rng.normal(size=(B_, S_, d)).astype(np.float32)
    return p, x


def _both(p, x):
    return ({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x),
            {k: torch.from_numpy(v) for k, v in p.items()},
            torch.from_numpy(x))


def test_moe_block_and_oracle_match_reference_at_full_capacity():
    """cf 8 keeps every assignment: the port's moe_block (its fixed form),
    its capacity path ``_moe_local``, its oracle and its load-balance
    loss equal the reference's."""
    cfg = _moe_cfg()
    jp, jx, tp, tx = _both(*_moe_case(3, 2, 8))
    j_out, j_aux = JM.moe_block(jp, jx, cfg=cfg, mesh=None)
    t_out, t_aux = TM.moe_block(tp, tx, cfg=cfg, aux=True)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **MOE_TOL)
    np.testing.assert_allclose(
        TM.moe_reference(tp, tx, cfg=cfg).numpy(),
        np.asarray(JM.moe_reference(jp, jx, cfg=cfg)), **MOE_TOL)
    local = TM._moe_local(tx.reshape(-1, cfg.d_model), tp["router"],
                          tp["gate"], tp["up"], tp["down"], n_experts=4,
                          top_k=2, e_local=4, lo=0, k_max=128)
    np.testing.assert_allclose(local.reshape(t_out.shape).numpy(),
                               np.asarray(j_out), **MOE_TOL)
    np.testing.assert_allclose(float(t_aux), float(j_aux), rtol=1e-6)
    assert float(t_aux) >= 1.0 - 1e-3
    assert TM.moe_block(tp, tx, cfg=cfg)[1] is None   # aux on request only


def test_capacity_path_keeps_the_reference_assignments():
    """cf 0.05 (k_max 8 of 128 assignments): the port drops exactly the
    reference's, so the outputs agree at the oracle tolerance, and both
    fall short of the dropless oracle."""
    cfg = _moe_cfg(cf=0.05)
    jp, jx, tp, tx = _both(*_moe_case(4, 4, 16))
    j_out, _ = JM.moe_block(jp, jx, cfg=cfg, mesh=None)
    t_out, _ = TM.moe_block(tp, tx, cfg=cfg)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **MOE_TOL)
    ref = TM.moe_reference(tp, tx, cfg=cfg)
    assert torch.isfinite(t_out).all()
    assert float(torch.linalg.norm(t_out)) < float(torch.linalg.norm(ref))
    # 8 kept assignments: at most 8 tokens have a nonzero output
    kept = (t_out.reshape(-1, cfg.d_model).abs().sum(-1) > 0).sum()
    assert 1 <= int(kept) <= 8


@pytest.mark.parametrize("cf", [8.0, 0.05])
def test_tied_router_columns_pick_lax_top_k(cf):
    """Experts 1 and 3 score every token alike: ``stable_top_k`` takes
    ``lax.top_k``'s lower index, and both dispatch forms follow it."""
    cfg = _moe_cfg(cf=cf)
    jp, jx, tp, tx = _both(*_moe_case(5, 2, 8, tie=True))
    logits = tx.reshape(-1, cfg.d_model) @ tp["router"]
    assert torch.equal(logits[:, 1], logits[:, 3])
    jv, ji = jax.lax.top_k(jnp.asarray(logits.numpy()), 2)
    tv, ti = TM.stable_top_k(logits, 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert (ti == 1).any()
    j_out, _ = JM.moe_block(jp, jx, cfg=cfg, mesh=None)
    t_out, _ = TM.moe_block(tp, tx, cfg=cfg)
    np.testing.assert_allclose(t_out.numpy(), np.asarray(j_out), **MOE_TOL)


# -- the model against the reference -------------------------------------------

def _configs():
    return {"olmoe-reduced": jax_get_config("olmoe-1b-7b").reduced(),
            "arctic-reduced": jax_get_config("arctic-480b").reduced()}


_PAIRS: dict = {}


def _pair(name, raw=False):
    """(reference model, reference params, port model, port params);
    reduced arctic's attention at its per-layer fan-in unless ``raw``
    (:func:`test_reduced_arctic_at_the_raw_init_is_ill_conditioned`)."""
    if (name, raw) not in _PAIRS:
        jcfg = _configs()[name]
        jm = JaxModel(jcfg)
        jp = jm.init(jax.random.key(0))
        if name == "arctic-reduced" and not raw:
            jp = _per_layer_fan_in(jp, jcfg)
        tm = Model(ModelConfig(**dataclasses.asdict(jcfg)), device="cpu")
        tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
        _PAIRS[name, raw] = (jm, jp, tm, tp)
    return _PAIRS[name, raw]


def _prefill_decode(model, params, pkg):
    """Padded one-shot prefill of the script's prompts, then three decode
    steps: the logits of each, and the caches."""
    rng = np.random.default_rng(4)
    S = max(PROMPT_LENS)
    toks = rng.integers(0, model.cfg.vocab, (B, S)).astype(np.int32)
    lens = np.asarray(PROMPT_LENS, np.int32)
    arr = jnp.asarray if pkg == "jax" else torch.from_numpy
    logits, caches = model.prefill_step(
        params, {"tokens": arr(toks), "lengths": arr(lens)},
        max_len=SCRIPT_LEN)
    out = [np.asarray(logits)]
    for _ in range(3):
        nt = rng.integers(0, model.cfg.vocab, (B, 1)).astype(np.int32)
        logits, caches = model.serve_step(params, caches, arr(nt))
        out.append(np.asarray(logits))
    return out, caches, toks


def test_reduced_arctic_at_the_raw_init_is_ill_conditioned():
    """As reduced hymba's (``tests/test_torch_recurrent.py``): the
    reference's init takes a stacked 4-D attention leaf's fan-in from its
    layer axis (2 at reduced depth), so reduced arctic attends with
    near-one-hot softmaxes, and at the second decode step of the padded
    prefill script the reference's logits move past rtol 3e-4 / atol
    3e-5 when its weights move by 1e-7 (relative).  The parity tests
    draw its attention at the per-layer fan-in; here the port at the raw
    init stays within four times the reference's own move, and under 1%
    of the logits leave the bound."""
    jm, jp, tm, tp = _pair("arctic-reduced", raw=True)
    ref, _, _ = _prefill_decode(jm, jp, "jax")
    moved, _, _ = _prefill_decode(
        jm, jax.tree.map(lambda a: a * (1 + 1e-7), jp), "jax")
    port, _, _ = _prefill_decode(tm, tp, "torch")
    ref, moved, port = (np.stack(x) for x in (ref, moved, port))
    bound = RTOL["atol"] + RTOL["rtol"] * np.abs(ref)
    assert (np.abs(moved - ref) > bound).any()
    assert np.abs(port - ref).max() <= 4 * np.abs(moved - ref).max()
    assert (np.abs(port - ref) > bound).mean() < 0.01


def test_converted_tree_carries_every_moe_leaf():
    """Leaf for leaf the port's spec tree is the reference's: the
    ``(L, E, d, ff)`` experts, the router and arctic's ``dense_mlp``
    cross with their shapes."""
    for name in _configs():
        jm, jp, tm, tp = _pair(name)

        def walk(t, j, specs, path=""):
            assert set(t) == set(j) == set(specs), path
            for k in t:
                if isinstance(t[k], dict):
                    walk(t[k], j[k], specs[k], f"{path}/{k}")
                else:
                    assert tuple(t[k].shape) == j[k].shape \
                        == specs[k].shape, f"{path}/{k}"
                    np.testing.assert_array_equal(t[k].numpy(),
                                                  np.asarray(j[k]))
        walk(tp, jp, tm.param_specs())
        layer = tp["layers"]
        cfg = tm.cfg
        assert tuple(layer["moe"]["gate"].shape) == (
            cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.d_ff)
        assert ("dense_mlp" in layer) == cfg.moe_dense_residual
        assert tm.param_count() == jm.param_count()


def test_prefill_decode_matches_forward_on_the_port():
    """``tests/test_arch_smoke.py::test_prefill_decode_matches_forward``
    for olmoe-1b-7b, on the port (its draws, its tolerances)."""
    cfg = ModelConfig(**dataclasses.asdict(
        jax_get_config("olmoe-1b-7b").reduced()))
    m = Model(cfg, device="cpu")
    params = m.init(torch.Generator().manual_seed(0))
    Bs, S = 2, 16
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (Bs, S)).astype(np.int32))
    full, _ = m.forward(params, {"tokens": toks})
    lg, caches = m.prefill_step(params, {"tokens": toks[:, :S // 2]},
                                max_len=S)
    np.testing.assert_allclose(lg.numpy(), full[:, S // 2 - 1].numpy(),
                               rtol=1e-3, atol=1e-4)
    for t in range(S // 2, S):
        lg, caches = m.serve_step(params, caches, toks[:, t:t + 1])
        np.testing.assert_allclose(lg.numpy(), full[:, t].numpy(),
                                   rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("kv", ["dense", "paged"])
@pytest.mark.parametrize("name", ["olmoe-reduced", "arctic-reduced"])
def test_chunk_and_decode_logits_match_reference(name, kv):
    """Every chunk and decode step of the teacher-forced script (a
    bystander row, a dead decode row), dense and paged."""
    jm, jp, tm, tp = _pair(name)
    ref = _run_ref(jm, jp, kv)
    got = _run_port(tm, tp, kv)
    for i, (step, r, g) in enumerate(zip(_script(jm.cfg.vocab), ref, got)):
        rows = step[4]
        np.testing.assert_allclose(g[rows], r[rows], **RTOL,
                                   err_msg=f"{name} {kv} step {i} {step[0]}")


@pytest.mark.parametrize("name", ["olmoe-reduced", "arctic-reduced"])
def test_prefill_forward_and_verify_match_reference(name):
    """One-shot padded prefill, three decode steps and a verify of 3
    positions (one bystander row), and the forward with its summed
    load-balance loss."""
    jm, jp, tm, tp = _pair(name)
    ref, cj, toks = _prefill_decode(jm, jp, "jax")
    got, ct, _ = _prefill_decode(tm, tp, "torch")
    for i, (r, g) in enumerate(zip(ref, got)):
        np.testing.assert_allclose(g, r, **RTOL, err_msg=f"step {i}")
    rng = np.random.default_rng(5)
    vt = rng.integers(0, jm.cfg.vocab, (B, 3)).astype(np.int32)
    n_new = np.asarray([3, 0, 2], np.int32)
    vj, _ = jm.verify_step(jp, cj, jnp.asarray(vt), jnp.asarray(n_new))
    vp, _ = tm.verify_step(tp, ct, torch.from_numpy(vt),
                           torch.from_numpy(n_new))
    for b, n in enumerate(n_new):
        np.testing.assert_allclose(vp[b, :n].numpy(), np.asarray(vj)[b, :n],
                                   **RTOL)
    fj, aj = jm.forward(jp, {"tokens": jnp.asarray(toks)})
    ft, at = tm.forward(tp, {"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(ft.numpy(), np.asarray(fj), **RTOL)
    np.testing.assert_allclose(float(at), float(aj), rtol=1e-5)


def test_chunking_matches_one_shot():
    """Chunks of 4 ≡ chunks of 1 bit for bit (a row's expert outputs do
    not depend on its neighbours); the one-shot prefill agrees to 2e-5,
    as for the dense family."""
    *_, tm, tp = _pair("olmoe-reduced")
    base = _run_port(tm, tp, "dense")
    other = _run_port(tm, tp, "dense", chunk_split=4)
    for step, x, y in zip(_script(tm.cfg.vocab), base, other):
        np.testing.assert_array_equal(x[step[4]], y[step[4]])
    rng = np.random.default_rng(0)
    for b, p in enumerate(rng.integers(0, tm.cfg.vocab, n)
                          for n in PROMPT_LENS):
        one, _ = tm.prefill_step(tp, {"tokens": torch.from_numpy(p)[None]},
                                 max_len=SCRIPT_LEN)
        last = max(i for i, s in enumerate(_script(tm.cfg.vocab))
                   if s[0] == "chunk" and s[4][b])
        np.testing.assert_allclose(base[last][b], one[0].numpy(),
                                   rtol=2e-5, atol=2e-6)


# -- the serving oracles on the MoE fuzz twin ----------------------------------

_FUZZ: dict = {}


def _fuzz():
    """(reference model, reference params, port model, port params) of
    ``MOE_CFG``, the port's weights the reference's."""
    if not _FUZZ:
        jm = JaxModel(MOE_CFG)
        jp = jm.init(jax.random.key(0))
        tm = Model(ModelConfig(**dataclasses.asdict(MOE_CFG)), device="cpu")
        _FUZZ["pair"] = (jm, jp, tm,
                         params_from_numpy(jax.tree.map(np.asarray, jp),
                                           "cpu"))
    return _FUZZ["pair"]


def run_trace(trace, kv, engine=ServingEngine, request=Request, **kw):
    """``test_serving_fuzz.run_trace`` on the MoE twin: the streams, the
    pool's invariants re-derived every tick.  ``engine`` / ``request``:
    the reference's classes run the reference model on the same
    weights."""
    jm, jp, tm, tp = _fuzz()
    model, params = (jm, jp) if engine is JaxEngine else (tm, tp)
    paged = kv == "paged"
    eng = engine(model, params, slots=kw.pop("slots", SLOTS),
                 max_len=MAX_LEN, chunk=CHUNK,
                 prefill_mode=kw.pop("prefill_mode", "chunked"),
                 replan_every=10_000, eos_id=trace.eos_id, kv=kv,
                 kv_block_size=BLOCK if paged else None,
                 kv_pool_blocks=trace.pool_blocks if paged else None, **kw)
    reqs = []

    def step():
        eng.step()
        if eng.pool is not None:
            eng.pool.check_invariants()
    for rid, ev in enumerate(trace.events):
        for _ in range(ev.gap):
            step()
        req = request(rid=rid, prompt=ev.prompt.copy(),
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
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paged_and_spec_match_dense_on_traces(seed, sampled):
    """The reference's ``assert_equivalent`` on the MoE twin: paged ≡
    dense, and n-gram speculation (k 3, dense and paged) ≡ the dense
    baseline, bit for bit (gaps, priorities and preemption, gated pools,
    EOS)."""
    trace = make_trace(seed + (10_000 if sampled else 0), sampled=sampled)
    dense = run_trace(trace, "dense")
    assert run_trace(trace, "paged") == dense
    spec = SpecParams(mode="ngram", k=3, min_ngram=1)
    for kv in ("dense", "paged"):
        assert run_trace(trace, kv, spec=spec, spec_k_max=4) == dense, kv


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_preempt_and_restore_matches_solo(kv):
    """A request preempted in decode restores by re-prefilling its folded
    context and emits its solo stream, as does the request that
    preempted it."""
    *_, tm, tp = _fuzz()
    rng = np.random.default_rng(33)
    prompt = rng.integers(0, CFG.vocab, 20).astype(np.int32)
    vip_prompt = rng.integers(0, CFG.vocab, 6).astype(np.int32)

    def engine(kv_):
        return ServingEngine(tm, tp, slots=1, max_len=MAX_LEN, chunk=CHUNK,
                             prefill_mode="chunked", replan_every=10_000,
                             kv=kv_,
                             kv_block_size=BLOCK if kv_ == "paged" else None,
                             kv_pool_blocks=8 if kv_ == "paged" else None)
    eng = engine(kv)
    eng.scheduler.cfg.preempt = 1  # a 1-slot engine defaults to 0
    low = Request(rid=0, prompt=prompt.copy(), max_new_tokens=8)
    eng.submit(low)
    for _ in range(8):       # 5 prefill ticks (20 at chunk 4), then decode
        eng.step()
    assert len(low.generated) >= 1 and not low.done
    vip = Request(rid=1, prompt=vip_prompt.copy(), max_new_tokens=2,
                  priority=5)
    eng.submit(vip)
    eng.run()
    assert eng.scheduler.preempted == 1 and low.done and vip.done
    solos = []
    for p, n in ((prompt, 8), (vip_prompt, 2)):
        solo = Request(rid=0, prompt=p.copy(), max_new_tokens=n)
        one = engine("dense")
        one.submit(solo)
        one.run()
        solos.append(list(solo.generated))
    assert [list(low.generated), list(vip.generated)] == solos


@pytest.mark.parametrize("seed", [0, 3])
def test_greedy_streams_match_reference_engine(seed):
    """The port's engine and the reference's on the same weights and the
    same greedy trace: equal streams, or a parting at a step whose
    top-1 / top-2 margin (the port's own logits, replayed for that
    request alone) is under the fp32 tolerance."""
    trace = make_trace(seed, sampled=False)
    port = run_trace(trace, "dense")
    ref = run_trace(trace, "dense", engine=JaxEngine, request=JaxRequest)
    *_, tm, tp = _fuzz()
    for rid, (a, b) in enumerate(zip(port, ref)):
        if a == b:
            continue
        t = next(i for i, (x, y) in enumerate(zip(a, b)) if x != y)
        caches = tm.init_caches(1, MAX_LEN)
        toks = list(trace.events[rid].prompt) + a[:t]
        logits, _ = tm.prefill_step(tp, {"tokens": torch.tensor([toks])},
                                    max_len=MAX_LEN)
        top = torch.topk(logits[0, :CFG.vocab], 2).values
        assert float(top[0] - top[1]) <= RTOL["rtol"] * max(
            1.0, abs(float(top[0]))), (rid, t)
        del caches


@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_serve_command_runs_reduced_olmoe(kv, capsys):
    """``python -m repro_torch.launch.serve --arch olmoe-1b-7b --reduced
    --device cpu`` (and with ``--kv paged``), in-process at 3 requests."""
    rc = serve_launch.main(["--arch", "olmoe-1b-7b", "--reduced",
                            "--device", "cpu", "--kv", kv, "--requests",
                            "3", "--prompt-len", "24", "--max-new", "6"])
    out = capsys.readouterr().out
    assert rc == 0 and "served 3 requests" in out, out


def test_concat_tp_refuses_moe_like_reference():
    """``validate_serving_tp`` refuses an MoE stack over 2 shards with the
    reference's message."""
    jcfg = jax_get_config("olmoe-1b-7b").reduced()
    tcfg = ModelConfig(**dataclasses.asdict(jcfg))

    class Mesh:
        shape = {"model": 2}
        axis_names = ("model",)

    msgs = []
    for fn, cfg, mesh in ((ref_tp.validate_serving_tp, jcfg, Mesh()),
                          (port_tp.validate_serving_tp, tcfg,
                           port_tp.ServingMesh(shards=2))):
        with pytest.raises(ValueError) as e:
            fn(cfg, mesh)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] and "family 'moe'" in msgs[0]
