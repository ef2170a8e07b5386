"""Rank bodies of the port's multi-rank tests (``test_torch_tp.py``,
``test_torch_router.py``, ``test_torch_collectives.py``), and the trace
runner they share with the one-device runs they are compared with.

A spawned rank imports the module of the function it runs; this one
imports torch, numpy and ``repro_torch`` only (no jax, no reference), so
a rank starts in seconds.  Traces, requests and weights arrive as plain
data: ``plain_trace`` in ``test_torch_tp.py`` flattens a
``test_serving_fuzz.Trace``.  No test lives here.
"""
import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core.pipeline import StageTimer, _Stage
from repro_torch.distributed import ps_sync, ring_allreduce, tp
from repro_torch.models.model import Model
from repro_torch.serving import (ReplicaRouter, Request, SamplingParams,
                                 ServingEngine)
from repro_torch.serving.speculative import SpecParams


def build_model(cfg: dict, np_params, device="cpu"):
    """The port model of config fields ``cfg`` with numpy weights."""
    model = Model(ModelConfig(**cfg), device=device)
    return model, params_from_numpy(np_params, device)


def run_trace(model, params, trace: dict, kv: str, geo: dict, spec=None,
              mesh=None, replan_every=10_000, hook=None) -> list:
    """``test_serving_fuzz.run_trace`` on a port engine: ``trace`` a
    plain trace, ``geo`` the fuzz engine geometry, ``spec`` SpecParams
    fields or None, ``mesh`` this rank's concat-TP mesh; ``hook(eng)``
    runs once the engine is built."""
    spec_kw = {} if spec is None else dict(spec=SpecParams(**spec),
                                           spec_k_max=geo["spec_k_max"])
    eng = ServingEngine(model, params, slots=geo["slots"],
                        max_len=geo["max_len"], chunk=geo["chunk"],
                        prefill_mode="chunked", replan_every=replan_every,
                        eos_id=trace["eos_id"], kv=kv,
                        kv_block_size=geo["block"] if kv == "paged" else None,
                        kv_pool_blocks=trace["pool_blocks"]
                        if kv == "paged" else None, mesh=mesh, **spec_kw)
    if hook is not None:
        hook(eng)

    def tick():
        eng.step()
        if eng.pool is not None:
            eng.pool.check_invariants()
    reqs = []
    for rid, (gap, prompt, max_new, priority, sampling) in \
            enumerate(trace["events"]):
        for _ in range(gap):
            tick()
        req = Request(rid=rid, prompt=np.array(prompt, np.int32),
                      max_new_tokens=max_new, priority=priority,
                      sampling=SamplingParams(**sampling)
                      if sampling is not None else None)
        eng.submit(req)
        reqs.append(req)
    steps = 0
    while eng.scheduler.pending() and steps < 3000:
        tick()
        steps += 1
    assert all(r.done for r in reqs)
    if eng.pool is not None:
        assert eng.pool.stats()["blocks_in_use"] == 0
    return [list(r.generated) for r in reqs]


def trace_rank(mesh, cfg, np_params, traces, geo, spec):
    """Every ``traces`` entry (key -> plain trace), dense and paged, with
    speculation off and with ``spec``, through this rank's engine."""
    model, params = build_model(cfg, np_params, mesh.device)
    return {f"{key}/{kv}/{mode}": run_trace(model, params, trace, kv, geo,
                                            spec=s, mesh=mesh)
            for key, trace in traces.items() for kv in ("dense", "paged")
            for mode, s in (("plain", None), ("spec", spec))}


class _SkewedStage(_Stage):
    def __exit__(self, *exc):
        super().__exit__(*exc)
        t = self._timer
        t.totals[self.name] += self.dt * (t.skew - 1.0)
        return False


class SkewedTimer(StageTimer):
    """A :class:`StageTimer` that files every stage at ``skew`` times its
    measured time: a rank whose card or host runs slower."""

    def __init__(self, skew: float):
        super().__init__()
        self.skew = skew

    def stage(self, name: str) -> _Stage:
        return _SkewedStage(self, name)


def replan_rank(mesh, cfg, np_params, traces, geo, replan_every, skew):
    """Every ``traces`` entry, dense and paged, on an engine that replans
    every ``replan_every`` ticks, with rank 1's stage times ``skew``
    times its own.  Returns, per run, the streams, each replan's inputs
    and plan, and the prefill seconds this rank measured."""
    model, params = build_model(cfg, np_params, mesh.device)
    out = {}
    for key, trace in traces.items():
        for kv in ("dense", "paged"):
            replans, engines = [], []

            def hook(eng):
                if mesh.rank == 1:
                    eng.timer = SkewedTimer(skew)
                inner = eng.scheduler.maybe_replan

                def record(**kw):
                    plan = inner(**kw)
                    if plan is not None:
                        replans.append((kw, plan))
                    return plan
                eng.scheduler.maybe_replan = record
                engines.append(eng)
            streams = run_trace(model, params, trace, kv, geo, mesh=mesh,
                                replan_every=replan_every, hook=hook)
            totals = engines[0].timer.totals
            out[f"{key}/{kv}"] = (streams, replans,
                                  totals.get("prefill_chunk", 0.0)
                                  + totals.get("admit", 0.0))
    return out


def teacher_forced_logits(model, params, kv: str, script: dict,
                          mesh=None) -> list:
    """The logits of every prefill chunk and decode step of ``script``
    (rows, chunk, prompt lengths, decode steps, horizon, block size;
    greedy tokens fed back) on one device or on this rank."""
    B, C = script["rows"], script["chunk"]
    shards = mesh.shards if mesh is not None else 1
    if mesh is not None:
        params = tp.shard_params(params, shards, mesh.rank,
                                 tp.serving_param_specs(model.param_specs()))
    if kv == "dense":
        caches = model.init_caches(B, script["horizon"], shards=shards)
    else:
        bs = script["block"]
        M = script["horizon"] // bs
        caches = model.init_paged_caches(B, pool_blocks=B * M, block_size=bs,
                                         max_blocks=M, shards=shards)
        bt = torch.arange(B * M, dtype=torch.int32).reshape(B, M)
        caches.kv.block_tables.copy_(bt.expand_as(caches.kv.block_tables))
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, model.cfg.vocab, n)
               for n in script["prompts"]]
    out = []
    done = [0] * B
    while any(d < len(p) for d, p in zip(done, prompts)):
        toks = np.zeros((B, C), np.int64)
        n_new = np.zeros((B,), np.int32)
        for b, p in enumerate(prompts):
            n = min(C, len(p) - done[b])
            toks[b, :n] = p[done[b]:done[b] + n]
            n_new[b] = n
        logits, caches = model.prefill_chunk(
            params, caches, torch.from_numpy(toks),
            torch.tensor(done, dtype=torch.int32), torch.from_numpy(n_new),
            shard_axis=mesh)
        out.append(logits)
        done = [d + int(n) for d, n in zip(done, n_new)]
    tok = torch.argmax(out[-1], dim=-1)[:, None]
    for _ in range(script["steps"]):
        logits, caches = model.serve_step(params, caches, tok,
                                          shard_axis=mesh)
        out.append(logits)
        tok = torch.argmax(logits, dim=-1)[:, None]
    return [t.numpy() for t in out]


def logits_rank(mesh, cfg, np_params, script):
    model, params = build_model(cfg, np_params, mesh.device)
    return {kv: teacher_forced_logits(model, params, kv, script, mesh)
            for kv in ("dense", "paged")}


def router_engine(model, params, geo, mesh=None) -> ServingEngine:
    """``test_serving_router.make_engine``'s paged replica."""
    return ServingEngine(model, params, slots=geo["slots"],
                         max_len=geo["max_len"], chunk=geo["chunk"],
                         prefill_mode="chunked", replan_every=10_000,
                         kv="paged", kv_block_size=geo["block"],
                         kv_pool_blocks=geo["slots"] * geo["max_len"]
                         // geo["block"], mesh=mesh)


def make_request(rid, prompt, max_new, sampling) -> Request:
    return Request(rid=rid, prompt=np.array(prompt, np.int32),
                   max_new_tokens=max_new,
                   sampling=SamplingParams(**sampling)
                   if sampling is not None else None)


def route(router: ReplicaRouter, requests, fail_after=None):
    """Serve ``requests`` (rid, prompt, max_new, sampling fields) through
    ``router``; with ``fail_after`` replica 1 fails after that many
    router steps.  Returns each request's stream, where each was first
    placed and the router's counters."""
    reqs = [make_request(*r) for r in requests]
    for r in reqs:
        router.submit(r)
    router._dispatch()
    first = {rid: pl.replica for rid, pl in router.placements.items()}
    steps = 0
    while router.pending() and steps < 3000:
        if steps == fail_after:
            router.fail_replica(1)
        router.step()
        steps += 1
    assert all(r.done for r in reqs)
    s = router.stats()
    return ([list(r.generated) for r in reqs], first,
            {k: s[k] for k in ("dispatched", "affinity_hits", "requeued",
                               "live_replicas")})


def router_rank(mesh, cfg, np_params, geo, requests, fail_afters):
    """:func:`route` over a fresh router of two replicas sharded over
    this rank's mesh, once for each entry of ``fail_afters``."""
    model, params = build_model(cfg, np_params, mesh.device)
    return [route(ReplicaRouter([router_engine(model, params, geo, mesh)
                                 for _ in range(2)]), requests, fail_after)
            for fail_after in fail_afters]


def fail_on_rank_1(mesh):
    if mesh.rank == 1:
        raise ValueError("planted")
    return mesh.gather(torch.ones(1), dim=0).tolist()


def collectives_rank(mesh, cases: dict):
    """``cases`` maps a group size p to its ranks' inputs (p rows); the
    ranks below p form one group each (every rank joins every group, as
    ``new_group`` asks).  Returns, for each p this rank belongs to, its
    ``ring_allreduce``, ``ps_sync`` and ``dist.all_reduce`` results as
    numpy, whether its input came back unchanged, and whether p = 1
    returned the input itself."""
    import torch.distributed as dist
    out = {}
    for p, rows in sorted(cases.items()):
        group = dist.new_group(list(range(p)))
        if mesh.rank >= p:
            continue
        x = torch.as_tensor(rows[mesh.rank])
        keep = x.clone()
        ring, ps = ring_allreduce(x, group), ps_sync(x, group)
        summed = x.clone()
        dist.all_reduce(summed, group=group)
        out[p] = {"ring": ring.numpy(), "ps": ps.numpy(),
                  "all_reduce": summed.numpy(),
                  "input_kept": bool(torch.equal(x, keep)),
                  "identity": ring is x and ps is x}
    return out
