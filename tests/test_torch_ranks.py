"""Rank bodies of the port's multi-rank tests (``test_torch_tp.py``,
``test_torch_router.py``, ``test_torch_collectives.py``,
``test_torch_train_mesh.py``, ``test_torch_long_context.py``), and the
trace runner they share with the one-device runs they are compared
with.

A spawned rank imports the module of the function it runs; this one
imports torch, numpy and ``repro_torch`` only (no jax, no reference), so
a rank starts in seconds.  Traces, requests and weights arrive as plain
data: ``plain_trace`` in ``test_torch_tp.py`` flattens a
``test_serving_fuzz.Trace``.  No test lives here.
"""
from functools import partial

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import params_from_numpy
from repro_torch.core.pipeline import StageTimer, _Stage
from repro_torch.distributed import ps_sync, ring_allreduce, tp
from repro_torch.distributed import sharding as SH
from repro_torch.distributed import state_sharding as SS
from repro_torch.launch.mesh import mesh_device
from repro_torch.models import layers
from repro_torch.models.model import Model
from repro_torch.optim import AdamWConfig, adamw_init, cosine_schedule
from repro_torch.serving import (ReplicaRouter, Request, SamplingParams,
                                 ServingEngine)
from repro_torch.serving.speculative import SpecParams
from torch.utils._python_dispatch import TorchDispatchMode


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


def _by_path(tree, fn) -> dict:
    """``fn`` of every leaf of a nested dict, keyed by its path (an int8
    moment's ``q`` and ``scale`` apart)."""
    out = {}

    def walk(t, path):
        if isinstance(t, dict):
            for k, v in t.items():
                walk(v, f"{path}/{k}")
        elif hasattr(t, "q"):
            walk(t.q, path + ".q")
            walk(t.scale, path + ".scale")
        else:
            out[path] = fn(t)
    walk(tree, "")
    return out


def _local(tree) -> dict:
    """A DTensor tree's local shards as fp32 numpy."""
    return _by_path(tree, lambda t: t.detach().to_local().cpu().float()
                    .numpy())


def _placements(tree) -> dict:
    """A DTensor tree's placements as strings."""
    return _by_path(tree, lambda t: [repr(p) for p in t.placements])


def _rank_rows(mesh, batch: dict, batch_axes: tuple) -> dict:
    """This rank's rows of a global numpy batch split over ``batch_axes``
    (``make_train_iterator``'s contiguous blocks)."""
    n, i = 1, 0
    for a in batch_axes:
        size = mesh.size(list(mesh.mesh_dim_names).index(a))
        i = i * size + mesh.get_local_rank(a)
        n *= size
    out = {}
    for k, v in batch.items():
        rows = v.shape[0] // n
        out[k] = v[i * rows:(i + 1) * rows]
    return out


def mesh_train_run(mesh, case: dict) -> dict:
    """``case["steps"]`` train steps of ``case["cfg"]`` from the numpy
    params ``case["params"]`` on this rank's rows of each
    ``case["batches"]`` entry; the losses and grad norms as fp32 bits
    and the params' local shards after."""
    dev = mesh_device(mesh)
    model = Model(ModelConfig(**case["cfg"]), mesh=mesh, device=dev)
    state = model.init_train_state(None, params=params_from_numpy(
        case["params"], dev))
    sched = partial(cosine_schedule, **case["sched"])
    losses, gnorms = [], []
    for batch in case["batches"]:
        state, met = model.train_step(
            state, _rank_rows(mesh, batch, case["batch_axes"]),
            lr_schedule=sched, batch_axes=case["batch_axes"])
        losses.append(met["loss"].cpu().numpy().astype(np.float32))
        gnorms.append(met["grad_norm"].cpu().numpy().astype(np.float32))
        assert all(type(v) is torch.Tensor for v in met.values())
    return {"loss": np.stack(losses), "grad_norm": np.stack(gnorms),
            "params": _local(state.params),
            "placements": _placements(state.params)}


def vocab_parallel_run(mesh, case: dict) -> dict:
    """The vocabulary-parallel ``cross_entropy`` and ``embed_lookup`` on
    placed inputs (logits sharded (batch, -, vocab) over (data, model), a
    (vocab, d) table over model, ids over data): the values and the
    gradients' local shards."""
    from torch.distributed.tensor import DTensor

    dev = mesh_device(mesh)
    table = SS.place_value(torch.as_tensor(case["table"]).to(dev),
                           SH.P("model", None), mesh).requires_grad_(True)
    logits = SS.place_value(torch.as_tensor(case["logits"]).to(dev),
                            SH.P("data", None, "model"),
                            mesh).requires_grad_(True)
    ids = SS.place_value(torch.as_tensor(case["ids"]).to(dev),
                         SH.P("data", None), mesh)
    labels = SS.place_value(torch.as_tensor(case["labels"]).to(dev),
                            SH.P("data", None), mesh)
    emb = layers.embed_lookup(table, ids, torch.float32)
    ce = layers.cross_entropy(logits, labels, case["vocab"])
    w = SS.place_value(torch.as_tensor(case["emb_weight"]).to(dev),
                       SH.P("data", None, None), mesh)
    (emb * w).sum().backward()
    ce.backward()
    assert isinstance(emb, DTensor) and isinstance(ce, DTensor)
    return {"emb": emb.detach().full_tensor().cpu().numpy(),
            "ce": ce.detach().full_tensor().cpu().numpy(),
            "emb_placements": [repr(p) for p in emb.placements],
            "table_grad": table.grad.full_tensor().cpu().numpy(),
            "logits_grad": logits.grad.full_tensor().cpu().numpy()}


def placement_run(mesh, case: dict) -> dict:
    """The model's init from ``case["seed"]`` on the mesh (each rank's
    local shards, :meth:`Model.init`) and ``adamw_init``'s moment
    placements beside ``opt_partition_specs``' in each moment dtype."""
    dev = mesh_device(mesh)
    model = Model(ModelConfig(**case["cfg"]), mesh=mesh, device=dev)
    params = model.init(torch.Generator(device=dev).manual_seed(case["seed"]))
    out = {"params": _local(params), "placements": _placements(params),
           "specs": {}, "moments": {}}
    pspecs = model.partition_specs()
    for dt in ("float32", "bfloat16", "int8"):
        cfg = AdamWConfig(moment_dtype=dt)
        opt = adamw_init(params, cfg)
        meta = layers.tree_map(lambda t: torch.empty(t.shape, device="meta"),
                               params)
        want = SS.opt_partition_specs(adamw_init(meta, cfg), pspecs,
                                      SH.mesh_shape(mesh))
        got = _placements({"m": opt.m, "v": opt.v})
        out["specs"][dt] = _by_path(
            {"m": want.m, "v": want.v},
            lambda sp: [repr(p) for p in SH.to_placements(sp, mesh)])
        out["moments"][dt] = {"placements": got, "m": _local(opt.m),
                              "v": _local(opt.v),
                              "step": int(opt.step)}
    return out


def moe_block_run(mesh, case: dict) -> dict:
    """``moe_block`` on placed inputs (the router whole, the experts split
    over ``"model"``, the tokens over ``"data"``): its output at
    ``case["cf_drop"]``; at ``case["cf_all"]`` its output and the
    gradients of ``sum(out * w)`` by every param and the tokens, whole."""
    from repro_torch.models.moe import moe_block

    dev = mesh_device(mesh)
    specs = {"router": SH.P(None, None), "gate": SH.P("model", None, None),
             "up": SH.P("model", None, None),
             "down": SH.P("model", None, None)}

    def placed(a, spec):
        return SS.place_value(torch.as_tensor(a).to(dev), spec, mesh)
    out = {}
    for key in ("cf_drop", "cf_all"):
        cfg = ModelConfig(**{**case["cfg"], "capacity_factor": case[key]})
        p = {k: placed(v, specs[k]).requires_grad_(True)
             for k, v in case["p"].items()}
        x = placed(case["x"], SH.P("data", None, None)).requires_grad_(True)
        y, _ = moe_block(p, x, cfg=cfg)
        out[key] = y.detach().full_tensor().cpu().numpy()
        if key == "cf_all":
            (y * placed(case["w"], SH.P("data", None, None))).sum().backward()
            out["grads"] = {k: t.grad.full_tensor().cpu().numpy()
                            for k, t in {**p, "x": x}.items()}
    return out


class LocalMatmuls(TorchDispatchMode):
    """The ``aten.mm`` ops a rank runs on its own tensors, at their local
    shapes, with ``torch.utils.flop_counter``'s FLOPs for each: DTensor
    ops are declined (DTensor runs them and issues the local ops, which
    come back here); its sharding propagation, on meta or fake tensors,
    is not counted.  (``FlopCounterMode`` counts a DTensor op at its
    global shapes, whatever each rank computes.)"""

    def __init__(self):
        super().__init__()
        self.mms: list[tuple[tuple, float]] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        if func._overloadpacket is torch.ops.aten.mm and not any(
                a.device.type == "meta" or isinstance(a, FakeTensor)
                for a in args[:2]):
            self.mms.append((tuple(out.shape), float(
                flop_registry[func._overloadpacket](*args, out_val=out))))
        return out


def kv_grad_run(mesh, case: dict) -> dict:
    """The loss and every gradient of ``case["cfg"]`` from the numpy params
    ``case["params"]`` on the batch ``case["batch"]`` (whole on every
    rank), the gradients gathered whole; and the shapes and FLOPs of the
    ``mm`` ops with ``K * hd`` output columns (:class:`LocalMatmuls`):
    the kv projections, forward and backward, whose weight gradients are
    the ones with d rows, whole or split."""
    dev = mesh_device(mesh)
    cfg = ModelConfig(**case["cfg"])
    model = Model(cfg, mesh=mesh, device=dev)
    params = model.place_params(params_from_numpy(case["params"], dev))
    params = layers.tree_map(lambda t: t.requires_grad_(True), params)
    batch = model.shard_batch(case["batch"])
    from torch.distributed.tensor.experimental import implicit_replication
    with implicit_replication(), LocalMatmuls() as counter:
        loss, _, grads = model._grads(params, batch)
    kv_cols = cfg.n_kv_heads * cfg.resolved_head_dim
    wk = params["layers"]["attn"]["wk"]
    return {"loss": float(loss.full_tensor() if hasattr(loss, "full_tensor")
                          else loss),
            "grads": [g.full_tensor().detach().cpu().numpy()
                      if hasattr(g, "full_tensor") else
                      g.detach().cpu().numpy() for g in grads],
            "kv_mms": [(shape, f) for shape, f in counter.mms
                       if shape[1] == kv_cols],
            "wk_placements": [repr(p) for p in wk.placements]}


def kv_grad_rank(mesh, cases: dict) -> dict:
    """Every case of ``test_torch_long_context.py``'s mesh tests."""
    return {name: kv_grad_run(mesh, case) for name, case in cases.items()}


def train_mesh_rank(mesh, cases: dict) -> dict:
    """Every case of ``test_torch_train_mesh.py`` on this rank: ``kind``
    names the body (:func:`mesh_train_run`, :func:`vocab_parallel_run`,
    :func:`placement_run`, :func:`moe_block_run`)."""
    bodies = {"train": mesh_train_run, "vocab": vocab_parallel_run,
              "placement": placement_run, "moe": moe_block_run}
    return {name: bodies[case["kind"]](mesh, case)
            for name, case in cases.items()}
