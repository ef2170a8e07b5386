"""Continuous-batching serving engine: executes the scheduler's TickPlans.

The counterpart of ``repro.serving.engine`` on PyTorch.  A fixed decode
batch of ``slots``; each tick the scheduler decides admissions,
prefill-chunk assignments and the decode set, and the engine runs at
most three batched dispatches: admit (row recycling, or the one-shot
padded ``prefill_step`` in the batched/serial modes), one fixed-shape
``prefill_chunk`` call, and one ``serve_step`` decode with a ``live``
mask.  KV is dense per slot (``kv="dense"``) or a block pool with
refcounted shared prefixes (``kv="paged"``).  A sliding-window family
runs the pool as a ring (window-sized block tables, rewritten in place
as the window slides) and a layer-pattern stack (gemma3) as a
:class:`MixedKVPool`: a classic lease for its global layers and a ring
lease for its sliding ones, each request holding both.  The recurrent
families (``ssm``: mamba2; ``hybrid``: hymba) carry constant-size SSM
state per slot beside their dense KV, if any: nothing of theirs pages,
their plan's ``kv_growth`` reads ``"constant"``, and the one-shot
prefill modes batch equal-length prompts instead of padding them (a
recurrent scan would run through the padded tail).

Every hot-path dispatch routes through a :class:`KernelPlan`: by default
the ``kernel_select`` pass picks per site — the hand-written CUDA
kernels on a CUDA engine, plain torch on the host.  The reference's
jitted entries become a per-model table of step bodies
(:func:`_serving_calls`).  With ``graphed=True`` (one device's default) the
entries that run every decode tick — ``serve`` (reference sampler),
``serve_sample`` (decode, ``fused_mask`` and the draw: tokens out) and
``verify`` (per draft width; with the grid sampler under a fused plan)
— run as per-engine CUDA graphs (``serving.graphs``) over static input
buffers, with the result's copy to pinned host memory the tick's only
synchronization; on a CPU engine the same staged bodies run eagerly.
``graphed=False`` calls the bodies directly with fresh tensors (the
eager path that tests and timings compare against).  Prefill, admission
and rollback stay eager.

Speculative decoding (``spec``, ``draft_model``; ``serving.speculative``)
proposes drafts per decode slot, scores them in one verify step and
commits the longest prefix the target's keyed samples agree with,
rolling the caches back over the rest: the emitted streams are the
spec-off engine's, bit for bit.

Stage times come from a :class:`StageTimer` that synchronizes the card
before a stage closes, so ``serve_schedule`` plans from step times.

``mesh`` (a ``repro_torch.distributed.tp.ServingMesh`` of more than one
rank) makes this engine one rank of a concat-TP deployment: every rank
runs an engine over the same requests in the same order, holding its
slice of the attention heads and MLP columns (``shard_params``) and
caches at ``K / shards`` kv heads; each step gathers head outputs and
MLP activations across the ranks, so every rank holds the same logits
and its host scheduling makes the same decisions: it is deterministic
given the plan, and a replan reads rank 0's step times on every rank
(``ServingMesh.agree``), never a rank's own.  A sharded engine runs its steps eagerly: a gloo collective
cannot be captured in a CUDA graph.  Replicas of an engine go behind a
``serving.router.ReplicaRouter``.
"""
from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from ..core.pipeline import KernelPlan, StageTimer
from ..distributed import tp as _tp
from ..kernels.fused_sampler import ops as fused_ops
from ..models import cache_family as CF
from .graphs import StaticInputs, StepGraphs, tensor_key
from .kv_pool import KVBlockPool, MixedKVPool, PoolConfig
from .sampling import SamplingParams, sample_token_grid, sample_tokens
from .scheduler import Scheduler, SchedulerConfig, TickPlan, serve_plan_graph
from .speculative import (SPEC_OFF, DraftModelProposer, NGramProposer,
                          SpecParams, SpecStats)

#: the sampling policy's static buffers, in ``_sampling_arrays`` order
_POLICY = ("seeds", "steps", "temps", "ks", "ps")


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int = 16
    #: per-request generation policy; None = the engine's default
    sampling: SamplingParams | None = None
    #: higher admits first and may preempt strictly-lower DECODE slots
    priority: int = 0
    #: per-request speculative-decoding policy; None = the engine's default
    spec: SpecParams | None = None
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


def settle_ticks(prompt_len: int, chunk: int) -> int:
    """Ticks for a fresh admission wave to clear chunked prefill and settle
    into decode (drivers wait this long before injecting late
    high-priority work)."""
    return 2 * max(1, -(-prompt_len // max(chunk, 1))) + 1


def _serving_calls(model, max_len: int, plan: KernelPlan,
                   mesh=None) -> dict:
    """The serving step bodies, cached **on the model** per ``(max_len,
    plan, mesh)`` — the counterpart of the reference's jit cache; ``mesh``
    (a concat-TP mesh of more than one rank, else None) threads through
    the decode, verify and chunk bodies as their ``shard_axis``.  An engine
    calls them directly (eager) or captures ``serve``, ``serve_sample``,
    ``verify`` and ``verify_sample`` as CUDA graphs (``serving.graphs``).
    Decode, verify, one-shot and chunked prefill all run under ``plan``
    (its ``linked_matmul`` site routes every layer's SwiGLU MLP).
    The plan's ``sampler`` site picks the sampling lowering:
    ``"reference"`` (two-sort ``sample_tokens`` / ``sample_token_grid``,
    their own dispatch after the step) or ``"fused"`` / ``"cuda"`` (the
    fused sampler — one-sort torch or the ``fused_mask`` kernel — plus
    ``serve_sample`` and ``verify_sample``, step and sampling in one
    body)."""
    cache = getattr(model, "_serving_call_cache", None)
    if cache is None:
        cache = {}
        model._serving_call_cache = cache
    key = (max_len, plan, mesh)
    if key not in cache:
        vocab = model.cfg.vocab

        def serve(p, c, t, live):
            return model.serve_step(p, c, t, live=live, plan=plan,
                                    shard_axis=mesh)

        def verify(p, c, t, n_new):
            return model.verify_step(p, c, t, n_new, plan=plan,
                                     shard_axis=mesh)

        if plan.sampler == "reference":
            sample = functools.partial(sample_tokens, vocab=vocab)
            sample_grid = functools.partial(sample_token_grid, vocab=vocab)
            serve_sample = verify_sample = None
        else:
            backend = "cuda" if plan.sampler == "cuda" else "torch"
            sample = functools.partial(fused_ops.fused_sample, vocab=vocab,
                                       backend=backend)
            sample_grid = functools.partial(fused_ops.fused_sample_grid,
                                            vocab=vocab, backend=backend)

            def serve_sample(p, c, t, live, seeds, steps, temps, ks, ps):
                logits, c = serve(p, c, t, live)
                return sample(logits, seeds, steps, temps, ks, ps), c

            def verify_sample(p, c, t, n_new, seeds, steps, temps, ks, ps):
                logits, c = verify(p, c, t, n_new)
                return sample_grid(logits, seeds, steps, temps, ks, ps), c

        cache[key] = {
            "serve": serve,
            "prefill": lambda p, b: model.prefill_step(p, b, max_len=max_len,
                                                       plan=plan),
            "chunk": functools.partial(model.prefill_chunk, plan=plan,
                                       shard_axis=mesh),
            "reset": model.reset_cache_rows,
            "sample": sample,
            "serve_sample": serve_sample,
            "verify": verify,
            "verify_sample": verify_sample,
            "rollback": model.rollback_cache_rows,
            "sample_grid": sample_grid,
        }
    return cache[key]


def _device_id(device: torch.device) -> tuple:
    """``(type, index)``, an unindexed CUDA device as the current one."""
    if device.type == "cuda" and device.index is None:
        return ("cuda", torch.cuda.current_device())
    return (device.type, device.index)


def _leaves(tree) -> list:
    """The tensor leaves of a cache tree (tuples and named tuples), in
    order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    return [t for v in tree for t in _leaves(v)]


class ServingEngine:
    def __init__(self, model, params, *, slots: int = 4, max_len: int = 256,
                 eos_id: int = -1, prefill_mode: str | None = None,
                 chunk: int = 32, replan_every: int = 32, kv: str = "dense",
                 kv_block_size: int | None = None,
                 kv_pool_blocks: int | None = None,
                 kernel_plan: KernelPlan | None = None,
                 spec: SpecParams | None = None, spec_k_max: int = 16,
                 draft_model=None, draft_params=None,
                 graphed: bool | None = None, mesh=None):
        if kv not in ("dense", "paged"):
            raise ValueError(f"unknown kv mode {kv!r}; have dense|paged")
        self.model = model
        self.device = model.device
        #: the concat-TP mesh (``repro_torch.distributed.tp``), validated
        #: here so an incompatible config fails at construction
        self.mesh = mesh
        self.mesh_shards = _tp.validate_serving_tp(model.cfg, mesh)
        if self.mesh_shards > 1:
            if _device_id(mesh.device) != _device_id(self.device):
                raise ValueError(
                    f"the model lives on {self.device}, this rank of the "
                    f"mesh on {mesh.device}")
            # this rank's slice of every sharded leaf, sliced once
            params = _tp.shard_params(
                params, self.mesh_shards, mesh.rank,
                _tp.serving_param_specs(model.param_specs()))
        #: the serving copy of the weights (this rank's slices on a mesh),
        #: in cfg.dtype (cast once here)
        self.params = model.cast_params(params)
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.kv = kv
        self.pool: KVBlockPool | MixedKVPool | None = None
        #: ring-window width (tokens) when the paged pool runs in ring or
        #: mixed mode — ring leases price this, not the decode horizon
        self._kv_window = 0
        #: the policy of requests that carry no SamplingParams: greedy
        self.default_sampling = SamplingParams()
        self.timer = StageTimer(
            synchronize=(lambda: torch.cuda.synchronize(self.device))
            if self.device.type == "cuda" else None)
        self.tokens_out = 0        # every generated token (prefill + decode)
        self._decode_tokens = 0    # decode-loop tokens only (throughput)
        self._prefill_tokens = 0   # prompt tokens pushed through prefill
        #: speculative policy for requests that carry no SpecParams of
        #: their own; SPEC_OFF = plain one-token-per-tick decode
        self.default_spec = spec if spec is not None else SPEC_OFF
        self._spec_k_max = int(spec_k_max)
        self.spec_stats = SpecStats()
        self._ngram = NGramProposer()
        self._draft: DraftModelProposer | None = None
        if draft_model is not None:
            if draft_model.cfg.vocab != model.cfg.vocab:
                # the draft's embedding is indexed by the target's tokens
                raise ValueError(
                    f"the draft model's vocab ({draft_model.cfg.vocab}) "
                    f"must be the target's ({model.cfg.vocab})")
            self._draft = DraftModelProposer(
                draft_model, draft_params, slots=slots, max_len=max_len)
        if self.default_spec.mode == "draft" and self._draft is None:
            raise ValueError(
                "spec mode 'draft' needs a draft_model (a reduced config "
                "from repro_torch.configs — see ModelConfig.reduced())")
        if self.default_spec.mode != "off":
            self._check_spec_model(model.cfg)

        cfg = model.cfg
        if self.mesh_shards > 1 and any(f.ssm
                                        for f in CF.layer_cache_families(cfg)):
            raise ValueError(
                "mesh-sharded serving does not support constant-state "
                f"(SSM/hybrid) families ({CF.family_label(cfg)}): the "
                "concat-TP partition specs cover attention KV only")
        if self.mesh_shards > 1 and getattr(cfg, "layer_pattern", ""):
            raise ValueError(
                "mesh-sharded serving does not support heterogeneous "
                f"(layer_pattern={cfg.layer_pattern!r}) cache stacks")
        auto_mode = prefill_mode is None
        if auto_mode:
            prefill_mode = ("chunked" if CF.supports_chunked_prefill(cfg)
                            else "batched")
        if self.mesh_shards > 1 and prefill_mode != "chunked":
            # the one-shot prefill_step path is not shard-threaded; every
            # sharded dispatch goes through the chunked entries
            raise ValueError(
                f"a mesh-sharded engine requires prefill_mode='chunked', "
                f"not {prefill_mode!r}")
        if graphed is None:
            graphed = self.mesh_shards == 1
        if graphed and self.mesh_shards > 1:
            why = ("a gloo collective cannot be captured in a CUDA graph"
                   if mesh.backend == "gloo" else
                   "capturing the sharded step over NCCL is not ported")
            raise ValueError(
                f"a mesh-sharded engine runs its steps eagerly "
                f"(graphed=False): its steps gather over "
                f"torch.distributed ({mesh.backend}), and {why}")
        if kv == "paged" and not CF.supports_paged(cfg):
            raise ValueError(
                f"kv='paged' needs an attention KV family, not "
                f"{CF.family_label(cfg)} (constant-state layers hold no "
                "pageable KV)")
        if kv == "paged" and prefill_mode != "chunked":
            raise ValueError(f"kv='paged' requires prefill_mode='chunked', "
                             f"not {prefill_mode!r}")
        if prefill_mode == "chunked" and not CF.supports_chunked_prefill(cfg):
            raise ValueError(f"{cfg.family} cannot run chunked prefill; "
                             f"use prefill_mode='batched'")
        self.scheduler = Scheduler(
            SchedulerConfig(slots=slots, max_len=max_len, chunk=chunk,
                            prefill_mode=prefill_mode,
                            replan_every=replan_every),
            plan_graph=serve_plan_graph(
                cfg.name, slots, cfg.d_model, cfg.d_ff or cfg.d_model,
                cfg.vocab))
        self.scheduler.eos_id = None if eos_id < 0 else eos_id
        self.scheduler.chunk_supported = CF.supports_chunked_prefill(cfg)
        # the dataflow shape serve_schedule prices, from the per-layer
        # descriptors: a window bounds per-request KV, a mixed stack grows
        # per layer kind
        plan_window = CF.kv_plan_window(cfg)
        if plan_window:
            self.scheduler.kv_window = min(plan_window, max_len)
        self.scheduler.kv_mixed = CF.family_label(cfg) == "mixed"
        self.scheduler.constant_state = any(
            f.ssm for f in CF.layer_cache_families(cfg))
        # replans feed the observed acceptance rate through serve_schedule
        # and adopt its planned spec_k (requests with k=None use it)
        self.scheduler.spec_mode = self.default_spec.mode
        # a pinned mode stays pinned; an auto dense engine lets
        # serve_schedule switch batched<->chunked from observed stats (not
        # a sharded one: the one-shot path is not shard-threaded)
        self.scheduler.adopt_prefill_mode = (auto_mode and kv != "paged"
                                             and self.mesh_shards == 1)
        # replans price the per-dispatch gathers of a sharded plan
        self.scheduler.mesh_shards = self.mesh_shards

        if kv == "paged":
            self._init_paged_kv(kv_block_size, kv_pool_blocks)
        else:
            self.caches = model.init_caches(slots, max_len,
                                            shards=self.mesh_shards)
        self.scheduler.last_plan["kv_growth"] = (
            "constant" if self.scheduler.constant_state
            else "mixed" if self.scheduler.kv_mixed
            else "window" if self.scheduler.kv_window else "linear")
        self._kernel_report = None  # PassReport when the plan was routed
        self.kernel_plan = self._resolve_kernel_plan(kernel_plan)
        self.scheduler.kernel_plan = self.kernel_plan.as_dict()
        #: the token each slot feeds its next decode step (host copy)
        self._last_tokens = np.zeros((slots, 1), np.int64)
        calls = _serving_calls(model, max_len, self.kernel_plan,
                               mesh if self.mesh_shards > 1 else None)
        self._serve = calls["serve"]
        self._prefill = calls["prefill"]
        self._chunk_step = calls["chunk"]
        self._reset_rows = calls["reset"]
        self._sample_step = calls["sample"]
        self._serve_sample = calls["serve_sample"]
        self._verify = calls["verify"]
        self._verify_sample = calls["verify_sample"]
        self._rollback = calls["rollback"]
        self._sample_grid_step = calls["sample_grid"]
        #: run the per-tick steps staged (captured as CUDA graphs on the
        #: card, eagerly on the host) instead of calling them directly;
        #: the default for one device, refused on a mesh
        self.graphed = graphed
        self.graphs = StepGraphs()
        self._static = StaticInputs(self.device)
        #: decode (width 1) and verify (width K1) steps by width: steady
        #: calls and seconds, and the steps that captured a graph
        self.steps: dict[int, dict] = {}
        #: dispatches of a sampler (its eager calls and the replays of a
        #: graph that samples): each launches the fused sampler once
        #: under a fused plan
        self.sampler_calls = 0

    @staticmethod
    def _check_spec_model(cfg, rid: int | None = None) -> None:
        """Speculative decoding rewinds the KV cache by position, which
        only a full-attention family supports.  With ``rid`` the error
        names the offending request (the per-request ``submit()``
        path)."""
        if not CF.supports_spec(cfg):
            who = f"request {rid}: " if rid is not None else ""
            raise ValueError(
                f"{who}speculative decoding needs a full-attention family, "
                f"not {cfg.family}"
                + (" with a sliding window" if cfg.sliding_window else "")
                + " (rollback across an evicted window block or recurrent "
                "state is undefined)")

    def _resolve_kernel_plan(self, kernel_plan) -> KernelPlan:
        """``None`` runs the ``kernel_select`` pass (the decision lands in
        ``stats()["kernel_report"]``); an explicit :class:`KernelPlan`
        (``KernelPlan()`` is the plain-torch seed path) is honored."""
        if kernel_plan is not None:
            if not isinstance(kernel_plan, KernelPlan):
                raise ValueError(
                    f"kernel_plan must be a KernelPlan or None, "
                    f"got {kernel_plan!r}")
            return kernel_plan
        from ..core import pipeline
        cfg = self.model.cfg
        options = {
            "accelerator": self.device.type,
            "slots": self.slots, "max_len": self.max_len,
            "q_heads": cfg.n_heads, "kv_heads": cfg.n_kv_heads,
            "head_dim": cfg.resolved_head_dim,
        }
        if self.mesh_shards > 1:
            options["mesh_shards"] = self.mesh_shards
        if self.pool is not None:
            options["kv_block_size"] = self.pool.cfg.block_size
            options["kv_pool_blocks"] = self.pool.cfg.pool_blocks
        _, report = pipeline.optimize(self.scheduler.plan_graph,
                                      passes=("kernel_select",),
                                      options=options)
        self._kernel_report = report
        summary = report.passes[-1].summary
        return KernelPlan(**{site: summary[site]
                             for site in KernelPlan().as_dict()})

    # -- paged KV -------------------------------------------------------------
    def _init_paged_kv(self, block_size: int | None,
                       pool_blocks: int | None) -> None:
        """Build the block pool; unset geometry comes from the
        ``serve_schedule`` pass (block size clamped to the prefill chunk,
        capacity the dense-equivalent token budget).

        A sliding family runs the pool as a **ring** (``CF.paged_kind``):
        each slot's table tiles the window, writes wrap in place, and
        admission prices window-sized leases.  A layer-pattern stack runs
        **mixed**: a :class:`MixedKVPool` leases a classic table (the
        horizon) for the global layers and a ring table (the window) for
        the sliding ones."""
        cfg = self.model.cfg
        kind = CF.paged_kind(cfg)
        window = 0
        if kind in ("ring", "mixed"):
            window = min(CF.kv_plan_window(cfg), self.max_len)
            if self.scheduler.cfg.chunk > window:
                raise ValueError(
                    f"{kind} paged KV needs chunk "
                    f"({self.scheduler.cfg.chunk}) <= window ({window}): a "
                    "larger chunk would write the same ring slot twice in "
                    "one scatter")
        # the span one slot's classic table tiles: the window in ring mode,
        # the horizon otherwise (mixed keeps the horizon on its global
        # layers; its ring table is sized below)
        horizon = self.max_len if kind == "mixed" else (window or
                                                        self.max_len)
        if block_size is None or pool_blocks is None:
            from ..core import pipeline
            options = {"slots": self.slots, "max_len": self.max_len,
                       "kv": "paged", "can_chunk": True,
                       "replan_every": self.scheduler.cfg.replan_every}
            if window:
                options["sliding_window"] = window
            if kind == "mixed":
                options["kv_mixed"] = True
            if self.mesh_shards > 1:
                options["mesh_shards"] = self.mesh_shards
            _, report = pipeline.optimize(
                self.scheduler.plan_graph,
                passes=("serve_schedule",), options=options)
            plan = report.passes[-1].summary
            if block_size is None:
                block_size = int(plan["kv_block_size"])
                fitting = [b for b in pipeline.SERVE_KV_BLOCK_SIZES
                           if horizon % b == 0
                           and (not window or window % b == 0)
                           and b <= max(self.scheduler.cfg.chunk, 8)]
                if fitting:
                    block_size = min(block_size, max(fitting))
            if pool_blocks is None:
                pool_blocks = self.slots * (horizon // block_size)
        if horizon % block_size:
            what = f"window {horizon}" if window and kind != "mixed" \
                else f"max_len {self.max_len}"
            raise ValueError(
                f"{what} is not a multiple of the KV block size "
                f"{block_size}: the block table must tile it exactly "
                "(this is also what keeps paged and dense decode "
                "bit-identical)")
        if kind == "mixed" and window % block_size:
            raise ValueError(
                f"window {window} is not a multiple of the KV block size "
                f"{block_size}: the ring block table must tile it exactly")
        max_blocks = horizon // block_size
        self._kv_window = window
        if kind == "mixed":
            ring_max = window // block_size
            ring_blocks = self.slots * ring_max
            self.pool = MixedKVPool(
                PoolConfig(block_size=block_size, pool_blocks=pool_blocks,
                           max_blocks_per_seq=max_blocks),
                PoolConfig(block_size=block_size, pool_blocks=ring_blocks,
                           max_blocks_per_seq=ring_max),
                window)
            self.caches = self.model.init_paged_caches(
                self.slots, pool_blocks=pool_blocks, block_size=block_size,
                max_blocks=max_blocks, ring_pool_blocks=ring_blocks,
                ring_max_blocks=ring_max)
        else:
            self.pool = KVBlockPool(PoolConfig(
                block_size=block_size, pool_blocks=pool_blocks,
                max_blocks_per_seq=max_blocks, shards=self.mesh_shards))
            self.caches = self.model.init_paged_caches(
                self.slots, pool_blocks=pool_blocks, block_size=block_size,
                max_blocks=max_blocks, shards=self.mesh_shards)
        self.scheduler.kv_mode = "paged"
        self.scheduler.kv_window = window
        self.scheduler.kv_gate = self._kv_gate
        self.scheduler.on_admit = self._kv_on_admit
        self.scheduler.on_release = self._kv_on_release

    def _kv_horizon(self, sreq) -> int:
        remaining = max(sreq.req.max_new_tokens - len(sreq.req.generated), 0)
        return min(sreq.prompt_len + remaining, self.max_len)

    def _kv_gate(self, sreq, victim=None) -> bool:
        ok = self.pool.can_admit(
            sreq.prompt_tokens, self._kv_horizon(sreq),
            victim_rid=victim.req.rid if victim is not None else None,
            window=self._kv_window)
        if not ok:
            self.pool.gated_rids.add(sreq.req.rid)
        return ok

    def _kv_on_admit(self, sreq) -> None:
        _, cached = self.pool.allocate(sreq.req.rid, sreq.prompt_tokens,
                                       self._kv_horizon(sreq),
                                       window=self._kv_window)
        sreq.pos = cached

    def _kv_on_release(self, sreq) -> None:
        if self.pool.holds(sreq.req.rid):
            self.pool.free(sreq.req.rid)

    # -- public API -----------------------------------------------------------
    def submit(self, req: Request) -> None:
        rspec = req.spec if req.spec is not None else self.default_spec
        if rspec.mode != "off":
            self._check_spec_model(self.model.cfg, rid=req.rid)
            if rspec.mode == "draft" and self._draft is None:
                raise ValueError(
                    f"request {req.rid} wants spec mode 'draft' but the "
                    "engine holds no draft model")
            if self.pool is None \
                    and len(req.prompt) + req.max_new_tokens > self.max_len:
                # rollback rewinds the dense ring by absolute position,
                # which a wrapped ring has overwritten
                raise ValueError(
                    f"request {req.rid}: prompt ({len(req.prompt)}) + "
                    f"max_new_tokens ({req.max_new_tokens}) exceeds the "
                    f"{self.max_len}-token horizon; a speculative request "
                    "cannot wrap the dense KV ring (its rollback rewinds "
                    "by position)")
        if self.pool is not None \
                and len(req.prompt) + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"request {req.rid}: prompt ({len(req.prompt)}) + "
                f"max_new_tokens ({req.max_new_tokens}) exceeds the "
                f"{self.max_len}-token KV horizon of the paged pool")
        self.scheduler.submit(req)

    def step(self) -> int:
        """One engine tick.  Returns the slots that produced a token."""
        plan = self.scheduler.plan_tick()
        produced = 0
        if plan.admissions:
            with self.timer.stage("admit"):
                self._admit(plan)
            if self.scheduler.cfg.prefill_mode != "chunked":
                produced += len(plan.admissions)
        if plan.prefill:
            with self.timer.stage("prefill_chunk"):
                produced += self._prefill_chunks(plan)
        if plan.decode_slots:
            drafts = self._plan_drafts(plan)
            if drafts:
                produced += self._timed_step(
                    "verify", 1 + max(len(d) for d in drafts.values()),
                    self._decode_verify, plan, drafts)
            else:
                # no slot drafted this tick: the plain one-token decode
                # dispatch, exactly as a spec=off engine would run it
                produced += self._timed_step("decode", 1, self._decode, plan)
        self._maybe_replan()
        return produced

    def _timed_step(self, stage: str, width: int, fn, *args) -> int:
        """Run a decode (width 1) or verify (width K1) step under stage
        ``stage``, or ``<stage>_capture`` when it captured a CUDA graph (a
        one-off, kept out of the steady means the replan reads), and file
        its time in ``self.steps`` by width."""
        captures = self.graphs.captures
        with self.timer.stage(stage) as st:
            produced = fn(*args)
            captured = self.graphs.captures != captures \
                and self.device.type == "cuda"
            if captured:
                st.name = f"{stage}_capture"
        w = self.steps.setdefault(width, {"calls": 0, "total_s": 0.0,
                                          "captures": 0, "capture_s": 0.0})
        w["captures" if captured else "calls"] += 1
        w["capture_s" if captured else "total_s"] += st.dt
        return produced

    def run(self, max_steps: int = 10_000) -> None:
        steps = 0
        while self.scheduler.pending() and steps < max_steps:
            self.step()
            steps += 1

    # -- admission ------------------------------------------------------------
    def _admit(self, plan: TickPlan) -> None:
        if self.scheduler.cfg.prefill_mode == "chunked":
            if self.pool is not None:
                self._install_leases(plan)
                return
            rows = np.zeros((self.slots,), bool)
            for sreq in plan.admissions:
                rows[sreq.slot] = True
            self._reset_rows(self.caches, torch.from_numpy(rows))
            return
        # one-shot modes: batched padded prefill of the admission set; a
        # recurrent family cannot mask a padded tail out of its state scan,
        # so it batches groups of equal-length prompts instead
        paddable = self.model.cfg.attention_only
        if self.scheduler.cfg.prefill_mode == "serial" or \
                len(plan.admissions) == 1:
            groups = [[s] for s in plan.admissions]
        elif paddable:
            groups = [list(plan.admissions)]
        else:
            by_len: dict[int, list] = {}
            for s in plan.admissions:
                by_len.setdefault(s.prompt_len, []).append(s)
            groups = list(by_len.values())
        for group in groups:
            self._prefill_group(group, padded=paddable and len(group) > 1)

    def _install_leases(self, plan: TickPlan) -> None:
        """Point the admitted slots' block tables at their leases, in
        place; length starts at the prefix-cache hit.  A ring cache (the
        one carrying per-slot positions) also forgets the slot's previous
        occupant.  Under a :class:`MixedKVPool` the ring table goes on the
        sliding layers and the classic one on the global layers; a
        stacked cache (leading layer axis) shares one table over every
        layer."""
        per_layer = type(self.caches) is tuple
        mixed = isinstance(self.pool, MixedKVPool)
        for c in (self.caches if per_layer else (self.caches,)):
            kv = c.kv
            ring = hasattr(kv, "positions")
            for sreq in plan.admissions:
                rid = sreq.req.rid
                table = self.pool.ring_block_table(rid) if ring and mixed \
                    else self.pool.block_table(rid)
                row = (sreq.slot,) if per_layer else (slice(None), sreq.slot)
                kv.block_tables[row] = torch.from_numpy(table).to(
                    self.device)
                kv.length[row] = sreq.pos
                if ring:
                    kv.positions[row] = -1

    def _prefill_group(self, group, padded: bool) -> None:
        lens = [s.prompt_len for s in group]
        S = max(lens)
        toks = np.zeros((len(group), S), np.int64)
        for i, s in enumerate(group):
            toks[i, :lens[i]] = s.prompt_tokens
        batch = {"tokens": torch.from_numpy(toks)}
        if padded:
            batch["lengths"] = torch.tensor(lens, dtype=torch.int32)
        logits, fresh = self._prefill(self.params, batch)
        # splice the prefilled rows into their slots, every leaf (KV and
        # SSM state), in place (a layer-pattern tuple's leaves are
        # batch-major: no layer axis)
        slots = torch.tensor([s.slot for s in group], device=self.device)
        lead = (slots,) if type(self.caches) is tuple \
            else (slice(None), slots)
        for full, one in zip(_leaves(self.caches), _leaves(fresh)):
            full[lead] = one
        toks_out = self._sample(logits, group)
        for i, sreq in enumerate(group):
            t = int(toks_out[i])
            self._last_tokens[sreq.slot, 0] = t
            self._prefill_tokens += lens[i]
            self.tokens_out += 1  # first token comes out of the prefill
            self.scheduler.note_admitted_prefilled(sreq, t)

    # -- chunked prefill ------------------------------------------------------
    def _prefill_chunks(self, plan: TickPlan) -> int:
        C = self.scheduler.cfg.chunk
        toks = np.zeros((self.slots, C), np.int64)
        offsets = np.zeros((self.slots,), np.int32)
        n_new = np.zeros((self.slots,), np.int32)
        rows: list = [None] * self.slots
        for a in plan.prefill:
            toks[a.slot, :a.n_new] = \
                a.sreq.prompt_tokens[a.start:a.start + a.n_new]
            offsets[a.slot] = a.start
            n_new[a.slot] = a.n_new
            rows[a.slot] = a.sreq
        logits, self.caches = self._chunk_step(
            self.params, self.caches, torch.from_numpy(toks),
            torch.from_numpy(offsets), torch.from_numpy(n_new))
        toks_out = None
        if any(a.start + a.n_new >= a.sreq.prompt_len for a in plan.prefill):
            toks_out = self._sample(logits, rows)
        produced = 0
        for a in plan.prefill:
            self._prefill_tokens += a.n_new
            done = a.start + a.n_new >= a.sreq.prompt_len
            first = int(toks_out[a.slot]) if done else None
            if self.pool is not None:
                # register freshly full prefill blocks in the prefix cache
                self.pool.note_prefilled(a.sreq.req.rid, a.start + a.n_new)
            if done:
                self._last_tokens[a.slot, 0] = first
                self.tokens_out += 1
                produced += 1
            self.scheduler.note_prefilled(a.sreq, a.n_new, first)
        return produced

    # -- speculative decode ---------------------------------------------------
    def _resolve_spec(self, sreq) -> tuple[SpecParams, int]:
        """A request's effective spec policy (its own SpecParams, or the
        engine default) and draft length."""
        sp = sreq.req.spec if sreq.req.spec is not None else self.default_spec
        return sp, self._spec_k(sp)

    def _spec_k(self, sp: SpecParams) -> int:
        """The draft length under ``sp`` (0 when off): ``k=None`` takes
        the serve_schedule-planned ``spec_k`` (4 before any plan), capped
        at ``spec_k_max``."""
        if sp.mode == "off":
            return 0
        k = sp.k
        if k is None:
            k = self.scheduler.cfg.spec_k
            if k is None:
                k = 4
        return min(int(k), self._spec_k_max)

    def _plan_drafts(self, plan: TickPlan) -> dict[int, np.ndarray]:
        """Draft tokens per decode slot (empty: the tick runs the plain
        decode step).  A row drafts at most ``remaining - 1`` tokens (the
        verify's bonus token then lands exactly on the budget) and at most
        ``max_len - 1 - L`` (every write stays inside the horizon)."""
        out: dict[int, np.ndarray] = {}
        draft_rows: list[tuple[int, int, np.ndarray, int]] = []
        for slot in plan.decode_slots:
            sreq = self.scheduler.active[slot]
            sp, k = self._resolve_spec(sreq)
            if k <= 0:
                continue
            req = sreq.req
            remaining = req.max_new_tokens - len(req.generated)
            cache_len = len(req.prompt) + len(req.generated) - 1
            k = min(k, remaining - 1, self.max_len - 1 - cache_len)
            if k <= 0:
                continue
            context = np.concatenate(
                [np.asarray(req.prompt, np.int64),
                 np.asarray(req.generated, np.int64)])
            if sp.mode == "ngram":
                d = self._ngram.propose(context, k, sp)
                if len(d):
                    out[slot] = d
            else:
                draft_rows.append((slot, req.rid, context, k))
        if draft_rows:
            for slot, d in self._draft.propose(draft_rows).items():
                if len(d):
                    out[slot] = d
        return out

    def _decode_verify(self, plan: TickPlan, drafts: dict[int, np.ndarray]
                       ) -> int:
        """One verify step for the whole decode set: each drafting row
        scores ``[pending, d_1..d_k]``, the others ride along with one
        position.  Commit the longest prefix whose drafts match the
        target's keyed samples plus the token at the first mismatch; roll
        the rejected suffix's writes back, so the caches end as a plain
        decode history would leave them."""
        B = self.slots
        K1 = 1 + max(len(d) for d in drafts.values())
        toks = np.zeros((B, K1), np.int64)
        n_new = np.zeros((B,), np.int32)
        rows: list = [None] * B
        pre_len = np.zeros((B,), np.int64)
        for slot in plan.decode_slots:
            sreq = self.scheduler.active[slot]
            rows[slot] = sreq
            d = drafts.get(slot)
            toks[slot, 0] = self._last_tokens[slot, 0]
            if d is not None:
                toks[slot, 1:1 + len(d)] = d
            n_new[slot] = 1 + (len(d) if d is not None else 0)
            # context tokens cached before this tick: prompt + emitted - 1
            # (the newest emitted token is still pending, never written)
            pre_len[slot] = (len(sreq.req.prompt)
                             + len(sreq.req.generated) - 1)
        if self.graphed:
            targets = self._verify_staged(toks, n_new, rows)
        else:
            logits, self.caches = self._verify(
                self.params, self.caches, torch.from_numpy(toks),
                torch.from_numpy(n_new))
            targets = self._sample_grid(logits, rows)
        self.spec_stats.verify_calls += 1
        self.spec_stats.verify_positions += int(n_new.sum())

        produced = 0
        keep_len = np.zeros((B,), np.int32)
        rollback = np.zeros((B,), bool)
        for slot in plan.decode_slots:
            sreq = rows[slot]
            d = drafts.get(slot, np.zeros((0,), np.int32))
            n = 1 + len(d)
            commits = 0
            for i in range(n):
                t = int(targets[slot, i])
                self.tokens_out += 1
                self._decode_tokens += 1
                self._last_tokens[slot, 0] = t
                self.scheduler.note_decoded(slot, t)
                commits += 1
                produced += 1
                if sreq.req.done:
                    break           # EOS/budget retired mid-commit
                if i < len(d) and int(d[i]) != t:
                    break           # first rejected draft: t is the bonus
            self.spec_stats.drafts_proposed += len(d)
            self.spec_stats.drafts_accepted += commits - 1
            self.spec_stats.spec_tokens += commits
            if commits < n:
                keep_len[slot] = pre_len[slot] + commits
                rollback[slot] = True
        if rollback.any():
            self._rollback(self.caches, torch.from_numpy(keep_len),
                           torch.from_numpy(rollback))
        if self.pool is not None:
            self._spec_truncate_leases(plan, rows)
        return produced

    def _spec_truncate_leases(self, plan: TickPlan, rows: list) -> None:
        """Paged rollback, pool side: a decoding request never needs
        blocks past ``prompt + max_new - 1`` context tokens, so
        strandable tail blocks go back to the pool and the block-table
        row (written in place) forgets them."""
        bt = self.caches.kv.block_tables
        for slot in plan.decode_slots:
            sreq = rows[slot]
            rid = sreq.req.rid
            if sreq.req.done or not self.pool.holds(rid):
                continue
            needed = len(sreq.req.prompt) + sreq.req.max_new_tokens - 1
            if self.pool.truncate(rid, needed):
                bt[:, slot] = torch.from_numpy(
                    self.pool.block_table(rid)).to(self.device)

    # -- decode ---------------------------------------------------------------
    def _decode(self, plan: TickPlan) -> int:
        live = np.zeros((self.slots,), bool)
        rows: list = [None] * self.slots
        for slot in plan.decode_slots:
            live[slot] = True
            rows[slot] = self.scheduler.active[slot]
        if self.graphed:
            toks = self._decode_staged(live, rows)
        elif self._serve_sample is not None:
            # fused plan: decode then the fused sampler, back to back on
            # the stream; the copy of the tokens is the one sync
            self.sampler_calls += 1
            toks, self.caches = self._serve_sample(
                self.params, self.caches,
                torch.from_numpy(self._last_tokens), torch.from_numpy(live),
                *self._sampling_tensors(rows))
            toks = toks.cpu().numpy()
        else:
            logits, self.caches = self._serve(
                self.params, self.caches,
                torch.from_numpy(self._last_tokens), torch.from_numpy(live))
            toks = self._sample(logits, rows)
        for slot in plan.decode_slots:
            t = int(toks[slot])
            self.tokens_out += 1
            self._decode_tokens += 1
            self._last_tokens[slot, 0] = t
            self.scheduler.note_decoded(slot, t)
        return len(plan.decode_slots)

    # -- staged steps (CUDA graphs on the card) -------------------------------
    def _graph_key(self, inputs: dict) -> tuple:
        """What a captured step reads at fixed addresses: the parameters,
        the caches and the static inputs, plus the slots, KV layout and
        kernel plan it was built for."""
        return (self.slots, self.kv, self.kernel_plan, tensor_key(self.params),
                tensor_key(self.caches), tensor_key(inputs))

    def _staged(self, names: tuple[str, str], step, step_sample,
                inputs: dict, idle: str, rows, sample) -> np.ndarray:
        """Run a per-tick step through its graph: ``step`` under the
        reference sampler (logits out, then ``sample``'s own dispatch),
        else ``step_sample`` (tokens out, read back here).  ``names`` are
        the two graphs' entry names; the warm-up before a capture zeroes
        input ``idle`` (the step then writes no cache row).  The bodies
        take the engine's params and caches, then the inputs in order."""
        if step_sample is None:
            logits = self.graphs.run(
                names[0], lambda **ins: step(self.params, self.caches,
                                             *ins.values())[0],
                inputs, self._graph_key(inputs), (idle,))
            return sample(logits, rows)
        for name, a in zip(_POLICY, self._sampling_arrays(rows)):
            inputs[name] = self._static.put(name, a)
        self.sampler_calls += 1
        return self._static.read(self.graphs.run(
            names[1], lambda **ins: step_sample(self.params, self.caches,
                                                *ins.values())[0],
            inputs, self._graph_key(inputs), (idle,)))

    def _decode_staged(self, live: np.ndarray, rows) -> np.ndarray:
        """The decode step through ``serve`` / ``serve_sample``."""
        st = self._static
        return self._staged(
            ("serve", "serve_sample"), self._serve, self._serve_sample,
            {"tokens": st.put("tokens", self._last_tokens),
             "live": st.put("live", live)}, "live", rows, self._sample)

    def _verify_staged(self, toks: np.ndarray, n_new: np.ndarray,
                       rows) -> np.ndarray:
        """The verify step through ``verify/<K1>`` /
        ``verify_sample/<K1>``: one graph per draft width K1."""
        st = self._static
        K1 = toks.shape[1]
        return self._staged(
            (f"verify/{K1}", f"verify_sample/{K1}"), self._verify,
            self._verify_sample,
            {"tokens": st.put(f"tokens/{K1}", toks),
             "n_new": st.put("n_new", n_new)}, "n_new", rows,
            self._sample_grid)

    # -- sampling -------------------------------------------------------------
    def _sampling_arrays(self, rows):
        """Per-slot policy arrays (None rows take the default policy and
        are discarded); each row's key depends only on its request's seed
        and emitted-token count."""
        B = len(rows)
        seeds = np.zeros((B,), np.int64)
        steps = np.zeros((B,), np.int64)
        temps = np.zeros((B,), np.float32)
        ks = np.zeros((B,), np.int32)
        ps = np.ones((B,), np.float32)
        for i, sreq in enumerate(rows):
            if sreq is None:
                continue
            sp = sreq.req.sampling or self.default_sampling
            seeds[i] = sp.seed & 0xFFFFFFFF
            steps[i] = len(sreq.req.generated)
            temps[i] = sp.temperature
            ks[i] = sp.top_k
            ps[i] = sp.top_p
        return seeds, steps, temps, ks, ps

    def _sampling_tensors(self, rows):
        return tuple(torch.from_numpy(a).to(self.device)
                     for a in self._sampling_arrays(rows))

    def _sample(self, logits: torch.Tensor, rows) -> np.ndarray:
        """One batched sampling dispatch over (B, V) logits (the prefill
        paths, and decode under the reference-sampler plan)."""
        return self._draw(self._sample_step, logits, rows)

    def _sample_grid(self, logits: torch.Tensor, rows) -> np.ndarray:
        """Verify-tick sampling over (B, K1, V) logits: position ``i`` of
        row ``b`` uses key ``(seed_b, emitted_b + i)``, the key a plain
        decode step would use emitting that token."""
        return self._draw(self._sample_grid_step, logits, rows)

    def _draw(self, sampler, logits: torch.Tensor, rows) -> np.ndarray:
        temps = self._sampling_arrays(rows)[2]
        if not temps.any():
            # all-greedy batch: plain argmax, skip the sampler
            toks = torch.argmax(logits[..., :self.model.cfg.vocab], dim=-1)
            return toks.cpu().numpy()
        self.sampler_calls += 1
        return sampler(logits, *self._sampling_tensors(rows)).cpu().numpy()

    # -- re-planning / stats --------------------------------------------------
    def _maybe_replan(self) -> None:
        # verify steps are the spec engine's decode steps: fold them in
        # so a mostly-speculative workload still produces decode stats
        decode = (self.timer.totals.get("decode", 0.0)
                  + self.timer.totals.get("verify", 0.0))
        decode_calls = (self.timer.counts.get("decode", 0)
                        + self.timer.counts.get("verify", 0))
        prefill_s = (self.timer.totals.get("prefill_chunk", 0.0)
                     + self.timer.totals.get("admit", 0.0))
        accept = None
        if self.default_spec.mode != "off" \
                and self.spec_stats.drafts_proposed:
            accept = self.spec_stats.accept_rate
        decode_step_s = decode / decode_calls if decode_calls else 0.0
        prefill_token_s = (prefill_s / self._prefill_tokens
                           if self._prefill_tokens else 0.0)
        if self.mesh_shards > 1 and self.scheduler.replan_due():
            # each rank times its own steps: plan from rank 0's times on
            # every rank, so the mesh adopts one chunk and preempt bound
            decode_step_s, prefill_token_s = self.mesh.agree(
                [decode_step_s, prefill_token_s])
        t0 = time.perf_counter()
        plan = self.scheduler.maybe_replan(
            decode_step_s=decode_step_s, prefill_token_s=prefill_token_s,
            accept_rate=accept)
        if plan is not None:
            dt = time.perf_counter() - t0
            self.timer.totals["replan"] = \
                self.timer.totals.get("replan", 0.0) + dt
            self.timer.counts["replan"] = \
                self.timer.counts.get("replan", 0) + 1

    def cache_bytes(self) -> dict[str, int]:
        """The bytes the slot caches hold, by kind: each KV layout's K
        and V over every layer (``KVCache``, ``PagedKVCache``,
        ``PagedRingKVCache``; a pool's write sink included), the
        recurrent SSM state (``ssm_state``) and the conv shift register
        (``ssm_conv``)."""
        out: dict[str, int] = {}

        def add(kind, tensors):
            out[kind] = out.get(kind, 0) + sum(
                t.numel() * t.element_size() for t in tensors)
        caches = self.caches
        for c in (caches if type(caches) is tuple else (caches,)):
            if c.kv != ():
                add(type(c.kv).__name__, (c.kv.k, c.kv.v))
            if c.ssm != ():
                add("ssm_state", (c.ssm.state,))
                add("ssm_conv", (c.ssm.conv,))
        return out

    def stats(self) -> dict:
        """Per-stage timing + throughput + the scheduler's plan; the
        decode and verify steps by width (``steps``: steady calls and
        time, and the steps that captured a graph); the sampler's
        dispatches (``sampler_calls``: eager calls and sampling-graph
        replays); the caches' bytes by kind (``cache_bytes``); with
        ``graphed``, each step graph's captures, replays,
        capture time, pool bytes, the launches one replay adds and those
        its warm-ups launched."""
        out = {"stages": self.timer.as_dict(), "tokens_out": self.tokens_out,
               "prefill_tokens": self._prefill_tokens,
               "plan": dict(self.scheduler.last_plan),
               "scheduler": self.scheduler.state_counts(),
               "prefill_mode": self.scheduler.cfg.prefill_mode,
               "kv": self.kv, "device": str(self.device),
               "kernel_plan": self.kernel_plan.as_dict(),
               "graphed": self.graphed,
               "steps": {w: dict(v) for w, v in sorted(self.steps.items())},
               "sampler_calls": self.sampler_calls,
               "cache_bytes": self.cache_bytes()}
        if self.graphs.counts:
            out["graphs"] = {k: dict(v) for k, v in self.graphs.counts.items()}
        if self._kernel_report is not None:
            out["kernel_report"] = self._kernel_report.as_dict()
        if self.mesh_shards > 1:
            out["mesh_shards"] = self.mesh_shards
        if self.pool is not None:
            out["kv_pool"] = self.pool.stats()
            out["prefill_tokens_saved"] = self.pool.tokens_saved
            if self._kv_window:
                out["kv_window"] = self._kv_window
            if self.mesh_shards > 1:
                # block allocation is one host-side decision on every
                # rank; each rank stores only its kv-head slice of a block
                kv = self.caches.kv
                k_loc, hd = kv.k.shape[-2], kv.k.shape[-1]
                blk = self.pool.cfg.block_size
                item = kv.k.element_size()
                out["kv_pool"]["per_shard"] = {
                    "kv_heads": k_loc,
                    "block_bytes": 2 * blk * k_loc * hd * item,
                    "pool_bytes": 2 * self.pool.cfg.pool_blocks * blk
                    * k_loc * hd * item,
                }
        rep = self.scheduler.last_report
        if rep is not None:
            out["plan_report"] = rep.as_dict()
            out["plan_cache_hit"] = rep.cache_hit
        if self.default_spec.mode != "off":
            out["spec"] = {"mode": self.default_spec.mode,
                           "k": self._spec_k(self.default_spec),
                           **self.spec_stats.as_dict()}
        # decode throughput counts committed tokens over the decode +
        # verify time (the steps that captured a graph included) —
        # rejected draft positions are never emissions
        decode_s = sum(out["stages"].get(s, {"total_s": 0.0})["total_s"]
                       for s in ("decode", "verify", "decode_capture",
                                 "verify_capture"))
        if decode_s > 0:
            out["decode_tokens_per_s"] = self._decode_tokens / decode_s
        return out
