"""Continuous-batching serving engine: executes the scheduler's TickPlans.

The counterpart of ``repro.serving.engine`` on PyTorch.  A fixed decode
batch of ``slots``; each tick the scheduler decides admissions,
prefill-chunk assignments and the decode set, and the engine runs at
most three batched dispatches: admit (row recycling, or the one-shot
padded ``prefill_step`` in the batched/serial modes), one fixed-shape
``prefill_chunk`` call, and one ``serve_step`` decode with a ``live``
mask.  KV is dense per slot (``kv="dense"``) or a block pool with
refcounted shared prefixes (``kv="paged"``).

Every hot-path dispatch routes through a :class:`KernelPlan`: by default
the ``kernel_select`` pass picks per site — the hand-written CUDA
kernels on a CUDA engine, plain torch on the host.  Under a ``cuda``
sampler plan the decode step and the fused sampler run back to back on
the stream, with the tokens' copy to the host the only synchronization.
The reference's jitted entries become a per-model table of eager
callables (:func:`_serving_calls`).

Stage times come from a :class:`StageTimer` that synchronizes the card
before a stage closes, so ``serve_schedule`` plans from step times.

Not in this slice: speculative decoding (ROADMAP queue 1 item 5), mesh
sharding and replicas (item 8), layer-pattern / sliding / SSM stacks
(item 7) — asking for them raises ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import torch

from ..core.pipeline import KernelPlan, StageTimer
from ..kernels.fused_sampler import ops as fused_ops
from ..models import cache_family as CF
from .kv_pool import KVBlockPool, PoolConfig
from .sampling import SamplingParams, sample_tokens
from .scheduler import Scheduler, SchedulerConfig, TickPlan, serve_plan_graph


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # (prompt_len,) int32
    max_new_tokens: int = 16
    #: per-request generation policy; None = the engine's default
    sampling: SamplingParams | None = None
    #: higher admits first and may preempt strictly-lower DECODE slots
    priority: int = 0
    #: speculative decoding is not ported yet: must stay None
    spec: object | None = None
    generated: list = dataclasses.field(default_factory=list)
    done: bool = False


def settle_ticks(prompt_len: int, chunk: int) -> int:
    """Ticks for a fresh admission wave to clear chunked prefill and settle
    into decode (drivers wait this long before injecting late
    high-priority work)."""
    return 2 * max(1, -(-prompt_len // max(chunk, 1))) + 1


def _serving_calls(model, max_len: int, plan: KernelPlan) -> dict:
    """The serving steps as eager callables, cached **on the model** per
    ``(max_len, plan)`` — the counterpart of the reference's jit cache.
    Decode, one-shot and chunked prefill all run under ``plan`` (its
    ``linked_matmul`` site routes every layer's SwiGLU MLP).
    The plan's ``sampler`` site picks the sampling lowering:
    ``"reference"`` (two-sort ``sample_tokens``, its own dispatch after
    decode) or ``"fused"`` / ``"cuda"`` (the fused sampler — one-sort
    torch or the ``fused_mask`` kernel — plus ``serve_sample``, decode
    and sampling back to back)."""
    cache = getattr(model, "_serving_call_cache", None)
    if cache is None:
        cache = {}
        model._serving_call_cache = cache
    key = (max_len, plan)
    if key not in cache:
        vocab = model.cfg.vocab

        def serve(p, c, t, live):
            return model.serve_step(p, c, t, live=live, plan=plan)

        if plan.sampler == "reference":
            sample = functools.partial(sample_tokens, vocab=vocab)
            serve_sample = None
        else:
            backend = "cuda" if plan.sampler == "cuda" else "torch"
            sample = functools.partial(fused_ops.fused_sample, vocab=vocab,
                                       backend=backend)

            def serve_sample(p, c, t, live, seeds, steps, temps, ks, ps):
                logits, c = serve(p, c, t, live)
                return fused_ops.fused_sample(
                    logits, seeds, steps, temps, ks, ps, vocab=vocab,
                    backend=backend), c

        cache[key] = {
            "serve": serve,
            "prefill": lambda p, b: model.prefill_step(p, b, max_len=max_len,
                                                       plan=plan),
            "chunk": functools.partial(model.prefill_chunk, plan=plan),
            "reset": model.reset_cache_rows,
            "sample": sample,
            "serve_sample": serve_sample,
        }
    return cache[key]


class ServingEngine:
    def __init__(self, model, params, *, slots: int = 4, max_len: int = 256,
                 eos_id: int = -1, prefill_mode: str | None = None,
                 chunk: int = 32, replan_every: int = 32, kv: str = "dense",
                 kv_block_size: int | None = None,
                 kv_pool_blocks: int | None = None,
                 kernel_plan: KernelPlan | None = None,
                 spec=None, draft_model=None, mesh=None):
        if kv not in ("dense", "paged"):
            raise ValueError(f"unknown kv mode {kv!r}; have dense|paged")
        if spec is not None or draft_model is not None:
            raise NotImplementedError(
                "speculative decoding is ported by ROADMAP queue 1 item 5")
        if mesh is not None:
            raise NotImplementedError(
                "mesh-sharded serving is ported by ROADMAP queue 1 item 8")
        self.model = model
        self.device = model.device
        #: the serving copy of the weights, in cfg.dtype (cast once here)
        self.params = model.cast_params(params)
        self.slots = slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.kv = kv
        self.pool: KVBlockPool | None = None
        #: the policy of requests that carry no SamplingParams: greedy
        self.default_sampling = SamplingParams()
        self.timer = StageTimer(
            synchronize=(lambda: torch.cuda.synchronize(self.device))
            if self.device.type == "cuda" else None)
        self.tokens_out = 0        # every generated token (prefill + decode)
        self._decode_tokens = 0    # decode-loop tokens only (throughput)
        self._prefill_tokens = 0   # prompt tokens pushed through prefill

        cfg = model.cfg
        auto_mode = prefill_mode is None
        if auto_mode:
            prefill_mode = ("chunked" if CF.supports_chunked_prefill(cfg)
                            else "batched")
        if kv == "paged" and prefill_mode != "chunked":
            raise ValueError(f"kv='paged' requires prefill_mode='chunked', "
                             f"not {prefill_mode!r}")
        self.scheduler = Scheduler(
            SchedulerConfig(slots=slots, max_len=max_len, chunk=chunk,
                            prefill_mode=prefill_mode,
                            replan_every=replan_every),
            plan_graph=serve_plan_graph(
                cfg.name, slots, cfg.d_model, cfg.d_ff or cfg.d_model,
                cfg.vocab))
        self.scheduler.eos_id = None if eos_id < 0 else eos_id
        self.scheduler.chunk_supported = CF.supports_chunked_prefill(cfg)
        # a pinned mode stays pinned; an auto dense engine lets
        # serve_schedule switch batched<->chunked from observed stats
        self.scheduler.adopt_prefill_mode = auto_mode and kv != "paged"

        if kv == "paged":
            self._init_paged_kv(kv_block_size, kv_pool_blocks)
        else:
            self.caches = model.init_caches(slots, max_len)
        self.scheduler.last_plan["kv_growth"] = "linear"
        self._kernel_report = None  # PassReport when the plan was routed
        self.kernel_plan = self._resolve_kernel_plan(kernel_plan)
        self.scheduler.kernel_plan = self.kernel_plan.as_dict()
        #: the token each slot feeds its next decode step (host copy)
        self._last_tokens = np.zeros((slots, 1), np.int64)
        calls = _serving_calls(model, max_len, self.kernel_plan)
        self._serve = calls["serve"]
        self._prefill = calls["prefill"]
        self._chunk_step = calls["chunk"]
        self._reset_rows = calls["reset"]
        self._sample_step = calls["sample"]
        self._serve_sample = calls["serve_sample"]

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
        capacity the dense-equivalent token budget)."""
        horizon = self.max_len
        if block_size is None or pool_blocks is None:
            from ..core import pipeline
            options = {"slots": self.slots, "max_len": self.max_len,
                       "kv": "paged", "can_chunk": True,
                       "replan_every": self.scheduler.cfg.replan_every}
            _, report = pipeline.optimize(
                self.scheduler.plan_graph,
                passes=("serve_schedule",), options=options)
            plan = report.passes[-1].summary
            if block_size is None:
                block_size = int(plan["kv_block_size"])
                fitting = [b for b in pipeline.SERVE_KV_BLOCK_SIZES
                           if horizon % b == 0
                           and b <= max(self.scheduler.cfg.chunk, 8)]
                if fitting:
                    block_size = min(block_size, max(fitting))
            if pool_blocks is None:
                pool_blocks = self.slots * (horizon // block_size)
        if horizon % block_size:
            raise ValueError(
                f"max_len {self.max_len} is not a multiple of the KV block "
                f"size {block_size}: the block table must tile it exactly "
                "(this is also what keeps paged and dense decode "
                "bit-identical)")
        max_blocks = horizon // block_size
        self.pool = KVBlockPool(PoolConfig(
            block_size=block_size, pool_blocks=pool_blocks,
            max_blocks_per_seq=max_blocks))
        self.caches = self.model.init_paged_caches(
            self.slots, pool_blocks=pool_blocks, block_size=block_size,
            max_blocks=max_blocks)
        self.scheduler.kv_mode = "paged"
        self.scheduler.kv_gate = self._kv_gate
        self.scheduler.on_admit = self._kv_on_admit
        self.scheduler.on_release = self._kv_on_release

    def _kv_horizon(self, sreq) -> int:
        remaining = max(sreq.req.max_new_tokens - len(sreq.req.generated), 0)
        return min(sreq.prompt_len + remaining, self.max_len)

    def _kv_gate(self, sreq, victim=None) -> bool:
        ok = self.pool.can_admit(
            sreq.prompt_tokens, self._kv_horizon(sreq),
            victim_rid=victim.req.rid if victim is not None else None)
        if not ok:
            self.pool.gated_rids.add(sreq.req.rid)
        return ok

    def _kv_on_admit(self, sreq) -> None:
        _, cached = self.pool.allocate(sreq.req.rid, sreq.prompt_tokens,
                                       self._kv_horizon(sreq))
        sreq.pos = cached

    def _kv_on_release(self, sreq) -> None:
        if self.pool.holds(sreq.req.rid):
            self.pool.free(sreq.req.rid)

    # -- public API -----------------------------------------------------------
    def submit(self, req: Request) -> None:
        if req.spec is not None:
            raise NotImplementedError(
                f"request {req.rid}: speculative decoding is ported by "
                "ROADMAP queue 1 item 5")
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
            with self.timer.stage("decode"):
                produced += self._decode(plan)
        self._maybe_replan()
        return produced

    def run(self, max_steps: int = 10_000) -> None:
        steps = 0
        while self.scheduler.pending() and steps < max_steps:
            self.step()
            steps += 1

    # -- admission ------------------------------------------------------------
    def _admit(self, plan: TickPlan) -> None:
        kv = self.caches.kv
        if self.scheduler.cfg.prefill_mode == "chunked":
            if self.pool is not None:
                # point the admitted slots' block tables at their leases;
                # length starts at the prefix-cache hit
                for sreq in plan.admissions:
                    row = torch.from_numpy(
                        self.pool.block_table(sreq.req.rid)).to(self.device)
                    kv.block_tables[:, sreq.slot] = row
                    kv.length[:, sreq.slot] = sreq.pos
                return
            rows = np.zeros((self.slots,), bool)
            for sreq in plan.admissions:
                rows[sreq.slot] = True
            self._reset_rows(self.caches, torch.from_numpy(rows))
            return
        # one-shot modes: batched padded prefill of the admission set
        if self.scheduler.cfg.prefill_mode == "serial" or \
                len(plan.admissions) == 1:
            groups = [[s] for s in plan.admissions]
        else:
            groups = [list(plan.admissions)]
        for group in groups:
            self._prefill_group(group, padded=len(group) > 1)

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
        # splice the prefilled rows into their slots, in place
        slots = torch.tensor([s.slot for s in group], device=self.device)
        for full, one in zip(self.caches.kv, fresh.kv):
            full[:, slots] = one
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

    # -- decode ---------------------------------------------------------------
    def _decode(self, plan: TickPlan) -> int:
        live = np.zeros((self.slots,), bool)
        rows: list = [None] * self.slots
        for slot in plan.decode_slots:
            live[slot] = True
            rows[slot] = self.scheduler.active[slot]
        tokens = torch.from_numpy(self._last_tokens)
        if self._serve_sample is not None:
            # fused plan: decode then the fused sampler, back to back on
            # the stream; the copy of the tokens is the one sync
            toks, self.caches = self._serve_sample(
                self.params, self.caches, tokens, torch.from_numpy(live),
                *self._sampling_tensors(rows))
            toks = toks.cpu().numpy()
        else:
            logits, self.caches = self._serve(
                self.params, self.caches, tokens, torch.from_numpy(live))
            toks = self._sample(logits, rows)
        for slot in plan.decode_slots:
            t = int(toks[slot])
            self.tokens_out += 1
            self._decode_tokens += 1
            self._last_tokens[slot, 0] = t
            self.scheduler.note_decoded(slot, t)
        return len(plan.decode_slots)

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
        temps = self._sampling_arrays(rows)[2]
        if not temps.any():
            # all-greedy batch: plain argmax, skip the sampler
            toks = torch.argmax(logits[..., :self.model.cfg.vocab], dim=-1)
            return toks.cpu().numpy()
        return self._sample_step(
            logits, *self._sampling_tensors(rows)).cpu().numpy()

    # -- re-planning / stats --------------------------------------------------
    def _maybe_replan(self) -> None:
        decode = self.timer.totals.get("decode", 0.0)
        decode_calls = self.timer.counts.get("decode", 0)
        prefill_s = (self.timer.totals.get("prefill_chunk", 0.0)
                     + self.timer.totals.get("admit", 0.0))
        t0 = time.perf_counter()
        plan = self.scheduler.maybe_replan(
            decode_step_s=decode / decode_calls if decode_calls else 0.0,
            prefill_token_s=prefill_s / self._prefill_tokens
            if self._prefill_tokens else 0.0)
        if plan is not None:
            dt = time.perf_counter() - t0
            self.timer.totals["replan"] = \
                self.timer.totals.get("replan", 0.0) + dt
            self.timer.counts["replan"] = \
                self.timer.counts.get("replan", 0) + 1

    def stats(self) -> dict:
        """Per-stage timing + throughput + the scheduler's plan."""
        out = {"stages": self.timer.as_dict(), "tokens_out": self.tokens_out,
               "prefill_tokens": self._prefill_tokens,
               "plan": dict(self.scheduler.last_plan),
               "scheduler": self.scheduler.state_counts(),
               "prefill_mode": self.scheduler.cfg.prefill_mode,
               "kv": self.kv, "device": str(self.device),
               "kernel_plan": self.kernel_plan.as_dict()}
        if self._kernel_report is not None:
            out["kernel_report"] = self._kernel_report.as_dict()
        if self.pool is not None:
            out["kv_pool"] = self.pool.stats()
            out["prefill_tokens_saved"] = self.pool.tokens_saved
        rep = self.scheduler.last_report
        if rep is not None:
            out["plan_report"] = rep.as_dict()
            out["plan_cache_hit"] = rep.cache_hit
        decode_s = out["stages"].get("decode", {"total_s": 0.0})["total_s"]
        if decode_s > 0:
            out["decode_tokens_per_s"] = self._decode_tokens / decode_s
        return out
