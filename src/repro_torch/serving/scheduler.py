"""Request scheduler for the continuous-batching serving engine.

The PyTorch port's copy of ``repro.serving.scheduler`` (host-side
Python, ported verbatim but for its imports and for the speculative,
sliding-window, mixed-stack, recurrent-state and mesh fields it forwards
to ``serve_schedule``, which come with those paths).

The engine (``serving.engine``) executes arrays; this module decides
*what* to execute each tick.  It owns the request lifecycle

    WAITING ──admit──▶ PREFILL ──last chunk──▶ DECODE ──EOS/max──▶ RETIRED
       ▲                                          │
       └──────────────── preempt ─────────────────┘

and produces a :class:`TickPlan` per engine tick: which waiting requests to
admit into which free slots (priority-then-FIFO, all free slots in one
tick), which prefill-phase slots advance by how many prompt tokens (the
chunked-prefill budget), and which slots decode.  The paper's thesis
applied at the request level: instead of operator-at-a-time — request-at-a-
time — execution, the scheduler restructures the request dataflow so
prefill and decode share batched dispatches.

**Priorities and preemption.**  Admission orders the waiting queue by
``(priority desc, submission order)``.  When the queue still holds a
request of *strictly* higher priority than some DECODE-phase slot, that
lowest-priority slot is preempted (bounded per tick by the plan's
``preempt`` field): the victim re-enters the queue with ``pos`` reset, and
its already-generated tokens become a prompt suffix
(:attr:`ScheduledRequest.prompt_tokens`), so a later re-admission prefills
the whole context back and the request continues exactly where it stopped.

Plan *parameters* (chunk size, admission width, preemption bound, prefill
mode, replan period) come from the ``serve_schedule`` pass registered in
``core.pipeline``: the scheduler feeds its observed stage timings
through ``pipeline.optimize`` every ``replan_every`` ticks and adopts the
plan it gets back.  Timings are quantized to two significant digits first,
so steady-state re-planning hits the pass-result cache and costs nothing.
"""
from __future__ import annotations

import dataclasses
import enum
from collections import deque
from typing import Any

import numpy as np


class RequestState(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    DECODE = "decode"
    RETIRED = "retired"


@dataclasses.dataclass
class ScheduledRequest:
    """A request plus its lifecycle bookkeeping (FSM state, slot, progress)."""

    req: Any                         # serving.engine.Request
    state: RequestState = RequestState.WAITING
    slot: int | None = None
    pos: int = 0                     # prompt tokens prefilled so far
    seq: int = 0                     # submission order (FIFO evidence)
    preemptions: int = 0             # times this request was evicted

    @property
    def prompt_tokens(self) -> np.ndarray:
        """Tokens to prefill: the prompt plus — after a preemption — the
        tokens already generated, so re-admission restores the context."""
        prompt = np.asarray(self.req.prompt, np.int32)
        if not self.req.generated:
            return prompt
        return np.concatenate(
            [prompt, np.asarray(self.req.generated, np.int32)])

    @property
    def prompt_len(self) -> int:
        return len(self.req.prompt) + len(self.req.generated)

    @property
    def prefill_done(self) -> bool:
        return self.pos >= self.prompt_len


@dataclasses.dataclass
class PrefillAssignment:
    """One slot's share of this tick's batched prefill chunk."""

    slot: int
    start: int                       # first prompt position in the chunk
    n_new: int                       # valid tokens (<= chunk budget)
    sreq: ScheduledRequest


@dataclasses.dataclass
class TickPlan:
    """What the engine executes in one tick."""

    admissions: list[ScheduledRequest] = dataclasses.field(default_factory=list)
    prefill: list[PrefillAssignment] = dataclasses.field(default_factory=list)
    decode_slots: list[int] = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class SchedulerConfig:
    slots: int = 4
    max_len: int = 256
    #: chunked-prefill budget (prompt tokens per slot per tick); replaced by
    #: the serve_schedule plan after the first replan.
    chunk: int = 32
    #: "chunked"  — admissions assign a slot, prefill happens as per-tick
    #:              chunks batched across slots and interleaved with decode;
    #: "batched"  — one-shot prefill of all admissions in one padded call
    #:              (equal-length groups for recurrent families);
    #: "serial"   — admissions still fill all free slots, but each request
    #:              prefills in its own B=1 call (the pre-scheduler
    #:              one-at-a-time path, kept as the benchmark baseline).
    prefill_mode: str = "chunked"
    replan_every: int = 32
    #: per-tick admission cap (None = every free slot); replaced by the
    #: serve_schedule plan's ``admit`` after the first replan.
    admit: int | None = None
    #: per-tick preemption cap; replaced by the plan's ``preempt``.
    preempt: int = 1


def _quantize(x: float) -> float:
    """Two significant digits: close-enough stats map to the same
    serve_schedule options, so re-planning hits the optimize() cache."""
    return float(f"{x:.2g}") if x > 0 else 0.0


class Scheduler:
    """Admission policy + chunk budgeting + lifecycle FSM over fixed slots."""

    def __init__(self, cfg: SchedulerConfig, plan_graph=None):
        if cfg.prefill_mode not in ("chunked", "batched", "serial"):
            raise ValueError(f"unknown prefill_mode {cfg.prefill_mode!r}")
        self.cfg = cfg
        #: a caller-set admission cap is pinned; only a None (= every free
        #: slot) cap is replaced by the serve_schedule plan's ``admit``
        self._admit_pinned = cfg.admit is not None
        # single-slot engines must never evict their only decoder (the
        # serve_schedule pass encodes the same bound: preempt <= slots-1)
        cfg.preempt = min(cfg.preempt, max(cfg.slots - 1, 0))
        self.eos_id: int | None = None  # engine sets this at construction
        #: whether the model behind the engine supports chunked prefill
        #: (attention-only families); gates prefill_mode adoption.
        self.chunk_supported = cfg.prefill_mode == "chunked"
        #: adopt the plan's batched-vs-chunked choice?  False when the
        #: caller pinned a mode explicitly (benchmarks compare policies).
        self.adopt_prefill_mode = False
        #: "dense" or "paged" — forwarded to the serve_schedule pass so a
        #: paged engine's replans keep the kv pool fields in the plan.
        self.kv_mode = "dense"
        #: the engine's resolved KernelPlan (as a site->backend dict) —
        #: forwarded to the serve_schedule pass so every replanned plan
        #: carries the routing it was planned under; the dict is fixed at
        #: engine construction, so replans still hit the optimize() cache.
        self.kernel_plan: dict[str, str] | None = None
        #: paged-KV hooks, set by the engine when it runs a block pool:
        #: ``kv_gate(sreq, victim=None)`` — may this request be admitted
        #: given free blocks (counting the victim's, when preempting)?;
        #: ``on_admit(sreq)`` — lease blocks and apply the prefix-cache
        #: probe (may advance ``sreq.pos`` past already-cached chunks);
        #: ``on_release(sreq)`` — drop the lease at retire/preempt.
        self.kv_gate = None
        self.on_admit = None
        self.on_release = None
        self.waiting: deque[ScheduledRequest] = deque()
        self._waiting_dirty = False  # re-sort only after submit/preempt
        self.active: list[ScheduledRequest | None] = [None] * cfg.slots
        self.retired: list[ScheduledRequest] = []
        self.preempted = 0               # total evictions (stats)
        self._seq = 0
        self._ticks = 0
        self._prompt_tokens_admitted = 0  # avg_prompt_len replan input
        self._admissions = 0
        #: proxy graph the serve_schedule pass plans over (hash-stable across
        #: replans — that is what makes repeated optimize() calls cache hits)
        self.plan_graph = plan_graph
        self.last_plan: dict[str, Any] = {
            "slots": cfg.slots, "chunk": cfg.chunk,
            "admit": cfg.admit or cfg.slots, "preempt": cfg.preempt,
            "replan_every": cfg.replan_every,
            "prefill_mode": cfg.prefill_mode}
        self.last_report = None

    # -- submission / admission ----------------------------------------------
    def submit(self, req) -> ScheduledRequest:
        if len(req.prompt) == 0:
            raise ValueError(
                f"request {getattr(req, 'rid', '?')} has an empty prompt: "
                "there is no position to sample a first token from")
        sreq = ScheduledRequest(req=req, seq=self._seq)
        self._seq += 1
        self.waiting.append(sreq)
        self._waiting_dirty = True
        return sreq

    def free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.active) if s is None]

    def _place(self, sreq: ScheduledRequest, slot: int,
               plan: TickPlan) -> None:
        sreq.slot = slot
        sreq.state = RequestState.PREFILL
        self.active[slot] = sreq
        if self.on_admit is not None:
            # paged KV: lease blocks now, so this tick's chunk plan (built
            # below from sreq.pos) already skips prefix-cached chunks
            self.on_admit(sreq)
        plan.admissions.append(sreq)

    def plan_tick(self) -> TickPlan:
        """Advance the FSM one tick and say what to execute.

        Admission is priority-then-FIFO and fills every free slot in one
        tick (capped by the plan's ``admit``); a leftover waiting request of
        strictly higher priority may then preempt the lowest-priority
        DECODE slot (capped by ``preempt``).  In chunked mode admitted
        requests enter PREFILL and are immediately part of this tick's
        chunk; in the one-shot modes the engine prefills admissions
        directly to DECODE.
        """
        self._ticks += 1
        plan = TickPlan()
        if self.waiting and self._waiting_dirty:
            # zero-budget requests have nothing to generate: retire them
            # here so they never occupy a slot (or emit a token: `_emit`)
            live = [s for s in self.waiting if s.req.max_new_tokens > 0]
            for s in self.waiting:
                if s.req.max_new_tokens <= 0:
                    self.retire(s)
            self.waiting = deque(sorted(
                live, key=lambda s: (-s.req.priority, s.seq)))
            self._waiting_dirty = False
        budget = min(len(self.free_slots()),
                     self.cfg.admit or self.cfg.slots)
        while budget > 0 and self.waiting:
            sreq = self.waiting[0]
            if self.kv_gate is not None and not self.kv_gate(sreq):
                break  # no KV blocks for the queue head: admission stays
                       # FIFO — it waits for a retirement to free blocks
            self.waiting.popleft()
            self._place(sreq, self.free_slots()[0], plan)
            self._prompt_tokens_admitted += sreq.prompt_len
            self._admissions += 1
            budget -= 1

        # preemption only makes sense when the admission cap left no slot
        # empty: evicting a decoder while a free slot idles wastes its work
        preempt_budget = self.cfg.preempt if not self.free_slots() else 0
        while preempt_budget > 0 and self.waiting:
            cand = self.waiting[0]
            victims = [s for s in self.active if s is not None
                       and s.state is RequestState.DECODE]
            if not victims:
                # a VIP must not wait behind a wall of long prefills:
                # mid-chunked-prefill slots are eviction candidates too
                # (their consumed chunk budget is recomputed — reset to
                # zero — by _preempt, so re-admission prefills cleanly).
                # A slot admitted *this* tick can never qualify: admission
                # is priority-ordered, so its priority >= cand's.
                victims = [s for s in self.active if s is not None
                           and s.state is RequestState.PREFILL]
            if not victims:
                break
            # evict the lowest priority; among equals, the newest arrival
            victim = min(victims, key=lambda s: (s.req.priority, -s.seq))
            if victim.req.priority >= cand.req.priority:
                break
            if self.kv_gate is not None and \
                    not self.kv_gate(cand, victim=victim):
                break  # even the victim's blocks would not make cand fit
            self.waiting.popleft()
            slot = victim.slot
            self._preempt(victim)
            self._place(cand, slot, plan)
            self._prompt_tokens_admitted += cand.prompt_len
            self._admissions += 1
            preempt_budget -= 1

        if self.cfg.prefill_mode == "chunked":
            for sreq in self.active:
                if sreq is None or sreq.state is not RequestState.PREFILL:
                    continue
                n = min(self.cfg.chunk, sreq.prompt_len - sreq.pos)
                plan.prefill.append(PrefillAssignment(
                    slot=sreq.slot, start=sreq.pos, n_new=n, sreq=sreq))
        plan.decode_slots = [s.slot for s in self.active
                             if s is not None
                             and s.state is RequestState.DECODE]
        return plan

    def _preempt(self, sreq: ScheduledRequest) -> None:
        """Evict a DECODE (or mid-prefill) request: back to WAITING with its
        generated tokens folded into the prompt (`prompt_tokens`) so
        re-admission restores the context by re-prefilling it.  Keeps its
        original `seq`, so among equal priorities it re-admits before
        anything submitted later.

        ``pos = 0`` is the chunk-budget recompute: a mid-chunked-prefill
        victim has consumed part of its budget (pos chunk tokens) but zero
        generated tokens — carrying that pos into the next admission would
        make the restore skip the evicted tokens' re-prefill and decode
        from a hole in the cache.  Eviction always restarts the prefill
        (the paged engine's prefix cache is what makes that cheap)."""
        self.active[sreq.slot] = None
        sreq.slot = None
        sreq.pos = 0
        sreq.state = RequestState.WAITING
        sreq.preemptions += 1
        self.preempted += 1
        if self.on_release is not None:
            self.on_release(sreq)
        self.waiting.append(sreq)
        self._waiting_dirty = True

    # -- engine feedback ------------------------------------------------------
    def note_prefilled(self, sreq: ScheduledRequest, n_new: int,
                       first_token: int | None) -> None:
        """A chunk advanced ``sreq`` by ``n_new`` prompt tokens; when the
        prompt is exhausted ``first_token`` (sampled at the last prompt
        position) moves the request to DECODE."""
        sreq.pos += n_new
        if not sreq.prefill_done:
            return
        assert first_token is not None
        sreq.state = RequestState.DECODE
        self._emit(sreq, first_token)

    def note_admitted_prefilled(self, sreq: ScheduledRequest,
                                first_token: int) -> None:
        """One-shot modes: admission prefilled the whole prompt at once."""
        sreq.pos = sreq.prompt_len
        sreq.state = RequestState.DECODE
        self._emit(sreq, first_token)

    def note_decoded(self, slot: int, token: int) -> None:
        sreq = self.active[slot]
        assert sreq is not None and sreq.state is RequestState.DECODE
        self._emit(sreq, token)

    def _emit(self, sreq: ScheduledRequest, token: int) -> None:
        if len(sreq.req.generated) >= sreq.req.max_new_tokens:
            # budget already exhausted (max_new_tokens == 0, or a stale
            # in-flight token): drop the token instead of over-emitting
            self.retire(sreq)
            return
        sreq.req.generated.append(int(token))
        done = len(sreq.req.generated) >= sreq.req.max_new_tokens
        if self.eos_id is not None and int(token) == self.eos_id:
            done = True
        if done:
            self.retire(sreq)

    def retire(self, sreq: ScheduledRequest) -> None:
        if sreq.state is RequestState.RETIRED:
            return
        sreq.req.done = True
        sreq.state = RequestState.RETIRED
        if sreq.slot is not None:
            self.active[sreq.slot] = None
        if self.on_release is not None:
            self.on_release(sreq)  # paged KV: drop the block lease
        self.retired.append(sreq)

    def pending(self) -> bool:
        return bool(self.waiting) or any(s is not None for s in self.active)

    # -- re-planning through the pass manager ---------------------------------
    def maybe_replan(self, decode_step_s: float, prefill_token_s: float,
                     device=None) -> dict[str, Any] | None:
        """Every ``replan_every`` ticks: run the ``serve_schedule`` pass over
        the proxy graph with quantized observed timings and adopt its plan —
        chunk budget, admission width, preemption bound, replan period, and
        (unless pinned) the batched-vs-chunked prefill mode.  Returns the
        plan on replan ticks, None otherwise."""
        if self.plan_graph is None or self._ticks % self.cfg.replan_every:
            return None
        from repro_torch.core import pipeline  # serving depends on core

        avg_prompt = (self._prompt_tokens_admitted / self._admissions
                      if self._admissions else 0.0)
        options = {
            "slots": self.cfg.slots,
            "max_len": self.cfg.max_len,
            "decode_step_s": _quantize(decode_step_s),
            "prefill_token_s": _quantize(prefill_token_s),
            "replan_every": self.cfg.replan_every,
            "avg_prompt_len": _quantize(avg_prompt),
            "can_chunk": self.chunk_supported,
        }
        if self.kv_mode != "dense":
            options["kv"] = self.kv_mode
        if self.kernel_plan:
            options["kernel_plan"] = dict(sorted(self.kernel_plan.items()))
        _, report = pipeline.optimize(self.plan_graph, device,
                                      passes=("serve_schedule",),
                                      options=options)
        plan = dict(report.passes[-1].summary)
        # adopt the mode first: a batched->chunked switch must start with
        # the planned chunk, not the stale constructor default
        self._adopt_prefill_mode(plan.get("prefill_mode"))
        if self.cfg.prefill_mode == "chunked":
            self.cfg.chunk = int(plan["chunk"])
        if not self._admit_pinned:
            self.cfg.admit = max(1, int(plan.get("admit", self.cfg.slots)))
        self.cfg.preempt = min(max(0, int(plan.get("preempt",
                                                   self.cfg.preempt))),
                               max(self.cfg.slots - 1, 0))
        self.cfg.replan_every = max(1, int(plan.get("replan_every",
                                                    self.cfg.replan_every)))
        self.last_plan = plan
        self.last_report = report
        return plan

    def _adopt_prefill_mode(self, mode: str | None) -> None:
        """Switch batched<->chunked when the plan says so — only if the mode
        was not pinned, the model supports the target, and no request is
        mid-prefill (a chunked->batched flip would strand its progress).
        ``serial`` engines never switch: that mode exists to be measured."""
        if (not self.adopt_prefill_mode
                or mode not in ("chunked", "batched")
                or mode == self.cfg.prefill_mode
                or self.cfg.prefill_mode == "serial"
                or (mode == "chunked" and not self.chunk_supported)
                or any(s is not None and s.state is RequestState.PREFILL
                       for s in self.active)):
            return
        self.cfg.prefill_mode = mode

    def state_counts(self) -> dict[str, int]:
        counts = {"waiting": len(self.waiting), "retired": len(self.retired),
                  "preempted": self.preempted, "prefill": 0, "decode": 0}
        for s in self.active:
            if s is not None:
                counts[s.state.value] += 1
        return counts


def serve_plan_graph(name: str, slots: int, d_model: int, d_ff: int,
                     vocab: int):
    """Tiny Table-3 proxy of the per-tick decode workload.

    The serve_schedule pass is a graph pass like every other registered
    stage, so the scheduler hands it a real (minimal) graph: the decode
    batch's MLP + LM-head shape.  Built once per engine — its fingerprint
    is stable, which is what makes every steady-state replan a cache hit.
    """
    from repro_torch.core import graph as G

    g = G.Graph(f"serve[{name}]x{slots}")
    x = g.add_input("h", (slots, d_model), layout="")
    up = G.matmul(g, x, d_ff, name="serve_mlp_up")
    down = G.matmul(g, up, d_model, name="serve_mlp_down")
    logits = G.matmul(g, down, vocab, name="serve_lm_head")
    out = G.softmax(g, logits, name="serve_sample")
    g.mark_output(out)
    return g
