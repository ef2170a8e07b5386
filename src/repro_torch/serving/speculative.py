"""Speculative decoding: draft proposers + acceptance bookkeeping.

The port's copy of ``repro.serving.speculative``.  A *proposer* guesses
the next ``k`` tokens per request, one batched **verify** step scores all
``k + 1`` positions (``Model.verify_step``), and the engine commits the
longest prefix the target model agrees with, rolling the KV cache back
over the rejected tail.

Two proposers, both deterministic (point-mass draft distributions):

* :class:`NGramProposer` — prompt-lookup self-drafting over the
  request's own context (prompt + generated tokens);
* :class:`DraftModelProposer` — a small model from ``configs/`` with its
  own dense KV caches, kept slot-synchronized with the target engine
  (committed tokens fed as a backlog through ``prefill_chunk``, its own
  rejected drafts rolled back with the target's cache rewind).

Acceptance is the Leviathan rule for point-mass drafts coupled to the
target's keyed sampler: the engine samples the target token ``t_i`` at
every verified position with the request's own PRNG stream (key =
``(seed, emitted count)``, ``serving.sampling``) and accepts draft
``d_{i+1}`` iff ``d_{i+1} == t_i``.  Every committed token is the
target's keyed sample, so the committed stream is bit-identical to the
non-speculative engine's.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class SpecParams:
    """Per-request speculative-decoding policy.

    ``mode``: ``"off"`` (plain decode), ``"ngram"`` (prompt lookup) or
    ``"draft"`` (small draft model — the engine must hold one).  ``k`` is
    the draft length per verify; ``None`` defers to the
    ``serve_schedule`` plan (which sizes it from the observed acceptance
    rate and may turn speculation off entirely).
    """

    mode: str = "ngram"
    k: int | None = None
    max_ngram: int = 4       # longest suffix n-gram the lookup tries
    min_ngram: int = 2       # shortest; 1 matches aggressively (noisy)

    def __post_init__(self):
        if self.mode not in ("off", "ngram", "draft"):
            raise ValueError(f"unknown spec mode {self.mode!r}; "
                             "have off|ngram|draft")
        if self.k is not None and self.k < 0:
            raise ValueError(f"spec k must be >= 0, got {self.k}")
        if not 1 <= self.min_ngram <= self.max_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"{self.min_ngram}..{self.max_ngram}")


#: speculation disabled — the engine's default when no SpecParams given.
SPEC_OFF = SpecParams(mode="off", k=0)


def propose_ngram(context: np.ndarray, k: int, *, max_ngram: int = 4,
                  min_ngram: int = 2) -> np.ndarray:
    """Prompt-lookup drafting: up to ``k`` tokens continuing the most
    recent earlier occurrence of the context's suffix n-gram.

    The longest suffix first (``max_ngram`` down to ``min_ngram``); among
    equal-length matches the most recent one with a full k-token
    continuation wins, else the most recent one.  Returns an empty array
    when the context is too short or no earlier occurrence exists."""
    ctx = np.asarray(context, np.int64)
    n_ctx = len(ctx)
    if k <= 0 or n_ctx < min_ngram + 1:
        return np.zeros((0,), np.int32)
    for n in range(min(max_ngram, n_ctx - 1), min_ngram - 1, -1):
        suffix = ctx[n_ctx - n:]
        # the match must end strictly before the context's end so it has
        # a continuation
        windows = np.lib.stride_tricks.sliding_window_view(
            ctx[:n_ctx - 1], n)
        hits = np.nonzero((windows == suffix).all(axis=1))[0]
        if len(hits) == 0:
            continue
        starts = hits + n                   # continuation of each match
        full = starts[starts + k <= n_ctx]
        start = int(full[-1]) if len(full) else int(starts[-1])
        draft = ctx[start:start + k]
        if len(draft):
            return draft.astype(np.int32)
    return np.zeros((0,), np.int32)


class NGramProposer:
    """Stateless self-drafting proposer over each request's own context."""

    def propose(self, context: np.ndarray, k: int,
                params: SpecParams) -> np.ndarray:
        return propose_ngram(context, k, max_ngram=params.max_ngram,
                             min_ngram=params.min_ngram)


class DraftModelProposer:
    """A small draft model proposing greedily, slot-synced with the engine.

    Holds its own dense KV caches (``slots`` rows, the engine's
    ``max_len`` horizon) and per-slot sync state: how many context tokens
    each row's cache has absorbed and which request owns the row.  Each
    proposal round is three batched dispatch kinds on the draft model:
    the backlog feed (``prefill_chunk`` with per-row offsets), ``k``
    greedy ``serve_step`` calls with per-step live masks, and the rewind
    of its own speculative writes (``rollback_cache_rows``), keeping only
    the committed pending token.  It runs eagerly under ``KernelPlan()``
    (plain torch): its proposals are verified by the target, so routing
    buys nothing here.

    The draft must share the target's vocabulary: its embedding is
    indexed by the target's committed tokens.
    """

    def __init__(self, model, params, *, slots: int, max_len: int,
                 feed_chunk: int = 16):
        cfg = model.cfg
        if not cfg.attention_only or cfg.sliding_window:
            raise ValueError(
                "the draft model must be a full-attention family (its "
                f"cache rewinds by position), not {cfg.family}"
                + (" with a sliding window" if cfg.sliding_window else ""))
        from ..core.pipeline import KernelPlan
        from .engine import _serving_calls  # shared call table on the model
        self.model = model
        self.params = model.cast_params(params)
        self.device = model.device
        self.slots = slots
        self.max_len = max_len
        self.feed_chunk = feed_chunk
        self.caches = model.init_caches(slots, max_len)
        self.synced = np.zeros((slots,), np.int64)   # context tokens cached
        self.rids = np.full((slots,), -1, np.int64)  # owning request per row
        calls = _serving_calls(model, max_len, KernelPlan())
        self._chunk = calls["chunk"]
        self._serve = calls["serve"]
        self._reset = calls["reset"]
        self._rollback = calls["rollback"]

    def propose(self, rows: list[tuple[int, int, np.ndarray, int]]
                ) -> dict[int, np.ndarray]:
        """rows: ``(slot, rid, context, k)`` per drafting request, where
        ``context`` is prompt + all generated tokens (the last one is the
        pending token the target has not yet fed).  Returns drafts per
        slot."""
        if not rows:
            return {}
        # -- slot ownership: reset rows whose request changed (retire/
        #    preempt reuse) or whose sync ran ahead of a restored context
        reset = np.zeros((self.slots,), bool)
        for slot, rid, context, _ in rows:
            if self.rids[slot] != rid or self.synced[slot] > len(context) - 1:
                reset[slot] = True
                self.rids[slot] = rid
                self.synced[slot] = 0
        if reset.any():
            self._reset(self.caches, torch.from_numpy(reset))

        # -- backlog feed: bring every row up to context[:-1]
        targets = {slot: len(ctx) - 1 for slot, _, ctx, _ in rows}
        contexts = {slot: ctx for slot, _, ctx, _ in rows}
        C = self.feed_chunk
        while any(self.synced[s] < t for s, t in targets.items()):
            toks = np.zeros((self.slots, C), np.int64)
            offs = np.zeros((self.slots,), np.int32)
            n_new = np.zeros((self.slots,), np.int32)
            for slot, t in targets.items():
                done = int(self.synced[slot])
                n = min(C, t - done)
                if n <= 0:
                    continue
                toks[slot, :n] = contexts[slot][done:done + n]
                offs[slot] = done
                n_new[slot] = n
            self._chunk(self.params, self.caches, torch.from_numpy(toks),
                        torch.from_numpy(offs), torch.from_numpy(n_new))
            for slot in targets:
                self.synced[slot] += int(n_new[slot])

        # -- greedy autoregressive drafting: step 0 feeds the pending
        #    token (committed context — its cache write is kept), later
        #    steps feed the draft's own guesses (rolled back below)
        k_max = max(k for _, _, _, k in rows)
        cur = np.zeros((self.slots, 1), np.int64)
        ks = np.zeros((self.slots,), np.int64)
        for slot, _, ctx, k in rows:
            cur[slot, 0] = ctx[-1]
            ks[slot] = k
        drafts: dict[int, list[int]] = {slot: [] for slot, *_ in rows}
        vocab = self.model.cfg.vocab
        for i in range(k_max):
            live = ks > i
            logits, _ = self._serve(self.params, self.caches,
                                    torch.from_numpy(cur),
                                    torch.from_numpy(live))
            toks = torch.argmax(logits[..., :vocab], dim=-1).cpu().numpy()
            for slot in drafts:
                if live[slot]:
                    drafts[slot].append(int(toks[slot]))
                    cur[slot, 0] = toks[slot]

        # -- rewind the draft writes; keep the pending-token write
        keep = np.asarray(self.synced, np.int32).copy()
        rollback = np.zeros((self.slots,), bool)
        for slot, t in targets.items():
            keep[slot] = t + 1          # context incl. the pending token
            rollback[slot] = True
            self.synced[slot] = t + 1
        self._rollback(self.caches, torch.from_numpy(keep),
                       torch.from_numpy(rollback))
        return {slot: np.asarray(d, np.int32) for slot, d in drafts.items()}


@dataclasses.dataclass
class SpecStats:
    """Engine-side speculative counters (host bookkeeping only)."""

    drafts_proposed: int = 0     # draft tokens handed to verify
    drafts_accepted: int = 0     # draft tokens the target agreed with
    verify_calls: int = 0        # batched verify dispatches
    verify_positions: int = 0    # row-positions scored (incl. rejected)
    spec_tokens: int = 0         # tokens emitted by verify dispatches

    @property
    def accept_rate(self) -> float:
        """Accepted fraction of proposed draft tokens (0 when none)."""
        if self.drafts_proposed == 0:
            return 0.0
        return self.drafts_accepted / self.drafts_proposed

    def as_dict(self) -> dict:
        return {
            "drafts_proposed": self.drafts_proposed,
            "drafts_accepted": self.drafts_accepted,
            "accept_rate": round(self.accept_rate, 4),
            "verify_calls": self.verify_calls,
            "verify_positions": self.verify_positions,
            "spec_tokens": self.spec_tokens,
        }
