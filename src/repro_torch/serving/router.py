"""Engine-replica router: data parallelism for the port's serving stack
(the counterpart of ``repro.serving.router``, dispatch decision for
decision).

Concat-TP (``repro_torch.distributed.tp``) spreads one engine's decode
batch over mesh ranks; this module scales the deployment *out*: N
independent :class:`ServingEngine` replicas (each optionally
mesh-sharded) behind one submit queue.  A request lives wholly inside one
replica, so routed output is bit-identical to a solo engine's by the
engine's own batch-composition invariant (sampling keys derive from the
request seed and emitted count, never from slot or batch makeup).

Dispatch policy, in order:

  * **prefix affinity** — requests whose prompts share a block-aligned
    prefix want the same replica: its paged pool already holds those
    blocks, so admission skips their prefill chunks
    (``KVBlockPool`` refcounted sharing).  The router keys a sticky map by
    the hash of the longest block-aligned prompt prefix and honors it
    unless the sticky replica is overloaded;
  * **least-loaded** — otherwise the replica with the fewest in-flight +
    queued requests takes the request (ties break by replica index, which
    keeps dispatch deterministic and replayable).

Failure handling is at-least-once: :meth:`ReplicaRouter.fail_replica`
drops a replica from rotation and re-queues its unfinished requests from
scratch (generated tokens are discarded — a half-generated greedy stream
re-generates identically; a seeded sampled stream replays its own keys).
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import deque

import numpy as np

from .engine import Request, ServingEngine

#: refuse affinity routing when the sticky replica holds this many more
#: unfinished requests than the least-loaded one.  One slot-width of slack
#: keeps shared-prefix bursts together (the win is skipped prefill chunks)
#: without letting one hot prefix starve the rest of the fleet.
AFFINITY_SLACK_SLOTS = 1.0


def prefix_key(prompt: np.ndarray, block_size: int) -> int | None:
    """Hash of the longest block-aligned prompt prefix (None = shorter
    than one block, nothing shareable).  Mirrors the pool's chain-hash
    granularity: only whole blocks are ever shared, so affinity below one
    block buys nothing."""
    n = (len(prompt) // block_size) * block_size
    if n <= 0:
        return None
    h = hashlib.blake2b(digest_size=8)
    h.update(np.asarray(prompt[:n], np.int32).tobytes())
    return int.from_bytes(h.digest(), "little")


@dataclasses.dataclass
class _Placement:
    req: Request
    replica: int


class ReplicaRouter:
    """N serving engines behind one queue.

    ``engines`` are fully constructed :class:`ServingEngine` replicas
    (same model/params; KV layout and mesh may differ per replica — the
    router never looks inside).  ``affinity_block`` is the prefix-hash
    granularity, defaulting to each engine's paged block size when every
    replica runs a pool, else 16.
    """

    def __init__(self, engines: list[ServingEngine], *,
                 affinity_block: int | None = None):
        if not engines:
            raise ValueError("router needs at least one engine replica")
        self.engines = list(engines)
        self.alive = [True] * len(self.engines)
        if affinity_block is None:
            pooled = [e.pool.cfg.block_size for e in self.engines
                      if e.pool is not None]
            affinity_block = min(pooled) if len(pooled) == len(engines) \
                else 16
        self.affinity_block = int(affinity_block)
        self.queue: deque[Request] = deque()
        #: prefix hash -> replica index (sticky until that replica dies)
        self.affinity: dict[int, int] = {}
        self.placements: dict[int, _Placement] = {}   # rid -> placement
        self.dispatched = 0
        self.affinity_hits = 0
        self.requeued = 0

    # -- dispatch -------------------------------------------------------------
    def submit(self, req: Request) -> None:
        self.queue.append(req)

    def _load(self, i: int) -> int:
        c = self.engines[i].scheduler.state_counts()
        return c["waiting"] + c["prefill"] + c["decode"]

    def _pick(self, req: Request) -> int:
        live = [i for i in range(len(self.engines)) if self.alive[i]]
        if not live:
            raise RuntimeError("no live replicas")
        loads = {i: self._load(i) for i in live}
        least = min(live, key=lambda i: (loads[i], i))
        key = prefix_key(np.asarray(req.prompt), self.affinity_block)
        if key is not None:
            sticky = self.affinity.get(key)
            slack = AFFINITY_SLACK_SLOTS * self.engines[least].slots
            if sticky is not None and self.alive[sticky] \
                    and loads[sticky] <= loads[least] + slack:
                self.affinity_hits += 1
                return sticky
            self.affinity[key] = least
        return least

    def _dispatch(self) -> None:
        while self.queue:
            req = self.queue.popleft()
            i = self._pick(req)
            self.engines[i].submit(req)
            self.placements[req.rid] = _Placement(req=req, replica=i)
            self.dispatched += 1

    # -- execution ------------------------------------------------------------
    def step(self) -> int:
        """Dispatch everything queued, then tick every live replica that
        has work.  Returns tokens produced across the fleet this tick."""
        self._dispatch()
        produced = 0
        for i, eng in enumerate(self.engines):
            if self.alive[i] and eng.scheduler.pending():
                produced += eng.step()
        for rid in [r for r, pl in self.placements.items() if pl.req.done]:
            del self.placements[rid]
        return produced

    def pending(self) -> bool:
        return bool(self.queue) or any(
            self.alive[i] and e.scheduler.pending()
            for i, e in enumerate(self.engines))

    def run(self, max_steps: int = 10_000) -> None:
        steps = 0
        while self.pending() and steps < max_steps:
            self.step()
            steps += 1

    # -- failure --------------------------------------------------------------
    def fail_replica(self, i: int) -> int:
        """Drop replica ``i`` and re-queue its unfinished requests from
        scratch (at-least-once: partial generations are discarded — the
        per-request sampling seed replays the identical stream on the new
        replica).  Returns the number of requests re-queued."""
        if not self.alive[i]:
            return 0
        self.alive[i] = False
        self.affinity = {k: r for k, r in self.affinity.items() if r != i}
        moved = 0
        for rid, pl in list(self.placements.items()):
            if pl.replica != i or pl.req.done:
                continue
            del self.placements[rid]
            pl.req.generated = []
            pl.req.done = False
            self.queue.append(pl.req)
            self.requeued += 1
            moved += 1
        return moved

    # -- stats ----------------------------------------------------------------
    def stats(self) -> dict:
        out = {
            "replicas": len(self.engines),
            "live_replicas": int(sum(self.alive)),
            "dispatched": self.dispatched,
            "affinity_hits": self.affinity_hits,
            "requeued": self.requeued,
            "queued": len(self.queue),
            "per_replica": [e.stats() if self.alive[i] else None
                            for i, e in enumerate(self.engines)],
        }
        rates = [s.get("decode_tokens_per_s") for s in out["per_replica"]
                 if s is not None]
        rates = [r for r in rates if r]
        if rates:
            # aggregate decode capacity: each replica's committed decode
            # tokens over its own busy decode time, summed.  On a real
            # multi-device deployment replicas decode concurrently, so the
            # sum is the fleet throughput; interleaved on one host it is
            # the capacity projection (wall-clock cannot beat one device).
            out["aggregate_decode_tokens_per_s"] = float(sum(rates))
        return out
