"""Block-paged KV pool: the serving path's memory allocator.

The PyTorch port's copy of ``repro.serving.kv_pool`` (host-side numpy
bookkeeping, ported nearly verbatim).

The dense serving caches pre-allocate ``max_len`` KV per slot regardless of
prompt length, and identical prompt prefixes re-prefill and re-store the
same KV.  This module replaces that with the paper's thesis applied to the
KV *dataflow*: physical KV lives in fixed-size blocks
(``(pool_blocks, block_size, K, D)`` device arrays, owned by the model
caches), and this host-side pool decides which blocks each request's
logical context maps to:

  * **free-list allocation** — a request is admitted with exactly
    ``ceil(horizon / block_size)`` blocks (its prompt plus decode budget),
    not a ``max_len`` row; admission is gated on free blocks instead of
    free slots alone;
  * **refcounted sharing** — identical prompt *prefixes* map to the same
    physical blocks: every full prompt block is registered under a chain
    hash (hash of the block's tokens + the previous block's hash), and an
    admission probe walks that chain, sharing every hit (refcount++) and
    skipping its prefill chunks entirely;
  * **cached-free blocks** — retire/preempt decrements refcounts; a block
    that reaches zero but is still hash-registered keeps its contents and
    parks in an LRU "cached" list, allocatable like a free block but
    re-shareable until evicted.  A preempted VIP's restore therefore
    re-prefills only its unregistered tail;
  * **collision fallback** — a chain-hash hit is confirmed by comparing
    the actual block tokens (and parent hash); a colliding entry is
    treated as a miss and the request gets a private block.

Only blocks written **by prefill chunks** are ever registered: decode-step
KV can differ from chunk-recomputed KV in the last ulp, and the paged
engine must stay bit-identical to the dense engine (which always restores
a preempted context by re-prefilling it).  The randomized serving-
equivalence harness (``tests/test_serving_fuzz.py``) holds that line.

The pool is pure bookkeeping (numpy/python, no device arrays): the engine installs
its decisions into the device-side block tables, and
:meth:`KVBlockPool.check_invariants` re-derives the whole accounting from
scratch after every tick in tests.
"""
from __future__ import annotations

import dataclasses
import hashlib
from collections import OrderedDict
from typing import Sequence

import numpy as np


def block_hash(parent: int, tokens: Sequence[int]) -> int:
    """Chain hash of one full block: the previous block's hash + this
    block's token ids.  Module-level so tests can monkeypatch it to force
    collisions (the pool must fall back to private blocks, not share)."""
    h = hashlib.blake2b(digest_size=8)
    h.update(parent.to_bytes(8, "little", signed=False))
    h.update(np.asarray(tokens, np.int32).tobytes())
    return int.from_bytes(h.digest(), "little")


#: chain root for block 0 (any fixed value works; 0 keeps hashes stable)
_ROOT_HASH = 0


class PoolError(RuntimeError):
    """Allocator misuse: double free, over-allocation, unknown request."""


@dataclasses.dataclass(frozen=True)
class PoolConfig:
    block_size: int = 16       # tokens per physical block
    pool_blocks: int = 64      # physical blocks in the pool
    max_blocks_per_seq: int = 8  # block-table width (= max_len / block_size)
    #: concat-TP shard count of the serving mesh the pool arrays live on.
    #: Allocation stays a single host-side decision (block ids and tables
    #: are replicated on every shard); each shard's device arrays hold only
    #: its kv-head slice of every block, so per-shard block bytes are the
    #: dense block's / shards.  Recorded here so stats() and the planner
    #: can report/price per-device capacity.
    shards: int = 1

    def __post_init__(self):
        if self.block_size <= 0 or self.pool_blocks <= 0:
            raise ValueError(f"bad pool config {self}")
        if self.shards < 1:
            raise ValueError(f"bad shard count in pool config {self}")
        if self.max_blocks_per_seq > self.pool_blocks:
            raise ValueError(
                f"max_blocks_per_seq {self.max_blocks_per_seq} exceeds the "
                f"pool ({self.pool_blocks} blocks): one request could never "
                "be admitted")


@dataclasses.dataclass
class _Registration:
    """One prefix-cache entry: a full prefill-written block."""

    block: int
    parent: int                 # chain hash of the previous block
    tokens: tuple[int, ...]     # the block's token ids (collision check)


@dataclasses.dataclass
class _Lease:
    """One live request's slice of the pool."""

    blocks: list[int]           # logical order; [:shared] are refcount-shared
    tokens: np.ndarray          # prefill context (prompt incl. restore tail)
    shared_blocks: int          # leading blocks shared at admission
    registered: int             # leading blocks this rid has registered
    chain: list[int]            # chain hash per registered prefix block
    #: sliding-window ring lease: blocks cover ring *slots* and are
    #: rewritten in place as the window slides, so they never register
    #: in the prefix cache (their contents mutate) and never share
    ring: bool = False


class KVBlockPool:
    """Free-list + refcount + prefix-hash bookkeeping over a block pool."""

    def __init__(self, cfg: PoolConfig):
        self.cfg = cfg
        self.refcount = np.zeros((cfg.pool_blocks,), np.int32)
        #: never-registered free blocks, FIFO
        self.free_list: list[int] = list(range(cfg.pool_blocks))
        #: refcount-0 blocks that still hold a registered prefix
        #: (block -> hash), LRU: oldest evicted first when free runs dry
        self.cached: OrderedDict[int, int] = OrderedDict()
        #: chain hash -> registration (one block per distinct prefix)
        self.registry: dict[int, _Registration] = {}
        self._block_hash: dict[int, int] = {}   # block -> its chain hash
        self.leases: dict[int, _Lease] = {}
        # stats
        self.tokens_saved = 0       # prefill tokens skipped via sharing
        #: rids ever deferred by the admission gate (a blocked queue head
        #: is re-polled every tick — count requests, not polls)
        self.gated_rids: set[int] = set()

    # -- capacity -----------------------------------------------------------
    def blocks_for(self, n_tokens: int) -> int:
        return -(-max(int(n_tokens), 1) // self.cfg.block_size)

    def available(self) -> int:
        """Allocatable blocks: truly free plus cached (evictable)."""
        return len(self.free_list) + len(self.cached)

    def holds(self, rid: int) -> bool:
        return rid in self.leases

    def blocks_held(self, rid: int) -> int:
        """Blocks that would become allocatable if ``rid`` freed now."""
        return sum(1 for b in self.leases[rid].blocks
                   if self.refcount[b] == 1)

    # -- prefix probe -------------------------------------------------------
    def probe(self, tokens: np.ndarray) -> tuple[int, list[int]]:
        """Walk the prefix chain: how many leading *full* blocks of
        ``tokens`` are already registered (hash hit + token match)?
        Returns ``(n_shared_blocks, their physical block ids)``."""
        bs = self.cfg.block_size
        parent = _ROOT_HASH
        shared: list[int] = []
        for start in range(0, len(tokens) - bs + 1, bs):
            btoks = tuple(int(t) for t in tokens[start:start + bs])
            h = block_hash(parent, btoks)
            reg = self.registry.get(h)
            if reg is None or reg.parent != parent or reg.tokens != btoks:
                break  # miss — or a hash collision: fall back to private
            shared.append(reg.block)
            parent = h
        return len(shared), shared

    def can_admit(self, tokens: np.ndarray, horizon: int,
                  victim_rid: int | None = None, window: int = 0) -> bool:
        """Would ``allocate(tokens, horizon)`` succeed — counting a
        preemption victim's about-to-be-released blocks when given?  A
        victim block the probe already shares must not be credited as
        fresh capacity too (it is subtracted from ``needed`` instead);
        otherwise the gate would pass and the post-eviction ``allocate``
        raise.  Conservative: sharing can only grow once the victim's
        remaining blocks park in the cache.

        ``window > 0`` prices a sliding-window ring lease instead: the
        request needs ``min(blocks_for(horizon), window // block_size)``
        blocks *total*, no matter how long its context runs — admission
        prices the window, not the horizon."""
        if window:
            extra = 0
            if victim_rid is not None and victim_rid in self.leases:
                extra = sum(1 for b in self.leases[victim_rid].blocks
                            if self.refcount[b] == 1)
            return self._ring_blocks(horizon, window) \
                <= self.available() + extra
        n_shared, shared_ids = self.probe(tokens)
        n_shared = self._cap_shared(n_shared, len(tokens))
        shared_ids = shared_ids[:n_shared]
        extra = 0
        if victim_rid is not None and victim_rid in self.leases:
            shared_set = set(shared_ids)
            extra = sum(1 for b in self.leases[victim_rid].blocks
                        if self.refcount[b] == 1 and b not in shared_set)
        needed = self.blocks_for(horizon) - n_shared
        return needed <= self._allocatable(shared_ids) + extra

    def _allocatable(self, shared_ids: list[int]) -> int:
        """Blocks available as *fresh* private blocks, given that
        ``shared_ids`` are about to be revived: a shared block sitting in
        the cached-free list stops being allocatable the moment it is
        shared again."""
        revived = sum(1 for b in shared_ids if self.refcount[b] == 0)
        return self.available() - revived

    def _cap_shared(self, n_shared: int, n_tokens: int) -> int:
        """Never share the whole prefill context: at least one token must
        go through a prefill chunk to produce the first-token logits (and
        shared blocks are read-only, so the last position must sit in a
        private block)."""
        bs = self.cfg.block_size
        if n_shared * bs >= n_tokens:
            n_shared -= 1
        return max(n_shared, 0)

    def _ring_blocks(self, horizon: int, window: int) -> int:
        """Blocks a ring lease needs: the whole horizon while it fits the
        window, then exactly the window — never more.  This fixed lease
        with in-place wraparound reuse is the block-granularity form of
        "oldest blocks free back as the window slides": the slot a token
        vacates is the slot its successor ``window`` positions later
        rewrites, so net occupancy is O(window) for any sequence length
        (freeing and re-allocating the same block each slide would churn
        the free list for an identical steady state)."""
        return min(self.blocks_for(horizon), window // self.cfg.block_size)

    # -- allocate / free ----------------------------------------------------
    def allocate(self, rid: int, tokens: np.ndarray,
                 horizon: int, window: int = 0) -> tuple[list[int], int]:
        """Lease blocks for a request: ``tokens`` is its prefill context
        (prompt, plus previously-generated tokens after a preemption) and
        ``horizon`` the max context it may reach (prompt + decode budget,
        clamped to max_len by the engine).  Returns ``(block_table,
        cached_tokens)`` — the prefill may start at ``cached_tokens``.

        ``window > 0`` leases a sliding-window ring: a window-sized block
        table whose blocks are private and rewritten in place as the ring
        wraps.  Ring blocks never enter the prefix cache — their contents
        mutate, while registered blocks must stay immutable — so there is
        no probe and no shared prefix (``cached_tokens`` is always 0)."""
        if rid in self.leases:
            raise PoolError(f"request {rid} already holds a lease")
        if horizon < len(tokens):
            raise PoolError(
                f"request {rid}: horizon {horizon} shorter than its "
                f"{len(tokens)}-token prefill context")
        if window:
            n_blocks = self._ring_blocks(horizon, window)
            if n_blocks > self.cfg.max_blocks_per_seq:
                raise PoolError(
                    f"request {rid} needs {n_blocks} ring blocks; the "
                    f"block table holds {self.cfg.max_blocks_per_seq}")
            if n_blocks > self.available():
                raise PoolError(
                    f"pool exhausted: request {rid} needs {n_blocks} ring "
                    f"blocks, {self.available()} allocatable")
            blocks = []
            for _ in range(n_blocks):
                b = self._pop_fresh()
                self.refcount[b] = 1
                blocks.append(b)
            self.leases[rid] = _Lease(
                blocks=blocks, tokens=np.asarray(tokens, np.int32),
                shared_blocks=0, registered=0, chain=[], ring=True)
            return list(blocks), 0
        n_blocks = self.blocks_for(horizon)
        if n_blocks > self.cfg.max_blocks_per_seq:
            raise PoolError(
                f"request {rid} needs {n_blocks} blocks; the block table "
                f"holds {self.cfg.max_blocks_per_seq}")
        n_shared, shared_ids = self.probe(tokens)
        n_shared = self._cap_shared(n_shared, len(tokens))
        shared_ids = shared_ids[:n_shared]
        if n_blocks - n_shared > self._allocatable(shared_ids):
            raise PoolError(
                f"pool exhausted: request {rid} needs "
                f"{n_blocks - n_shared} fresh blocks, "
                f"{self._allocatable(shared_ids)} allocatable")
        blocks = []
        chain = []
        for b in shared_ids:
            if self.refcount[b] == 0:       # revive a cached-free block
                self.cached.pop(b)
            self.refcount[b] += 1
            blocks.append(b)
            chain.append(self._block_hash[b])
        for _ in range(n_blocks - n_shared):
            b = self._pop_fresh()
            self.refcount[b] = 1
            blocks.append(b)
        cached_tokens = n_shared * self.cfg.block_size
        self.tokens_saved += cached_tokens
        self.leases[rid] = _Lease(
            blocks=blocks, tokens=np.asarray(tokens, np.int32),
            shared_blocks=n_shared, registered=n_shared, chain=chain)
        return list(blocks), cached_tokens

    def _pop_fresh(self) -> int:
        """A private writable block: prefer never-registered free blocks;
        otherwise evict the LRU cached block (de-registering its prefix)."""
        if self.free_list:
            return self.free_list.pop(0)
        b, h = self.cached.popitem(last=False)
        self.registry.pop(h, None)
        self._block_hash.pop(b, None)
        return b

    def note_prefilled(self, rid: int, pos: int) -> None:
        """Prefill advanced ``rid`` to ``pos`` context tokens: register
        every newly *full* block under its chain hash so later admissions
        (including this request's own restore after a preemption) can share
        it.  Only prefill-written content is ever registered — see the
        module docstring for why decode-written blocks are not.  Ring
        leases never register: their blocks are rewritten in place as the
        window slides, and a registered block must stay immutable."""
        lease = self.leases[rid]
        if lease.ring:
            return
        bs = self.cfg.block_size
        pos = min(int(pos), len(lease.tokens))
        while (lease.registered + 1) * bs <= pos:
            i = lease.registered
            parent = lease.chain[i - 1] if i else _ROOT_HASH
            btoks = tuple(int(t) for t in lease.tokens[i * bs:(i + 1) * bs])
            h = block_hash(parent, btoks)
            b = lease.blocks[i]
            if h not in self.registry:
                self.registry[h] = _Registration(block=b, parent=parent,
                                                 tokens=btoks)
                self._block_hash[b] = h
            # on collision the existing entry wins; this block stays private
            lease.chain.append(h)
            lease.registered += 1

    def free(self, rid: int) -> None:
        """Release a lease (retire or preemption).  Blocks drop a refcount;
        at zero they park in the cached list if registered (contents kept
        for prefix reuse) or return to the free list."""
        lease = self.leases.pop(rid, None)
        if lease is None:
            raise PoolError(f"double free: request {rid} holds no lease")
        for b in lease.blocks:
            if self.refcount[b] <= 0:
                raise PoolError(f"block {b} freed below zero (rid {rid})")
            self.refcount[b] -= 1
            if self.refcount[b] == 0:
                h = self._block_hash.get(b)
                if h is not None and self.registry.get(h) is not None \
                        and self.registry[h].block == b:
                    self.cached[b] = h      # most-recently used
                    self.cached.move_to_end(b)
                else:
                    self.free_list.append(b)

    def truncate(self, rid: int, n_tokens: int) -> int:
        """Shrink a lease to ``blocks_for(n_tokens)`` blocks, freeing the
        strandable tail — the speculative-decode rollback hook: after a
        rejected draft suffix the request's reachable horizon shrinks
        (context + remaining budget), so blocks past it can go back to the
        pool.  Never cuts into shared or registered prefix blocks (those
        hold prefill-written content other requests may probe — a
        ``PoolError`` guards the boundary).  Tail blocks are private by
        construction (only full *prefill* blocks ever register or share),
        so freed ones return straight to the free list.  Returns the
        number of blocks freed."""
        lease = self.leases.get(rid)
        if lease is None:
            raise PoolError(f"truncate: request {rid} holds no lease")
        keep = self.blocks_for(n_tokens)
        floor = max(lease.shared_blocks, lease.registered)
        if keep < floor:
            raise PoolError(
                f"truncate: request {rid} would drop to {keep} blocks, "
                f"below its {floor}-block shared/registered prefix")
        freed = 0
        while len(lease.blocks) > keep:
            b = lease.blocks.pop()
            if self.refcount[b] != 1:
                lease.blocks.append(b)
                raise PoolError(
                    f"truncate: tail block {b} of request {rid} is shared "
                    f"(refcount {int(self.refcount[b])})")
            self.refcount[b] = 0
            self.free_list.append(b)
            freed += 1
        return freed

    # -- introspection ------------------------------------------------------
    def block_table(self, rid: int) -> np.ndarray:
        """The request's block table row, -1-padded to the table width."""
        row = np.full((self.cfg.max_blocks_per_seq,), -1, np.int32)
        blocks = self.leases[rid].blocks
        row[:len(blocks)] = blocks
        return row

    def stats(self) -> dict:
        in_use = int((self.refcount > 0).sum())
        return {
            "pool_blocks": self.cfg.pool_blocks,
            "block_size": self.cfg.block_size,
            "shards": self.cfg.shards,
            "blocks_in_use": in_use,
            "blocks_free": len(self.free_list),
            "blocks_cached": len(self.cached),
            "registered_prefixes": len(self.registry),
            "prefill_tokens_saved": self.tokens_saved,
            "gated_requests": len(self.gated_rids),
            "live_requests": len(self.leases),
        }

    def check_invariants(self) -> None:
        """Re-derive the whole accounting and assert it matches: refcounts
        equal the number of leases referencing each block; every block is
        exactly one of {free, cached, leased}; cached/registry stay
        consistent.  Tests run this after every engine tick."""
        derived = np.zeros_like(self.refcount)
        for rid, lease in self.leases.items():
            if len(set(lease.blocks)) != len(lease.blocks):
                raise AssertionError(f"rid {rid} lease repeats a block")
            for b in lease.blocks:
                derived[b] += 1
        if not np.array_equal(derived, self.refcount):
            bad = np.nonzero(derived != self.refcount)[0]
            raise AssertionError(
                f"refcount drift at blocks {bad.tolist()}: "
                f"stored {self.refcount[bad].tolist()} vs "
                f"derived {derived[bad].tolist()}")
        free_set, cached_set = set(self.free_list), set(self.cached)
        leased = {b for l in self.leases.values() for b in l.blocks}
        if len(free_set) != len(self.free_list):
            raise AssertionError("free list repeats a block")
        for name, s in (("free", free_set), ("cached", cached_set)):
            if s & leased:
                raise AssertionError(f"{name} blocks also leased: "
                                     f"{sorted(s & leased)}")
        if free_set & cached_set:
            raise AssertionError("blocks both free and cached: "
                                 f"{sorted(free_set & cached_set)}")
        accounted = len(free_set) + len(cached_set) + len(leased)
        if accounted != self.cfg.pool_blocks:
            raise AssertionError(
                f"{self.cfg.pool_blocks - accounted} blocks leaked "
                f"(free {len(free_set)} + cached {len(cached_set)} + "
                f"leased {len(leased)} != {self.cfg.pool_blocks})")
        for b, h in self.cached.items():
            reg = self.registry.get(h)
            if reg is None or reg.block != b:
                raise AssertionError(
                    f"cached block {b} lost its registration")
        if int((self.refcount < 0).sum()):
            raise AssertionError("negative refcount")


class MixedKVPool:
    """Two-kind allocator for heterogeneous (layer-pattern) stacks: one
    classic refcounted pool backs the global full-attention layers, one
    ring pool backs the sliding-window layers.  The two pools have
    **independent block-id spaces** (each layer kind owns its own device
    arrays, sized to its own geometry — that separation is what makes a
    mixed stack's KV footprint land between all-full and all-sliding), so
    every request holds one lease in each and the engine installs the
    classic table on its global layers and the ring table on its sliding
    layers.

    Prefix-cache behaviour is deliberately asymmetric: the classic lease
    still probes and refcount-shares full prompt blocks (memory dedup for
    the global layers — deterministic prefill rewrites a shared block
    bit-identically), but ``allocate`` always reports ``cached_tokens=0``.
    Skipping a prefill chunk skips it for *all* layers, and the ring
    layers' window must be populated per request — so no prefill work is
    ever skipped and ``tokens_saved`` stays honest at 0.
    """

    def __init__(self, classic_cfg: PoolConfig, ring_cfg: PoolConfig,
                 window: int):
        if window <= 0:
            raise ValueError("MixedKVPool needs a sliding window > 0")
        if classic_cfg.block_size != ring_cfg.block_size:
            raise ValueError(
                "mixed pools must share one block size, got "
                f"{classic_cfg.block_size} vs {ring_cfg.block_size}")
        if window % ring_cfg.block_size:
            raise ValueError(
                f"window {window} not a multiple of block size "
                f"{ring_cfg.block_size}")
        self.classic = KVBlockPool(classic_cfg)
        self.ring = KVBlockPool(ring_cfg)
        self.window = window

    # engine-facing surface mirrors KVBlockPool; its ``window`` argument is
    # ignored — this pool owns the split (classic leases price the horizon,
    # ring leases price self.window)
    @property
    def cfg(self) -> PoolConfig:
        return self.classic.cfg

    @property
    def tokens_saved(self) -> int:
        return self.classic.tokens_saved

    @property
    def gated_rids(self) -> set:
        return self.classic.gated_rids

    def blocks_for(self, n_tokens: int) -> int:
        return self.classic.blocks_for(n_tokens)

    def available(self) -> int:
        """Bottleneck capacity: an admission needs blocks from *both*."""
        return min(self.classic.available(), self.ring.available())

    def holds(self, rid: int) -> bool:
        return self.classic.holds(rid)

    def can_admit(self, tokens, horizon: int, victim_rid: int | None = None,
                  window: int = 0) -> bool:
        return self.classic.can_admit(tokens, horizon, victim_rid) \
            and self.ring.can_admit(tokens, horizon, victim_rid,
                                    window=self.window)

    def allocate(self, rid: int, tokens, horizon: int,
                 window: int = 0) -> tuple[list[int], int]:
        blocks, cached = self.classic.allocate(rid, tokens, horizon)
        # shared classic blocks are real memory dedup but not skipped
        # prefill (see class docstring) — undo the classic pool's
        # tokens-saved credit and report 0 cached tokens
        self.classic.tokens_saved -= cached
        try:
            self.ring.allocate(rid, tokens, horizon, window=self.window)
        except PoolError:
            self.classic.free(rid)
            raise
        return blocks, 0

    def note_prefilled(self, rid: int, pos: int) -> None:
        self.classic.note_prefilled(rid, pos)
        self.ring.note_prefilled(rid, pos)    # no-op (ring lease)

    def free(self, rid: int) -> None:
        self.classic.free(rid)
        self.ring.free(rid)

    def truncate(self, rid: int, n_tokens: int) -> int:
        # spec decoding (the one truncate caller) is gated off for mixed
        # stacks; classic-only keeps the hook total if that ever changes
        return self.classic.truncate(rid, n_tokens)

    def block_table(self, rid: int):
        """The classic table (global layers)."""
        return self.classic.block_table(rid)

    def ring_block_table(self, rid: int):
        """The ring table (sliding layers)."""
        return self.ring.block_table(rid)

    def stats(self) -> dict:
        c, r = self.classic.stats(), self.ring.stats()
        merged = dict(c)
        for k in ("pool_blocks", "blocks_in_use", "blocks_free",
                  "blocks_cached"):
            merged[k] = c[k] + r[k]
        merged["kind"] = "mixed"
        merged["kv_window"] = self.window
        merged["classic"] = c
        merged["ring"] = r
        return merged

    def check_invariants(self) -> None:
        self.classic.check_invariants()
        self.ring.check_invariants()
        if set(self.classic.leases) != set(self.ring.leases):
            raise AssertionError(
                "mixed pool lease drift: classic holds "
                f"{sorted(self.classic.leases)} vs ring "
                f"{sorted(self.ring.leases)}")
        for rid, lease in self.ring.leases.items():
            if not lease.ring:
                raise AssertionError(
                    f"rid {rid} holds a non-ring lease in the ring pool")
        if self.classic.tokens_saved:
            raise AssertionError(
                "mixed pool reported skipped prefill tokens "
                f"({self.classic.tokens_saved}) — mixed admissions must "
                "prefill every token (ring layers need per-request KV)")
