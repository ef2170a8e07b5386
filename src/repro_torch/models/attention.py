"""Attention for the dense decoder: GQA + RoPE + qk-norm + sliding
window and its caches, in PyTorch.

The counterpart of ``repro.models.attention`` for full and sliding-window
attention.  Four execution paths, as in the reference:

  * ``full_attention`` — materialized masked scores, for sequences up to
    ``CHUNKED_ABOVE`` tokens (plain torch, as the reference leaves it to
    XLA);
  * ``chunked_attention`` — the reference's flash-style online softmax
    over (512 x 1024) blocks, banded for sliding windows, never building
    (S, T); training, the encoder and the one-shot prefill take it past
    ``CHUNKED_ABOVE`` tokens (plain torch: one step a kv block, every
    q block at once);
  * chunked prefill against a cache (``prefill_chunk_into_cache`` and its
    paged and ring-paged variants) — chunk queries over the whole cache
    view;
  * ``decode_attention`` / ``decode_attention_paged`` — one query token
    over a cache, routed per ``KernelPlan`` site to plain torch or the
    hand-written CUDA flash-decode kernels.

Three cache layouts: the dense ring (:class:`KVCache`, ``W`` = the cache
width: the horizon for a full layer, the window for a sliding one), the
block-paged pool (:class:`PagedKVCache`, full layers) and the
wraparound ring pool (:class:`PagedRingKVCache`, sliding layers).  A
sliding layer attends the positions ``> pos - window``; the ring pool's
gathered view is in ring-slot order, the dense ring's layout, so its
decode and chunk attends are the dense ones (``decode_ring`` site:
``"gather"``; the ``decode_dense`` site's kernel attends the view).
``window`` and ``rope_theta`` arguments override the config's for one
layer of a layer-pattern stack (gemma3: sliding layers at theta 10k,
global ones at 1M); None keeps ``cfg.sliding_window`` / ``cfg.rope_theta``.

``NEG_INF = -1e30`` masking is part of the semantics: a row with no
valid slot yields the mean of V over the slots it reads, never NaN.

**Caches are updated in place.**  Where the reference rebuilds a cache
functionally with ``.at[].set`` and restores bystander rows wholesale,
these functions write K/V, positions and lengths only where a row is
live (dense: a masked write-back of the row's own slot; paged and ring
paged: dead rows write into a sink block past the pool), so a decode
step never copies the cache.  The returned cache is the argument cache.
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from ..kernels import sm_count
from ..kernels.decode_attention import ops as dec_ops
from .layers import ParamSpec, _is_dtensor, contiguous_stride, rms_norm

NEG_INF = -1e30

#: whole-sequence attention over more tokens than this runs
#: :func:`chunked_attention` (the reference's switch, ``S > 2048``)
CHUNKED_ABOVE = 2048


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(head_dim: int, fraction: float, theta: float,
                     device=None) -> torch.Tensor:
    """Inverse frequencies for the rotary dims (fraction < 1 => partial
    RoPE: only the first fraction*head_dim dims rotate).  Memoized per
    device: every layer of every step asks for the same constants.  A
    fake tensor (made under the dry run's ``FakeTensorMode``) is never
    memoized: a later real step would read it."""
    key = (head_dim, fraction, theta,
           str(torch.device(device if device is not None else "cpu")))
    inv = _INV_FREQ.get(key)
    if inv is None:
        rot = int(head_dim * fraction)
        rot -= rot % 2
        inv = 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32,
                                            device=key[3]) / rot))
        if type(inv) is torch.Tensor:
            _INV_FREQ[key] = inv
    return inv


_INV_FREQ: dict[tuple, torch.Tensor] = {}


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               inv_freq: torch.Tensor) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    rot = inv_freq.shape[0] * 2
    x_rot, x_pass = x[..., :rot], x[..., rot:]
    angles = positions[..., None].float() * inv_freq       # (..., S, rot/2)
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x_rot[..., 0::2].float(), x_rot[..., 1::2].float()
    r1 = (x1 * cos - x2 * sin).to(x.dtype)
    r2 = (x1 * sin + x2 * cos).to(x.dtype)
    out = torch.stack([r1, r2], dim=-1).reshape(x_rot.shape)
    return torch.cat([out, x_pass], dim=-1) if x_pass.shape[-1] else out


# ---------------------------------------------------------------------------
# Parameter specs
# ---------------------------------------------------------------------------

def attention_specs(d: int, n_heads: int, n_kv: int, head_dim: int,
                    qk_norm: bool) -> dict[str, ParamSpec]:
    specs = {
        "wq": ParamSpec((d, n_heads, head_dim), ("embed", "heads", None)),
        "wk": ParamSpec((d, n_kv, head_dim), ("embed", "kv_heads", None)),
        "wv": ParamSpec((d, n_kv, head_dim), ("embed", "kv_heads", None)),
        "wo": ParamSpec((n_heads, head_dim, d), ("heads", None, "embed")),
    }
    if qk_norm:
        specs["q_norm"] = ParamSpec((head_dim,), (None,), init="ones")
        specs["k_norm"] = ParamSpec((head_dim,), (None,), init="ones")
    return specs


# ---------------------------------------------------------------------------
# Core attention math
# ---------------------------------------------------------------------------

def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                   window: int = 0, causal: bool = True,
                   q_offset: int = 0) -> torch.Tensor:
    """Attention over a whole sequence.  q: (B,S,H,D), k/v: (B,T,K,D) ->
    (B,S,H,D); query ``i`` sits at position ``i + q_offset``; ``causal``
    keeps keys ``<= q_pos``, ``window`` > 0 only keys ``> q_pos -
    window``.  Builds the whole (B, K, G, S, T) fp32 score tensor: past
    ``CHUNKED_ABOVE`` tokens callers take :func:`chunked_attention`."""
    if _is_dtensor(q):
        return _sharded_attention(q, k, v, functools.partial(
            full_attention, window=window, causal=causal, q_offset=q_offset))
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, D)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() / math.sqrt(D)
    q_pos = torch.arange(S, device=q.device) + q_offset
    k_pos = torch.arange(T, device=q.device)
    mask = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask = mask & (k_pos[None, :] <= q_pos[:, None])
    if window:
        mask = mask & (k_pos[None, :] > q_pos[:, None] - window)
    scores = torch.where(mask, scores, NEG_INF)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bkgst,btkd->bskgd", w, v)
    return out.reshape(B, S, H, D)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: int = 0,
                      q_chunk: int = 512, kv_chunk: int = 1024
                      ) -> torch.Tensor:
    """Flash-style online-softmax attention that never builds (S, T): the
    reference's double scan, with its numerics.  q: (B,S,H,D), k/v:
    (B,T,K,D) -> (B,S,H,D).

    Falls back to :func:`full_attention` unless ``q_chunk`` divides S and
    ``kv_chunk`` divides T.  Each q block folds in kv blocks 0 .. nk-1
    in order; with a causal window, from its diagonal block down, for the
    ``ceil((q_chunk + window) / kv_chunk) + 1`` blocks its band can reach
    (blocks before 0 masked whole), the fully masked tail skipped.  The
    running max ``m``, sum ``l`` and output ``acc`` are fp32; the result
    is ``acc / max(l, 1e-30)``.  One Python step a kv block runs every q
    block at once (the banded step gathers each q block's kv block by
    its own index), so a step's live scores are (B, H, S, kv_chunk) fp32
    and a layer issues nk steps, not nq x nk.  Gradients flow through the
    steps by autograd, as the reference differentiates its scan, but for
    the running max: the output does not depend on it, so it is held
    constant (its terms, which cancel in the reference's gradient, are
    not formed)."""
    if _is_dtensor(q):
        return _sharded_attention(q, k, v, functools.partial(
            chunked_attention, causal=causal, window=window,
            q_chunk=q_chunk, kv_chunk=kv_chunk))
    B, S, H, D = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    if S % q_chunk or T % kv_chunk:
        return full_attention(q, k, v, causal=causal, window=window)
    nq, nk = S // q_chunk, T // kv_chunk
    dev = q.device
    qg = q.reshape(B, nq, q_chunk, K, G, D)
    kc = k.reshape(B, nk, kv_chunk, K, D)
    vc = v.reshape(B, nk, kv_chunk, K, D)
    scale = 1.0 / math.sqrt(D)
    banded = bool(window) and causal
    nk_needed = min(nk, -(-(q_chunk + window) // kv_chunk) + 1) if banded \
        else nk
    q_pos = torch.arange(S, device=dev).reshape(nq, q_chunk, 1)
    t_pos = torch.arange(kv_chunk, device=dev)
    hi_block = (torch.arange(nq, device=dev) * q_chunk + q_chunk - 1) \
        // kv_chunk
    m = torch.full((B, nq, K, G, q_chunk), NEG_INF, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((B, nq, K, G, q_chunk), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, nq, K, G, q_chunk, D), dtype=torch.float32,
                      device=dev)
    for rel in range(nk_needed):
        if banded:
            kidx = hi_block - rel                           # (nq,)
            kb = kc[:, kidx.clamp(min=0)]                   # (B,nq,kvc,K,D)
            vb = vc[:, kidx.clamp(min=0)]
            s = torch.einsum("bnqkgd,bntkd->bnkgqt", qg, kb)
            mask = (kidx >= 0)[:, None, None]
        else:
            kidx = torch.full((nq,), rel, device=dev)
            kb, vb = kc[:, rel], vc[:, rel]                 # (B,kvc,K,D)
            s = torch.einsum("bnqkgd,btkd->bnkgqt", qg, kb)
            mask = torch.ones((1, 1, 1), dtype=torch.bool, device=dev)
        # fp32 scores, masked and exponentiated in place: one fresh
        # (B, nq, K, G, qc, kvc) tensor a step
        s = s.float().mul_(scale)
        k_pos = (kidx[:, None] * kv_chunk + t_pos)[:, None, :]  # (nq,1,kvc)
        if causal:
            mask = mask & (k_pos <= q_pos)
        if window:
            mask = mask & (k_pos > q_pos - window)
        s = s.masked_fill_(~mask[:, None, None], NEG_INF)
        # the running max only steadies exp: the output does not depend
        # on it, so no gradient flows through it (nor does autograd keep
        # each step's scores for it)
        m_new = torch.maximum(m, s.detach().amax(-1))
        p = s.sub_(m_new[..., None]).exp_()
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        pv = torch.einsum("bnkgqt,bntkd->bnkgqd", p.to(vb.dtype), vb) \
            if banded else torch.einsum("bnkgqt,btkd->bnkgqd",
                                        p.to(vb.dtype), vb)
        acc = acc * corr[..., None] + pv.float()
        m = m_new
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    # (B, nq, K, G, qc, D) -> (B, S, H, D)
    return out.permute(0, 1, 4, 2, 3, 5).reshape(B, S, H, D)


def _sharded_attention(q, k, v, attend):
    """Whole-sequence attention of DTensors (``attend``: the plain
    :func:`full_attention` or :func:`chunked_attention` with its
    options bound), as GSPMD partitions it: each rank attends its own
    rows (the mesh dims splitting q's batch) and its own query heads (the
    one mesh dim splitting q's heads) on local tensors, with no
    collective in the forward; the rank runs what one device runs at its
    local shapes (the sequence is whole on every rank).  A rank's kv
    heads are those its query heads read: k and v split as q's heads
    where the kv heads divide into the same groups, else taken whole on
    that mesh dim and sliced; the slice's gradient, a partial sum over
    that dim, is summed there before it leaves (GSPMD's all-reduce of
    the cotangent), so the kv projections' weight gradients stay split
    as their weights are.  Other splits (the sequence, head_dim, a
    pending sum) are gathered first.  DTensor's own einsum would flatten
    a batch and a head dim split on two mesh dims, which torch 2.11's
    view rule refuses."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = q.device_mesh
    H, K = q.shape[2], k.shape[2]
    G = H // K
    qpl = [p if isinstance(p, Shard) and p.dim in (0, 2) else Replicate()
           for p in q.placements]
    heads = [md for md, p in enumerate(qpl) if p == Shard(2)]
    for md in heads[1:]:            # one mesh dim splits the heads
        qpl[md] = Replicate()
    kvpl = [p if p == Shard(0) else Replicate() for p in qpl]
    kv_grad = list(kvpl)
    lo = hi = None                  # the rank's kv heads, sliced locally
    if heads:
        md, m = heads[0], mesh.size(heads[0])
        h_l = H // m
        if H % m or (h_l % G and G % h_l):
            qpl[md] = Replicate()
        elif K % m == 0 and h_l % G == 0:
            kvpl[md] = kv_grad[md] = Shard(2)
        else:
            h0 = mesh.get_local_rank(md) * h_l
            lo, hi = h0 // G, (h0 + h_l - 1) // G + 1
            kv_grad[md] = Partial()
    q, k, v = (t.redistribute(mesh, pl) if list(t.placements) != pl else t
               for t, pl in ((q, qpl), (k, kvpl), (v, kvpl)))
    if lo is not None:
        k, v = _SumCotangent.apply(k), _SumCotangent.apply(v)
    kl, vl = (t.to_local(grad_placements=kv_grad) for t in (k, v))
    if lo is not None:
        kl, vl = kl[:, :, lo:hi], vl[:, :, lo:hi]
    out = attend(q.to_local(), kl, vl)
    return DTensor.from_local(out, mesh, qpl, run_check=False,
                              shape=q.shape, stride=contiguous_stride(
                                  q.shape))


class _SumCotangent(torch.autograd.Function):
    """Identity on a DTensor; its gradient's pending sums (a rank's
    sliced kv heads' cotangent, partial over the heads' mesh dim) are
    summed in the backward, an all-reduce, before they reach the
    projection that made the tensor.  Left partial, DTensor would compute
    that projection's whole weight gradient on every rank and reduce it
    afterwards."""

    @staticmethod
    def forward(ctx, t):
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        from torch.distributed.tensor import Replicate
        pl = [Replicate() if p.is_partial() else p for p in g.placements]
        if pl == list(g.placements):
            return g
        return g.redistribute(g.device_mesh, pl)


def rank_plan(q: torch.Tensor, K: int, W: int, shards: int):
    """The decode kernels' plan (body, query heads a CTA, split count) for
    a concat-TP rank holding ``K`` of ``K * shards`` kv heads: one
    device's at the full kv heads (``dec_ops.rank_plan``), so the rank's
    heads take the one-device body, pieces and merge order.  None (the
    shapes' own) on one device or off the card."""
    if shards == 1 or not q.is_cuda:
        return None
    B, H, D = q.shape
    return dec_ops.rank_plan(B, K, H // K, W, sm_count(q.device), D, shards,
                             q.dtype)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid: torch.Tensor,
                     backend: str = "torch", shards: int = 1) -> torch.Tensor:
    """One-token attention over a cache.

    q: (B,H,D); caches: (B,W,K,D); valid: (B,W) bool.  ``backend`` is the
    ``decode_dense`` site of a ``KernelPlan``: ``"torch"`` (einsum +
    softmax, the reference's XLA path) or ``"cuda"`` (flash-decode kernel).
    ``shards``: the concat-TP mesh's ranks when the cache holds one
    rank's kv heads (:func:`rank_plan`).
    """
    if backend == "cuda":
        return dec_ops.gqa_decode(
            q, k_cache, v_cache, valid,
            rank_plan(q, k_cache.shape[2], k_cache.shape[1], shards))
    if backend != "torch":
        raise ValueError(f"unknown decode_dense backend {backend!r}")
    B, H, D = q.shape
    K = k_cache.shape[2]
    qg = q.reshape(B, K, H // K, D)
    # batched matmuls over contiguous (B, K, ...) copies: each head's dot
    # products then run the same way whatever K is, so a concat-TP rank's
    # heads equal the one-device op's bit for bit (an einsum over the
    # strided cache picks its path by K)
    kt = k_cache.permute(0, 2, 3, 1).contiguous()          # (B, K, D, W)
    s = torch.matmul(qg, kt).float() / math.sqrt(D)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.matmul(w, v_cache.permute(0, 2, 1, 3).contiguous())
    return out.reshape(B, H, D)


def paged_kv_view(k_pool: torch.Tensor, v_pool: torch.Tensor,
                  block_tables: torch.Tensor
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """Gather a request-major dense view (B, M*bs, K, D) out of the pools.
    Unassigned table entries (-1) gather block 0; callers mask by length."""
    return (dec_ops.paged_view(k_pool, block_tables),
            dec_ops.paged_view(v_pool, block_tables))


def decode_attention_paged(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor,
                           backend: str = "gather",
                           shards: int = 1) -> torch.Tensor:
    """One-token attention over a block-paged cache.

    q: (B,H,D); pools: (P,bs,K,D); block_tables: (B,M) int32 (-1 =
    unassigned); lengths: (B,).  Position ``p`` sits at logical index
    ``p`` of an ``M*bs`` axis — the dense ring's layout, which keeps paged
    and dense decode bit-identical on the gather path.

    ``backend`` is the ``decode_paged`` site: ``"gather"`` builds the dense
    view, ``"fold"`` selects K by an exact one-hot contraction
    (:func:`_paged_fold_attention`), ``"cuda"`` is the paged flash-decode
    kernel, which never builds the view.  ``shards`` as in
    :func:`decode_attention`.
    """
    if backend == "cuda":
        return dec_ops.gqa_decode_paged(
            q, k_pool, v_pool, block_tables, lengths,
            rank_plan(q, k_pool.shape[2],
                      block_tables.shape[1] * k_pool.shape[1], shards))
    if backend == "fold":
        return _paged_fold_attention(q, k_pool, v_pool, block_tables,
                                     lengths)
    if backend != "gather":
        raise ValueError(f"unknown decode_paged backend {backend!r}")
    k, v = paged_kv_view(k_pool, v_pool, block_tables)
    W = k.shape[1]
    valid = torch.arange(W, device=q.device)[None, :] < lengths[:, None]
    return decode_attention(q, k, v, valid)


def _paged_fold_attention(q: torch.Tensor, k_pool: torch.Tensor,
                          v_pool: torch.Tensor, block_tables: torch.Tensor,
                          lengths: torch.Tensor) -> torch.Tensor:
    """Paged decode with the K gather folded into a one-hot contraction
    over the physical-block axis: each view row sums exactly one pool row
    and exact zeros, so K — and the output — match the gather path bit
    for bit.  V is still gathered; -1 entries select nothing and are then
    masked by length."""
    B, H, D = q.shape
    P, bs, K, _ = k_pool.shape
    M = block_tables.shape[1]
    W = M * bs
    onehot = ((block_tables[:, :, None]
               == torch.arange(P, device=q.device)[None, None, :])
              & (block_tables >= 0)[:, :, None]).to(k_pool.dtype)
    k = torch.einsum("bmp,pskd->bmskd", onehot, k_pool).reshape(B, W, K, D)
    v = dec_ops.paged_view(v_pool, block_tables)
    valid = torch.arange(W, device=q.device)[None, :] < lengths[:, None]
    return decode_attention(q, k, v, valid)


# ---------------------------------------------------------------------------
# Caches
# ---------------------------------------------------------------------------

class KVCache(NamedTuple):
    """Ring-buffer KV cache (``W`` = cache width).  Leaves may carry a
    leading layer axis; per-layer views update the stack in place."""
    k: torch.Tensor          # (B, W, K, D)
    v: torch.Tensor          # (B, W, K, D)
    positions: torch.Tensor  # (B, W) int32 absolute position per slot, -1 empty
    length: torch.Tensor     # (B,) int32 tokens seen so far


def init_kv_cache(batch: int, width: int, n_kv: int, head_dim: int,
                  dtype=torch.bfloat16, device="cuda") -> KVCache:
    return KVCache(
        k=torch.zeros((batch, width, n_kv, head_dim), dtype=dtype,
                      device=device),
        v=torch.zeros((batch, width, n_kv, head_dim), dtype=dtype,
                      device=device),
        positions=torch.full((batch, width), -1, dtype=torch.int32,
                             device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


class PagedKVCache(NamedTuple):
    """Block-paged KV cache: physical blocks + per-slot block tables.

    Position ``p`` of slot ``b`` lives at ``(block_tables[b, p // bs],
    p % bs)``.  The pools hold ``pool_blocks + 1`` blocks: the last one is
    a write sink — dead rows, padded chunk positions and rows without a
    block route their writes there instead of dropping them, so a masked
    scatter needs no host round trip.  No block table ever names it.
    """
    k: torch.Tensor             # (P + 1, bs, K, D) physical pool + sink
    v: torch.Tensor             # (P + 1, bs, K, D)
    block_tables: torch.Tensor  # (B, M) int32, -1 = unassigned
    length: torch.Tensor        # (B,) int32 context tokens cached


def init_paged_kv_cache(batch: int, pool_blocks: int, block_size: int,
                        max_blocks: int, n_kv: int, head_dim: int,
                        dtype=torch.bfloat16, device="cuda") -> PagedKVCache:
    shape = (pool_blocks + 1, block_size, n_kv, head_dim)
    return PagedKVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        block_tables=torch.full((batch, max_blocks), -1, dtype=torch.int32,
                                device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


class PagedRingKVCache(NamedTuple):
    """Wraparound paged ring for a sliding-window layer.

    The block table is window-sized: ``M = W // bs`` blocks cover ring
    slots, not positions — position ``p`` lives at ring slot ``p % W``,
    i.e. ``(block_tables[b, (p % W) // bs], (p % W) % bs)``; a new token
    overwrites the slot of the token that just left the window, so a
    request holds ``W // bs`` blocks however long it runs.  ``positions``
    is the dense ring's per-slot metadata, so the gathered ``(B, W, K,
    D)`` view in ring-slot order is the dense :class:`KVCache` layout and
    the dense attends and window masks apply as they are: that identity
    keeps the ring engine bit-identical to the dense sliding engine.  The
    pools hold a write sink past the ``P`` blocks, as
    :class:`PagedKVCache`'s do.
    """
    k: torch.Tensor             # (P + 1, bs, K, D) physical pool + sink
    v: torch.Tensor             # (P + 1, bs, K, D)
    block_tables: torch.Tensor  # (B, M) int32 ring-slot order, -1 unassigned
    positions: torch.Tensor     # (B, M * bs) int32 position a slot, -1 empty
    length: torch.Tensor        # (B,) int32 tokens seen so far


def init_paged_ring_kv_cache(batch: int, pool_blocks: int, block_size: int,
                             max_blocks: int, n_kv: int, head_dim: int,
                             dtype=torch.bfloat16,
                             device="cuda") -> PagedRingKVCache:
    shape = (pool_blocks + 1, block_size, n_kv, head_dim)
    return PagedRingKVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        block_tables=torch.full((batch, max_blocks), -1, dtype=torch.int32,
                                device=device),
        positions=torch.full((batch, max_blocks * block_size), -1,
                             dtype=torch.int32, device=device),
        length=torch.zeros((batch,), dtype=torch.int32, device=device),
    )


def rollback_kv_cache(cache: KVCache, keep_len: torch.Tensor,
                      rows: torch.Tensor) -> KVCache:
    """Rewind slot rows ((B,) bool) to ``keep_len`` ((B,) int) context
    tokens, in place: ring entries at absolute positions >= keep_len are
    invalidated and the write pointer moves back, undoing the
    rejected-suffix writes of a speculative verify (stale K/V payloads
    are dead once no position points at them).  Leaves may carry a
    leading layer axis."""
    m = rows[:, None] & (cache.positions >= keep_len[:, None])
    cache.positions.copy_(torch.where(m, -1, cache.positions))
    cache.length.copy_(torch.where(rows, keep_len.to(torch.int32),
                                   cache.length))
    return cache


def rollback_paged_kv_cache(cache: PagedKVCache, keep_len: torch.Tensor,
                            rows: torch.Tensor) -> PagedKVCache:
    """Paged rewind, in place, is pure metadata: truncate ``length`` and
    the rejected positions cease to exist (attention masks by length;
    the host-side pool may then free strandable tail blocks,
    ``KVBlockPool.truncate``)."""
    cache.length.copy_(torch.where(rows, keep_len.to(torch.int32),
                                   cache.length))
    return cache


# ---------------------------------------------------------------------------
# The attention block (projections + rope + cache handling)
# ---------------------------------------------------------------------------

def _project(p, x, name):
    """x (B,S,d) @ w (d, heads, hd) -> (B,S,heads,hd)."""
    w = p[name].to(x.dtype)
    w2 = w.reshape(w.shape[0], -1)
    y = _split_contraction(x, w2) if _is_dtensor(w2) else x @ w2
    return y.reshape(*x.shape[:-1], w.shape[1], w.shape[2])


def _split_contraction(x, w):
    """``x @ w`` of DTensors as GSPMD partitions a projection whose weight
    splits its d rows over a mesh dim (a kv projection whose heads do not
    split over it): ``x`` split on d there too (a free slice where it is
    whole, a reduce-scatter where it is a pending sum), each rank's rows
    multiplied into a partial sum, summed at once.  The backward then
    takes a whole cotangent into each rank's own weight rows.  Left to
    DTensor, the saved input stays whole or partial, the sum pending, and
    the weight gradient is computed whole on every rank."""
    from torch.distributed.tensor import Replicate, Shard

    pl = list(x.placements)
    split = False
    for md, wp in enumerate(w.placements):
        if wp == Shard(0):
            split = True
            if not pl[md].is_shard():
                pl[md] = Shard(x.dim() - 1)
    if not split:
        return x @ w
    if pl != list(x.placements):
        x = x.redistribute(x.device_mesh, pl)
    y = x @ w
    whole = [Replicate() if q.is_partial() else q for q in y.placements]
    return y if whole == list(y.placements) else \
        y.redistribute(y.device_mesh, whole)


def _out_project(p, out, shard_axis=None):
    """out (..., H, hd) @ wo (H, hd, d) -> (..., d).

    ``shard_axis`` (concat-TP serving, ``repro_torch.distributed.tp``):
    the mesh whose ranks hold the head shards; ``out`` holds this rank's
    contiguous head slice (``wq``/``wk``/``wv`` are column-split, so it is
    exactly those heads of the one-device op) and is gathered back to
    full width, a concatenation with no arithmetic, before the replicated
    ``wo``: its contraction sees the same full-width input on every
    rank."""
    if shard_axis is not None:
        out = shard_axis.gather(out, dim=out.dim() - 2)
    wo = p["wo"].to(out.dtype)
    return out.reshape(*out.shape[:-2], -1) @ wo.reshape(-1, wo.shape[-1])


def _layer_args(cfg, window, rope_theta) -> tuple[int, float]:
    """One layer's window and RoPE theta: the arguments, or the config's
    stack-wide values where they are None."""
    return (cfg.sliding_window if window is None else window,
            cfg.rope_theta if rope_theta is None else rope_theta)


def _rope(cfg, theta: float, device):
    return rope_frequencies(cfg.resolved_head_dim, cfg.rope_fraction, theta,
                            device)


def attention_block(p, x, *, cfg, window: int | None = None,
                    rope_theta: float | None = None, causal: bool = True,
                    kv: tuple[torch.Tensor, torch.Tensor] | None = None,
                    use_chunked: bool | None = None) -> torch.Tensor:
    """Attention over a whole sequence.  x: (B,S,d).  ``causal`` False:
    bidirectional (the encoder's).  ``kv`` overrides K/V (cross-attention
    over the encoder's, :func:`~.transformer.cross_kv`): then no mask, no
    RoPE on either side and no k-norm, as in the reference.
    ``use_chunked`` (None: ``S > CHUNKED_ABOVE``) runs self-attention,
    causal or not, through :func:`chunked_attention`; cross-attention is
    always :func:`full_attention`."""
    S = x.shape[1]
    window, theta = _layer_args(cfg, window, rope_theta)
    q = _project(p, x, "wq")
    if kv is None:
        k = _project(p, x, "wk")
        v = _project(p, x, "wv")
    else:
        k, v = kv
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        if kv is None:
            k = rms_norm(k, p["k_norm"])
    if kv is None and cfg.rope_fraction > 0:
        inv = _rope(cfg, theta, x.device)
        positions = torch.arange(S, device=x.device)[None, :]
        q = apply_rope(q, positions, inv)
        k = apply_rope(k, positions, inv)
    if use_chunked is None:
        use_chunked = S > CHUNKED_ABOVE
    if use_chunked and kv is None:
        out = chunked_attention(q, k, v, causal=causal, window=window)
    elif kv is None:
        out = full_attention(q, k, v, window=window, causal=causal)
    else:
        out = full_attention(q, k, v, window=0, causal=False)
    return _out_project(p, out)


def _window_valid(positions: torch.Tensor, pos: torch.Tensor,
                  window: int) -> torch.Tensor:
    """Slots a decode query at ``pos`` (B,) attends: written, and inside
    the sliding window when one is set."""
    valid = positions >= 0
    if window:
        valid = valid & (positions > (pos[:, None] - window))
    return valid


def attention_decode_block(p, x, cache, *, cfg, dense_backend: str = "torch",
                           paged_backend: str = "gather",
                           ring_backend: str = "gather",
                           live: torch.Tensor | None = None,
                           window: int | None = None,
                           rope_theta: float | None = None,
                           shard_axis=None, cross_kv=None):
    """One decode step.  x: (B, 1, d) -> (y (B, 1, d), cache).

    RoPE is applied at write time (K is cached post-rotation).  ``live``
    ((B,) bool) rows write their token's K/V, position and length; other
    rows leave the cache untouched (the reference restores them
    afterwards for a dense cache and drops their scatter for a paged
    one).  A non-live row's output is computed over its untouched cache
    and is meant to be discarded.  The cache is updated in place.
    ``dense_backend`` / ``paged_backend`` / ``ring_backend`` are the
    ``decode_dense`` / ``decode_paged`` / ``decode_ring`` sites; the
    cache's type picks one (a ring attends its gathered view through the
    dense one).  ``shard_axis`` (concat-TP): the params hold this rank's
    heads and the cache its kv heads; see :func:`_out_project`; the
    decode kernels then take one device's plan (:func:`rank_plan`).

    ``cross_kv`` ((B, Ssrc, K, D) K and V): cross-attention over the
    encoder's static K/V through the ``decode_dense`` site, every slot
    valid, no RoPE; ``cache`` is neither read nor written.
    """
    B = x.shape[0]
    window, theta = _layer_args(cfg, window, rope_theta)
    shards = shard_axis.shards if shard_axis is not None else 1
    q = _project(p, x, "wq")[:, 0]             # (B, H, D)
    if cross_kv is not None:
        if cfg.qk_norm:
            q = rms_norm(q, p["q_norm"])
        k_c, v_c = cross_kv
        valid = torch.ones(k_c.shape[:2], dtype=torch.bool, device=x.device)
        out = decode_attention(q, k_c, v_c, valid, dense_backend, shards)
        return _out_project(p, out, shard_axis)[:, None], cache
    if live is None:
        live = torch.ones((B,), dtype=torch.bool, device=x.device)
    pos = cache.length.clone()                 # (B,) position of the new token
    k_new = _project(p, x, "wk")[:, 0]         # (B, K, D)
    v_new = _project(p, x, "wv")[:, 0]
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k_new = rms_norm(k_new, p["k_norm"])
    if cfg.rope_fraction > 0:
        inv = _rope(cfg, theta, x.device)
        q = apply_rope(q[:, None], pos[:, None], inv)[:, 0]
        k_new = apply_rope(k_new[:, None], pos[:, None], inv)[:, 0]
    bidx = torch.arange(B, device=x.device)

    if isinstance(cache, PagedRingKVCache):
        y = _ring_decode_write_attend(q, k_new, v_new, cache, pos,
                                      window=window, live=live,
                                      dense_backend=dense_backend,
                                      backend=ring_backend)
        return _out_project(p, y, shard_axis)[:, None], cache

    if isinstance(cache, PagedKVCache):
        sink = cache.k.shape[0] - 1
        bs = cache.k.shape[1]
        M = cache.block_tables.shape[1]
        blk = cache.block_tables[bidx, (pos // bs).clamp(0, M - 1)]
        ok = live & (blk >= 0) & (pos < M * bs)
        dst = torch.where(ok, blk, sink).long()
        off = (pos % bs).long()
        cache.k[dst, off] = k_new.to(cache.k.dtype)
        cache.v[dst, off] = v_new.to(cache.v.dtype)
        new_len = torch.where(ok, pos + 1, pos).to(torch.int32)
        cache.length.copy_(new_len)
        y = decode_attention_paged(q, cache.k, cache.v, cache.block_tables,
                                   new_len, paged_backend, shards)
        return _out_project(p, y, shard_axis)[:, None], cache

    W = cache.k.shape[1]
    slot = (pos % W).long()
    keep = live[:, None, None]
    cache.k[bidx, slot] = torch.where(keep, k_new.to(cache.k.dtype),
                                      cache.k[bidx, slot])
    cache.v[bidx, slot] = torch.where(keep, v_new.to(cache.v.dtype),
                                      cache.v[bidx, slot])
    cache.positions[bidx, slot] = torch.where(live, pos,
                                              cache.positions[bidx, slot])
    cache.length.copy_(torch.where(live, pos + 1, pos))
    valid = _window_valid(cache.positions, pos, window)
    out = decode_attention(q, cache.k, cache.v, valid, dense_backend, shards)
    return _out_project(p, out, shard_axis)[:, None], cache


def _ring_decode_write_attend(q, k_new, v_new, cache: PagedRingKVCache,
                              pos: torch.Tensor, *, window: int,
                              live: torch.Tensor, dense_backend: str,
                              backend: str = "gather") -> torch.Tensor:
    """Write one token into the ring pool at ring slot ``pos % W`` and
    attend over the window, in place.  Past the window that slot is the
    token ``W`` positions back, which just left it: the overwrite is the
    window's slide.  Dead rows and rows without a lease write into the
    sink.  The attend is the dense ring's (written and inside the
    window) over the gathered ring-slot-order view, so outputs match the
    dense sliding engine bit for bit."""
    if backend != "gather":
        raise ValueError(f"unknown decode_ring backend {backend!r}")
    B = q.shape[0]
    sink = cache.k.shape[0] - 1
    bs = cache.k.shape[1]
    W = cache.block_tables.shape[1] * bs
    bidx = torch.arange(B, device=q.device)
    slot = (pos % W).long()
    blk = cache.block_tables[bidx, slot // bs]
    ok = live & (blk >= 0)                     # the ring wraps by design
    dst = torch.where(ok, blk, sink).long()
    off = slot % bs
    cache.k[dst, off] = k_new.to(cache.k.dtype)
    cache.v[dst, off] = v_new.to(cache.v.dtype)
    cache.positions[bidx, slot] = torch.where(ok, pos,
                                              cache.positions[bidx, slot])
    cache.length.copy_(torch.where(ok, pos + 1, pos).to(torch.int32))
    k_view, v_view = paged_kv_view(cache.k, cache.v, cache.block_tables)
    valid = _window_valid(cache.positions, pos, window)
    return decode_attention(q, k_view, v_view, valid, dense_backend)


def prefill_into_cache(p, x, cache: KVCache, *, cfg,
                       lengths: torch.Tensor | None = None,
                       window: int | None = None,
                       rope_theta: float | None = None,
                       use_chunked: bool | None = None):
    """Prefill: full-sequence attention (:func:`chunked_attention` where
    ``use_chunked``, None: past ``CHUNKED_ABOVE`` tokens, as the
    reference's; else :func:`full_attention`) AND populate a (fresh)
    cache in place.  ``lengths`` (B,) makes this a right-padded batch:
    positions at or past a row's length are recorded empty (-1) and each
    row's length is its own.  A ring narrower than the prompt (a sliding layer's)
    keeps the last ``min(W, S)`` positions at their slots."""
    B, S, _ = x.shape
    W = cache.k.shape[1]
    window, theta = _layer_args(cfg, window, rope_theta)
    q = _project(p, x, "wq")
    k = _project(p, x, "wk")
    v = _project(p, x, "wv")
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k = rms_norm(k, p["k_norm"])
    positions = torch.arange(S, device=x.device)[None, :]
    if cfg.rope_fraction > 0:
        inv = _rope(cfg, theta, x.device)
        q = apply_rope(q, positions, inv)
        k = apply_rope(k, positions, inv)
    if use_chunked is None:
        use_chunked = S > CHUNKED_ABOVE
    attend = chunked_attention if use_chunked else full_attention
    out = attend(q, k, v, causal=True, window=window)
    take = min(W, S)
    tail_pos = torch.arange(S - take, S, device=x.device)
    slots = tail_pos % W
    cache.k[:, slots] = k[:, S - take:].to(cache.k.dtype)
    cache.v[:, slots] = v[:, S - take:].to(cache.v.dtype)
    written = tail_pos.to(torch.int32).expand(B, take)
    if lengths is not None:
        written = torch.where(written < lengths[:, None], written, -1)
    cache.positions[:, slots] = written.to(torch.int32)
    cache.length.copy_(torch.full((B,), S, dtype=torch.int32,
                                  device=x.device)
                       if lengths is None else lengths.to(torch.int32))
    return _out_project(p, out), cache


def _chunk_qkv(p, x, *, cfg, offsets: torch.Tensor, rope_theta: float):
    """Chunk-prefill front half shared by the dense, paged and ring
    variants: q/k/v projections, qk-norm and RoPE at the rows' absolute
    positions."""
    C = x.shape[1]
    q = _project(p, x, "wq")                   # (B, C, H, D)
    k_new = _project(p, x, "wk")               # (B, C, K, D)
    v_new = _project(p, x, "wv")
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"])
        k_new = rms_norm(k_new, p["k_norm"])
    pos = offsets[:, None] + torch.arange(C, device=x.device)[None, :]
    if cfg.rope_fraction > 0:
        inv = _rope(cfg, rope_theta, x.device)
        q = apply_rope(q, pos, inv)
        k_new = apply_rope(k_new, pos, inv)
    return q, k_new, v_new, pos


def _chunk_attend(p, q, k_cache, v_cache, attend,
                  shard_axis=None) -> torch.Tensor:
    """Chunk-prefill back half: chunk queries over the whole (updated)
    cache view, masked per row by ``attend`` (B, C, W), then ``wo``
    (after the head gather under concat-TP)."""
    B, C, H, hd = q.shape
    K = k_cache.shape[2]
    qg = q.reshape(B, C, K, H // K, hd)
    s = torch.einsum("bckgd,bwkd->bkgcw", qg, k_cache).float() \
        / math.sqrt(hd)
    s = torch.where(attend[:, None, None, :, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1).to(v_cache.dtype)
    out = torch.einsum("bkgcw,bwkd->bckgd", w, v_cache).reshape(B, C, H, hd)
    return _out_project(p, out, shard_axis)


def _chunk_ring_attend(positions: torch.Tensor, pos: torch.Tensor,
                       window: int) -> torch.Tensor:
    """(B, C, W) chunk mask over a ring's slots: written, causally
    visible, and inside the sliding window when one is set."""
    slot_pos = positions[:, None, :]
    attend = (slot_pos >= 0) & (slot_pos <= pos[:, :, None])
    if window:
        attend = attend & (slot_pos > pos[:, :, None] - window)
    return attend


def prefill_chunk_into_cache(p, x, cache: KVCache, *, cfg,
                             offsets: torch.Tensor, n_new: torch.Tensor,
                             window: int | None = None,
                             rope_theta: float | None = None,
                             shard_axis=None):
    """Chunked prefill: extend a ring cache by up to C prompt tokens per
    row, in place.  x: (B, C, d) right-padded; offsets: (B,) tokens each
    row has cached; n_new: (B,) valid tokens (0 = bystander, untouched).
    Chunk queries attend to the row's cache plus the chunk (written
    first), masked by slot position and the window.  ``shard_axis``
    (concat-TP): this rank's heads, gathered before ``wo``
    (:func:`_out_project`)."""
    C = x.shape[1]
    W = cache.k.shape[1]
    window, theta = _layer_args(cfg, window, rope_theta)
    q, k_new, v_new, pos = _chunk_qkv(p, x, cfg=cfg, offsets=offsets,
                                      rope_theta=theta)
    valid_new = torch.arange(C, device=x.device)[None, :] < n_new[:, None]
    slot = (pos % W).long()
    bidx = torch.arange(x.shape[0], device=x.device)[:, None]
    sel = valid_new[..., None, None]
    cache.k[bidx, slot] = torch.where(sel, k_new.to(cache.k.dtype),
                                      cache.k[bidx, slot])
    cache.v[bidx, slot] = torch.where(sel, v_new.to(cache.v.dtype),
                                      cache.v[bidx, slot])
    cache.positions[bidx, slot] = torch.where(
        valid_new, pos.to(torch.int32), cache.positions[bidx, slot])
    cache.length.copy_(torch.where(n_new > 0, offsets + n_new, cache.length))
    attend = _chunk_ring_attend(cache.positions, pos, window)
    return _chunk_attend(p, q, cache.k, cache.v, attend, shard_axis), cache


def prefill_chunk_into_paged_cache(p, x, cache: PagedKVCache, *, cfg,
                                   offsets: torch.Tensor,
                                   n_new: torch.Tensor,
                                   window: int | None = None,
                                   rope_theta: float | None = None,
                                   shard_axis=None):
    """Chunked prefill against a block-paged cache, in place: the same
    contract and masks as :func:`prefill_chunk_into_cache` (position
    ``p`` at axis index ``p``), K/V landing in pool blocks through the
    row's block table; padded and bystander positions go to the sink.
    Full-attention layers only: a sliding layer takes the ring pool."""
    if window:
        raise ValueError("classic paged chunks attend the full context; "
                         "sliding layers take the ring variant")
    C = x.shape[1]
    sink = cache.k.shape[0] - 1
    bs = cache.k.shape[1]
    M = cache.block_tables.shape[1]
    _, theta = _layer_args(cfg, 0, rope_theta)
    q, k_new, v_new, pos = _chunk_qkv(p, x, cfg=cfg, offsets=offsets,
                                      rope_theta=theta)
    valid_new = torch.arange(C, device=x.device)[None, :] < n_new[:, None]
    blk = torch.gather(cache.block_tables, 1,
                       (pos // bs).clamp(0, M - 1).long())
    ok = valid_new & (blk >= 0) & (pos < M * bs)
    dst = torch.where(ok, blk, sink).long()
    off = (pos % bs).long()
    cache.k[dst, off] = k_new.to(cache.k.dtype)
    cache.v[dst, off] = v_new.to(cache.v.dtype)
    length = torch.where(n_new > 0, offsets + n_new, cache.length)
    cache.length.copy_(length)
    k_view, v_view = paged_kv_view(cache.k, cache.v, cache.block_tables)
    pos_k = torch.arange(k_view.shape[1], device=x.device)[None, None, :]
    attend = (pos_k < length[:, None, None]) \
        & (pos_k <= pos[:, :, None])                           # (B, C, W)
    return _chunk_attend(p, q, k_view, v_view, attend, shard_axis), cache


def prefill_chunk_into_ring_cache(p, x, cache: PagedRingKVCache, *, cfg,
                                  offsets: torch.Tensor, n_new: torch.Tensor,
                                  window: int | None = None,
                                  rope_theta: float | None = None,
                                  shard_axis=None):
    """Chunked prefill against the wraparound ring pool, in place: the
    contract of :func:`prefill_chunk_into_cache`, K/V landing at ring slot
    ``pos % W`` through the window-sized block table (padded, bystander
    and unleased positions go to the sink).  A prompt longer than the
    window laps the ring; the per-slot ``positions`` and the dense window
    mask keep exactly the last ``window`` tokens attendable, as the dense
    sliding ring does.  The chunk must not exceed the ring (the engine
    checks): two positions of one chunk would share a slot."""
    C = x.shape[1]
    sink = cache.k.shape[0] - 1
    bs = cache.k.shape[1]
    W = cache.block_tables.shape[1] * bs
    window, theta = _layer_args(cfg, window, rope_theta)
    q, k_new, v_new, pos = _chunk_qkv(p, x, cfg=cfg, offsets=offsets,
                                      rope_theta=theta)
    valid_new = torch.arange(C, device=x.device)[None, :] < n_new[:, None]
    slot = (pos % W).long()
    blk = torch.gather(cache.block_tables, 1, slot // bs)
    ok = valid_new & (blk >= 0)
    dst = torch.where(ok, blk, sink).long()
    off = slot % bs
    cache.k[dst, off] = k_new.to(cache.k.dtype)
    cache.v[dst, off] = v_new.to(cache.v.dtype)
    bidx = torch.arange(x.shape[0], device=x.device)[:, None]
    cache.positions[bidx, slot] = torch.where(
        ok, pos.to(torch.int32), cache.positions[bidx, slot])
    cache.length.copy_(torch.where(n_new > 0, offsets + n_new, cache.length))
    k_view, v_view = paged_kv_view(cache.k, cache.v, cache.block_tables)
    attend = _chunk_ring_attend(cache.positions, pos, window)
    return _chunk_attend(p, q, k_view, v_view, attend, shard_axis), cache
