"""GQA flash-decode: CUDA kernel wrappers and their plain PyTorch versions.

``gqa_decode`` (dense ring-buffer cache) and ``gqa_decode_paged`` (block
pool) take the reference's shapes and return ``(B, H, D)`` in ``q``'s
dtype.  For CUDA tensors they launch ``csrc/decode_attention.cu`` on the
current stream, one kernel per call; for CPU tensors they run the plain
version below, the same masked softmax computed in one shot in fp32 (the
Pallas kernel's arithmetic).  Nothing on the CUDA path falls back to the
plain version.

The launch reads no length on the host and never synchronizes: the grid
follows the shapes and the card's SM count (:func:`decode_grid`), and each
CTA finds its row's live span on the device and takes its piece of it
(:func:`split_range`).  The splits meet in a scratch buffer whose atomic
tickets start at zero and which the kernel leaves at zero (:func:`_scratch`),
so a launch can be captured into a CUDA graph and replayed after the
lengths or the mask change in place.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from .. import check_launch, count_launch, library, refuse_grad, sm_count

NEG_INF = -1e30

#: CTAs a row's splits put on each SM, in one wave (the heads body's launch
#: bounds let 4 sit there; 2 measured faster: fewer prologues and merges,
#: PERF.md)
CTAS_PER_SM = 2
#: the most pieces one merge stages (kMaxSplits in the source)
MAX_SPLITS = 32
#: the heads body's shared-memory ring (kRingBytes): 3 stages of 8 KB K and
#: V tiles, where a merge stages its pieces' accumulators
RING_BYTES = 3 * 2 * 8192
#: the head dims the kernel is built for
HEAD_DIMS = (32, 64, 128, 256)
#: the least a split of a whole row holds, in slots (half a bf16 D=128 tile)
MIN_SPLIT_SLOTS = 16
#: the query heads a kv head may have for the group body (two 8-row blocks
#: of the tensor-core tile), and the fewest that take it in bf16 (at G 2
#: the heads body also reads each K/V row once, but the group body's
#: tensor-core tile still ran faster: PERF.md)
GROUP_MAX_G = 16
GROUP_MIN_G = 2
#: the bodies, as the source numbers them
BODIES = {"heads": 0, "group": 1}
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


class DecodePlan(NamedTuple):
    """A launch's plan.  ``body``: ``"heads"`` (GT = 1 or 2 query heads a
    CTA, fp32 FFMA; every fp32 launch) or ``"group"`` (every query head of
    a kv head a CTA, on tensor cores; bf16 only).  ``gt``: query heads a
    CTA (G for the group body).  ``splits``: pieces a row's live span is
    cut into, one CTA each."""
    body: str
    gt: int
    splits: int


def gqa_decode_plain(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, valid: torch.Tensor
                     ) -> torch.Tensor:
    """q (B,H,D); k/v (B,W,K,D); valid (B,W) bool -> (B,H,D).  Scores
    q.k/sqrt(D) in fp32, invalid slots -1e30, softmax, weighted V; a row
    with no valid slot yields the mean of V over its W slots."""
    B, H, D = q.shape
    K = k_cache.shape[2]
    qg = q.float().reshape(B, K, H // K, D)
    s = torch.einsum("bkgd,bwkd->bkgw", qg, k_cache.float()) / math.sqrt(D)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgw,bwkd->bkgd", w, v_cache.float())
    return out.reshape(B, H, D).to(q.dtype)


def paged_view(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """Gather a request-major (B, M*bs, K, D) view out of a (P, bs, K, D)
    pool; unassigned (-1) entries gather block 0."""
    B, M = block_tables.shape
    return pool[block_tables.clamp_min(0).long()].reshape(
        B, M * pool.shape[1], *pool.shape[2:])


def gqa_decode_paged_plain(q: torch.Tensor, k_pool: torch.Tensor,
                           v_pool: torch.Tensor, block_tables: torch.Tensor,
                           lengths: torch.Tensor) -> torch.Tensor:
    """The paged oracle: gather the pages, mask positions >= length."""
    W = block_tables.shape[1] * k_pool.shape[1]
    valid = (torch.arange(W, device=q.device)[None, :]
             < lengths.to(q.device)[:, None])
    return gqa_decode_plain(q, paged_view(k_pool, block_tables),
                            paged_view(v_pool, block_tables), valid)


def ring_bytes(body: str, D: int) -> int:
    """The body's shared-memory ring at head dim ``D`` (``ring_bytes`` in
    the source): the heads body's 48 KB; the group body's 32-slot tiles (8
    KB of K up to D = 128) in 3 stages, 2 at D = 256 (64 KB)."""
    if body == "group":
        stages = 2 if D == 256 else 3
        slots = 32 if D >= 128 else 8192 // (2 * D)
        return stages * 2 * slots * D * 2
    return RING_BYTES


def merge_cap(body: str, D: int, gt: int) -> int:
    """The most pieces one merge stages: ``gt x D`` fp32 accumulators a
    piece in the body's ring, at most ``MAX_SPLITS`` (the heads body at D =
    256 and GT 2: 24; the group body at chatglm3's G 16, D 128: 6)."""
    return min(MAX_SPLITS, ring_bytes(body, D) // (gt * D * 4))


def max_splits(body: str, D: int, gt: int) -> int:
    """The most splits a row may take: two merge levels of at most
    :func:`merge_cap` pieces each."""
    return merge_cap(body, D, gt) ** 2


def merge_groups(S: int, cap: int) -> list[tuple[int, int]]:
    """The kernel's first merge level: ``S`` splits in ``ceil(S / cap)``
    groups of ``ceil(S / groups)`` consecutive splits (the last may hold
    fewer), as ``[first, end)`` ranges.  One group is the single merge of
    all S pieces in split order."""
    ng = -(-S // cap)
    sg = -(-S // ng)
    return [(j * sg, min(S, (j + 1) * sg)) for j in range(ng)]


def decode_grid(B: int, K: int, G: int, W: int, sms: int, D: int,
                dtype: torch.dtype = torch.bfloat16,
                plan: DecodePlan | None = None) -> DecodePlan:
    """The launch's :class:`DecodePlan`, from the shapes, the type and the
    card's SM count alone (no length: a CUDA graph replays it).

    fp32 (IEEE fp32, no tensor cores) takes the heads body (GT 2 for even
    G, else 1) at the split count it took before the group body existed:
    ``units = B*K*G/GT`` units of S CTAs, S as many as one wave of
    ``CTAS_PER_SM`` CTAs an SM holds, at most one per ``MIN_SPLIT_SLOTS``
    slots of ``W`` and at most :func:`merge_cap` (one merge), at least
    one; so its bits are unchanged.

    bf16, the rule the phase-2 shapes' times set (``launch/decode_timing
    --sweep``, PERF.md):

    * the group body (GT = G: each K/V row crosses from device memory once
      a group, where the heads body read it G / 2 times) at ``2 <= G <=
      GROUP_MAX_G`` where D <= 128, and at D = 256 where the heads body's
      one-merge grid (units x :func:`merge_cap`) would leave SMs idle
      (gemma3's one row over 32,768 slots: 48 CTAs); two CTAs an SM;
    * else the heads body at one CTA an SM (G = 1; gemma3's 8 rows, where
      a group's 64 KB merge of 4 KB pieces cost more than a second read
      of its single kv head);
    * S: the wave, at most one per ``MIN_SPLIT_SLOTS`` slots of W, at
      most :func:`merge_cap` (one merge) unless one merge covers less
      than half the SMs (``units x cap < sms / 2``), then at most
      :func:`max_splits` (two merge levels: gemma3's one long row takes
      256 CTAs in 16 groups).

    What bounds both bodies on the H100 is bytes (a slot costs ``2 K D``
    bf16 for ``4 H D`` flops); at the serving shapes they are chains of
    latencies (the span's loads, the K/V stream, the merges' round trips
    through L2), so the fewest CTAs that fill the card win.

    ``plan`` overrides (a concat-TP rank passes :func:`rank_plan`): its
    body and GT are taken as they are, its split count capped by
    :func:`max_splits` and at least one."""
    if plan is not None:
        body, gt, s = plan
        return DecodePlan(body, gt, max(1, min(s, max_splits(body, D, gt))))
    heads_gt = 2 if G % 2 == 0 else 1
    heads_units = B * K * (G // heads_gt)
    if dtype != torch.bfloat16:
        s = min(CTAS_PER_SM * sms // heads_units, -(-W // MIN_SPLIT_SLOTS),
                merge_cap("heads", D, heads_gt))
        return DecodePlan("heads", heads_gt, max(1, s))
    if GROUP_MIN_G <= G <= GROUP_MAX_G and (
            D <= 128 or heads_units * merge_cap("heads", D, heads_gt) < sms):
        body, gt, per_sm = "group", G, CTAS_PER_SM
    else:
        body, gt, per_sm = "heads", heads_gt, 1
    units = B * K * (G // gt)
    cap = merge_cap(body, D, gt)
    s = min(per_sm * sms // units, -(-W // MIN_SPLIT_SLOTS),
            cap if 2 * units * cap >= sms else cap * cap)
    return DecodePlan(body, gt, max(1, s))


def rank_plan(B: int, K: int, G: int, W: int, sms: int, D: int,
              shards: int, dtype: torch.dtype = torch.bfloat16
              ) -> DecodePlan:
    """The plan a concat-TP rank holding ``K`` of ``K * shards`` kv heads
    launches with: the plan one device takes at the full kv heads (its
    body, GT and split count).  At its own K the rank would take more
    splits (twice as many at two ranks: the grid fills one wave either
    way) and merge each row's partials in another order.
    :func:`split_range` cuts a row by its own live span and S alone, and
    :func:`merge_groups` groups the pieces by S and the body's cap alone,
    so equal plans give the rank's heads the one-device body, pieces and
    merge order, and their bits (the rank's own shapes could pick another
    body where one device's kv heads decide it, or another merge depth)."""
    return decode_grid(B, K * shards, G, W, sms, D, dtype)


def split_range(lo: int, hi: int, S: int, s: int) -> tuple[int, int]:
    """Split ``s`` of ``S`` of a row's live span ``[lo, hi)``: the
    kernel's partition (the formula in ``csrc/decode_attention.cu``)."""
    n = hi - lo
    return lo + s * n // S, lo + (s + 1) * n // S


def _entry():
    fn = library("decode_attention").repro_gqa_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 8
                       + [ctypes.c_longlong] + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


#: (device index, stream, B, H, D, body, GT, S) -> the scratch of eager
#: launches of that layout on that stream.  One buffer per layout: its
#: tickets are never anything but tickets, so they stay zero between calls.
_SCRATCH: dict[tuple[int, ...], torch.Tensor] = {}


def _scratch(device: torch.device, stream: int, B: int, H: int, D: int,
             plan: DecodePlan) -> torch.Tensor:
    """A scratch with zero tickets for a launch of this layout.

    Eager launches on one stream run in order and share one buffer per
    layout, zeroed when it is made.  A launch being captured into a CUDA
    graph gets a buffer of its own from the graph's pool, which the graph
    zeroes before the kernel at every replay: a buffer made inside one
    capture is zeroed only by that graph, and an eager one may be in use
    on its stream while a graph replays."""
    capturing = torch.cuda.is_current_stream_capturing()
    key = (device.index, stream, B, H, D, *plan)
    buf = None if capturing else _SCRATCH.get(key)
    if buf is None:
        fn = library("decode_attention").repro_gqa_decode_scratch_bytes
        fn.argtypes = [ctypes.c_int] * 6
        fn.restype = ctypes.c_size_t
        buf = torch.zeros(fn(BODIES[plan.body], B, H, D, plan.gt,
                             plan.splits), dtype=torch.uint8,
                          device=device)
        if not capturing:
            _SCRATCH[key] = buf
    return buf


def _check_common(q, k, v, kernel):
    tensors = (q, k, v)
    if any(not t.is_cuda for t in tensors) or \
            len({t.device for t in tensors}) != 1:
        raise ValueError(f"{kernel}: q, k and v must lie on one CUDA device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"{kernel}: q/k/v must share float32 or bfloat16, "
                         f"got {q.dtype}/{k.dtype}/{v.dtype}")
    if q.dim() != 3 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{kernel}: want q (B,H,D) and k/v of one 4-d "
                         f"shape, got {tuple(q.shape)} {tuple(k.shape)} "
                         f"{tuple(v.shape)}")
    B, H, D = q.shape
    K = k.shape[2]
    if D not in HEAD_DIMS or k.shape[3] != D or H % K:
        raise ValueError(f"{kernel}: head_dim must be one of {HEAD_DIMS} "
                         f"(the kernel's instantiations) and H a multiple of "
                         f"K; got H={H} K={K} D={D}")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{kernel}: tensors must be contiguous and "
                             "16-byte aligned")
    return B, H, K, D


def _launch(paged, q, k, v, valid, tables, lengths, W, bs, M, kernel, plan):
    B, H, K, D = q.shape[0], q.shape[1], k.shape[2], q.shape[2]
    plan = decode_grid(B, K, H // K, W, sm_count(q.device), D, q.dtype, plan)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scratch = _scratch(q.device, stream, B, H, D, plan)
    out = torch.empty_like(q)
    err = _entry()(
        int(paged), _DTYPE_CODE[q.dtype], BODIES[plan.body], q.data_ptr(),
        k.data_ptr(),
        v.data_ptr(), valid.data_ptr() if valid is not None else None,
        tables.data_ptr() if tables is not None else None,
        lengths.data_ptr() if lengths is not None else None,
        out.data_ptr(), scratch.data_ptr(), scratch.numel(), B, H, K, D, W,
        plan.gt, plan.splits, bs, M, stream)
    check_launch(err, kernel)
    count_launch(kernel)
    return out


def gqa_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               valid: torch.Tensor, plan: DecodePlan | None = None
               ) -> torch.Tensor:
    """q (B,H,D); k/v_cache (B,W,K,D); valid (B,W) bool -> (B,H,D).
    ``plan``: the launch's plan (:func:`decode_grid`'s override; None: the
    shapes' own)."""
    refuse_grad("gqa_decode", q, k_cache, v_cache)
    if not q.is_cuda:
        return gqa_decode_plain(q, k_cache, v_cache, valid)
    B, H, K, D = _check_common(q, k_cache, v_cache, "gqa_decode")
    W = k_cache.shape[1]
    if k_cache.shape[0] != B or W < 1 or valid.shape != (B, W) \
            or valid.dtype != torch.bool or valid.device != q.device \
            or not valid.is_contiguous():
        raise ValueError("gqa_decode: want k/v (B,W,K,D) and a contiguous "
                         f"bool valid (B,W) on q's device, got "
                         f"{tuple(k_cache.shape)} {tuple(valid.shape)} "
                         f"{valid.dtype}")
    return _launch(False, q, k_cache, v_cache, valid, None, None, W, 1, 1,
                   "gqa_decode", plan)


def gqa_decode_paged(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, block_tables: torch.Tensor,
                     lengths: torch.Tensor, plan: DecodePlan | None = None
                     ) -> torch.Tensor:
    """q (B,H,D); pools (P,bs,K,D); block_tables (B,M) int32 (-1 =
    unassigned); lengths (B,) int32 -> (B,H,D).  The dense per-request
    view is never built: the kernel maps each slot through the table.
    ``plan`` as in :func:`gqa_decode`."""
    refuse_grad("gqa_decode_paged", q, k_pool, v_pool)
    if not q.is_cuda:
        return gqa_decode_paged_plain(q, k_pool, v_pool, block_tables,
                                      lengths)
    B, H, K, D = _check_common(q, k_pool, v_pool, "gqa_decode_paged")
    M = block_tables.shape[1] if block_tables.dim() == 2 else -1
    if M < 1:
        raise ValueError("gqa_decode_paged: block_tables must be (B, M) "
                         f"with M >= 1, got {tuple(block_tables.shape)}")
    for name, t, shape in (("block_tables", block_tables, (B, M)),
                           ("lengths", lengths, (B,))):
        if t.shape != shape or t.dtype != torch.int32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"gqa_decode_paged: {name} must be a "
                             f"contiguous int32 {shape} on q's device, got "
                             f"{tuple(t.shape)} {t.dtype}")
    bs = k_pool.shape[1]
    return _launch(True, q, k_pool, v_pool, None, block_tables, lengths,
                   M * bs, bs, M, "gqa_decode_paged", plan)
