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

import torch

from .. import check_launch, count_launch, library, sm_count

NEG_INF = -1e30

#: CTAs a row's splits put on each SM, in one wave (the launch bounds let 4
#: sit there; 2 measured faster: fewer prologues and merges, PERF.md)
CTAS_PER_SM = 2
#: the kernel's most splits of a row (kMaxSplits in the source)
MAX_SPLITS = 32
#: the kernel's shared-memory ring (kRingBytes): 3 stages of 8 KB K and V
#: tiles, where the last CTA of a row merges its splits' accumulators
RING_BYTES = 3 * 2 * 8192
#: the head dims the kernel is built for
HEAD_DIMS = (32, 64, 128, 256)
#: the least a split of a whole row holds, in slots (half a bf16 D=128 tile)
MIN_SPLIT_SLOTS = 16
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


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


def max_splits(D: int, gt: int) -> int:
    """The most splits a row of head dim ``D`` may take at ``gt`` query
    heads a CTA: the last CTA merges ``S x gt x D`` fp32 accumulators in
    the kernel's ring (``max_splits`` in the source), so 24 at D = 256
    and gt = 2, else ``MAX_SPLITS``."""
    return min(MAX_SPLITS, RING_BYTES // (gt * D * 4))


def decode_grid(B: int, K: int, G: int, W: int, sms: int, D: int,
                splits: int | None = None) -> tuple[int, int]:
    """``(GT, S)``: query heads per CTA (2 when G is even, else 1) and
    splits per row.  The grid is ``B*K*G/GT`` units of ``S`` CTAs: as many
    splits as one wave of ``CTAS_PER_SM`` CTAs on each of the ``sms`` SMs
    holds, at most :func:`max_splits` of ``(D, GT)`` and at most one per
    ``MIN_SPLIT_SLOTS`` slots of ``W``, at least one.  Shapes alone
    decide it: no length.  ``splits`` overrides S (capped by
    :func:`max_splits`, at least one): a concat-TP rank passes
    :func:`rank_splits`."""
    gt = 2 if G % 2 == 0 else 1
    if splits is not None:
        return gt, max(1, min(splits, max_splits(D, gt)))
    units = B * K * (G // gt)
    s = min(CTAS_PER_SM * sms // units, -(-W // MIN_SPLIT_SLOTS),
            max_splits(D, gt))
    return gt, max(1, s)


def rank_splits(B: int, K: int, G: int, W: int, sms: int, D: int,
                shards: int) -> int:
    """The split count a concat-TP rank holding ``K`` of ``K * shards`` kv
    heads launches with: the count one device takes at the full kv heads.
    At its own K the rank would take more splits (twice as many at two
    ranks: the grid fills one wave either way) and merge each row's
    partials in another order.  :func:`split_range` cuts a row by its
    own live span and S alone, so equal counts give the rank's heads the
    one-device pieces and merge order, and their bits.  GT follows G,
    which sharding keeps."""
    return decode_grid(B, K * shards, G, W, sms, D)[1]


def split_range(lo: int, hi: int, S: int, s: int) -> tuple[int, int]:
    """Split ``s`` of ``S`` of a row's live span ``[lo, hi)``: the
    kernel's partition (the formula in ``csrc/decode_attention.cu``)."""
    n = hi - lo
    return lo + s * n // S, lo + (s + 1) * n // S


def _entry():
    fn = library("decode_attention").repro_gqa_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                       + [ctypes.c_longlong] + [ctypes.c_int] * 9
                       + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


#: (device index, stream, B, H, D, GT, S) -> the scratch of eager launches
#: of that layout on that stream.  One buffer per layout: its tickets are
#: never anything but tickets, so they stay zero between calls.
_SCRATCH: dict[tuple[int, ...], torch.Tensor] = {}


def _scratch(device: torch.device, stream: int, B: int, H: int, D: int,
             gt: int, S: int) -> torch.Tensor:
    """A scratch with zero tickets for a launch of this layout.

    Eager launches on one stream run in order and share one buffer per
    layout, zeroed when it is made.  A launch being captured into a CUDA
    graph gets a buffer of its own from the graph's pool, which the graph
    zeroes before the kernel at every replay: a buffer made inside one
    capture is zeroed only by that graph, and an eager one may be in use
    on its stream while a graph replays."""
    capturing = torch.cuda.is_current_stream_capturing()
    key = (device.index, stream, B, H, D, gt, S)
    buf = None if capturing else _SCRATCH.get(key)
    if buf is None:
        fn = library("decode_attention").repro_gqa_decode_scratch_bytes
        fn.argtypes = [ctypes.c_int] * 5
        fn.restype = ctypes.c_size_t
        buf = torch.zeros(fn(B, H, D, gt, S), dtype=torch.uint8,
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


def _launch(paged, q, k, v, valid, tables, lengths, W, bs, M, kernel,
            splits):
    B, H, K, D = q.shape[0], q.shape[1], k.shape[2], q.shape[2]
    gt, n_split = decode_grid(B, K, H // K, W, sm_count(q.device), D,
                              splits)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    scratch = _scratch(q.device, stream, B, H, D, gt, n_split)
    out = torch.empty_like(q)
    err = _entry()(
        int(paged), _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), valid.data_ptr() if valid is not None else None,
        tables.data_ptr() if tables is not None else None,
        lengths.data_ptr() if lengths is not None else None,
        out.data_ptr(), scratch.data_ptr(), scratch.numel(), B, H, K, D, W,
        gt, n_split, bs, M, stream)
    check_launch(err, kernel)
    count_launch(kernel)
    return out


def gqa_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               valid: torch.Tensor, splits: int | None = None
               ) -> torch.Tensor:
    """q (B,H,D); k/v_cache (B,W,K,D); valid (B,W) bool -> (B,H,D).
    ``splits``: the split count a row takes (:func:`decode_grid`'s
    override; None: the grid's own)."""
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
                   "gqa_decode", splits)


def gqa_decode_paged(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, block_tables: torch.Tensor,
                     lengths: torch.Tensor, splits: int | None = None
                     ) -> torch.Tensor:
    """q (B,H,D); pools (P,bs,K,D); block_tables (B,M) int32 (-1 =
    unassigned); lengths (B,) int32 -> (B,H,D).  The dense per-request
    view is never built: the kernel maps each slot through the table.
    ``splits`` as in :func:`gqa_decode`."""
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
                   M * bs, bs, M, "gqa_decode_paged", splits)
