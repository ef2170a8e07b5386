"""GQA flash-decode: CUDA kernel wrappers and their plain PyTorch versions.

``gqa_decode`` (dense ring-buffer cache) and ``gqa_decode_paged`` (block
pool) take the reference's shapes and return ``(B, H, D)`` in ``q``'s
dtype.  For CUDA tensors they launch ``csrc/decode_attention.cu`` on the
current stream; for CPU tensors they run the plain version below, the
same masked softmax computed in one shot in fp32 (the Pallas kernel's
arithmetic).  Nothing on the CUDA path falls back to the plain version.
"""
from __future__ import annotations

import ctypes
import math

import torch

from .. import check_launch, count_launch, library

NEG_INF = -1e30

#: split W until about four CTAs sit on each of the H100's 132 SMs
_TARGET_CTAS = 4 * 132
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


def _splits(ctas: int, W: int) -> tuple[int, int]:
    """(n_split, split_len) so that every split holds at least one slot."""
    n = max(1, min(-(-_TARGET_CTAS // max(ctas, 1)), -(-W // 32)))
    split_len = -(-W // n)
    return -(-W // split_len), split_len


def _entry():
    fn = library("decode_attention").repro_gqa_decode
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 10
                       + [ctypes.c_int] * 9 + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


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
    if D not in (32, 64, 128) or k.shape[3] != D or H % K:
        raise ValueError(f"{kernel}: head_dim must be 32/64/128 and H a "
                         f"multiple of K; got H={H} K={K} D={D}")
    for t in tensors:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{kernel}: tensors must be contiguous and "
                             "16-byte aligned")
    return B, H, K, D


def _launch(paged, q, k, v, valid, tables, lengths, W, bs, M, kernel):
    B, H, K, D = q.shape[0], q.shape[1], k.shape[2], q.shape[2]
    n_split, split_len = _splits(B * K, W)
    out = torch.empty_like(q)
    part_acc = torch.empty((B, H, n_split, D), dtype=torch.float32,
                           device=q.device)
    part_m = torch.empty((B, H, n_split), dtype=torch.float32,
                         device=q.device)
    part_l = torch.empty_like(part_m)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = _entry()(
        int(paged), _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), valid.data_ptr() if valid is not None else None,
        tables.data_ptr() if tables is not None else None,
        lengths.data_ptr() if lengths is not None else None,
        out.data_ptr(), part_acc.data_ptr(), part_m.data_ptr(),
        part_l.data_ptr(), B, H, K, D, W, n_split, split_len, bs, M, stream)
    check_launch(err, kernel)
    count_launch(kernel)
    return out


def gqa_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
               valid: torch.Tensor) -> torch.Tensor:
    """q (B,H,D); k/v_cache (B,W,K,D); valid (B,W) bool -> (B,H,D)."""
    if not q.is_cuda:
        return gqa_decode_plain(q, k_cache, v_cache, valid)
    B, H, K, D = _check_common(q, k_cache, v_cache, "gqa_decode")
    W = k_cache.shape[1]
    if k_cache.shape[0] != B or valid.shape != (B, W) \
            or valid.dtype != torch.bool or valid.device != q.device \
            or not valid.is_contiguous():
        raise ValueError("gqa_decode: want k/v (B,W,K,D) and a contiguous "
                         f"bool valid (B,W) on q's device, got "
                         f"{tuple(k_cache.shape)} {tuple(valid.shape)} "
                         f"{valid.dtype}")
    return _launch(False, q, k_cache, v_cache, valid, None, None, W, 1, 1,
                   "gqa_decode")


def gqa_decode_paged(q: torch.Tensor, k_pool: torch.Tensor,
                     v_pool: torch.Tensor, block_tables: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """q (B,H,D); pools (P,bs,K,D); block_tables (B,M) int32 (-1 =
    unassigned); lengths (B,) int32 -> (B,H,D).  The dense per-request
    view is never built: the kernel maps each slot through the table."""
    if not q.is_cuda:
        return gqa_decode_paged_plain(q, k_pool, v_pool, block_tables,
                                      lengths)
    B, H, K, D = _check_common(q, k_pool, v_pool, "gqa_decode_paged")
    M = block_tables.shape[1] if block_tables.dim() == 2 else -1
    for name, t, shape in (("block_tables", block_tables, (B, M)),
                           ("lengths", lengths, (B,))):
        if t.shape != shape or t.dtype != torch.int32 \
                or t.device != q.device or not t.is_contiguous():
            raise ValueError(f"gqa_decode_paged: {name} must be a "
                             f"contiguous int32 {shape} on q's device, got "
                             f"{tuple(t.shape)} {t.dtype}")
    bs = k_pool.shape[1]
    return _launch(True, q, k_pool, v_pool, None, block_tables, lengths,
                   M * bs, bs, M, "gqa_decode_paged")
