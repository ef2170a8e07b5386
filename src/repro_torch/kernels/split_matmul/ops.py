"""DOS parameter-split matmul: the CUDA kernel's wrapper, its planner and
its plain version.

``split_matmul(x, w, b, block_n=..., block_k=...)`` computes ``x @ w + b``
for x (M, K), w (K, N), b (N,) with w cut into (block_k, block_n) tiles,
with the Pallas kernel's arithmetic: N tiles (the paper's output-channel
split) are independent; K tiles (the inC split) accumulate in order, in
fp32, with the bias added to the first tile's product.  For CUDA tensors
it launches ``csrc/split_matmul.cu`` on the current stream with the grid
:func:`split_plan` picks; for CPU tensors it runs
:func:`split_matmul_plain`.  Nothing on the CUDA path falls back to the
plain version, and ragged shapes are masked in the kernel.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import check_launch, count_launch, library, refuse_grad, sm_count

#: k a pipeline step of the kernel, and y columns a CTA
BK, BN = 32, 64
#: the kernel's CTA shapes, (rows of y, k halves) -> (warps, CTAs an SM
#: holds by registers and shared memory)
SHAPES = {(64, 1): (4, 3), (64, 2): (8, 1), (32, 2): (4, 3)}
#: CTAs a cluster may split each K tile over (portable cluster sizes)
CL_CHOICES = (1, 2, 4, 8)
#: warps an SM needs in flight before its FFMA pipes run at rate (the
#: planner's model: fewer warps run proportionally slower)
WARPS_AT_RATE = 8


class SplitPlan(NamedTuple):
    """How one call runs: CTAs of ``bm`` x BN outputs whose threads split
    each step's k in ``kh`` halves, ``cl`` CTAs a cluster; the grid is
    (``m_tiles``, ``cols``, ``cl``), ``cols`` = N tiles x ``sub_tiles``
    blocks of BN columns."""
    bm: int
    kh: int
    cl: int
    m_tiles: int
    cols: int
    sub_tiles: int


def split_matmul_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                       block_n: int, block_k: int) -> torch.Tensor:
    """Tile by tile in fp32: each N tile's K tiles summed in order, the
    bias added at the first; the N tiles concatenated."""
    xf, wf, bf = x.float(), w.float(), b.float()
    K, N = wf.shape
    cols = []
    for n0 in range(0, N, block_n):
        n1 = min(N, n0 + block_n)
        acc = None
        for k0 in range(0, K, block_k):
            part = xf[:, k0:k0 + block_k] @ wf[k0:k0 + block_k, n0:n1]
            acc = part + bf[n0:n1] if acc is None else acc + part
        cols.append(acc)
    return torch.cat(cols, dim=1).to(x.dtype)


def piece_steps(k_lo: int, k_hi: int, rank: int, cl: int) -> tuple[int, int]:
    """Steps ``[s0, s1)`` (BK k each, from ``k_lo``) of the K tile
    ``[k_lo, k_hi)`` that cluster rank ``rank`` of ``cl`` contracts: the
    kernel's ``piece``."""
    steps = -(-(k_hi - k_lo) // BK)
    return rank * steps // cl, (rank + 1) * steps // cl


def split_plan(M: int, N: int, K: int, block_n: int, block_k: int,
               sms: int) -> SplitPlan:
    """Pick the CTA shape and the cluster split from the shapes and the
    SM count.

    Model: an SM holding n CTAs of ``warps`` warps each, every CTA walking
    s steps of bm rows, takes n * bm * s / min(1, n * warps /
    WARPS_AT_RATE); the busiest SM holds ceil(CTAs / sms), at most the
    shape's CTAs an SM a wave.  A cluster's reduction adds one step per
    rank and K tile.  Ties go to the smaller cluster, then the taller and
    the narrower CTA."""
    k_tiles = -(-K // block_k)
    steps = sum(-(-(min(K, k + block_k) - k) // BK)
                for k in range(0, K, block_k))
    widest = -(-min(block_k, K) // BK)
    sub = -(-min(block_n, N) // BN)
    cols = -(-N // block_n) * sub
    best = None
    for (bm, kh), (warps, per_sm_max) in SHAPES.items():
        m_tiles = -(-M // bm)
        for cl in CL_CHOICES:
            if cl > 1 and cl > widest:
                break
            ctas = m_tiles * cols * cl
            per_sm = -(-ctas // sms)
            waves = -(-per_sm // per_sm_max)
            n = min(per_sm, per_sm_max)
            work = bm * (-(-steps // cl) + (cl - 1) * k_tiles * (cl > 1))
            cost = waves * n * work / min(1.0, n * warps / WARPS_AT_RATE)
            key = (cost, cl, -bm, kh)
            if best is None or key < best[0]:
                best = (key, SplitPlan(bm, kh, cl, m_tiles, cols, sub))
    return best[1]


def tile_of(plan: SplitPlan, block_n: int, N: int, bx: int, by: int
            ) -> tuple[int, int, int, int] | None:
    """Rows ``[m0, m0 + bm)`` and columns ``[n0, n_hi)`` (cut at BN past
    n0) that grid cell (bx, by) of ``plan`` writes, or None where the
    cell lies past its N tile: the kernel's own mapping."""
    n_lo = (by // plan.sub_tiles) * block_n
    n_hi = min(N, n_lo + block_n)
    n0 = n_lo + (by % plan.sub_tiles) * BN
    if n0 >= n_hi:
        return None
    return bx * plan.bm, bx * plan.bm + plan.bm, n0, min(n_hi, n0 + BN)


def _entry():
    fn = library("split_matmul").repro_split_matmul
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=1024)
def _device_plan(index: int, M: int, N: int, K: int, block_n: int,
                 block_k: int) -> SplitPlan:
    """:func:`split_plan` on CUDA device ``index``, once per shape, so that
    its search does not run again on every call."""
    return split_plan(M, N, K, block_n, block_k,
                      sm_count(torch.device("cuda", index)))


def vector_copies(x: torch.Tensor, w: torch.Tensor, block_n: int,
                  block_k: int) -> bool:
    """Whether the kernel may copy 16 bytes at a time: every row and tile
    edge falls on 4 floats and both pointers are 16-byte aligned."""
    K, N = w.shape
    return (K % 4 == 0 and N % 4 == 0 and block_n % 4 == 0
            and block_k % 4 == 0 and x.data_ptr() % 16 == 0
            and w.data_ptr() % 16 == 0)


def split_matmul(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                 block_n: int, block_k: int,
                 plan: SplitPlan | None = None) -> torch.Tensor:
    """x (M, K); w (K, N); b (N,) -> (M, N).  On CUDA all three must be
    contiguous float32 on one device.  ``plan`` overrides the planner's
    choice (for timing its alternatives)."""
    if block_n < 1 or block_k < 1:
        raise ValueError(f"split_matmul: block_n ({block_n}) and block_k "
                         f"({block_k}) must be positive")
    refuse_grad("split_matmul", x, w, b)
    if not x.is_cuda:
        return split_matmul_plain(x, w, b, block_n, block_k)
    tensors = (x, w, b)
    if any(not t.is_cuda for t in tensors) or \
            len({t.device for t in tensors}) != 1:
        raise ValueError("split_matmul: x, w and b must lie on one CUDA "
                         "device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("split_matmul: x, w and b must be float32, got "
                         f"{x.dtype}/{w.dtype}/{b.dtype}")
    if x.dim() != 2 or w.dim() != 2 or w.shape[0] != x.shape[1] \
            or b.shape != (w.shape[1],) or x.shape[1] == 0:
        raise ValueError("split_matmul: want x (M,K), w (K,N), b (N,) with "
                         f"K > 0; got {tuple(x.shape)} {tuple(w.shape)} "
                         f"{tuple(b.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("split_matmul: x, w and b must be contiguous")
    (M, K), N = x.shape, w.shape[1]
    y = torch.empty((M, N), dtype=torch.float32, device=x.device)
    if y.numel() == 0:
        return y
    if plan is None:
        plan = _device_plan(x.device.index, M, N, K, block_n, block_k)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _entry()(x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
                   M, N, K, block_n, block_k, plan.bm, plan.kh, plan.cl,
                   int(vector_copies(x, w, block_n, block_k)), stream)
    check_launch(err, "split_matmul")
    count_launch("split_matmul")
    return y
