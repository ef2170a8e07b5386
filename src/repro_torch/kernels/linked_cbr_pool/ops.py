"""Linked CBR-AvgPool: the CUDA kernel's wrapper and its plain version.

``cbr_avgpool(x, w, b)`` computes ``avgpool2x2(relu(x @ w + b))`` for an
NHWC feature map ``x`` (N, H, W, C), a 1x1 conv weight ``w`` (C, OC) or
(1, 1, C, OC) and a bias ``b`` (OC,), giving (N, H // 2, W // 2, OC); an
odd H or W drops the last row or column, as the reference's VALID pooling
does.  For CUDA tensors it launches ``csrc/linked_cbr_pool.cu`` on the
current stream with the grid :func:`cbra_plan` picks; for CPU tensors it
runs :func:`cbr_avgpool_plain`.  Nothing on the CUDA path falls back to
the plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from .. import (SM_SMEM, CTA_SMEM_RESERVED, check_launch, count_launch,
                library, refuse_grad, sm_count)

#: channels of C a pipeline step
BK = 32
#: the kernel's CTA shapes, name -> (TXN, TYN, KH, TSQ): a CTA of KH x TXN
#: x TYN threads computes TSQ x TYN pooled outputs (squares) x 8 TXN output
#: channels, each thread TSQ squares x 8 channels; KH > 1 splits each
#: step's channels between KH parts of its threads.  mid (KH = 1) takes no
#: cluster and walks square tiles (big maps); small and tiny split k and
#: take clusters (small maps)
SHAPES = {"mid": (8, 16, 1, 2), "small": (4, 8, 2, 2), "tiny": (4, 8, 4, 1)}
#: cluster sizes a k-splitting shape takes (16 is non-portable)
CL_CHOICES = (1, 2, 4, 8, 16)
#: square tiles a walking CTA may take (the kernel's kWalkMax)
WALK_MAX = 8
#: the planner's model, in cycles, fitted to the sweeps of
#: ``launch/mask_cbra_timing.py`` on an H100: a work item (one step of one
#: tile) costs ITEM + FFMA_CYCLES per FFMA of a thread, plus STAGE1
#: without a ring; each extra k part PART (its sum through shared memory);
#: each doubling of the cluster CLUSTER (its barriers and its reduction
#: through distributed shared memory); the card issues ISSUE_RATE warp
#: FFMAs a scheduler cycle when full
ITEM, FFMA_CYCLES, STAGE1, PART, CLUSTER, ISSUE_RATE = \
    1280, 3.05, 200, 1500, 4500, 0.3


def cbra_ctas_per_sm(threads: int) -> int:
    """CTAs an SM holds by registers: the kernel's ``__launch_bounds__``
    minimum (kMinBlocks), which its register count meets."""
    return 3 if threads >= 128 else 6


class CbraPlan(NamedTuple):
    """How one call runs: CTAs of shape (``txn``, ``tyn``, ``kh``, ``tsq``),
    the grid (``sq_ctas``, ``oc_tiles``, ``cl``) with ``cl`` CTAs a cluster
    splitting C, and a cp.async ring of ``stages`` slots.  With kh = 1 (no
    cluster) CTA bx walks square tiles bx, bx + sq_ctas, ... of the
    ``sq_tiles`` (at most WALK_MAX); otherwise sq_ctas = sq_tiles."""
    txn: int
    tyn: int
    kh: int
    tsq: int
    cl: int
    stages: int
    sq_ctas: int
    sq_tiles: int
    oc_tiles: int


def cbra_steps(C: int, cl: int, rank: int) -> tuple[int, int]:
    """Steps ``[s0, s1)`` (BK channels each) of C that cluster rank
    ``rank`` of ``cl`` contracts: the kernel's own split."""
    steps = -(-C // BK)
    return rank * steps // cl, (rank + 1) * steps // cl


def cbra_tiles(plan: CbraPlan, bx: int) -> list[int]:
    """The square tiles CTA column ``bx`` of ``plan`` computes, in order."""
    return list(range(bx, plan.sq_tiles, plan.sq_ctas))


def cbra_tile(plan: CbraPlan, Q: int, OC: int, tile: int, by: int
              ) -> tuple[int, int, int, int]:
    """Pooled outputs ``[q0, q1)`` (flattened over n, ho, wo) and output
    channels ``[oc0, oc1)`` of square tile ``tile`` in grid row ``by``."""
    bsq, bn = plan.tsq * plan.tyn, 8 * plan.txn
    return (tile * bsq, min(Q, tile * bsq + bsq), by * bn,
            min(OC, by * bn + bn))


def cbra_pixels(q: int, H: int, W: int) -> list[tuple[int, int, int]]:
    """The pre-pool pixels (n, h, w) of pooled output q, corners in the
    kernel's order (dy, dx) = (0, 0), (0, 1), (1, 0), (1, 1)."""
    Ho, Wo = H // 2, W // 2
    n, r = divmod(q, Ho * Wo)
    ho, wo = divmod(r, Wo)
    return [(n, 2 * ho + c // 2, 2 * wo + c % 2) for c in range(4)]


def cbra_smem(txn: int, tyn: int, kh: int, tsq: int, cl: int,
              stages: int) -> int:
    """Shared memory of one CTA: the ring (or the partial block where it is
    larger and a split, kh or cl, sums through it) and the pixel table."""
    bsq, bn = tsq * tyn, 8 * txn
    ring = stages * (4 * bsq * (BK + 4) + BK * bn)
    walk = kh == 1 and cl == 1
    red = 0 if walk else 4 * bsq * bn
    return 4 * max(ring, red) + 4 * 4 * bsq * (WALK_MAX if walk else 1)


def cbra_vector_copies(C: int, OC: int, aligned: bool) -> bool:
    """Whether the kernel may copy 16 bytes at a time: every x row and w
    row falls on 4 floats (C and OC multiples of 4) and x, w and the
    output are 16-byte aligned."""
    return C % 4 == 0 and OC % 4 == 0 and aligned


def _candidates(N: int, H: int, W: int, C: int, OC: int, sms: int):
    """(cost key, plan) for each CTA shape, cluster size up to C's steps
    and ring depth up to a CTA's work items (see :func:`cbra_plan`)."""
    Q = N * (H // 2) * (W // 2)
    steps = -(-C // BK)
    depth = min(C, BK) if steps == 1 else BK
    for txn, tyn, kh, tsq in SHAPES.values():
        bsq, bn = tsq * tyn, 8 * txn
        threads = kh * txn * tyn
        sq_tiles, oc_tiles = -(-Q // bsq), -(-OC // bn)
        ffma = min(-(-depth // 4) * 4, BK // kh) * 32 * tsq
        for cl in CL_CHOICES if kh > 1 else (1,):
            if cl > steps:
                break
            st = -(-steps // cl)
            for stages in (1, 2, 3):
                smem = cbra_smem(txn, tyn, kh, tsq, cl, stages) \
                    + CTA_SMEM_RESERVED
                per_sm = min(cbra_ctas_per_sm(threads), SM_SMEM // smem)
                if kh == 1:
                    slots = max(1, sms * per_sm // oc_tiles)
                    walk = min(WALK_MAX, -(-sq_tiles // slots))
                    sq_ctas = -(-sq_tiles // walk)
                else:
                    walk, sq_ctas = 1, sq_tiles
                items = walk * st
                if stages > min(3, items):
                    break
                ctas = sq_ctas * oc_tiles * cl
                waves = max(1.0, ctas / (sms * per_sm))
                chain = items * (ITEM + FFMA_CYCLES * ffma + (
                    STAGE1 if stages == 1 else 0)) + PART * (kh - 1) \
                    + CLUSTER * (cl.bit_length() - 1)
                issue = ctas * items * threads // 32 * ffma / (
                    4 * sms * ISSUE_RATE)
                yield ((max(waves * chain, issue), ctas, cl, stages),
                       CbraPlan(txn, tyn, kh, tsq, cl, stages, sq_ctas,
                                sq_tiles, oc_tiles))


def cbra_plan(N: int, H: int, W: int, C: int, OC: int,
              sms: int) -> CbraPlan:
    """Pick the CTA shape, the cluster that splits C, the square tiles a
    CTA walks and the ring's depth from the shapes and the SM count.

    Model (cycles): a CTA's chain is its work items' cost plus the k
    parts' and the cluster's reductions; the waves of CTAs the SMs hold
    run one after another; the card's schedulers issue all items' FFMAs
    at ISSUE_RATE.  A call takes the larger of the waves' chains
    and the issue.  A walking shape spreads its square tiles over the
    CTAs the SMs hold at once.  Ties go to fewer CTAs, the smaller
    cluster, the shallower ring."""
    return min(_candidates(N, H, W, C, OC, sms))[1]


def cbra_plans(N: int, H: int, W: int, C: int, OC: int,
               sms: int) -> list[CbraPlan]:
    """Every plan :func:`cbra_plan` weighs, and each walking one also with
    one square tile a CTA (for tests and timing)."""
    plans = []
    for _, plan in _candidates(N, H, W, C, OC, sms):
        plans.append(plan)
        if plan.sq_ctas != plan.sq_tiles and plan.stages == 1:
            plans.append(plan._replace(sq_ctas=plan.sq_tiles))
    return list(dict.fromkeys(plans))


@functools.lru_cache(maxsize=1024)
def _device_plan(index: int, N: int, H: int, W: int, C: int,
                 OC: int) -> CbraPlan:
    """:func:`cbra_plan` on CUDA device ``index``, once per shape."""
    return cbra_plan(N, H, W, C, OC, sm_count(torch.device("cuda", index)))


def _weight_2d(w: torch.Tensor) -> torch.Tensor:
    """(1, 1, C, OC) conv weight -> its (C, OC) matrix."""
    if w.dim() == 4:
        if w.shape[:2] != (1, 1):
            raise ValueError("cbr_avgpool: a 4-d weight must be a 1x1 conv "
                             f"(1, 1, C, OC), got {tuple(w.shape)}")
        return w[0, 0]
    return w


def cbr_avgpool_plain(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor
                      ) -> torch.Tensor:
    """The unlinked form in fp32: einsum, bias, ReLU, then the 2x2 average
    over the materialized pre-pool map."""
    w = _weight_2d(w)
    N, H, W, _ = x.shape
    Ho, Wo = H // 2, W // 2
    y = torch.relu(torch.einsum("nhwc,co->nhwo", x.float(), w.float())
                   + b.float())
    y = y[:, :2 * Ho, :2 * Wo].reshape(N, Ho, 2, Wo, 2, -1)
    return (y.sum(dim=(2, 4)) * 0.25).to(x.dtype)


def _entry():
    fn = library("linked_cbr_pool").repro_cbr_avgpool
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 13 \
            + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def cbr_avgpool(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *,
                plan: CbraPlan | None = None) -> torch.Tensor:
    """x (N,H,W,C); w (C,OC) or (1,1,C,OC); b (OC,) -> (N,H//2,W//2,OC).
    On CUDA all three must be contiguous float32 on one device.  ``plan``
    overrides :func:`cbra_plan`'s choice (for tests and timing)."""
    refuse_grad("cbr_avgpool", x, w, b)
    if not x.is_cuda:
        return cbr_avgpool_plain(x, w, b)
    w = _weight_2d(w)
    tensors = (x, w, b)
    if any(not t.is_cuda for t in tensors) or \
            len({t.device for t in tensors}) != 1:
        raise ValueError("cbr_avgpool: x, w and b must lie on one CUDA "
                         "device")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError("cbr_avgpool: x, w and b must be float32, got "
                         f"{x.dtype}/{w.dtype}/{b.dtype}")
    if x.dim() != 4 or w.dim() != 2 or w.shape[0] != x.shape[3] \
            or b.shape != (w.shape[1],):
        raise ValueError("cbr_avgpool: want x (N,H,W,C), w (C,OC), b (OC,); "
                         f"got {tuple(x.shape)} {tuple(w.shape)} "
                         f"{tuple(b.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("cbr_avgpool: x (NHWC), w and b must be contiguous")
    N, H, W, C = x.shape
    OC = w.shape[1]
    out = torch.empty((N, H // 2, W // 2, OC), dtype=torch.float32,
                      device=x.device)
    if out.numel() == 0:
        return out
    if plan is None:
        plan = _device_plan(x.device.index, N, H, W, C, OC)
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, w, out))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _entry()(x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr(),
                   N, H, W, C, OC, plan.txn, plan.tyn, plan.kh, plan.tsq,
                   plan.cl, plan.sq_ctas, plan.stages,
                   int(cbra_vector_copies(C, OC, aligned)), stream)
    check_launch(err, "cbr_avgpool")
    count_launch("cbr_avgpool")
    return out
