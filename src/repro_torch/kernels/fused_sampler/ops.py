"""Fused sampler: support filter (one-sort or the ``fused_mask`` kernel)
plus the keyed draw.

Two filter backends behind :func:`fused_sample`:

* ``torch`` — the one-sort filter of the reference's ``jnp`` backend
  (:func:`_mask_one`): one descending sort gives the k-th threshold and
  the permutation that orders the masked probabilities for the nucleus
  cumsum.
* ``cuda`` — :func:`fused_mask`: for CUDA tensors the sort-free kernel in
  ``csrc/fused_sampler.cu`` (a cluster of CTAs per row, with the grid
  :func:`mask_plan` picks), for CPU tensors :func:`fused_mask_plain`, the
  reference kernel's 32-step key searches written in torch.

The kernel keeps the reference's top-k support exactly but departs from
it on the nucleus boundary: its masses are fp64 exps summed exactly in
units of 2^-43 (the reference and the plain version sum fp32 exps in
fp32) and it keeps every top-k survivor at p >= 1 (the reference's fp32
search cuts tail tokens whose mass vanishes in its sum).  Both
differences touch only the tokens that :func:`nucleus_boundary` marks.

The draw is shared (``serving.sampling.keyed_draw``) and stays outside
the kernel, so the backend never touches the PRNG contract.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Callable, NamedTuple

import torch

from ...serving.sampling import keyed_draw
from .. import (CTA_SMEM_MAX, CTA_SMEM_RESERVED, SM_SMEM, check_launch,
                count_launch, library, refuse_grad, sm_count)


def _monotone_key(x: torch.Tensor) -> torch.Tensor:
    """Order-preserving uint32 key of finite float32 values, as int64."""
    u = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >> 31 > 0, u ^ 0xFFFFFFFF, u | 0x80000000)


def fused_mask_plain(rows: torch.Tensor, temperature: torch.Tensor,
                     top_k: torch.Tensor, top_p: torch.Tensor
                     ) -> torch.Tensor:
    """rows (B,V) fp32; temperature/top_p (B,) fp32; top_k (B,) int.
    Survivors keep ``row / T`` (T <= 0 scales by 1), the rest are -inf.

    The reference kernel's algorithm, step for step.  top-k: the largest
    key t with count(key >= t) >= clip(k, 1, V), MSB first (k <= 0 keeps
    all; ties at the k-th key survive).  top-p: the largest key c with
    mass(key > c) >= max(p, 1e-6) over the top-k survivors, masses in
    fp32; survivors then need key > c."""
    B, V = rows.shape
    temperature = temperature.to(rows.device, torch.float32)
    top_k = top_k.to(rows.device, torch.int64)
    top_p = top_p.to(rows.device, torch.float32)
    safe_t = torch.where(temperature > 0, temperature, 1.0)
    x = rows / safe_t[:, None]
    key = _monotone_key(x)

    k_eff = top_k.clamp(1, V)
    res = torch.zeros((B,), dtype=torch.int64, device=rows.device)
    for i in range(32):
        cand = res | (1 << (31 - i))
        cnt = (key >= cand[:, None]).sum(dim=-1)
        res = torch.where(cnt >= k_eff, cand, res)
    keep_k = (top_k[:, None] <= 0) | (key >= res[:, None])

    xk = torch.where(keep_k, x, -torch.inf)
    m = xk.max(dim=-1, keepdim=True).values
    e = torch.where(keep_k, torch.exp(xk - m), 0.0)
    denom = e.sum(dim=-1)
    p_eff = top_p.clamp_min(1e-6)
    kk = torch.where(keep_k, key, 0)
    res = torch.zeros_like(res)
    for i in range(32):
        cand = res | (1 << (31 - i))
        mass = torch.where(kk > cand[:, None], e, 0.0).sum(dim=-1) / denom
        res = torch.where(mass >= p_eff, cand, res)
    return torch.where(keep_k & (key > res[:, None]), x, -torch.inf)


def nucleus_boundary(rows: torch.Tensor, temperature: torch.Tensor,
                     top_k: torch.Tensor, top_p: torch.Tensor,
                     tol: float = 1e-5) -> torch.Tensor:
    """(B, V) bool: the top-k survivors whose nucleus membership rounding
    decides.  A token survives top-p iff the mass strictly above it is
    < max(p, 1e-6); these are the tokens where that mass, summed exactly
    (fp64), lies within ``tol`` of the limit, so two summation orders (or
    fp32 and fp64) may decide them either way.  At p = 1 they are the
    tail whose mass the fp32 sum loses.  Every other token's membership
    is fixed: kernel, plain version and reference must agree on it."""
    B, V = rows.shape
    temperature = temperature.to(rows.device, torch.float32)
    safe_t = torch.where(temperature > 0, temperature, 1.0)
    x = rows.float() / safe_t[:, None]
    k = top_k.to(rows.device, torch.int64)
    sx, perm = torch.sort(x, dim=-1, descending=True)
    kth = sx.gather(1, (k.clamp(1, V) - 1)[:, None])
    keep_k = (k[:, None] <= 0) | (sx >= kth)
    e = torch.where(keep_k, torch.exp(sx.double() - sx[:, :1].double()), 0.0)
    cum = torch.cumsum(e / e.sum(dim=-1, keepdim=True), dim=-1)
    # mass strictly above = the cumsum just before the token's tie group
    first = torch.searchsorted(-sx, -sx, right=False)
    above = torch.where(first > 0, cum.gather(1, (first - 1).clamp_min(0)),
                        0.0)
    p_eff = top_p.to(rows.device, torch.float64).clamp_min(1e-6)[:, None]
    near = keep_k & ((above - p_eff).abs() <= tol)
    return torch.zeros_like(near).scatter(1, perm, near)


#: CTAs a row's cluster may hold (16 is a non-portable cluster size)
CL_CHOICES = (1, 2, 4, 8, 16)
#: the kernel's static shared memory beside its slice (``struct Shared``
#: in the .cu; ``repro_fused_mask_static_smem`` reports it on the card)
STATIC_SMEM = 17648
#: survivors the top-p list takes before the kernel's radix path (<= 512)
CAP = 256
#: CTAs of the kernel an SM holds by registers (``__launch_bounds__(512,
#: 2)``)
CTAS_PER_SM = 2
#: the planner's model, in slice elements, fitted to the served policy's
#: cluster sweep of ``launch/mask_cbra_timing.py`` on an H100 (clusters of
#: 4, 8 and 16 at B = 1, 8 and 64): a CTA's fixed chain (its rounds'
#: barriers and merges), what each rank of its cluster adds (every
#: round's merge reads every rank's bins), and how much longer a wave
#: takes when its clusters share SMs
FIXED, PER_RANK, SHARED = 18566, 620, 1.16


class MaskPlan(NamedTuple):
    """How one call runs: ``cl`` CTAs a row (one cluster a row, the grid
    B x cl), each holding ``chunk`` elements of its row (a multiple of 4)
    in shared memory; up to ``cap`` top-k survivors the nucleus is cut
    from a gathered list, past it by a radix select over the masses."""
    cl: int
    chunk: int
    cap: int


def mask_slice(V: int, chunk: int, rank: int) -> tuple[int, int]:
    """Elements ``[lo, hi)`` of a row that cluster rank ``rank`` holds:
    the kernel's own slice."""
    lo = min(V, rank * chunk)
    return lo, min(V, lo + chunk)


def mask_smem(chunk: int) -> int:
    """Shared memory of one CTA: its slice of keys and the static part."""
    return 4 * chunk + STATIC_SMEM


def mask_plan(B: int, V: int, sms: int,
              solo: Callable[[int], int] | None = None) -> MaskPlan | None:
    """Pick the cluster from the rows, the row length and the SM count,
    or None where even 16 CTAs cannot hold a row.

    ``solo(cl)``: clusters of cl CTAs the card holds at once with one CTA
    an SM (asked from the card; the GPCs' SMs go to whole clusters, so at
    cl = 16 the H100 holds 7, not 132 // 16); default ``sms // cl``.
    Model: a CTA takes chunk + FIXED + PER_RANK x cl; an SM holds per_sm
    CTAs (registers and shared memory), so a wave holds solo x per_sm
    clusters; a wave of more than solo clusters shares SMs and takes
    SHARED times as long.  Ties go to the smaller cluster."""
    best = None
    for cl in CL_CHOICES:
        chunk = -(-V // (4 * cl)) * 4
        smem = mask_smem(chunk)
        if smem > CTA_SMEM_MAX:
            continue
        alone = max(1, solo(cl) if solo is not None else sms // cl)
        wave = alone * min(CTAS_PER_SM,
                           SM_SMEM // (smem + CTA_SMEM_RESERVED))
        cost = -(-B // wave) * (SHARED if min(B, wave) > alone else 1.0) \
            * (chunk + FIXED + PER_RANK * cl)
        if best is None or cost < best[0]:
            best = (cost, MaskPlan(cl, chunk, CAP))
    return None if best is None else best[1]


_SOLO: dict[tuple[int, int], int] = {}


def solo_clusters(device: torch.device) -> Callable[[int], int]:
    """``solo(cl)`` for ``device``: clusters of cl CTAs of the kernel it
    holds at once with one CTA an SM, from the CUDA occupancy calculator
    (cached)."""
    def solo(cl: int) -> int:
        key = (device.index, cl)
        n = _SOLO.get(key)
        if n is None:
            with torch.cuda.device(device):
                n = _lib().repro_fused_mask_solo_clusters(cl)
            if n <= 0:
                raise RuntimeError(f"fused_mask: clusters of {cl} CTAs do "
                                   "not fit this device")
            _SOLO[key] = n
        return n
    return solo


@functools.lru_cache(maxsize=256)
def _device_plan(index: int, B: int, V: int) -> MaskPlan | None:
    """:func:`mask_plan` on CUDA device ``index``, once per shape."""
    device = torch.device("cuda", index)
    return mask_plan(B, V, sm_count(device), solo=solo_clusters(device))


def mask_vector_copies(rows: torch.Tensor) -> bool:
    """Whether the kernel may copy and store 16 bytes at a time: the rows'
    stride and length multiples of 4 floats, the rows 16-byte aligned."""
    return (rows.stride(0) % 4 == 0 and rows.shape[1] % 4 == 0
            and rows.data_ptr() % 16 == 0)


def _lib():
    lib = library("fused_sampler")
    if lib.repro_fused_mask.argtypes is None:
        lib.repro_fused_mask.argtypes = [ctypes.c_void_p, ctypes.c_int] + \
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        lib.repro_fused_mask.restype = ctypes.c_int
        lib.repro_fused_mask_static_smem.argtypes = []
        lib.repro_fused_mask_static_smem.restype = ctypes.c_int
        lib.repro_fused_mask_solo_clusters.argtypes = [ctypes.c_int]
        lib.repro_fused_mask_solo_clusters.restype = ctypes.c_int
    return lib


def fused_mask(rows: torch.Tensor, temperature: torch.Tensor,
               top_k: torch.Tensor, top_p: torch.Tensor, *,
               plan: MaskPlan | None = None) -> torch.Tensor:
    """The support filter: kernel for CUDA tensors, plain version for CPU
    tensors.  The two agree except on the :func:`nucleus_boundary`
    tokens (see the module docstring).  On CUDA: rows (B,V) fp32 with unit
    column stride (a row stride past V is allowed, e.g. a slice of padded
    logits); temperature/top_p (B,) fp32 and top_k (B,) int32,
    contiguous.  ``plan`` overrides :func:`mask_plan`'s choice (for tests
    and timing)."""
    refuse_grad("fused_mask", rows, temperature, top_p)
    if not rows.is_cuda:
        return fused_mask_plain(rows, temperature, top_k, top_p)
    if rows.dim() != 2 or rows.dtype != torch.float32 or rows.stride(1) != 1:
        raise ValueError("fused_mask: rows must be (B, V) float32 with unit "
                         f"column stride, got {tuple(rows.shape)} "
                         f"{rows.dtype} strides {rows.stride()}")
    B, V = rows.shape
    for name, t, dt in (("temperature", temperature, torch.float32),
                        ("top_k", top_k, torch.int32),
                        ("top_p", top_p, torch.float32)):
        if t.shape != (B,) or t.dtype != dt or t.device != rows.device \
                or not t.is_contiguous():
            raise ValueError(f"fused_mask: {name} must be a contiguous "
                             f"{dt} ({B},) on the rows' device, got "
                             f"{tuple(t.shape)} {t.dtype} {t.device}")
    out = torch.empty((B, V), dtype=torch.float32, device=rows.device)
    if out.numel() == 0:
        return out
    if plan is None:
        plan = _device_plan(rows.device.index, B, V)
    if plan is None:
        raise ValueError(f"fused_mask: a row of {V} does not fit the shared "
                         f"memory of {CL_CHOICES[-1]} CTAs")
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    err = _lib().repro_fused_mask(
        rows.data_ptr(), rows.stride(0), temperature.data_ptr(),
        top_k.data_ptr(), top_p.data_ptr(), out.data_ptr(), B, V, plan.cl,
        plan.chunk, plan.cap, int(mask_vector_copies(rows)), stream)
    check_launch(err, "fused_mask")
    count_launch("fused_mask")
    return out


def _mask_one(x: torch.Tensor, top_k: torch.Tensor, top_p: torch.Tensor
              ) -> torch.Tensor:
    """One-sort filter over scaled rows x (B, V) -> masked scaled logits."""
    V = x.shape[-1]
    sx, perm = torch.sort(x, dim=-1, descending=True)
    kth = sx.gather(1, (top_k - 1).clamp(0, V - 1)[:, None])
    x = torch.where((top_k[:, None] <= 0) | (x >= kth), x, -torch.inf)
    probs = torch.softmax(x, dim=-1)
    sp = probs.gather(1, perm)       # == sort(probs) descending
    keep = (torch.cumsum(sp, dim=-1) - sp) < top_p.clamp_min(1e-6)[:, None]
    thresh = torch.where(keep, sp, torch.inf).min(dim=-1, keepdim=True).values
    return torch.where(probs >= thresh, x, -torch.inf)


def _draw_one(rows, masked, seeds, steps, temperature) -> torch.Tensor:
    sampled = keyed_draw(masked, seeds, steps)
    return torch.where(temperature <= 0, torch.argmax(rows, dim=-1),
                       sampled).to(torch.int32)


def fused_sample(logits, seeds, steps, temperature, top_k, top_p, *,
                 vocab: int, backend: str = "torch") -> torch.Tensor:
    """Batched fused sampling: ``(B, V) -> (B,)`` int32 tokens, same
    signature and PRNG contract as ``serving.sampling.sample_tokens``.
    Policy tensors may come from the host; they move to the logits'
    device.  No host synchronization happens here."""
    dev = logits.device
    rows = logits[..., :vocab].float()
    temperature = temperature.to(dev, torch.float32)
    top_p = top_p.to(dev, torch.float32)
    top_k = top_k.to(dev, torch.int32)
    if backend == "cuda":
        masked = fused_mask(rows, temperature, top_k, top_p)
    elif backend == "torch":
        safe_t = torch.where(temperature > 0, temperature, 1.0)
        masked = _mask_one(rows / safe_t[:, None], top_k.long(), top_p)
    else:
        raise ValueError(f"unknown fused sampler backend {backend!r}")
    return _draw_one(rows, masked, seeds.to(dev), steps.to(dev), temperature)


def fused_sample_grid(logits, seeds, steps, temperature, top_k, top_p, *,
                      vocab: int, backend: str = "torch") -> torch.Tensor:
    """Speculative-verify sampling: ``(B, K1, V) -> (B, K1)`` tokens keyed
    ``(seeds[b], steps[b] + i)`` per position.  The per-row policy is
    repeated by ``expand`` (no host synchronization: a CUDA graph
    captures it)."""
    B, K1 = logits.shape[0], logits.shape[1]
    grid_steps = steps.to(torch.int64)[:, None] + torch.arange(
        K1, device=steps.device)[None, :]

    def rep(t):
        return t[:, None].expand(B, K1).reshape(-1)
    toks = fused_sample(
        logits.reshape(B * K1, logits.shape[2]),
        rep(seeds), grid_steps.reshape(-1), rep(temperature), rep(top_k),
        rep(top_p), vocab=vocab, backend=backend)
    return toks.reshape(B, K1)
