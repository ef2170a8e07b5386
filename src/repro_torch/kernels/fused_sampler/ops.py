"""Fused sampler: support filter (one-sort or the ``fused_mask`` kernel)
plus the keyed draw.

Two filter backends behind :func:`fused_sample`:

* ``torch`` — the one-sort filter of the reference's ``jnp`` backend
  (:func:`_mask_one`): one descending sort gives the k-th threshold and
  the permutation that orders the masked probabilities for the nucleus
  cumsum.
* ``cuda`` — :func:`fused_mask`: for CUDA tensors the sort-free kernel in
  ``csrc/fused_sampler.cu``, for CPU tensors :func:`fused_mask_plain`,
  the reference kernel's 32-step key searches written in torch.

The kernel keeps the reference's top-k support exactly but departs from
it on the nucleus boundary: it sums masses in fp64 (the reference and
the plain version in fp32) and keeps every top-k survivor at p >= 1
(the reference's fp32 search cuts tail tokens whose mass vanishes in
its sum).  Both differences touch only the tokens that
:func:`nucleus_boundary` marks.

The draw is shared (``serving.sampling.keyed_draw``) and stays outside
the kernel, so the backend never touches the PRNG contract.
"""
from __future__ import annotations

import ctypes

import torch

from ...serving.sampling import keyed_draw
from .. import check_launch, count_launch, library


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


def _entry():
    fn = library("fused_sampler").repro_fused_mask
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_int] + \
            [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return fn


def fused_mask(rows: torch.Tensor, temperature: torch.Tensor,
               top_k: torch.Tensor, top_p: torch.Tensor) -> torch.Tensor:
    """The support filter: kernel for CUDA tensors, plain version for CPU
    tensors.  The two agree except on the :func:`nucleus_boundary`
    tokens (see the module docstring).  On CUDA: rows (B,V) fp32 with unit
    column stride (a row
    stride past V is allowed, e.g. a slice of padded logits);
    temperature/top_p (B,) fp32 and top_k (B,) int32, contiguous."""
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
    stream = torch.cuda.current_stream(rows.device).cuda_stream
    err = _entry()(rows.data_ptr(), rows.stride(0), temperature.data_ptr(),
                   top_k.data_ptr(), top_p.data_ptr(), out.data_ptr(), B, V,
                   stream)
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
    ``(seeds[b], steps[b] + i)`` per position."""
    B, K1 = logits.shape[0], logits.shape[1]
    grid_steps = steps.to(torch.int64)[:, None] + torch.arange(
        K1, device=steps.device)[None, :]
    toks = fused_sample(
        logits.reshape(B * K1, logits.shape[2]),
        seeds.repeat_interleave(K1), grid_steps.reshape(-1),
        temperature.repeat_interleave(K1), top_k.repeat_interleave(K1),
        top_p.repeat_interleave(K1), vocab=vocab, backend=backend)
    return toks.reshape(B, K1)
