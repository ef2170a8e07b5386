"""Mamba2 (SSD, state-space duality) block [arXiv:2405.21060], in PyTorch.

The counterpart of ``repro.models.ssm``: the chunked SSD algorithm for
prefill (an intra-chunk quadratic form and an inter-chunk linear state
recurrence), the masked chunk update of chunked serving prefill, and the
O(1) recurrent step of decode.  The reference computes the scan in plain
XLA (its ``ssm_scan`` site is ``xla`` only); the port keeps it plain
torch behind ``KernelPlan.ssm_scan == "torch"``.

Differences of idiom, not of result:

* the inter-chunk ``lax.scan`` is a Python loop over chunks, and each
  chunk's quadratic form is computed inside it, so a serving chunk of
  ``ssm_chunk`` tokens (:func:`mamba2_chunk_update`) runs exactly the
  operations of one chunk of the one-shot scan (:func:`mamba2_block`):
  chunked ≡ one-shot bit for bit;
* the three-operand einsums are written as two-operand products in a
  fixed order (``torch.einsum`` may pick its contraction path by shape);
* the depthwise causal conv is an explicit K-tap sum, the same on both
  paths, so a zeroed shift register is the one-shot left zero-pad bit
  for bit;
* caches update **in place**: the chunk update writes back only rows
  with ``n_new > 0`` (the reference's explicit write-back) and decode
  only ``live`` rows (the port's decode writes only live rows);
* ``softplus`` is ``logaddexp(x, 0)``, ``jax.nn.softplus``'s formula
  (``F.softplus`` switches to the identity above a threshold).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from .layers import ParamSpec, rms_norm


def mamba2_specs(cfg) -> dict[str, ParamSpec]:
    d, di = cfg.d_model, cfg.ssm_inner
    g, n, nh = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * g * n
    return {
        "w_zx": ParamSpec((d, 2 * di), ("embed", "ssm_inner")),
        "w_bc": ParamSpec((d, 2 * g * n), ("embed", None)),
        "w_dt": ParamSpec((d, nh), ("embed", "ssm_heads")),
        "conv_w": ParamSpec((cfg.ssm_conv, conv_dim), (None, "ssm_inner")),
        "conv_b": ParamSpec((conv_dim,), ("ssm_inner",), init="zeros"),
        "A_log": ParamSpec((nh,), ("ssm_heads",), init="zeros"),
        "D": ParamSpec((nh,), ("ssm_heads",), init="ones"),
        "dt_bias": ParamSpec((nh,), ("ssm_heads",), init="zeros"),
        "norm": ParamSpec((di,), ("ssm_inner",), init="ones"),
        "out": ParamSpec((di, d), ("ssm_inner", "embed")),
    }


class SSMCache(NamedTuple):
    state: torch.Tensor    # (B, nh, P, N) fp32 recurrent state
    conv: torch.Tensor     # (B, K - 1, conv_dim) shift register


def init_ssm_cache(batch: int, cfg, dtype=torch.float32,
                   device="cuda") -> SSMCache:
    conv_dim = cfg.ssm_inner + 2 * cfg.ssm_groups * cfg.ssm_state
    return SSMCache(
        state=torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                           cfg.ssm_state), dtype=torch.float32,
                          device=device),
        conv=torch.zeros((batch, cfg.ssm_conv - 1, conv_dim), dtype=dtype,
                         device=device))


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: ``logaddexp(x, 0)``."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype,
                                          device=x.device))


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """a: (..., L) -> (..., L, L) with out[i, j] = sum_{j < t <= i} a[t],
    -inf above the diagonal (the 1-semiseparable decay log-matrix)."""
    L = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((L, L), dtype=torch.bool, device=a.device).tril()
    return diff.masked_fill(~mask, float("-inf"))


def _conv_taps(full: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise VALID conv along the sequence as a K-tap sum, accumulated
    in fp32 and returned in ``full``'s dtype.  full: (B, T + K - 1, C),
    w: (K, C) -> (B, T, C)."""
    K = w.shape[0]
    T = full.shape[1] - K + 1
    f, wf = full.float(), w.float()
    out = f[:, 0:T] * wf[0]
    for k in range(1, K):
        out = out + f[:, k:k + T] * wf[k]
    return out.to(full.dtype)


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv along the sequence.  x: (B, S, C), w: (K, C)."""
    pad = F.pad(x, (0, 0, w.shape[0] - 1, 0))
    return _conv_taps(pad, w) + b


def _ssd_chunk(x, dt, B, C, A, h0):
    """One SSD chunk.  x: (b, l, h, p); dt: (b, l, h); B, C: (b, l, h, n)
    (groups repeated to heads), all fp32; A: (h,); h0: (b, h, p, n), the
    state before the chunk.  Returns (y (b, l, h, p), state after)."""
    xdt = x * dt[..., None]                            # dt folded into x
    dA = dt * A                                        # (b, l, h) log-decays
    dA_cum = torch.cumsum(dA, dim=1)
    # 1. intra-chunk: the dual quadratic form
    L = torch.exp(_segsum(dA.transpose(1, 2)))         # (b, h, l, l)
    Ch = C.transpose(1, 2)                             # (b, h, l, n)
    Bh = B.transpose(1, 2)
    scores = Ch @ Bh.transpose(-1, -2)                 # (b, h, l, s)
    y_diag = ((scores * L) @ xdt.transpose(1, 2)).transpose(1, 2)
    # 2. the chunk's own contribution to the final state
    decay_states = torch.exp(dA_cum[:, -1:, :] - dA_cum)          # (b, l, h)
    states = (xdt * decay_states[..., None]).permute(0, 2, 3, 1) @ Bh
    # 3. the inter-chunk recurrence
    state = h0 * torch.exp(dA_cum[:, -1, :])[..., None, None] + states
    # 4. the state seen by each position
    y_off = (Ch @ h0.transpose(-1, -2)).transpose(1, 2) \
        * torch.exp(dA_cum)[..., None]
    return y_diag + y_off, state


def ssd_chunked(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, chunk: int,
                initial_state: torch.Tensor | None = None,
                ) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked SSD scan.

    x: (b, s, h, p); dt: (b, s, h) (post-softplus); A: (h,) negative;
    B, C: (b, s, g, n) with g dividing h.  Returns (y (b, s, h, p) in x's
    dtype, final_state (b, h, p, n) fp32)."""
    b, s, h, p_ = x.shape
    g, n = B.shape[2], B.shape[3]
    if s % chunk:
        raise ValueError(f"sequence {s} is not a multiple of chunk {chunk}")
    rep = h // g
    xf = x.float()
    dtf = dt.float()
    Bf = B.float().repeat_interleave(rep, dim=2)
    Cf = C.float().repeat_interleave(rep, dim=2)
    Af = A.float()
    state = initial_state.float() if initial_state is not None \
        else torch.zeros((b, h, p_, n), dtype=torch.float32, device=x.device)
    ys = []
    for c0 in range(0, s, chunk):
        sl = slice(c0, c0 + chunk)
        y, state = _ssd_chunk(xf[:, sl], dtf[:, sl], Bf[:, sl], Cf[:, sl],
                              Af, state)
        ys.append(y)
    y = ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)
    return y.to(x.dtype), state


def _mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (..., k) @ w (k, n) as one 2-D GEMM over the flattened rows: a
    row's bits then do not depend on how the rows are batched (a 3-D
    matmul of batch 1 takes another path than the folded 2-D one)."""
    return (x.reshape(-1, x.shape[-1]) @ w.to(x.dtype)).reshape(
        *x.shape[:-1], w.shape[-1])


def _in_proj(p, x, cfg):
    """z, the conv input (xs ‖ bc) and dt's pre-activation of x (..., d)."""
    di = cfg.ssm_inner
    zx = _mm(x, p["w_zx"])
    bc = _mm(x, p["w_bc"])
    dt = _mm(x, p["w_dt"])
    return zx[..., :di], torch.cat([zx[..., di:], bc], dim=-1), dt


def _split_conv(conv, cfg, shape):
    """The conv output (..., conv_dim) -> xs (*shape, nh, P), B, C
    (*shape, g, n)."""
    di, g, n = cfg.ssm_inner, cfg.ssm_groups, cfg.ssm_state
    xs, bc = conv[..., :di], conv[..., di:]
    return (xs.reshape(*shape, cfg.ssm_heads, cfg.ssm_head_dim),
            bc[..., :g * n].reshape(*shape, g, n),
            bc[..., g * n:].reshape(*shape, g, n))


def _dt_and_A(p, dt):
    dt = softplus(dt.float() + p["dt_bias"].float())
    return dt, -torch.exp(p["A_log"].float())


def _out(p, y, z, cfg):
    """Gate, norm and out-project the SSM output y (..., di)."""
    return _mm(rms_norm(y * F.silu(z), p["norm"]), p["out"])


def mamba2_block(p: dict[str, torch.Tensor], x: torch.Tensor, *, cfg,
                 initial_state: torch.Tensor | None = None,
                 return_state: bool = False):
    """Full Mamba2 mixer over a sequence.  x: (B, S, d)."""
    Bsz, S, _ = x.shape
    z, conv_in, dt = _in_proj(p, x, cfg)
    conv = F.silu(_causal_conv(conv_in, p["conv_w"].to(x.dtype),
                               p["conv_b"].to(x.dtype)))
    xh, B_, C_ = _split_conv(conv, cfg, (Bsz, S))
    dt, A = _dt_and_A(p, dt)
    # pad the sequence to a chunk multiple; padded steps get dt = 0, so
    # they are identity transitions (decay exp(0) = 1, zero input)
    pad = (-S) % cfg.ssm_chunk
    if pad:
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_ = F.pad(B_, (0, 0, 0, 0, 0, pad))
        C_ = F.pad(C_, (0, 0, 0, 0, 0, pad))
    y, state = ssd_chunked(xh, dt, A, B_, C_, cfg.ssm_chunk, initial_state)
    if pad:
        y = y[:, :S]
        xh = xh[:, :S]
    y = y + xh * p["D"].to(y.dtype)[None, None, :, None]
    out = _out(p, y.reshape(Bsz, S, cfg.ssm_inner), z, cfg)
    if return_state:
        return out, state
    return out


def conv_tail(p: dict[str, torch.Tensor], x: torch.Tensor,
              cfg) -> torch.Tensor:
    """The conv register after a prefill of x (B, S, d): its last K - 1
    conv inputs; a prompt shorter than the register keeps the leading
    zeros the causal conv left-pads with."""
    _, conv_in, _ = _in_proj(p, x, cfg)
    k1 = cfg.ssm_conv - 1
    if conv_in.shape[1] < k1:
        conv_in = F.pad(conv_in, (0, 0, k1 - conv_in.shape[1], 0))
    return conv_in[:, -k1:, :]


def _check_backend(backend: str) -> None:
    if backend != "torch":
        raise ValueError(f"unknown ssm_scan backend {backend!r}")


def mamba2_chunk_update(p: dict[str, torch.Tensor], x: torch.Tensor,
                        cache: SSMCache, *, cfg, n_new: torch.Tensor,
                        backend: str = "torch",
                        ) -> tuple[torch.Tensor, SSMCache]:
    """Masked SSD scan over one serving chunk with per-row stop lengths,
    in place.

    ``x`` is a fixed-width ``(B, C, d)`` chunk buffer; row ``b`` carries
    ``n_new[b]`` valid new tokens (0 for bystander rows).  Positions past
    ``n_new`` are identity transitions (``dt = 0``, x/B/C zeroed), the
    padding :func:`mamba2_block` appends, so the state after this call is
    the state after the row's valid prefix alone.  The conv runs over
    ``cat(cache.conv, conv_in)`` with the K-tap sum of
    :func:`_causal_conv` (a zeroed register on the first chunk *is* its
    left zero-pad), and the register advances by each row's ``n_new``.
    Only rows with ``n_new > 0`` write state and register back; the
    others keep theirs bit for bit.  With a chunk of ``cfg.ssm_chunk``
    tokens this is one chunk of the one-shot scan, bit for bit."""
    _check_backend(backend)
    Bsz, C, _ = x.shape
    K = cfg.ssm_conv
    z, conv_in, dt = _in_proj(p, x, cfg)
    full = torch.cat([cache.conv.to(x.dtype), conv_in], dim=1)
    conv = F.silu(_conv_taps(full, p["conv_w"].to(x.dtype))
                  + p["conv_b"].to(x.dtype))
    # the K-1 conv inputs ending at each row's last valid token: full[n_new
    # + t] is conv_in[n_new - K + 1 + t], or the cached register where that
    # falls before the chunk (an n_new = 0 row reads its register back)
    tail = n_new.long()[:, None] + torch.arange(K - 1, device=x.device)
    new_conv = torch.gather(
        full, 1, tail[..., None].expand(Bsz, K - 1, full.shape[2]))
    xh, B_, C_ = _split_conv(conv, cfg, (Bsz, C))
    dt, A = _dt_and_A(p, dt)
    valid = torch.arange(C, device=x.device)[None, :] < n_new[:, None]
    dt = torch.where(valid[..., None], dt, 0.0)
    xh = torch.where(valid[..., None, None], xh, 0.0)
    B_ = torch.where(valid[..., None, None], B_, 0.0)
    C_ = torch.where(valid[..., None, None], C_, 0.0)
    y, state = ssd_chunked(xh, dt, A, B_, C_, C, cache.state)
    y = y + xh.to(y.dtype) * p["D"].to(y.dtype)[None, None, :, None]
    out = _out(p, y.reshape(Bsz, C, cfg.ssm_inner), z, cfg)
    row = n_new > 0
    cache.state.copy_(torch.where(row[:, None, None, None], state,
                                  cache.state))
    cache.conv.copy_(torch.where(row[:, None, None],
                                 new_conv.to(cache.conv.dtype), cache.conv))
    return out, cache


def mamba2_decode(p: dict[str, torch.Tensor], x: torch.Tensor,
                  cache: SSMCache, *, cfg, backend: str = "torch",
                  live: torch.Tensor | None = None,
                  ) -> tuple[torch.Tensor, SSMCache]:
    """One-token recurrent step, in place.  x: (B, 1, d).  ``live``
    ((B,) bool) rows write their new state and register; the others keep
    theirs bit for bit (their output is to be discarded)."""
    _check_backend(backend)
    Bsz = x.shape[0]
    nh, rep = cfg.ssm_heads, cfg.ssm_heads // cfg.ssm_groups
    z, conv_in, dt = _in_proj(p, x[:, 0], cfg)
    # the shift-register causal conv
    window = torch.cat([cache.conv.to(x.dtype), conv_in[:, None, :]], dim=1)
    conv = F.silu(_conv_taps(window, p["conv_w"].to(x.dtype))[:, 0]
                  + p["conv_b"].to(x.dtype))
    xs, B_, C_ = _split_conv(conv, cfg, (Bsz,))
    B_ = B_.repeat_interleave(rep, dim=1).float()             # (B, nh, n)
    C_ = C_.repeat_interleave(rep, dim=1).float()
    dt, A = _dt_and_A(p, dt)
    dA = torch.exp(dt * A)                                     # (B, nh)
    xh = xs.float()                                            # (B, nh, P)
    # h <- h * dA + (dt * x) outer B
    upd = (dt[..., None] * xh)[..., None] * B_[:, :, None, :]
    state = cache.state * dA[..., None, None] + upd
    y = (state @ C_[..., None])[..., 0]                        # (B, nh, P)
    y = y + xh * p["D"].float()[None, :, None]
    y = y.reshape(Bsz, cfg.ssm_inner).to(x.dtype)
    out = _out(p, y, z, cfg)[:, None]
    if live is None:
        live = torch.ones((Bsz,), dtype=torch.bool, device=x.device)
    cache.state.copy_(torch.where(live[:, None, None, None], state,
                                  cache.state))
    cache.conv.copy_(torch.where(live[:, None, None],
                                 window[:, 1:].to(cache.conv.dtype),
                                 cache.conv))
    return out, cache
