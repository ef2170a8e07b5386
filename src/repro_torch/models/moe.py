"""Mixture-of-Experts FFN on one device, in PyTorch.

The counterpart of ``repro.models.moe``'s one-device path: a router in
fp32, the top-k experts of each token with softmax-renormalised weights,
a SwiGLU expert FFN, and the weighted sum of each token's k outputs.  The
reference's expert-parallel path (a ``shard_map`` whose partial outputs
combine with a ``psum``) is not ported: the port's concat tensor
parallelism moves concatenations only, and ``validate_serving_tp``
refuses MoE stacks.

Two forms of one function:

* :func:`_moe_local` is the reference's dispatch: the assignments sorted
  stably by expert, cut to the static capacity ``k_max`` (a trailing
  all-zero trash expert takes what the capacity drops), and the grouped
  FFN :func:`_ragged_ffn`, whose group sizes it reads on the host;
* :func:`moe_dense` runs every expert on every row and gathers each
  token's k outputs.  Its shapes
  are fixed, so a CUDA graph captures it, and a row's output does not
  depend on the other rows of the batch.

They compute the same function wherever the capacity drops nothing,
which at one device is whenever ``k_max >= T * k`` (the default
capacity factor 1.25 always); :func:`moe_block` then takes the fixed
form, else the capacity path (eager only).  The fixed form reads every
expert's weights and computes ``E / k`` times the FFN work that the
assignments need (ROADMAP queue 2).

Both combine deterministically: each token's k weighted outputs are
gathered into ``(T, k, d)`` and summed over k in top-k order, as
:func:`moe_reference` does (a scatter-add would take atomics on the card,
in an order that changes from run to run).  Top-k ties break toward the
lower expert index, as ``lax.top_k``'s do.  Keep TF32 off on the card
(torch's default): the router's fp32 matmul decides the routing.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import ParamSpec


def moe_specs(d: int, ff: int, n_experts: int) -> dict[str, ParamSpec]:
    return {
        "router": ParamSpec((d, n_experts), ("embed", "experts")),
        "gate": ParamSpec((n_experts, d, ff),
                          ("experts", "embed", "expert_mlp")),
        "up": ParamSpec((n_experts, d, ff),
                        ("experts", "embed", "expert_mlp")),
        "down": ParamSpec((n_experts, ff, d),
                          ("experts", "expert_mlp", "embed")),
    }


def stable_top_k(logits: torch.Tensor, k: int
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """``lax.top_k``: the k largest along the last axis, ties toward the
    lower index (a stable descending sort; ``torch.topk`` promises no
    order among ties)."""
    v, i = torch.sort(logits, dim=-1, descending=True, stable=True)
    return v[..., :k], i[..., :k]


def route(x: torch.Tensor, router: torch.Tensor, k: int):
    """fp32 router logits of x (T, d), each token's top-k experts (T, k)
    and their softmax-renormalised weights (T, k) fp32."""
    logits = x.float() @ router.float()
    top_v, top_i = stable_top_k(logits, k)
    return torch.softmax(top_v, dim=-1), top_i


def _ragged_ffn(xs: torch.Tensor, gate: torch.Tensor, up: torch.Tensor,
                down: torch.Tensor, gs: torch.Tensor) -> torch.Tensor:
    """Grouped SwiGLU over rows sorted by expert: rows ``[o_e, o_e +
    gs[e])`` go through expert e.  ``gs`` has one group more than there
    are experts, the all-zero trash expert, whose rows come out exactly
    zero (silu(0) * 0 @ 0).  Reads the group sizes on the host."""
    y = torch.zeros_like(xs)
    o = 0
    for e, n in enumerate(gs.tolist()[:gate.shape[0]]):
        if n:
            r = xs[o:o + n]
            h = F.silu(r @ gate[e].to(r.dtype)) * (r @ up[e].to(r.dtype))
            y[o:o + n] = h @ down[e].to(r.dtype)
        o += n
    return y


def _combine(y: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Each token's k outputs y (T, k, d) weighted by w (T, k) and summed
    over k in top-k order."""
    return (y * w[..., None].to(y.dtype)).sum(dim=1)


def _moe_local(x: torch.Tensor, router: torch.Tensor, gate: torch.Tensor,
               up: torch.Tensor, down: torch.Tensor, *, n_experts: int,
               top_k: int, e_local: int, lo: int, k_max: int
               ) -> torch.Tensor:
    """The reference's dispatch for the experts ``[lo, lo + e_local)``.
    x: (T, d) -> the partial output (T, d).  Assignments to other experts
    and those past the capacity ``k_max`` (of the stably sorted ones)
    contribute nothing."""
    T, d = x.shape
    w, top_i = route(x, router, top_k)
    local_e = top_i.reshape(-1) - lo
    is_local = (local_e >= 0) & (local_e < e_local)
    sort_key = torch.where(is_local, local_e, e_local)   # e_local = trash
    order = torch.sort(sort_key, stable=True).indices
    sel = order[:k_max]                                 # static capacity
    gs = torch.bincount(sort_key[sel], minlength=e_local + 1)
    y = _ragged_ffn(x[sel // top_k], gate, up, down, gs)
    placed = torch.zeros((T * top_k, d), dtype=y.dtype, device=x.device)
    placed[sel] = y                  # each kept assignment at (token, slot)
    return _combine(placed.reshape(T, top_k, d), w)


def moe_dense(p: dict[str, torch.Tensor], x: torch.Tensor, *, top_k: int
              ) -> torch.Tensor:
    """Every expert on every row, then each token's top-k outputs
    gathered and combined.  x: (T, d) -> (T, d).  Fixed shapes: no host
    read, so a CUDA graph captures it; a row's output depends on that row
    alone."""
    T, d = x.shape
    w, top_i = route(x, p["router"], top_k)
    E = p["gate"].shape[0]
    xe = x.expand(E, T, d)
    h = F.silu(torch.bmm(xe, p["gate"].to(x.dtype))) \
        * torch.bmm(xe, p["up"].to(x.dtype))               # (E, T, ff)
    y = torch.bmm(h, p["down"].to(x.dtype)).transpose(0, 1)  # (T, E, d)
    y = torch.gather(y, 1, top_i[..., None].expand(T, top_k, d))
    return _combine(y, w)


def load_balance_loss(x: torch.Tensor, router: torch.Tensor, *,
                      n_experts: int, top_k: int) -> torch.Tensor:
    """Switch-style auxiliary loss: n_e * sum_e f_e * p_e."""
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    _, top_i = stable_top_k(logits, top_k)
    assigned = F.one_hot(top_i, n_experts).float().sum(dim=-2)
    f = assigned.reshape(-1, n_experts).mean(dim=0) / top_k
    p = probs.reshape(-1, n_experts).mean(dim=0)
    return n_experts * torch.sum(f * p)


def moe_block(p: dict[str, torch.Tensor], x: torch.Tensor, *, cfg,
              aux: bool = False):
    """MoE FFN on one device.  x: (B, S, d) -> (out (B, S, d), the
    load-balance loss, or None unless ``aux``: the serving paths discard
    it).  The reference's capacity ``k_max = round8(ceil(cf * T * k))``:
    where it holds every assignment the fixed form :func:`moe_dense`
    runs, else the capacity path :func:`_moe_local`."""
    B, S, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    xf = x.reshape(B * S, d)
    loss = load_balance_loss(xf, p["router"], n_experts=E, top_k=k) \
        if aux else None
    t = B * S
    k_max = _round8(int(math.ceil(cfg.capacity_factor * t * k)))
    if k_max >= t * k:
        out = moe_dense(p, xf, top_k=k)
    else:
        out = _moe_local(xf, p["router"], p["gate"], p["up"], p["down"],
                         n_experts=E, top_k=k, e_local=E, lo=0, k_max=k_max)
    return out.reshape(B, S, d).to(x.dtype), loss


def moe_reference(p: dict[str, torch.Tensor], x: torch.Tensor, *,
                  cfg) -> torch.Tensor:
    """The reference's dense oracle: every expert on every token, the
    exact top-k combine (einsums, as the reference writes it)."""
    B, S, d = x.shape
    xf = x.reshape(-1, d)
    w, top_i = route(xf, p["router"], cfg.top_k)
    h = F.silu(torch.einsum("td,edf->etf", xf, p["gate"])) \
        * torch.einsum("td,edf->etf", xf, p["up"])
    y_all = torch.einsum("etf,efd->etd", h, p["down"])
    gathered = torch.gather(y_all.transpose(0, 1), 1,
                            top_i[..., None].expand(-1, -1, d))
    return _combine(gathered, w).reshape(B, S, d).to(x.dtype)


def _round8(n: int) -> int:
    return max(8, -(-n // 8) * 8)
