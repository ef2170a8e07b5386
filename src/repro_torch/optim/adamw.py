"""AdamW with selectable moment precision, in PyTorch.

The counterpart of ``repro.optim.adamw``.  ``moment_dtype``:

* float32 — standard;
* bfloat16 — halves the moments' memory;
* int8 — absmax-quantized moments, one fp32 scale per last-dim row
  (:class:`QuantMoment`); the second moment is stored as its square root
  with a half-quantum floor on reading, the 8-bit-Adam safeguard.

The state mirrors the params: ``m`` and ``v`` are nested dicts of the
params' names.  The arithmetic is the reference's, in fp32, leaf by leaf
and in its order, so both packages take the same step from the same
state.  :func:`adamw_update` runs under ``torch.no_grad()`` and writes
params and moments **in place** (a full-width model's state is tens of
GB: a second copy of it would not fit beside the first); the returned
state holds the same tensors.

Plain torch: one step is ~20 elementwise ops a leaf.  A fused kernel is
later performance work; ``torch.optim.AdamW`` has neither the int8 /
bf16 moments nor this clip.
"""
from __future__ import annotations

import dataclasses
from typing import Any, NamedTuple

import torch

from ..models.layers import _is_dtensor, tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    moment_dtype: str = "float32"   # float32 | bfloat16 | int8


@dataclasses.dataclass
class QuantMoment:
    """int8 moment with the same shape as its parameter: ``q`` int8 of
    ``shape``, ``scale`` the fp32 absmax of each last-dim row, of shape
    ``shape[:-1] + (1,)`` (a scalar parameter quantizes as ``x[None]``:
    scale (1,))."""
    q: torch.Tensor
    scale: torch.Tensor
    shape: tuple


def _quantize(x: torch.Tensor, sqrt_code: bool = False) -> QuantMoment:
    """Last-dim absmax int8, shape-preserving.  ``sqrt_code``: store
    sqrt(x) (the non-negative second moment), whose range is the square
    root of x's."""
    shape = tuple(x.shape)
    if sqrt_code:
        x = torch.sqrt(torch.clamp(x, min=0.0))
    if x.dim() == 0:
        x = x[None]
    scale = x.abs().amax(dim=-1, keepdim=True) + 1e-12
    q = torch.clamp(torch.round(x / scale * 127.0), -127, 127).to(torch.int8)
    return QuantMoment(q=q.reshape(shape), scale=scale.to(torch.float32),
                       shape=shape)


def _dequantize(m: QuantMoment, sqrt_code: bool = False) -> torch.Tensor:
    q = m.q.to(torch.float32)
    if q.dim() == 0:
        q = q[None]
    if sqrt_code:
        q = torch.clamp(q, min=0.5)  # half-quantum floor: sqrt(v) never 0
    out = (q / 127.0 * m.scale).reshape(m.shape)
    return out.square() if sqrt_code else out


_FLOAT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _check_dtype(dtype: str) -> None:
    if dtype != "int8" and dtype not in _FLOAT:
        raise ValueError(f"moment_dtype {dtype!r}: want float32, bfloat16 "
                         "or int8")


def _zeros_moment(p: torch.Tensor, dtype: str, sqrt_code: bool = False):
    if dtype == "int8":
        return _quantize(torch.zeros(p.shape, dtype=torch.float32,
                                     device=p.device), sqrt_code)
    return torch.zeros(p.shape, dtype=_FLOAT[dtype], device=p.device)


def _read_moment(m, dtype: str, sqrt_code: bool = False) -> torch.Tensor:
    if dtype == "int8":
        return _dequantize(m, sqrt_code)
    return m.to(torch.float32)


def _write_moment(dst, x: torch.Tensor, dtype: str,
                  sqrt_code: bool = False) -> None:
    """Store the fp32 moment ``x`` into ``dst`` in place."""
    if dtype == "int8":
        new = _quantize(x, sqrt_code)
        dst.q.copy_(new.q)
        dst.scale.copy_(new.scale)
    else:
        dst.copy_(x)


class AdamWState(NamedTuple):
    step: torch.Tensor   # int32, 0-dim
    m: Any
    v: Any


def adamw_init(params, cfg: AdamWConfig) -> AdamWState:
    """Zero moments of ``cfg.moment_dtype`` beside each param, step 0 (on
    the params' device).  DTensor params (a mesh's) get DTensor moments
    placed by ``state_sharding.opt_partition_specs``."""
    _check_dtype(cfg.moment_dtype)
    first = tree_leaves(params)[0]
    if _is_dtensor(first):
        return _placed_init(params, cfg)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=first.device),
        m=tree_map(lambda p: _zeros_moment(p, cfg.moment_dtype), params),
        v=tree_map(lambda p: _zeros_moment(p, cfg.moment_dtype, True),
                   params))


def _placed_init(params, cfg: AdamWConfig) -> AdamWState:
    """:func:`adamw_init` of DTensor params: the moments' specs from each
    param's placements (``opt_partition_specs``: a float moment mirrors
    its param, an int8 one's ``q`` too and its per-row ``scale`` drops
    the last dim's split), each rank allocating its shards at the zero
    moment's value (``scale`` is then 1e-12, :func:`_quantize`'s floor)."""
    from ..distributed import sharding as SH
    from ..distributed import state_sharding as SS

    first = tree_leaves(params)[0]
    mesh, device = first.device_mesh, first.to_local().device
    pspecs = tree_map(lambda p: SH.placements_to_spec(p.placements, p.dim(),
                                                      mesh), params)
    meta = tree_map(lambda p: torch.empty(p.shape, dtype=p.dtype,
                                          device="meta"), params)
    dt = cfg.moment_dtype
    abstract = AdamWState(step=None,
                          m=tree_map(lambda p: _zeros_moment(p, dt), meta),
                          v=tree_map(lambda p: _zeros_moment(p, dt, True),
                                     meta))
    specs = SS.opt_partition_specs(abstract, pspecs, SH.mesh_shape(mesh))

    def zeros(tree, spec):
        if isinstance(tree, dict):
            return {k: zeros(v, spec[k]) for k, v in tree.items()}
        if isinstance(tree, QuantMoment):
            return QuantMoment(
                q=SS.place(tree.q, spec.q, mesh, 0, device),
                scale=SS.place(tree.scale, spec.scale, mesh, 1e-12, device),
                shape=tree.shape)
        return SS.place(tree, spec, mesh, 0, device)
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=device),
        m=zeros(abstract.m, specs.m), v=zeros(abstract.v, specs.v))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the summed squares of every leaf, in fp32, the leaves in
    sorted-key order (``jax.tree.leaves``' order).  DTensor leaves: see
    :func:`_sharded_norm`."""
    leaves = tree_leaves(tree)
    if leaves and _is_dtensor(leaves[0]):
        return _sharded_norm(leaves)
    total = 0
    for leaf in leaves:
        total = total + leaf.to(torch.float32).square().sum()
    return torch.sqrt(total)


def _sharded_norm(leaves: list) -> torch.Tensor:
    """:func:`global_norm` of DTensor leaves, a plain 0-dim tensor with
    the same bits on every rank: each rank sums the squares of the local
    shards it owns (those of a leaf replicated on a mesh dim count at
    coordinate 0 of that dim alone) into its row of a (ranks, leaves)
    table of zeros, one all-reduce over the whole mesh fills the table
    (each element one rank's sum plus zeros: exact, whatever the
    reduction's order), and every rank adds it up in one order (ranks,
    then leaves).  Summing a replicated scalar with an all-reduce a mesh
    dim at a time could leave the ranks' bits apart."""
    import torch.distributed as dist
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Replicate

    mesh = leaves[0].device_mesh
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"a mesh of {mesh.size()} ranks in a world of "
                         f"{dist.get_world_size()}: the norm reduces over "
                         "the world")
    coord = mesh.get_coordinate()
    sums = []
    for t in leaves:
        if any(p.is_partial() for p in t.placements):
            t = t.redistribute(mesh, [Replicate() if p.is_partial() else p
                                      for p in t.placements])
        s = t.to_local().to(torch.float32).square().sum()
        own = all(c == 0 for c, p in zip(coord, t.placements)
                  if p.is_replicate())
        sums.append(s if own else torch.zeros_like(s))
    table = torch.zeros((mesh.size(), len(sums)), dtype=torch.float32,
                        device=sums[0].device)
    table[dist.get_rank()] = torch.stack(sums)
    if mesh.size() > 1:
        table = funcol.wait_tensor(funcol.all_reduce(table, "sum",
                                                     dist.group.WORLD))
    total = 0
    for row in table:
        for s in row:
            total = total + s
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(params, grads, state: AdamWState, cfg: AdamWConfig,
                 lr=None):
    """One AdamW step, in place -> (params, state, metrics).

    ``grads`` mirrors ``params``; ``lr``: a float or a 0-dim tensor
    (default ``cfg.lr``).  The clip scales every gradient by
    ``min(1, grad_clip / (gnorm + 1e-9))`` (not at all when ``grad_clip``
    is 0), the bias corrections are ``1 - b ** step`` in fp32 and weight
    decay applies to every leaf, as in the reference.  Metrics:
    ``grad_norm`` (before the clip) and the new ``step``."""
    lr = cfg.lr if lr is None else lr
    step = state.step + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0) \
        if cfg.grad_clip else 1.0
    step_f = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(cfg.b1, dtype=torch.float32,
                                       device=step.device), step_f)
    bc2 = 1.0 - torch.pow(torch.tensor(cfg.b2, dtype=torch.float32,
                                       device=step.device), step_f)
    dt = cfg.moment_dtype
    # a QuantMoment is one leaf of its tree
    flat = zip(tree_leaves(params), tree_leaves(grads),
               tree_leaves(state.m), tree_leaves(state.v))
    for p, g, m, v in flat:
        g = g.to(torch.float32) * clip
        m_f = cfg.b1 * _read_moment(m, dt) + (1 - cfg.b1) * g
        v_f = cfg.b2 * _read_moment(v, dt, True) + (1 - cfg.b2) * g.square()
        upd = (m_f / bc1) / (torch.sqrt(v_f / bc2) + cfg.eps)
        pf = p.to(torch.float32)
        p.copy_(pf - lr * (upd + cfg.weight_decay * pf))
        _write_moment(m, m_f, dt)
        _write_moment(v, v_f, dt, True)
    return params, AdamWState(step=step, m=state.m, v=state.v), \
        {"grad_norm": gnorm, "step": step}

