"""Parameter specs + basic layers in PyTorch.

The counterpart of ``repro.models.layers``: every parameter is declared
once as a :class:`ParamSpec` (shape, logical axes, init rule), and
:func:`init_params` draws the same distributions as the reference's
``_init_leaf`` — including its fan-in rule for stacked leaves — from an
explicit ``torch.Generator``.  The draws differ from JAX's (different
generators); tests carry weights across with ``repro_torch.convert``.

Layers take params already in the compute dtype: the reference casts
fp32 params to ``cfg.dtype`` at every use, the port casts once at load
(``Model.cast_params``) — the same numbers without a per-step cast.
"""
from __future__ import annotations

import dataclasses
import math
import sys
from typing import Any

import torch
import torch.nn.functional as F

LOGICAL_AXES = (
    "vocab", "embed", "heads", "kv_heads", "head_dim", "qkv", "mlp",
    "experts", "expert_mlp", "ssm_inner", "ssm_state", "ssm_heads", "conv",
    "layers", None,
)


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    axes: tuple[Any, ...]            # logical axis name per dim
    init: str = "normal"             # normal | zeros | ones | embed
    scale: float = 0.0               # 0 => fan-in default

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")
        for a in self.axes:
            if a not in LOGICAL_AXES:
                raise ValueError(f"unknown logical axis {a!r}")


def tree_map(fn, tree):
    """Map over the leaves of a nested dict."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(like, leaves):
    """The nested dict of ``like``'s structure holding ``leaves`` (in
    :func:`tree_leaves`' order)."""
    it = iter(leaves)

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(tree[k]) for k in sorted(tree)}
        return next(it)
    return build(like)


def init_leaf(spec: ParamSpec, generator: torch.Generator, device,
               dtype) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    # scaled in place (the values of ``x * scale``): one fp32 draw live
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=device)
    if spec.init == "embed":
        return x.mul_(0.02).to(dtype)
    fan_in = spec.shape[0] if len(spec.shape) > 1 else spec.shape[-1]
    if len(spec.shape) == 3:  # stacked experts / layers: fan-in is dim 1
        fan_in = spec.shape[1]
    scale = spec.scale or (1.0 / math.sqrt(max(fan_in, 1)))
    return x.mul_(scale).to(dtype)


def init_params(specs, generator: torch.Generator, device,
                dtype=torch.float32):
    """Draw every leaf of a spec tree (sorted-key order) on ``device``."""
    return tree_map(lambda s: init_leaf(s, generator, device, dtype), specs)


def stack_layer_specs(specs, n_layers: int):
    """Add a leading ('layers') axis to every leaf spec."""
    return tree_map(lambda s: ParamSpec((n_layers,) + s.shape,
                                        ("layers",) + s.axes, s.init,
                                        s.scale), specs)


def param_count(specs) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(specs))


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """fp32 variance, cast back to x's dtype, then scale."""
    dt = x.dtype
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * scale.to(dt)


def rms_norm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), ("embed",), init="ones")


def swiglu_specs(d: int, ff: int) -> dict[str, ParamSpec]:
    return {
        "gate": ParamSpec((d, ff), ("embed", "mlp")),
        "up": ParamSpec((d, ff), ("embed", "mlp")),
        "down": ParamSpec((ff, d), ("mlp", "embed")),
    }


def swiglu(p: dict[str, torch.Tensor], x: torch.Tensor,
           backend: str = "torch", shard_axis=None) -> torch.Tensor:
    """(silu(x@gate) * (x@up)) @ down: the transformer instance of the
    paper's Matmul->Matmul operator linking.  ``backend`` is the
    ``linked_matmul`` site of a ``KernelPlan``: ``"torch"`` runs the three
    matmuls, ``"cuda"`` the ``linked_mlp`` kernel, which keeps the hidden
    activation on chip (its plain version on CPU tensors).

    ``shard_axis`` (concat-TP serving, ``repro_torch.distributed.tp``):
    the mesh whose ranks hold column shards of gate/up; h is gathered to
    full width (a concatenation, no arithmetic) before the replicated
    ``down``.  The linked kernel would fuse ``down`` over this rank's
    columns of h alone, a partial sum, so this path takes the three
    matmuls (``kernel_select`` routes ``linked_matmul`` to ``torch`` on a
    mesh)."""
    if backend == "cuda":
        if shard_axis is not None:
            raise ValueError(
                "the linked_mlp kernel fuses down over a rank's columns of "
                "h (a partial sum); a concat-TP mesh needs linked_matmul "
                "'torch'")
        from ..kernels.linked_matmul import ops as linked_ops
        return linked_ops.linked_mlp(x, p["gate"].to(x.dtype),
                                     p["up"].to(x.dtype),
                                     p["down"].to(x.dtype))
    h = F.silu(x @ p["gate"].to(x.dtype)) * (x @ p["up"].to(x.dtype))
    if shard_axis is not None:
        h = shard_axis.gather(h, dim=h.dim() - 1)
    return h @ p["down"].to(x.dtype)


def gelu_mlp_specs(d: int, ff: int) -> dict[str, ParamSpec]:
    return {
        "up": ParamSpec((d, ff), ("embed", "mlp")),
        "up_b": ParamSpec((ff,), ("mlp",), init="zeros"),
        "down": ParamSpec((ff, d), ("mlp", "embed")),
        "down_b": ParamSpec((d,), ("embed",), init="zeros"),
    }


def gelu_mlp(p: dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """gelu(x@up + up_b) @ down + down_b: the encoder-decoder's MLP.  The
    tanh form of GELU, as ``jax.nn.gelu``'s default.  No kernel site: the
    linked kernel fuses SwiGLU only."""
    h = F.gelu(x @ p["up"].to(x.dtype) + p["up_b"].to(x.dtype),
               approximate="tanh")
    return h @ p["down"].to(x.dtype) + p["down_b"].to(x.dtype)


def embed_specs(vocab: int, d: int) -> dict[str, ParamSpec]:
    return {"tokens": ParamSpec((vocab, d), ("vocab", "embed"), init="embed")}


def embed_lookup(table: torch.Tensor, ids: torch.Tensor,
                 dtype) -> torch.Tensor:
    """``table[ids]`` in ``dtype``.  A DTensor table sharded over its
    rows (the vocabulary) on one mesh dim takes the vocabulary-parallel
    lookup (:func:`_vocab_parallel_lookup`); the one-device path is
    this line alone."""
    if _is_dtensor(table):
        out = _vocab_parallel_lookup(table, ids)
        if out is not None:
            return out.to(dtype)
    return table[ids.long()].to(dtype)


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: logits over the padded vocabulary."""
    return x @ table.to(x.dtype).T


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """Mean next-token CE in fp32 over the positions whose label is >= 0;
    the logits' padded vocabulary entries (past ``vocab``) are masked to
    -1e30.  DTensor logits take the vocabulary-parallel form
    (:func:`_vocab_parallel_ce`)."""
    if _is_dtensor(logits):
        return _vocab_parallel_ce(logits, labels, vocab)
    logits = logits.float()
    padded = logits.shape[-1]
    if padded > vocab:
        pad = torch.arange(padded, device=logits.device) >= vocab
        logits = logits.masked_fill(pad, -1e30)
    labels = labels.to(logits.device).long()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.clamp(min=0)[..., None])[..., 0]
    mask = (labels >= 0).float()
    return torch.sum((lse - gold) * mask) / torch.clamp(mask.sum(), min=1.0)


# ---------------------------------------------------------------------------
# The vocabulary-parallel forms (DTensor leaves on a mesh)
# ---------------------------------------------------------------------------
#
# A table or logits sharded over the vocabulary on a mesh dim: each rank
# works on its own columns and the ranks of that dim combine scalars a
# row (Megatron's vocabulary-parallel embedding and loss, GSPMD's
# partitioning of the gather and the reduction).  DTensor would gather
# the vocabulary whole for the lookup, and its strategies for the
# gather's and the lookup's accumulating backward differ between torch
# versions (or are missing); here the backward writes into the rank's
# own shard, with no collective and nothing asked of DTensor.

def _is_dtensor(t) -> bool:
    """Without importing DTensor's module on the served path: no tensor
    is a DTensor before that module is loaded."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(t, mod.DTensor)


def _group(mesh, md):
    """The process group of mesh dim ``md``; None for no dim or one of
    size 1 (nothing to reduce)."""
    return mesh.get_group(md) if md is not None and mesh.size(md) > 1 \
        else None


def _all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """``t`` reduced over ``group`` (a functional collective: the dry
    run's trace counts it), or ``t`` itself where there is no group."""
    if group is None:
        return t
    from torch.distributed import _functional_collectives as funcol
    return funcol.wait_tensor(funcol.all_reduce(t, op, group))


def _vocab_dim(t, dim: int):
    """(mesh dim, this rank's first index) of ``t``'s dim ``dim`` where
    exactly one mesh dim shards it (DTensor's chunks: ``ceil(n / m)``
    each), else (None, 0)."""
    from torch.distributed.tensor import Shard
    mesh = t.device_mesh
    mds = [md for md, p in enumerate(t.placements)
           if isinstance(p, Shard) and p.dim == dim]
    if len(mds) != 1:
        return None, 0
    md = mds[0]
    chunk = -(-t.shape[dim] // mesh.size(md))
    return md, mesh.get_local_rank(md) * chunk


class _LookupFn(torch.autograd.Function):
    """A rank's rows ``[lo, lo + rows)`` of a table: each id there looks
    up its row, others give zeros, summed over ``group``.  The backward
    accumulates into the rank's rows alone."""

    @staticmethod
    def forward(ctx, table, ids, lo: int, group):
        rows = table.shape[0]
        local = ids.long() - lo
        hit = (local >= 0) & (local < rows)
        idx = torch.where(hit, local, 0)
        out = torch.where(hit[..., None], table[idx], 0.0).to(table.dtype)
        ctx.save_for_backward(idx, hit)
        ctx.rows = rows
        return _all_reduce(out, "sum", group)

    @staticmethod
    def backward(ctx, grad):
        idx, hit = ctx.saved_tensors
        d = grad.shape[-1]
        g = torch.zeros((ctx.rows, d), dtype=grad.dtype, device=grad.device)
        # an id off the rank's rows adds zeros to row 0 (fixed shapes)
        g.index_add_(0, idx.reshape(-1),
                     torch.where(hit[..., None], grad, 0.0).reshape(-1, d))
        return g, None, None, None


def _vocab_parallel_lookup(table, ids):
    """``table[ids]`` for a DTensor table sharded on its rows over one mesh
    dim, the ids not split on that mesh dim: the rank's rows looked up
    locally, the partial results summed over the mesh dim (one all-reduce
    of the output).  A table also split on its columns (the embedding
    dim, on other mesh dims: FSDP) is gathered whole on them first, an
    all-gather whose backward reduce-scatters the gradient, so the
    output keeps the ids' placements (the rows where the batch split
    puts them); DTensor's own indexing keeps the columns split and the
    rows whole in one torch version and gathers the table in another.
    The table's gradient is the rank's rows' alone, a partial sum over
    the mesh dims that split the ids (the batch: the train step sums it
    over ``"data"``).  None where the table is placed otherwise
    (DTensor's own indexing then runs)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    md, lo = _vocab_dim(table, 0)
    if md is None or any(isinstance(p, Shard) and p.dim not in (0, 1)
                         or p.is_partial() for p in table.placements):
        return None
    if isinstance(ids, DTensor):
        if not ids.placements[md].is_replicate() or any(
                p.is_partial() for p in ids.placements):
            return None
        id_pls, ids_local = list(ids.placements), ids.to_local()
    else:
        id_pls, ids_local = [Replicate()] * mesh.ndim, ids
    whole = [Replicate() if p == Shard(1) else p for p in table.placements]
    if whole != list(table.placements):
        table = table.redistribute(mesh, whole)
    grad_pls = [Shard(0) if i == md else
                (Partial() if not id_pls[i].is_replicate() else p)
                for i, p in enumerate(table.placements)]
    out = _LookupFn.apply(table.to_local(grad_placements=grad_pls),
                          ids_local.to(table.device), lo, _group(mesh, md))
    shape = tuple(ids.shape) + (table.shape[1],)
    return DTensor.from_local(out, mesh, id_pls, run_check=False,
                              shape=torch.Size(shape),
                              stride=contiguous_stride(shape))


class _CrossEntropyFn(torch.autograd.Function):
    """Per-row CE in fp32 of a rank's vocabulary columns ``[lo, lo +
    V_l)`` of logits (..., V_l): the rows' maxima, sums of exponentials
    and gold logits (a masked local gather) reduced over ``group``;
    columns past ``vocab`` masked to -1e30.  The backward is local:
    softmax less the one-hot of the label, on the rank's columns, written
    over the saved exponentials (one backward a graph)."""

    @staticmethod
    def forward(ctx, logits, labels, lo: int, vocab: int, group):
        x = logits.float()
        if lo + x.shape[-1] > vocab:
            cols = lo + torch.arange(x.shape[-1], device=x.device)
            x = x.masked_fill(cols >= vocab, -1e30)
        mx = _all_reduce(x.amax(dim=-1), "max", group)
        e = torch.sub(x, mx[..., None]).exp_()
        se = _all_reduce(e.sum(dim=-1), "sum", group)
        local = labels.long().clamp(min=0) - lo
        hit = (local >= 0) & (local < x.shape[-1])
        idx = torch.where(hit, local, 0)
        gold = torch.where(hit, torch.gather(x, -1, idx[..., None])[..., 0],
                           0.0)
        gold = _all_reduce(gold, "sum", group)
        ctx.save_for_backward(e, se, idx, hit)
        ctx.dtype = logits.dtype
        return mx + torch.log(se) - gold

    @staticmethod
    def backward(ctx, grad):
        e, se, idx, hit = ctx.saved_tensors
        g = e.div_(se[..., None])
        g.scatter_add_(-1, idx[..., None], -hit.to(g.dtype)[..., None])
        return g.mul_(grad[..., None]).to(ctx.dtype), None, None, None, None


def _vocab_parallel_ce(logits, labels, vocab: int) -> torch.Tensor:
    """:func:`cross_entropy` of DTensor logits: a pending partial sum is
    summed first (and the vocabulary gathered but on one mesh dim); where
    a mesh dim splits the vocabulary (the last dim) each rank takes its
    columns (:class:`_CrossEntropyFn`), the rows staying where the
    logits' batch placement has them; each rank sums its rows' masked
    losses and counts, and the mean divides the two sums over the mesh
    dims that split the rows.  Returns a replicated scalar."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = logits.device_mesh
    last = logits.dim() - 1
    pls = [Replicate() if p.is_partial() else p for p in logits.placements]
    split = [md for md, p in enumerate(pls) if p == Shard(last)]
    for md in split[1:]:             # the vocabulary on one mesh dim
        pls[md] = Replicate()
    if pls != list(logits.placements):
        logits = logits.redistribute(mesh, pls)
    md, lo = _vocab_dim(logits, last)
    row_pls = [Replicate() if i == md else p for i, p in enumerate(pls)]
    rep = [Replicate()] * mesh.ndim
    if not isinstance(labels, DTensor):      # every row: keep the rank's
        labels = DTensor.from_local(labels.to(logits.device), mesh, rep,
                                    run_check=False)
    labels = labels.redistribute(mesh, row_pls).to_local()
    rows = _CrossEntropyFn.apply(
        logits.to_local(grad_placements=pls), labels, lo, vocab,
        _group(mesh, md))
    mask = (labels >= 0).float()
    part = [Replicate() if p.is_replicate() else Partial() for p in row_pls]
    total, count = (DTensor.from_local(t, mesh, part, run_check=False)
                    .redistribute(mesh, rep)
                    for t in ((rows * mask).sum(), mask.sum()))
    return total / torch.clamp(count, min=1.0)


def contiguous_stride(size) -> tuple:
    """The strides of a contiguous tensor of ``size``."""
    stride, acc = [], 1
    for n in reversed(list(size)):
        stride.append(acc)
        acc *= max(int(n), 1)
    return tuple(reversed(stride))
