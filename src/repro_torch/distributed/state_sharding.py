"""Sharding trees for non-parameter state: KV caches, SSM caches, optimizer.

The counterpart of ``repro.distributed.state_sharding``, over the port's
state: ``models.transformer.LayerCache`` (``kv`` / ``ssm`` /
``cross_k`` / ``cross_v``), ``models.attention.KVCache`` (``k`` / ``v``
/ ``positions`` / ``length``), ``models.ssm.SSMCache`` (``state`` /
``conv``) and ``optim.adamw.AdamWState`` with fp32 / bf16 tensors or
int8 ``QuantMoment`` moments.

Cache sharding follows the DOS ladder (§4.2.1) applied to serving:
  * outC  -> kv heads / ssm heads over "model";
  * inH   -> the batch over ("pod","data") when divisible;
  * inW   -> otherwise the *cache sequence* dim over "data" (context
    parallelism — this is what makes long_500k's batch=1 shardable).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..optim.adamw import AdamWState, QuantMoment
from .sharding import PartitionSpec as P
from .sharding import batch_axes_for, mesh_shape, to_placements


def enforce_divisible(spec: P, shape: tuple, mesh) -> P:
    """Drop/relocate mesh axes that do not evenly divide their dim (the DOS
    fallback ladder applied to runtime state: shards must be even).  A
    displaced axis moves to the next unsharded dim that divides (e.g.
    hymba's 5 kv heads push 'model' onto head_dim)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))

    def size_of(entry) -> int:
        names = entry if isinstance(entry, tuple) else (entry,)
        n = 1
        for nm in names:
            n *= mesh.shape[nm]
        return n

    displaced = []
    for i, entry in enumerate(parts):
        if entry is None:
            continue
        if shape[i] % size_of(entry) != 0:
            displaced.append(entry)
            parts[i] = None
    for entry in displaced:
        for i in range(len(parts) - 1, 0, -1):   # prefer trailing (feature) dims
            if parts[i] is None and shape[i] % size_of(entry) == 0 \
                    and shape[i] > 1:
                parts[i] = entry
                break
    return P(*parts)


def _map_named(fn, tree, name=None):
    """``fn(name, leaf)`` over the tensor leaves of a cache tree (nested
    tuples / NamedTuples), ``name`` the innermost field name above the
    leaf; ``()`` placeholders stay; a PartitionSpec is a leaf."""
    if isinstance(tree, tuple) and not isinstance(tree, P):
        fields = getattr(tree, "_fields", None)
        kids = [_map_named(fn, v, fields[i] if fields else name)
                for i, v in enumerate(tree)]
        return type(tree)(*kids) if fields else tuple(kids)
    return fn(name, tree)


def cache_partition_specs(cache_abstract, mesh, *, global_batch: int,
                          seq_shard: bool | None = None,
                          kv_axis: Any = "model") -> Any:
    """PartitionSpec tree matching a stacked-LayerCache tree (or a
    layer-pattern stack's tuple of per-layer ones).

    Leaves are identified by field name (k/v/positions/length/state/conv/
    cross_k/cross_v); a stacked leaf has a leading layer axis (never
    sharded).  A layer-pattern stack's per-layer leaves have none: each
    takes the spec its leaf would have in a one-layer stack, without the
    layer entry (the reference's specs assume the axis and raise on
    them).  ``seq_shard`` enables context parallelism over the cache
    sequence dim (the DOS inW fallback — automatic when the batch is
    unshardable); ``kv_axis`` shards kv heads (None replicates them).
    """
    baxes = batch_axes_for(mesh, global_batch)
    b = baxes if len(baxes) > 1 else (baxes[0] if baxes else None)
    if seq_shard is None:
        seq_shard = not baxes and "data" in mesh.axis_names
    used = set(baxes)
    s = None
    if seq_shard:
        s = next((a for a in ("data", "model") if a not in used), None)
        if s is not None:
            used.add(s)
    if kv_axis in used:
        kv_axis = None
    if kv_axis is not None and kv_axis not in getattr(mesh, "axis_names", ()):
        kv_axis = None

    def spec_of(name, leaf) -> P:
        nd = len(leaf.shape)
        if name in ("k", "v", "cross_k", "cross_v"):   # (L, B, W, K, D)
            spec = P(None, b, s, kv_axis, None)
        elif name == "positions":                      # (L, B, W)
            spec = P(None, b, s)
        elif name == "length":                         # (L, B)
            spec = P(None, b)
        elif name == "state":                          # (L, B, nh, p, n)
            spec = P(None, b, kv_axis, None, None)
        elif name == "conv":                           # (L, B, w-1, conv_dim)
            spec = P(None, b, None, kv_axis)
        else:
            spec = P(*([None] * nd))
        return enforce_divisible(spec, tuple(leaf.shape), mesh)

    if type(cache_abstract) is tuple:     # a layer pattern's per-layer caches
        return _map_named(
            lambda name, leaf: P(*spec_of(name, _Stacked(leaf))[1:]),
            cache_abstract)
    return _map_named(spec_of, cache_abstract)


class _Stacked:
    """A per-layer leaf's shape with a one-layer stack axis in front."""

    def __init__(self, leaf):
        self.shape = (1,) + tuple(leaf.shape)


def _leaves_of(tree) -> list:
    """Leaves of a dict tree in the port's (sorted-key) order, a
    QuantMoment counting as one leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_of(tree[k])]
    return [tree]


def _rebuild(like, leaves):
    it = iter(leaves)

    def build(tree):
        if isinstance(tree, dict):
            return {k: build(tree[k]) for k in sorted(tree)}
        return next(it)
    return build(like)


def opt_partition_specs(opt_abstract: AdamWState, param_specs_tree,
                        mesh) -> AdamWState:
    """Optimizer-state PartitionSpecs.

    fp32/bf16 moments mirror the parameter sharding (ZeRO-1 for free).
    int8 moments keep their parameter's shape: ``q`` mirrors the param
    spec exactly, ``scale`` (the per-row absmax) drops the last dim's
    sharding.  A moment tree of another structure (flat blocks) is
    sharded over all mesh axes on dim 0 when divisible, else replicated.
    """
    all_axes = tuple(mesh.axis_names)
    n_all = 1
    for a in all_axes:
        n_all *= mesh.shape[a]
    params_flat = _leaves_of(param_specs_tree)

    def moment_specs(tree):
        flat = _leaves_of(tree)
        if flat and isinstance(flat[0], QuantMoment):
            out = []
            for pspec, qm in zip(params_flat, flat):
                parts = list(pspec)
                parts += [None] * (len(qm.shape) - len(parts))
                sparts = (parts[:-1] + [None]) if parts else [None]
                out.append(QuantMoment(q=P(*parts), scale=P(*sparts),
                                       shape=qm.shape))
            return _rebuild(tree, out)
        if len(flat) == len(params_flat):
            return _rebuild(tree, params_flat)
        specs = []
        for leaf in flat:
            nd = len(leaf.shape)
            if nd >= 1 and leaf.shape[0] % n_all == 0:
                specs.append(P(all_axes, *([None] * (nd - 1))))
            else:
                specs.append(P(*([None] * nd)))
        return _rebuild(tree, specs)

    return AdamWState(step=P(), m=moment_specs(opt_abstract.m),
                      v=moment_specs(opt_abstract.v))


def map_specs(fn, tree):
    """``fn`` over every PartitionSpec of a spec tree (dicts, tuples,
    NamedTuples, QuantMoments), the structure kept."""
    if isinstance(tree, P):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: map_specs(fn, v) for k, v in tree.items()}
    if isinstance(tree, QuantMoment):
        return dataclasses.replace(tree, q=map_specs(fn, tree.q),
                                   scale=map_specs(fn, tree.scale))
    if isinstance(tree, tuple):
        kids = [map_specs(fn, v) for v in tree]
        return type(tree)(*kids) if hasattr(tree, "_fields") else tuple(kids)
    return tree


def to_shardings(spec_tree, mesh):
    """PartitionSpec tree -> the tree of DTensor placements on the
    ``DeviceMesh`` ``mesh`` (the reference's ``NamedSharding`` tree)."""
    return map_specs(lambda s: to_placements(s, mesh), spec_tree)


def local_shape(shape: tuple, spec: P, mesh) -> tuple:
    """The shape of one rank's shard of a ``shape`` tensor placed by
    ``spec`` (rank 0's where a dim does not divide: DTensor's ceiling
    chunk)."""
    ms = mesh_shape(mesh)
    out = list(shape)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        for nm in (entry if isinstance(entry, tuple) else (entry,)):
            out[d] = -(-out[d] // ms.shape[nm])
    return tuple(out)


def place(leaf, spec: P, mesh, fill=None, device=None):
    """A DTensor on the ``DeviceMesh`` ``mesh`` with ``leaf``'s global
    shape, dtype and strides, placed by ``spec``, whose local shard is a
    fresh tensor of the local shape (``fill`` in every element, else
    uninitialized) on ``device`` (default ``leaf``'s): the global tensor
    is never built.  Under a ``FakeTensorMode`` the shard is fake."""
    from torch.distributed.tensor import DTensor

    shape = local_shape(tuple(leaf.shape), spec, mesh)
    device = leaf.device if device is None else device
    local = torch.empty(shape, dtype=leaf.dtype, device=device) \
        if fill is None else \
        torch.full(shape, fill, dtype=leaf.dtype, device=device)
    return DTensor.from_local(local, mesh, to_placements(spec, mesh),
                              run_check=False, shape=leaf.shape,
                              stride=leaf.stride())


def place_value(value: torch.Tensor, spec: P, mesh):
    """``value`` (the whole tensor, the same on every rank: drawn from one
    seed, or read from one file) as a DTensor on the ``DeviceMesh``
    ``mesh`` placed by ``spec``: the local shard is a copy of this rank's
    chunk of it (DTensor's ``torch.chunk`` split, mesh dims in order), so
    ``value`` may be freed at once; no collective.  The real-valued
    counterpart of :func:`place`."""
    from torch.distributed.tensor import DTensor

    pls = to_placements(spec, mesh)
    local = value
    for md, p in enumerate(pls):
        if p.is_shard():
            local = torch.chunk(local, mesh.size(md),
                                dim=p.dim)[mesh.get_local_rank(md)]
    return DTensor.from_local(
        local.clone(memory_format=torch.contiguous_format), mesh, pls,
        run_check=False, shape=value.shape, stride=value.stride())


def place_tree(tree, specs, mesh):
    """:func:`place` over a state tree (dicts, tuples, NamedTuples,
    QuantMoments) and its spec tree: each tensor leaf becomes a DTensor
    with an uninitialized local shard (the dry run's fake state)."""
    if isinstance(tree, torch.Tensor):
        return place(tree, specs, mesh)
    if isinstance(tree, dict):
        return {k: place_tree(v, specs[k], mesh) for k, v in tree.items()}
    if isinstance(tree, QuantMoment):
        return QuantMoment(q=place_tree(tree.q, specs.q, mesh),
                           scale=place_tree(tree.scale, specs.scale, mesh),
                           shape=tree.shape)
    if isinstance(tree, tuple):
        kids = [place_tree(v, sp, mesh) for v, sp in zip(tree, specs)]
        return type(tree)(*kids) if hasattr(tree, "_fields") else tuple(kids)
    return tree


def place_caches(caches, specs, mesh, device):
    """Caches as DTensors on ``mesh`` placed by ``specs`` (from
    :func:`cache_partition_specs`), each local shard allocated on
    ``device`` at its fresh-cache value: ``positions`` -1 (empty), every
    other leaf 0.  ``caches`` may be meta tensors: only their shapes and
    dtypes are read."""
    spec_leaves = []
    _map_named(lambda name, sp: spec_leaves.append(sp), specs)
    it = iter(spec_leaves)
    return _map_named(
        lambda name, leaf: place(leaf, next(it), mesh,
                                 -1 if name == "positions" else 0, device),
        caches)
