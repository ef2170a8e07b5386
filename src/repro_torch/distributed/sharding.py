"""Logical-axis sharding rules: the transformer face of DSP-aware operator
split (paper §4.2), as torch placements.

The counterpart of ``repro.distributed.sharding``.  The paper's priority
(partition ``outC`` first: parameters distribute, no reduction;
``inH``/``inW`` next: activations and batch; never ``inC``) maps to:

  outC  -> heads / kv_heads / mlp / experts / vocab / ssm_inner -> "model"
  inH   -> batch                                                -> ("pod","data")
  inW   -> sequence                                             -> None (baseline)
  inC   -> embed (contraction dim)                              -> None (a
           rule mapping embed->mesh would add an all-reduce per matmul, the
           exact reduction overhead §4.2.1 dismisses)

Rules are plain dicts logical-axis -> mesh-axis (or None); the d-Xenos
planner (``launch/autotune.py``) enumerates rule variants and scores them
with the dry run's roofline, mirroring Algorithm 1.

A :class:`PartitionSpec` maps tensor dims to mesh axes, as the
reference's ``jax.sharding.PartitionSpec`` does (``tuple()`` of either
gives the same entries); :func:`to_placements` turns one into the DTensor
placements of a ``torch.distributed.device_mesh.DeviceMesh``, which map
mesh dims to ``Shard(d)`` / ``Replicate()``.  A mesh here is anything
with ``axis_names`` and a ``shape`` dict (axis -> size), as the
reference's rules read a mesh: :class:`MeshShape`, or a ``DeviceMesh``
through :func:`mesh_shape`.
"""
from __future__ import annotations

from typing import Any, Mapping

from ..models.layers import ParamSpec, tree_map

Rules = dict  # logical axis name -> mesh axis name | tuple | None

BASELINE_RULES: Rules = {
    "vocab": "model",
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "qkv": "model",
    "mlp": "model",
    "experts": "model",
    "expert_mlp": None,
    "ssm_inner": "model",
    "ssm_heads": "model",
    "ssm_state": None,
    "conv": None,
    "head_dim": None,
    "layers": None,   # the stacked layer axis is never sharded
}


class PartitionSpec(tuple):
    """Per-dim mesh axes of one tensor: each entry ``None`` (replicated),
    a mesh axis name, or a tuple of names (the dim split over their
    product, the first name outermost)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return "PartitionSpec" + super().__repr__()


P = PartitionSpec


class MeshShape:
    """A mesh's axis names and sizes, no devices: what the rules read."""

    def __init__(self, sizes: Mapping[str, int]):
        self.shape = dict(sizes)
        self.axis_names = tuple(sizes)

    @property
    def size(self) -> int:
        n = 1
        for v in self.shape.values():
            n *= v
        return n


def mesh_shape(mesh) -> MeshShape:
    """The :class:`MeshShape` of a ``DeviceMesh`` (its dim names and
    sizes) or of anything that already has ``axis_names`` and ``shape``."""
    if hasattr(mesh, "mesh_dim_names"):
        return MeshShape(dict(zip(mesh.mesh_dim_names, mesh.shape)))
    return MeshShape(dict(mesh.shape))


def rules_for(cfg, mesh, overrides: Mapping[str, Any] | None = None) -> Rules:
    """Baseline DOS rules, adapted to the config and mesh.

    Mirrors §4.2.1's fallback ladder: if an outC-like extent cannot use the
    full model axis (e.g. chatglm3's kv=2 over 16), the rule keeps the
    shard and :func:`spec_for_axes` moves it down the ladder; the planner
    may override.  A rule naming an axis the mesh lacks becomes None.
    """
    rules = dict(BASELINE_RULES)
    rules.update(dict(getattr(cfg, "sharding_overrides", ()) or ()))
    if overrides:
        rules.update(overrides)
    axis_names = set(mesh.axis_names) if mesh is not None else set()
    for k, v in list(rules.items()):
        names = v if isinstance(v, tuple) else (v,)
        if any(n is not None and n not in axis_names for n in names):
            rules[k] = None
    return rules


#: when an outC-like dim cannot be evenly sharded, DOS falls back down the
#: §4.2.2 param-split ladder; the final rung is the contraction (inC ≙
#: embed) dim — the "extra reduction" split the paper deprioritizes but
#: allows as last resort.
FALLBACK_AXES = ("embed", "mlp", "ssm_inner")


def _size_of(mesh, names: tuple) -> int:
    n = 1
    for nm in names:
        n *= mesh.shape[nm]
    return n


def spec_for_axes(axes: tuple, rules: Rules, shape: tuple | None = None,
                  mesh=None) -> PartitionSpec:
    """PartitionSpec for one parameter.

    With ``shape``+``mesh``, enforces divisibility: a mesh axis that does
    not divide its dim moves down the fallback ladder (another divisible
    dim with a FALLBACK_AXES logical name), else is dropped (replicated) —
    the paper's "pad / randomly assign the remainder" adapted to even
    shards.
    """
    parts: list = []
    used: set = set()
    pending: list[tuple[int, tuple]] = []   # (dim, mesh axes needing a home)

    for dim, a in enumerate(axes):
        m = rules.get(a) if a is not None else None
        if m is None:
            parts.append(None)
            continue
        names = tuple(n for n in (m if isinstance(m, tuple) else (m,))
                      if n is not None and n not in used)
        if not names:
            parts.append(None)
            continue
        if shape is not None and mesh is not None \
                and shape[dim] % _size_of(mesh, names) != 0:
            parts.append(None)
            pending.append((dim, names))
            continue
        used.update(names)
        parts.append(names if len(names) > 1 else names[0])

    # fallback ladder for displaced mesh axes
    for _, names in pending:
        for dim, a in enumerate(axes):
            if parts[dim] is not None or a not in FALLBACK_AXES:
                continue
            if shape[dim] % _size_of(mesh, names) == 0 \
                    and not any(n in used for n in names):
                parts[dim] = names if len(names) > 1 else names[0]
                used.update(names)
                break
        # not placed -> replicated
    return PartitionSpec(*parts)


def param_partition_specs(tree, rules: Rules, mesh=None):
    """ParamSpec tree -> PartitionSpec tree (a leaf that is a tuple of
    logical axes gets the rules' spec without the divisibility check)."""
    def leaf_fn(x):
        if isinstance(x, ParamSpec):
            return spec_for_axes(x.axes, rules, x.shape, mesh)
        return spec_for_axes(x, rules)
    return tree_map(leaf_fn, tree)


def to_placements(spec: PartitionSpec, mesh) -> list:
    """The DTensor placements of ``spec`` on the ``DeviceMesh`` ``mesh``:
    one per mesh dim, ``Shard(d)`` where tensor dim ``d`` names that mesh
    axis, else ``Replicate()``.  A dim split over several axes lists them
    outermost first, as the reference's specs do; DTensor shards such a
    dim over the mesh dims in mesh order, so the names must come in mesh
    order (``("pod", "data")``)."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: list = [Replicate() for _ in names]
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        group = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(n) for n in group]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec!r} splits dim {d} over {group}, "
                             f"not in the mesh's order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return out


def placements_to_spec(placements, ndim: int, mesh) -> PartitionSpec:
    """The ``PartitionSpec`` of a rank-``ndim`` tensor with DTensor
    ``placements`` on ``mesh``: :func:`to_placements`' inverse (a
    partial placement reads as replicated)."""
    names = list(mesh.mesh_dim_names)
    parts: list = [[] for _ in range(ndim)]
    for md, p in enumerate(placements):
        if p.is_shard():
            parts[p.dim].append(names[md])
    return PartitionSpec(*(None if not g else g[0] if len(g) == 1
                           else tuple(g) for g in parts))


def param_shardings(specs_tree, mesh):
    """PartitionSpec tree -> the tree of each leaf's DTensor placements on
    ``mesh``: the counterpart of the reference's ``NamedSharding`` tree."""
    return tree_map(lambda s: to_placements(s, mesh), specs_tree)


def batch_axes_for(mesh, global_batch: int) -> tuple:
    """Shard the batch over ("pod","data") when divisible; §4.2.1's inH split.
    Falls back to fewer axes (long_500k batch=1 -> replicated)."""
    if mesh is None:
        return ()
    cands = [a for a in ("pod", "data") if a in mesh.axis_names]
    while cands:
        if global_batch % _size_of(mesh, tuple(cands)) == 0:
            return tuple(cands)
        cands.pop(0)
    return ()


def activation_spec(batch_axes: tuple, ndim: int,
                    last: Any = None) -> PartitionSpec:
    """Rank-``ndim`` PartitionSpec: (batch, None, ..., last)."""
    first = batch_axes if len(batch_axes) > 1 else \
        (batch_axes[0] if batch_axes else None)
    if ndim == 1:
        return PartitionSpec(first)
    return PartitionSpec(first, *([None] * (ndim - 2)), last)
