"""Concat tensor parallelism for the serving hot path, over
``torch.distributed`` (the counterpart of ``repro.distributed.tp``).

The sharded engine must be bit-identical to the one-device engine, so
concat-TP shards only *output* feature axes, never a contraction axis:

  * ``wq`` / ``wk`` / ``wv`` split over the (kv-)head axis: each rank
    projects its own whole heads (a column slice of a matmul is the same
    dot products);
  * attention runs per rank over its local heads against a KV cache
    sharded the same way (softmax and PV touch no other head);
  * the head outputs are reassembled by :meth:`ServingMesh.gather`, a
    concatenation in rank order with no arithmetic;
  * the SwiGLU ``gate`` / ``up`` projections split over the mlp axis,
    with the same gather before ``down``;
  * ``wo`` / ``down`` / embed / unembed / norms stay replicated: their
    contraction would otherwise need a reduction.

No cross-rank arithmetic happens, so every rank holds the same
activations between blocks and the same logits at the end; only
activations (two gathers a layer) cross the mesh.  Each rank stores and
streams ``1/shards`` of the KV bytes.

The reference places shards with ``PartitionSpec`` trees under
``shard_map``; here each rank is a process that holds its own slices
(:func:`shard_params`) and allocates its caches at ``K / shards`` kv
heads (:func:`serving_cache_dims`).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from ..models.layers import ParamSpec

#: logical parameter axes concat-TP shards (output-feature axes only)
SERVING_TP_AXES = ("heads", "kv_heads", "mlp")

#: parameter leaf names whose sharded logical axis sits on the contraction
#: side of their matmul: sharding those would need a reduction, so they
#: stay replicated (full width) on every rank
_REPLICATED_LEAVES = ("wo", "down")

#: the mesh axis the serving hot path shards over
SERVING_AXIS = "model"

#: the kv-head dimension of a stacked K/V payload: dense rings are
#: ``(L, B, W, K, D)``, paged pools ``(L, P, bs, K, D)``
KV_HEAD_DIM = 3


@dataclasses.dataclass(eq=False)
class ServingMesh:
    """A 1-D concat-TP mesh over ``torch.distributed``: ``shards`` ranks,
    this process's ``rank`` and ``device``, the process ``group`` its
    gathers run over (None for one shard) and its ``backend``
    (``"nccl"`` or ``"gloo"``).  Built by
    ``repro_torch.launch.mesh.make_serving_mesh``.

    Compared and hashed by identity: the engine keys its step bodies on
    the mesh they gather over."""
    shards: int
    rank: int = 0
    device: torch.device = torch.device("cpu")
    group: Any = None
    backend: str = "none"

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` concatenated along ``dim`` in rank order: a
        pure concatenation, no arithmetic (the reference's
        ``all_gather(tiled=True)``).  gloo has no
        ``all_gather_into_tensor``, so this gathers into a list and
        concatenates.  gloo takes CUDA tensors too (staged through
        pinned host memory inside the collective: two copies a part)."""
        if self.shards == 1:
            return x
        import torch.distributed as dist
        src = x.contiguous()
        parts = [torch.empty_like(src) for _ in range(self.shards)]
        dist.all_gather(parts, src, group=self.group)
        return torch.cat(parts, dim=dim)

    def agree(self, values: list[float]) -> list[float]:
        """Rank 0's ``values`` on every rank (one broadcast): a decision
        that reads a rank's own measurements, such as a replan from its
        step times, must be taken once for the whole mesh, or the ranks
        adopt different chunk widths and their gathers stop matching.
        The group is the world group, so its rank 0 is global rank 0."""
        if self.shards == 1:
            return list(values)
        import torch.distributed as dist
        t = torch.tensor(values, dtype=torch.float64,
                         device=self.device if self.backend == "nccl"
                         else "cpu")
        dist.broadcast(t, src=0, group=self.group)
        return t.tolist()


def serving_mesh_shards(mesh) -> int:
    """Size of the mesh's model axis (1 = effectively unsharded)."""
    return 1 if mesh is None else mesh.shards


def validate_serving_tp(cfg, mesh) -> int:
    """Check a model config can run concat-TP serving over ``mesh``.

    Returns the shard count.  Raises ``ValueError`` with the full list of
    violations (the reference's refusals and messages): a
    half-compatible config must fail at engine construction, not produce
    wrong tokens."""
    shards = serving_mesh_shards(mesh)
    if shards <= 1:
        return shards
    problems = []
    if cfg.family not in ("dense", "vlm"):
        problems.append(
            f"family {cfg.family!r} is not supported (concat-TP threads "
            "through the GQA-attention + SwiGLU decode layer; dense/vlm "
            "only today)")
    if cfg.sliding_window:
        problems.append("sliding-window attention is not supported")
    if cfg.is_encoder_decoder:
        problems.append("encoder-decoder cross-attention is not supported")
    for name, dim in (("n_heads", cfg.n_heads),
                      ("n_kv_heads", cfg.n_kv_heads),
                      ("d_ff", cfg.d_ff or cfg.d_model)):
        if dim % shards:
            problems.append(
                f"{name}={dim} is not divisible by {shards} shards "
                "(concat-TP splits whole heads / mlp columns)")
    if problems:
        raise ValueError(
            f"cannot shard serving for {cfg.name!r} over {shards} devices: "
            + "; ".join(problems))
    return shards


def serving_param_specs(param_specs):
    """The concat-TP split of every parameter: walks the ``ParamSpec``
    tree and returns, leaf for leaf, the dimension whose logical axis is
    one of :data:`SERVING_TP_AXES`, or None (replicated).  ``wo`` and
    ``down`` are always None: that axis is their contraction input."""
    def walk(tree, name):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        if not isinstance(tree, ParamSpec) or name in _REPLICATED_LEAVES:
            return None
        dims = [i for i, a in enumerate(tree.axes) if a in SERVING_TP_AXES]
        return dims[0] if dims else None
    return walk(param_specs, "")


def shard_params(params, shards: int, rank: int, dims):
    """Rank ``rank``'s slice of every leaf: along its TP dimension
    (``dims``, from :func:`serving_param_specs`) the ``rank``-th of
    ``shards`` contiguous pieces (whole heads of ``wq`` / ``wk`` / ``wv``,
    whole columns of ``gate`` / ``up``), copied out; replicated leaves
    are returned as they are.  The pieces concatenate back to the leaf."""
    if isinstance(params, dict):
        return {k: shard_params(v, shards, rank, dims[k])
                for k, v in params.items()}
    if dims is None or shards == 1:
        return params
    size = params.shape[dims]
    if size % shards:
        raise ValueError(f"dimension {dims} of a {tuple(params.shape)} leaf "
                         f"does not split into {shards} shards")
    piece = size // shards
    return params.narrow(dims, rank * piece, piece).contiguous()


def serving_cache_dims(caches) -> Any:
    """The concat-TP split of a stacked serving cache, the counterpart of
    the reference's ``serving_cache_specs``: the same tree with
    :data:`KV_HEAD_DIM` on the K/V payloads and None on every other leaf
    (positions, lengths and block tables are replicated: every rank runs
    the same masks and scatters, only the payload bytes split).  A rank
    allocates its payloads at ``K / shards`` heads
    (``Model.init_caches(..., shards=)``)."""
    kv = caches.kv
    if not (hasattr(kv, "k") and hasattr(kv, "v")):
        raise ValueError(
            f"serving caches carry no shardable KV ({type(kv).__name__})")

    def none(tree):
        if isinstance(tree, torch.Tensor):
            return None
        return type(tree)(*(none(v) for v in tree))
    dims = none(caches)
    return dims._replace(kv=dims.kv._replace(k=KV_HEAD_DIM, v=KV_HEAD_DIM))
