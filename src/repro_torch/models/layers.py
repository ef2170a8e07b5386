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


def _init_leaf(spec: ParamSpec, generator: torch.Generator, device,
               dtype) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=device)
    if spec.init == "embed":
        return (x * 0.02).to(dtype)
    fan_in = spec.shape[0] if len(spec.shape) > 1 else spec.shape[-1]
    if len(spec.shape) == 3:  # stacked experts / layers: fan-in is dim 1
        fan_in = spec.shape[1]
    scale = spec.scale or (1.0 / math.sqrt(max(fan_in, 1)))
    return (x * scale).to(dtype)


def init_params(specs, generator: torch.Generator, device,
                dtype=torch.float32):
    """Draw every leaf of a spec tree (sorted-key order) on ``device``."""
    return tree_map(lambda s: _init_leaf(s, generator, device, dtype), specs)


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
    return table[ids.long()].to(dtype)


def unembed(table: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Tied unembedding: logits over the padded vocabulary."""
    return x @ table.to(x.dtype).T
