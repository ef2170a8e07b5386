"""Transformer stack for the dense full-attention family, in PyTorch.

The counterpart of ``repro.models.transformer`` for ``dense`` (and the
identical ``vlm``) layers: pre-norm GQA attention + SwiGLU MLP.  The
reference's ``lax.scan`` over stacked layer params becomes a Python loop
over per-layer views of the stacked leaves; cache views share storage
with the stack, so per-layer in-place updates land in the stacked cache.
MoE, SSM, hybrid and audio layers fail with ``NotImplementedError``
(``check_supported``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from . import attention as A
from .layers import rms_norm, rms_norm_spec, swiglu, swiglu_specs

#: the ROADMAP items that port what this slice leaves out
_LATER = {
    "moe": "ROADMAP queue 1 item 9 (MoE)",
    "audio": "ROADMAP queue 1 item 9 (encoder-decoder)",
    "ssm": "ROADMAP queue 1 item 7 (cache families: SSM)",
    "hybrid": "ROADMAP queue 1 item 7 (cache families: hybrid)",
}


def check_supported(cfg) -> None:
    """Raise for configurations this slice of the port does not serve."""
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; "
            f"{_LATER[cfg.family]} ports it")
    if cfg.family not in ("dense", "vlm") or cfg.attn_free:
        raise NotImplementedError(
            f"{cfg.name}: only dense full-attention decoders are ported")
    if cfg.layer_pattern:
        raise NotImplementedError(
            f"{cfg.name}: layer_pattern {cfg.layer_pattern!r} stacks are "
            "ported by ROADMAP queue 1 item 7 (cache families)")
    if cfg.sliding_window > 0:
        raise NotImplementedError(
            f"{cfg.name}: sliding_window={cfg.sliding_window} is ported by "
            "ROADMAP queue 1 item 7 (cache families: the sliding ring)")
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder stacks are ported by "
            f"{_LATER['audio']}")


def decoder_layer_specs(cfg) -> dict[str, Any]:
    d = cfg.d_model
    return {
        "norm1": rms_norm_spec(d),
        "attn": A.attention_specs(d, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.resolved_head_dim, cfg.qk_norm),
        "norm2": rms_norm_spec(d),
        "mlp": swiglu_specs(d, cfg.d_ff),
    }


def layer_views(stacked, n_layers: int) -> list:
    """Per-layer views of a tree of stacked leaves (dicts / NamedTuples)."""
    def view(tree, i):
        if isinstance(tree, dict):
            return {k: view(v, i) for k, v in tree.items()}
        if isinstance(tree, tuple):       # KVCache / PagedKVCache / LayerCache
            return type(tree)(*(view(v, i) for v in tree))
        return tree[i]
    return [view(stacked, i) for i in range(n_layers)]


def decoder_layer(p, x, *, cfg, mlp_backend: str = "torch"):
    """x: (B, S, d) -> (B, S, d).  ``mlp_backend``: the ``linked_matmul``
    site (see :func:`~.layers.swiglu`)."""
    x = x + A.attention_block(p["attn"], rms_norm(x, p["norm1"]), cfg=cfg)
    return x + swiglu(p["mlp"], rms_norm(x, p["norm2"]), mlp_backend)


def decoder_stack(layers: list, x, *, cfg, mlp_backend: str = "torch"):
    """``layers``: per-layer param views (see :func:`layer_views`).  The
    dense family has no auxiliary loss."""
    for lp in layers:
        x = decoder_layer(lp, x, cfg=cfg, mlp_backend=mlp_backend)
    return x


class LayerCache(NamedTuple):
    """Per-layer decode cache (the dense family carries KV only)."""
    kv: Any = ()


def init_layer_cache(cfg, batch: int, width: int, dtype=torch.bfloat16,
                     device="cuda") -> LayerCache:
    return LayerCache(kv=A.init_kv_cache(batch, width, cfg.n_kv_heads,
                                         cfg.resolved_head_dim, dtype,
                                         device))


def init_paged_layer_cache(cfg, batch: int, pool_blocks: int,
                           block_size: int, max_blocks: int,
                           dtype=torch.bfloat16, device="cuda") -> LayerCache:
    return LayerCache(kv=A.init_paged_kv_cache(
        batch, pool_blocks, block_size, max_blocks, cfg.n_kv_heads,
        cfg.resolved_head_dim, dtype, device))


def decoder_layer_decode(p, x, cache: LayerCache, *, cfg,
                         dense_backend: str = "torch",
                         paged_backend: str = "gather",
                         mlp_backend: str = "torch", live=None):
    """One-token decode through one layer, updating ``cache`` in place.
    x: (B, 1, d)."""
    att, _ = A.attention_decode_block(p["attn"], rms_norm(x, p["norm1"]),
                                      cache.kv, cfg=cfg,
                                      dense_backend=dense_backend,
                                      paged_backend=paged_backend, live=live)
    x = x + att
    return x + swiglu(p["mlp"], rms_norm(x, p["norm2"]), mlp_backend), cache


def decoder_stack_decode(layers: list, x, caches: list, *, cfg,
                         dense_backend: str = "torch",
                         paged_backend: str = "gather",
                         mlp_backend: str = "torch", live=None):
    """``layers``/``caches``: per-layer views; caches update in place."""
    for lp, cache in zip(layers, caches):
        x, _ = decoder_layer_decode(lp, x, cache, cfg=cfg,
                                    dense_backend=dense_backend,
                                    paged_backend=paged_backend,
                                    mlp_backend=mlp_backend, live=live)
    return x, caches
