"""Transformer stacks for the dense, SSM and hybrid families, in PyTorch.

The counterpart of ``repro.models.transformer`` for ``dense`` (and the
identical ``vlm``) layers: pre-norm GQA attention + SwiGLU MLP, with full
or sliding-window attention and layer patterns (gemma3's ``SSSSSG``: a
window and a RoPE theta per layer); ``ssm`` layers (a Mamba2 mixer
alone); and ``hybrid`` layers (Hymba: attention and Mamba2 heads in
parallel on the same normed input, mean-fused with learned per-branch
scales, then the SwiGLU MLP).  The reference's ``lax.scan`` over
stacked layer params becomes a Python loop over per-layer views of the
stacked leaves; cache views share storage with the stack, so per-layer
in-place updates land in the stacked cache.  A layer-pattern stack's
caches are a tuple of per-layer caches (the reference's unrolled path).
MoE and audio layers fail with ``NotImplementedError``
(``check_supported``).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from . import attention as A
from . import ssm as S
from .layers import (ParamSpec, rms_norm, rms_norm_spec, swiglu,
                     swiglu_specs)

#: the ROADMAP items that port what this slice leaves out
_LATER = {
    "moe": "ROADMAP queue 1 item 9 (MoE)",
    "audio": "ROADMAP queue 1 item 9 (encoder-decoder)",
}


def check_supported(cfg) -> None:
    """Raise for configurations this slice of the port does not serve."""
    if cfg.family in _LATER:
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} is not ported yet; "
            f"{_LATER[cfg.family]} ports it")
    if cfg.family not in ("dense", "vlm", "ssm", "hybrid") \
            or (cfg.attn_free and cfg.family != "ssm"):
        raise NotImplementedError(
            f"{cfg.name}: only dense, ssm and hybrid decoders are ported")
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name}: encoder-decoder stacks are ported by "
            f"{_LATER['audio']}")


def decoder_layer_specs(cfg) -> dict[str, Any]:
    d = cfg.d_model
    fam = cfg.family
    specs: dict[str, Any] = {"norm1": rms_norm_spec(d)}
    if not cfg.attn_free:
        specs["attn"] = A.attention_specs(d, cfg.n_heads, cfg.n_kv_heads,
                                          cfg.resolved_head_dim, cfg.qk_norm)
    if fam in ("ssm", "hybrid"):
        specs["ssm"] = S.mamba2_specs(cfg)
    if fam == "hybrid":
        # learned per-branch fusion scales (Hymba's mean-fusion)
        specs["attn_scale"] = ParamSpec((d,), ("embed",), init="ones")
        specs["ssm_scale"] = ParamSpec((d,), ("embed",), init="ones")
    if fam != "ssm":
        specs["norm2"] = rms_norm_spec(d)
        specs["mlp"] = swiglu_specs(d, cfg.d_ff)
    return specs


def fuse_hybrid(lp, att, ssm_o):
    """Hymba's mean-fusion of the two branch outputs, each scaled."""
    return 0.5 * (att * lp["attn_scale"].to(att.dtype)
                  + ssm_o * lp["ssm_scale"].to(att.dtype))


def layer_views(stacked, n_layers: int) -> list:
    """Per-layer views of a tree of stacked leaves (dicts / NamedTuples)."""
    def view(tree, i):
        if isinstance(tree, dict):
            return {k: view(v, i) for k, v in tree.items()}
        if isinstance(tree, tuple):  # LayerCache, KV and SSM caches, ()
            return type(tree)(*(view(v, i) for v in tree))
        return tree[i]
    return [view(stacked, i) for i in range(n_layers)]


def decoder_layer(p, x, *, cfg, mlp_backend: str = "torch",
                  window: int | None = None, rope_theta: float | None = None):
    """x: (B, S, d) -> (B, S, d).  ``mlp_backend``: the ``linked_matmul``
    site (see :func:`~.layers.swiglu`); ``window`` / ``rope_theta``
    override the config's for one layer of a layer-pattern stack."""
    h = rms_norm(x, p["norm1"])
    if cfg.family == "ssm":
        return x + S.mamba2_block(p["ssm"], h, cfg=cfg)
    att = A.attention_block(p["attn"], h, cfg=cfg, window=window,
                            rope_theta=rope_theta)
    if cfg.family == "hybrid":
        x = x + fuse_hybrid(p, att, S.mamba2_block(p["ssm"], h, cfg=cfg))
    else:
        x = x + att
    return x + swiglu(p["mlp"], rms_norm(x, p["norm2"]), mlp_backend)


def decoder_stack(layers: list, x, *, cfg, mlp_backend: str = "torch"):
    """``layers``: per-layer param views (see :func:`layer_views`).  Every
    layer takes the config's window and theta, as the reference's full
    forward does.  The dense family has no auxiliary loss."""
    for lp in layers:
        x = decoder_layer(lp, x, cfg=cfg, mlp_backend=mlp_backend)
    return x


class LayerCache(NamedTuple):
    """Per-layer decode cache; an unused field is the () placeholder (no
    KV on an attention-free layer, no SSM state on an attention one)."""
    kv: Any = ()            # A.KVCache / PagedKVCache / PagedRingKVCache
    ssm: Any = ()           # S.SSMCache


def init_layer_cache(cfg, batch: int, width: int, dtype=torch.bfloat16,
                     device="cuda", shards: int = 1) -> LayerCache:
    """``shards``: a concat-TP rank's cache holds ``n_kv_heads / shards``
    kv heads (``repro_torch.distributed.tp``)."""
    kv: Any = ()
    ssm: Any = ()
    if not cfg.attn_free:
        kv = A.init_kv_cache(batch, width, cfg.n_kv_heads // shards,
                             cfg.resolved_head_dim, dtype, device)
    if cfg.family in ("ssm", "hybrid"):
        ssm = S.init_ssm_cache(batch, cfg, dtype, device)
    return LayerCache(kv=kv, ssm=ssm)


def init_paged_layer_cache(cfg, batch: int, pool_blocks: int,
                           block_size: int, max_blocks: int,
                           dtype=torch.bfloat16, device="cuda",
                           kind: str = "paged",
                           shards: int = 1) -> LayerCache:
    """A per-layer cache backed by a block pool: ``kind`` ``"paged"``
    (logical-order tables, full attention) or ``"ring"`` (window-sized
    wraparound tables, sliding layers); ``shards`` as in
    :func:`init_layer_cache`."""
    init = {"paged": A.init_paged_kv_cache,
            "ring": A.init_paged_ring_kv_cache}[kind]
    return LayerCache(kv=init(batch, pool_blocks, block_size, max_blocks,
                              cfg.n_kv_heads // shards,
                              cfg.resolved_head_dim, dtype, device))


def decoder_layer_decode(p, x, cache: LayerCache, *, cfg,
                         dense_backend: str = "torch",
                         paged_backend: str = "gather",
                         ring_backend: str = "gather",
                         ssm_backend: str = "torch",
                         mlp_backend: str = "torch", live=None,
                         window: int | None = None,
                         rope_theta: float | None = None,
                         shard_axis=None):
    """One-token decode through one layer, updating ``cache`` in place.
    x: (B, 1, d).  ``ssm_backend`` is the ``ssm_scan`` site; ``live``
    rows alone write KV and SSM state.  ``shard_axis``: the concat-TP
    mesh of a sharded engine (attention heads and MLP columns gathered
    before ``wo`` / ``down``), None on one device."""
    h = rms_norm(x, p["norm1"])
    if cfg.family == "ssm":
        y, _ = S.mamba2_decode(p["ssm"], h, cache.ssm, cfg=cfg,
                               backend=ssm_backend, live=live)
        return x + y, cache
    att, _ = A.attention_decode_block(p["attn"], h, cache.kv, cfg=cfg,
                                      dense_backend=dense_backend,
                                      paged_backend=paged_backend,
                                      ring_backend=ring_backend, live=live,
                                      window=window, rope_theta=rope_theta,
                                      shard_axis=shard_axis)
    if cfg.family == "hybrid":
        ssm_o, _ = S.mamba2_decode(p["ssm"], h, cache.ssm, cfg=cfg,
                                   backend=ssm_backend, live=live)
        x = x + fuse_hybrid(p, att, ssm_o)
    else:
        x = x + att
    return x + swiglu(p["mlp"], rms_norm(x, p["norm2"]), mlp_backend,
                      shard_axis), cache


def decoder_stack_decode(layers: list, x, caches, *, cfg,
                         dense_backend: str = "torch",
                         paged_backend: str = "gather",
                         ring_backend: str = "gather",
                         ssm_backend: str = "torch",
                         mlp_backend: str = "torch", live=None,
                         layer_windows: tuple | None = None,
                         layer_thetas: tuple | None = None,
                         shard_axis=None):
    """``layers``/``caches``: per-layer views (a layer-pattern stack's
    caches are its tuple of per-layer caches); caches update in place.
    ``layer_windows`` / ``layer_thetas``: a layer-pattern stack's window
    and RoPE theta by layer (None: the config's for every layer);
    ``shard_axis`` as in :func:`decoder_layer_decode`."""
    for i, (lp, cache) in enumerate(zip(layers, caches)):
        x, _ = decoder_layer_decode(
            lp, x, cache, cfg=cfg, dense_backend=dense_backend,
            paged_backend=paged_backend, ring_backend=ring_backend,
            ssm_backend=ssm_backend, mlp_backend=mlp_backend, live=live,
            window=layer_windows[i] if layer_windows else None,
            rope_theta=layer_thetas[i] if layer_thetas else None,
            shard_axis=shard_axis)
    return x, caches
