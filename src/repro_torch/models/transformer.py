"""Transformer stacks for every family of the reference, in PyTorch.

The counterpart of ``repro.models.transformer``: ``dense`` (and the
identical ``vlm``) layers, pre-norm GQA attention + SwiGLU MLP, with full
or sliding-window attention and layer patterns (gemma3's ``SSSSSG``: a
window and a RoPE theta per layer); ``moe`` layers (attention + the
one-device MoE FFN of :mod:`.moe`, plus arctic's dense SwiGLU residual);
``ssm`` layers (a Mamba2 mixer alone); ``hybrid`` layers (Hymba:
attention and Mamba2 heads in parallel on the same normed input,
mean-fused with learned per-branch scales, then the SwiGLU MLP); and
``audio`` (encoder-decoder: a bidirectional encoder of attention + GELU
MLP layers, and decoder layers of causal self-attention, cross-attention
over the encoder's output and a GELU MLP).  The reference's
``lax.scan`` over stacked layer params becomes a Python loop over
per-layer views of the stacked leaves; cache views share storage with
the stack, so per-layer in-place updates land in the stacked cache.  A
layer-pattern stack's caches are a tuple of per-layer caches (the
reference's unrolled path).
"""
from __future__ import annotations

from typing import Any, NamedTuple

import torch

from . import attention as A
from . import moe as M
from . import ssm as S
from .layers import (ParamSpec, gelu_mlp, gelu_mlp_specs, rms_norm,
                     rms_norm_spec, swiglu, swiglu_specs)

#: the families the port serves (the reference's every family)
FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "audio")


def check_supported(cfg) -> None:
    """Raise for a configuration no family of the port builds."""
    if cfg.family not in FAMILIES \
            or (cfg.attn_free and cfg.family != "ssm"):
        raise NotImplementedError(
            f"{cfg.name}: family {cfg.family!r} (attention-free "
            f"{cfg.attn_free}) is not one the port builds: {FAMILIES}, "
            "attention-free only as ssm")


def decoder_layer_specs(cfg, cross: bool = False) -> dict[str, Any]:
    """One decoder layer's params by family; ``cross`` adds the
    cross-attention of an encoder-decoder's decoder."""
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
    if cross:
        specs["norm_cross"] = rms_norm_spec(d)
        specs["cross_attn"] = A.attention_specs(d, cfg.n_heads, cfg.n_kv_heads,
                                                cfg.resolved_head_dim, False)
    if fam == "moe":
        specs["norm2"] = rms_norm_spec(d)
        specs["moe"] = M.moe_specs(d, cfg.d_ff, cfg.n_experts)
        if cfg.moe_dense_residual:
            specs["dense_mlp"] = swiglu_specs(d, cfg.d_ff)
    elif fam == "audio":
        specs["norm2"] = rms_norm_spec(d)
        specs["mlp"] = gelu_mlp_specs(d, cfg.d_ff)
    elif fam != "ssm":
        specs["norm2"] = rms_norm_spec(d)
        specs["mlp"] = swiglu_specs(d, cfg.d_ff)
    return specs


def encoder_layer_specs(cfg) -> dict[str, Any]:
    d = cfg.d_model
    return {
        "norm1": rms_norm_spec(d),
        "attn": A.attention_specs(d, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.resolved_head_dim, False),
        "norm2": rms_norm_spec(d),
        "mlp": gelu_mlp_specs(d, cfg.d_ff),
    }


def ffn(p, h2, *, cfg, mlp_backend: str = "torch", shard_axis=None,
        aux: bool = False):
    """A layer's FFN on its normed input h2, by family: the MoE FFN (plus
    arctic's dense SwiGLU residual, through the ``linked_matmul`` site),
    the GELU MLP (audio) or the SwiGLU MLP (``mlp_backend``: the
    ``linked_matmul`` site; ``shard_axis``: the concat-TP mesh it gathers
    over).  Returns (y, the MoE load-balance loss when ``aux``, else
    None)."""
    if cfg.family == "moe":
        y, loss = M.moe_block(p["moe"], h2, cfg=cfg, aux=aux)
        if cfg.moe_dense_residual:
            y = y + swiglu(p["dense_mlp"], h2, mlp_backend)
        return y, loss
    if cfg.family == "audio":
        return gelu_mlp(p["mlp"], h2), None
    return swiglu(p["mlp"], h2, mlp_backend, shard_axis), None


def cross_kv(p, enc_out):
    """The cross-attention's K and V (B, Ssrc, K, D) of the encoder's
    output (the reference's ``_cross_kv``)."""
    return A._project(p, enc_out, "wk"), A._project(p, enc_out, "wv")


def cross_attend(p, x, kv, *, cfg):
    """The decoder's cross-attention residual over the encoder's K/V."""
    return A.attention_block(p["cross_attn"], rms_norm(x, p["norm_cross"]),
                             cfg=cfg, kv=kv)


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
                  window: int | None = None, rope_theta: float | None = None,
                  enc_out=None, aux: bool = False):
    """x: (B, S, d) -> (y, the MoE load-balance loss or None).
    ``mlp_backend``: the ``linked_matmul`` site (see :func:`~.layers.
    swiglu`); ``window`` / ``rope_theta`` override the config's for one
    layer of a layer-pattern stack; ``enc_out`` (B, Ssrc, d): the
    encoder's output the decoder cross-attends; ``aux`` as in
    :func:`ffn`."""
    h = rms_norm(x, p["norm1"])
    if cfg.family == "ssm":
        return x + S.mamba2_block(p["ssm"], h, cfg=cfg), None
    att = A.attention_block(p["attn"], h, cfg=cfg, window=window,
                            rope_theta=rope_theta)
    if cfg.family == "hybrid":
        x = x + fuse_hybrid(p, att, S.mamba2_block(p["ssm"], h, cfg=cfg))
    else:
        x = x + att
    if enc_out is not None:
        x = x + cross_attend(p, x, cross_kv(p["cross_attn"], enc_out),
                             cfg=cfg)
    y, loss = ffn(p, rms_norm(x, p["norm2"]), cfg=cfg,
                  mlp_backend=mlp_backend, aux=aux)
    return x + y, loss


def decoder_stack(layers: list, x, *, cfg, mlp_backend: str = "torch",
                  enc_out=None):
    """``layers``: per-layer param views (see :func:`layer_views`).  Every
    layer takes the config's window and theta, as the reference's full
    forward does.  Returns (x, the summed MoE load-balance loss: 0 but
    for the moe family)."""
    total = torch.zeros((), device=x.device)
    for lp in layers:
        x, loss = decoder_layer(lp, x, cfg=cfg, mlp_backend=mlp_backend,
                                enc_out=enc_out, aux=cfg.family == "moe")
        if loss is not None:
            total = total + loss
    return x, total


def encoder_layer(p, x, *, cfg):
    """Bidirectional attention + GELU MLP, each pre-norm."""
    h = rms_norm(x, p["norm1"])
    x = x + A.attention_block(p["attn"], h, cfg=cfg, causal=False)
    return x + gelu_mlp(p["mlp"], rms_norm(x, p["norm2"]))


def encoder_stack(layers: list, x, *, cfg):
    """``layers``: the encoder's per-layer param views."""
    for lp in layers:
        x = encoder_layer(lp, x, cfg=cfg)
    return x


class LayerCache(NamedTuple):
    """Per-layer decode cache; an unused field is the () placeholder (no
    KV on an attention-free layer, no SSM state on an attention one, no
    cross K/V but an encoder-decoder's)."""
    kv: Any = ()            # A.KVCache / PagedKVCache / PagedRingKVCache
    ssm: Any = ()           # S.SSMCache
    cross_k: Any = ()       # (B, Ssrc, K, D) the encoder's, static
    cross_v: Any = ()


def init_layer_cache(cfg, batch: int, width: int, dtype=torch.bfloat16,
                     device="cuda", shards: int = 1,
                     src_len: int = 0) -> LayerCache:
    """``shards``: a concat-TP rank's cache holds ``n_kv_heads / shards``
    kv heads (``repro_torch.distributed.tp``); ``src_len``: an
    encoder-decoder's source frames, the width of its cross K/V."""
    kv: Any = ()
    ssm: Any = ()
    ck: Any = ()
    cv: Any = ()
    if not cfg.attn_free:
        kv = A.init_kv_cache(batch, width, cfg.n_kv_heads // shards,
                             cfg.resolved_head_dim, dtype, device)
    if cfg.family in ("ssm", "hybrid"):
        ssm = S.init_ssm_cache(batch, cfg, dtype, device)
    if cfg.is_encoder_decoder and src_len:
        ck = torch.zeros((batch, src_len, cfg.n_kv_heads,
                          cfg.resolved_head_dim), dtype=dtype, device=device)
        cv = torch.zeros_like(ck)
    return LayerCache(kv=kv, ssm=ssm, cross_k=ck, cross_v=cv)


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
    before ``wo`` / ``down``), None on one device.  An encoder-decoder's
    layer cross-attends its cache's static K/V through the
    ``decode_dense`` site."""
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
    if isinstance(cache.cross_k, torch.Tensor):
        y, _ = A.attention_decode_block(
            p["cross_attn"], rms_norm(x, p["norm_cross"]), cache.kv,
            cfg=cfg, cross_kv=(cache.cross_k, cache.cross_v),
            dense_backend=dense_backend)
        x = x + y
    y, _ = ffn(p, rms_norm(x, p["norm2"]), cfg=cfg, mlp_backend=mlp_backend,
               shard_axis=shard_axis)
    return x + y, cache


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
