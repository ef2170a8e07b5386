"""Top-level model: parameters and the serving steps, in PyTorch.

The counterpart of ``repro.models.model.Model`` for every family: dense
(full attention, sliding windows and layer patterns), MoE, the recurrent
ones (``ssm``: Mamba2 alone; ``hybrid``: attention and Mamba2 heads in
parallel) and the encoder-decoder (``audio``: the encoder runs over
precomputed frame embeddings, ``batch["src"]``, and the decoder
cross-attends its output): ``param_specs``, ``init``, ``forward``,
``prefill_step``, ``prefill_chunk``, ``serve_step``, ``verify_step``,
``init_caches``, ``init_paged_caches``, ``reset_cache_rows`` and
``rollback_cache_rows``.  The parameter tree is
the reference's (same nested dict, names, shapes and stacked leading
layer axis), so ``repro_torch.convert`` carries reference weights over
leaf for leaf.

Differences of idiom, not of result:

* a layer-pattern stack (gemma3's ``SSSSSG``) runs the reference's
  per-layer path: its caches are a tuple of per-layer caches at their
  natural widths (a sliding layer's ring is window-sized) and each layer
  takes its own window and RoPE theta (``layer_windows``,
  ``layer_thetas``); other stacks keep one stacked cache;
* caches are updated **in place** and returned; a decode step writes K/V,
  positions, lengths and SSM state only for live rows (the reference
  writes every row and restores the dead ones wholesale);
* ``cast_params`` makes one serving copy in ``cfg.dtype`` (the reference
  casts fp32 params at every use — the same numbers);
* the model lives on one ``device`` (default ``"cuda"``); asking for
  CUDA without a card raises.

Training (``loss_fn``, ``train_step``) is ROADMAP queue 1 item 10.
"""
from __future__ import annotations

from typing import Any

import torch

from .. import resolve_device
from . import attention as A
from . import cache_family as CF
from . import ssm as SSM
from . import transformer as T
from .layers import (embed_lookup, embed_specs, init_params, param_count,
                     rms_norm, rms_norm_spec, stack_layer_specs, tree_leaves,
                     tree_map, unembed)

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


class Model:
    def __init__(self, cfg, kernel_plan=None, device="cuda"):
        from ..core.pipeline import KernelPlan
        T.check_supported(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        #: per-site backend routing; the default is the plain-torch seed
        #: path.  prefill_step, prefill_chunk and serve_step accept a
        #: per-call override.
        self.kernel_plan = kernel_plan if kernel_plan is not None \
            else KernelPlan()
        self.dtype = _DTYPES[cfg.dtype]
        self.param_dtype = _DTYPES[cfg.param_dtype]
        self._views: dict[int, tuple[Any, list]] = {}
        #: the per-layer cache dataflow: a layer-pattern config takes the
        #: per-layer path (tuple caches, a window and a RoPE theta a
        #: layer); other configs keep the stacked cache
        self.families = CF.layer_cache_families(cfg)
        self.layer_windows = CF.layer_windows(cfg)
        self.layer_thetas = CF.layer_rope_thetas(cfg)
        self.hetero = bool(getattr(cfg, "layer_pattern", ""))

    # ------------------------------------------------------------------ specs
    def param_specs(self):
        cfg = self.cfg
        specs: dict[str, Any] = {
            "embed": embed_specs(cfg.padded_vocab(), cfg.d_model),
            "layers": stack_layer_specs(
                T.decoder_layer_specs(cfg, cross=cfg.is_encoder_decoder),
                cfg.n_layers),
            "final_norm": rms_norm_spec(cfg.d_model),
        }
        if cfg.is_encoder_decoder:
            specs["encoder"] = stack_layer_specs(
                T.encoder_layer_specs(cfg), cfg.encoder_layers)
            specs["enc_norm"] = rms_norm_spec(cfg.d_model)
        return specs

    def init(self, generator: torch.Generator, device=None):
        """Random parameters drawn like the reference's ``_init_leaf``, in
        ``param_dtype``, on ``device`` (default: the model's device; the
        generator must live there too)."""
        device = resolve_device(device) if device is not None else self.device
        return init_params(self.param_specs(), generator, device,
                           self.param_dtype)

    def param_count(self) -> int:
        return param_count(self.param_specs())

    def cast_params(self, params):
        """The serving copy: every floating leaf in ``cfg.dtype`` on the
        model's device (leaves already there are returned as they are)."""
        return tree_map(lambda t: t.to(self.device, self.dtype)
                        if t.is_floating_point() else t.to(self.device),
                        params)

    def _layers(self, params, key: str = "layers") -> list:
        """Per-layer views of the stacked params (``key`` "encoder": the
        encoder's), memoized per tree and made again when any stacked
        leaf was replaced."""
        stacked = params[key]
        leaves = tree_leaves(stacked)
        hit = self._views.get(id(stacked))
        if hit is not None and len(hit[0]) == len(leaves) \
                and all(a is b for a, b in zip(hit[0], leaves)):
            return hit[1]
        views = T.layer_views(stacked, leaves[0].shape[0])
        if len(self._views) >= 4:
            self._views.pop(next(iter(self._views)))
        self._views[id(stacked)] = (leaves, views)
        return views

    def _head(self, params, x):
        x = rms_norm(x, params["final_norm"])
        return unembed(params["embed"]["tokens"], x)

    def _embed(self, params, tokens):
        return embed_lookup(params["embed"]["tokens"],
                            tokens.to(self.device), self.dtype)

    # ---------------------------------------------------------------- forward
    def _encode(self, params, src):
        """The encoder over frame embeddings src (B, Ssrc, d), final-normed."""
        x = T.encoder_stack(self._layers(params, "encoder"),
                            src.to(self.device, self.dtype), cfg=self.cfg)
        return rms_norm(x, params["enc_norm"])

    def forward(self, params, batch):
        """Full-sequence forward -> (logits (B, S, V), aux_loss: the MoE
        load-balance loss summed over layers, else 0).  An
        encoder-decoder reads ``batch["src"]``."""
        enc_out = self._encode(params, batch["src"]) \
            if self.cfg.is_encoder_decoder else None
        x = self._embed(params, batch["tokens"])
        x, aux = T.decoder_stack(self._layers(params), x, cfg=self.cfg,
                                 mlp_backend=self.kernel_plan.linked_matmul,
                                 enc_out=enc_out)
        return self._head(params, x), aux

    # ---------------------------------------------------------------- serving
    def cache_width(self, seq_len: int) -> int:
        """The dense ring's width: the window of a sliding stack, else the
        horizon."""
        w = self.cfg.sliding_window or seq_len
        return min(w, seq_len)

    def _stack(self, one: T.LayerCache) -> T.LayerCache:
        """One layer's cache repeated along a leading layer axis (every
        leaf: KV and SSM state)."""
        L = self.cfg.n_layers

        def rep(tree):
            if isinstance(tree, torch.Tensor):
                return tree.expand(L, *tree.shape).clone()
            return type(tree)(*(rep(v) for v in tree))
        return rep(one)

    def init_caches(self, batch: int, seq_len: int, shards: int = 1,
                    src_len: int = 0):
        """Ring-buffer caches with a leading layer axis on every leaf — or,
        for a layer-pattern stack, a tuple of per-layer caches at their
        natural widths: a sliding layer's ring is window-sized, a global
        layer's spans the horizon (masked slots add exact zero terms, so
        the widths leave the softmax's bits alone).  ``shards``: a
        concat-TP rank's caches, at ``n_kv_heads / shards`` kv heads;
        ``src_len``: an encoder-decoder's source frames (its cross K/V)."""
        if self.hetero:
            return tuple(
                T.init_layer_cache(self.cfg, batch,
                                   min(w, seq_len) if w else seq_len,
                                   self.dtype, self.device, shards, src_len)
                for w in self.layer_windows)
        return self._stack(T.init_layer_cache(
            self.cfg, batch, self.cache_width(seq_len), self.dtype,
            self.device, shards, src_len))

    def init_paged_caches(self, batch: int, *, pool_blocks: int,
                          block_size: int, max_blocks: int,
                          ring_pool_blocks: int | None = None,
                          ring_max_blocks: int | None = None,
                          shards: int = 1):
        """Block-paged caches: one pool per layer (plus its write sink,
        see ``attention.PagedKVCache``) and per-slot block tables.

        By the layers' cache families: all-full stacks get the classic
        pool, all-sliding stacks the wraparound ring pool (window-sized
        tables), and a mixed stack both, a tuple of per-layer caches whose
        ring layers take ``ring_pool_blocks`` / ``ring_max_blocks`` (the
        two kinds have separate block-id spaces, as ``MixedKVPool``'s
        pools do).  ``shards`` as in :meth:`init_caches`."""
        cfg = self.cfg
        if not CF.supports_paged(cfg):
            raise NotImplementedError(
                "paged KV needs attention-only cache families "
                f"(full or sliding per layer), not {CF.family_label(cfg)}")
        kind = CF.paged_kind(cfg)
        if kind == "mixed" and (ring_pool_blocks is None
                                or ring_max_blocks is None):
            raise ValueError(
                "a mixed sliding+global stack needs its ring pool "
                "geometry (ring_pool_blocks/ring_max_blocks) alongside "
                "the classic pool's")
        if self.hetero:
            # every layer-pattern stack runs the per-layer path; a uniform
            # pattern shares one pool, its ring geometry the main one's
            rpb = pool_blocks if ring_pool_blocks is None \
                else ring_pool_blocks
            rmb = max_blocks if ring_max_blocks is None else ring_max_blocks
            return tuple(
                T.init_paged_layer_cache(
                    cfg, batch,
                    rpb if f.kv == "sliding" else pool_blocks, block_size,
                    rmb if f.kv == "sliding" else max_blocks, self.dtype,
                    self.device,
                    kind="ring" if f.kv == "sliding" else "paged",
                    shards=shards)
                for f in self.families)
        return self._stack(T.init_paged_layer_cache(
            cfg, batch, pool_blocks, block_size, max_blocks, self.dtype,
            self.device, kind=kind, shards=shards))

    def _layer_caches(self, caches) -> list:
        """Per-layer views of the caches (a layer-pattern stack's tuple
        holds them already)."""
        if type(caches) is tuple:
            return list(caches)
        return T.layer_views(caches, self.cfg.n_layers)

    def _layer_kw(self, i: int) -> dict:
        """Layer ``i``'s window and RoPE theta on the per-layer path (the
        config's otherwise)."""
        if not self.hetero:
            return {}
        return {"window": self.layer_windows[i],
                "rope_theta": self.layer_thetas[i]}

    def _run_layers(self, params, caches, x, attn, ssm, mlp_backend: str,
                    shard_axis=None, cross=None):
        """Every layer's token mixing, by family, then (but for ``ssm``)
        its FFN (:func:`~.transformer.ffn`): ``attn(p, h, kv,
        **layer_args)`` attends layer ``i`` over its KV view with its
        window and theta, ``ssm(p, h, sc)`` runs its Mamba2 mixer over its
        SSM state view; a hybrid layer runs both on the same normed input
        and mean-fuses them; ``cross(p, x, c)`` (an encoder-decoder's) is
        the cross-attention residual over layer ``i``'s cache view.
        ``shard_axis``: the concat-TP mesh the MLP gathers over."""
        cfg = self.cfg
        for i, (lp, c) in enumerate(zip(self._layers(params),
                                        self._layer_caches(caches))):
            h = rms_norm(x, lp["norm1"])
            if cfg.family == "ssm":
                x = x + ssm(lp["ssm"], h, c.ssm)
                continue
            att = attn(lp["attn"], h, c.kv, **self._layer_kw(i))
            if cfg.family == "hybrid":
                att = T.fuse_hybrid(lp, att, ssm(lp["ssm"], h, c.ssm))
            x = x + att
            if cross is not None:
                x = x + cross(lp, x, c)
            y, _ = T.ffn(lp, rms_norm(x, lp["norm2"]), cfg=cfg,
                         mlp_backend=mlp_backend, shard_axis=shard_axis)
            x = x + y
        return x

    def prefill_step(self, params, batch, max_len: int = 0, plan=None):
        """Run the prompt -> (last-position logits (B, V), fresh caches).

        ``max_len`` sizes the cache for the decode horizon.
        ``batch["lengths"]`` (B,) makes this a right-padded multi-sequence
        prefill: per-row logits come from position ``lengths[b]-1``;
        attention-only families alone (a recurrent scan cannot stop at a
        per-row length: the engine groups equal-length prompts instead).
        ``plan`` overrides ``self.kernel_plan`` for this call."""
        cfg = self.cfg
        plan = plan if plan is not None else self.kernel_plan
        tokens = batch["tokens"].to(self.device)
        lengths = batch.get("lengths")
        if lengths is not None and not cfg.attention_only:
            raise NotImplementedError(
                "padded-batch prefill (lengths=...) needs attention-only "
                f"layers; {cfg.family} carries recurrent state through the "
                "padded tail")
        if lengths is not None:
            lengths = lengths.to(self.device)
        B, S = tokens.shape
        cross = None
        src_len = 0
        if cfg.is_encoder_decoder:
            enc_out = self._encode(params, batch["src"])
            src_len = enc_out.shape[1]

            def cross(lp, x, c):
                kv = T.cross_kv(lp["cross_attn"], enc_out)
                c.cross_k.copy_(kv[0])
                c.cross_v.copy_(kv[1])
                return T.cross_attend(lp, x, kv, cfg=cfg)
        x = self._embed(params, tokens)
        caches = self.init_caches(B, max(max_len, S), src_len=src_len)

        def ssm(p, h, sc):
            y, state = SSM.mamba2_block(p, h, cfg=cfg, return_state=True)
            sc.state.copy_(state)
            sc.conv.copy_(SSM.conv_tail(p, h, cfg))
            return y
        x = self._run_layers(
            params, caches, x,
            lambda p, h, kv, **kw: A.prefill_into_cache(
                p, h, kv, cfg=cfg, lengths=lengths, **kw)[0],
            ssm, plan.linked_matmul, cross=cross)
        if lengths is None:
            x = x[:, -1:]
        else:
            idx = (lengths - 1).clamp(0, S - 1).long()
            x = torch.gather(x, 1, idx[:, None, None].expand(B, 1, x.shape[2]))
        return self._head(params, x)[:, 0], caches

    def prefill_chunk(self, params, caches, tokens, offsets, n_new,
                      plan=None, shard_axis=None):
        """Advance a chunked prefill by up to C tokens per row, in place.

        tokens: (B, C) right-padded; offsets: (B,) tokens already
        prefilled; n_new: (B,) valid tokens (0 = bystander, untouched).
        Returns (logits at each row's last valid chunk position (B, V),
        caches).  B is the full slot batch.  ``plan`` overrides
        ``self.kernel_plan`` for this call.  ``shard_axis``: the
        concat-TP mesh when ``params`` / ``caches`` are one rank's shards
        (``repro_torch.distributed.tp``); the logits are every rank's."""
        cfg = self.cfg
        if not CF.supports_chunked_prefill(cfg):
            raise NotImplementedError(
                f"chunked prefill needs decoder-only cache families, not "
                f"{cfg.family}")
        plan = plan if plan is not None else self.kernel_plan
        tokens = tokens.to(self.device)
        offsets = offsets.to(self.device, torch.int32)
        n_new = n_new.to(self.device, torch.int32)
        B, C = tokens.shape
        x = self._embed(params, tokens)
        x = self._run_layers(
            params, caches, x,
            lambda p, h, kv, **kw: _chunk_fn(kv)(
                p, h, kv, cfg=cfg, offsets=offsets, n_new=n_new,
                shard_axis=shard_axis, **kw)[0],
            lambda p, h, sc: SSM.mamba2_chunk_update(
                p, h, sc, cfg=cfg, n_new=n_new, backend=plan.ssm_scan)[0],
            plan.linked_matmul, shard_axis)
        idx = (n_new - 1).clamp(0, C - 1).long()
        x = torch.gather(x, 1, idx[:, None, None].expand(B, 1, x.shape[2]))
        return self._head(params, x)[:, 0], caches

    def serve_step(self, params, caches, tokens, live=None, plan=None,
                   shard_axis=None):
        """One decode step, in place.  tokens: (B, 1) -> (logits (B, V),
        caches).  ``live`` (B,) bool: only live rows write the cache; the
        logits of other rows are to be discarded.  ``plan`` overrides
        ``self.kernel_plan`` for this call; ``shard_axis`` as in
        :meth:`prefill_chunk`."""
        cfg = self.cfg
        plan = plan if plan is not None else self.kernel_plan
        if live is not None:
            live = live.to(self.device, torch.bool)
        x = self._embed(params, tokens)
        x, _ = T.decoder_stack_decode(
            self._layers(params), x, self._layer_caches(caches),
            cfg=cfg, dense_backend=plan.decode_dense,
            paged_backend=plan.decode_paged, ring_backend=plan.decode_ring,
            ssm_backend=plan.ssm_scan, mlp_backend=plan.linked_matmul,
            live=live,
            layer_windows=self.layer_windows if self.hetero else None,
            layer_thetas=self.layer_thetas if self.hetero else None,
            shard_axis=shard_axis)
        return self._head(params, x)[:, 0], caches

    def verify_step(self, params, caches, tokens, n_new, live=None,
                    plan=None, shard_axis=None):
        """Speculative verify: score ``K1`` positions per row, in place.
        tokens: (B, K1) = per row ``[pending, draft_1..draft_k]``
        right-padded; n_new: (B,) valid positions (0 = bystander row).
        Returns (logits (B, K1, V), caches with all n_new[b] tokens
        written — the engine rolls rejected suffixes back afterwards).

        A loop of K1 exact decode steps (:meth:`serve_step`), step ``i``
        with the live mask ``live & (i < n_new)`` computed on the device,
        so position ``i``'s logits are bit-identical to ``serve_step``
        after feeding the first ``i`` tokens; with K1 == 1 this is the
        decode step.  Chunked-prefill attention is not reused: its
        batched contraction runs in another order.  ``shard_axis`` as in
        :meth:`prefill_chunk`."""
        cfg = self.cfg
        if not CF.supports_spec(cfg):
            raise NotImplementedError(
                "speculative verify needs a uniform full-attention stack "
                "(rollback rewinds the cache by position), not "
                f"{CF.family_label(cfg)}")
        tokens = tokens.to(self.device)
        n_new = n_new.to(self.device, torch.int32)
        base_live = n_new > 0
        if live is not None:
            base_live = base_live & live.to(self.device, torch.bool)
        logits = [self.serve_step(params, caches, tokens[:, i:i + 1],
                                  live=base_live & (i < n_new),
                                  plan=plan, shard_axis=shard_axis)[0]
                  for i in range(tokens.shape[1])]
        return torch.stack(logits, dim=1), caches

    def rollback_cache_rows(self, caches, keep_len, rows):
        """Rewind slot rows ((B,) bool) to ``keep_len`` ((B,) int)
        context tokens, in place — the speculative rejection path.
        Dense: ring entries past keep_len are invalidated and the write
        pointer moves back; paged: a length truncation (the host-side
        pool frees strandable tail blocks separately)."""
        if type(caches) is tuple:
            raise NotImplementedError(
                "heterogeneous per-layer caches have no rollback path; "
                "supports_spec gates speculative decoding off for "
                "layer-pattern stacks")
        kv = caches.kv
        if not hasattr(kv, "length") or getattr(caches, "ssm", ()) != ():
            raise NotImplementedError(
                f"{self.cfg.family} caches carry recurrent state that "
                "cannot be rewound; speculative decoding needs an "
                "attention-only family")
        if hasattr(kv, "block_tables") and hasattr(kv, "positions"):
            raise NotImplementedError(
                "sliding-window ring caches cannot roll back: positions "
                "past the window were evicted by the wraparound write")
        keep_len = keep_len.to(self.device, torch.int32)
        rows = rows.to(self.device, torch.bool)
        if isinstance(kv, A.PagedKVCache):
            A.rollback_paged_kv_cache(kv, keep_len, rows)
        else:
            A.rollback_kv_cache(kv, keep_len, rows)
        return caches

    def reset_cache_rows(self, caches, rows):
        """Mark slot rows ``rows`` ((B,) bool) empty for refill, in place:
        validity metadata (positions -> -1, length -> 0, for every cache
        that carries positions: the dense ring and the ring pool) and the
        recurrent SSM state and conv register (-> 0); stale K/V payloads
        are dead once no position points at them, and a classic paged
        cache's rows are re-pointed at admission instead.  Stacked leaves
        carry a leading layer axis, a layer-pattern tuple's are
        batch-major."""
        rows = rows.to(self.device, torch.bool)
        per_layer = type(caches) is tuple
        lead = 1 if per_layer else 2

        def clear(leaf, value):
            m = rows.reshape((1,) * (lead - 1) + rows.shape
                             + (1,) * (leaf.dim() - lead))
            leaf.copy_(torch.where(m, value, leaf))
        for c in (caches if per_layer else (caches,)):
            kv = c.kv
            if hasattr(kv, "positions"):
                clear(kv.positions, -1)
                clear(kv.length, 0)
            if isinstance(c.ssm, SSM.SSMCache):
                clear(c.ssm.state, 0)
                clear(c.ssm.conv, 0)
        return caches


def _chunk_fn(kv):
    """The chunked-prefill attention of a cache's layout, chosen per layer:
    a mixed stack interleaves ring-paged and classic-paged layers."""
    if isinstance(kv, A.PagedRingKVCache):
        return A.prefill_chunk_into_ring_cache
    if isinstance(kv, A.PagedKVCache):
        return A.prefill_chunk_into_paged_cache
    return A.prefill_chunk_into_cache
