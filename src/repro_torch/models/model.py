"""Top-level model: parameters and the serving steps, in PyTorch.

The counterpart of ``repro.models.model.Model`` for the dense
full-attention family: ``param_specs``, ``init``, ``forward``,
``prefill_step``, ``prefill_chunk``, ``serve_step``, ``init_caches``,
``init_paged_caches`` and ``reset_cache_rows``.  The parameter tree is
the reference's (same nested dict, names, shapes and stacked leading
layer axis), so ``repro_torch.convert`` carries reference weights over
leaf for leaf.

Differences of idiom, not of result:

* caches are updated **in place** and returned; a decode step writes K/V,
  positions and lengths only for live rows (the reference writes every
  row and restores the dead ones wholesale);
* ``cast_params`` makes one serving copy in ``cfg.dtype`` (the reference
  casts fp32 params at every use — the same numbers);
* the model lives on one ``device`` (default ``"cuda"``); asking for
  CUDA without a card raises.

Training (``loss_fn``, ``train_step``) is ROADMAP queue 1 item 10, and
speculative verify/rollback item 5.
"""
from __future__ import annotations

from typing import Any

import torch

from .. import resolve_device
from . import attention as A
from . import transformer as T
from .layers import (embed_lookup, embed_specs, init_params, param_count,
                     rms_norm, rms_norm_spec, stack_layer_specs, swiglu,
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

    # ------------------------------------------------------------------ specs
    def param_specs(self):
        cfg = self.cfg
        return {
            "embed": embed_specs(cfg.padded_vocab(), cfg.d_model),
            "layers": stack_layer_specs(T.decoder_layer_specs(cfg),
                                        cfg.n_layers),
            "final_norm": rms_norm_spec(cfg.d_model),
        }

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

    def _layers(self, params) -> list:
        """Per-layer views of the stacked params, memoized per tree."""
        stacked = params["layers"]
        hit = self._views.get(id(stacked))
        if hit is not None and hit[0] is stacked:
            return hit[1]
        views = T.layer_views(stacked, self.cfg.n_layers)
        if len(self._views) >= 2:
            self._views.pop(next(iter(self._views)))
        self._views[id(stacked)] = (stacked, views)
        return views

    def _head(self, params, x):
        x = rms_norm(x, params["final_norm"])
        return unembed(params["embed"]["tokens"], x)

    def _embed(self, params, tokens):
        return embed_lookup(params["embed"]["tokens"],
                            tokens.to(self.device), self.dtype)

    # ---------------------------------------------------------------- forward
    def forward(self, params, batch):
        """Full-sequence forward -> (logits (B, S, V), aux_loss)."""
        x = self._embed(params, batch["tokens"])
        x = T.decoder_stack(self._layers(params), x, cfg=self.cfg,
                            mlp_backend=self.kernel_plan.linked_matmul)
        return self._head(params, x), torch.zeros((), device=x.device)

    # ---------------------------------------------------------------- serving
    def cache_width(self, seq_len: int) -> int:
        return seq_len            # full attention: the ring spans the horizon

    def _stack(self, one: T.LayerCache) -> T.LayerCache:
        """One layer's cache repeated along a leading layer axis."""
        L = self.cfg.n_layers
        return T.LayerCache(kv=type(one.kv)(
            *(t.expand(L, *t.shape).clone() for t in one.kv)))

    def init_caches(self, batch: int, seq_len: int) -> T.LayerCache:
        """Ring-buffer caches with a leading layer axis on every leaf."""
        return self._stack(T.init_layer_cache(
            self.cfg, batch, self.cache_width(seq_len), self.dtype,
            self.device))

    def init_paged_caches(self, batch: int, *, pool_blocks: int,
                          block_size: int, max_blocks: int) -> T.LayerCache:
        """Block-paged caches: one pool per layer (plus its write sink,
        see ``attention.PagedKVCache``) and per-slot block tables."""
        return self._stack(T.init_paged_layer_cache(
            self.cfg, batch, pool_blocks, block_size, max_blocks, self.dtype,
            self.device))

    @staticmethod
    def _is_paged(caches) -> bool:
        return isinstance(caches.kv, A.PagedKVCache)

    def _block(self, lp, h, attn, mlp_backend: str):
        """Residual attention then residual SwiGLU for one layer."""
        h = h + attn(lp["attn"], rms_norm(h, lp["norm1"]))
        return h + swiglu(lp["mlp"], rms_norm(h, lp["norm2"]), mlp_backend)

    def prefill_step(self, params, batch, max_len: int = 0, plan=None):
        """Run the prompt -> (last-position logits (B, V), fresh caches).

        ``max_len`` sizes the cache for the decode horizon.
        ``batch["lengths"]`` (B,) makes this a right-padded multi-sequence
        prefill: per-row logits come from position ``lengths[b]-1``.
        ``plan`` overrides ``self.kernel_plan`` for this call."""
        cfg = self.cfg
        plan = plan if plan is not None else self.kernel_plan
        tokens = batch["tokens"].to(self.device)
        lengths = batch.get("lengths")
        if lengths is not None:
            lengths = lengths.to(self.device)
        B, S = tokens.shape
        x = self._embed(params, tokens)
        caches = self.init_caches(B, max(max_len, S))
        for lp, c in zip(self._layers(params),
                         T.layer_views(caches, cfg.n_layers)):
            x = self._block(lp, x, lambda p, h, c=c: A.prefill_into_cache(
                p, h, c.kv, cfg=cfg, lengths=lengths)[0],
                plan.linked_matmul)
        if lengths is None:
            x = x[:, -1:]
        else:
            idx = (lengths - 1).clamp(0, S - 1).long()
            x = torch.gather(x, 1, idx[:, None, None].expand(B, 1, x.shape[2]))
        return self._head(params, x)[:, 0], caches

    def prefill_chunk(self, params, caches, tokens, offsets, n_new,
                      plan=None):
        """Advance a chunked prefill by up to C tokens per row, in place.

        tokens: (B, C) right-padded; offsets: (B,) tokens already
        prefilled; n_new: (B,) valid tokens (0 = bystander, untouched).
        Returns (logits at each row's last valid chunk position (B, V),
        caches).  B is the full slot batch.  ``plan`` overrides
        ``self.kernel_plan`` for this call."""
        cfg = self.cfg
        plan = plan if plan is not None else self.kernel_plan
        tokens = tokens.to(self.device)
        offsets = offsets.to(self.device, torch.int32)
        n_new = n_new.to(self.device, torch.int32)
        B, C = tokens.shape
        fn = A.prefill_chunk_into_paged_cache if self._is_paged(caches) \
            else A.prefill_chunk_into_cache
        x = self._embed(params, tokens)
        for lp, c in zip(self._layers(params),
                         T.layer_views(caches, cfg.n_layers)):
            x = self._block(lp, x, lambda p, h, c=c: fn(
                p, h, c.kv, cfg=cfg, offsets=offsets, n_new=n_new)[0],
                plan.linked_matmul)
        idx = (n_new - 1).clamp(0, C - 1).long()
        x = torch.gather(x, 1, idx[:, None, None].expand(B, 1, x.shape[2]))
        return self._head(params, x)[:, 0], caches

    def serve_step(self, params, caches, tokens, live=None, plan=None):
        """One decode step, in place.  tokens: (B, 1) -> (logits (B, V),
        caches).  ``live`` (B,) bool: only live rows write the cache; the
        logits of other rows are to be discarded.  ``plan`` overrides
        ``self.kernel_plan`` for this call."""
        cfg = self.cfg
        plan = plan if plan is not None else self.kernel_plan
        if live is not None:
            live = live.to(self.device, torch.bool)
        x = self._embed(params, tokens)
        x, _ = T.decoder_stack_decode(
            self._layers(params), x, T.layer_views(caches, cfg.n_layers),
            cfg=cfg, dense_backend=plan.decode_dense,
            paged_backend=plan.decode_paged, mlp_backend=plan.linked_matmul,
            live=live)
        return self._head(params, x)[:, 0], caches

    def reset_cache_rows(self, caches, rows):
        """Mark slot rows ``rows`` ((B,) bool) empty for refill, in place:
        only validity metadata changes (positions -> -1, length -> 0); a
        paged cache's rows are re-pointed at admission instead."""
        kv = caches.kv
        if isinstance(kv, A.KVCache):
            rows = rows.to(self.device, torch.bool)
            kv.positions.copy_(torch.where(rows[None, :, None], -1,
                                           kv.positions))
            kv.length.copy_(torch.where(rows[None, :], 0, kv.length))
        return caches
