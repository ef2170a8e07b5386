"""Model/run configuration system (the PyTorch port's own copy).

A verbatim copy of ``repro.configs.base``: the port imports nothing of the
JAX package, so both packages build one model from field-identical
``ModelConfig`` values.

Every assigned architecture gets a ``ModelConfig`` (one module per arch in
this package); ``reduced()`` derives the CPU smoke variant (≤2 layers,
d_model ≤ 512, ≤4 experts) from the same family so smoke tests exercise the
exact code path of the full config.
"""
from __future__ import annotations

import dataclasses
from typing import Any


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | vlm | audio
    n_layers: int
    d_model: int
    vocab: int
    n_heads: int = 0               # 0 => attention-free
    n_kv_heads: int = 0
    d_ff: int = 0
    head_dim: int = 0              # 0 => d_model // n_heads

    # attention flavor
    qk_norm: bool = False
    rope_fraction: float = 1.0     # chatglm3 "RoPE 2d": rotary on half the dims
    rope_theta: float = 10000.0
    sliding_window: int = 0        # 0 = full attention; >0 enables long_500k
    #: per-layer cache pattern for heterogeneous attention stacks, repeated
    #: over n_layers: 'S' = sliding-window layer (needs sliding_window > 0),
    #: 'G' = global full-attention layer.  "" = homogeneous (every layer
    #: derives its family from `family`/`sliding_window` as before).
    layer_pattern: str = ""
    #: gemma3-style per-kind RoPE wavelengths for pattern stacks: sliding
    #: ('S') layers rotate with the local theta, global ('G') layers with
    #: the global theta.  0 = fall back to `rope_theta` for that kind.
    rope_theta_local: float = 0.0
    rope_theta_global: float = 0.0
    max_len: int = 0               # serving-horizon hint (0 = unbounded);
                                   # reduced() clamps sliding_window to it
    logit_softcap: float = 0.0

    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False   # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.01

    # SSM (Mamba2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 128
    ssm_groups: int = 1

    # encoder-decoder (seamless)
    encoder_layers: int = 0

    # modality frontend stub: what input_specs() provides
    modality: str = "text"         # text | audio_frames | vision_tokens

    # numerics / memory policy
    dtype: str = "bfloat16"        # activation/compute dtype
    param_dtype: str = "float32"
    opt_dtype: str = "float32"     # float32 | bfloat16 | int8 (blockwise-quantized moments)
    remat: bool = True
    microbatch: int = 0            # 0 = no gradient accumulation
    scan_layers: bool = True       # False: unroll (dry-run calibration mode —
                                   # XLA cost analysis can't see scan trip counts)
    unroll_microbatch: bool = False  # python-loop grad accumulation (ditto)

    # sharding-rule overrides: tuple of (logical_axis, mesh_axis) pairs
    sharding_overrides: tuple = ()

    # provenance
    source: str = ""
    notes: str = ""

    # ---------------- derived ----------------
    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.n_heads if self.n_heads else 0

    @property
    def attn_free(self) -> bool:
        return self.n_heads == 0

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model if self.ssm_state else 0

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim if self.ssm_state else 0

    @property
    def is_encoder_decoder(self) -> bool:
        return self.encoder_layers > 0

    @property
    def attention_only(self) -> bool:
        """Every decoder layer mixes tokens through attention alone — the
        precondition for padded-batch and chunked prefill (a recurrent scan
        cannot stop at a per-row length; an encoder needs its own pass)."""
        return (not self.attn_free and self.family not in ("ssm", "hybrid")
                and not self.is_encoder_decoder)

    @property
    def sub_quadratic(self) -> bool:
        """Can this config decode with O(1)/O(window) memory per token?

        Derived from the per-layer cache descriptors: true iff no layer
        holds a full (linearly growing) KV cache.  A hybrid with
        ``sliding_window == 0`` has SSM state *and* full-attention KV, so
        its decode memory still grows with context — the old predicate's
        ``family == "hybrid" and sliding_window > 0`` clause was
        unreachable (subsumed by ``sliding_window > 0``) and invited
        reading hybrids as sub-quadratic unconditionally.  A mixed
        sliding+global pattern stack likewise stays linear: its global
        layers grow."""
        from repro_torch.models import cache_family as CF
        return all(f.kv != "full" for f in CF.layer_cache_families(self))

    def padded_vocab(self, multiple: int = 256) -> int:
        return -(-self.vocab // multiple) * multiple

    def param_count(self) -> int:
        """Approximate parameter count (embedding + layers + head)."""
        d, ff = self.d_model, self.d_ff
        hd = self.resolved_head_dim
        n = self.padded_vocab() * d * 2  # embed + lm head
        per_layer = 0
        if not self.attn_free:
            per_layer += d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d
        if self.ssm_state:
            di = self.ssm_inner
            proj = 2 * di + 2 * self.ssm_groups * self.ssm_state + self.ssm_heads
            per_layer += d * proj + di * d
        if self.n_experts:
            per_layer += self.n_experts * 3 * d * ff + d * self.n_experts
            if self.moe_dense_residual:
                per_layer += 3 * d * ff
        elif ff:
            per_layer += 3 * d * ff
        n += self.n_layers * per_layer
        if self.encoder_layers:
            enc_layer = d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d \
                + 2 * d * ff  # gelu mlp
            # decoder cross-attention
            n += self.encoder_layers * enc_layer
            n += self.n_layers * (d * hd * (self.n_heads + 2 * self.n_kv_heads) + self.n_heads * hd * d)
        return n

    def reduced(self) -> "ModelConfig":
        """CPU smoke variant of the same family (assignment requirement)."""
        d = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4) if self.n_heads else 0
        n_kv = min(self.n_kv_heads, max(1, n_heads // 2)) if self.n_kv_heads else 0
        # the reduced horizon bounds the reduced window: a smoke config
        # claiming a window wider than its own max_len would mask every
        # sliding-window code path (the ring would never wrap)
        max_len = min(self.max_len, 128) if self.max_len else 128
        window = min(self.sliding_window, 64, max_len) \
            if self.sliding_window else 0
        # a 2-layer smoke stack must keep every layer *kind* of a pattern
        # config: compress the pattern to its distinct kinds in order of
        # first appearance ("SSSSSG" -> "SG"), so the reduced stack still
        # mixes sliding and global layers instead of truncating to all-S
        pattern = "".join(dict.fromkeys(self.layer_pattern)) \
            if self.layer_pattern else ""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=2,
            encoder_layers=2 if self.encoder_layers else 0,
            d_model=d,
            n_heads=n_heads,
            n_kv_heads=n_kv,
            head_dim=(d // n_heads if n_heads else 0),
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            top_k=min(self.top_k, 2) if self.top_k else 0,
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else 64,
            ssm_chunk=16,
            sliding_window=window,
            layer_pattern=pattern,
            max_len=max_len,
            dtype="float32",
            param_dtype="float32",
            opt_dtype="float32",
            microbatch=0,
        )

    def long_context_variant(self, window: int = 8192) -> "ModelConfig":
        """Sliding-window variant used only for long_500k on dense archs."""
        if self.family == "ssm" or self.sliding_window:
            return self
        return dataclasses.replace(
            self, name=self.name + "-swa", sliding_window=window,
            notes=self.notes + " [sliding-window variant for long_500k]")


# ---------------------------------------------------------------------------
# Input shapes (assignment)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str   # train | prefill | decode


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524288, 1, "decode"),
}


_REGISTRY: dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if not _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def all_configs() -> dict[str, ModelConfig]:
    if not _REGISTRY:
        _load_all()
    return dict(_REGISTRY)


def _load_all() -> None:
    from . import (arctic_480b, chameleon_34b, chatglm3_6b, gemma3_1b,  # noqa: F401
                   granite_8b, hymba_1_5b, internlm2_20b, mamba2_370m,
                   olmoe_1b_7b, qwen3_1_7b, seamless_m4t_large_v2)
