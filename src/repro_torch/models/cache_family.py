"""Per-layer cache-family descriptors: the serving stack's dataflow map.

The paper's core claim is that inference performance lives in the
*dataflow shape* of the graph, not in per-operator tuning.  On the cache
plane that shape is per layer: a full-attention layer grows KV with the
sequence, a sliding-window layer holds a bounded ring of the last
``window`` tokens, and an SSM layer carries constant-size recurrent
state with no KV at all.  Hybrid (hymba-style) stacks mix attention and
SSM state *within one layer*; a ``layer_pattern`` config (gemma3-style)
mixes sliding and global attention layers *across* the stack.

Before this module every serving component re-derived that shape from
``cfg.attention_only`` and rejected anything else with a family
``ValueError``.  Now each layer gets a :class:`CacheFamily` descriptor
and the engine/scheduler/pipeline dispatch through the predicates below:

* ``supports_chunked_prefill`` — can the stack run incremental prefill
  chunks against row-addressed caches?  True for every decoder-only
  family including SSM/hybrid (the masked SSD scan in ``models/ssm.py``
  makes constant-state layers chunkable).
* ``supports_paged`` — can the KV plane live in a shared block pool?
  True for attention-only stacks: all-full layers take the classic
  paged pool, all-sliding layers take the wraparound ring pool
  (window-sized block tables), and mixed stacks lease both kinds from
  a composed pool (``paged_kind == "mixed"``).  SSM/hybrid state is
  dense-per-slot.
* ``supports_spec`` — can speculative decoding roll the cache back?
  Only uniform full-attention stacks: rollback across an evicted
  sliding-window block is undefined (ROADMAP defers it) and SSM state
  updates are not reversible.

Each predicate has a ``*_of(fams)`` form over a raw descriptor tuple —
that form is the contract: it must answer (or raise) explicitly for
heterogeneous tuples rather than any/all-guessing, so a new config can
never silently get the wrong pool layout.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class CacheFamily:
    """What one decoder layer needs from the cache plane.

    ``kv`` is the attention cache shape: ``"full"`` (KV grows with the
    sequence up to the horizon), ``"sliding"`` (a bounded ring of the
    last ``window`` tokens), or ``"none"`` (no attention KV — pure
    SSM).  ``ssm`` marks constant-size recurrent state (SSD state +
    conv tail) alongside — or instead of — the KV cache.
    """
    kv: str = "full"            # "full" | "sliding" | "none"
    window: int = 0             # ring width when kv == "sliding"
    ssm: bool = False           # carries SSD state + conv tail

    def __post_init__(self):
        if self.kv not in ("full", "sliding", "none"):
            raise ValueError(f"unknown kv cache family {self.kv!r}")
        if self.kv == "sliding" and self.window <= 0:
            raise ValueError("sliding cache family needs window > 0")
        if self.kv == "none" and not self.ssm:
            raise ValueError("a layer with no KV must carry SSM state")


def layer_cache_families(cfg) -> tuple:
    """The per-layer cache descriptors for a config, length ``n_layers``.

    A non-empty ``cfg.layer_pattern`` ('S' = sliding, 'G' = global full
    attention, repeated over the stack) produces a heterogeneous tuple;
    otherwise every layer shares the one family derived from
    ``cfg.family``/``cfg.sliding_window`` as before.
    """
    if getattr(cfg, "layer_pattern", ""):
        return _pattern_families(cfg)
    if cfg.family == "ssm":
        fam = CacheFamily(kv="none", ssm=True)
    elif cfg.family == "hybrid":
        fam = CacheFamily(
            kv="sliding" if cfg.sliding_window else "full",
            window=cfg.sliding_window, ssm=True)
    elif cfg.sliding_window:
        fam = CacheFamily(kv="sliding", window=cfg.sliding_window)
    else:
        fam = CacheFamily(kv="full")
    return (fam,) * cfg.n_layers


def _pattern_families(cfg) -> tuple:
    """Expand ``cfg.layer_pattern`` over ``n_layers`` (repeating)."""
    pat = cfg.layer_pattern.upper()
    bad = sorted(set(pat) - set("SG"))
    if bad:
        raise ValueError(
            f"layer_pattern {cfg.layer_pattern!r} has unknown layer kinds "
            f"{bad}: only 'S' (sliding) and 'G' (global) are defined")
    if cfg.family in ("ssm", "hybrid") or cfg.attn_free \
            or cfg.is_encoder_decoder:
        raise ValueError(
            f"layer_pattern is only defined for decoder-only attention "
            f"stacks, not family {cfg.family!r}")
    if "S" in pat and not cfg.sliding_window:
        raise ValueError(
            f"layer_pattern {cfg.layer_pattern!r} has sliding layers but "
            "sliding_window == 0")
    sliding = CacheFamily(kv="sliding", window=cfg.sliding_window) \
        if "S" in pat else None
    full = CacheFamily(kv="full")
    return tuple(sliding if pat[i % len(pat)] == "S" else full
                 for i in range(cfg.n_layers))


def layer_windows(cfg) -> tuple:
    """Per-layer sliding-window width (0 = full attention), aligned with
    :func:`layer_cache_families`."""
    return tuple(f.window if f.kv == "sliding" else 0
                 for f in layer_cache_families(cfg))


def layer_rope_thetas(cfg) -> tuple:
    """Per-layer RoPE theta: sliding layers rotate with
    ``rope_theta_local``, global layers with ``rope_theta_global``
    (either falls back to ``cfg.rope_theta`` when 0/unset — homogeneous
    configs stay exactly on the single theta they always used)."""
    local = getattr(cfg, "rope_theta_local", 0.0) or cfg.rope_theta
    glob = getattr(cfg, "rope_theta_global", 0.0) or cfg.rope_theta
    return tuple(local if f.kv == "sliding" else glob
                 for f in layer_cache_families(cfg))


def kv_plan_window(cfg) -> int:
    """The sliding-window width the serving planner prices (0 = no layer
    slides).  Derived from the descriptors, *not* from the raw
    ``cfg.sliding_window`` field: a family whose layers ignore the field
    (e.g. pure SSM with ``sliding_window`` set) must not make the
    scheduler price a phantom window."""
    return max((f.window for f in layer_cache_families(cfg)
                if f.kv == "sliding"), default=0)


def supports_chunked_prefill(cfg) -> bool:
    """Chunked prefill needs row-addressed decoder caches: any
    decoder-only stack qualifies, including SSM/hybrid via the masked
    SSD chunk update (``ssm.mamba2_chunk_update``) — attention-free
    pure-SSM stacks (mamba2: ``n_heads == 0``) very much included;
    per-row stop lengths are exactly what the masked scan provides."""
    if cfg.is_encoder_decoder:
        return False
    return all(f.kv in ("full", "sliding", "none")
               for f in layer_cache_families(cfg))


def supports_paged(cfg) -> bool:
    """Block-pool KV needs attention-only layers (SSM state is dense
    per slot, never pooled).  All-full stacks use the classic paged
    pool, all-sliding stacks the wraparound ring pool, mixed stacks the
    composed classic+ring pool."""
    if cfg.is_encoder_decoder or cfg.attn_free:
        return False
    fams = layer_cache_families(cfg)
    return all(not f.ssm and f.kv in ("full", "sliding") for f in fams)


def paged_kind_of(fams) -> str:
    """Which pool layout a paged engine builds for a descriptor tuple:
    ``"paged"`` (classic, all-full), ``"ring"`` (wraparound window,
    all-sliding), or ``"mixed"`` (both kinds present — per-layer-kind
    leases).  Raises for tuples no block pool serves (SSM state, no-KV
    layers): the caller must gate on :func:`supports_paged` first —
    guessing here is how a global layer's KV would end up wrapped in a
    ring."""
    kinds = {f.kv for f in fams}
    if any(f.ssm for f in fams) or not kinds or not kinds <= {"full",
                                                             "sliding"}:
        raise ValueError(
            f"no paged-pool layout for cache families {sorted(kinds)}"
            f"{' with SSM state' if any(f.ssm for f in fams) else ''}")
    if kinds == {"full"}:
        return "paged"
    if kinds == {"sliding"}:
        return "ring"
    return "mixed"


def paged_kind(cfg) -> str:
    """:func:`paged_kind_of` over the config's descriptor tuple.  Only
    meaningful when :func:`supports_paged` is true."""
    return paged_kind_of(layer_cache_families(cfg))


def supports_spec_of(fams) -> bool:
    """Speculative decoding needs rollback on *every* layer: uniform
    full-attention KV only.  A mixed stack is explicitly unsupported —
    its sliding layers evict the blocks a rollback would restore."""
    return bool(fams) and all(f.kv == "full" and not f.ssm for f in fams)


def supports_spec(cfg) -> bool:
    """Speculative decoding needs rollback: uniform full-attention KV
    only.  Sliding windows evict the blocks a rollback would restore
    (deferred in ROADMAP); SSM state updates are not reversible; and the
    heterogeneous (layer-pattern) cache path carries tuple caches with no
    rollback implementation even when every layer happens to be 'G'."""
    return supports_spec_of(layer_cache_families(cfg)) \
        and not cfg.attn_free and not cfg.is_encoder_decoder \
        and not getattr(cfg, "layer_pattern", "")


def family_label_of(fams) -> str:
    """Human-readable dataflow-shape label for a descriptor tuple:
    heterogeneous attention tuples label ``"mixed"`` instead of
    collapsing onto whichever homogeneous label an any() happens to
    hit first."""
    if any(f.ssm for f in fams):
        return "hybrid" if any(f.kv != "none" for f in fams) else "ssm"
    kinds = {f.kv for f in fams}
    if kinds == {"sliding"}:
        return "sliding"
    if kinds == {"full"}:
        return "full"
    return "mixed"


def family_label(cfg) -> str:
    """Human-readable dataflow-shape label for errors and stats."""
    return family_label_of(layer_cache_families(cfg))
