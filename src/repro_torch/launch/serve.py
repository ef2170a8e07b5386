"""End-to-end serving driver of the port: scheduler-planned continuous
batching on one device (the card by default).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --requests 16 --prompt-len 512 --max-new 64 --slots 8 --max-len 2048

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --reduced --device cpu

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --reduced --device cpu --spec ngram --spec-k 4

    PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma3-1b \
        --reduced --device cpu --kv paged

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --reduced --sliding-window 32 --kv paged --device cpu

    PYTHONPATH=src python -m repro_torch.launch.serve --arch hymba-1.5b \
        --reduced --device cpu

The same flags as ``python -m repro.launch.serve``, plus ``--device``.
Weights are random, drawn on the device from ``--seed``
(``Model.init``); ``--spec draft`` drafts with the arch's reduced config
(at the target's vocabulary, weights from ``--seed`` + 1).  The decode
and verify steps run as CUDA graphs on the card (``ServingEngine``'s
``graphed``).  Throughput counts the tokens requests actually emitted.
``--sliding-window W`` serves the arch with a W-token sliding window
(named ``<arch>-swa<W>``, as the reference names it): per-request KV
stays O(W), and with ``--kv paged`` the pool runs window-sized ring
tables; a layer-pattern arch (gemma3-1b) runs its own windows, paged
through a ``MixedKVPool``.  The recurrent archs (``mamba2-370m``,
``hymba-1.5b``) carry constant-size SSM state per slot (the report's
``cache`` line: ``kv_growth constant`` and the bytes of each cache kind)
and serve dense KV only: ``--kv paged`` fails with the engine's
``ValueError``.  Exits nonzero when a request did not complete
or the batched decode loop produced no throughput.  Flags for paths this
slice does not port (``--mesh-shards`` > 1, ``--replicas`` > 1) raise
``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import numpy as np
import torch

from ..configs.base import get_config
from ..models.model import Model
from ..serving import Request, SamplingParams, ServingEngine, settle_ticks
from ..serving.speculative import SpecParams


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--sliding-window", type=int, default=None,
                    help="serve the arch with this sliding-attention "
                         "window (tokens): per-request KV stays O(window); "
                         "with --kv paged the pool runs window-sized ring "
                         "block tables")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--chunk", type=int, default=32)
    ap.add_argument("--prefill-mode", default=None,
                    choices=[None, "chunked", "batched", "serial"])
    ap.add_argument("--replan-every", type=int, default=32)
    ap.add_argument("--kv", default="dense", choices=["dense", "paged"])
    ap.add_argument("--kv-block-size", type=int, default=None)
    ap.add_argument("--kv-pool-blocks", type=int, default=None)
    ap.add_argument("--spec", default="off", choices=["off", "ngram", "draft"])
    ap.add_argument("--spec-k", type=int, default=None)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--eos-id", type=int, default=-1)
    ap.add_argument("--priority-mix", default="0")
    ap.add_argument("--mesh-shards", type=int, default=1)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def build_config(args):
    """The arch's config, reduced and with ``--sliding-window`` applied
    (renamed ``<arch>-swa<W>``, as the reference does)."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    if args.sliding_window is not None:
        if args.sliding_window <= 0:
            raise SystemExit("--sliding-window must be positive")
        cfg = dataclasses.replace(
            cfg, name=f"{cfg.name}-swa{args.sliding_window}",
            sliding_window=args.sliding_window)
    return cfg


def build_draft(cfg, device, seed: int):
    """``--spec draft``'s proposer: the arch's reduced config at the
    target's vocabulary (its embedding is indexed by the target's
    tokens), random weights from ``seed``."""
    draft = Model(dataclasses.replace(cfg.reduced(), vocab=cfg.vocab),
                  device=device)
    gen = torch.Generator(device=draft.device).manual_seed(seed)
    return draft, draft.init(gen)


def build_engine(args, model=None, params=None, kernel_plan=None,
                 graphed: bool = True, draft=None) -> ServingEngine:
    """The engine the flags describe (``model``/``params`` may be given
    to share weights across engines, ``draft`` a ``(model, params)``
    proposer for ``--spec draft``; ``kernel_plan`` pins the routing,
    None lets ``kernel_select`` choose; ``graphed=False`` runs the
    per-tick steps eagerly, for timing and parity)."""
    if args.mesh_shards > 1 or args.replicas > 1:
        raise NotImplementedError(
            "--mesh-shards/--replicas are ported by ROADMAP queue 1 item 8")
    if model is None:
        model = Model(build_config(args), device=args.device)
    if params is None:
        gen = torch.Generator(device=model.device).manual_seed(args.seed)
        params = model.init(gen)
    prefill_mode = args.prefill_mode
    if args.kv == "paged" and prefill_mode is None:
        prefill_mode = "chunked"  # the only mode a block pool can execute
    spec_kw = {}
    if args.spec != "off":
        spec_kw["spec"] = SpecParams(mode=args.spec, k=args.spec_k)
        if args.spec == "draft":
            if draft is None:
                draft = build_draft(model.cfg, model.device, args.seed + 1)
            spec_kw["draft_model"], spec_kw["draft_params"] = draft
    return ServingEngine(model, params, slots=args.slots,
                         max_len=args.max_len, chunk=args.chunk,
                         eos_id=args.eos_id, prefill_mode=prefill_mode,
                         replan_every=args.replan_every, kv=args.kv,
                         kv_block_size=args.kv_block_size,
                         kv_pool_blocks=args.kv_pool_blocks,
                         kernel_plan=kernel_plan, graphed=graphed, **spec_kw)


def make_requests(args, vocab: int) -> list[Request]:
    priorities = [int(x) for x in args.priority_mix.split(",")]
    rng = np.random.default_rng(args.seed)
    return [Request(
        rid=rid,
        prompt=rng.integers(0, vocab, size=args.prompt_len).astype(np.int32),
        max_new_tokens=args.max_new,
        sampling=SamplingParams(temperature=args.temperature,
                                top_k=args.top_k, top_p=args.top_p,
                                seed=args.seed + rid),
        priority=priorities[rid % len(priorities)])
        for rid in range(args.requests)]


def serve(engine: ServingEngine, reqs: list[Request], args) -> dict:
    """Submit (late high-priority arrivals after the batch settles), run
    to completion, and return the engine's stats plus wall time."""
    base = min(r.priority for r in reqs)
    t0 = time.perf_counter()
    for r in reqs:
        if r.priority == base:
            engine.submit(r)
    vips = [r for r in reqs if r.priority > base]
    if vips:
        for _ in range(settle_ticks(args.prompt_len, args.chunk)):
            engine.step()
        for r in vips:
            engine.submit(r)
    engine.run()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    stats = engine.stats()
    stats["wall_s"] = time.perf_counter() - t0
    return stats


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    engine = build_engine(args)
    cfg = engine.model.cfg
    if cfg.is_encoder_decoder:
        raise SystemExit("serve drives decoder-only archs")
    reqs = make_requests(args, cfg.vocab)
    stats = serve(engine, reqs, args)
    dt = stats["wall_s"]
    total_tokens = sum(len(r.generated) for r in reqs)
    decode_tps = stats.get("decode_tokens_per_s", 0.0)
    dev = engine.device
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"served {args.requests} requests, {total_tokens} tokens in "
          f"{dt:.2f}s ({total_tokens / dt:.1f} tok/s overall, "
          f"{decode_tps:.1f} tok/s batched decode) on {where}")
    print(f"policy: temperature={args.temperature} top_k={args.top_k} "
          f"top_p={args.top_p} eos_id={args.eos_id}; "
          f"{stats['scheduler']['preempted']} preemptions")
    print(f"plan: {stats['plan']} (prefill_mode={stats['prefill_mode']}, "
          f"kv={stats['kv']})")
    print(f"kernel plan: {stats['kernel_plan']}")
    print(f"cache: kv_growth {stats['plan']['kv_growth']}; "
          + ", ".join(f"{k} {v / 1e6:.1f} MB"
                      for k, v in stats["cache_bytes"].items()))
    if "spec" in stats:
        sp = stats["spec"]
        # emissions and draft traffic are different currencies: report
        # them side by side, never summed
        print(f"spec: mode={sp['mode']} k={sp['k']} — "
              f"{total_tokens} tokens emitted, "
              f"{sp['drafts_proposed']} drafts proposed "
              f"({sp['drafts_proposed'] / dt:.1f} drafts/s), "
              f"{sp['drafts_accepted']} accepted "
              f"(accept ratio {sp['accept_rate']:.2f}), "
              f"{sp['spec_tokens']} tokens via {sp['verify_calls']} "
              f"verify dispatches")
    for name, g in (stats.get("graphs", {}) if dev.type == "cuda"
                    else {}).items():
        print(f"  graph {name}: {g['captures']} captures "
              f"({g['capture_s']:.2f} s, pool +{g['pool_bytes'] / 2**20:.0f}"
              f" MiB), {g['replays']} replays")
    if "kv_pool" in stats:
        kp = stats["kv_pool"]
        kind = kp.get("kind", "ring" if "kv_window" in stats else "classic")
        print(f"kv pool ({kind}): {kp['pool_blocks']} x "
              f"{kp['block_size']}-token blocks, "
              f"{kp['registered_prefixes']} cached prefixes, "
              f"{kp['prefill_tokens_saved']} prefill tokens saved, "
              f"{kp['gated_requests']} requests block-gated"
              + (f", window {stats['kv_window']}" if "kv_window" in stats
                 else ""))
    for stage, s in stats["stages"].items():
        print(f"  stage {stage}: {s['calls']} calls, "
              f"mean {s['mean_s'] * 1e3:.2f} ms")
    if not all(r.done for r in reqs):
        print("FAIL: not every request completed", file=sys.stderr)
        return 1
    if not decode_tps > 0:
        print("FAIL: batched decode produced no throughput", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
