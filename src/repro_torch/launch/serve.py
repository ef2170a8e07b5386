"""End-to-end serving driver of the port: scheduler-planned continuous
batching on one device (the card by default).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --requests 16 --prompt-len 512 --max-new 64 --slots 8 --max-len 2048

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --reduced --device cpu

The same flags as ``python -m repro.launch.serve``, plus ``--device``.
Weights are random, drawn on the device from ``--seed``
(``Model.init``).  Throughput counts the tokens requests actually
emitted.  Exits nonzero when a request did not complete or the batched
decode loop produced no throughput.  Flags for paths this slice does
not port (``--sliding-window``, ``--spec``, ``--mesh-shards`` > 1,
``--replicas`` > 1) raise ``NotImplementedError``.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ..configs.base import get_config
from ..models.model import Model
from ..serving import Request, SamplingParams, ServingEngine, settle_ticks


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--sliding-window", type=int, default=None)
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
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--top-k", type=int, default=0)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--eos-id", type=int, default=-1)
    ap.add_argument("--priority-mix", default="0")
    ap.add_argument("--mesh-shards", type=int, default=1)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    return ap


def build_engine(args, model=None, params=None,
                 kernel_plan=None) -> ServingEngine:
    """The engine the flags describe (``model``/``params`` may be given
    to share weights across engines; ``kernel_plan`` pins the routing,
    None lets ``kernel_select`` choose)."""
    if args.sliding_window is not None:
        raise NotImplementedError(
            "--sliding-window is ported by ROADMAP queue 1 item 7")
    if args.spec != "off":
        raise NotImplementedError("--spec is ported by ROADMAP queue 1 item 5")
    if args.mesh_shards > 1 or args.replicas > 1:
        raise NotImplementedError(
            "--mesh-shards/--replicas are ported by ROADMAP queue 1 item 8")
    if model is None:
        cfg = get_config(args.arch)
        if args.reduced:
            cfg = cfg.reduced()
        model = Model(cfg, device=args.device)
    if params is None:
        gen = torch.Generator(device=model.device).manual_seed(args.seed)
        params = model.init(gen)
    prefill_mode = args.prefill_mode
    if args.kv == "paged" and prefill_mode is None:
        prefill_mode = "chunked"  # the only mode a block pool can execute
    return ServingEngine(model, params, slots=args.slots,
                         max_len=args.max_len, chunk=args.chunk,
                         eos_id=args.eos_id, prefill_mode=prefill_mode,
                         replan_every=args.replan_every, kv=args.kv,
                         kv_block_size=args.kv_block_size,
                         kv_pool_blocks=args.kv_pool_blocks,
                         kernel_plan=kernel_plan)


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
    if "kv_pool" in stats:
        kp = stats["kv_pool"]
        print(f"kv pool: {kp['pool_blocks']} x {kp['block_size']}-token "
              f"blocks, {kp['registered_prefixes']} cached prefixes, "
              f"{kp['prefill_tokens_saved']} prefill tokens saved, "
              f"{kp['gated_requests']} requests block-gated")
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
