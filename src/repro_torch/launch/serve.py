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

    PYTHONPATH=src python -m repro_torch.launch.serve --arch olmoe-1b-7b \
        --reduced --device cpu --kv paged

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \
        --reduced --device cpu --mesh-shards 2 --replicas 2 --kv paged

The same flags as ``python -m repro.launch.serve``, plus ``--device``
and ``--rank-timeout``.  Weights are random, drawn on the device from
``--seed`` (``Model.init``); ``--spec draft`` drafts with the arch's
reduced config (at the target's vocabulary, weights from ``--seed`` +
1).  The decode and verify steps run as CUDA graphs on the card
(``ServingEngine``'s ``graphed``).  Throughput counts the tokens
requests actually emitted.  ``--sliding-window W`` serves the arch with
a W-token sliding window (named ``<arch>-swa<W>``, as the reference
names it): per-request KV stays O(W), and with ``--kv paged`` the pool
runs window-sized ring tables; a layer-pattern arch (gemma3-1b) runs
its own windows, paged through a ``MixedKVPool``.  The recurrent archs
(``mamba2-370m``, ``hymba-1.5b``) carry constant-size SSM state per
slot (the report's ``cache`` line: ``kv_growth constant`` and the bytes
of each cache kind) and serve dense KV only: ``--kv paged`` fails with
the engine's ``ValueError``.  An MoE arch (``olmoe-1b-7b``,
reduced ``arctic-480b``) serves as a dense one does.  An
encoder-decoder arch (``seamless-m4t-large-v2``) is refused: the
engine drives decoder-only stacks, and ``repro_torch.launch.
translate_audio`` serves it.

``--mesh-shards N`` serves each engine concat-TP over N ranks
(``repro_torch.distributed.tp``): the command spawns N processes
(``launch.mesh.spawn_ranks``), one a card (``cuda:0`` .. ``cuda:N-1``;
fewer visible cards exit 2, with no fallback to one device) or all on
the host with ``--device cpu`` (gloo); every rank draws the same full
weights from ``--seed`` and keeps its slice, runs its steps eagerly,
and rank 0 prints (``mesh:`` and ``per shard:`` lines).  ``--replicas
R`` puts R engines behind a ``ReplicaRouter`` (prefix affinity, then
least load; ``router:`` and ``replica i:`` lines); the two compose.  A
rank that fails, or ranks that outlive ``--rank-timeout`` seconds, fail
the run.  Exits nonzero when a request did not complete or the batched
decode loop produced no throughput.
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
from ..serving import (ReplicaRouter, Request, SamplingParams,
                       ServingEngine, settle_ticks)
from ..serving.speculative import SpecParams
from .mesh import default_devices, spawn_ranks


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
    ap.add_argument("--mesh-shards", type=int, default=1,
                    help="concat-TP ranks per engine, one process each")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas behind one router")
    ap.add_argument("--rank-timeout", type=float, default=3600.0,
                    help="seconds the mesh ranks may take, all told")
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
                 graphed: bool | None = None, draft=None,
                 mesh=None) -> ServingEngine:
    """The engine the flags describe (``model``/``params`` may be given
    to share weights across engines, ``draft`` a ``(model, params)``
    proposer for ``--spec draft``; ``kernel_plan`` pins the routing,
    None lets ``kernel_select`` choose; ``graphed=False`` runs the
    per-tick steps eagerly, for timing and parity, None takes the
    engine's default; ``mesh``: this rank's concat-TP mesh, with
    ``params`` the full tree each rank slices)."""
    if model is None:
        device = mesh.device if mesh is not None else args.device
        model = Model(build_config(args), device=device)
    if params is None:
        gen = torch.Generator(device=model.device).manual_seed(args.seed)
        params = model.init(gen)
    prefill_mode = args.prefill_mode
    if (args.kv == "paged" or args.mesh_shards > 1) and prefill_mode is None:
        # the only mode a block pool can execute, and the only
        # shard-threaded one
        prefill_mode = "chunked"
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
                         kernel_plan=kernel_plan, graphed=graphed,
                         mesh=mesh, **spec_kw)


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


def serve(engine: ServingEngine, reqs: list[Request], args,
          router: ReplicaRouter | None = None) -> dict:
    """Submit (late high-priority arrivals after the batch settles), run
    to completion, and return the engine's stats plus wall time.  With a
    ``router`` the requests go through it (``engine`` is one of its
    replicas, whose stats are returned)."""
    front = router if router is not None else engine
    base = min(r.priority for r in reqs)
    t0 = time.perf_counter()
    for r in reqs:
        if r.priority == base:
            front.submit(r)
    vips = [r for r in reqs if r.priority > base]
    if vips:
        for _ in range(settle_ticks(args.prompt_len, args.chunk)):
            front.step()
        for r in vips:
            front.submit(r)
    front.run()
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    stats = engine.stats()
    stats["wall_s"] = time.perf_counter() - t0
    return stats


def run(args, mesh=None) -> int:
    """Build the engine (or the router over ``--replicas`` engines), serve
    ``--requests`` and report; on a mesh every rank serves and rank 0
    reports.  Returns the exit code."""
    say = print if mesh is None or mesh.rank == 0 else (lambda *a, **k: None)
    model = Model(build_config(args),
                  device=mesh.device if mesh is not None else args.device)
    cfg = model.cfg
    if cfg.is_encoder_decoder:
        raise SystemExit("serve.py drives decoder-only archs; for seamless "
                         "see src/repro_torch/launch/translate_audio.py")
    params = model.init(torch.Generator(device=model.device)
                        .manual_seed(args.seed))
    draft = build_draft(cfg, model.device, args.seed + 1) \
        if args.spec == "draft" else None
    engines = [build_engine(args, model, params, draft=draft, mesh=mesh)
               for _ in range(max(args.replicas, 1))]
    del params
    router = ReplicaRouter(engines) if len(engines) > 1 else None
    engine = engines[0]
    reqs = make_requests(args, cfg.vocab)
    stats = serve(engine, reqs, args, router)
    dt = stats["wall_s"]
    total_tokens = sum(len(r.generated) for r in reqs)
    decode_tps = stats.get("decode_tokens_per_s", 0.0)
    if router is not None:
        rstats = router.stats()
        decode_tps = rstats.get("aggregate_decode_tokens_per_s", 0.0)
    dev = engine.device
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    say(f"served {args.requests} requests, {total_tokens} tokens in "
        f"{dt:.2f}s ({total_tokens / dt:.1f} tok/s overall, "
        f"{decode_tps:.1f} tok/s batched decode) on {where}")
    if router is not None:
        say(f"router: {rstats['replicas']} replicas, "
            f"{rstats['dispatched']} dispatched, "
            f"{rstats['affinity_hits']} affinity hits, aggregate decode "
            f"capacity {decode_tps:.1f} tok/s")
        for i, per in enumerate(rstats["per_replica"]):
            say(f"  replica {i}: {per['tokens_out']} tokens out, "
                f"{per.get('decode_tokens_per_s', 0.0):.1f} tok/s decode")
    if "mesh_shards" in stats:
        say(f"mesh: {stats['mesh_shards']}-way concat-TP "
            f"({mesh.backend} over {mesh.shards} ranks)")
    say(f"policy: temperature={args.temperature} top_k={args.top_k} "
        f"top_p={args.top_p} eos_id={args.eos_id}; "
        f"{stats['scheduler']['preempted']} preemptions")
    say(f"plan: {stats['plan']} (prefill_mode={stats['prefill_mode']}, "
        f"kv={stats['kv']})")
    say(f"kernel plan: {stats['kernel_plan']}")
    say(f"cache: kv_growth {stats['plan']['kv_growth']}; "
        + ", ".join(f"{k} {v / 1e6:.1f} MB"
                    for k, v in stats["cache_bytes"].items())
        + (" (this rank's)" if "mesh_shards" in stats else ""))
    if "spec" in stats:
        sp = stats["spec"]
        # emissions and draft traffic are different currencies: report
        # them side by side, never summed
        say(f"spec: mode={sp['mode']} k={sp['k']} — "
            f"{total_tokens} tokens emitted, "
            f"{sp['drafts_proposed']} drafts proposed "
            f"({sp['drafts_proposed'] / dt:.1f} drafts/s), "
            f"{sp['drafts_accepted']} accepted "
            f"(accept ratio {sp['accept_rate']:.2f}), "
            f"{sp['spec_tokens']} tokens via {sp['verify_calls']} "
            f"verify dispatches")
    for name, g in (stats.get("graphs", {}) if dev.type == "cuda"
                    else {}).items():
        say(f"  graph {name}: {g['captures']} captures "
            f"({g['capture_s']:.2f} s, pool +{g['pool_bytes'] / 2**20:.0f}"
            f" MiB), {g['replays']} replays")
    if "kv_pool" in stats:
        kp = stats["kv_pool"]
        kind = kp.get("kind", "ring" if "kv_window" in stats else "classic")
        say(f"kv pool ({kind}): {kp['pool_blocks']} x "
            f"{kp['block_size']}-token blocks, "
            f"{kp['registered_prefixes']} cached prefixes, "
            f"{kp['prefill_tokens_saved']} prefill tokens saved, "
            f"{kp['gated_requests']} requests block-gated"
            + (f", window {stats['kv_window']}" if "kv_window" in stats
               else ""))
        if "per_shard" in kp:
            ps = kp["per_shard"]
            say(f"  per shard: {ps['kv_heads']} kv heads, "
                f"{ps['block_bytes']} B/block, "
                f"{ps['pool_bytes'] / 1e6:.2f} MB pool payload")
    for stage, s in stats["stages"].items():
        say(f"  stage {stage}: {s['calls']} calls, "
            f"mean {s['mean_s'] * 1e3:.2f} ms")
    if not all(r.done for r in reqs):
        say("FAIL: not every request completed", file=sys.stderr)
        return 1
    if not decode_tps > 0:
        say("FAIL: batched decode produced no throughput", file=sys.stderr)
        return 1
    return 0


def serve_rank(mesh, args) -> int:
    """One rank of ``--mesh-shards``: :func:`run` on this rank's mesh."""
    return run(args, mesh)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mesh_shards <= 1:
        return run(args)
    devices = ["cpu"] * args.mesh_shards if args.device == "cpu" else None
    try:
        if devices is None:
            devices = default_devices(args.mesh_shards)
    except ValueError as e:
        # no silent fallback: a sharded deployment that quietly runs on
        # one device reports throughput that does not exist
        print(f"FAIL: {e}", file=sys.stderr)
        return 2
    try:
        codes = spawn_ranks(serve_rank, args.mesh_shards, args=(args,),
                            devices=devices, timeout_s=args.rank_timeout)
    except (RuntimeError, TimeoutError) as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    return max(codes)


if __name__ == "__main__":
    sys.exit(main())
