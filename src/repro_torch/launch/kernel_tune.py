"""Micro-benchmark the serving kernel sites and print the routed plan (the
counterpart of the reference's ``tools/kernel_tune.py``).

Runs ``launch.autotune.bench_kernel_sites`` for the given serving
geometry — sweeping every ``SERVE_KV_BLOCK_SIZES`` candidate that tiles
the horizon for the paged-decode site — persists the ``{"site:backend":
seconds}`` timings cache as JSON, and prints the :class:`KernelPlan` the
``kernel_select`` pass derives from those measurements (a measured argmin
overrides the heuristic per site).

A serving run can then consume the cache::

    python -m repro_torch.launch.kernel_tune --out kernel_timings.json
    # ... later ...
    from repro_torch.launch.autotune import load_timings
    ServingEngine(..., kernel_timings=load_timings("kernel_timings.json"))

Usage: PYTHONPATH=src python -m repro_torch.launch.kernel_tune
           [--slots N] [--max-len N] [--q-heads N] [--kv-heads N]
           [--head-dim N] [--vocab N] [--block-size N] [--iters N]
           [--out PATH] [--device cuda|cpu] [--dtype float32|bfloat16]

On ``--device cpu`` the bench times the plain versions only (a kernel
wrapper runs its plain version on host tensors).
"""
from __future__ import annotations

import argparse

from .. import resolve_device
from ..core.pipeline import SERVE_KV_BLOCK_SIZES, select_kernel_plan
from .autotune import bench_kernel_sites, save_timings


def sweep(args) -> tuple[dict[str, float], dict[int, dict[str, float]]]:
    """One bench per viable KV block size.  The returned flat timings dict
    uses the engine's actual block size (``--block-size``, default: the
    smallest candidate) for the paged site; the per-block-size sweep is
    printed and persisted alongside so the geometry choice is visible."""
    candidates = [b for b in SERVE_KV_BLOCK_SIZES if args.max_len % b == 0]
    if not candidates:
        candidates = [args.max_len]
    block_size = args.block_size or candidates[0]
    by_block: dict[int, dict[str, float]] = {}
    for bs in sorted(set(candidates + [block_size])):
        by_block[bs] = bench_kernel_sites(
            slots=args.slots, max_len=args.max_len, q_heads=args.q_heads,
            kv_heads=args.kv_heads, head_dim=args.head_dim,
            kv_block_size=bs, vocab=args.vocab, iters=args.iters,
            device=args.device, dtype=args.dtype)
    return dict(by_block[block_size]), by_block


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--q-heads", type=int, default=8)
    ap.add_argument("--kv-heads", type=int, default=2)
    ap.add_argument("--head-dim", type=int, default=64)
    ap.add_argument("--vocab", type=int, default=512)
    ap.add_argument("--block-size", type=int, default=None,
                    help="KV block size the engine will actually run "
                         "(default: smallest SERVE_KV_BLOCK_SIZES divisor)")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--out", default=None,
                    help="persist the timings cache JSON here")
    ap.add_argument("--device", default="cuda",
                    help="where to time (default cuda; cpu times the plain "
                         "versions only)")
    ap.add_argument("--dtype", default="float32",
                    choices=("float32", "bfloat16"),
                    help="queries, caches and logits (default float32, the "
                         "reference's)")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    accelerator = resolve_device(args.device).type
    timings, by_block = sweep(args)
    print(f"kernel-site micro-benchmarks "
          f"(device={args.device}, dtype={args.dtype}, slots={args.slots}, "
          f"max_len={args.max_len})")
    for bs, t in sorted(by_block.items()):
        print(f"  kv_block_size={bs}:")
        for key, s in sorted(t.items()):
            print(f"    {key:24s} {s * 1e6:10.1f} us")

    block_size = args.block_size or min(by_block)
    plan, detail = select_kernel_plan({
        "accelerator": accelerator,
        "slots": args.slots, "max_len": args.max_len,
        "q_heads": args.q_heads, "kv_heads": args.kv_heads,
        "head_dim": args.head_dim, "kv_block_size": block_size,
        "kv_pool_blocks": args.slots * (args.max_len // block_size),
        "timings": timings,
    })
    print(f"routed plan: {plan}")
    for k, v in sorted(detail.items()):
        print(f"  {k}: {v}")

    if args.out:
        save_timings(args.out, timings, meta={
            "accelerator": accelerator, "slots": args.slots,
            "max_len": args.max_len, "q_heads": args.q_heads,
            "kv_heads": args.kv_heads, "head_dim": args.head_dim,
            "vocab": args.vocab, "kv_block_size": block_size,
            "by_block_size": {str(b): t for b, t in by_block.items()},
            "plan": plan.as_dict(), "dtype": args.dtype,
        })
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
