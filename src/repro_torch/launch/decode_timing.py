"""Time the two decode-attention wrappers at the serving shape on the card.

    PYTHONPATH=src python -m repro_torch.launch.decode_timing [--repeats N]

The shape is ``chip_smoke.py``'s: bf16, 8 rows of 512-600 valid slots in
a 2048-slot ring (dense) or behind a 64 x 32 block table (paged),
qwen3-1.7b's 16 q / 8 kv heads of 128, 6 input sets rotated past the
50 MB L2.  Each repeat gives, per wrapper, the device ms per call (CUDA
events around calls queued behind a spin kernel) and the host µs per
call (the wrapper's enqueue, timed while a spin kernel holds the
stream).  Prints every repeat, then one JSON line with each list and its
median.

It reaches only ``gqa_decode`` and ``gqa_decode_paged`` (and
``launch/gemm_timing``'s ``device_ms``), so running this file with
``PYTHONPATH`` set to another checkout's ``src`` times that checkout's
kernels.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import torch

from repro_torch.kernels.decode_attention import ops
from repro_torch.launch.gemm_timing import SPIN_CYCLES, device_ms

B, H, K, D, W, BS = 8, 16, 8, 128, 2048, 32
LENGTHS = [560, 512, 600, 540, 580, 530, 590, 520]
ROTATE = 6


def host_us(fn, iters: int = 500) -> float:
    """Host µs per call of ``fn`` while a spin kernel holds the stream."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e6 * dt / iters


def make_sets(gen):
    """ROTATE dense and paged input sets at the main shape."""
    dense, paged = [], []
    pos = torch.arange(W, device="cuda")[None, :]
    ln = torch.tensor(LENGTHS, dtype=torch.int32, device="cuda")
    M, P = W // BS, B * W // BS
    rnd = lambda *s: torch.randn(s, generator=gen,
                                 device="cuda").to(torch.bfloat16)
    for _ in range(ROTATE):
        dense.append((rnd(B, H, D), rnd(B, W, K, D), rnd(B, W, K, D),
                      pos < ln[:, None].long()))
        perm = torch.randperm(P, generator=gen, device="cuda").reshape(B, M)
        start = torch.arange(M, device="cuda")[None, :] * BS
        bt = torch.where(start < ln[:, None], perm, -1).to(torch.int32)
        paged.append((rnd(B, H, D), rnd(P, BS, K, D), rnd(P, BS, K, D),
                      bt.contiguous(), ln))
    return dense, paged


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=5)
    cli = ap.parse_args()
    if not torch.cuda.is_available():
        print("decode_timing needs a CUDA card", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi gave nothing"
    print(card)
    dense, paged = make_sets(torch.Generator(device="cuda").manual_seed(0))
    result = {"card": card, "source": os.path.dirname(ops.__file__)}
    for name, fn, sets in (("gqa_decode", ops.gqa_decode, dense),
                           ("gqa_decode_paged", ops.gqa_decode_paged, paged)):
        ms, us = [], []
        for r in range(cli.repeats):
            ms.append(device_ms([lambda s=s: fn(*s) for s in sets], iters=24))
            us.append(host_us(lambda: fn(*sets[0])))
            print(f"{name} repeat {r}: {ms[-1]:.4f} ms device, "
                  f"{us[-1]:.1f} us host per call", flush=True)
        result[name] = {"ms": ms, "host_us": us,
                        "ms_median": statistics.median(ms),
                        "host_us_median": statistics.median(us)}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
