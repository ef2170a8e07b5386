"""Time the two decode-attention wrappers on the card.

    PYTHONPATH=src python -m repro_torch.launch.decode_timing [--repeats N]
        [--sweep] [--prologue] [--out FILE]

Default: the serving shape of ``chip_smoke.py``: bf16, 8 rows of 512-600
valid slots in a 2048-slot ring (dense) or behind a 64 x 32 block table
(paged), qwen3-1.7b's 16 q / 8 kv heads of 128, 6 input sets rotated
past the 50 MB L2.  Each repeat gives, per wrapper, the device ms per
call (CUDA events around calls queued behind a spin kernel) and the host
µs per call (the wrapper's enqueue, timed while a spin kernel holds the
stream).  Prints the plan (body, query heads a CTA, splits) and every
repeat, then one JSON line with each list and its median.

``--sweep``: at every decode shape ``chip_smoke.py`` phase 2 times
(``SWEEP``), both wrappers (dense only where the served cache is a
dense ring) under candidate plans: the plan ``decode_grid`` picks, the
heads body at the split count it took before the group body existed,
each body at one merge and at two levels, at one split, and at a
quarter, half and twice one wave; beside SDPA (``enable_gqa``; the
gathered view for paged) and the bytes bound, in two passes (the second
in reverse order).  The ``decode_grid`` rule is set from these times.

``--planned``: the same shapes at the plan each launch takes by itself
(no plan passed), beside SDPA and the bound, in two passes; it needs
nothing of the plan API, so it also times a checkout from before it
(``PYTHONPATH=<other checkout>/src python
src/repro_torch/launch/decode_timing.py --planned``).

``--prologue``: the dense kernel's fixed cost at one row over 32,768
slots: the same mask row staged and reduced ahead of a one-slot span
(one valid slot), against the paged twin at length 1 (no mask row) and
the full row, at the plan of each body.

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
import torch.nn.functional as F

from repro_torch.kernels.decode_attention import ops
from repro_torch.launch.gemm_timing import SPIN_CYCLES, device_ms

B, H, K, D, W, BS = 8, 16, 8, 128, 2048, 32
LENGTHS = [560, 512, 600, 540, 580, 530, 590, 520]
ROTATE = 6
#: H100 SXM data-sheet HBM rate (bytes/s), for the bytes bound
HBM_BW = 3.35e12
#: the long-context row: phase 3g's prompt and half its new tokens
LONG_LIVE = 31744 + 32
#: name -> (B, H, K, D, W, live slots a row, paged too): phase 2's timed
#: decode rows (qwen3-1.7b, a TP rank's half, gemma3-1b's sliding and
#: global layers, hymba-1.5b's windows, olmoe-1b-7b, seamless's cross and
#: self spans, the long-context row, the large decoders: granite-8b's
#: G 4, which phase 2 does not time, included)
SWEEP = {
    "qwen3": (8, 16, 8, 128, 2048, LENGTHS, True),
    "qwen3_rank_k4": (8, 8, 4, 128, 2048, LENGTHS, True),
    "gemma3_sliding_w512": (8, 4, 1, 256, 512, [512] * 8, True),
    "gemma3_global_w2048": (8, 4, 1, 256, 2048, LENGTHS, True),
    "hymba_w1024": (8, 25, 5, 64, 1024, [1024] * 8, False),
    "olmoe": (8, 16, 16, 128, 2048, LENGTHS, True),
    "seamless_cross": (8, 16, 16, 64, 512, [512] * 8, False),
    "seamless_self": (8, 16, 16, 64, 69, [69] * 8, False),
    "qwen3_w32768": (1, 16, 8, 128, 32768, [LONG_LIVE], True),
    "gemma3_w32768": (1, 4, 1, 256, 32768, [LONG_LIVE], True),
    "chatglm3": (8, 32, 2, 128, 2048, LENGTHS, True),
    "granite": (8, 32, 8, 128, 2048, LENGTHS, True),
    "internlm2": (8, 48, 8, 128, 2048, LENGTHS, True),
    "chameleon": (8, 64, 8, 128, 2048, LENGTHS, True),
}


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


def shape_sets(gen, b, h, k, d, w, lengths, bs=BS, n=ROTATE):
    """``n`` dense and paged bf16 input sets: prefix rows of ``lengths``
    in a ``w``-slot cache; pools of ``bs``-slot blocks in a shuffled
    order, -1 past each row's length."""
    dense, paged = [], []
    pos = torch.arange(w, device="cuda")[None, :]
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    M = -(-w // bs)
    rnd = lambda *s: torch.randn(s, generator=gen,
                                 device="cuda").to(torch.bfloat16)
    for _ in range(n):
        dense.append((rnd(b, h, d), rnd(b, w, k, d), rnd(b, w, k, d),
                      pos < ln[:, None].long()))
        perm = torch.randperm(b * M, generator=gen,
                              device="cuda").reshape(b, M)
        start = torch.arange(M, device="cuda")[None, :] * bs
        bt = torch.where(start < ln[:, None], perm, -1).to(torch.int32)
        paged.append((rnd(b, h, d), rnd(b * M, bs, k, d), rnd(b * M, bs, k, d),
                      bt.contiguous(), ln))
    return dense, paged


def make_sets(gen):
    """ROTATE dense and paged input sets at the main shape."""
    return shape_sets(gen, B, H, K, D, W, LENGTHS)


def sdpa(q, k, v, valid):
    """One ``scaled_dot_product_attention`` call over the same inputs
    (the library yardstick; never used by the port)."""
    return F.scaled_dot_product_attention(
        q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=valid[:, None, None, :], enable_gqa=True)


def candidates(b, h, k, d, w, sms):
    """name -> plan: the planned one, the heads body's plan before the
    group body existed (one merge), and each body at one merge, at two
    levels, at one split, at a quarter, a half and twice one wave."""
    g = h // k
    out = {"planned": ops.decode_grid(b, k, g, w, sms, d)}
    bodies = [("heads", 2 - g % 2)]
    if 2 <= g <= ops.GROUP_MAX_G:
        bodies.append(("group", g))
    for body, gt in bodies:
        units = b * k * (g // gt)
        cap = ops.merge_cap(body, d, gt)
        wave = max(1, min(ops.CTAS_PER_SM * sms // units,
                          -(-w // ops.MIN_SPLIT_SLOTS)))
        for tag, s in (("one_merge", min(wave, cap)),
                       ("two_levels", min(wave, cap * cap)),
                       ("one_split", 1),
                       ("quarter_wave", max(1, wave // 4)),
                       ("half_wave", max(1, wave // 2)),
                       ("two_waves", min(2 * wave, cap * cap))):
            out[f"{body}_{tag}"] = ops.DecodePlan(body, gt, s)
    return out


def sweep(gen, sms, planned_only=False) -> dict:
    """Every ``SWEEP`` shape under its candidate plans, or (planned_only)
    at the plan the launch takes by itself."""
    result = {}
    for name, (b, h, k, d, w, lengths, has_paged) in SWEEP.items():
        dense, paged = shape_sets(gen, b, h, k, d, w, lengths)
        live = sum(lengths)
        uniq = {None: ["planned"]}
        row = {"shape": [b, h, k, d, w], "live": live, "plans": {}}
        if not planned_only:
            plans = candidates(b, h, k, d, w, sms)
            uniq = {}
            for tag, plan in plans.items():
                uniq.setdefault(tuple(plan), []).append(tag)
            row["planned"] = list(plans["planned"])
        kv = 2 * live * k * d * 2 + 2 * b * h * d * 2
        kinds = [("dense", ops.gqa_decode, dense, kv + b * w)]
        if has_paged:
            kinds.append(("paged", ops.gqa_decode_paged, paged,
                          kv + paged[0][3].numel() * 4 + b * 4))
        for kind, fn, sets, nbytes in kinds:
            views = sets if kind == "dense" else [
                (q, ops.paged_view(kp, bt), ops.paged_view(vp, bt),
                 torch.arange(bt.shape[1] * kp.shape[1], device="cuda")[None]
                 < ln[:, None]) for q, kp, vp, bt, ln in sets]
            row[f"{kind}_sdpa_ms"] = device_ms(
                [lambda s=s: sdpa(*s) for s in views], iters=24)
            row[f"{kind}_bound_ms"] = 1e3 * nbytes / HBM_BW
            order = list(uniq)
            times = {p: [] for p in order}
            for pas in (order, order[::-1]):
                for p in pas:
                    extra = () if p is None else (ops.DecodePlan(*p),)
                    times[p].append(device_ms(
                        [lambda s=s: fn(*s, *extra) for s in sets], iters=24))
            for p, ts in times.items():
                row["plans"].setdefault(kind, []).append(
                    {"plan": p and list(p), "names": uniq[p], "ms": ts})
                print(f"{name} {kind} {'/'.join(uniq[p])} "
                      f"{'' if p is None else list(p)}: "
                      + " ".join(f"{t:.4f}" for t in ts) + " ms", flush=True)
            print(f"{name} {kind}: SDPA {row[f'{kind}_sdpa_ms']:.4f} ms, "
                  f"bound {row[f'{kind}_bound_ms']:.4f} ms", flush=True)
        result[name] = row
        del dense, paged
        torch.cuda.empty_cache()
    return result


def prologue(gen, sms) -> dict:
    """The dense kernel's fixed cost at one row over 32,768 slots (qwen3's
    heads, the heads body; gemma3's, the group body): one valid slot (the
    mask row staged and reduced, then a one-slot span) against the paged
    twin at length 1 (no mask row) and the full row."""
    out = {}
    for name in ("qwen3_w32768", "gemma3_w32768"):
        b, h, k, d, w, lengths, _ = SWEEP[name]
        dense, paged = shape_sets(gen, b, h, k, d, w, lengths)
        one_d = [(q, kc, vc, torch.zeros_like(vl).index_fill_(1, torch.tensor(
            [0], device="cuda"), True)) for q, kc, vc, vl in dense]
        one_p = [(q, kp, vp, bt, torch.ones_like(ln))
                 for q, kp, vp, bt, ln in paged]
        plan = ops.decode_grid(b, k, h // k, w, sms, d)
        row = {"plan": list(plan)}
        for tag, fn, sets in (("dense_one_slot", ops.gqa_decode, one_d),
                              ("paged_one_slot", ops.gqa_decode_paged, one_p),
                              ("dense_full", ops.gqa_decode, dense),
                              ("paged_full", ops.gqa_decode_paged, paged)):
            row[tag] = [device_ms([lambda s=s: fn(*s) for s in sets],
                                  iters=24) for _ in range(3)]
            print(f"prologue {name} {tag} {list(plan)}: "
                  + " ".join(f"{t:.4f}" for t in row[tag]) + " ms",
                  flush=True)
        out[name] = row
        del dense, paged, one_d, one_p
        torch.cuda.empty_cache()
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--sweep", action="store_true",
                    help="time candidate plans at phase 2's decode shapes")
    ap.add_argument("--planned", action="store_true",
                    help="time phase 2's decode shapes at their own plans")
    ap.add_argument("--prologue", action="store_true",
                    help="time the dense mask prologue at 32,768 slots")
    ap.add_argument("--out", help="also write the JSON result here")
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
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"card": card, "source": os.path.dirname(ops.__file__)}
    if cli.sweep:
        result["sweep"] = sweep(gen, sms)
    if cli.planned:
        result["planned"] = sweep(gen, sms, planned_only=True)
    if cli.prologue:
        result["prologue"] = prologue(gen, sms)
    if not (cli.sweep or cli.planned or cli.prologue):
        dense, paged = make_sets(gen)
        result["plan"] = list(ops.decode_grid(B, K, H // K, W, sms, D))
        print(f"plan {result['plan']}")
        for name, fn, sets in (("gqa_decode", ops.gqa_decode, dense),
                               ("gqa_decode_paged", ops.gqa_decode_paged,
                                paged)):
            ms, us = [], []
            for r in range(cli.repeats):
                ms.append(device_ms([lambda s=s: fn(*s) for s in sets],
                                    iters=24))
                us.append(host_us(lambda: fn(*sets[0])))
                print(f"{name} repeat {r}: {ms[-1]:.4f} ms device, "
                      f"{us[-1]:.1f} us host per call", flush=True)
            result[name] = {"ms": ms, "host_us": us,
                            "ms_median": statistics.median(ms),
                            "host_us_median": statistics.median(us)}
    if cli.out:
        with open(cli.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
