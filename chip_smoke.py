#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero before the result line):

1. print the card's name and power limit (``nvidia-smi``) and build the
   CUDA kernels from ``src/repro_torch/csrc`` (one ``nvcc`` per source,
   started together);
2. hold each kernel against its plain PyTorch version at the main path's
   shapes (slots 8, max_len 2048, qwen3-1.7b's 16 q / 8 kv heads of 128,
   vocab 151,936), in bf16 and fp32, with ragged W, -1 table entries,
   length-0 rows, k <= 0, T = 0, p = 1 and ties; decode element by
   element (|kernel - plain| <= atol + rtol |plain|), the mask by equal
   support outside the nucleus-boundary tokens and equal survivor values;
   time kernel, plain version and the library yardstick with CUDA events;
3. serve full-width qwen3-1.7b (random weights from ``Model.init``,
   seeded) through ``repro_torch.launch.serve``'s engine: 16 requests of
   ~512-token prompts, 64 new tokens each, once with dense KV greedy and
   once with paged KV sampled (T 0.8, top-k 50, top-p 0.95).  Every
   request must complete with in-vocabulary tokens and each kernel's
   launch counter must rise during the runs that route through it;
4. hold the routed ``cuda`` plan against the plain-backend plan on the
   same weights and prompts at reduced depth: greedy streams must match
   wherever the plain path's top-1/top-2 logit margin exceeds the bf16
   tolerance.

The line before last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  A copy of everything measured goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
SRC = REPO / "src"

#: H100 SXM data-sheet peaks (700 W): bytes/s and FLOP/s by input type
HBM_BW = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}

SLOTS, MAX_LEN, VOCAB = 8, 2048, 151936
H, K, D = 16, 8, 128
#: decode: element-wise |kernel - plain| <= atol + rtol * |plain|
TOL = {"float32": dict(rtol=3e-5, atol=3e-5),
       "bfloat16": dict(rtol=2e-2, atol=1e-3)}
#: ~0.1 s of spinning at the H100's 1.98 GHz boost clock (see cuda_ms)
SPIN_CYCLES = 200_000_000
#: decode timings rotate over this many input sets (~110 MB of K/V rows,
#: past the 50 MB L2), since serving reads each layer's cache cold
ROTATE = 6
#: where the checks run (the card; a rehearsal on the host may change it)
DEV = "cuda"


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fns, iters: int = 24, warmup: int = 3) -> float:
    """Device time per call, run back to back, cycling through the
    callables ``fns`` (one per input set).  A spin kernel holds the stream
    while the host enqueues the timed calls, so the events time the card
    and not the host's launch rate."""
    import torch
    for i in range(warmup):
        fns[i % len(fns)]()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def check_close(label: str, got, want, dtype: str) -> float:
    """Fail unless every element is within TOL[dtype] of the plain
    version; return the max abs error."""
    tol = TOL[dtype]
    got, want = got.float(), want.float()
    err = (got - want).abs()
    worst = (err / (tol["atol"] + tol["rtol"] * want.abs())).max().item()
    print(f"{label}: max_abs_err {err.max().item():.3e}, worst "
          f"err / (atol + rtol |plain|) {worst:.3f} (atol {tol['atol']}, "
          f"rtol {tol['rtol']})")
    if not worst <= 1.0:
        fail(f"{label} disagrees with its plain version")
    return err.max().item()


def bound_ms(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BW, flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else \
        "operations"


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

def sdpa(q, k, v, valid):
    """The library yardstick: one ``scaled_dot_product_attention`` call
    over q (B,H,D), k/v (B,W,K,D) and valid (B,W) (timed, never used by
    the port)."""
    import torch.nn.functional as F
    return F.scaled_dot_product_attention(
        q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
        attn_mask=valid[:, None, None, :], enable_gqa=True)


def decode_inputs(torch, dtype, W, lengths, gen, ring=False):
    """q (B,H,D), k/v (B,W,K,D), valid (B,W): row b holds lengths[b]
    tokens; ``ring`` scatters the valid slots instead of a prefix."""
    B = len(lengths)
    q = torch.randn((B, H, D), generator=gen, device=DEV).to(dtype)
    k = torch.randn((B, W, K, D), generator=gen, device=DEV).to(dtype)
    v = torch.randn((B, W, K, D), generator=gen, device=DEV).to(dtype)
    pos = torch.arange(W, device=DEV)[None, :]
    valid = pos < torch.tensor(lengths, device=DEV)[:, None]
    if ring:
        perm = torch.randperm(W, generator=gen, device=DEV)
        valid = valid[:, perm]
    return q, k, v, valid


def check_dense(torch, ops, gen, report):
    lengths = [600, 512, 0, 2048, 1, 530, 777, 1500]
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for W, ring in ((MAX_LEN, False), (MAX_LEN, True), (2000, True)):
            ls = [min(x, W) for x in lengths]
            q, k, v, valid = decode_inputs(torch, dtype, W, ls, gen, ring)
            name = str(dtype).split(".")[-1]
            err = check_close(f"gqa_decode {name} W={W} ring={ring}",
                              ops.gqa_decode(q, k, v, valid),
                              ops.gqa_decode_plain(q, k, v, valid), name)
            worst[name] = max(worst.get(name, 0.0), err)
    # main-path timing: bf16, ~560-token rows in a 2048-slot ring
    ls = [560, 512, 600, 540, 580, 530, 590, 520]
    sets = [decode_inputs(torch, torch.bfloat16, MAX_LEN, ls, gen)
            for _ in range(ROTATE)]
    rows = sum(ls)
    nbytes = 2 * rows * K * D * 2 + 2 * SLOTS * H * D * 2 + SLOTS * MAX_LEN
    flops = 4 * rows * H * D
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    report["gqa_decode"] = {
        "name": "gqa_decode", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/decode_attention.py:135",
        "max_abs_err": worst["bfloat16"], "max_abs_err_fp32": worst["float32"],
        "ms": cuda_ms([lambda s=s: ops.gqa_decode(*s) for s in sets]),
        "plain_ms": cuda_ms([lambda s=s: ops.gqa_decode_plain(*s)
                             for s in sets]),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms([lambda s=s: sdpa(*s) for s in sets]),
    }


def paged_inputs(torch, dtype, bs, lengths, gen):
    B, M = len(lengths), MAX_LEN // bs
    P = B * M
    kp = torch.randn((P, bs, K, D), generator=gen, device=DEV).to(dtype)
    vp = torch.randn((P, bs, K, D), generator=gen, device=DEV).to(dtype)
    q = torch.randn((B, H, D), generator=gen, device=DEV).to(dtype)
    perm = torch.randperm(P, generator=gen, device=DEV).tolist()
    bt = torch.full((B, M), -1, dtype=torch.int32)
    i = 0
    for b, n in enumerate(lengths):
        for m in range(-(-n // bs)):
            bt[b, m] = perm[i]
            i += 1
    return (q, kp, vp, bt.to(DEV),
            torch.tensor(lengths, dtype=torch.int32, device=DEV))


def check_paged(torch, ops, gen, bs, report):
    lengths = [600, 512, 0, 2048, 1, 530, 777, 1500]
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, kp, vp, bt, ln = paged_inputs(torch, dtype, bs, lengths, gen)
        name = str(dtype).split(".")[-1]
        worst[name] = check_close(
            f"gqa_decode_paged {name} bs={bs}",
            ops.gqa_decode_paged(q, kp, vp, bt, ln),
            ops.gqa_decode_paged_plain(q, kp, vp, bt, ln), name)
    ls = [560, 512, 600, 540, 580, 530, 590, 520]
    sets = [paged_inputs(torch, torch.bfloat16, bs, ls, gen)
            for _ in range(ROTATE)]
    # the library call needs the gathered view; only its attention is timed
    views = [(q, ops.paged_view(kp, bt), ops.paged_view(vp, bt),
              torch.arange(MAX_LEN, device=DEV)[None, :] < ln[:, None])
             for q, kp, vp, bt, ln in sets]
    rows = sum(ls)
    nbytes = (2 * rows * K * D * 2 + 2 * SLOTS * H * D * 2
              + sets[0][3].numel() * 4 + SLOTS * 4)
    b_ms, b_by = bound_ms(nbytes, 4 * rows * H * D, "bfloat16")
    report["gqa_decode_paged"] = {
        "name": "gqa_decode_paged", "route": "cuda",
        "source": "src/repro_torch/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention/decode_attention.py:91",
        "max_abs_err": worst["bfloat16"], "max_abs_err_fp32": worst["float32"],
        "ms": cuda_ms([lambda s=s: ops.gqa_decode_paged(*s) for s in sets]),
        "plain_ms": cuda_ms([lambda s=s: ops.gqa_decode_paged_plain(*s)
                             for s in sets]),
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": cuda_ms([lambda s=s: sdpa(*s) for s in views]),
        "block_size": bs,
    }


def check_fused_mask(torch, ops, gen, report):
    B, V = SLOTS, VOCAB
    cases = {
        "mixed": ([0.0, 0.8, 0.8, 1.3, 0.0, 0.5, 0.8, 1.0],
                  [0, 50, 1, V, 50, 0, 1000, -3],
                  [1.0, 0.95, 1.0, 0.5, 0.95, 0.9, 1.0, 0.3]),
        "main_sampled": ([0.8] * B, [50] * B, [0.95] * B),
        "main_greedy": ([0.0] * B, [0] * B, [1.0] * B),
    }
    logits = torch.randn((B, V + 128), generator=gen, device=DEV) * 3.0
    tied = torch.round(logits * 2) / 2          # exact ties everywhere
    worst = 0.0
    for label, (t, k, p) in cases.items():
        for rows_name, rows in (("random", logits), ("ties", tied)):
            rows = rows[:, :V]                  # a strided slice, as served
            tt = torch.tensor(t, device=DEV)
            kk = torch.tensor(k, dtype=torch.int32, device=DEV)
            pp = torch.tensor(p, device=DEV)
            got = ops.fused_mask(rows, tt, kk, pp)
            want = ops.fused_mask_plain(rows, tt, kk, pp)
            # the kernel's documented departures (fp64 nucleus masses,
            # p >= 1 keeps every top-k survivor) touch only these tokens
            free = ops.nucleus_boundary(rows, tt, kk, pp)
            differ = torch.isinf(got) != torch.isinf(want)
            both = ~torch.isinf(got) & ~torch.isinf(want)
            err = (got[both] - want[both]).abs().max().item() \
                if both.any() else 0.0
            print(f"fused_mask {label}/{rows_name}: survivors/row kernel "
                  f"{(~torch.isinf(got)).sum(dim=-1).tolist()} plain "
                  f"{(~torch.isinf(want)).sum(dim=-1).tolist()}; supports "
                  f"differ on {int(differ.sum())} tokens, all nucleus-"
                  f"boundary: {not (differ & ~free).any().item()} "
                  f"({int(free.sum())} boundary tokens); survivor "
                  f"max_abs_err {err}")
            if (differ & ~free).any() or err != 0.0:
                fail(f"fused_mask {label}/{rows_name} disagrees with its "
                     "plain version")
            worst = max(worst, err)
    tt = torch.full((B,), 0.8, device=DEV)
    kk = torch.full((B,), 50, dtype=torch.int32, device=DEV)
    pp = torch.full((B,), 0.95, device=DEV)
    rows = logits[:, :V]
    b_ms, b_by = bound_ms(2 * B * V * 4 + B * 12, B * V, "float32")
    report["fused_mask"] = {
        "name": "fused_mask", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_sampler.cu",
        "replaces": "src/repro/kernels/fused_sampler/fused_sampler.py:79",
        "max_abs_err": worst,
        # one input set: served logits come straight from the LM head
        # and are still in L2
        "ms": cuda_ms([lambda: ops.fused_mask(rows, tt, kk, pp)]),
        "plain_ms": cuda_ms([lambda: ops.fused_mask_plain(rows, tt, kk, pp)],
                            iters=5, warmup=1),
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
    }


# ---------------------------------------------------------------------------
# phase 3 + 4: the served path
# ---------------------------------------------------------------------------

def serve_args(serve, **over):
    args = serve.build_parser().parse_args(["--arch", "qwen3-1.7b"])
    values = dict(requests=16, prompt_len=512, max_new=64, slots=SLOTS,
                  max_len=MAX_LEN, seed=0)
    values.update(over)
    for k, v in values.items():
        setattr(args, k, v)
    return args


def ragged_prompts(reqs, vocab, seed):
    import numpy as np
    rng = np.random.default_rng(seed)
    for r in reqs:
        n = int(rng.integers(480, 545))
        r.prompt = rng.integers(0, vocab, size=n).astype(np.int32)


def profile_window(torch, prof, ticks: int) -> dict:
    """Device kernel time per tick and the top kernels of a profiled
    window (torch.profiler's CUDA rows)."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        rows.append((us, e.key, e.count))
    total = sum(r[0] for r in rows)
    rows.sort(reverse=True)
    return {"device_ms_per_tick": total / 1e3 / ticks if total else None,
            "top_kernels": [{"name": k[:80], "ms_per_tick": us / 1e3 / ticks,
                             "calls_per_tick": n / ticks}
                            for us, k, n in rows[:8]]}


def serve_phase(torch, kernels, serve, engine, args, label,
                window=(100, 105)):
    """One full serving run through ``engine`` (built from ``args``), ticks
    driven here so a window of ticks can be profiled; the launch counts
    cover the run."""
    model = engine.model
    reqs = serve.make_requests(args, model.cfg.vocab)
    ragged_prompts(reqs, model.cfg.vocab, seed=1 + len(label))
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    tick, prof, profiled = 0, None, None
    while engine.scheduler.pending():
        if tick == window[0]:
            torch.cuda.synchronize()
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        engine.step()
        tick += 1
        if prof is not None and tick == window[1]:
            torch.cuda.synchronize()
            prof.__exit__(None, None, None)
            profiled = profile_window(torch, prof, window[1] - window[0])
            prof = None
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(kernels.LAUNCHES)
    stats = engine.stats()
    if not all(r.done and len(r.generated) == args.max_new for r in reqs):
        fail(f"{label}: not every request completed")
    if not all(0 <= t < model.cfg.vocab for r in reqs for t in r.generated):
        fail(f"{label}: a token outside the vocabulary")
    tps = stats.get("decode_tokens_per_s", 0.0)
    if not tps > 0:
        fail(f"{label}: decode produced no throughput")
    dec = stats["stages"]["decode"]
    print(f"serve {label}: {len(reqs)} requests, "
          f"{sum(len(r.generated) for r in reqs)} tokens in {wall:.2f} s "
          f"over {tick} ticks; decode {tps:.1f} tok/s, mean decode step "
          f"{dec['mean_s'] * 1e3:.2f} ms over {dec['calls']} steps; "
          f"launches {launches}")
    for stage, s in stats["stages"].items():
        print(f"  stage {stage}: {s['calls']} calls, total "
              f"{s['total_s']:.3f} s, mean {s['mean_s'] * 1e3:.2f} ms")
    print(f"  kernel plan {stats['kernel_plan']}; final plan {stats['plan']}")
    if profiled is not None:
        busy = profiled["device_ms_per_tick"]
        print(f"  profiled ticks {window}: device kernel time "
              f"{'not measured' if busy is None else f'{busy:.2f} ms'} per "
              "tick; top kernels:")
        for k in profiled["top_kernels"]:
            print(f"    {k['ms_per_tick']:.3f} ms/tick "
                  f"{k['calls_per_tick']:.0f} calls/tick  {k['name']}")
    return {"decode_tokens_per_s": tps, "mean_decode_ms": dec["mean_s"] * 1e3,
            "decode_steps": dec["calls"], "wall_s": wall, "ticks": tick,
            "stages": stats["stages"], "launches": launches,
            "kernel_plan": stats["kernel_plan"], "plan": stats["plan"],
            "profile": profiled}


def parity_phase(torch, serve, pipeline, Model, cfg):
    """Routed cuda plan vs plain-backend plan, reduced depth, greedy."""
    small = dataclasses.replace(cfg, n_layers=2)
    model = Model(small, device=DEV)
    params = model.cast_params(model.init(
        torch.Generator(device=DEV).manual_seed(1)))
    plain = pipeline.KernelPlan(decode_dense="torch", decode_paged="gather",
                                sampler="fused")
    out = {}
    for kv in ("dense", "paged"):
        streams = {}
        for name, plan in (("plain", plain), ("routed", None)):
            args = serve_args(serve, requests=4, prompt_len=64, max_new=24,
                              max_len=256, kv=kv)
            engine = serve.build_engine(args, model, params,
                                        kernel_plan=plan)
            reqs = serve.make_requests(args, small.vocab)
            serve.serve(engine, reqs, args)
            streams[name] = ([list(r.generated) for r in reqs],
                             [r.prompt for r in reqs], engine.kernel_plan)
        if streams["routed"][2].decode_dense != "cuda" \
                or streams["routed"][2].sampler != "cuda":
            fail(f"parity {kv}: the routed plan did not route to cuda")
        compared = diverged = 0
        for a, b, prompt in zip(streams["plain"][0], streams["routed"][0],
                                streams["plain"][1]):
            seq = torch.tensor([list(prompt) + a], device=DEV)
            logits, _ = model.forward(params, {"tokens": seq})
            logits = logits[0, len(prompt) - 1:, :small.vocab].float()
            for t, (x, y) in enumerate(zip(a, b)):
                top = torch.topk(logits[t], 2).values
                margin = (top[0] - top[1]).item()
                tol = TOL["bfloat16"]["rtol"] * max(1.0, abs(top[0].item()))
                if x != y:
                    if margin > tol:
                        fail(f"parity {kv}: streams differ at step {t} where "
                             f"the plain margin {margin:.4f} > tol {tol:.4f}")
                    diverged += 1
                    break
                compared += 1
        print(f"parity {kv}: {compared} tokens compared, {diverged} streams "
              "diverged at a low-margin step, routed plan "
              f"{streams['routed'][2].as_dict()}")
        out[kv] = {"compared": compared, "diverged_low_margin": diverged}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 2 (build and kernel checks)")
    cli = ap.parse_args()
    if not (SRC / "repro_torch" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from a checkout")
    sys.path.insert(0, str(SRC))
    import torch
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch import kernels
    from repro_torch.configs.base import get_config
    from repro_torch.core import pipeline
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.fused_sampler import ops as fs_ops
    from repro_torch.launch import serve
    from repro_torch.models.model import Model

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else \
        "nvidia-smi gave nothing"
    print(card)  # name, power limit: nvidia-smi's own line
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    result: dict = {"card": card}

    t0 = time.perf_counter()
    libs = kernels.build()
    result["build_s"] = time.perf_counter() - t0
    print(f"built {sorted(libs)} in {result['build_s']:.1f} s")
    out_dir = REPO / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    for name, path in libs.items():
        log = path.with_suffix(".log").read_text()
        (out_dir / f"nvcc_{name}.log").write_text(log)

    cfg = get_config("qwen3-1.7b")
    model = Model(cfg, device=DEV)
    t0 = time.perf_counter()
    params = model.cast_params(model.init(
        torch.Generator(device=DEV).manual_seed(0)))
    torch.cuda.synchronize()
    print(f"qwen3-1.7b full width ({cfg.n_layers} layers, d {cfg.d_model}, "
          f"vocab {cfg.vocab}): {model.param_count() / 1e9:.3f} B params "
          f"initialized in {time.perf_counter() - t0:.1f} s")
    # the paged engine of phase 3, built now: its pool's block size is the
    # one the paged kernel is checked and timed at
    paged_args = serve_args(serve, kv="paged", temperature=0.8, top_k=50,
                            top_p=0.95)
    paged_engine = serve.build_engine(paged_args, model, params)
    bs = paged_engine.pool.cfg.block_size

    gen = torch.Generator(device=DEV).manual_seed(0)
    report: dict = {}
    check_dense(torch, dec_ops, gen, report)
    check_paged(torch, dec_ops, gen, bs, report)
    check_fused_mask(torch, fs_ops, gen, report)
    result["kernels"] = report
    if cli.kernels_only:
        print(json.dumps(result, default=str))
        return 1   # a partial run is never a passing result

    dense_args = serve_args(serve, kv="dense")
    dense_engine = serve.build_engine(dense_args, model, params)
    runs = {
        "dense_greedy": serve_phase(torch, kernels, serve, dense_engine,
                                    dense_args, "dense_greedy"),
        "paged_sampled": serve_phase(torch, kernels, serve, paged_engine,
                                     paged_args, "paged_sampled"),
    }
    del dense_engine, paged_engine
    need = {"dense_greedy": ("gqa_decode", "fused_mask"),
            "paged_sampled": ("gqa_decode_paged", "fused_mask")}
    for label, names in need.items():
        for name in names:
            if runs[label]["launches"].get(name, 0) <= 0:
                fail(f"{label}: kernel {name} was never launched")
    result["serve"] = runs
    del params
    torch.cuda.empty_cache()
    result["parity"] = parity_phase(torch, serve, pipeline, Model, cfg)

    table = []
    for name in ("gqa_decode", "gqa_decode_paged", "fused_mask"):
        row = dict(report[name])
        row["launches"] = sum(r["launches"].get(name, 0)
                              for r in runs.values())
        table.append({k: row[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")})
    result["table"] = table
    (out_dir / "chip_smoke.json").write_text(json.dumps(result, indent=1,
                                                        default=str))
    print(card)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
