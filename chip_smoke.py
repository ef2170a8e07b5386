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
   launch counter must rise during the runs that route through it
   (``linked_mlp`` in both: every layer's SwiGLU MLP, prefill and decode);
4. hold the routed ``cuda`` plan against the plain-torch plan (every
   site) on the same weights and prompts at reduced depth: greedy streams
   must match wherever the plain path's top-1/top-2 logit margin exceeds
   the bf16 tolerance;
5. the paper's CNN path: the zoo's MobileNet (224, width 1.0, 1000
   classes) and ResNet18 (224, width 64, 1000 classes) at the zoo's depth,
   the Figure-5 graph, both Table-4 CBRA graphs, and the zoo's
   ``bert_s(seq=128, d=768, n_layers=2)`` planned under the paper's DSP
   spec (``DeviceSpec.tms320c6678()``), each
   through ``build_engine`` in vanilla, ho and xenos (ho and xenos also
   under the plan ``select_kernel_plan({"accelerator": "cuda"})``
   returns, xenos eager and as one CUDA graph).  The modes must agree at
   the reference's engine tolerance (rtol 3e-4, atol 3e-5, TF32 off), the
   routed ho and xenos must equal their plain-plan runs to 2e-5, the
   ``cbr_avgpool`` launch counter must rise in the xenos runs of the CBRA
   graphs, and ``split_matmul`` must launch 4 times per routed ho or
   xenos inference of bert_s (its four FFN matmuls, split three ways)
   and never for the other graphs.  Prints the
   median ms per inference per graph and mode (Fig. 7 on the card) and
   the device busy share of xenos.

Phase 2 also holds ``cbr_avgpool`` against ``cbr_avgpool_plain`` element
by element (|kernel - plain| <= 2e-5 + 2e-5 |plain|, fp32) at the
Figure-5 and Table-4 shapes and at odd H and W, C = 3, OC = 10, N = 2, and
times the kernel, its plain version and the unlinked form (``addmm``,
``relu_``, ``avg_pool2d`` over the materialized pre-pool map);
``linked_mlp`` against ``linked_mlp_plain`` (bf16 1e-3 / 2e-2, fp32
2e-5 / 2e-5) at the serving shapes, decode (8, 2048, 6144) and prefill
(8 x the engine's chunk, 2048, 6144), and at fp32, ragged and M = 1
shapes; at batched prefill's shape (8 x the longest prompt, 2048, 6144)
bf16, the kernel and its plain version each against the fp64-summed MLP
(the kernel's worst error within ``MLP_ORDER_FACTOR`` times the plain
version's; two planted faults must fail that test); timing the kernel,
its plain version and the unlinked three-matmul form (after phase 3
also at each chunked-prefill shape the serving runs reached: the chunk
the scheduler replanned to); and
``split_matmul`` against ``split_matmul_plain`` (fp32, 2e-5 / 2e-5) at
bert_s's two plan tiles, an inC split and a ragged case, timing the
kernel, its plain version and ``torch.addmm``.

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
#: cbr_avgpool: element-wise, IEEE fp32 on both sides
CBRA_TOL = dict(rtol=2e-5, atol=2e-5)
#: linked_mlp: element-wise (bf16: h and y rounded to bf16 on both sides)
MLP_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
           "bfloat16": dict(rtol=2e-2, atol=1e-3)}
#: linked_mlp at batched prefill's shape: the kernel's worst error from
#: the fp64-summed MLP, at most this many times the plain version's
MLP_ORDER_FACTOR = 2.0
#: the serving runs' prompt lengths, shortest and longest
PROMPT_LENS = (480, 544)
#: split_matmul: element-wise, IEEE fp32 on both sides
SPLIT_TOL = dict(rtol=2e-5, atol=2e-5)
#: qwen3-1.7b's MLP widths (configs/qwen3_1_7b.py)
D_MODEL, D_FF = 2048, 6144
#: split_matmul cases, (M, K, N, block_n, block_k): bert_s at seq 128,
#: d 768 under the DSP spec (its FFN matmuls split three ways), an inC
#: split, and ragged cases on both of the kernel's block shapes
SPLIT_CASES = {"ffn1": (128, 768, 3072, 1024, 768),
               "ffn2": (128, 3072, 768, 256, 3072),
               "inC": (128, 768, 3072, 3072, 256),
               "ragged": (33, 70, 100, 30, 27),
               "ragged_wide": (600, 70, 1000, 333, 27)}
#: the reference's engine tolerance between modes (fp32 conv reassociation)
ENGINE_TOL = dict(rtol=3e-4, atol=3e-5)
#: cbr_avgpool shapes, (N,H,W,C) and OC: the Figure-5 example and the two
#: Table-4 CBRA operators
CBRA_SHAPES = {"fig5": ((1, 16, 16, 64), 128),
               "t4_8x8": ((1, 8, 8, 1024), 1024),
               "t4_224": ((1, 224, 224, 24), 224)}
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


def check_close(label: str, got, want, dtype: str,
                tol: dict | None = None) -> float:
    """Fail unless every element is within ``tol`` (default TOL[dtype]) of
    the plain version; return the max abs error."""
    tol = tol or TOL[dtype]
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


def unlinked_cbra(x, w, b):
    """The unlinked form, Table 4's yardstick: ``addmm`` writes the
    pre-pool map, ``relu_`` rewrites it, ``avg_pool2d`` reads it back."""
    import torch
    import torch.nn.functional as F
    N, H, W, C = x.shape
    y = torch.addmm(b, x.reshape(-1, C), w).relu_()
    y = y.view(N, H, W, -1).permute(0, 3, 1, 2)
    return F.avg_pool2d(y, 2).permute(0, 2, 3, 1)


def check_cbr_avgpool(torch, ops, gen, report):
    # odd H and W, C = 3, OC = 10, N = 2; then one case per launch shape
    # (narrow, C over clusters of 8 and 4; wide with scalar stores)
    cases = dict(CBRA_SHAPES, odd=((2, 7, 9, 3), 10),
                 cluster8=((1, 4, 4, 256), 64), cluster4=((1, 6, 6, 100), 40),
                 wide_odd_oc=((1, 100, 98, 24), 45))
    worst, per_shape = 0.0, {}
    for label, (shape, oc) in cases.items():
        C = shape[-1]
        x = torch.randn(shape, generator=gen, device=DEV)
        w = torch.randn((C, oc), generator=gen, device=DEV) / C ** 0.5
        b = torch.randn((oc,), generator=gen, device=DEV) * 0.1
        want = ops.cbr_avgpool_plain(x, w, b)
        err = check_close(f"cbr_avgpool {label} {shape}@({C},{oc})",
                          ops.cbr_avgpool(x, w, b), want, "float32",
                          CBRA_TOL)
        worst = max(worst, err)
        if label not in CBRA_SHAPES:
            continue
        check_close(f"unlinked form {label}", unlinked_cbra(x, w, b), want,
                    "float32", CBRA_TOL)
        N, H, W, _ = shape
        M = N * H * W
        nbytes = 4 * (x.numel() + w.numel() + b.numel()
                      + N * (H // 2) * (W // 2) * oc)
        flops = 2 * M * C * oc + 3 * M * oc    # matmul; bias, relu, pool
        b_ms, b_by = bound_ms(nbytes, flops, "float32")
        per_shape[label] = {
            "shape": [*shape, oc],
            "ms": cuda_ms([lambda: ops.cbr_avgpool(x, w, b)]),
            "plain_ms": cuda_ms([lambda: ops.cbr_avgpool_plain(x, w, b)]),
            "unlinked_ms": cuda_ms([lambda: unlinked_cbra(x, w, b)]),
            "bound_ms": b_ms, "bound_by": b_by}
        r = per_shape[label]
        print(f"cbr_avgpool {label}: {r['ms']:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), plain {r['plain_ms']:.4f} ms, "
              f"unlinked {r['unlinked_ms']:.4f} ms")
    head = per_shape["t4_224"]
    report["cbr_avgpool"] = {
        "name": "cbr_avgpool", "route": "cuda",
        "source": "src/repro_torch/csrc/linked_cbr_pool.cu",
        "replaces": "src/repro/kernels/linked_cbr_pool/linked_cbr_pool.py:33",
        "max_abs_err": worst, "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        # no single PyTorch call computes it; the unlinked form is Table 4's
        # yardstick, recorded beside it
        "library_ms": None, "unlinked_ms": head["unlinked_ms"],
        "shape": head["shape"], "per_shape": per_shape,
    }


def mlp_inputs(torch, M, d, ff, dtype, gen):
    """x ~ N(0, 1) and weights at the model's fan-in scale, in dtype."""
    rnd = lambda *s: torch.randn(s, generator=gen, device=DEV)
    return (rnd(M, d).to(dtype), (rnd(d, ff) / d ** 0.5).to(dtype),
            (rnd(d, ff) / d ** 0.5).to(dtype),
            (rnd(ff, d) / ff ** 0.5).to(dtype))


def unlinked_mlp(x, wg, wu, wd):
    """The unlinked form, the served ``torch`` backend of the
    ``linked_matmul`` site: three matmuls in x's dtype, h through device
    memory."""
    import torch.nn.functional as F
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def mlp_fp64(torch, args):
    """The MLP with its sums taken in fp64 and h and y rounded to x's
    dtype as in the plain version: what any correct summation order
    rounds to, up to order noise."""
    F = torch.nn.functional
    dt = args[0].dtype
    x, wg, wu, wd = (a.double() for a in args)
    h = (F.silu(x @ wg) * (x @ wu)).to(dt)
    return (h.double() @ wd).to(dt)


def mlp_err(got, ref, tol) -> float:
    """Worst |got - ref| / (atol + rtol |ref|) over the elements."""
    got, ref = got.float(), ref.float()
    return ((got - ref).abs() / (tol["atol"] + tol["rtol"] * ref.abs())
            ).max().item()


def time_mlp_case(torch, ops, gen, label, args, row):
    """The kernel's, plain and unlinked times at ``args``' shape, rotating
    over two weight sets (151 MB at the served widths, past the 50 MB L2:
    serving reads each layer's weights cold)."""
    (M, d), ff = args[0].shape, args[1].shape[1]
    sets = [args, mlp_inputs(torch, M, d, ff, args[0].dtype, gen)]
    nbytes = 2 * (3 * d * ff + 2 * M * d)
    flops = 2 * M * d * ff * 3 + 4 * M * ff    # matmuls; silu, product
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    r = row["per_shape"].setdefault(label, {})
    r.update({
        "shape": [M, d, ff],
        "ms": cuda_ms([lambda a=a: ops.linked_mlp(*a) for a in sets]),
        "plain_ms": cuda_ms([lambda a=a: ops.linked_mlp_plain(*a)
                             for a in sets]),
        "unlinked_ms": cuda_ms([lambda a=a: unlinked_mlp(*a) for a in sets]),
        "bound_ms": b_ms, "bound_by": b_by})
    print(f"linked_mlp {label} ({M},{d})@({d},{ff}): {r['ms']:.4f} ms, "
          f"bound {b_ms:.4f} ms ({b_by}), plain {r['plain_ms']:.4f} ms, "
          f"unlinked {r['unlinked_ms']:.4f} ms")


def linked_mlp_case(torch, ops, gen, label, shape, row, timed):
    """Hold ``linked_mlp`` against its plain version at ``shape`` (M, d,
    ff, dtype), twice (the same bits both times), and fold the error into
    ``row``; ``timed`` also prints how far the plain version lands from
    the fp64-summed one and times the shape."""
    M, d, ff, dt = shape
    name = str(dt).split(".")[-1]
    args = mlp_inputs(torch, M, d, ff, dt, gen)
    got = ops.linked_mlp(*args)
    if not torch.equal(got, ops.linked_mlp(*args)):
        fail(f"linked_mlp {label}: two launches gave different bits")
    plain = ops.linked_mlp_plain(*args)
    err = check_close(f"linked_mlp {label} {name} ({M},{d})@({d},{ff})",
                      got, plain, name, MLP_TOL[name])
    key = "max_abs_err" if name == "bfloat16" else "max_abs_err_fp32"
    row[key] = max(row.get(key, 0.0), err)
    if not timed:
        return
    # how far two correct summation orders land apart once h is rounded
    # to bf16, in units of the limit
    noise = mlp_err(plain, mlp_fp64(torch, args), MLP_TOL[name])
    print(f"linked_mlp {label}: fp32 plain vs fp64-summed plain, worst "
          f"err / (atol + rtol |fp64|) {noise:.3f}")
    row["per_shape"][label] = {"order_noise": noise}
    time_mlp_case(torch, ops, gen, label, args, row)


def linked_mlp_batched(torch, ops, gen, row):
    """Batched prefill's shape: the engine pads a group of ``SLOTS``
    admitted prompts to the longest, so M = SLOTS x PROMPT_LENS[1].  In
    bf16 at thousands of rows the kernel and the plain version (each a
    correct fp32 summation order, each rounding h to bf16) can land a few
    ulps apart, past the element-wise limit.  So each is held against the
    fp64-summed MLP instead: on 3 input sets the kernel's worst error must stay within ``MLP_ORDER_FACTOR`` times the
    plain version's on the same inputs.  Two planted faults, launched
    through the kernel, must fail the same test: one up-projection term
    (the last of d) and one ff column (the last) left out."""
    M = SLOTS * PROMPT_LENS[1]
    tol = MLP_TOL["bfloat16"]
    worst = {"kernel": 0.0, "plain": 0.0, "ratio": 0.0}
    for i in range(3):
        args = mlp_inputs(torch, M, D_MODEL, D_FF, torch.bfloat16, gen)
        got = ops.linked_mlp(*args)
        if not torch.equal(got, ops.linked_mlp(*args)):
            fail("linked_mlp batched_prefill: two launches gave different "
                 "bits")
        ref = mlp_fp64(torch, args)
        plain = ops.linked_mlp_plain(*args)
        e_k, e_p = mlp_err(got, ref, tol), mlp_err(plain, ref, tol)
        e_kp = mlp_err(got, plain, tol)
        x, wg, wu, wd = args
        x_cut = x.clone()
        x_cut[:, -1] = 0
        wd_cut = wd.clone()
        wd_cut[-1] = 0
        faults = {"d_term": mlp_err(ops.linked_mlp(x_cut, wg, wu, wd), ref,
                                    tol),
                  "ff_column": mlp_err(ops.linked_mlp(x, wg, wu, wd_cut),
                                       ref, tol)}
        print(f"linked_mlp batched_prefill set {i} ({M},{D_MODEL})@"
              f"({D_MODEL},{D_FF}) bf16, worst err / (atol + rtol |fp64|): "
              f"kernel {e_k:.3f}, plain {e_p:.3f} (kernel vs plain "
              f"{e_kp:.3f}); planted faults "
              + ", ".join(f"{k} {v:.3f}" for k, v in faults.items()))
        if not e_k <= MLP_ORDER_FACTOR * e_p:
            fail(f"linked_mlp batched_prefill set {i}: kernel {e_k:.3f} > "
                 f"{MLP_ORDER_FACTOR} x plain {e_p:.3f} from the fp64 sum")
        for k, v in faults.items():
            if v <= MLP_ORDER_FACTOR * e_p:
                fail(f"linked_mlp batched_prefill set {i}: the planted "
                     f"fault {k} ({v:.3f}) passes the test")
        worst = {"kernel": max(worst["kernel"], e_k),
                 "plain": max(worst["plain"], e_p),
                 "ratio": max(worst["ratio"], e_k / e_p)}
        row["max_abs_err"] = max(row.get("max_abs_err", 0.0),
                                 (got.float() - plain.float()).abs().max()
                                 .item())
        del args, got, ref, plain, x_cut, wd_cut
    row["per_shape"]["batched_prefill"] = {"vs_fp64": worst}
    time_mlp_case(torch, ops, gen, "batched_prefill",
                  mlp_inputs(torch, M, D_MODEL, D_FF, torch.bfloat16, gen),
                  row)


def check_linked_mlp(torch, ops, gen, chunk, report):
    """The served shapes, decode (slots rows), chunked prefill (slots x
    the engine's chunk rows) and batched prefill, timed; then fp32,
    ragged and M = 1."""
    bf16, f32 = torch.bfloat16, torch.float32
    row = report["linked_mlp"] = {
        "name": "linked_mlp", "route": "cuda",
        "source": "src/repro_torch/csrc/linked_mlp.cu",
        "replaces": "src/repro/kernels/linked_matmul/linked_matmul.py:42",
        # no single PyTorch call computes it; the unlinked three-matmul
        # form (the served torch backend) is recorded beside it
        "library_ms": None, "per_shape": {}}
    cases = {"decode": (SLOTS, D_MODEL, D_FF, bf16),
             f"prefill_c{chunk}": (SLOTS * chunk, D_MODEL, D_FF, bf16),
             "m1": (1, D_MODEL, D_FF, bf16),
             "fp32": (64, 1024, 2048, f32),
             # more row tiles than SMs: one ff split, each CTA walks all
             # of ff (as batched prefill does)
             "fp32_one_split": (1100, 256, 512, f32),
             "ragged_bf16": (37, 2000, 1000, bf16),
             "ragged_fp32": (13, 2047, 129, f32),
             "ragged_ff_bf16": (5, 136, 200, bf16),
             "ragged_m_bf16": (37, 256, 208, bf16)}
    for i, (label, shape) in enumerate(cases.items()):
        linked_mlp_case(torch, ops, gen, label, shape, row, timed=i < 2)
    linked_mlp_batched(torch, ops, gen, row)
    head = row["per_shape"]["decode"]
    row.update({k: head[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "unlinked_ms", "shape")})


def linked_mlp_path_shapes(torch, ops, gen, runs, chunk, report):
    """The chunked-prefill shapes the serving runs reached that phase 2
    did not time: the chunks ``serve_schedule`` replanned to."""
    chunks = sorted({r["plan"]["chunk"] for r in runs.values()} - {chunk})
    for c in chunks:
        linked_mlp_case(torch, ops, gen, f"prefill_c{c}",
                        (SLOTS * c, D_MODEL, D_FF, torch.bfloat16),
                        report["linked_mlp"], timed=True)


def check_split_matmul(torch, ops, gen, report):
    worst, per_shape = 0.0, {}
    for label, (M, K, N, bn, bk) in SPLIT_CASES.items():
        x = torch.randn((M, K), generator=gen, device=DEV)
        w = torch.randn((K, N), generator=gen, device=DEV) / K ** 0.5
        b = torch.randn((N,), generator=gen, device=DEV)
        worst = max(worst, check_close(
            f"split_matmul {label} ({M},{K})@({K},{N}) block_n {bn} "
            f"block_k {bk}", ops.split_matmul(x, w, b, block_n=bn,
                                               block_k=bk),
            ops.split_matmul_plain(x, w, b, bn, bk), "float32", SPLIT_TOL))
        if label not in ("ffn1", "ffn2"):
            continue
        nbytes = 4 * (M * K + K * N + N + M * N)
        b_ms, b_by = bound_ms(nbytes, 2 * M * K * N + M * N, "float32")
        per_shape[label] = {
            "shape": [M, K, N, bn, bk],
            "ms": cuda_ms([lambda: ops.split_matmul(x, w, b, block_n=bn,
                                                    block_k=bk)]),
            "plain_ms": cuda_ms([lambda: ops.split_matmul_plain(
                x, w, b, bn, bk)]),
            "library_ms": cuda_ms([lambda: torch.addmm(b, x, w)]),
            "bound_ms": b_ms, "bound_by": b_by}
        r = per_shape[label]
        print(f"split_matmul {label}: {r['ms']:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}), plain {r['plain_ms']:.4f} ms, addmm "
              f"{r['library_ms']:.4f} ms")
    head = per_shape["ffn1"]
    report["split_matmul"] = {
        "name": "split_matmul", "route": "cuda",
        "source": "src/repro_torch/csrc/split_matmul.cu",
        "replaces": "src/repro/kernels/split_matmul/split_matmul.py:33",
        "max_abs_err": worst, "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"], "shape": head["shape"],
        "per_shape": per_shape,
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
        n = int(rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1))
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
    # the plain-torch plan at every site; the model's own plan, so the
    # margin logits of model.forward come from it too
    plain = pipeline.KernelPlan(decode_dense="torch", decode_paged="gather",
                                prefill_chunk="torch", linked_matmul="torch",
                                split_matmul="torch", sampler="fused")
    model = Model(small, kernel_plan=plain, device=DEV)
    params = model.cast_params(model.init(
        torch.Generator(device=DEV).manual_seed(1)))
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
        routed = streams["routed"][2]
        if routed.decode_dense != "cuda" or routed.sampler != "cuda" \
                or routed.linked_matmul != "cuda":
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


# ---------------------------------------------------------------------------
# phase 5: the CNN path (the paper's Fig. 7 on the card)
# ---------------------------------------------------------------------------

def cnn_graphs(cnn_zoo, launch, dsp) -> dict:
    """label -> (graph, planner's DeviceSpec or None for the H100's): the
    zoo's MobileNet and ResNet18 at their published input size and widths
    (zoo depth), the Figure-5 graph, the Table-4 CBRA graphs, and the
    zoo's bert_s at BERT-base width planned under the paper's DSP spec
    ``dsp``."""
    return {
        "mobilenet_224": (cnn_zoo.mobilenet(res=224, width=1.0,
                                            n_classes=1000), None),
        "resnet18_224": (cnn_zoo.resnet18(res=224, width=64,
                                          n_classes=1000), None),
        "fig5": (launch.fig5_graph(), None),
        **{label: (launch.cbra_graph(label, shape, oc), None)
           for label, (shape, oc) in CBRA_SHAPES.items() if label != "fig5"},
        "bert_s_dsp": (cnn_zoo.bert_s(seq=128, d=768, n_layers=2), dsp),
    }


def host_ms(fn, iters: int, warmup: int = 3) -> float:
    """Median host time of ``fn`` (which synchronizes the card)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t0)
    times.sort()
    return 1e3 * times[len(times) // 2]


def device_ms(torch, fn, calls: int = 10):
    """Device kernel time per call over ``calls`` calls (torch.profiler's
    CUDA rows), or None when the profiler sees no device time."""
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return profile_window(torch, prof, calls)["device_ms_per_tick"]


#: (run, mode, routed, graphed); a routed run uses the cuda plan
RUNS = (("vanilla", "vanilla", False, False), ("ho", "ho", False, False),
        ("ho_cuda", "ho", True, False),
        ("xenos_torch", "xenos", False, False),
        ("xenos_eager", "xenos", True, False),
        ("xenos_graph", "xenos", True, True))
#: the CNN path's kernels
CNN_KERNELS = ("cbr_avgpool", "split_matmul")
#: split_matmul launches per routed ho / xenos inference, by graph
SPLITS = {"bert_s_dsp": 4}


def cnn_phase(torch, kernels, core, plan, graphs, iters: int = 20) -> dict:
    """Every graph through build_engine in each mode; returns per-graph
    times, launches and agreement."""
    gen = torch.Generator(device=DEV).manual_seed(5)
    out: dict = {}
    print("CNN path, median ms per inference (host clock, synchronized):")
    print(f"  {'graph':14s} {'vanilla':>9s} {'ho':>9s} {'ho cuda':>9s} "
          f"{'xenos/torch':>11s} {'xenos eager':>11s} {'xenos graph':>11s}  "
          "device ms (eager, graph)  launches per inference")
    for label, (g, device) in graphs.items():
        params = core.init_params(g, seed=0, device=DEV)
        xs = [torch.randn(g.tensors[name].shape, generator=gen, device=DEV)
              for name in g.inputs]
        res, outs = {}, {}
        for run, mode, routed, graphed in RUNS:
            eng, _ = core.build_engine(g, mode, device=device,
                                       plan=plan if routed else None,
                                       graphed=graphed)
            kernels.reset_launches()
            got = eng(params, *xs)      # graphed: warm-up, capture, replay
            outs[run] = [o.clone() for o in got]
            first = dict(kernels.LAUNCHES)
            kernels.reset_launches()
            eng(params, *xs)
            per_inference = {k: kernels.LAUNCHES[k] for k in CNN_KERNELS}
            ms = host_ms(lambda: eng(params, *xs), iters)
            res[run] = {"ms": ms, "per_inference": per_inference,
                        **{k: first[k] + kernels.LAUNCHES[k]
                           for k in CNN_KERNELS}}
            if mode == "xenos" and routed:
                res[run]["device_ms"] = device_ms(
                    torch, lambda: eng(params, *xs))
            del eng
        want_shape = g.tensors[g.outputs[0]].shape
        for run, o in outs.items():
            if tuple(o[0].shape) != tuple(want_shape) \
                    or not torch.isfinite(o[0]).all():
                fail(f"{label} {run}: output {tuple(o[0].shape)} not finite "
                     f"or not {want_shape}")
        errs = {run: check_close(f"  {label} {run} vs vanilla", outs[run][0],
                                 outs["vanilla"][0], "float32", ENGINE_TOL)
                for run in ("ho", "ho_cuda", "xenos_torch", "xenos_eager",
                            "xenos_graph")}
        errs["routed_vs_torch"] = check_close(
            f"  {label} routed xenos vs torch-plan xenos",
            outs["xenos_eager"][0], outs["xenos_torch"][0], "float32",
            CBRA_TOL)
        errs["routed_ho_vs_torch"] = check_close(
            f"  {label} routed ho vs torch-plan ho", outs["ho_cuda"][0],
            outs["ho"][0], "float32", SPLIT_TOL)
        errs["graph_vs_eager"] = check_close(
            f"  {label} CUDA-graph xenos vs eager xenos",
            outs["xenos_graph"][0], outs["xenos_eager"][0], "float32",
            CBRA_TOL)
        cbra = label in CBRA_SHAPES
        for run in ("xenos_eager", "xenos_graph"):
            if cbra and res[run]["per_inference"]["cbr_avgpool"] <= 0:
                fail(f"{label} {run}: cbr_avgpool was never launched")
        for run in ("ho_cuda", "xenos_eager", "xenos_graph"):
            n = res[run]["per_inference"]["split_matmul"]
            if n != SPLITS.get(label, 0):
                fail(f"{label} {run}: split_matmul launched {n} times per "
                     f"inference, want {SPLITS.get(label, 0)}")
        for run in ("vanilla", "ho", "xenos_torch"):
            if any(res[run][k] for k in CNN_KERNELS):
                fail(f"{label} {run}: a kernel launched off its route")
        dev = [res[r]["device_ms"] for r in ("xenos_eager", "xenos_graph")]
        busy = [d / res[r]["ms"] if d else None for d, r in
                zip(dev, ("xenos_eager", "xenos_graph"))]
        fmt = lambda v: "not measured" if v is None else f"{v:.4f}"
        counts = ", ".join(f"{k} {res['xenos_graph']['per_inference'][k]}"
                           for k in CNN_KERNELS)
        print(f"  {label:14s} " + " ".join(
            f"{res[r]['ms']:{9 if i < 3 else 11}.4f}"
            for i, r in enumerate(("vanilla", "ho", "ho_cuda", "xenos_torch",
                                   "xenos_eager", "xenos_graph")))
            + f"  {fmt(dev[0])}, {fmt(dev[1])}  {counts}")
        print(f"    busy share eager {fmt(busy[0])}, graph {fmt(busy[1])}; "
              f"max abs err {', '.join(f'{k} {v:.2e}' for k, v in errs.items())}")
        out[label] = {"inputs": [list(x.shape) for x in xs], "runs": res,
                      "errors": errs, "planner": device.name if device
                      else "h100_sxm",
                      "busy_share": {"xenos_eager": busy[0],
                                     "xenos_graph": busy[1]},
                      "ops": len(g.nodes)}
        del params
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
    from repro_torch import core
    from repro_torch.configs import cnn_zoo
    from repro_torch.configs.base import get_config
    from repro_torch.core import pipeline
    from repro_torch.kernels.decode_attention import ops as dec_ops
    from repro_torch.kernels.fused_sampler import ops as fs_ops
    from repro_torch.core.dos import DeviceSpec
    from repro_torch.kernels.linked_cbr_pool import ops as cb_ops
    from repro_torch.kernels.linked_matmul import ops as lm_ops
    from repro_torch.kernels.split_matmul import ops as sm_ops
    from repro_torch.launch import optimize_graph, serve
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
    # and its prefill chunk: linked_mlp's prefill shape is (slots x chunk)
    chunk = paged_engine.scheduler.cfg.chunk

    gen = torch.Generator(device=DEV).manual_seed(0)
    report: dict = {}
    check_dense(torch, dec_ops, gen, report)
    check_paged(torch, dec_ops, gen, bs, report)
    check_fused_mask(torch, fs_ops, gen, report)
    check_cbr_avgpool(torch, cb_ops, gen, report)
    check_linked_mlp(torch, lm_ops, gen, chunk, report)
    check_split_matmul(torch, sm_ops, gen, report)
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
    need = {"dense_greedy": ("gqa_decode", "fused_mask", "linked_mlp"),
            "paged_sampled": ("gqa_decode_paged", "fused_mask",
                              "linked_mlp")}
    for label, names in need.items():
        for name in names:
            if runs[label]["launches"].get(name, 0) <= 0:
                fail(f"{label}: kernel {name} was never launched")
    result["serve"] = runs
    linked_mlp_path_shapes(torch, lm_ops, gen, runs, chunk, report)
    del params
    torch.cuda.empty_cache()
    result["parity"] = parity_phase(torch, serve, pipeline, Model, cfg)
    torch.cuda.empty_cache()

    plan, _ = pipeline.select_kernel_plan({"accelerator": "cuda"})
    if plan.linked_matmul != "cuda" or plan.split_matmul != "cuda":
        fail(f"the cuda kernel plan does not route linked_matmul and "
             f"split_matmul: {plan}")
    result["cnn"] = cnn_phase(
        torch, kernels, core, plan,
        cnn_graphs(cnn_zoo, optimize_graph, DeviceSpec.tms320c6678()))

    table = []
    for name in ("gqa_decode", "gqa_decode_paged", "fused_mask",
                 "cbr_avgpool", "linked_mlp", "split_matmul"):
        row = dict(report[name])
        if name in CNN_KERNELS:
            row["launches"] = sum(
                g["runs"][r][name] for g in result["cnn"].values()
                for r in ("ho_cuda", "xenos_eager", "xenos_graph"))
        else:
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
