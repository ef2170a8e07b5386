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
   length-0 rows, k <= 0, T = 0, p = 1 and ties; decode also at lengths
   on each boundary of the kernel's live-span split (and one slot either
   side), in dense rings that start late, wrap, or hold only the last
   slot; decode element by element (|kernel - plain| <= atol + rtol
   |plain|), the mask by equal support outside the nucleus-boundary
   tokens and equal survivor values, twice (the same bits), at the
   served, greedy and top-p-only policies too; time kernel, plain
   version and the library yardstick with CUDA events, and print each
   decode kernel's share of its bound and ``fused_mask``'s at each of
   the three policies, beside the plan ``mask_plan`` picks, and at a
   verify's rows (8 x K1 for K1 = 5 and 13, the served policy); and at
   gemma3-1b's shapes: both decode kernels at head_dim 256 (q (8, 4,
   256)) over a sliding layer's 512-slot ring (wrapped spans starting
   mid-row) and a global layer's 2048-slot horizon, dense and paged
   (the mixed pool's block size and 16), one row at the D = 256 split
   cap, timed beside SDPA; ``fused_mask`` at (8, 262144), served and
   greedy; ``linked_mlp_tc`` at d 1152, ff 6912 (a cluster of 5), M = 8
   and 256, beside the unlinked form; and at hymba-1.5b's and
   mamba2-370m's: ``gqa_decode`` at 25 q / 5 kv heads of 64 (G = 5) over
   1024-slot rings (wrapped spans, prefixes), timed beside SDPA;
   ``linked_mlp_tc`` at d 1600, ff 5504 (a cluster of 7, its last rank
   64 columns), M = 8 and 256; ``fused_mask`` at (8, 32001) in a
   32,256-wide row and at (8, 50280) in a 50,432-wide one, served and
   greedy; and at a concat-TP rank's heads (qwen3's over 2 ranks, 8 q / 4
   kv, and over 4, 4 / 2), both decode kernels against their plain
   versions, timed at 8 / 4 beside the plain version and SDPA; and at MHA
   (G = 1): both decode kernels at olmoe-1b-7b's 16 q / 16 kv heads of
   128 over a 2048-slot horizon (~560 live slots timed), ``gqa_decode``
   at seamless-m4t-large-v2's 16 / 16 of 64 over a 512-frame cross span
   with every slot valid and over its 69-slot self span, each timed
   beside SDPA; ``fused_mask`` at (8, 50304) in 50,432-wide rows and at
   (8, 256206) in 256,256-wide rows, served and greedy;
3. serve full-width qwen3-1.7b (random weights from ``Model.init``,
   seeded) through ``repro_torch.launch.serve``'s engine: 16 requests of
   ~512-token prompts, 64 new tokens each, once with dense KV greedy and
   once with paged KV sampled (T 0.8, top-k 50, top-p 0.95), each run
   graphed (the decode step a CUDA graph) and eager on the same
   requests, with replanning off (a replan adopts a chunk and prefill
   mode from timings, which differ between the two), and their token
   streams equal bit for bit; then the dense run once more, graphed,
   replanning every 32 ticks as ``launch.serve`` does (it must replan).
   Every request must complete with in-vocabulary tokens and each
   kernel's launch counter must rise during the runs that route through
   it (``linked_mlp`` in both: every layer's SwiGLU MLP, prefill and
   decode; every prefill launch must go through its tensor-core kernel,
   counted as ``linked_mlp_tc``); each run's decode-attention kernel
   must launch once per layer of every decode step (K1 times at a verify
   of width K1), and ``fused_mask`` once per dispatch of the engine's
   samplers (a replay of a sampling graph included), each graph's
   warm-ups adding one replay's launches a capture; a graph replay
   counts the launches its capture recorded.  Step times, sampler
   dispatches and warm-ups are the engine's own ``stats()``.  Prints the
   steady decode step (the engine's synchronized step time, the
   capturing and profiled steps apart), the device ms per tick from the
   profiler, the busy share (that device time over the steady step),
   and each graph's capture time and pool;
3b. speculative decoding at full width, each run beside a spec-off twin
   with the same requests and seeds, streams equal bit for bit: the
   paged sampled run with ``spec ngram`` (k 4), a dense greedy run of 8
   requests with ``spec draft`` (qwen3's reduced config at the full
   vocabulary, k 12: it meets every verify width from 2 to 13, all its
   graphs in one pool), and a dense greedy run of 4 requests with the
   target as its own draft (an oracle: on random weights neither of the
   others predicts the target); the two draft-model runs are not
   profiled (their drafts run eagerly inside the window, and profiling
   them cost ~60 s); at least one draft accepted and one rejected
   over the three.  Prints each run's acceptance, verify calls, verify
   ms by width K1, its graphs' pool and decode tokens/s beside its
   twin's;
3c. the attention cache families at full width: gemma3-1b (26 layers
   ``SSSSSG``, window 512, RoPE theta 10k / 1M; random weights, seed 0,
   bf16) serving 16 requests of 600-1100-token prompts (past the
   window: every sliding ring wraps in prefill) and 64 new tokens, dense
   KV greedy and the mixed pool sampled (T 0.8, top-k 50, top-p 0.95),
   each graphed beside its eager twin, streams equal bit for bit; a
   decode tick launches ``gqa_decode`` 26 times (dense) or 22 times plus
   ``gqa_decode_paged`` 4 times (mixed), ``linked_mlp_tc`` 26 times and
   ``fused_mask`` once; every request holds a classic and a ring lease,
   the ring lease window / block size blocks whatever its context; then
   qwen3-1.7b with a 512-token window, 8 requests, ring-paged beside
   dense KV, greedy, streams equal bit for bit.  Prints each run's
   steady step, busy share, profiled kernels and KV bytes beside the
   dense full-attention KV;
3d. the recurrent cache families at full width (random weights, seed 0,
   bf16, dense KV, chunked prefill at chunk 32, replanning off):
   hymba-1.5b (32 layers, d 1600, attention and Mamba2 heads in
   parallel, window 1024, SSM 50 heads x 64 x state 16) serving 16
   requests of 1100-1600-token prompts (every ring wraps in prefill) and
   64 new tokens, greedy and sampled (T 0.8, top-k 50, top-p 0.95), and
   mamba2-370m (48 layers, d 1024, SSM 32 heads x 64 x state 128)
   serving 16 requests of 480-544-token prompts, greedy; each run
   graphed beside its eager twin, streams equal bit for bit, the plan's
   ``kv_growth`` "constant"; a hymba decode replay launches
   ``gqa_decode`` and ``linked_mlp_tc`` 32 times and ``fused_mask``
   once, a mamba2 one ``fused_mask`` alone (no attention or MLP kernel
   ever).  Prints each run's steady step, busy share and cache bytes
   (ring KV, SSM state, conv register) beside hymba's full-attention KV;
3e. replica routing and concat tensor parallelism on qwen3-1.7b at full
   width: (a) two graphed, paged replicas on the one card behind a
   ``ReplicaRouter``, sharing phase 3's params, serving 16 requests in 4
   groups (each a shared 256-token block-aligned prefix, then a tail
   shorter than a block), 32 new tokens, greedy and seeded sampled: every
   stream equal to a solo graphed engine's, prefix affinity hits, both
   replicas busy, then again with replica 1 failed after 12 ticks (its
   requests requeued and replayed, still equal); prints the router's
   stats; (b) two concat-TP ranks on the one card (spawned processes,
   ``devices=["cuda:0", "cuda:0"]``, gloo, eager; both load the kernels
   built here), dense greedy and paged sampled, 8 requests of 120-160
   tokens, 24 new tokens, beside a one-device eager engine under the
   ranks' kernel plan on the same requests: a rank's decode kernels
   take one device's split count, so a teacher-forced logits probe's
   bits must equal the one-device bits and every stream, greedy and
   sampled (T 0.8, top-k 50, top-p 0.95), the one-device stream (the
   probe also prints the worst difference between a rank's half of
   each sharded projection and the one-device columns); each rank's KV
   bytes half the one-device engine's at 4 kv heads, its decode kernel
   launched 28 times a decode step, ``fused_mask`` once a sampler
   dispatch, no ``linked_mlp``; a rank that fails or overruns its time
   limit fails the run.  Prints the eager decode step and busy share of
   rank 0 and of the one-device engine;
3f. MoE and encoder-decoder at full width (random weights, seed 0,
   bf16): (a) olmoe-1b-7b (16 layers, d 2048, 16 q / 16 kv heads of
   128, 64 experts top 8 of ff 1024, vocab 50,304; 6.82 B params)
   serving phase 3's traffic, dense KV greedy and paged KV sampled, each
   graphed beside its eager twin, then the paged run with ``spec ngram``
   (k 4) beside it, streams equal bit for bit; a decode replay launches
   16 ``gqa_decode`` (or ``gqa_decode_paged``), one ``fused_mask`` and
   no ``linked_mlp`` (the experts have no kernel site); prints each
   run's steady step, busy share, KV bytes and graphs, and the MoE FFN's
   device ms a decode tick (every layer's ``moe_block`` at the decode
   shape, profiler and CUDA events) beside the least time for the expert
   weights its rows route to, and its share of a graphed tick; (b)
   reduced arctic-480b (2 layers, d 256, 4 experts top 2, its dense
   SwiGLU residual), dense greedy, graphed ≡ eager, a decode replay 2
   ``linked_mlp_tc``; (c) seamless-m4t-large-v2 (24 + 24 layers, d
   1024, ff 8192, 16 / 16 heads of 64, vocab 256,206) through
   ``launch/translate_audio.py``: 8 utterances of 512 stub frames, a
   4-token prompt and 64 decode steps, greedy and sampled, 48
   ``gqa_decode`` a step (24 self, 24 cross), one ``fused_mask`` a
   sampled step, no ``linked_mlp``; prints the encoder's device ms, the
   decode step, busy share and cross-KV bytes;
4. hold the routed ``cuda`` plan against the plain-torch plan (every
   site) on the same weights and prompts at reduced depth (qwen3 at 2
   layers; gemma3 at 6, five sliding and one global, 600-token
   prompts; hymba at 4, dense KV, its attention drawn at one layer's
   fan-in; olmoe at 2, dense and paged, and seamless at 2 + 2, through
   the translate driver, every attention likewise): greedy streams must
   match wherever the plain path's top-1/top-2 logit margin (its
   engine's computation replayed for one request) exceeds the bf16
   tolerance; an olmoe stream may also part after a routing decision
   within the bf16 tolerance of its top-k boundary (a bf16 difference
   in a layer's input can swap an expert: ``routing_margins``);
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
by element (|kernel - plain| <= 2e-5 + 2e-5 |plain|, fp32), twice (the
same bits), at the Figure-5 and Table-4 shapes and at odd H and W, C = 3,
OC = 10, N = 2, printing the plan ``cbra_plan`` picks for each, and
times the kernel, its plain version and the unlinked form (``addmm``,
``relu_``, ``avg_pool2d`` over the materialized pre-pool map), printing
at t4_8x8 whether the kernel beats either (a finding, not a gate);
``linked_mlp`` against ``linked_mlp_plain`` (bf16 1e-3 / 2e-2, fp32
2e-5 / 2e-5) at the serving shapes, decode (8, 2048, 6144) and prefill
(8 x each chunk a replan may adopt, 8 to 64, 2048, 6144), and at fp32,
ragged and M = 1
shapes, printing the plan (kernel, tile, cluster, ff splits) of each;
at batched prefill's shape (8 x the longest prompt, 2048, 6144)
bf16, which must take the tensor-core kernel, the kernel and its plain
version each against the fp64-summed MLP
(the kernel's worst error within ``MLP_ORDER_FACTOR`` times the plain
version's; two planted faults must fail that test); timing the kernel,
its plain version and the unlinked three-matmul form at the served
shapes; and
``split_matmul`` against ``split_matmul_plain`` (fp32, 2e-5 / 2e-5) at
bert_s's two plan tiles, inC splits (one with a cluster split inside
each of its K tiles), M = 1 and ragged cases, twice each (the same
bits), timing the kernel, its plain version and ``torch.addmm``.  Phase
1 prints the registers and spills ``nvcc -Xptxas -v`` reports for the
instantiations of the two GEMM kernels, ``fused_mask`` and
``cbr_avgpool``.

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
#: the oracle-draft run's prompts (its full-width draft feeds them eagerly)
ORACLE_PROMPT_LENS = (64, 128)
#: speculative runs: draft length (the n-gram and oracle runs, and the
#: reduced-draft run's), and the verify widths phase 2 holds fused_mask at
SPEC_K = 4
DRAFT_SPEC_K = 12
VERIFY_K1S = (SPEC_K + 1, DRAFT_SPEC_K + 1)
#: the replan period of the serving runs with a twin: never (see phase 3)
PINNED = 10_000
#: split_matmul: element-wise, IEEE fp32 on both sides
SPLIT_TOL = dict(rtol=2e-5, atol=2e-5)
#: qwen3-1.7b's MLP widths (configs/qwen3_1_7b.py)
D_MODEL, D_FF = 2048, 6144
#: split_matmul cases, (M, K, N, block_n, block_k): bert_s at seq 128,
#: d 768 under the DSP spec (its FFN matmuls split three ways), inC
#: splits, the second with each of its 3 K tiles split again over a
#: cluster (SPLIT_CLUSTERED), M = 1, and ragged cases (4-byte copies)
SPLIT_CASES = {"ffn1": (128, 768, 3072, 1024, 768),
               "ffn2": (128, 3072, 768, 256, 3072),
               "inC": (128, 768, 3072, 3072, 256),
               "inC_cluster": (128, 3072, 768, 256, 1024),
               "m1": (1, 768, 3072, 1024, 768),
               "ragged": (33, 70, 100, 30, 27),
               "ragged_wide": (600, 70, 1000, 333, 27)}
#: the SPLIT_CASES whose plan must split every K tile over a cluster
SPLIT_CLUSTERED = ("inC_cluster",)
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
#: gemma3-1b (configs/gemma3_1b.py): 4 q / 1 kv heads of 256, d 1152, ff
#: 6912, vocab 262,144, a 512-token window on its sliding layers
G3_H, G3_K, G3_D, G3_WINDOW = 4, 1, 256, 512
G3_D_MODEL, G3_D_FF, G3_VOCAB = 1152, 6912, 262144
#: phase 3c's prompts: past the window, so every sliding ring wraps in
#: prefill
G3_PROMPT_LENS = (600, 1100)
#: phase 3c's profiled decode ticks (the first wave's decode)
G3_WINDOW_TICKS = (40, 45)
#: hymba-1.5b (configs/hymba_1_5b.py): 25 q / 5 kv heads of 64 over a
#: 1024-token window, d 1600, ff 5504, vocab 32,001 in a 32,256-wide
#: padded row; mamba2-370m's vocab 50,280 in a 50,432-wide row
HY_H, HY_K, HY_D, HY_WINDOW = 25, 5, 64, 1024
HY_D_MODEL, HY_D_FF, HY_VOCAB, HY_ROW = 1600, 5504, 32001, 32256
M2_VOCAB, M2_ROW = 50280, 50432
#: phase 3d's prompts: hymba's past its window (every ring wraps in
#: prefill), mamba2's phase 3's
HY_PROMPT_LENS = (1100, 1600)
M2_PROMPT_LENS = PROMPT_LENS
#: phase 3d's profiled decode ticks (the first wave's decode, every slot
#: decoding)
HY_WINDOW_TICKS = (60, 65)
M2_WINDOW_TICKS = (30, 35)
#: phase 3e (a): the routed requests (groups sharing a block-aligned
#: prefix, a tail shorter than a block each), new tokens, and the router
#: tick replica 1 fails at in the failover run
ROUTER_GROUPS, ROUTER_PER_GROUP, ROUTER_PREFIX = 4, 4, 256
ROUTER_NEW, ROUTER_FAIL_AT = 32, 12
#: phase 3e (b): the concat-TP runs (dense greedy, paged sampled at T
#: 0.8, top-k 50 and top-p 0.95, as one device samples: a rank's logits
#: equal one device's bit for bit), their prompts and new tokens, the
#: profiled decode ticks of rank 0 and the one-device twin, the ranks'
#: time limit, and the logits probe's shape
TP_RUNS = {"dense_greedy": dict(kv="dense", requests=8, max_new=24),
           "paged_sampled": dict(kv="paged", requests=8, max_new=24,
                                 temperature=0.8, top_k=50, top_p=0.95)}
TP_PROMPT_LENS, TP_PROMPT_SEED, TP_WINDOW = (120, 160), 23, (10, 14)
TP_TIMEOUT = 480.0
TP_PROBE_CHUNK, TP_PROBE_STEPS = 32, 3
#: olmoe-1b-7b (configs/olmoe_1b_7b.py): 16 q / 16 kv heads of 128 (G 1),
#: d 2048, 64 experts top 8 of ff 1024, vocab 50,304 in 50,432-wide rows;
#: phase 3f (a)'s profiled decode ticks (the first wave's decode)
OL_H, OL_K, OL_D = 16, 16, 128
OL_VOCAB, OL_ROW = 50304, 50432
OL_WINDOW_TICKS = (30, 35)
#: seamless-m4t-large-v2: 16 q / 16 kv heads of 64 (G 1), vocab 256,206
#: in 256,256-wide rows; phase 3f (c)'s utterances of stub frames, its
#: decode steps after the prefill's token and its profiled steps
SM_H, SM_K, SM_D = 16, 16, 64
SM_VOCAB, SM_ROW = 256206, 256256
SM_FRAMES, SM_NEW, SM_WINDOW = 512, 64, (20, 28)
#: the self-attention span of seamless's decode: the 4-token prompt and
#: the 64 new tokens, plus one
SM_SELF = 69


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


#: kernels whose registers and spills phase 1 prints, by the pattern of
#: their mangled names: the tensor-core linked_mlp, split_matmul (rows a
#: CTA, k halves, cluster size, 16-byte copies), fused_mask (cluster
#: size, 16-byte copies) and cbr_avgpool (thread columns and rows, k
#: parts, squares a thread, cluster size, 16-byte copies)
PTXAS_KERNELS = {
    r"linked_mlp_tcE": "linked_mlp_tc",
    r"split_matmul_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb(\d)E":
        "split_matmul_kernel<BM={},KH={},CL={},VEC={}>",
    r"fused_mask_kernelILi(\d+)ELb(\d)E": "fused_mask_kernel<CL={},VEC={}>",
    r"cbr_avgpool_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELb(\d)E":
        "cbr_avgpool_kernel<TXN={},TYN={},KH={},TSQ={},CL={},VEC={}>"}
#: the sources whose kernels those are
PTXAS_SOURCES = ("linked_mlp", "split_matmul", "fused_sampler",
                 "linked_cbr_pool")


def ptxas_report(log: str) -> dict:
    """Registers, stack frame and spill bytes of each kernel named in
    PTXAS_KERNELS, from an ``nvcc -Xptxas -v`` log; printed one line a
    kernel."""
    import re
    out, name, spill = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = None
            for pat, fmt in PTXAS_KERNELS.items():
                k = re.search(pat, m.group(1))
                if k:
                    name = fmt.format(*k.groups())
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            spill = tuple(int(g) for g in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            stack, stores, loads = spill or (0, 0, 0)
            out[name] = {"registers": int(m.group(1)), "stack": stack,
                         "spill_stores": stores, "spill_loads": loads}
            print(f"ptxas {name}: {m.group(1)} registers, stack {stack} B, "
                  f"spill stores {stores} B, loads {loads} B")
            name = spill = None
    return out


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


def split_edges(torch, ops):
    """The main shape's split count S and, in batches of SLOTS rows, the
    lengths where the kernel's pieces change: each split boundary of a
    full row, S, 16 S, 32 S and 64 S (pieces of one slot, half a 32-slot
    tile, one tile, two tiles) and W, each with one slot either side."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    _, S = ops.decode_grid(SLOTS, K, H // K, MAX_LEN, sms, D)
    edges = {ops.split_range(0, MAX_LEN, S, s)[0] for s in range(1, S)}
    edges |= {S, 16 * S, 32 * S, 64 * S, MAX_LEN}
    ls = sorted({min(MAX_LEN, max(0, e + d)) for e in edges
                 for d in (-1, 0, 1)})
    ls += [560] * (-len(ls) % SLOTS)
    return S, [ls[i:i + SLOTS] for i in range(0, len(ls), SLOTS)]


def late_rings(torch, starts):
    """Dense ring masks whose first valid slot is late: a 560-slot window
    from each start (cut at W)."""
    pos = torch.arange(MAX_LEN, device=DEV)[None, :]
    lo = torch.tensor(starts, device=DEV)[:, None]
    return (pos >= lo) & (pos < lo + 560)


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
    # the live-span split: lengths on its boundaries, windows starting
    # there, and rings whose only valid slot is the last, that wrap, or
    # that start late
    S, batches = split_edges(torch, ops)
    special = torch.zeros((SLOTS, MAX_LEN), dtype=torch.bool, device=DEV)
    special[0, MAX_LEN - 1] = True
    special[1, :50] = True
    special[1, MAX_LEN - 100:] = True
    special[2, 1500:] = True
    special[3, 1000:1560] = True
    special[4, 0] = True
    special[6, 777:1337] = True
    special[7, 1] = True
    print(f"gqa_decode: {S} splits a row at the main shape; boundary "
          f"lengths {[x for b in batches for x in b]}")
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        cases = [(f"prefix {ls}", ls, None) for ls in batches]
        cases += [(f"late window from {ls}", ls, late_rings(torch, ls))
                  for ls in batches]
        cases += [("last-only / wrapped / late / first-only rings", [0] * 8,
                   special)]
        for label, ls, mask in cases:
            q, k, v, valid = decode_inputs(torch, dtype, MAX_LEN, ls, gen)
            valid = valid if mask is None else mask
            err = check_close(f"gqa_decode {name} {label}",
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
        "splits": S,
    }
    print_share(report["gqa_decode"])


def shard_decode_inputs(torch, dtype, heads, lengths, gen, bs=None):
    """A concat-TP rank's decode inputs at qwen3's head_dim: ``heads`` =
    (q heads, kv heads) of the rank; a dense 2048-slot cache with prefix
    rows of ``lengths`` (``bs`` None), or block pools of ``bs``-token
    blocks in a shuffled order, -1 past each row's length."""
    h, k = heads
    B = len(lengths)
    q = torch.randn((B, h, D), generator=gen, device=DEV).to(dtype)
    ln = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    if bs is None:
        kv = [torch.randn((B, MAX_LEN, k, D), generator=gen,
                          device=DEV).to(dtype) for _ in range(2)]
        return q, *kv, torch.arange(MAX_LEN, device=DEV)[None, :] \
            < ln[:, None]
    M = MAX_LEN // bs
    kp, vp = (torch.randn((B * M, bs, k, D), generator=gen,
                          device=DEV).to(dtype) for _ in range(2))
    perm = torch.randperm(B * M, generator=gen, device=DEV).reshape(B, M)
    start = torch.arange(M, device=DEV)[None, :] * bs
    bt = torch.where(start < ln[:, None], perm, -1).to(torch.int32)
    return q, kp, vp, bt.contiguous(), ln


def check_decode_shards(torch, ops, gen, bs, report):
    """Both decode kernels at a concat-TP rank's heads: qwen3's 16 q / 8
    kv over 2 ranks (8 / 4, phase 3e's) and over 4 (4 / 2), dense and
    paged (block size ``bs``), element by element against the plain
    version in fp32 and bf16; timed at 8 / 4 beside the plain version and
    SDPA (``report[...]["k4"]``)."""
    lengths = [600, 512, 0, 2048, 1, 530, 777, 1500]
    for heads in ((H // 2, K // 2), (H // 4, K // 4)):
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype).split(".")[-1]
            for label, fn, plain, pbs in (
                    ("gqa_decode", ops.gqa_decode, ops.gqa_decode_plain,
                     None),
                    ("gqa_decode_paged", ops.gqa_decode_paged,
                     ops.gqa_decode_paged_plain, bs)):
                args = shard_decode_inputs(torch, dtype, heads, lengths, gen,
                                           pbs)
                err = check_close(f"{label} {name} at a rank's {heads[0]} q "
                                  f"/ {heads[1]} kv heads", fn(*args),
                                  plain(*args), name)
                row = report[label]
                key = "max_abs_err" if name == "bfloat16" else \
                    "max_abs_err_fp32"
                row[key] = max(row[key], err)
    ls = [560, 512, 600, 540, 580, 530, 590, 520]
    h, k = H // 2, K // 2
    rows = sum(ls)
    b_ms, b_by = bound_ms(2 * rows * k * D * 2 + 2 * SLOTS * h * D * 2,
                          4 * rows * h * D, "bfloat16")
    for label, fn, plain, pbs in (
            ("gqa_decode", ops.gqa_decode, ops.gqa_decode_plain, None),
            ("gqa_decode_paged", ops.gqa_decode_paged,
             ops.gqa_decode_paged_plain, bs)):
        sets = [shard_decode_inputs(torch, torch.bfloat16, (h, k), ls, gen,
                                    pbs) for _ in range(ROTATE)]
        views = sets if pbs is None else [
            (q, ops.paged_view(kp, bt), ops.paged_view(vp, bt),
             torch.arange(MAX_LEN, device=DEV)[None, :] < ln[:, None])
            for q, kp, vp, bt, ln in sets]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        row = report[label]["k4"] = {
            "heads": [h, k], "splits": ops.decode_grid(
                SLOTS, k, h // k, MAX_LEN, sms, D)[1],
            "ms": cuda_ms([lambda s=s: fn(*s) for s in sets]),
            "plain_ms": cuda_ms([lambda s=s: plain(*s) for s in sets]),
            "library_ms": cuda_ms([lambda s=s: sdpa(*s) for s in views]),
            "bound_ms": b_ms, "bound_by": b_by}
        print(f"{label} at a rank's {h} q / {k} kv heads, ~560 of "
              f"{MAX_LEN} slots: {row['ms']:.4f} ms ({row['splits']} "
              f"splits; bound {b_ms:.4f} by {b_by}, share "
              f"{b_ms / row['ms']:.3f}), plain {row['plain_ms']:.4f}, "
              f"SDPA {row['library_ms']:.4f}")


def g3_decode_case(torch, dtype, W, spans, gen, heads=(G3_H, G3_K, G3_D)):
    """gemma3's decode shape over a W-slot dense ring: q (8, 4, 256), k/v
    (8, W, 1, 256) (``heads``: another model's (H, K, D)); row b's live
    span is ``spans[b] = (start, n)`` slots from ``start``, wrapping past
    the ring's end (a ring whose span starts mid-row)."""
    B = len(spans)
    nh, nk, hd = heads
    q = torch.randn((B, nh, hd), generator=gen, device=DEV).to(dtype)
    k = torch.randn((B, W, nk, hd), generator=gen, device=DEV).to(dtype)
    v = torch.randn((B, W, nk, hd), generator=gen, device=DEV).to(dtype)
    pos = torch.arange(W, device=DEV)[None, :]
    start = torch.tensor([a for a, _ in spans], device=DEV)[:, None]
    n = torch.tensor([c for _, c in spans], device=DEV)[:, None]
    return q, k, v, ((pos - start) % W) < n


def g3_paged_case(torch, dtype, W, bs, lengths, gen):
    """The same rows as paged: a shuffled pool of 8 x W / bs blocks."""
    B, M = len(lengths), W // bs
    kp = torch.randn((B * M, bs, G3_K, G3_D), generator=gen,
                     device=DEV).to(dtype)
    vp = torch.randn((B * M, bs, G3_K, G3_D), generator=gen,
                     device=DEV).to(dtype)
    q = torch.randn((B, G3_H, G3_D), generator=gen, device=DEV).to(dtype)
    perm = torch.randperm(B * M, generator=gen, device=DEV).reshape(B, M)
    ln = torch.tensor(lengths, dtype=torch.int32, device=DEV)
    first = torch.arange(M, device=DEV)[None, :] * bs
    bt = torch.where(first < ln[:, None], perm, -1).to(torch.int32)
    return q, kp, vp, bt.contiguous(), ln


def check_decode_gemma3(torch, ops, gen, bs, report):
    """Both decode kernels at head_dim 256 (gemma3's 4 q / 1 kv heads):
    a sliding layer's 512-slot ring (full, wrapped with its span starting
    mid-row, short, empty) and a global layer's 2048-slot horizon, dense
    and paged at the mixed pool's block size ``bs`` and at 16, element by
    element, fp32 and bf16; then timed at the served shapes (bf16, rows of
    ~560 live slots of a 2048 horizon and full 512-slot windows) beside
    SDPA (``enable_gqa``; the gathered view for paged) and the bytes
    bound.  Rows go under ``gemma3`` in the two decode kernels' rows."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    spans = {512: [(137, 512), (0, 512), (509, 3), (300, 200), (1, 1),
                   (0, 0), (64, 500), (400, 512)],
             MAX_LEN: [(0, 600), (1500, 560), (0, 0), (0, 2048), (2047, 1),
                       (1000, 1100), (777, 1337), (5, 530)]}
    worst = {"gqa_decode": {}, "gqa_decode_paged": {}}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for W, sp in spans.items():
            gt, S = ops.decode_grid(SLOTS, G3_K, G3_H // G3_K, W, sms, G3_D)
            q, k, v, valid = g3_decode_case(torch, dtype, W, sp, gen)
            err = check_close(
                f"gqa_decode gemma3 {name} W={W} wrapped spans (GT {gt}, "
                f"{S} splits)", ops.gqa_decode(q, k, v, valid),
                ops.gqa_decode_plain(q, k, v, valid), name)
            w = worst["gqa_decode"]
            w[name] = max(w.get(name, 0.0), err)
            lengths = [min(n, W) for _, n in sp]
            for b in sorted({bs, 16}):
                args = g3_paged_case(torch, dtype, W, b, lengths, gen)
                err = check_close(
                    f"gqa_decode_paged gemma3 {name} W={W} bs={b}",
                    ops.gqa_decode_paged(*args),
                    ops.gqa_decode_paged_plain(*args), name)
                w = worst["gqa_decode_paged"]
                w[name] = max(w.get(name, 0.0), err)
    # B = 1: a row at the D = 256 split cap, the merge filling the ring
    gt, S = ops.decode_grid(1, G3_K, G3_H // G3_K, MAX_LEN, sms, G3_D)
    if S != ops.max_splits(G3_D, gt):
        fail(f"gqa_decode gemma3 B=1: {S} splits, want the cap "
             f"{ops.max_splits(G3_D, gt)}")
    q, k, v, valid = g3_decode_case(torch, torch.bfloat16, MAX_LEN,
                                    [(100, 1900)], gen)
    check_close(f"gqa_decode gemma3 B=1 at the {S}-split cap",
                ops.gqa_decode(q, k, v, valid),
                ops.gqa_decode_plain(q, k, v, valid), "bfloat16")
    # timing at the served shapes
    timed = {"sliding_w512": (512, [(s, 512) for s in
                                    (137, 0, 300, 480, 64, 7, 211, 400)]),
             "global_w2048": (MAX_LEN, [(0, n) for n in
                                        (560, 512, 600, 540, 580, 530, 590,
                                         520)])}
    for label, (W, sp) in timed.items():
        rows = sum(n for _, n in sp)
        sets = [g3_decode_case(torch, torch.bfloat16, W, sp, gen)
                for _ in range(ROTATE)]
        nbytes = (2 * rows * G3_K * G3_D * 2 + 2 * SLOTS * G3_H * G3_D * 2
                  + SLOTS * W)
        b_ms, b_by = bound_ms(nbytes, 4 * rows * G3_H * G3_D, "bfloat16")
        row = {"shape": [SLOTS, G3_H, G3_D, W], "dtype": "bfloat16",
               "splits": ops.decode_grid(SLOTS, G3_K, G3_H // G3_K, W, sms,
                                         G3_D)[1],
               "ms": cuda_ms([lambda s=s: ops.gqa_decode(*s) for s in sets]),
               "plain_ms": cuda_ms([lambda s=s: ops.gqa_decode_plain(*s)
                                    for s in sets]),
               "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": cuda_ms([lambda s=s: sdpa(*s) for s in sets])}
        report["gqa_decode"].setdefault("gemma3", {})[label] = row
        print_share({"name": f"gqa_decode gemma3 {label}", **row})
        lengths = [n for _, n in sp]
        psets = [g3_paged_case(torch, torch.bfloat16, W, bs, lengths, gen)
                 for _ in range(ROTATE)]
        views = [(q, ops.paged_view(kp, bt), ops.paged_view(vp, bt),
                  torch.arange(W, device=DEV)[None, :] < ln[:, None])
                 for q, kp, vp, bt, ln in psets]
        nbytes = (2 * rows * G3_K * G3_D * 2 + 2 * SLOTS * G3_H * G3_D * 2
                  + psets[0][3].numel() * 4 + SLOTS * 4)
        b_ms, b_by = bound_ms(nbytes, 4 * rows * G3_H * G3_D, "bfloat16")
        prow = {"shape": [SLOTS, G3_H, G3_D, W], "dtype": "bfloat16",
                "block_size": bs,
                "ms": cuda_ms([lambda s=s: ops.gqa_decode_paged(*s)
                               for s in psets]),
                "plain_ms": cuda_ms([lambda s=s: ops.gqa_decode_paged_plain(
                    *s) for s in psets]),
                "bound_ms": b_ms, "bound_by": b_by,
                "library_ms": cuda_ms([lambda s=s: sdpa(*s) for s in views])}
        report["gqa_decode_paged"].setdefault("gemma3", {})[label] = prow
        print_share({"name": f"gqa_decode_paged gemma3 {label}", **prow})
    for kernel, w in worst.items():
        report[kernel]["gemma3_max_abs_err"] = w
        report[kernel]["max_abs_err"] = max(report[kernel]["max_abs_err"],
                                            w["bfloat16"])


def check_decode_hymba(torch, ops, gen, report):
    """``gqa_decode`` at hymba's shapes: 25 q / 5 kv heads of 64 (G = 5:
    one query head a CTA, 200 work units at B = 8) over its 1024-slot
    sliding rings, element by element in fp32 and bf16 (full windows
    whose span starts mid-row, short, empty, prefix rows), then timed at
    the served shape (bf16, every window full, as after a prefill past
    it) beside SDPA and the bytes bound; under ``hymba`` in the row."""
    heads = (HY_H, HY_K, HY_D)
    W = HY_WINDOW
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gt, S = ops.decode_grid(SLOTS, HY_K, HY_H // HY_K, W, sms, HY_D)
    worst = {}
    cases = {"wrapped": [(137, W), (0, W), (W - 3, 3), (300, 200), (1, 1),
                         (0, 0), (64, 1000), (W - 1, W)],
             "prefix": [(0, n) for n in (W, 600, 0, 1, W - 1, 17, 513,
                                         256)]}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for label, sp in cases.items():
            q, k, v, valid = g3_decode_case(torch, dtype, W, sp, gen, heads)
            err = check_close(
                f"gqa_decode hymba {name} W={W} {label} (GT {gt}, {S} "
                "splits)", ops.gqa_decode(q, k, v, valid),
                ops.gqa_decode_plain(q, k, v, valid), name)
            worst[name] = max(worst.get(name, 0.0), err)
    sp = [(s0, W) for s0 in (137, 0, 300, 480, 64, 7, 211, 1000)]
    rows = sum(n for _, n in sp)
    sets = [g3_decode_case(torch, torch.bfloat16, W, sp, gen, heads)
            for _ in range(ROTATE)]
    nbytes = 2 * rows * HY_K * HY_D * 2 + 2 * SLOTS * HY_H * HY_D * 2 \
        + SLOTS * W
    b_ms, b_by = bound_ms(nbytes, 4 * rows * HY_H * HY_D, "bfloat16")
    row = {"shape": [SLOTS, HY_H, HY_K, HY_D, W], "dtype": "bfloat16",
           "gt": gt, "splits": S,
           "ms": cuda_ms([lambda s=s: ops.gqa_decode(*s) for s in sets]),
           "plain_ms": cuda_ms([lambda s=s: ops.gqa_decode_plain(*s)
                                for s in sets]),
           "bound_ms": b_ms, "bound_by": b_by,
           "library_ms": cuda_ms([lambda s=s: sdpa(*s) for s in sets]),
           "max_abs_err": worst}
    report["gqa_decode"]["hymba"] = row
    report["gqa_decode"]["max_abs_err"] = max(
        report["gqa_decode"]["max_abs_err"], worst["bfloat16"])
    print_share({"name": "gqa_decode hymba w1024", **row})


def time_decode_row(torch, ops, sets, nbytes, flops, paged=False, **info):
    """A decode kernel timed on rotating input ``sets`` beside its plain
    version, SDPA (the gathered view for paged) and the bound."""
    fn, plain = ((ops.gqa_decode_paged, ops.gqa_decode_paged_plain) if paged
                 else (ops.gqa_decode, ops.gqa_decode_plain))
    views = sets if not paged else [
        (q, ops.paged_view(kp, bt), ops.paged_view(vp, bt),
         torch.arange(bt.shape[1] * kp.shape[1], device=DEV)[None, :]
         < ln[:, None]) for q, kp, vp, bt, ln in sets]
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    return {**info, "dtype": "bfloat16",
            "ms": cuda_ms([lambda s=s: fn(*s) for s in sets]),
            "plain_ms": cuda_ms([lambda s=s: plain(*s) for s in sets]),
            "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": cuda_ms([lambda s=s: sdpa(*s) for s in views])}


def check_decode_g1(torch, ops, gen, bs, report):
    """Both decode kernels at MHA (G = 1: one query head a CTA): olmoe's
    16 q / 16 kv heads of 128 over a 2048-slot horizon, dense and paged
    (block size ``bs``), and seamless's 16 / 16 of 64 over a 512-frame
    cross span with every slot valid and over its self span of
    ``SM_SELF`` slots; element by element against the plain version in
    fp32 and bf16, then timed at the served shapes (~560 live of 2048
    slots for olmoe; full spans for seamless) beside SDPA and the bound.
    Rows go under ``olmoe`` / ``seamless_cross`` / ``seamless_self``."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lengths = [600, 512, 0, 2048, 1, 530, 777, 1500]
    heads = {"olmoe": (OL_H, OL_K, OL_D)}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        key = "max_abs_err" if name == "bfloat16" else "max_abs_err_fp32"
        for label, fn, plain, pbs in (
                ("gqa_decode", ops.gqa_decode, ops.gqa_decode_plain, None),
                ("gqa_decode_paged", ops.gqa_decode_paged,
                 ops.gqa_decode_paged_plain, bs)):
            args = shard_decode_inputs(torch, dtype, (OL_H, OL_K), lengths,
                                       gen, pbs)
            err = check_close(f"{label} olmoe {name} (G 1, D {OL_D})",
                              fn(*args), plain(*args), name)
            report[label][key] = max(report[label][key], err)
        for W, spans in ((SM_FRAMES, [(0, SM_FRAMES)] * SLOTS),
                         (SM_SELF, [(0, n) for n in (SM_SELF, 5, 1, 40, 68,
                                                     SM_SELF, 17, 33)])):
            q, k, v, valid = g3_decode_case(torch, dtype, W, spans, gen,
                                            (SM_H, SM_K, SM_D))
            err = check_close(f"gqa_decode seamless {name} W={W} (G 1, "
                              f"D {SM_D})", ops.gqa_decode(q, k, v, valid),
                              ops.gqa_decode_plain(q, k, v, valid), name)
            report["gqa_decode"][key] = max(report["gqa_decode"][key], err)
    ls = [560, 512, 600, 540, 580, 530, 590, 520]
    rows = sum(ls)
    for label, pbs in (("gqa_decode", None), ("gqa_decode_paged", bs)):
        sets = [shard_decode_inputs(torch, torch.bfloat16, (OL_H, OL_K), ls,
                                    gen, pbs) for _ in range(ROTATE)]
        nbytes = 2 * rows * OL_K * OL_D * 2 + 2 * SLOTS * OL_H * OL_D * 2 \
            + (SLOTS * MAX_LEN if pbs is None
               else sets[0][3].numel() * 4 + SLOTS * 4)
        row = report[label]["olmoe"] = time_decode_row(
            torch, ops, sets, nbytes, 4 * rows * OL_H * OL_D,
            paged=pbs is not None, shape=[SLOTS, OL_H, OL_K, OL_D, MAX_LEN],
            splits=ops.decode_grid(SLOTS, OL_K, 1, MAX_LEN, sms, OL_D)[1])
        print_share({"name": f"{label} olmoe ~560 of {MAX_LEN} slots "
                     f"({row['splits']} splits)", **row})
    for key, W in (("seamless_cross", SM_FRAMES), ("seamless_self", SM_SELF)):
        sets = [g3_decode_case(torch, torch.bfloat16, W, [(0, W)] * SLOTS,
                               gen, (SM_H, SM_K, SM_D))
                for _ in range(ROTATE)]
        rows = SLOTS * W
        nbytes = 2 * rows * SM_K * SM_D * 2 + 2 * SLOTS * SM_H * SM_D * 2 \
            + SLOTS * W
        row = report["gqa_decode"][key] = time_decode_row(
            torch, ops, sets, nbytes, 4 * rows * SM_H * SM_D,
            shape=[SLOTS, SM_H, SM_K, SM_D, W],
            splits=ops.decode_grid(SLOTS, SM_K, 1, W, sms, SM_D)[1])
        print_share({"name": f"gqa_decode {key} W={W} all valid "
                     f"({row['splits']} splits)", **row})


def print_share(row) -> None:
    """A kernel's time beside its bound, its share of the bound and the
    library call's time."""
    lib = row["library_ms"]
    print(f"{row['name']}: {row['ms']:.4f} ms, bound {row['bound_ms']:.4f} "
          f"ms ({row['bound_by']}), share of bound "
          f"{row['bound_ms'] / row['ms']:.3f}; plain {row['plain_ms']:.4f} "
          f"ms; library "
          f"{'null' if lib is None else f'{lib:.4f} ms'}")


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
    # lengths on the live-span split's boundaries
    S, batches = split_edges(torch, ops)
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for ls in batches:
            q, kp, vp, bt, ln = paged_inputs(torch, dtype, bs, ls, gen)
            worst[name] = max(worst[name], check_close(
                f"gqa_decode_paged {name} bs={bs} lengths {ls}",
                ops.gqa_decode_paged(q, kp, vp, bt, ln),
                ops.gqa_decode_paged_plain(q, kp, vp, bt, ln), name))
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
        "block_size": bs, "splits": S,
    }
    print_share(report["gqa_decode_paged"])


#: fused_mask's timed policies (T, top_k, top_p): the paged run's served
#: policy, the greedy run's (no filter: one read, one write) and top-p
#: alone (no top-k: the kernel's radix select over masses)
MASK_POLICIES = {"served": (0.8, 50, 0.95), "greedy": (0.0, 0, 1.0),
                 "top_p": (0.8, 0, 0.9)}


def mask_policy(torch, t, k, p, B=SLOTS):
    return (torch.full((B,), t, device=DEV),
            torch.full((B,), k, dtype=torch.int32, device=DEV),
            torch.full((B,), p, device=DEV))


def check_fused_mask(torch, ops, gen, report):
    B, V = SLOTS, VOCAB
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    solo = ops.solo_clusters(torch.device(DEV))
    plan = ops.mask_plan(B, V, sms, solo=solo)
    print(f"fused_mask ({B},{V}): plan {plan._asdict()} (clusters held one "
          "CTA an SM: " + ", ".join(f"{cl}: {solo(cl)}"
                                    for cl in ops.CL_CHOICES)
          + "), 16-byte copies for the served slice")
    cases = {
        "mixed": ([0.0, 0.8, 0.8, 1.3, 0.0, 0.5, 0.8, 1.0],
                  [0, 50, 1, V, 50, 0, 1000, -3],
                  [1.0, 0.95, 1.0, 0.5, 0.95, 0.9, 1.0, 0.3]),
        **{f"main_{k}": tuple([v] * B for v in pol)
           for k, pol in MASK_POLICIES.items()},
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
            if not torch.equal(got, ops.fused_mask(rows, tt, kk, pp)):
                fail(f"fused_mask {label}/{rows_name}: two launches gave "
                     "different bits")
            want = ops.fused_mask_plain(rows, tt, kk, pp)
            # the kernel's documented departures (exact sums of fp64
            # nucleus masses, p >= 1 keeps every top-k survivor) touch
            # only these tokens
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
    rows = logits[:, :V]
    b_ms, b_by = bound_ms(2 * B * V * 4 + B * 12, B * V, "float32")
    per_policy = {}
    for label, pol in MASK_POLICIES.items():
        args = mask_policy(torch, *pol)
        # one input set: served logits come straight from the LM head and
        # are still in L2
        r = per_policy[label] = {
            "policy": list(pol),
            "ms": cuda_ms([lambda: ops.fused_mask(rows, *args)]),
            "plain_ms": cuda_ms([lambda: ops.fused_mask_plain(rows, *args)],
                                iters=5, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by}
        print(f"fused_mask {label} (T, k, p) = {pol}: {r['ms']:.4f} ms, "
              f"bound {b_ms:.4f} ms ({b_by}), share of bound "
              f"{b_ms / r['ms']:.3f}; plain {r['plain_ms']:.4f} ms")
    # speculative verify samples B x K1 rows at once (K1 = spec_k + 1)
    verify = {}
    for K1 in VERIFY_K1S:
        B1 = SLOTS * K1
        vlogits = torch.randn((B1, V + 128), generator=gen, device=DEV) * 3.0
        vrows = vlogits[:, :V]
        args = mask_policy(torch, *MASK_POLICIES["served"], B=B1)
        got = ops.fused_mask(vrows, *args)
        if not torch.equal(got, ops.fused_mask(vrows, *args)):
            fail(f"fused_mask verify rows K1 {K1}: two launches gave "
                 "different bits")
        want = ops.fused_mask_plain(vrows, *args)
        free = ops.nucleus_boundary(vrows, *args)
        differ = torch.isinf(got) != torch.isinf(want)
        both = ~torch.isinf(got) & ~torch.isinf(want)
        err = (got[both] - want[both]).abs().max().item() \
            if both.any() else 0.0
        if (differ & ~free).any() or err != 0.0:
            fail(f"fused_mask at the verify shape K1 {K1} disagrees with "
                 "its plain version")
        worst = max(worst, err)
        vb_ms, vb_by = bound_ms(2 * B1 * V * 4 + B1 * 12, B1 * V, "float32")
        v = verify[K1] = {
            "rows": [B1, V], "policy": list(MASK_POLICIES["served"]),
            "plan": ops.mask_plan(B1, V, sms, solo=solo)._asdict(),
            "ms": cuda_ms([lambda: ops.fused_mask(vrows, *args)]),
            "plain_ms": cuda_ms([lambda: ops.fused_mask_plain(vrows, *args)],
                                iters=3, warmup=1),
            "bound_ms": vb_ms, "bound_by": vb_by,
            "boundary_tokens_differing": int(differ.sum())}
        print(f"fused_mask verify rows K1 {K1} ({B1},{V}) served policy: "
              f"plan {v['plan']}; supports differ on {int(differ.sum())} "
              f"nucleus-boundary tokens; {v['ms']:.4f} ms, bound "
              f"{vb_ms:.4f} ms ({vb_by}), share {vb_ms / v['ms']:.3f}; "
              f"plain {v['plain_ms']:.4f} ms")
        del vlogits, got, want, free, differ, both
    head = per_policy["served"]
    report["fused_mask"] = {
        "name": "fused_mask", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_sampler.cu",
        "replaces": "src/repro/kernels/fused_sampler/fused_sampler.py:79",
        "max_abs_err": worst, "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "plan": plan._asdict(), "per_policy": per_policy, "verify": verify,
    }


def check_fused_mask_rows(torch, ops, gen, report, key, V, width):
    """``fused_mask`` at another model's rows, (8, V) sliced out of rows
    ``width`` wide as served (its padded vocabulary): gemma3's (8,
    262144), the widest; hymba's odd 32,001 in 32,256 and mamba2's
    50,280 in 50,432.  The served policy (T 0.8, top-k 50, top-p 0.95)
    and the greedy one, held against the plain version as at qwen3's
    rows (equal survivors, equal supports off the nucleus boundary, two
    launches the same bits) and timed beside the bytes bound; under
    ``key`` in the row."""
    B = SLOTS
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    solo = ops.solo_clusters(torch.device(DEV))
    logits = torch.randn((B, width), generator=gen, device=DEV) * 3.0
    rows = logits[:, :V]                    # a strided slice, as served
    b_ms, b_by = bound_ms(2 * B * V * 4 + B * 12, B * V, "float32")
    out = {"rows": [B, V], "plan": ops.mask_plan(B, V, sms,
                                                 solo=solo)._asdict()}
    for label in ("served", "greedy"):
        args = mask_policy(torch, *MASK_POLICIES[label])
        got = ops.fused_mask(rows, *args)
        if not torch.equal(got, ops.fused_mask(rows, *args)):
            fail(f"fused_mask {key} {label}: two launches gave different "
                 "bits")
        want = ops.fused_mask_plain(rows, *args)
        free = ops.nucleus_boundary(rows, *args)
        differ = torch.isinf(got) != torch.isinf(want)
        both = ~torch.isinf(got) & ~torch.isinf(want)
        err = (got[both] - want[both]).abs().max().item() \
            if both.any() else 0.0
        if (differ & ~free).any() or err != 0.0:
            fail(f"fused_mask {key} ({B},{V}) {label} disagrees with its "
                 "plain version")
        r = out[label] = {
            "policy": list(MASK_POLICIES[label]),
            "ms": cuda_ms([lambda: ops.fused_mask(rows, *args)]),
            "plain_ms": cuda_ms([lambda: ops.fused_mask_plain(rows, *args)],
                                iters=5, warmup=1),
            "bound_ms": b_ms, "bound_by": b_by,
            "boundary_tokens_differing": int(differ.sum())}
        print(f"fused_mask {key} ({B},{V}) in rows {width} wide {label}: "
              f"plan {out['plan']}; "
              f"supports differ on {int(differ.sum())} nucleus-boundary "
              f"tokens; {r['ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), "
              f"share {b_ms / r['ms']:.3f}; plain {r['plain_ms']:.4f} ms")
    out["row_width"] = width
    report["fused_mask"][key] = out


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
    # odd H and W, C = 3, OC = 10, N = 2 (4-byte copies); small maps with
    # C = 256 and C = 100 (a last step of 4 channels); a wide map with OC
    # off multiples of 4
    cases = dict(CBRA_SHAPES, odd=((2, 7, 9, 3), 10),
                 c256=((1, 4, 4, 256), 64), c100=((1, 6, 6, 100), 40),
                 wide_odd_oc=((1, 100, 98, 24), 45))
    worst, per_shape = 0.0, {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, (shape, oc) in cases.items():
        C = shape[-1]
        x = torch.randn(shape, generator=gen, device=DEV)
        w = torch.randn((C, oc), generator=gen, device=DEV) / C ** 0.5
        b = torch.randn((oc,), generator=gen, device=DEV) * 0.1
        plan = ops.cbra_plan(*shape, oc, sms)
        aligned = all(t.data_ptr() % 16 == 0 for t in (x, w))
        print(f"cbr_avgpool {label}: plan {plan._asdict()}, 16-byte copies "
              f"{ops.cbra_vector_copies(C, oc, aligned)}")
        want = ops.cbr_avgpool_plain(x, w, b)
        got = ops.cbr_avgpool(x, w, b)
        if not torch.equal(got, ops.cbr_avgpool(x, w, b)):
            fail(f"cbr_avgpool {label}: two launches gave different bits")
        err = check_close(f"cbr_avgpool {label} {shape}@({C},{oc})", got,
                          want, "float32", CBRA_TOL)
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
            "shape": [*shape, oc], "plan": plan._asdict(),
            "ms": cuda_ms([lambda: ops.cbr_avgpool(x, w, b)]),
            "plain_ms": cuda_ms([lambda: ops.cbr_avgpool_plain(x, w, b)]),
            "unlinked_ms": cuda_ms([lambda: unlinked_cbra(x, w, b)]),
            "bound_ms": b_ms, "bound_by": b_by}
        r = per_shape[label]
        print(f"cbr_avgpool {label}: {r['ms']:.4f} ms, bound "
              f"{b_ms:.4f} ms ({b_by}), share of bound "
              f"{b_ms / r['ms']:.3f}; plain {r['plain_ms']:.4f} ms, "
              f"unlinked {r['unlinked_ms']:.4f} ms")
    # a finding, not a gate: the kernel may stay slower than either
    r = per_shape["t4_8x8"]
    print(f"cbr_avgpool t4_8x8: beats its plain version "
          f"{r['ms'] < r['plain_ms']}, beats the unlinked form "
          f"{r['ms'] < r['unlinked_ms']}")
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


def mlp_plan(torch, ops, args):
    """The plan ``linked_mlp`` picks for ``args`` on this card."""
    x, wg = args[0], args[1]
    return ops.mlp_plan(
        x.shape[0], x.shape[1], wg.shape[1], x.dtype,
        all(a.data_ptr() % 16 == 0 for a in args),
        torch.cuda.get_device_properties(0).multi_processor_count,
        slots=ops.cluster_slots(x.device))


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
        "shape": [M, d, ff], "plan": mlp_plan(torch, ops, args)._asdict(),
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
    plan = mlp_plan(torch, ops, args)
    print(f"linked_mlp {label}: plan {plan._asdict()}")
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
        plan = mlp_plan(torch, ops, args)
        if plan.path != "tc":
            fail(f"linked_mlp batched_prefill: planned {plan}, want the "
                 "tensor-core kernel")
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


def check_linked_mlp(torch, ops, gen, chunks, report):
    """The served shapes, decode (slots rows), chunked prefill (slots x
    each chunk in ``chunks``: every chunk ``serve_schedule`` may adopt)
    and batched prefill, timed; then fp32, ragged and M = 1."""
    bf16, f32 = torch.bfloat16, torch.float32
    row = report["linked_mlp"] = {
        "name": "linked_mlp", "route": "cuda",
        "source": "src/repro_torch/csrc/linked_mlp.cu",
        "replaces": "src/repro/kernels/linked_matmul/linked_matmul.py:42",
        # no single PyTorch call computes it; the unlinked three-matmul
        # form (the served torch backend) is recorded beside it
        "library_ms": None, "per_shape": {}}
    served = {"decode": (SLOTS, D_MODEL, D_FF, bf16),
              **{f"prefill_c{c}": (SLOTS * c, D_MODEL, D_FF, bf16)
                 for c in chunks}}
    cases = {**served,
             "m1": (1, D_MODEL, D_FF, bf16),
             "fp32": (64, 1024, 2048, f32),
             # more row tiles than SMs: one ff split, each CTA walks all
             # of ff (as batched prefill does)
             "fp32_one_split": (1100, 256, 512, f32),
             "ragged_bf16": (37, 2000, 1000, bf16),
             "ragged_fp32": (13, 2047, 129, f32),
             "ragged_ff_bf16": (5, 136, 200, bf16),
             "ragged_m_bf16": (37, 256, 208, bf16)}
    # gemma3-1b's MLP: d 1152 is no multiple of the 256 columns a cluster
    # rank owns (a cluster of 5, the last rank 128 columns), ff 6912 is
    # 108 blocks; decode (slots rows) and a 32-token chunk of the slots
    # hymba-1.5b's: d 1600 is a cluster of 7 whose last rank owns 64
    # columns, half of warpgroup 0's 128
    others = {"gemma3_decode": (SLOTS, G3_D_MODEL, G3_D_FF, bf16),
              "gemma3_prefill_c32": (SLOTS * 32, G3_D_MODEL, G3_D_FF, bf16),
              "hymba_decode": (SLOTS, HY_D_MODEL, HY_D_FF, bf16),
              "hymba_prefill_c32": (SLOTS * 32, HY_D_MODEL, HY_D_FF, bf16)}
    for label, shape in {**cases, **others}.items():
        linked_mlp_case(torch, ops, gen, label, shape, row,
                        timed=label in served or label in others)
    for label, (M, d, ff, dt) in others.items():
        plan = row["per_shape"][label]["plan"]
        if plan["path"] != "tc" or plan["cl"] != -(-d // ops.TC_DS):
            fail(f"linked_mlp {label}: planned {plan}, want the tensor-core "
                 f"kernel on a cluster of {-(-d // ops.TC_DS)}")
    linked_mlp_batched(torch, ops, gen, row)
    head = row["per_shape"]["decode"]
    row.update({k: head[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "unlinked_ms", "shape")})


def check_split_matmul(torch, ops, gen, report):
    worst, per_shape = 0.0, {}
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for label, (M, K, N, bn, bk) in SPLIT_CASES.items():
        x = torch.randn((M, K), generator=gen, device=DEV)
        w = torch.randn((K, N), generator=gen, device=DEV) / K ** 0.5
        b = torch.randn((N,), generator=gen, device=DEV)
        plan = ops.split_plan(M, N, K, bn, bk, sms)
        print(f"split_matmul {label}: plan {plan._asdict()}, "
              f"{-(-K // bk)} K tiles, 16-byte copies "
              f"{ops.vector_copies(x, w, bn, bk)}")
        if label in SPLIT_CLUSTERED and not (plan.cl > 1 and K > bk):
            fail(f"split_matmul {label}: want a cluster split inside each "
                 f"of several K tiles, planned {plan}")
        got = ops.split_matmul(x, w, b, block_n=bn, block_k=bk)
        if not torch.equal(got, ops.split_matmul(x, w, b, block_n=bn,
                                                 block_k=bk)):
            fail(f"split_matmul {label}: two launches gave different bits")
        worst = max(worst, check_close(
            f"split_matmul {label} ({M},{K})@({K},{N}) block_n {bn} "
            f"block_k {bk}", got, ops.split_matmul_plain(x, w, b, bn, bk),
            "float32", SPLIT_TOL))
        if label not in ("ffn1", "ffn2"):
            continue
        nbytes = 4 * (M * K + K * N + N + M * N)
        b_ms, b_by = bound_ms(nbytes, 2 * M * K * N + M * N, "float32")
        per_shape[label] = {
            "shape": [M, K, N, bn, bk], "plan": plan._asdict(),
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
                  max_len=MAX_LEN, seed=0, replan_every=PINNED)
    values.update(over)
    for k, v in values.items():
        setattr(args, k, v)
    return args


def ragged_prompts(reqs, vocab, seed, lens=PROMPT_LENS):
    import numpy as np
    rng = np.random.default_rng(seed)
    for r in reqs:
        n = int(rng.integers(lens[0], lens[1] + 1))
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
    dec = [(us, n) for us, key, n in rows if "decode_kernel" in key]
    return {"device_ms_per_tick": total / 1e3 / ticks if total else None,
            "top_kernels": [{"name": k[:80], "ms_per_tick": us / 1e3 / ticks,
                             "calls_per_tick": n / ticks}
                            for us, k, n in rows[:8]],
            "decode_attention": {
                "ms_per_tick": sum(us for us, _ in dec) / 1e3 / ticks,
                "calls_per_tick": sum(n for _, n in dec) / ticks}}


def window_steps(after: dict, before: dict) -> dict:
    """``steps`` minus ``before``'s, per width (a profiled window's)."""
    none = {"calls": 0, "total_s": 0.0, "captures": 0, "capture_s": 0.0}
    return {w: {k: v - before.get(w, none)[k] for k, v in st.items()}
            for w, st in after.items()}


def serve_phase(torch, kernels, serve, engine, args, label, prompt_seed,
                window=(100, 105), lens=PROMPT_LENS, on_tick=None):
    """One full serving run through ``engine`` (built from ``args``), ticks
    driven here so a window of ticks can be profiled; the launch counts
    cover the run.  The requests (``serve.make_requests``, prompts made
    ragged from ``prompt_seed``) are the same for every run given the
    same args and seed, so two runs' streams can be compared.  Step
    times, sampler dispatches and graph warm-ups are the engine's own
    (``stats()``, ``engine.steps``); the profiled window's steps are taken
    out of the steady means (``window`` None: no profiled ticks, no busy
    share).  ``on_tick(engine)`` runs after every tick."""
    model = engine.model
    reqs = serve.make_requests(args, model.cfg.vocab)
    ragged_prompts(reqs, model.cfg.vocab, prompt_seed, lens)
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    for r in reqs:
        engine.submit(r)
    tick, prof, profiled, inside, before = 0, None, None, {}, None
    # wall ms of the unprofiled ticks by kind (the stages that ran, the
    # step widths), and the kinds of the profiled ones
    tick_ms: dict[tuple, list] = {}
    window_kinds: set = set()

    def close_profile():
        torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        return profile_window(torch, prof, tick - window[0])
    while engine.scheduler.pending():
        if window is not None and tick == window[0]:
            torch.cuda.synchronize()
            before = {w: dict(st) for w, st in engine.steps.items()}
            prof = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        counts = dict(engine.timer.counts)
        widths = {w: st["calls"] + st["captures"]
                  for w, st in engine.steps.items()}
        t1 = time.perf_counter()
        engine.step()
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t1) * 1e3
        kind = (tuple(sorted(k for k, n in engine.timer.counts.items()
                             if n != counts.get(k) and k != "replan")),
                tuple(sorted(w for w, st in engine.steps.items()
                             if st["calls"] + st["captures"]
                             != widths.get(w))))
        if prof is not None:
            window_kinds.add(kind)
        else:
            tick_ms.setdefault(kind, []).append(ms)
        if on_tick is not None:
            on_tick(engine)
        tick += 1
        if prof is not None and tick == window[1]:
            profiled = close_profile()
            inside = window_steps(engine.steps, before)
            prof = None
    if prof is not None:
        profiled = close_profile()
        inside = window_steps(engine.steps, before)
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
    stages, steps = stats["stages"], stats["steps"]
    graphs = stats.get("graphs", {})
    # steady step ms by width (1 = a decode step, K1 = a verify): the
    # engine's synchronized step times, less the profiled window's and
    # the steps that captured a graph
    outside = window_steps(steps, inside)
    steady = {w: st["total_s"] / st["calls"] * 1e3
              for w, st in outside.items() if st["calls"]}
    capture_ms = {w: st["capture_s"] / st["captures"] * 1e3
                  for w, st in steps.items() if st["captures"]}
    # busy share: the profiled ticks' device kernel time over the mean
    # wall time of the unprofiled ticks of their kind, where the window
    # holds one kind of tick (a draft model's steps, outside the engine's
    # step, are in both)
    busy = None
    if profiled is not None and profiled["device_ms_per_tick"] \
            and len(window_kinds) == 1 and window_kinds <= set(tick_ms):
        wall_ms = tick_ms[next(iter(window_kinds))]
        busy = profiled["device_ms_per_tick"] / (sum(wall_ms) / len(wall_ms))
    kind = sorted(window_kinds)
    warmup: dict = {}
    for g in graphs.values():
        for k, n in g["warmup_launches"].items():
            warmup[k] = warmup.get(k, 0) + n
    pool = sum(g["pool_bytes"] for g in graphs.values())
    dec_ms = steady.get(1)
    print(f"serve {label} ({'graphed' if engine.graphed else 'eager'}): "
          f"{len(reqs)} requests, {sum(len(r.generated) for r in reqs)} "
          f"tokens in {wall:.2f} s over {tick} ticks; decode {tps:.1f} "
          f"tok/s; steady decode step "
          f"{'none' if dec_ms is None else f'{dec_ms:.2f} ms'}; steady ms "
          f"by width {steady}; steps by width {steps}; first steps that "
          f"captured (ms) {capture_ms}; busy share "
          f"{'not measured' if busy is None else f'{busy:.3f}'} (profiled "
          f"tick kinds {kind}); graph pool {pool / 2**20:.1f} MiB; "
          f"launches {launches}")
    for stage, st in stages.items():
        print(f"  stage {stage}: {st['calls']} calls, total "
              f"{st['total_s']:.3f} s, mean {st['mean_s'] * 1e3:.2f} ms")
    for name, g in graphs.items():
        print(f"  graph {name}: {g['captures']} captures, capture "
              f"{g['capture_s']:.3f} s, pool +{g['pool_bytes'] / 2**20:.1f} "
              f"MiB, {g['replays']} replays, launches a replay "
              f"{g['launches']}, warm-ups {g['warmup_launches']}")
    print(f"  kernel plan {stats['kernel_plan']}; final plan {stats['plan']}")
    if profiled is not None:
        dev_ms = profiled["device_ms_per_tick"]
        print(f"  profiled ticks {window}: device kernel time "
              f"{'not measured' if dev_ms is None else f'{dev_ms:.2f} ms'} "
              "per tick; top kernels:")
        for k in profiled["top_kernels"]:
            print(f"    {k['ms_per_tick']:.3f} ms/tick "
                  f"{k['calls_per_tick']:.0f} calls/tick  {k['name']}")
        da = profiled["decode_attention"]
        print(f"  decode attention kernel: {da['ms_per_tick']:.4f} ms/tick, "
              f"{da['calls_per_tick']:.1f} calls/tick")
    out = {"graphed": engine.graphed, "decode_tokens_per_s": tps,
           "mean_decode_ms": dec_ms, "steady_ms": steady,
           "capture_ms": capture_ms, "steps": steps,
           # decode-kernel steps: one a decode step, K1 a verify
           "kernel_steps": sum(w * (st["calls"] + st["captures"])
                               for w, st in steps.items()),
           "sampler_calls": stats["sampler_calls"], "warmup": warmup,
           "pool_bytes": pool, "wall_s": wall, "ticks": tick,
           "stages": stages, "launches": launches, "graphs": graphs,
           "kernel_plan": stats["kernel_plan"], "plan": stats["plan"],
           "profile": profiled, "busy_share": busy,
           "streams": [list(r.generated) for r in reqs]}
    if "spec" in stats:
        out["spec"] = stats["spec"]
    return out


def decode_kernels(model, kv: str) -> dict:
    """Launches of each decode-attention kernel a decode step: dense KV
    and a sliding layer (a dense ring, or the ring pool's gathered view)
    launch ``gqa_decode``, a paged full-attention layer
    ``gqa_decode_paged``."""
    n = model.cfg.n_layers
    sliding = sum(f.kv == "sliding" for f in model.families)
    if kv == "dense":
        return {"gqa_decode": n, "gqa_decode_paged": 0}
    return {"gqa_decode": sliding, "gqa_decode_paged": n - sliding}


def swiglu_layers(cfg) -> int:
    """The layers whose FFN is a SwiGLU on the ``linked_matmul`` site: a
    dense or hybrid layer's MLP, an MoE layer's dense residual (arctic);
    an MoE layer's experts, a GELU MLP (audio) and a Mamba2 layer have
    no kernel site."""
    if cfg.family == "moe":
        return cfg.n_layers if cfg.moe_dense_residual else 0
    return cfg.n_layers if cfg.d_ff and cfg.family != "audio" else 0


def check_launches(label, run, cfg, decode_tc, attn: dict) -> None:
    """Every prefill launch of ``linked_mlp`` goes through the tensor-core
    kernel (decode's through the one the planner picks), each
    decode-attention kernel launches ``attn[kernel]`` times every decode
    step (K1 times that at a verify of width K1), and ``fused_mask`` once
    a sampler dispatch; a graphed run's launches are its replays' plus its
    graphs' warm-ups, each warm-up the launches of one replay.  A family
    with no SwiGLU on the linked site (mamba2, olmoe's experts) launches
    no ``linked_mlp`` at all."""
    ln, warm = run["launches"], run["warmup"]
    for name, g in run["graphs"].items():
        want = {k: g["captures"] * n for k, n in g["launches"].items()}
        if g["warmup_launches"] != want:
            fail(f"{label}: graph {name}'s warm-ups launched "
                 f"{g['warmup_launches']}, want one replay's a capture "
                 f"({want})")
    if not swiglu_layers(cfg):
        print(f"{label}: " + "; ".join(
            f"{k} {ln.get(k, 0)} ({n} a step) over {run['kernel_steps']} "
            f"decode-kernel steps and warm-ups {warm.get(k, 0)}"
            for k, n in attn.items())
            + f"; linked_mlp {ln.get('linked_mlp', 0)}; fused_mask "
            f"{ln['fused_mask']} over {run['sampler_calls']} sampler "
            f"dispatches and warm-ups {warm.get('fused_mask', 0)}")
        for k in ("linked_mlp", "linked_mlp_tc"):
            if ln.get(k, 0):
                fail(f"{label}: {k} launched {ln[k]} times, want none")
        want = run["sampler_calls"] + warm.get("fused_mask", 0)
        if ln["fused_mask"] != want or want <= 0:
            fail(f"{label}: fused_mask launched {ln['fused_mask']} times, "
                 f"want one per sampler dispatch and warm-up ({want})")
        for k, n in attn.items():
            want = n * run["kernel_steps"] + warm.get(k, 0)
            if ln.get(k, 0) != want or (n and want <= 0):
                fail(f"{label}: {k} launched {ln.get(k, 0)} times, want {n} "
                     f"per decode-kernel step and the warm-ups' ({want})")
        return
    decode_mlp = swiglu_layers(cfg) * run["kernel_steps"] + warm.get(
        "linked_mlp", 0)
    want_tc = ln["linked_mlp"] - (0 if decode_tc else decode_mlp)
    print(f"{label}: linked_mlp {ln['linked_mlp']} launches, linked_mlp_tc "
          f"{ln['linked_mlp_tc']} (prefill {ln['linked_mlp'] - decode_mlp}, "
          f"decode and verify {decode_mlp} on {'tc' if decode_tc else 'ffma'}"
          f", warm-ups included); " + "; ".join(
              f"{k} {ln[k]} ({n} a step) over {run['kernel_steps']} "
              f"decode-kernel steps and warm-ups {warm.get(k, 0)}"
              for k, n in attn.items())
          + f"; fused_mask {ln['fused_mask']} over "
          f"{run['sampler_calls']} sampler dispatches and warm-ups "
          f"{warm.get('fused_mask', 0)}")
    if ln["linked_mlp_tc"] != want_tc or want_tc <= 0:
        fail(f"{label}: linked_mlp_tc launched {ln['linked_mlp_tc']} times, "
             f"want every prefill launch ({want_tc})")
    for name in [k for k, n in attn.items() if n] + [
            "fused_mask", "linked_mlp", "linked_mlp_tc"]:
        if ln.get(name, 0) <= 0:
            fail(f"{label}: kernel {name} was never launched")
    want = run["sampler_calls"] + warm.get("fused_mask", 0)
    if ln["fused_mask"] != want:
        fail(f"{label}: fused_mask launched {ln['fused_mask']} times, want "
             f"one per sampler dispatch and warm-up ({want})")
    for k, n in attn.items():
        want = n * run["kernel_steps"] + warm.get(k, 0)
        if ln[k] != want:
            fail(f"{label}: {k} launched {ln[k]} times, want {n} per "
                 f"decode-kernel step and the warm-ups' ({want})")


def same_streams(label, run, twin) -> None:
    if run["streams"] != twin["streams"]:
        bad = [i for i, (a, b) in enumerate(zip(run["streams"],
                                                twin["streams"])) if a != b]
        fail(f"{label}: token streams differ from the twin's (requests "
             f"{bad})")
    print(f"{label}: {len(run['streams'])} streams equal the twin's bit for "
          "bit")


def serving_phases(torch, kernels, serve, model, params, paged_args,
                   decode_tc: bool) -> dict:
    """Phases 3 and 3b: every serving run, its checks and comparisons."""
    cfg = model.cfg
    # phase 3: both served runs graphed, each beside its eager twin (the
    # same requests); replanning is off in the twins, since a replan
    # adopts a chunk and prefill mode from timings, which differ between
    # them.  One more graphed run replans as a served engine does.
    dense_args = serve_args(serve, kv="dense")
    runs = {}
    for label, args, seed in (("dense_greedy", dense_args, 13),
                              ("paged_sampled", paged_args, 14)):
        for graphed in (True, False):
            name = label if graphed else f"{label}_eager"
            runs[name] = serve_phase(
                torch, kernels, serve,
                serve.build_engine(args, model, params, graphed=graphed),
                args, name, seed)
            check_launches(name, runs[name], cfg, decode_tc,
                           decode_kernels(model, args.kv))
        same_streams(f"{label} graphed vs eager", runs[label],
                     runs[f"{label}_eager"])
        g, e = runs[label], runs[f"{label}_eager"]
        print(f"{label}: decode step eager {e['mean_decode_ms']:.2f} ms "
              f"(busy {e['busy_share']}), graphed {g['mean_decode_ms']:.2f} "
              f"ms (busy {g['busy_share']})")
    replan_args = serve_args(
        serve, kv="dense",
        replan_every=serve.build_parser().get_default("replan_every"))
    label = "dense_greedy_replan"
    runs[label] = serve_phase(
        torch, kernels, serve, serve.build_engine(replan_args, model, params),
        replan_args, label, 13)
    check_launches(label, runs[label], cfg, decode_tc,
                   decode_kernels(model, "dense"))
    replans = runs[label]["stages"].get("replan", {"calls": 0})["calls"]
    if replans < 1:
        fail(f"{label}: the engine never replanned")
    print(f"{label}: {replans} replans, final chunk "
          f"{runs[label]['plan'].get('chunk')}, prefill mode "
          f"{runs[label]['plan'].get('prefill_mode')}")

    # phase 3b: speculative decoding at full width, each run beside its
    # spec-off twin (the same requests and seeds).  On random weights
    # neither the n-gram lookup nor an unrelated draft model predicts the
    # target, so the accept path is driven by an oracle draft too: the
    # target as its own draft (its proposals run the plain-torch plan, so
    # low-margin steps may still reject), as the reference's own test of
    # mixed per-request speculation does.  The reduced draft proposes
    # DRAFT_SPEC_K tokens a tick, so its run meets every verify width
    # from 2 to DRAFT_SPEC_K + 1 and measures the graphs' shared pool
    spec_runs = (
        ("paged_sampled_ngram", dict(vars(paged_args), spec="ngram",
                                     spec_k=SPEC_K), 14, None,
         "paged_sampled", (100, 105), PROMPT_LENS),
        ("dense_greedy_draft", dict(vars(dense_args), spec="draft",
                                    spec_k=DRAFT_SPEC_K, requests=8), 15,
         serve.build_draft(cfg, model.device, seed=1), None, None,
         PROMPT_LENS),
        ("dense_greedy_oracle", dict(vars(dense_args), spec="draft",
                                     spec_k=SPEC_K, requests=4, max_new=32),
         16, (model, params), None, None, ORACLE_PROMPT_LENS))
    for label, values, seed, draft, twin_label, window, lens in spec_runs:
        args = serve_args(serve, **values)
        if twin_label is None:      # a spec-off twin of its own
            twin_label = f"{label}_twin"
            twin_args = serve_args(serve, **dict(values, spec="off"))
            runs[twin_label] = serve_phase(
                torch, kernels, serve,
                serve.build_engine(twin_args, model, params), twin_args,
                twin_label, seed, window, lens)
            check_launches(twin_label, runs[twin_label], cfg, decode_tc,
                           decode_kernels(model, twin_args.kv))
        runs[label] = serve_phase(
            torch, kernels, serve,
            serve.build_engine(args, model, params, draft=draft), args,
            label, seed, window, lens)
        check_launches(label, runs[label], cfg, decode_tc,
                       decode_kernels(model, args.kv))
        same_streams(f"{label} vs spec off", runs[label], runs[twin_label])
        run, sp = runs[label], runs[label]["spec"]
        twin_tps = runs[twin_label]["decode_tokens_per_s"]
        print(f"{label}: accept rate {sp['accept_rate']} "
              f"({sp['drafts_accepted']} of {sp['drafts_proposed']} drafts), "
              f"{sp['verify_calls']} verify calls; steady verify step ms by "
              "K1 " + ", ".join(
                  f"{w}: {ms:.2f} over {run['steps'][w]['calls']}"
                  for w, ms in sorted(run["steady_ms"].items()) if w > 1)
              + "; first verify that captured (ms) " + ", ".join(
                  f"{w}: {ms:.1f}" for w, ms in
                  sorted(run["capture_ms"].items()) if w > 1)
              + f"; graphs' pool {run['pool_bytes'] / 2**20:.1f} MiB; decode "
              f"{run['decode_tokens_per_s']:.1f} tok/s against the spec-off "
              f"twin's {twin_tps:.1f}")
        run["twin"] = twin_label
    accepted = sum(runs[lb]["spec"]["drafts_accepted"]
                   for lb, *_ in spec_runs)
    rejected = sum(runs[lb]["spec"]["drafts_proposed"]
                   - runs[lb]["spec"]["drafts_accepted"]
                   for lb, *_ in spec_runs)
    if accepted < 1 or rejected < 1:
        fail(f"speculative runs: {accepted} drafts accepted and {rejected} "
             "rejected; want at least one of each")
    return runs


def kv_bytes(engine) -> dict:
    """The bytes an engine's caches hold by kind (``cache_bytes``: each
    KV layout's K and V, a pool's write sink included; SSM state and
    conv register), beside the dense full-attention KV of the same
    slots, horizon and heads."""
    out = engine.cache_bytes()
    cfg = engine.model.cfg
    out["dense_full_equivalent"] = (
        2 * cfg.n_layers * engine.slots * engine.max_len * cfg.n_kv_heads
        * cfg.resolved_head_dim * engine.model.dtype.itemsize)
    return out


def lease_check(state: dict):
    """``serve_phase``'s ``on_tick`` for a mixed-pool engine: every
    request holds a classic lease and a ring lease, and every ring lease
    is window / block size blocks whatever the request's context; keeps
    the most leases held at once and the longest context a ring lease
    served."""
    def check(engine):
        pool = engine.pool
        want = pool.window // pool.ring.cfg.block_size
        if set(pool.classic.leases) != set(pool.ring.leases):
            fail("mixed pool: the classic and ring leases differ")
        for rid, lease in pool.ring.leases.items():
            if len(lease.blocks) != want:
                fail(f"mixed pool: rid {rid}'s ring lease holds "
                     f"{len(lease.blocks)} blocks, want {want}")
        live = {s.req.rid: len(s.req.prompt) + len(s.req.generated)
                for s in engine.scheduler.active if s is not None}
        state["most_leases"] = max(state.get("most_leases", 0),
                                   len(pool.ring.leases))
        state["longest_context"] = max(
            [state.get("longest_context", 0)]
            + [n for rid, n in live.items() if rid in pool.ring.leases])
        state["ring_blocks_a_lease"] = want
    return check


def cache_family_phase(torch, kernels, serve, Model, gemma3, qwen,
                       g3_paged_args) -> dict:
    """Phase 3c: gemma3-1b at full width, dense greedy and mixed-paged
    sampled, each graphed beside its eager twin (the same requests,
    replanning off), prompts past the window so every ring wraps; then
    qwen3-1.7b with a 512-token window, ring-paged beside dense, greedy."""
    model, params = gemma3
    runs, leases = {}, {}
    dense_args = serve_args(serve, kv="dense")
    for label, args, seed in (("gemma3_dense_greedy", dense_args, 17),
                              ("gemma3_paged_sampled", g3_paged_args, 18)):
        for graphed in (True, False):
            name = label if graphed else f"{label}_eager"
            engine = serve.build_engine(args, model, params, graphed=graphed)
            hook = None
            if args.kv == "paged":
                hook = lease_check(leases.setdefault(name, {}))
            runs[name] = serve_phase(
                torch, kernels, serve, engine, args, name, seed,
                window=G3_WINDOW_TICKS, lens=G3_PROMPT_LENS, on_tick=hook)
            runs[name]["kv_bytes"] = kv_bytes(engine)
            runs[name]["kv_window"] = engine.stats().get("kv_window")
            del engine
            check_launches(name, runs[name], model.cfg, True,
                           decode_kernels(model, args.kv))
            print(f"{name}: KV bytes {runs[name]['kv_bytes']}"
                  + (f"; leases {leases[name]}" if name in leases else ""))
        same_streams(f"{label} graphed vs eager", runs[label],
                     runs[f"{label}_eager"])
        g, e = runs[label], runs[f"{label}_eager"]
        print(f"{label}: decode step eager {e['mean_decode_ms']:.2f} ms "
              f"(busy {e['busy_share']}), graphed {g['mean_decode_ms']:.2f} "
              f"ms (busy {g['busy_share']})")
    for name, st in leases.items():
        runs[name]["leases"] = st
        if st.get("longest_context", 0) <= G3_WINDOW:
            fail(f"{name}: no ring lease served a context past the window")
    qmodel, qparams = qwen
    swa = Model(dataclasses.replace(
        qmodel.cfg, name=f"{qmodel.cfg.name}-swa{G3_WINDOW}",
        sliding_window=G3_WINDOW), device=DEV)
    for kv in ("dense", "paged"):
        name = f"qwen3_swa{G3_WINDOW}_{kv}_greedy"
        args = serve_args(serve, kv=kv, requests=8)
        engine = serve.build_engine(args, swa, qparams)
        runs[name] = serve_phase(torch, kernels, serve, engine, args, name,
                                 19, window=None, lens=G3_PROMPT_LENS)
        runs[name]["kv_bytes"] = kv_bytes(engine)
        runs[name]["kv_window"] = engine.stats().get("kv_window")
        del engine
        check_launches(name, runs[name], swa.cfg, True,
                       decode_kernels(swa, kv))
        print(f"{name}: KV bytes {runs[name]['kv_bytes']}")
    same_streams(f"qwen3-swa{G3_WINDOW} ring vs dense sliding",
                 runs[f"qwen3_swa{G3_WINDOW}_paged_greedy"],
                 runs[f"qwen3_swa{G3_WINDOW}_dense_greedy"])
    return runs


def state_mb(run) -> str:
    """A run's cache bytes by kind (``kv_bytes``), in MB."""
    return ", ".join(f"{k} {v / 1e6:.1f} MB"
                     for k, v in run["kv_bytes"].items())


def recurrent_phase(torch, kernels, serve, hymba, mamba2) -> dict:
    """Phase 3d: hymba-1.5b at full width, greedy and sampled, and
    mamba2-370m at full width, greedy, each graphed beside its eager twin
    (the same requests, replanning off, dense KV), streams equal bit for
    bit.  A hymba decode replay launches ``gqa_decode`` and
    ``linked_mlp_tc`` once a layer and ``fused_mask`` once; a mamba2 one
    ``fused_mask`` alone.  Prints each run's steady step, busy share and
    cache bytes beside the full-attention KV of the same slots and
    horizon (``kv_bytes``; 0 for mamba2)."""
    runs = {}
    sampled = dict(temperature=0.8, top_k=50, top_p=0.95)
    plan = [("hymba_greedy", hymba, {}, 20, HY_PROMPT_LENS, HY_WINDOW_TICKS),
            ("hymba_sampled", hymba, sampled, 21, HY_PROMPT_LENS,
             HY_WINDOW_TICKS),
            ("mamba2_greedy", mamba2, {}, 22, M2_PROMPT_LENS,
             M2_WINDOW_TICKS)]
    for label, (model, params), policy, seed, lens, window in plan:
        cfg = model.cfg
        args = serve_args(serve, kv="dense", **policy)
        n = cfg.n_layers if cfg.d_ff else 0
        for graphed in (True, False):
            name = label if graphed else f"{label}_eager"
            engine = serve.build_engine(args, model, params, graphed=graphed)
            if engine.stats()["plan"]["kv_growth"] != "constant":
                fail(f"{name}: plan kv_growth "
                     f"{engine.stats()['plan']['kv_growth']}, want constant")
            runs[name] = serve_phase(torch, kernels, serve, engine, args,
                                     name, seed, window=window, lens=lens)
            runs[name]["kv_bytes"] = kv_bytes(engine)
            del engine
            check_launches(name, runs[name], cfg, True,
                           {"gqa_decode": n, "gqa_decode_paged": 0})
            if graphed:
                want = {"gqa_decode": n, "gqa_decode_paged": 0,
                        "linked_mlp_tc": n, "fused_mask": 1}
                got = runs[name]["graphs"]["serve_sample"]["launches"]
                if {k: got.get(k, 0) for k in want} != want:
                    fail(f"{name}: a decode replay launches {got}, want "
                         f"{want}")
            print(f"{name}: cache {state_mb(runs[name])}")
        same_streams(f"{label} graphed vs eager", runs[label],
                     runs[f"{label}_eager"])
        g, e = runs[label], runs[f"{label}_eager"]
        print(f"{label}: decode step eager {e['mean_decode_ms']:.2f} ms "
              f"(busy {e['busy_share']}), graphed {g['mean_decode_ms']:.2f} "
              f"ms (busy {g['busy_share']}); cache {state_mb(g)}")
    return runs


# ---------------------------------------------------------------------------
# phase 3e: replica routing and concat tensor parallelism
# ---------------------------------------------------------------------------

def router_requests(torch, vocab: int, bs: int) -> list:
    """Phase 3e's routed requests: ROUTER_GROUPS groups of
    ROUTER_PER_GROUP, each group's first ROUTER_PREFIX tokens shared
    (block-aligned), then a distinct tail shorter than a block (so the
    longest block-aligned prefix, the router's affinity key, is the
    group's); odd request ids sample (T 0.8, top-k 50, top-p 0.95,
    seeded), even ones are greedy."""
    import numpy as np
    from repro_torch.serving import Request, SamplingParams
    rng = np.random.default_rng(31)
    out = []
    for g in range(ROUTER_GROUPS):
        prefix = rng.integers(0, vocab, ROUTER_PREFIX)
        for i in range(ROUTER_PER_GROUP):
            rid = g * ROUTER_PER_GROUP + i
            tail = rng.integers(0, vocab, 1 + (rid * 5) % (bs - 1))
            out.append(Request(
                rid=rid, max_new_tokens=ROUTER_NEW,
                prompt=np.concatenate([prefix, tail]).astype(np.int32),
                sampling=SamplingParams(temperature=0.8, top_k=50,
                                        top_p=0.95, seed=rid)
                if rid % 2 else None))
    return out


def router_phase(torch, kernels, serve, model, params, card: str) -> dict:
    """Phase 3e (a): two graphed, paged replicas of full-width qwen3-1.7b
    on one card behind a ``ReplicaRouter``, the params shared, against a
    solo graphed engine on the same requests: once steady, once with
    replica 1 failed part-way (its unfinished requests requeued from
    scratch onto replica 0).  Every stream must equal the solo engine's;
    the steady run must place requests on both replicas by prefix
    affinity."""
    from repro_torch.serving import ReplicaRouter
    args = serve_args(serve, kv="paged", requests=ROUTER_GROUPS
                      * ROUTER_PER_GROUP, max_new=ROUTER_NEW)

    def served(label, fn):
        torch.cuda.synchronize()
        kernels.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        out.update(wall_s=time.perf_counter() - t0,
                   launches=dict(kernels.LAUNCHES))
        print(f"router {label}: {out['wall_s']:.2f} s, launches "
              f"{out['launches']}")
        return out

    def solo():
        engine = serve.build_engine(args, model, params)
        reqs = router_requests(torch, model.cfg.vocab,
                               engine.pool.cfg.block_size)
        for r in reqs:
            engine.submit(r)
        engine.run()
        return {"streams": [list(r.generated) for r in reqs]}

    def routed(fail_at):
        router = ReplicaRouter([serve.build_engine(args, model, params)
                                for _ in range(2)])
        reqs = router_requests(torch, model.cfg.vocab,
                               router.affinity_block)
        for r in reqs:
            router.submit(r)
        router._dispatch()
        first = [router.placements[r.rid].replica for r in reqs]
        moved, steps = 0, 0
        while router.pending():
            if steps == fail_at:
                moved = router.fail_replica(1)
            router.step()
            steps += 1
        st = router.stats()
        per = [None if p is None else {
            "tokens_out": p["tokens_out"],
            "decode_tokens_per_s": p.get("decode_tokens_per_s"),
            "prefill_tokens_saved": p.get("prefill_tokens_saved"),
            "decode_ms": p["steps"].get(1, {}).get("total_s", 0.0) * 1e3
            / max(p["steps"].get(1, {}).get("calls", 0), 1)}
            for p in st["per_replica"]]
        summary = {k: st[k] for k in ("replicas", "live_replicas",
                                      "dispatched", "affinity_hits",
                                      "requeued", "queued")}
        summary["aggregate_decode_tokens_per_s"] = st.get(
            "aggregate_decode_tokens_per_s")
        summary["per_replica"] = per
        print(f"router stats ({card}): {json.dumps(summary)}")
        return {"streams": [list(r.generated) for r in reqs],
                "first_replica": first, "moved": moved, "stats": summary,
                "ticks": steps}

    runs = {"router_solo": served("solo", solo)}
    want = runs["router_solo"]["streams"]
    for label, fail_at in (("router_steady", None),
                           ("router_failover", ROUTER_FAIL_AT)):
        run = runs[label] = served(label, lambda f=fail_at: routed(f))
        torch.cuda.empty_cache()
        if run["streams"] != want:
            bad = [i for i, (a, b) in enumerate(zip(run["streams"], want))
                   if a != b]
            fail(f"{label}: streams of requests {bad} differ from the solo "
                 "engine's")
        if fail_at is None:
            if run["stats"]["affinity_hits"] <= 0 \
                    or set(run["first_replica"]) != {0, 1}:
                fail(f"{label}: no affinity hit, or a replica took no "
                     f"request (placements {run['first_replica']})")
        elif run["moved"] < 1 or run["stats"]["requeued"] < 1:
            fail(f"{label}: failing replica 1 at tick {fail_at} requeued "
                 "nothing")
        print(f"{label}: {len(want)} streams equal the solo engine's bit "
              f"for bit; first placements {run['first_replica']}, "
              f"{run['stats']['affinity_hits']} affinity hits, "
              f"{run['moved']} requests requeued")
    return runs


def probe_logits(torch, model, params, plan, mesh=None) -> list:
    """Teacher-forced logits on the card: one TP_PROBE_CHUNK-token prefill
    chunk of SLOTS rows, then TP_PROBE_STEPS decode steps feeding the
    greedy tokens back, under ``plan`` (on one device, or this rank of
    ``mesh`` from the full ``params``).  Returned to the host, fp32."""
    import numpy as np
    from repro_torch.distributed import tp
    shards = mesh.shards if mesh is not None else 1
    if mesh is not None:
        params = tp.shard_params(params, shards, mesh.rank,
                                 tp.serving_param_specs(model.param_specs()))
    caches = model.init_caches(SLOTS, TP_PROBE_CHUNK * 4, shards=shards)
    rng = np.random.default_rng(41)
    toks = torch.from_numpy(rng.integers(0, model.cfg.vocab,
                                         (SLOTS, TP_PROBE_CHUNK)))
    zeros = torch.zeros((SLOTS,), dtype=torch.int32)
    full = torch.full((SLOTS,), TP_PROBE_CHUNK, dtype=torch.int32)
    logits, caches = model.prefill_chunk(params, caches, toks, zeros, full,
                                         plan=plan, shard_axis=mesh)
    out = [logits]
    for _ in range(TP_PROBE_STEPS):
        tok = torch.argmax(out[-1][:, :model.cfg.vocab], dim=-1)[:, None]
        logits, caches = model.serve_step(params, caches, tok, plan=plan,
                                          shard_axis=mesh)
        out.append(logits)
    return [t.float().cpu() for t in out]


def decision_margin(torch, logits, sampling, step: int, other: int):
    """How far the one-device logits must shift for the decision at
    ``step`` to emit ``other`` (the token the run under test emitted
    there) in place of their own winner, and the bf16 tolerance that
    shift is held to.  A greedy row: the winner's logit minus
    ``other``'s (phase 4's rule names the runner-up), tolerance ``rtol
    * max(1, |top-1|)``.  A sampled row (T, top-k; no nucleus), on
    logits / T and a tolerance over T: the draw scores each token
    logits / T plus the request's Gumbel noise for this step (key
    ``fold_in(key(seed), step)``) and takes the best of the top-k
    survivors (ties at the k-th logit kept).  ``other`` wins either by
    outscoring the winner, or by outscoring every other survivor once
    the winner drops below the first token outside the support; it
    must be admitted first if it lies under the k-th logit.  The shift
    is the lesser of the two routes, each the largest gap it must
    close; so a tie at the top-k boundary lowers it only where it can
    change the draw to ``other``."""
    from repro_torch.serving import sampling as S
    x = logits.float()
    tol = TOL["bfloat16"]["rtol"] * max(1.0, abs(x.max().item()))
    if sampling is None or sampling.temperature <= 0:
        return (x.max() - x[other]).item(), tol
    if sampling.top_p < 1.0:
        raise ValueError("the margin rule covers top-k sampling only")
    x = x / sampling.temperature
    tol /= sampling.temperature
    n = x.numel()
    k = min(sampling.top_k or n, n)
    xs = torch.sort(x, descending=True).values
    seed = torch.tensor([sampling.seed & 0xFFFFFFFF], device=x.device)
    key = S.fold_in(S.prng_key(seed), torch.tensor([step], device=x.device))
    scores = x + S.gumbel(key, n)[0]
    win = int(torch.argmax(torch.where(x >= xs[k - 1], scores, -torch.inf)))
    if win == other:
        return 0.0, tol
    admit = max(0.0, (xs[k - 1] - x[other]).item())
    beat_winner = max(admit, (scores[win] - scores[other]).item())
    if k == n:
        return beat_winner, tol
    rest = torch.where(x >= xs[k], scores, -torch.inf)
    rest[win] = rest[other] = -torch.inf
    drop_winner = max(admit, (x[win] - xs[k]).item(),
                      (rest.max() - scores[other]).item())
    return min(beat_winner, drop_winner), tol


def tp_rank(mesh, card: str):
    """One rank of phase 3e (b): full-width qwen3-1.7b from seed 0 on this
    rank's device, sliced to its shard by the engine; each TP_RUNS run
    through ``serve_phase`` (rank 0 prints and profiles), then the
    logits probe.  Returns the runs (with the rank's cache bytes, its
    KV heads and the mesh's backend) and, on rank 0, the probe."""
    import contextlib
    import io
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch import kernels
    from repro_torch.configs.base import get_config
    from repro_torch.core.pipeline import KernelPlan
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    quiet = io.StringIO() if mesh.rank else None
    with contextlib.redirect_stdout(quiet or sys.stdout):
        model = Model(get_config("qwen3-1.7b"), device=mesh.device)
        params = model.cast_params(model.init(
            torch.Generator(device=mesh.device).manual_seed(0)))
        runs = {}
        for label, over in TP_RUNS.items():
            args = serve_args(serve, mesh_shards=mesh.shards, **over)
            engine = serve.build_engine(args, model, params, mesh=mesh,
                                        graphed=False)
            run = serve_phase(
                torch, kernels, serve, engine, args,
                f"tp_{label} rank {mesh.rank} ({card})", TP_PROMPT_SEED,
                window=TP_WINDOW if mesh.rank == 0 else None,
                lens=TP_PROMPT_LENS)
            st = engine.stats()
            run.update(cache_bytes=engine.cache_bytes(),
                       kv_heads=engine.caches.kv.k.shape[3],
                       per_shard=st.get("kv_pool", {}).get("per_shard"),
                       mesh_shards=st["mesh_shards"], backend=mesh.backend)
            runs[label] = run
            del engine
            torch.cuda.empty_cache()
        plan = KernelPlan(**runs[next(iter(TP_RUNS))]["kernel_plan"])
        probe = probe_logits(torch, model, params, plan, mesh)
    # numpy: a spawned rank's torch tensors reach the parent through a file
    # descriptor that its exit closes
    return {"runs": runs,
            "probe": [p.numpy() for p in probe] if mesh.rank == 0 else None}


def column_slices(torch, model, params) -> dict:
    """Whether cuBLAS gives a rank's column slice of each sharded
    projection of layer 0 (``wq`` / ``wk`` / ``wv`` / ``gate`` / ``up``,
    half the columns) the bits of the same columns of the one-device
    product, at a decode step's rows (SLOTS) and a chunk's (SLOTS x 32):
    the worst |difference| by op and row count (0: bit-equal)."""
    gen = torch.Generator(device=DEV).manual_seed(3)
    lp = model._layers(params)[0]
    out = {}
    for op, w in (("wq", lp["attn"]["wq"]), ("wk", lp["attn"]["wk"]),
                  ("wv", lp["attn"]["wv"]), ("gate", lp["mlp"]["gate"]),
                  ("up", lp["mlp"]["up"])):
        w2 = w.reshape(w.shape[0], -1)
        half = w2.shape[1] // 2
        for rows in (SLOTS, SLOTS * 32):
            x = torch.randn((rows, w2.shape[0]), generator=gen,
                            device=DEV).to(model.dtype)
            full = x @ w2
            worst = max((full[:, i * half:(i + 1) * half]
                         - x @ w2[:, i * half:(i + 1) * half].contiguous())
                        .abs().max().item() for i in range(2))
            out[f"{op}@{rows}"] = worst
    return out


def tp_phase(torch, kernels, serve, model, params, card: str) -> dict:
    """Phase 3e (b): two concat-TP ranks of full-width qwen3-1.7b on the
    one card (``devices=["cuda:0", "cuda:0"]``, gloo, eager; both load
    the kernels this process built), dense greedy and paged sampled,
    against a one-device eager engine under the ranks' kernel plan on
    the same requests.  The ranks' decode kernels take one device's split
    count (``ops.rank_splits``), so the probe's logits must equal the
    one-device logits bit for bit and every stream, greedy and sampled
    (top-p included), the one-device stream; the probe also prints
    whether cuBLAS gives a rank's half of each projection the one-device
    bits (``column_slices``).  Each rank's KV bytes are half the
    one-device engine's; each rank launches its decode kernel (at K / 2
    = 4 kv heads) n_layers times a decode step, ``fused_mask`` once a
    sampler dispatch and no ``linked_mlp``."""
    from repro_torch.core.pipeline import KernelPlan
    from repro_torch.launch.mesh import spawn_ranks
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        ranks = spawn_ranks(tp_rank, 2, args=(card,),
                            devices=["cuda:0", "cuda:0"],
                            timeout_s=TP_TIMEOUT)
    except (RuntimeError, TimeoutError) as e:
        fail(f"tp: {e}")
    spawn_s = time.perf_counter() - t0
    cfg = model.cfg
    runs = {}
    for label, over in TP_RUNS.items():
        plan = KernelPlan(**ranks[0]["runs"][label]["kernel_plan"])
        if plan.linked_matmul != "torch" or plan.decode_dense != "cuda" \
                or plan.decode_paged != "cuda" or plan.sampler != "cuda":
            fail(f"tp_{label}: the sharded engines' kernel plan {plan}")
        args = serve_args(serve, **over)
        engine = serve.build_engine(args, model, params, kernel_plan=plan,
                                    graphed=False)
        one = serve_phase(torch, kernels, serve, engine, args,
                          f"tp_{label} one device ({card})", TP_PROMPT_SEED,
                          window=TP_WINDOW, lens=TP_PROMPT_LENS)
        one_bytes = sum(engine.cache_bytes().values())
        del engine
        runs[f"tp_{label}_one_device"] = one
        attn = "gqa_decode" if over["kv"] == "dense" else "gqa_decode_paged"
        for rank, res in enumerate(ranks):
            run = res["runs"][label]
            runs[f"tp_{label}_rank{rank}"] = run
            ln = run["launches"]
            name = f"tp_{label} rank {rank}"
            if run["kv_heads"] != cfg.n_kv_heads // 2:
                fail(f"{name}: caches hold {run['kv_heads']} kv heads")
            if 2 * sum(run["cache_bytes"].values()) != one_bytes:
                fail(f"{name}: KV bytes {run['cache_bytes']}, the one-device "
                     f"engine's {one_bytes}: want half")
            want = cfg.n_layers * run["kernel_steps"]
            if ln[attn] != want or want <= 0:
                fail(f"{name}: {attn} launched {ln[attn]} times, want "
                     f"{cfg.n_layers} a decode step ({want})")
            if ln["fused_mask"] != run["sampler_calls"] \
                    or ln["linked_mlp"] or ln["linked_mlp_tc"]:
                fail(f"{name}: fused_mask {ln['fused_mask']} over "
                     f"{run['sampler_calls']} sampler dispatches, "
                     f"linked_mlp {ln['linked_mlp']} (want none)")
            print(f"{name}: {attn} {ln[attn]} launches at "
                  f"{run['kv_heads']} kv heads ({cfg.n_layers} a decode "
                  f"step over {run['kernel_steps']} steps), fused_mask "
                  f"{ln['fused_mask']} over {run['sampler_calls']} sampler "
                  f"dispatches, linked_mlp 0; KV {run['cache_bytes']} = "
                  f"half of {one_bytes}; {run['backend']}")
        if ranks[1]["runs"][label]["streams"] != \
                ranks[0]["runs"][label]["streams"]:
            fail(f"tp_{label}: the two ranks' streams differ")
        r0 = ranks[0]["runs"][label]
        parted = [i for i, (a, b) in enumerate(zip(one["streams"],
                                                   r0["streams"])) if a != b]
        print(f"tp_{label} ({card}): {len(one['streams']) - len(parted)} of "
              f"{len(one['streams'])} streams equal the one-device streams "
              f"(parted: {parted}); eager decode step "
              f"{r0['mean_decode_ms']:.2f} ms on 2 ranks (busy "
              f"{r0['busy_share']}) against {one['mean_decode_ms']:.2f} ms on "
              f"one device (busy {one['busy_share']})")
        runs[f"tp_{label}_rank0"]["vs_one_device"] = {"parted": parted}
        if parted:
            fail(f"tp_{label}: streams {parted} part from one device's")
    probe = [torch.from_numpy(p) for p in ranks[0]["probe"]]
    solo = probe_logits(torch, model, params, plan)
    diffs = [(a - b).abs().max().item() for a, b in zip(probe, solo)]
    bits = [torch.equal(a, b) for a, b in zip(probe, solo)]
    slices = column_slices(torch, model, params)
    print(f"tp logits probe (prefill chunk {TP_PROBE_CHUNK} x {SLOTS} rows, "
          f"{TP_PROBE_STEPS} decode steps, {card}): bits equal by step "
          f"{bits}; max |rank 0 - one device| by step "
          f"{[f'{d:.3e}' for d in diffs]}; ranks spawned and run in "
          f"{spawn_s:.1f} s; a rank's half of each projection against the "
          f"one-device columns, worst |difference| by op@rows {slices}")
    runs["tp_probe"] = {"bits_equal": all(bits), "bits_by_step": bits,
                        "max_abs_diff": diffs, "column_slices": slices,
                        "spawn_s": spawn_s}
    if not all(bits):
        fail(f"tp: rank 0's logits differ from one device's (by step "
             f"{diffs}); column slices {slices}")
    return runs


# ---------------------------------------------------------------------------
# phase 3f: MoE and encoder-decoder
# ---------------------------------------------------------------------------

def init_model(torch, Model, cfg, label: str):
    """``cfg`` on the card with random weights from seed 0 (drawn in
    ``param_dtype``, then the serving copy in ``cfg.dtype``; the draw is
    freed)."""
    model = Model(cfg, device=DEV)
    t0 = time.perf_counter()
    raw = model.init(torch.Generator(device=DEV).manual_seed(0))
    params = model.cast_params(raw)
    del raw
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    print(f"{label} ({cfg.n_layers} layers"
          + (f" + {cfg.encoder_layers} encoder" if cfg.encoder_layers else "")
          + f", d {cfg.d_model}, {cfg.n_heads} q / {cfg.n_kv_heads} kv heads "
          f"of {cfg.resolved_head_dim}, ff {cfg.d_ff}"
          + (f", {cfg.n_experts} experts top {cfg.top_k}"
             + (" + a dense residual" if cfg.moe_dense_residual else "")
             if cfg.family == "moe" else "")
          + f", vocab {cfg.vocab}, {cfg.dtype}): "
          f"{model.param_count() / 1e9:.3f} B params initialized in "
          f"{time.perf_counter() - t0:.1f} s")
    return model, params


def moe_ffn_timing(torch, model, params, card: str, ticks: int = 4) -> dict:
    """The device time a decode tick spends in the MoE FFN (routing, the
    fixed form's every-expert FFN, the gathered combine): every layer's
    ``moe_block`` at the decode shape (slots rows of normed activations,
    each layer its own weights), summed over the profiler's CUDA kernels
    and over CUDA events, a tick being one call a layer.  Beside it the
    least time the card could take for the expert weights those rows
    route to (each routed expert's gate, up and down read once, the
    router's weights once; counted from this run's routing), and the
    weights the fixed form reads (every expert)."""
    from torch.autograd import DeviceType

    from repro_torch.models import moe as M
    cfg = model.cfg
    layers = model._layers(params)
    gen = torch.Generator(device=DEV).manual_seed(5)
    xs = [torch.randn((SLOTS, 1, cfg.d_model), generator=gen,
                      device=DEV).to(model.dtype) for _ in layers]

    def tick():
        for lp, x in zip(layers, xs):
            M.moe_block(lp["moe"], x, cfg=cfg)
    routed = 0
    for lp, x in zip(layers, xs):
        _, top_i = M.route(x[:, 0], lp["moe"]["router"], cfg.top_k)
        routed += int(torch.unique(top_i).numel())
    esize = model.dtype.itemsize
    expert_bytes = 3 * cfg.d_model * cfg.d_ff * esize
    nbytes = routed * expert_bytes + cfg.n_layers * (
        cfg.d_model * cfg.n_experts * esize + 2 * SLOTS * cfg.d_model * esize)
    b_ms, b_by = bound_ms(nbytes, 6 * SLOTS * cfg.top_k * cfg.n_layers
                          * cfg.d_model * cfg.d_ff, "bfloat16")
    ms = cuda_ms([tick], iters=ticks * 2, warmup=2)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(ticks):
            tick()
        torch.cuda.synchronize()
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0.0))
                 for e in prof.key_averages()
                 if e.device_type == DeviceType.CUDA)
    # the profiler's kernel time, or the events' where it saw none
    dev_ms = dev_us / 1e3 / ticks if dev_us else None
    out = {"ms_per_tick_events": ms, "device_ms_per_tick": dev_ms or ms,
           "profiler_ms_per_tick": dev_ms, "bound_ms": b_ms, "bound_by": b_by,
           "experts_routed_per_layer": routed / cfg.n_layers,
           "weights_read_bytes": cfg.n_layers * cfg.n_experts * expert_bytes,
           "routed_weight_bytes": routed * expert_bytes}
    print(f"olmoe MoE FFN a decode tick ({SLOTS} rows x {cfg.n_layers} "
          f"layers, {card}): profiler "
          f"{'not measured' if dev_ms is None else f'{dev_ms:.3f} ms'}, "
          f"events {ms:.3f} ms; bound {b_ms:.3f} ms ({b_by}: "
          f"{routed / cfg.n_layers:.1f} routed experts a layer, "
          f"{out['routed_weight_bytes'] / 1e9:.2f} GB; the fixed form reads "
          f"all {cfg.n_experts}, {out['weights_read_bytes'] / 1e9:.2f} GB), "
          f"share of bound {b_ms / out['device_ms_per_tick']:.3f}")
    return out


def moe_phase(torch, kernels, serve, Model, card: str) -> dict:
    """Phase 3f (a): olmoe-1b-7b at full width (bf16, seed 0) serving 16
    requests of 480-544-token prompts and 64 new tokens (slots 8, max_len
    2048, chunk 32, replanning off): dense KV greedy and paged KV sampled
    (T 0.8, top-k 50, top-p 0.95), each graphed beside its eager twin,
    then the paged run with ``spec ngram`` (k 4) beside the graphed
    paged run, and 4 dense greedy requests with the target as its own
    draft (k 4: on random weights the n-gram lookup may propose nothing)
    beside their spec-off twin; streams equal bit for bit, the oracle's
    verify step run.  A decode replay launches the
    decode kernel once a layer, ``fused_mask`` once and no
    ``linked_mlp`` (the experts have no kernel site).  Prints each run's
    steady step, busy share, KV bytes and graphs, and the MoE FFN's
    device ms a tick beside its bound (``moe_ffn_timing``) and its share
    of the graphed decode tick."""
    from repro_torch.configs.base import get_config
    model, params = init_model(torch, Model, get_config("olmoe-1b-7b"),
                               "olmoe-1b-7b full width")
    cfg = model.cfg
    runs = {}
    sampled = dict(temperature=0.8, top_k=50, top_p=0.95)
    for label, over, seed in (("olmoe_dense_greedy", dict(kv="dense"), 24),
                              ("olmoe_paged_sampled",
                               dict(kv="paged", **sampled), 25)):
        args = serve_args(serve, **over)
        for graphed in (True, False):
            name = label if graphed else f"{label}_eager"
            engine = serve.build_engine(args, model, params, graphed=graphed)
            runs[name] = serve_phase(torch, kernels, serve, engine, args,
                                     name, seed, window=OL_WINDOW_TICKS)
            runs[name]["kv_bytes"] = kv_bytes(engine)
            del engine
            attn = decode_kernels(model, args.kv)
            check_launches(name, runs[name], cfg, True, attn)
            if graphed:
                want = {**attn, "fused_mask": 1, "linked_mlp": 0,
                        "linked_mlp_tc": 0}
                got = runs[name]["graphs"]["serve_sample"]["launches"]
                if {k: got.get(k, 0) for k in want} != want:
                    fail(f"{name}: a decode replay launches {got}, want "
                         f"{want}")
            print(f"{name}: KV {state_mb(runs[name])}")
        same_streams(f"{label} graphed vs eager", runs[label],
                     runs[f"{label}_eager"])
        g, e = runs[label], runs[f"{label}_eager"]
        print(f"{label}: decode step eager {e['mean_decode_ms']:.2f} ms "
              f"(busy {e['busy_share']}), graphed {g['mean_decode_ms']:.2f} "
              f"ms (busy {g['busy_share']})")
    label = "olmoe_paged_sampled_ngram"
    args = serve_args(serve, kv="paged", spec="ngram", spec_k=SPEC_K,
                      **sampled)
    runs[label] = serve_phase(torch, kernels, serve,
                              serve.build_engine(args, model, params), args,
                              label, 25, window=None)
    check_launches(label, runs[label], cfg, True,
                   decode_kernels(model, "paged"))
    same_streams(f"{label} vs spec off", runs[label],
                 runs["olmoe_paged_sampled"])
    # the n-gram lookup may propose nothing on random weights: the target
    # as its own draft (phase 3b's oracle) drives the MoE verify step and
    # its graphs
    base = dict(kv="dense", requests=4, max_new=32)
    for label, over, draft in (
            ("olmoe_dense_greedy_oracle_twin", {}, None),
            ("olmoe_dense_greedy_oracle",
             dict(spec="draft", spec_k=SPEC_K), (model, params))):
        args = serve_args(serve, **base, **over)
        runs[label] = serve_phase(
            torch, kernels, serve,
            serve.build_engine(args, model, params, draft=draft), args,
            label, 27, window=None, lens=ORACLE_PROMPT_LENS)
        check_launches(label, runs[label], cfg, True,
                       decode_kernels(model, "dense"))
    same_streams("olmoe_dense_greedy_oracle vs spec off",
                 runs["olmoe_dense_greedy_oracle"],
                 runs["olmoe_dense_greedy_oracle_twin"])
    for label in ("olmoe_paged_sampled_ngram", "olmoe_dense_greedy_oracle"):
        sp = runs[label]["spec"]
        print(f"{label}: accept rate {sp['accept_rate']} "
              f"({sp['drafts_accepted']} of {sp['drafts_proposed']} "
              f"drafts), {sp['verify_calls']} verify calls; steady verify "
              "step ms by K1 " + ", ".join(
                  f"{w}: {ms:.2f}" for w, ms in
                  sorted(runs[label]["steady_ms"].items()) if w > 1))
    # the draft runs the plain plan and the target the kernels: on
    # olmoe's random weights their greedy tokens may part at every step
    # (PERF.md, PR 21), so the gate is that the verify step ran
    sp = runs["olmoe_dense_greedy_oracle"]["spec"]
    if sp["verify_calls"] < 1 or sp["drafts_proposed"] < 1:
        fail(f"olmoe oracle draft: {sp['verify_calls']} verify calls, "
             f"{sp['drafts_proposed']} drafts proposed; want the verify "
             "step run")
    ffn = runs["olmoe_moe_ffn"] = moe_ffn_timing(torch, model, params, card)
    tick = (runs["olmoe_dense_greedy"]["profile"] or {}).get(
        "device_ms_per_tick")
    ffn["share_of_graphed_tick"] = (ffn["device_ms_per_tick"] / tick
                                    if tick else None)
    print(f"olmoe: the MoE FFN's share of a graphed dense decode tick's "
          f"device time ({tick} ms): {ffn['share_of_graphed_tick']}")
    del params
    torch.cuda.empty_cache()
    return runs


def arctic_phase(torch, kernels, serve, Model, lm_ops, gen) -> dict:
    """Phase 3f (b): reduced arctic-480b in bf16 (2 layers, d 256, 4
    experts top 2, its dense SwiGLU residual on the linked site), one
    dense greedy run graphed beside eager, streams bit for bit; each
    decode replay launches ``linked_mlp_tc`` once a layer (the dense
    residual: the one path to ``linked_mlp`` in this phase)."""
    from repro_torch.configs.base import get_config
    cfg = dataclasses.replace(get_config("arctic-480b").reduced(),
                              dtype="bfloat16", param_dtype="float32")
    model, params = init_model(torch, Model, cfg, "arctic-480b reduced")
    decode_tc = mlp_plan(torch, lm_ops, mlp_inputs(
        torch, SLOTS, cfg.d_model, cfg.d_ff, torch.bfloat16, gen)).path \
        == "tc"
    if not decode_tc:
        fail("arctic reduced: the decode MLP does not plan the tensor-core "
             "kernel")
    args = serve_args(serve, kv="dense", requests=8, max_new=32)
    runs = {}
    for graphed in (True, False):
        name = "arctic_dense_greedy" + ("" if graphed else "_eager")
        runs[name] = serve_phase(
            torch, kernels, serve,
            serve.build_engine(args, model, params, graphed=graphed), args,
            name, 26, window=None, lens=ORACLE_PROMPT_LENS)
        check_launches(name, runs[name], cfg, decode_tc,
                       decode_kernels(model, "dense"))
    got = runs["arctic_dense_greedy"]["graphs"]["serve_sample"]["launches"]
    want = {"gqa_decode": cfg.n_layers, "linked_mlp_tc": cfg.n_layers}
    if {k: got.get(k, 0) for k in want} != want:
        fail(f"arctic: a decode replay launches {got}, want {want}")
    same_streams("arctic graphed vs eager", runs["arctic_dense_greedy"],
                 runs["arctic_dense_greedy_eager"])
    del params
    torch.cuda.empty_cache()
    return runs


def translate_run(torch, kernels, TA, model, params, src, prompt, sampling,
                  label: str, card: str) -> dict:
    """One translate_audio pass at full width: launches, the decode step
    (host clock over synchronized steps), the device ms of the profiled
    steps SM_WINDOW and the busy share (their device time over their
    mean wall time)."""
    times, prof = [], {}

    def on_step(i, logits):
        torch.cuda.synchronize()
        times.append(time.perf_counter())
        if i == SM_WINDOW[0]:
            prof["p"] = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CUDA])
            prof["p"].__enter__()
        if i == SM_WINDOW[1]:
            prof["p"].__exit__(None, None, None)
    torch.cuda.synchronize()
    kernels.reset_launches()
    toks, caches = TA.translate(model, params, src, prompt,
                                new_tokens=SM_NEW, sampling=sampling,
                                on_step=on_step)
    launches = dict(kernels.LAUNCHES)
    toks = toks.cpu().numpy()
    n_win = SM_WINDOW[1] - SM_WINDOW[0]
    window = profile_window(torch, prof["p"], n_win)
    steps_ms = [1e3 * (b - a) for a, b in zip(times, times[1:])]
    win_ms = steps_ms[SM_WINDOW[0]:SM_WINDOW[1]]
    steady = [m for i, m in enumerate(steps_ms)
              if not SM_WINDOW[0] <= i < SM_WINDOW[1]]
    dev = window["device_ms_per_tick"]
    busy = dev / (sum(steady) / len(steady)) if dev else None
    cross = sum(t.numel() * t.element_size()
                for t in (caches.cross_k, caches.cross_v))
    n = model.cfg.n_layers
    want = {"gqa_decode": 2 * n * SM_NEW,
            "fused_mask": 0 if sampling is None else SM_NEW + 1,
            "linked_mlp": 0, "gqa_decode_paged": 0}
    if {k: launches.get(k, 0) for k in want} != want:
        fail(f"{label}: launches {launches}, want {want} ({2 * n} "
             "gqa_decode a step: self and cross)")
    if not ((toks >= 0) & (toks < model.cfg.vocab)).all():
        fail(f"{label}: a token outside the vocabulary")
    out = {"launches": launches, "decode_ms": sum(steady) / len(steady),
           "profiled_step_ms": sum(win_ms) / len(win_ms),
           "device_ms_per_step": dev, "busy_share": busy,
           "cross_kv_bytes": cross, "profile": window,
           "streams": toks.tolist()}
    print(f"{label} ({card}): decode step {out['decode_ms']:.2f} ms over "
          f"{len(steady)} steps; device {dev} ms a step, busy share {busy}; "
          f"cross KV {cross / 1e6:.1f} MB; launches {launches}")
    for k in window["top_kernels"]:
        print(f"    {k['ms_per_tick']:.3f} ms/step "
              f"{k['calls_per_tick']:.0f} calls/step  {k['name']}")
    return out


def seamless_phase(torch, kernels, Model, card: str) -> dict:
    """Phase 3f (c): seamless-m4t-large-v2 at full width (24 + 24 layers,
    bf16, seed 0) through ``launch/translate_audio.py``: 8 utterances of
    512 stub frames, a 4-token prompt and 64 decode steps, greedy, then
    sampled (T 0.8, top-k 50, top-p 0.95); every decode step launches 48
    ``gqa_decode`` (24 self, 24 cross) and, sampling, one ``fused_mask``;
    no ``linked_mlp``.  Eager (the reference serves this family outside
    the engine).  Prints the encoder's device ms (CUDA events), each
    run's decode step, busy share and cross-KV bytes."""
    from repro_torch.launch import translate_audio as TA
    args = TA.build_parser().parse_args(
        ["--batch", str(SLOTS), "--src-len", str(SM_FRAMES)])
    model = TA.build_model(args)
    if (model.kernel_plan.decode_dense, model.kernel_plan.sampler) != \
            ("cuda", "cuda"):
        fail(f"seamless: the card's plan {model.kernel_plan}")
    raw = model.init(torch.Generator(device=DEV).manual_seed(0))
    params = model.cast_params(raw)
    del raw
    torch.cuda.empty_cache()
    cfg = model.cfg
    print(f"seamless-m4t-large-v2 full width ({cfg.encoder_layers} + "
          f"{cfg.n_layers} layers, d {cfg.d_model}, ff {cfg.d_ff}, "
          f"{cfg.n_heads} / {cfg.n_kv_heads} heads of "
          f"{cfg.resolved_head_dim}, vocab {cfg.vocab}): "
          f"{model.param_count() / 1e9:.3f} B params")
    src, prompt = TA.stub_inputs(model, SLOTS, SM_FRAMES, 0)
    enc_ms = cuda_ms([lambda: model._encode(params, src)], iters=5,
                     warmup=1)
    print(f"seamless encoder ({SLOTS} x {SM_FRAMES} frames, {card}): "
          f"{enc_ms:.2f} ms")
    runs = {"seamless_encoder": {"ms": enc_ms}}
    for label, sampling in (("seamless_greedy", None),
                            ("seamless_sampled",
                             TA.parse_sample("0.8,50,0.95"))):
        runs[label] = translate_run(torch, kernels, TA, model, params, src,
                                    prompt, sampling, label, card)
    del params
    torch.cuda.empty_cache()
    return runs


def parity_translate(torch, pipeline, Model, cfg, n_layers: int = 2,
                     frames: int = 64, new: int = 24) -> dict:
    """Phase 4 for the encoder-decoder: the routed cuda plan against the
    plain plan on seamless at ``n_layers`` + ``n_layers`` layers, full
    width, 4 utterances of ``frames`` stub frames, greedy through
    ``translate_audio.translate``; streams must match wherever the plain
    run's top-1 / top-2 margin at the parting step exceeds the bf16
    tolerance."""
    from repro_torch.launch import translate_audio as TA
    small = dataclasses.replace(cfg, n_layers=n_layers,
                                encoder_layers=n_layers)
    plain = pipeline.KernelPlan(decode_dense="torch", sampler="fused")
    routed, _ = pipeline.select_kernel_plan({"accelerator": "cuda"})
    model = Model(small, kernel_plan=plain, device=DEV)
    raw = model.init(torch.Generator(device=DEV).manual_seed(1))
    layer_fan_in(raw, small)
    params = model.cast_params(raw)
    src, prompt = TA.stub_inputs(model, 4, frames, 1)
    logits = []
    want, _ = TA.translate(model, params, src, prompt, new_tokens=new,
                           on_step=lambda i, lg: logits.append(
                               lg[:, :small.vocab].float()))
    model.kernel_plan = routed
    got, _ = TA.translate(model, params, src, prompt, new_tokens=new)
    want, got = want.tolist(), got.tolist()
    compared = diverged = 0
    for b, (a, c) in enumerate(zip(want, got)):
        for t, (x, y) in enumerate(zip(a, c)):
            if x != y:
                top = torch.topk(logits[t][b], 2).values
                margin = (top[0] - top[1]).item()
                tol = TOL["bfloat16"]["rtol"] * max(1.0, abs(top[0].item()))
                if margin > tol:
                    fail(f"parity {small.name}: utterance {b} differs at "
                         f"step {t} where the plain margin {margin:.4f} > "
                         f"tol {tol:.4f}")
                diverged += 1
                break
            compared += 1
    print(f"parity {small.name} ({n_layers} + {n_layers} layers, {frames} "
          f"frames): {compared} tokens compared, {diverged} streams diverged "
          f"at a low-margin step, routed plan {routed.as_dict()}")
    return {"compared": compared, "diverged_low_margin": diverged}


def plain_logits(torch, model, params, prompt, generated, chunk: int,
                 max_len: int):
    """The plain plan's logits at each emitted step of one request, the
    way its engine computes them: the prompt in ``chunk``-token chunks
    from position 0, then one decode step a generated token."""
    caches = model.init_caches(1, max_len)
    for start in range(0, len(prompt), chunk):
        n = min(chunk, len(prompt) - start)
        toks = torch.zeros((1, chunk), dtype=torch.long)
        toks[0, :n] = torch.as_tensor(prompt[start:start + n])
        logits, caches = model.prefill_chunk(
            params, caches, toks, torch.tensor([start], dtype=torch.int32),
            torch.tensor([n], dtype=torch.int32))
    out = [logits[0]]
    for t in generated[:-1]:
        logits, caches = model.serve_step(
            params, caches, torch.tensor([[t]], device=DEV))
        out.append(logits[0])
    return torch.stack(out)[:, :model.cfg.vocab].float()


def routing_margins(torch, model, params, prompt, generated, chunk: int,
                    max_len: int) -> list:
    """An MoE model's routing decisions along one request, the way
    :func:`plain_logits` replays it: for each decode step (the step that
    emits ``generated[j]``, j >= 1), the least gap over layers and rows
    between the k-th and the (k+1)-th router logit, beside its bf16
    tolerance (``rtol * max(1, |k-th|)``).  A gap under it is a routing
    decision that a bf16 difference in the layer's input can flip."""
    from repro_torch.models import moe as M
    seen = []
    real = M.route

    def spy(x, router, k):
        logits = x.float() @ router.float()
        top = torch.sort(logits, dim=-1, descending=True).values
        seen.append(((top[:, k - 1] - top[:, k]).min().item(),
                     TOL["bfloat16"]["rtol"]
                     * max(1.0, top[:, k - 1].abs().max().item())))
        return real(x, router, k)
    M.route = spy
    try:
        caches = model.init_caches(1, max_len)
        for start in range(0, len(prompt), chunk):
            n = min(chunk, len(prompt) - start)
            toks = torch.zeros((1, chunk), dtype=torch.long)
            toks[0, :n] = torch.as_tensor(prompt[start:start + n])
            _, caches = model.prefill_chunk(
                params, caches, toks, torch.tensor([start], dtype=torch.int32),
                torch.tensor([n], dtype=torch.int32))
        out = []
        for t in generated[:-1]:
            seen.clear()
            _, caches = model.serve_step(
                params, caches, torch.tensor([[t]], device=DEV))
            out.append(min(seen, key=lambda g: g[0] - g[1]))
    finally:
        M.route = real
    return out


def layer_fan_in(raw, cfg) -> None:
    """Every attention's projections of ``raw`` (a stack's, an encoder's,
    a decoder's cross-attention) rescaled in place to one layer's
    fan-in: ``Model.init`` takes a stacked 4-D leaf's fan-in from its
    layer axis, as the reference's does."""
    for key, L in (("layers", cfg.n_layers), ("encoder", cfg.encoder_layers)):
        for name in ("attn", "cross_attn"):
            attn = raw.get(key, {}).get(name)
            if attn is None:
                continue
            for k in ("wq", "wk", "wv"):
                attn[k].mul_((L / cfg.d_model) ** 0.5)
            attn["wo"].mul_((L / (cfg.n_heads * cfg.resolved_head_dim))
                            ** 0.5)


def parity_phase(torch, serve, pipeline, Model, cfg, n_layers: int = 2,
                 prompt_len: int = 64, max_len: int = 256,
                 kvs=("dense", "paged"), per_layer_fan_in: bool = False):
    """Routed cuda plan vs plain-backend plan, reduced depth, greedy, over
    each KV layout in ``kvs``.  ``per_layer_fan_in`` draws the attention
    projections at one layer's fan-in: ``Model.init`` (as the
    reference's) takes a stacked 4-D leaf's fan-in from its layer axis,
    so a stack without qk-norm (hymba) at a few layers attends with
    scores of std in the hundreds, a one-hot softmax under which two
    correct bf16 paths part far past the margin rule (on an H100, hymba
    at 4 layers split at step 0, margin 0.109 against 0.067, in
    prefill, where the two plans differ only in the MLP), as
    ``tests/test_torch_recurrent.py`` shows the reference doing under a
    1e-7 move of its own weights."""
    small = dataclasses.replace(cfg, n_layers=n_layers)
    # the plain-torch plan at every site; the model's own plan, so the
    # margin logits come from it too
    plain = pipeline.KernelPlan(decode_dense="torch", decode_paged="gather",
                                decode_ring="gather", prefill_chunk="torch",
                                linked_matmul="torch", split_matmul="torch",
                                sampler="fused")
    model = Model(small, kernel_plan=plain, device=DEV)
    raw = model.init(torch.Generator(device=DEV).manual_seed(1))
    if per_layer_fan_in:
        layer_fan_in(raw, small)
    params = model.cast_params(raw)
    out = {}
    for kv in kvs:
        streams = {}
        for name, plan in (("plain", plain), ("routed", None)):
            args = serve_args(serve, requests=4, prompt_len=prompt_len,
                              max_new=24, max_len=max_len, kv=kv)
            engine = serve.build_engine(args, model, params,
                                        kernel_plan=plan)
            reqs = serve.make_requests(args, small.vocab)
            serve.serve(engine, reqs, args)
            streams[name] = ([list(r.generated) for r in reqs],
                             [r.prompt for r in reqs], engine.kernel_plan)
        routed = streams["routed"][2]
        if routed.decode_dense != "cuda" or routed.sampler != "cuda" \
                or routed.linked_matmul != "cuda" \
                or (kv == "paged" and routed.decode_paged != "cuda"):
            fail(f"parity {kv}: the routed plan did not route to cuda")
        compared = diverged = routing = 0
        for a, b, prompt in zip(streams["plain"][0], streams["routed"][0],
                                streams["plain"][1]):
            logits = plain_logits(torch, model, params, prompt, a,
                                  args.chunk, max_len)
            for t, (x, y) in enumerate(zip(a, b)):
                top = torch.topk(logits[t], 2).values
                margin = (top[0] - top[1]).item()
                tol = TOL["bfloat16"]["rtol"] * max(1.0, abs(top[0].item()))
                if x != y:
                    if margin > tol and small.family == "moe":
                        # a routing decision at a step up to t within the
                        # bf16 tolerance can flip an expert (PR 21)
                        steps = routing_margins(torch, model, params, prompt,
                                                a[:t + 1], args.chunk,
                                                max_len)
                        low = [(j + 1, g, rt) for j, (g, rt)
                               in enumerate(steps) if g <= rt]
                        print(f"parity {small.name} {kv}: parts at step {t} "
                              f"(plain margin {margin:.4f} > tol "
                              f"{tol:.4f}); routing decisions within "
                              f"their tolerance at steps up to it "
                              f"(step, gap, tol): {low[:4]}")
                        if low:
                            routing += 1
                            break
                    if margin > tol:
                        fail(f"parity {small.name} {kv}: streams differ at "
                             f"step {t} where the plain margin "
                             f"{margin:.4f} > tol {tol:.4f}")
                    diverged += 1
                    break
                compared += 1
        print(f"parity {small.name} ({n_layers} layers, prompts "
              f"{prompt_len}) {kv}: {compared} tokens compared, {diverged} "
              f"streams diverged at a low-margin step, {routing} after a "
              "low-margin routing decision, routed plan "
              f"{streams['routed'][2].as_dict()}")
        out[kv] = {"compared": compared, "diverged_low_margin": diverged,
                   "diverged_low_routing_margin": routing}
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
        if name in PTXAS_SOURCES:
            result.setdefault("ptxas", {}).update(ptxas_report(log))

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
    # linked_mlp's chunked-prefill shapes are (slots x chunk), at the
    # engine's chunk and every chunk a replan may adopt
    if paged_engine.scheduler.cfg.chunk not in pipeline.SERVE_CHUNK_SIZES:
        fail(f"the engine's chunk {paged_engine.scheduler.cfg.chunk} is not "
             f"one of {pipeline.SERVE_CHUNK_SIZES}")
    g3cfg = get_config("gemma3-1b")
    g3_model = Model(g3cfg, device=DEV)
    t0 = time.perf_counter()
    g3_params = g3_model.cast_params(g3_model.init(
        torch.Generator(device=DEV).manual_seed(0)))
    torch.cuda.synchronize()
    print(f"gemma3-1b full width ({g3cfg.n_layers} layers "
          f"{g3cfg.layer_pattern} at window {g3cfg.sliding_window}, d "
          f"{g3cfg.d_model}, {g3cfg.n_heads} q / {g3cfg.n_kv_heads} kv heads "
          f"of {g3cfg.resolved_head_dim}, vocab {g3cfg.vocab}): "
          f"{g3_model.param_count() / 1e9:.3f} B params initialized in "
          f"{time.perf_counter() - t0:.1f} s")
    # phase 3c's mixed-pool engine: its block size is the one the decode
    # kernels are held at gemma3's shapes
    g3_paged_args = serve_args(serve, kv="paged", temperature=0.8, top_k=50,
                               top_p=0.95)
    g3_engine = serve.build_engine(g3_paged_args, g3_model, g3_params)
    g3_bs = g3_engine.pool.cfg.block_size
    print(f"gemma3 mixed pool: {g3_engine.pool.stats()['classic']} classic, "
          f"{g3_engine.pool.stats()['ring']} ring, window "
          f"{g3_engine.pool.window}")
    del g3_engine

    gen = torch.Generator(device=DEV).manual_seed(0)
    report: dict = {}
    check_dense(torch, dec_ops, gen, report)
    check_paged(torch, dec_ops, gen, bs, report)
    check_decode_shards(torch, dec_ops, gen, bs, report)
    check_decode_gemma3(torch, dec_ops, gen, g3_bs, report)
    check_decode_hymba(torch, dec_ops, gen, report)
    check_decode_g1(torch, dec_ops, gen, bs, report)
    check_fused_mask(torch, fs_ops, gen, report)
    check_fused_mask_rows(torch, fs_ops, gen, report, "gemma3", G3_VOCAB,
                          G3_VOCAB + 256)
    check_fused_mask_rows(torch, fs_ops, gen, report, "hymba", HY_VOCAB,
                          HY_ROW)
    check_fused_mask_rows(torch, fs_ops, gen, report, "mamba2", M2_VOCAB,
                          M2_ROW)
    check_fused_mask_rows(torch, fs_ops, gen, report, "olmoe", OL_VOCAB,
                          OL_ROW)
    check_fused_mask_rows(torch, fs_ops, gen, report, "seamless", SM_VOCAB,
                          SM_ROW)
    check_cbr_avgpool(torch, cb_ops, gen, report)
    check_linked_mlp(torch, lm_ops, gen, pipeline.SERVE_CHUNK_SIZES, report)
    check_split_matmul(torch, sm_ops, gen, report)
    result["kernels"] = report
    if cli.kernels_only:
        print(json.dumps(result, default=str))
        return 1   # a partial run is never a passing result

    decode_tc = mlp_plan(torch, lm_ops, mlp_inputs(
        torch, SLOTS, D_MODEL, D_FF, torch.bfloat16, gen)).path == "tc"
    del paged_engine
    runs = serving_phases(torch, kernels, serve, model, params, paged_args,
                          decode_tc)
    runs.update(cache_family_phase(torch, kernels, serve, Model,
                                   (g3_model, g3_params), (model, params),
                                   g3_paged_args))
    del g3_params
    torch.cuda.empty_cache()
    runs.update(router_phase(torch, kernels, serve, model, params, card))
    runs.update(tp_phase(torch, kernels, serve, model, params, card))
    del params
    torch.cuda.empty_cache()
    recurrent = {}
    for arch in ("hymba-1.5b", "mamba2-370m"):
        rcfg = get_config(arch)
        rmodel = Model(rcfg, device=DEV)
        t0 = time.perf_counter()
        recurrent[arch] = (rmodel, rmodel.cast_params(rmodel.init(
            torch.Generator(device=DEV).manual_seed(0))))
        torch.cuda.synchronize()
        print(f"{arch} full width ({rcfg.n_layers} layers, d "
              f"{rcfg.d_model}, {rcfg.n_heads} q / {rcfg.n_kv_heads} kv "
              f"heads, window {rcfg.sliding_window}, SSM {rcfg.ssm_heads} "
              f"heads x {rcfg.ssm_head_dim} x state {rcfg.ssm_state}, conv "
              f"{rcfg.ssm_conv}, ff {rcfg.d_ff}, vocab {rcfg.vocab}): "
              f"{rmodel.param_count() / 1e9:.3f} B params initialized in "
              f"{time.perf_counter() - t0:.1f} s")
    runs.update(recurrent_phase(torch, kernels, serve,
                                recurrent["hymba-1.5b"],
                                recurrent["mamba2-370m"]))
    del recurrent
    torch.cuda.empty_cache()
    runs.update(moe_phase(torch, kernels, serve, Model, card))
    runs.update(arctic_phase(torch, kernels, serve, Model, lm_ops, gen))
    runs.update(seamless_phase(torch, kernels, Model, card))
    result["serve"] = runs
    result["parity"] = parity_phase(torch, serve, pipeline, Model, cfg)
    # gemma3 at six layers (five sliding, one global), prompts past the
    # window
    result["parity_gemma3"] = parity_phase(
        torch, serve, pipeline, Model, g3cfg, n_layers=6, prompt_len=600,
        max_len=1024)
    # hymba at four layers: dense KV, the only layout it serves; its
    # attention at one layer's fan-in (see parity_phase)
    result["parity_hymba"] = parity_phase(
        torch, serve, pipeline, Model, get_config("hymba-1.5b"), n_layers=4,
        kvs=("dense",), per_layer_fan_in=True)
    # olmoe at two layers, dense and paged; seamless at two + two; both
    # without qk-norm, so at the stacked init their plain path's bf16
    # scores (|s| in the hundreds) round by whole units: attention at one
    # layer's fan-in, as hymba's
    result["parity_olmoe"] = parity_phase(
        torch, serve, pipeline, Model, get_config("olmoe-1b-7b"),
        per_layer_fan_in=True)
    result["parity_seamless"] = parity_translate(
        torch, pipeline, Model, get_config("seamless-m4t-large-v2"))
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
            row["launches"] = sum(r.get("launches", {}).get(name, 0)
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
