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
   greedy; ``linked_mlp`` at d 1152, ff 6912, M = 8 (the swap body, a
   cluster of 3) and 256 (the prefill body), beside the unlinked form;
   and at hymba-1.5b's and
   mamba2-370m's: ``gqa_decode`` at 25 q / 5 kv heads of 64 (G = 5) over
   1024-slot rings (wrapped spans, prefixes), timed beside SDPA;
   ``linked_mlp`` at d 1600, ff 5504 (the swap body at M = 8, the
   prefill body at 256); ``fused_mask`` at (8, 32001) in a
   32,256-wide row and at (8, 50280) in a 50,432-wide one, served and
   greedy; and at a concat-TP rank's heads (qwen3's over 2 ranks, 8 q / 4
   kv, and over 4, 4 / 2), both decode kernels against their plain
   versions, timed at 8 / 4 beside the plain version and SDPA; and at MHA
   (G = 1): both decode kernels at olmoe-1b-7b's 16 q / 16 kv heads of
   128 over a 2048-slot horizon (~560 live slots timed), ``gqa_decode``
   at seamless-m4t-large-v2's 16 / 16 of 64 over a 512-frame cross span
   with every slot valid and over its 69-slot self span, each timed
   beside SDPA; ``fused_mask`` at (8, 50304) in 50,432-wide rows and at
   (8, 256206) in 256,256-wide rows, served and greedy; and at the large
   dense decoders': ``linked_mlp`` at chatglm3-6b's, granite-8b's,
   internlm2-20b's and chameleon-34b's widths (d 4096-8192) at decode
   (the swap body: one cluster over d) and a 32-token chunk of the
   slots (the prefill body, clusters splitting d), arctic-480b's dense
   residual (d 7168) at decode, batched prefill's 4352 rows at
   chatglm3's and internlm2's widths (against the fp64 sum), each timed
   beside the unlinked form, the FFMA kernel forced by its plan, the
   decode body forced (at decode), the plain version and the bound, and
   untimed at the ragged ownership edges (d 2056, 4104, 6152, ff no
   multiple of 64): the tensor-core kernel planned at every one, the
   same bits twice; the swap body forced at 1-64 rows at d 2056, 4104,
   6152 and 8200 wherever it takes them, against the fp64 sum with both
   planted faults, twice, and replayed in a CUDA graph; both
   decode kernels at 32 q / 2 kv (G 16), 48 / 8 and 64 / 8 heads of 128,
   element by element, then timed beside SDPA;
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
   decode; every prefill launch must go through its tensor-core kernel's
   prefill body, counted as ``linked_mlp_tc_prefill``, and every decode
   launch through its swap body, ``linked_mlp_tc_swap``; the replanning
   run may also send 8-token chunks, 64 rows, to the decode body,
   ``linked_mlp_tc``); each
   run's decode-attention kernel
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
3c. the attention cache families at full width: gemma3-1b (12 of its
   26 layers, ``G3_DEPTH``, cut for time: ``SSSSSG`` twice, window 512,
   RoPE theta 10k / 1M; random weights, seed 0, bf16) serving 16 requests of 600-1100-token prompts (past the
   window: every sliding ring wraps in prefill) and 64 new tokens, dense
   KV greedy and the mixed pool sampled (T 0.8, top-k 50, top-p 0.95),
   each graphed beside its eager twin, streams equal bit for bit; a
   decode tick launches ``gqa_decode`` 12 times (dense) or 10 times plus
   ``gqa_decode_paged`` twice (mixed), ``linked_mlp_tc_swap`` 12 times and
   ``fused_mask`` once; every request holds a classic and a ring lease,
   the ring lease window / block size blocks whatever its context; then
   qwen3-1.7b with a 512-token window, 8 requests, ring-paged beside
   dense KV, greedy, streams equal bit for bit.  Prints each run's
   steady step, busy share, profiled kernels and KV bytes beside the
   dense full-attention KV;
3d. the recurrent cache families at full width, depth cut for time
   (random weights, seed 0, bf16, dense KV, chunked prefill at chunk 32,
   replanning off): hymba-1.5b (8 of its 32 layers, d 1600, attention
   and Mamba2 heads in parallel, window 1024, SSM 50 heads x 64 x state
   16) serving 16 requests of 1100-1600-token prompts (every ring wraps
   in prefill) and 64 new tokens, greedy and sampled (T 0.8, top-k 50,
   top-p 0.95), and mamba2-370m (12 of its 48 layers, d 1024, SSM 32
   heads x 64 x state 128) serving 16 requests of 480-544-token
   prompts, greedy (16 requests: two waves over the 8 slots, the second
   admitted into slots the first freed); each run
   graphed beside its eager twin, streams equal bit for bit, the plan's
   ``kv_growth`` "constant"; a hymba decode replay launches
   ``gqa_decode`` and ``linked_mlp_tc_swap`` once a layer and
   ``fused_mask`` once, a mamba2 one ``fused_mask`` alone (no attention
   or MLP kernel ever).  Prints each run's steady step, busy share and
   cache bytes
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
   ``linked_mlp_tc_swap``; (c) seamless-m4t-large-v2 (24 + 24 layers, d
   1024, ff 8192, 16 / 16 heads of 64, vocab 256,206) through
   ``launch/translate_audio.py``: 8 utterances of 512 stub frames, a
   4-token prompt and 64 decode steps, greedy and sampled, 48
   ``gqa_decode`` a step (24 self, 24 cross), one ``fused_mask`` a
   sampled step, no ``linked_mlp``; prints the encoder's device ms, the
   decode step, busy share and cross-KV bytes;
3g. long context at full width (random weights, seed 0, bf16, one slot,
   a 32,768-slot horizon): qwen3-1.7b and gemma3-1b (its sliding layers
   on the banded scan) each serve one greedy request of a 31,744-token
   prompt (31 x 1024, so ``chunked_attention``'s 512 / 1024 blocks divide
   it) and 64 new tokens, (i) with ``prefill_mode="batched"`` (one
   one-shot ``prefill_step``: the scan on every attention layer, a spy
   counts it) and (ii) with ``prefill_mode="chunked"`` at chunk 512
   (qwen3 dense, gemma3 the mixed pool: its global layers decode through
   ``gqa_decode_paged`` over 32,768 slots), both graphed; (i)'s one-shot
   prefill measured inside the engine (wall and device ms, profiler;
   ``max_memory_allocated`` beside the bytes held and its caches); from
   a copy of its caches, the eager decode step at the model level; an
   exact path teacher-forced along (i)'s stream (qwen3: the
   chunked prefill; gemma3: a one-shot ``full_attention`` prefill, as its
   chunks into 512-slot sliding rings are lossy) holds the prefill and
   first decode step's logits within the bf16 tolerance and every token
   by phase 4's margin rule; (i) ≡ (ii) by the same rule for qwen3,
   reported for gemma3;
3h. the reference's large dense decoders at full width (random weights,
   seed 0, drawn leaf by leaf into bf16 by ``launch/serve.py``'s
   ``init_params``, whose peak must stay within the bf16 tree plus the
   largest leaf's fp32 draw plus 1 GB; 8 slots over 2048, dense KV,
   chunk 32, 32 new tokens, replanning off): chatglm3-6b (28 layers, 32
   q / 2 kv heads, partial RoPE) serving 16 greedy requests of
   480-544-token prompts (two waves), then 8 paged and sampled (T 0.8,
   top-k 50, top-p 0.95); granite-8b (36 layers) and internlm2-20b (48)
   8 greedy; chameleon-34b at 12 of its 48 layers (``LARGE_DEPTH``: its
   full depth does not fit one card), 8 greedy.  Each run graphed beside
   its eager twin, streams equal bit for bit; every ``linked_mlp``
   launch a tensor-core one (prefill ``linked_mlp_tc_prefill``, decode
   the swap body, ``linked_mlp_tc_swap``: one cluster over d); a decode
   replay launches ``linked_mlp_tc_swap`` and the decode-attention
   kernel once a
   layer and ``fused_mask`` once.  Prints each model's init peak beside
   its bf16 and largest-leaf fp32 bytes, steady step, device ms a tick,
   busy share, weights and KV bytes and the MLP's device ms a tick
   beside its weights' bytes bound; each model is freed before the next;
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
   in a layer's input can swap an expert: ``routing_margins``); the
   same rule for chatglm3-6b and internlm2-20b at 2 layers and full
   width (attention at one layer's fan-in) and chameleon-34b at 2 (its
   qk-norm);
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
   the device busy share of xenos;
6. training (``Model.train_step``: AdamW, per-layer remat, the loss
   over the padded vocabulary), which runs none of the six kernels:
   (a) reduced qwen3-1.7b, olmoe-1b-7b and mamba2-370m (fp32, TF32 off,
   attention at one layer's fan-in), three steps from one state on the
   card under the ``cuda`` kernel plan and on the host: losses at rtol
   1e-4, params by the CPU parity tests' rule (``close_params``); (b)
   the reference's convergence checks on the card: reduced qwen3 40
   steps and reduced olmoe 50 (grad clip 10) at batch 8 x seq 32, peak
   lr 3e-3, warmup 5 (last-5 mean below first-5 by 0.2 / 0.05), and
   ``examples/train_lm.py``'s ~100M config, 200 steps of 8 x 256 at
   peak 1e-3, warmup 20 (last-10 mean below first-10); (c) qwen3-1.7b at
   full width (bf16 compute, fp32 params and moments, remat on), 20
   steps of 8 x 512 tokens of ``SyntheticLM``, cosine lr 3e-4 warmup 5,
   every loss and grad norm finite: the param count, the median step
   over steps 3-20, forward / backward / optimizer by CUDA events,
   tokens/s, MFU (6 N + attention FLOPs a token over the bf16 dense
   peak), peak memory, the busy share and top device ops of two
   profiled steps, the first-5 / last-5 loss means; then three steps
   with int8 moments, their step ms and moment bytes; (d) reduced
   qwen3's train state with int8 moments saved from the card and loaded
   back onto it, equal bit for bit.  ``LAUNCHES`` must not move across
   the phase.  Before it, the bytes still allocated on the card are
   printed: the serving phases' weights are gone once their callers drop
   them (``Model._layers``' memo holds none of them);
7. measured kernel-site routing and the d-Xenos collectives: (a)
   ``launch.autotune.bench_kernel_sites`` at the reference's defaults
   (fp32), qwen3-1.7b's served geometry and hymba-1.5b's attention over
   its 1024-slot window (both bf16; ``BENCH_GEOMETRIES``), every
   ``site:backend`` time printed beside the plan ``select_kernel_plan``
   derives from it and the heuristic plan; each of ``gqa_decode``,
   ``gqa_decode_paged`` and ``fused_mask`` must launch 24 times a
   geometry (each candidate is timed as a CUDA graph's replays); (b) a
   graphed full-width qwen3-1.7b paged engine built with
   ``kernel_timings=`` (qwen3's timings) must take that plan and serve
   8 of phase 3's sampled requests (32 new tokens) with the streams, bit
   for bit, of an engine given the plan explicitly, each launching the
   kernels its plan routes to and no other; an engine built with
   ``kernel_plan="off"`` must launch none; the timings survive
   ``save_timings`` / ``load_timings``; (c) ``python -m
   repro_torch.launch.kernel_tune`` once at the reference's defaults,
   its cache in ``chiprun_out/kernel_timings.json``; (d)
   ``ring_allreduce`` and ``ps_sync`` on 8 ranks spawned on this card
   (gloo, staged through the host), in groups of 2, 4 and 8 ranks on
   2^20 fp32 a rank (Fig. 11's size) and of 4 on resnet18's parameter
   vector: each equal bit for bit to the numpy sum in its schedule's
   order and to ``dist.all_reduce`` within fp32 rounding; prints each
   schedule's median time and the bytes a rank sends;
8. the d-Xenos planning tools, in a process of their own started after
   phase 2 (host work only: fake ranks, no card), read after phase 7:
   (a) the fake-rank dry run (``launch/dryrun.py``) of qwen3-1.7b at
   ``train_4k``, ``prefill_32k`` and ``decode_32k``, olmoe-1b-7b at
   ``decode_32k`` and mamba2-370m at ``long_500k`` on the 16x16
   production mesh, full width, each printed as its dominant term,
   bound, per-rank FLOPs, bytes and collective bytes, peak and whether it
   fits; (b) ``launch.autotune.tune`` of qwen3-1.7b at ``decode_32k``
   over the seven rule sets, its ranking (``baseline_outC`` must score a
   finite bound); (c) ``launch.hillclimb.run_pair("chameleon_decode")``,
   chameleon-34b's three variants; (d) the roofline anchored to this
   card on a 1-rank mesh: the dry run's bound for qwen3-1.7b's served
   decode step (8 slots, 2048, bf16 weights) beside phase 3's graphed
   dense step, and its FLOPs and peak for phase 6's full-width train step
   (8 x 512, remat on) beside phase 6's executed FLOPs (the HFU
   numerator) and ``max_memory_allocated``, reported side by side, not
   gated.  Any dry run that raises fails the run.  No kernel launches;
9. training on a mesh, after phase 8 is read: 4 ranks spawned on this
   card (gloo, one process a rank) over the (data 2, model 2) debug
   mesh, ``Model.train_step`` over DTensor (params and moments sharded
   by the d-Xenos rules, each rank's rows of the batch): (a) reduced
   qwen3-1.7b and olmoe-1b-7b (capacity factor 8, attention at one
   layer's fan-in), 3 steps of 4 x 16 from one state, against the
   one-device card step from the same state and batches: losses and
   grad norms at rtol 1e-5 and the same bits on every rank, params by
   ``close_params``, every leaf a mesh dim replicates bit-equal on the
   ranks that share it; (b) qwen3-1.7b at full width (params drawn on
   each rank leaf by leaf from one seed, each keeping its shard), 2
   steps of 4 x 256 of ``SyntheticLM``, remat on; its depth cut, printed
   with the reason, only where phase 8's dry run of that step (one rank
   of the mesh) puts four ranks' peaks plus 3 GB, plus what this process
   still holds on the card, past 75 GB; losses
   finite and the same on every rank; prints each rank's
   ``max_memory_allocated`` beside the dry run's per-rank peak, its
   collectives by kind and count (``CommDebugMode``, the second step)
   beside the dry run's, and its step times, gloo through the host, not
   card to card.  No kernel launches.

Phase 2 also holds ``cbr_avgpool`` against ``cbr_avgpool_plain`` element
by element (|kernel - plain| <= 2e-5 + 2e-5 |plain|, fp32), twice (the
same bits), at the Figure-5 and Table-4 shapes and at odd H and W, C = 3,
OC = 10, N = 2, printing the plan ``cbra_plan`` picks for each, and
times the kernel, its plain version and the unlinked form (``addmm``,
``relu_``, ``avg_pool2d`` over the materialized pre-pool map), printing
at t4_8x8 whether the kernel beats either (a finding, not a gate);
``linked_mlp`` (fp32 against ``linked_mlp_plain`` at 2e-5 / 2e-5, bf16
against the fp64-summed MLP as below) at the serving shapes, decode
(8, 2048, 6144) and prefill
(8 x each chunk a replan may adopt, 8 to 64, 2048, 6144), and at fp32,
ragged and M = 1
shapes, printing the plan (kernel, tile, cluster, ff splits) of each;
at batched prefill's shape (8 x the longest prompt, 2048, 6144)
bf16, which must take the tensor-core kernel, the kernel and its plain
version each against the fp64-summed MLP
(the kernel's worst error within ``MLP_ORDER_FACTOR`` times the plain
version's; two planted faults must fail that test); every bf16 case
(the ragged-M one on 16 more input sets) held, kernel and plain version
each, against the fp64-summed MLP with ``linked_matmul.ops``'s
``mlp_reference`` limit (the h-rounding slack), both planted faults
failing it; timing the planned body, the decode body forced at prefill
and swap-body shapes (the design before each), its plain version and
the unlinked three-matmul form at the served shapes; and
``split_matmul`` against ``split_matmul_plain`` (fp32, 2e-5 / 2e-5) at
bert_s's two plan tiles, inC splits (one with a cluster split inside
each of its K tiles), M = 1 and ragged cases, twice each (the same
bits), timing the kernel, its plain version and ``torch.addmm``.  Phase
1 prints the registers and spills ``nvcc -Xptxas -v`` reports for the
instantiations of the two GEMM kernels, ``fused_mask``, ``cbr_avgpool``
and the decode kernels' group body.

Phase 2 also holds both decode kernels over 32,768 slots (qwen3's dense
and gemma3's heads, gemma3's paged global layers; 8 rows of mixed
lengths and one row, fp32 and bf16, two calls the same bits), timed at
one row beside SDPA; both decode kernels at G 3, 5, 6, 7, 8 and 16 (the
group body in bf16), two calls the same bits, and the bf16 kernel's
distance to an fp64 oracle at most ``DECODE_ORDER_FACTOR`` times the
plain version's; and ``linked_mlp`` at the one-shot prefill's M 31,744
against the fp64-summed MLP (as at batched prefill's shape), timed.

The line before last is the kernel table as JSON; the last line is
``{"ok": true, "device": {...}}``.  A copy of everything measured goes to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import argparse
import atexit
import contextlib
import dataclasses
import gc
import json
import os
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
#: linked_mlp: fp32 element-wise against the plain version; bf16 against
#: the fp64-summed MLP (``mlp_reference``): atol + rtol |ref| plus one bf16
#: step of each h element a correct fp32 order can round apart, carried
#: through |Wd|
MLP_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
           "bfloat16": dict(rtol=2e-2, atol=1e-3)}
#: ragged_m_bf16's extra input sets, drawn from a generator of their own
MLP_RAGGED_SETS, MLP_RAGGED_SEED = 16, 30
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
#: phase 3c's gemma3-1b depth (of 26): two SSSSSG periods, both layer
#: kinds, cut for time as phase 3d's (its runs are host-bound a layer)
G3_DEPTH = 12
#: hymba-1.5b (configs/hymba_1_5b.py): 25 q / 5 kv heads of 64 over a
#: 1024-token window, d 1600, ff 5504, vocab 32,001 in a 32,256-wide
#: padded row; mamba2-370m's vocab 50,280 in a 50,432-wide row
HY_H, HY_K, HY_D, HY_WINDOW = 25, 5, 64, 1024
HY_D_MODEL, HY_D_FF, HY_VOCAB, HY_ROW = 1600, 5504, 32001, 32256
M2_VOCAB, M2_ROW = 50280, 50432
#: phase 3d's depths (of 32 and 48): cut so the smoke keeps its two waves
#: of requests inside its time limit on a slow host
RECURRENT_DEPTH = {"hymba-1.5b": 8, "mamba2-370m": 12}
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
#: phase 3g: long context, one slot over a 32,768-slot horizon.  The
#: prompt is 31,744 tokens (31 x 1024): the chunked scan's 512 / 1024
#: blocks divide it (at a length they do not divide, the one-shot prefill
#: falls back to full attention, as the reference's does, and qwen3's
#: scores alone would not fit the card), 64 new tokens; the chunked
#: twin's chunk, the prompt's seed and the model-level eager decode steps
#: timed
LONG_PROMPT, LONG_NEW, LONG_MAX_LEN = 31744, 64, 32768
LONG_CHUNK, LONG_SEED, LONG_EAGER_STEPS = 512, 41, 8
#: phase 2 / 3h: the reference's large dense decoders, each at full
#: width; LARGE_DEPTH cuts a depth (chameleon-34b: its 48 layers' bf16
#: weights beside its largest leaf's fp32 draw do not fit one card)
LARGE_ARCHS = ("chatglm3-6b", "granite-8b", "internlm2-20b", "chameleon-34b")
LARGE_DEPTH = {"chameleon-34b": 12}
#: phase 3h's new tokens a request and its profiled decode ticks (the
#: first wave's decode, whether the prompts were admitted in chunks or
#: at once)
LARGE_NEW, LARGE_WINDOW = 32, (20, 25)
#: phase 2: the tensor-core kernel's column ownership at ragged widths (a
#: d just past 2048, d that no cluster's 256-column ranks divide) with ff
#: no multiple of 64: (M, d, ff)
MLP_RAGGED_WIDE = {"ragged_d2056": (37, 2056, 6144),
                   "ragged_d4104": (8, 4104, 13704),
                   "ragged_d6152": (65, 6152, 16392)}
#: phase 2: the group sizes the decode kernels are held at (7: arctic-480b
#: at full width; 3, the least G the group body takes, serves no arch)
GROUP_GS = (3, 5, 6, 7, 8, 16)
#: the bf16 decode kernel's worst distance to the fp64 oracle, at most
#: this many times the plain version's
DECODE_ORDER_FACTOR = 2.0
#: phase 2: the decode kernels at the large decoders' head layouts (q
#: heads, kv heads) of 128
LARGE_HEADS = {"chatglm3": (32, 2), "internlm2": (48, 8),
               "chameleon": (64, 8)}
#: phase 8: the full-width dry runs on the 16x16 production mesh, the
#: tuned (arch, shape), the hillclimb pair, and the time the phase's
#: process may take past phase 7's end
PLAN_RUNS = (("qwen3-1.7b", "train_4k"), ("qwen3-1.7b", "prefill_32k"),
             ("qwen3-1.7b", "decode_32k"), ("olmoe-1b-7b", "decode_32k"),
             ("mamba2-370m", "long_500k"))
PLAN_TUNE = ("qwen3-1.7b", "decode_32k")
PLAN_PAIR = "chameleon_decode"
PLAN_TIMEOUT = 300.0
#: phase 9: the training mesh's ranks (data 2 x model 2, all on this
#: card), the reduced runs' batch x seq and steps, the full-width run's
#: batch x seq and steps, the card's memory the four ranks may take by
#: phase 8's dry run (beside the 3 GB of CUDA contexts and the parent),
#: and the time the ranks may take
MESH_RANKS = 4
MESH_BATCH, MESH_SEQ, MESH_STEPS = 4, 16, 3
MESH_FULL_BATCH, MESH_FULL_SEQ, MESH_FULL_STEPS = 4, 256, 2
MESH_CARD_GB, MESH_SLACK_GB = 75.0, 3.0
MESH_TIMEOUT = 420.0


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
#: their mangled names: the tensor-core linked_mlp's three bodies (the
#: swap body by its rows, N),
#: split_matmul (rows a
#: CTA, k halves, cluster size, 16-byte copies), fused_mask (cluster
#: size, 16-byte copies), cbr_avgpool (thread columns and rows, k parts,
#: squares a thread, cluster size, 16-byte copies) and the decode
#: kernels' group body (head dim, 8-head blocks, paged)
PTXAS_KERNELS = {
    r"linked_mlp_tcE": "linked_mlp_tc",
    r"linked_mlp_tc_prefillE": "linked_mlp_tc_prefill",
    r"linked_mlp_tc_swapILi(\d+)E": "linked_mlp_tc_swap<N={}>",
    r"split_matmul_kernelILi(\d+)ELi(\d+)ELi(\d+)ELb(\d)E":
        "split_matmul_kernel<BM={},KH={},CL={},VEC={}>",
    r"fused_mask_kernelILi(\d+)ELb(\d)E": "fused_mask_kernel<CL={},VEC={}>",
    r"cbr_avgpool_kernelILi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELi(\d+)ELb(\d)E":
        "cbr_avgpool_kernel<TXN={},TYN={},KH={},TSQ={},CL={},VEC={}>",
    r"group_kernelILi(\d+)ELi(\d+)ELb(\d)E": "group_kernel<D={},NB={},PAGED={}>"}
#: the sources whose kernels those are
PTXAS_SOURCES = ("linked_mlp", "split_matmul", "fused_sampler",
                 "linked_cbr_pool", "decode_attention")


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
    S = ops.decode_grid(SLOTS, K, H // K, MAX_LEN, sms, D).splits
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
        "splits": S, "plan": plan_of(torch, ops, SLOTS, K, H // K, MAX_LEN,
                                      D),
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
        plan = plan_of(torch, ops, SLOTS, k, h // k, MAX_LEN, D)
        row = report[label]["k4"] = {
            "heads": [h, k], "splits": plan[2], "plan": plan,
            "ms": cuda_ms([lambda s=s: fn(*s) for s in sets]),
            "plain_ms": cuda_ms([lambda s=s: plain(*s) for s in sets]),
            "library_ms": cuda_ms([lambda s=s: sdpa(*s) for s in views]),
            "bound_ms": b_ms, "bound_by": b_by}
        print(f"{label} at a rank's {h} q / {k} kv heads, ~560 of "
              f"{MAX_LEN} slots: {row['ms']:.4f} ms (plan "
              f"{row['plan']}; bound {b_ms:.4f} by {b_by}, share "
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
            plan = ops.decode_grid(SLOTS, G3_K, G3_H // G3_K, W, sms, G3_D,
                                   dtype)
            q, k, v, valid = g3_decode_case(torch, dtype, W, sp, gen)
            err = check_close(
                f"gqa_decode gemma3 {name} W={W} wrapped spans (plan "
                f"{tuple(plan)})", ops.gqa_decode(q, k, v, valid),
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
    # B = 1: bf16's row past the group body's one-merge cap (two merge
    # levels), fp32's at the heads body's (the merge filling the ring);
    # the fp32 row draws from a generator of its own, so every later
    # check draws what it drew before the fp32 row was added
    for dtype, g in ((torch.bfloat16, gen), (torch.float32, new_gen(torch))):
        name = str(dtype).split(".")[-1]
        plan = ops.decode_grid(1, G3_K, G3_H // G3_K, MAX_LEN, sms, G3_D,
                               dtype)
        cap = ops.merge_cap(plan.body, G3_D, plan.gt)
        if (plan.splits == cap) != (dtype == torch.float32) \
                or plan.splits < cap:
            fail(f"gqa_decode gemma3 B=1 {name}: plan {tuple(plan)}, one "
                 f"merge's cap {cap}")
        q, k, v, valid = g3_decode_case(torch, dtype, MAX_LEN,
                                        [(100, 1900)], g)
        check_close(f"gqa_decode gemma3 B=1 {name} (plan {tuple(plan)}, "
                    f"cap {cap})", ops.gqa_decode(q, k, v, valid),
                    ops.gqa_decode_plain(q, k, v, valid), name)
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
        plan = plan_of(torch, ops, SLOTS, G3_K, G3_H // G3_K, W, G3_D)
        row = {"shape": [SLOTS, G3_H, G3_D, W], "dtype": "bfloat16",
               "splits": plan[2], "plan": plan,
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
                "block_size": bs, "plan": plan,
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
    in bf16 the group body, 40 units at B = 8; in fp32 one query head a
    CTA, 200 units) over its 1024-slot
    sliding rings, element by element in fp32 and bf16 (full windows
    whose span starts mid-row, short, empty, prefix rows), then timed at
    the served shape (bf16, every window full, as after a prefill past
    it) beside SDPA and the bytes bound; under ``hymba`` in the row."""
    heads = (HY_H, HY_K, HY_D)
    W = HY_WINDOW
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    worst = {}
    cases = {"wrapped": [(137, W), (0, W), (W - 3, 3), (300, 200), (1, 1),
                         (0, 0), (64, 1000), (W - 1, W)],
             "prefix": [(0, n) for n in (W, 600, 0, 1, W - 1, 17, 513,
                                         256)]}
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        for label, sp in cases.items():
            plan = ops.decode_grid(SLOTS, HY_K, HY_H // HY_K, W, sms, HY_D,
                                   dtype)
            q, k, v, valid = g3_decode_case(torch, dtype, W, sp, gen, heads)
            err = check_close(
                f"gqa_decode hymba {name} W={W} {label} (plan "
                f"{tuple(plan)})", ops.gqa_decode(q, k, v, valid),
                ops.gqa_decode_plain(q, k, v, valid), name)
            worst[name] = max(worst.get(name, 0.0), err)
    sp = [(s0, W) for s0 in (137, 0, 300, 480, 64, 7, 211, 1000)]
    rows = sum(n for _, n in sp)
    sets = [g3_decode_case(torch, torch.bfloat16, W, sp, gen, heads)
            for _ in range(ROTATE)]
    nbytes = 2 * rows * HY_K * HY_D * 2 + 2 * SLOTS * HY_H * HY_D * 2 \
        + SLOTS * W
    b_ms, b_by = bound_ms(nbytes, 4 * rows * HY_H * HY_D, "bfloat16")
    plan = plan_of(torch, ops, SLOTS, HY_K, HY_H // HY_K, W, HY_D)
    row = {"shape": [SLOTS, HY_H, HY_K, HY_D, W], "dtype": "bfloat16",
           "gt": plan[1], "splits": plan[2], "plan": plan,
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


def new_gen(torch, seed: int = 29):
    """A generator for inputs a check added after the others: the shared
    one keeps drawing what it drew for every earlier check."""
    return torch.Generator(device=DEV).manual_seed(seed)


def plan_of(torch, ops, B, K, G, W, D) -> list:
    """The bf16 plan (body, query heads a CTA, splits) a decode launch of
    these shapes takes on this card, as a JSON list."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return list(ops.decode_grid(B, K, G, W, sms, D))


def same_bits(torch, label: str, a, b) -> None:
    """Fail unless two calls on the same inputs gave the same bits."""
    if not torch.equal(a, b):
        fail(f"{label}: two calls differ (max "
             f"{(a.float() - b.float()).abs().max().item():.3e})")


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
            plan=plan_of(torch, ops, SLOTS, OL_K, 1, MAX_LEN, OL_D))
        print_share({"name": f"{label} olmoe ~560 of {MAX_LEN} slots "
                     f"(plan {row['plan']})", **row})
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
            plan=plan_of(torch, ops, SLOTS, SM_K, 1, W, SM_D))
        print_share({"name": f"gqa_decode {key} W={W} all valid "
                     f"(plan {row['plan']})", **row})


def check_decode_long(torch, ops, gen, g3_bs, report):
    """Both decode kernels over phase 3g's 32,768-slot horizon: qwen3's
    ``gqa_decode`` (16 q / 8 kv heads of 128) and gemma3's global layers'
    ``gqa_decode_paged`` (4 / 1 of 256, the mixed pool's block size
    ``g3_bs``), plus ``gqa_decode`` at gemma3's heads (its dense global
    layers); element by element against the plain version in fp32 and
    bf16 at 8 rows of mixed lengths (full, the phase's prompt, 1, 0,
    mid-horizon) and at one row (the phase's slot, at the B = 1 split
    count), then timed at the served shape (bf16, one row holding the
    prompt and half the new tokens) beside SDPA and the bytes bound:
    rows ``qwen3_w32768`` and ``gemma3_w32768`` (its dense global layers)
    of ``gqa_decode``, ``gemma3_w32768`` of ``gqa_decode_paged``; two
    calls give the same bits."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    W = LONG_MAX_LEN
    mixed = [W, LONG_PROMPT, 1, 0, W // 2 + 3, W - 1, 100, 20000]
    live = LONG_PROMPT + LONG_NEW // 2
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        key = "max_abs_err" if name == "bfloat16" else "max_abs_err_fp32"
        for lengths in (mixed, [live]):
            for heads, tag in (((H, K, D), "qwen3"),
                               ((G3_H, G3_K, G3_D), "gemma3")):
                nh, nk, hd = heads
                plan = ops.decode_grid(len(lengths), nk, nh // nk, W, sms,
                                       hd, dtype)
                q, k, v, valid = g3_decode_case(
                    torch, dtype, W, [(0, n) for n in lengths], gen, heads)
                got = ops.gqa_decode(q, k, v, valid)
                err = check_close(
                    f"gqa_decode {tag} {name} W={W} B={len(lengths)} (plan "
                    f"{tuple(plan)})", got,
                    ops.gqa_decode_plain(q, k, v, valid), name)
                same_bits(torch, f"gqa_decode {tag} {name} W={W}", got,
                          ops.gqa_decode(q, k, v, valid))
                report["gqa_decode"][key] = max(report["gqa_decode"][key],
                                                err)
                del q, k, v, valid
            args = g3_paged_case(torch, dtype, W, g3_bs, lengths, gen)
            plan = ops.decode_grid(len(lengths), G3_K, G3_H // G3_K, W, sms,
                                   G3_D, dtype)
            got = ops.gqa_decode_paged(*args)
            err = check_close(
                f"gqa_decode_paged gemma3 {name} W={W} bs={g3_bs} "
                f"B={len(lengths)} (plan {tuple(plan)})", got,
                ops.gqa_decode_paged_plain(*args), name)
            same_bits(torch, f"gqa_decode_paged gemma3 {name} W={W}", got,
                      ops.gqa_decode_paged(*args))
            report["gqa_decode_paged"][key] = max(
                report["gqa_decode_paged"][key], err)
            del args
    torch.cuda.empty_cache()
    # timed at the served shape: one row, its K/V read once a call.
    # gemma3's dense row draws from the shared generator (every later
    # check's inputs follow from its draws), qwen3's from one of its own
    for tag, heads, g in (("gemma3_w32768", (G3_H, G3_K, G3_D), gen),
                          ("qwen3_w32768", (H, K, D), new_gen(torch, 30))):
        nh, nk, hd = heads
        sets = [g3_decode_case(torch, torch.bfloat16, W, [(0, live)], g,
                               heads) for _ in range(ROTATE)]
        nbytes = 2 * live * nk * hd * 2 + 2 * nh * hd * 2 + W
        row = report["gqa_decode"][tag] = time_decode_row(
            torch, ops, sets, nbytes, 4 * live * nh * hd,
            shape=[1, nh, nk, hd, W], live=live,
            plan=plan_of(torch, ops, 1, nk, nh // nk, W, hd))
        print_share({"name": f"gqa_decode {tag.split('_')[0]} {live} of "
                     f"{W} slots, B 1 (plan {row['plan']})", **row})
        del sets
        torch.cuda.empty_cache()
    psets = [g3_paged_case(torch, torch.bfloat16, W, g3_bs, [live], gen)
             for _ in range(ROTATE)]
    nbytes = (2 * live * G3_K * G3_D * 2 + 2 * G3_H * G3_D * 2
              + psets[0][3].numel() * 4 + 4)
    row = report["gqa_decode_paged"]["gemma3_w32768"] = time_decode_row(
        torch, ops, psets, nbytes, 4 * live * G3_H * G3_D, paged=True,
        shape=[1, G3_H, G3_K, G3_D, W], live=live, block_size=g3_bs,
        plan=plan_of(torch, ops, 1, G3_K, G3_H // G3_K, W, G3_D))
    print_share({"name": f"gqa_decode_paged gemma3 {live} of {W} slots, "
                 f"B 1, bs {g3_bs} (plan {row['plan']})", **row})
    del psets
    torch.cuda.empty_cache()


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
        "plan": plan_of(torch, ops, SLOTS, K, H // K, MAX_LEN, D),
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


def mlp_faults(torch, args) -> dict:
    """The planted faults' inputs: the up-projection term of the largest
    |x| left out (that column of x 0) and the ff column whose h is
    largest left out (that row of wd 0).  The last term or column, taken
    blindly, can carry too little to see: one row's x[:, -1] may be near
    0, and at decode rows past d 4096 the last column's h lies under any
    limit that passes correct orders."""
    F = torch.nn.functional
    x, wg, wu, wd = args
    x_cut = x.clone()
    x_cut[:, x.float().abs().amax(0).argmax()] = 0
    col = (F.silu(x.float() @ wg.float()) * (x.float() @ wu.float())
           ).abs().amax(0).argmax()
    wd_cut = wd.clone()
    wd_cut[col] = 0
    return {"d_term": (x_cut, wg, wu, wd), "ff_column": (x, wg, wu, wd_cut)}


def hold_bf16(torch, ops, label, args, got, plain, plan=None) -> dict:
    """The bf16 check (``ops.mlp_reference``): the kernel's result and the
    plain version's each within the fp64-summed MLP's limit, and both
    planted faults, launched through the kernel (``plan``: a forced
    one), outside it.  Fails the smoke otherwise; returns each one's
    worst err / limit."""
    ref, limit = ops.mlp_reference(*args)
    out = {"kernel": ops.reference_err(got, ref, limit),
           "plain": ops.reference_err(plain, ref, limit)}
    for k, fa in mlp_faults(torch, args).items():
        out[k] = ops.reference_err(ops.linked_mlp(*fa, plan=plan), ref,
                                   limit)
    print(f"linked_mlp {label}: worst err / (atol + rtol |fp64| + h slack): "
          + ", ".join(f"{k} {v:.3f}" for k, v in out.items()))
    for k in ("kernel", "plain"):
        if not out[k] <= 1.0:
            fail(f"linked_mlp {label}: the {k} result is {out[k]:.3f} of "
                 "the fp64 limit")
    for k in ("d_term", "ff_column"):
        if not out[k] > 1.0:
            fail(f"linked_mlp {label}: the planted fault {k} "
                 f"({out[k]:.3f}) passes the fp64 limit")
    del ref, limit
    return out


#: the launch counter of each tensor-core linked_mlp body
MLP_BODY_KEY = {"decode": "linked_mlp_tc", "swap": "linked_mlp_tc_swap",
                "prefill": "linked_mlp_tc_prefill"}


def mlp_body_key(cfg, rows: int = SLOTS) -> str:
    """The launch counter of the tensor-core body ``cfg``'s SwiGLU takes at
    ``rows`` rows on this card (decode and each verify position: the
    slots)."""
    import torch
    from repro_torch.kernels.linked_matmul import ops
    plan = ops.mlp_plan(rows, cfg.d_model, cfg.d_ff, torch.bfloat16, True,
                        torch.cuda.get_device_properties(0)
                        .multi_processor_count,
                        slots=ops.cluster_slots(torch.device("cuda", 0)))
    return MLP_BODY_KEY[plan.body]


def mlp_plan(torch, ops, args):
    """The plan ``linked_mlp`` picks for ``args`` on this card."""
    x, wg = args[0], args[1]
    return ops.mlp_plan(
        x.shape[0], x.shape[1], wg.shape[1], x.dtype,
        all(a.data_ptr() % 16 == 0 for a in args),
        torch.cuda.get_device_properties(0).multi_processor_count,
        slots=ops.cluster_slots(x.device))


def time_mlp_case(torch, ops, gen, label, args, row, ffma=False):
    """The kernel's, plain and unlinked times at ``args``' shape, rotating
    over two weight sets (151 MB at the served widths, past the 50 MB L2:
    serving reads each layer's weights cold); ``ffma`` also times the
    FFMA kernel, forced by its plan (the route bf16 widths past d 2048
    took before clusters split d)."""
    (M, d), ff = args[0].shape, args[1].shape[1]
    sets = [args, mlp_inputs(torch, M, d, ff, args[0].dtype, gen)]
    nbytes = 2 * (3 * d * ff + 2 * M * d)
    flops = 2 * M * d * ff * 3 + 4 * M * ff    # matmuls; silu, product
    b_ms, b_by = bound_ms(nbytes, flops, "bfloat16")
    r = row["per_shape"].setdefault(label, {})
    plan = mlp_plan(torch, ops, args)
    r.update({
        "shape": [M, d, ff], "plan": plan._asdict(),
        "ms": cuda_ms([lambda a=a: ops.linked_mlp(*a) for a in sets]),
        "plain_ms": cuda_ms([lambda a=a: ops.linked_mlp_plain(*a)
                             for a in sets]),
        "unlinked_ms": cuda_ms([lambda a=a: unlinked_mlp(*a) for a in sets]),
        "bound_ms": b_ms, "bound_by": b_by})
    r["share"] = b_ms / r["ms"]
    if plan.body in ("prefill", "swap"):
        # the decode body forced at the same shape: the design before
        # this body
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        dplan = ops.mlp_plan(M, d, ff, args[0].dtype, True, sms, path="tc",
                             slots=ops.cluster_slots(args[0].device),
                             body="decode")
        r["decode_body"] = {"plan": dplan._asdict(), "ms": cuda_ms(
            [lambda a=a: ops.linked_mlp(*a, plan=dplan) for a in sets],
            iters=24 if M < 8192 else 6, warmup=3 if M < 8192 else 1)}
    if ffma:
        x = args[0]
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        fplan = ops.mlp_plan(M, d, ff, x.dtype, True, sms, path="ffma")
        r["ffma_plan"] = fplan._asdict()
        # at batched prefill's rows a call takes 0.2-0.4 s: fewer calls
        n = 24 if M < 1024 else 4
        r["ffma_ms"] = cuda_ms([lambda a=a: ops.linked_mlp(*a, plan=fplan)
                                for a in sets], iters=n, warmup=min(3, n))
        # the cluster sizes the planner weighed and did not choose
        r["other_clusters"] = {}
        sizes = ops.swap_clusters(M, d) if plan.body == "swap" else \
            ops.tc_clusters(d, ops.TP_DS if plan.body == "prefill"
                            else ops.TC_DS)
        for cl in sizes:
            if cl == r["plan"]["cl"]:
                continue
            alt = ops.mlp_plan(M, d, ff, x.dtype, True, sms, path="tc",
                               slots=ops.cluster_slots(x.device), cl=cl,
                               body=plan.body)
            r["other_clusters"][cl] = {
                "S": alt.S, "ms": cuda_ms([lambda a=a: ops.linked_mlp(
                    *a, plan=alt) for a in sets])}
    print(f"linked_mlp {label} ({M},{d})@({d},{ff}): {plan.body} body "
          f"{r['ms']:.4f} ms, bound {b_ms:.4f} ms ({b_by}), share "
          f"{r['share']:.3f}, plain {r['plain_ms']:.4f} ms, unlinked "
          f"{r['unlinked_ms']:.4f} ms"
          + (f", decode body forced {r['decode_body']['ms']:.4f} ms"
             if "decode_body" in r else "")
          + (f", FFMA kernel {r['ffma_ms']:.4f} ms (plan "
             f"{r['ffma_plan']}): tensor-core faster "
             f"{r['ms'] < r['ffma_ms']}, unlinked faster "
             f"{r['unlinked_ms'] < r['ms']}; the planned cluster of "
             f"{r['plan']['cl']} (S {r['plan']['S']}) beside the others "
             + ", ".join(f"{c} (S {o['S']}) {o['ms']:.4f} ms"
                         for c, o in r["other_clusters"].items())
             if ffma else ""))


def linked_mlp_case(torch, ops, gen, label, shape, row, timed, ffma=False,
                    sets=()):
    """Hold ``linked_mlp`` at ``shape`` (M, d, ff, dtype), twice (the same
    bits both times), and fold the error into ``row``: fp32 element-wise
    against its plain version; bf16 (kernel and plain version each)
    against the fp64-summed MLP with ``hold_bf16``'s limit, both planted
    faults failing it.  ``sets``: more input sets held the same way (each
    a tuple of the four tensors).  ``timed`` also times the shape
    (``ffma``: the FFMA kernel too)."""
    M, d, ff, dt = shape
    name = str(dt).split(".")[-1]
    args = mlp_inputs(torch, M, d, ff, dt, gen)
    plan = mlp_plan(torch, ops, args)
    print(f"linked_mlp {label}: plan {plan._asdict()}")
    for i, a in enumerate((args, *sets)):
        got = ops.linked_mlp(*a)
        if not torch.equal(got, ops.linked_mlp(*a)):
            fail(f"linked_mlp {label}: two launches gave different bits")
        plain = ops.linked_mlp_plain(*a)
        if name == "bfloat16":
            held = hold_bf16(torch, ops, f"{label} set {i} ({M},{d})@({d},"
                             f"{ff})", a, got, plain)
            row["worst_vs_fp64"] = max(row.get("worst_vs_fp64", 0.0),
                                       held["kernel"])
            err = (got.float() - plain.float()).abs().max().item()
            key = "max_abs_err"
        else:
            err = check_close(f"linked_mlp {label} {name} ({M},{d})@({d},"
                              f"{ff})", got, plain, name, MLP_TOL[name])
            key = "max_abs_err_fp32"
        row[key] = max(row.get(key, 0.0), err)
    if timed:
        time_mlp_case(torch, ops, gen, label, args, row, ffma)


def linked_mlp_batched(torch, ops, gen, row, M: int = SLOTS * PROMPT_LENS[1],
                       label: str = "batched_prefill", n_sets: int = 3,
                       d: int = D_MODEL, ff: int = D_FF, ffma=False):
    """Batched prefill's shape: the engine pads a group of ``SLOTS``
    admitted prompts to the longest, so M = SLOTS x PROMPT_LENS[1] (and
    phase 3g's one-shot prefill of one ``LONG_PROMPT``-token prompt, M =
    LONG_PROMPT, under ``label`` "long_prefill", one input set).  In
    bf16 at thousands of rows the kernel and the plain version (each a
    correct fp32 summation order, each rounding h to bf16) can land a few
    ulps apart, past the element-wise limit.  So each is held against the
    fp64-summed MLP instead: on ``n_sets`` input sets the kernel's worst
    error must stay within ``MLP_ORDER_FACTOR`` times the plain
    version's on the same inputs.  Two planted faults, launched through
    the kernel, must fail the same test: one up-projection term (the
    last of d) and one ff column (the last) left out.  Both are also
    held to ``hold_bf16``'s limit (the fp64 sum plus the h-rounding
    slack), its planted faults failing it.  ``d`` / ``ff``: the width
    (qwen3-1.7b's by default); ``ffma`` times the FFMA kernel too."""
    tol = MLP_TOL["bfloat16"]
    worst = {"kernel": 0.0, "plain": 0.0, "ratio": 0.0}
    for i in range(n_sets):
        args = mlp_inputs(torch, M, d, ff, torch.bfloat16, gen)
        plan = mlp_plan(torch, ops, args)
        if plan.path != "tc" or plan.body != "prefill":
            fail(f"linked_mlp {label}: planned {plan}, want the "
                 "tensor-core kernel's prefill body")
        got = ops.linked_mlp(*args)
        if not torch.equal(got, ops.linked_mlp(*args)):
            fail(f"linked_mlp {label}: two launches gave different bits")
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
        print(f"linked_mlp {label} set {i} ({M},{d})@({d},{ff}) bf16, "
              f"plan {plan._asdict()}, worst err / (atol + rtol |fp64|): "
              f"kernel {e_k:.3f}, plain {e_p:.3f} (kernel vs plain "
              f"{e_kp:.3f}); planted faults "
              + ", ".join(f"{k} {v:.3f}" for k, v in faults.items()))
        if not e_k <= MLP_ORDER_FACTOR * e_p:
            fail(f"linked_mlp {label} set {i}: kernel {e_k:.3f} > "
                 f"{MLP_ORDER_FACTOR} x plain {e_p:.3f} from the fp64 sum")
        for k, v in faults.items():
            if v <= MLP_ORDER_FACTOR * e_p:
                fail(f"linked_mlp {label} set {i}: the planted "
                     f"fault {k} ({v:.3f}) passes the test")
        held = hold_bf16(torch, ops, f"{label} set {i}", args, got, plain)
        worst = {"kernel": max(worst["kernel"], e_k),
                 "plain": max(worst["plain"], e_p),
                 "ratio": max(worst["ratio"], e_k / e_p),
                 "vs_limit": max(worst.get("vs_limit", 0.0),
                                 held["kernel"])}
        row["max_abs_err"] = max(row.get("max_abs_err", 0.0),
                                 (got.float() - plain.float()).abs().max()
                                 .item())
        del args, got, ref, plain, x_cut, wd_cut
    row["per_shape"][label] = {"vs_fp64": worst}
    time_mlp_case(torch, ops, gen, label,
                  mlp_inputs(torch, M, d, ff, torch.bfloat16, gen), row,
                  ffma)


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
    # ragged M in bf16 on more input sets (its own generator: the shared
    # one keeps drawing what it drew for every later check)
    rgen = new_gen(torch, MLP_RAGGED_SEED)
    extra = {"ragged_m_bf16": [
        mlp_inputs(torch, *cases["ragged_m_bf16"], rgen)
        for _ in range(MLP_RAGGED_SETS)]}
    for label, shape in {**cases, **others}.items():
        linked_mlp_case(torch, ops, gen, label, shape, row,
                        timed=label in served or label in others,
                        sets=extra.get(label, ()))
    for label, (M, d, ff, dt) in others.items():
        plan = row["per_shape"][label]["plan"]
        body = ops.tc_body(M, d)
        sizes = ops.swap_clusters(M, d) if body == "swap" else \
            [-(-d // (ops.TP_DS if body == "prefill" else ops.TC_DS))]
        if plan["path"] != "tc" or plan["cl"] not in sizes or \
                plan["body"] != body:
            fail(f"linked_mlp {label}: planned {plan}, want the tensor-core "
                 f"kernel's {body} body for {M} rows on a cluster of "
                 f"{sizes}")
    linked_mlp_batched(torch, ops, gen, row)
    linked_mlp_batched(torch, ops, gen, row, M=LONG_PROMPT,
                       label="long_prefill", n_sets=1)
    torch.cuda.empty_cache()
    head = row["per_shape"]["decode"]
    row.update({k: head[k] for k in ("ms", "plain_ms", "bound_ms",
                                     "bound_by", "unlinked_ms", "shape")})


#: phase 2: the swap body forced at these rows at every ragged width of
#: MLP_RAGGED_WIDE and d 8200 (one 64-column tile past 8192), where it
#: takes them (one cluster covering d: up to 64 rows at d 2056, 32 at
#: 4104 / 6152, 16 at 8200)
SWAP_ROWS_HELD = (1, 8, 13, 32, 37, 64)
SWAP_WIDTHS_HELD = ((2056, 6144), (4104, 13704), (6152, 16392),
                    (8200, 22016))


def check_swap_body(torch, ops, gen, row) -> None:
    """The tensor-core kernel's swap body past d 2048 at 1-64 rows
    (``SWAP_ROWS_HELD`` at ``SWAP_WIDTHS_HELD``), forced by its plan:
    within ``hold_bf16``'s limit with both planted faults, launched
    through the same plan, outside it; the same bits on two launches;
    and a CUDA-graph capture (tensor maps encoded at capture, the
    workspace from the graph's pool) replayed on new x written in place
    equal to an eager launch.  Records the cases under
    ``row["swap_held"]``."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    held = row["swap_held"] = {}
    for d, ff in SWAP_WIDTHS_HELD:
        args = mlp_inputs(torch, max(SWAP_ROWS_HELD), d, ff, torch.bfloat16,
                          gen)
        for M in SWAP_ROWS_HELD:
            if not ops.swap_clusters(M, d):
                held[f"{M}x{d}"] = "not taken"
                continue
            a = (args[0][:M].contiguous(), *args[1:])
            plan = ops.mlp_plan(M, d, ff, torch.bfloat16, True, sms,
                                path="tc", body="swap",
                                slots=ops.cluster_slots(a[0].device))
            got = ops.linked_mlp(*a, plan=plan)
            if not torch.equal(got, ops.linked_mlp(*a, plan=plan)):
                fail(f"linked_mlp swap ({M},{d}): two launches gave "
                     "different bits")
            out = hold_bf16(torch, ops, f"swap ({M},{d})@({d},{ff}) plan "
                            f"{tuple(plan)}", a, got,
                            ops.linked_mlp_plain(*a), plan=plan)
            x = a[0].clone()
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                ops.linked_mlp(x, *a[1:], plan=plan)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph):
                y = ops.linked_mlp(x, *a[1:], plan=plan)
            for _ in range(2):
                x.copy_(torch.randn(x.shape, generator=gen, device=DEV))
                graph.replay()
                if not torch.equal(y, ops.linked_mlp(x, *a[1:], plan=plan)):
                    fail(f"linked_mlp swap ({M},{d}): a graph replay "
                         "differs from an eager launch")
            del graph, y, x
            held[f"{M}x{d}"] = {"plan": plan._asdict(), **out}
            row["worst_vs_fp64"] = max(row.get("worst_vs_fp64", 0.0),
                                       out["kernel"])
        del args
        torch.cuda.empty_cache()
    taken = [k for k, v in held.items() if isinstance(v, dict)]
    print(f"linked_mlp swap body: {len(taken)} (rows, d) cases within the "
          f"fp64 limit, bit for bit on two launches and under graph "
          f"replay; not taken {sorted(set(held) - set(taken))}")


def check_linked_mlp_large(torch, ops, gen, get_config, report):
    """The tensor-core kernel past d 2048: the swap body at decode rows
    (one cluster over d), the prefill body from 65 rows (clusters split
    d, ``tc_columns``).  Each large decoder's SwiGLU (``LARGE_ARCHS``) at
    decode (slots rows) and a 32-token chunk of the slots, arctic-480b's
    dense residual at decode, batched prefill's rows at chatglm3-6b's
    and internlm2-20b's widths (held against the fp64-summed MLP, as at
    qwen3's), each timed beside the unlinked form, the FFMA kernel (the
    route of every bf16 width past 2048 before), the decode body forced
    (the design before the swap body), the plain version and the bound;
    the ragged ownership edges (``MLP_RAGGED_WIDE``) and the swap body at
    1-64 rows there (``check_swap_body``).  Every one must plan the
    tensor-core kernel, every decode shape its swap body; the rows go
    under ``per_shape``."""
    bf16 = torch.bfloat16
    row = report["linked_mlp"]
    widths = {arch.split("-")[0]: (get_config(arch).d_model,
                                   get_config(arch).d_ff)
              for arch in LARGE_ARCHS}
    arctic = get_config("arctic-480b")
    timed = {}
    for name, (d, ff) in widths.items():
        timed[f"{name}_decode"] = (SLOTS, d, ff, bf16)
        timed[f"{name}_prefill_c32"] = (SLOTS * 32, d, ff, bf16)
    timed["arctic_residual_decode"] = (SLOTS, arctic.d_model, arctic.d_ff,
                                       bf16)
    cases = {**timed, **{k: (M, d, ff, bf16)
                         for k, (M, d, ff) in MLP_RAGGED_WIDE.items()}}
    for label, shape in cases.items():
        linked_mlp_case(torch, ops, gen, label, shape, row,
                        timed=label in timed, ffma=True)
        plan = mlp_plan(torch, ops, mlp_inputs(torch, 1, shape[1], shape[2],
                                               bf16, gen))
        if plan.path != "tc":
            fail(f"linked_mlp {label}: planned {plan}, want the tensor-core "
                 "kernel")
        got = row["per_shape"].get(label, {}).get("plan", {}).get("body")
        if label in timed and label.endswith("_decode") and got != "swap":
            fail(f"linked_mlp {label}: planned the {got} body, want the "
                 "swap body")
        torch.cuda.empty_cache()
    for name in ("chatglm3", "internlm2"):
        d, ff = widths[name]
        linked_mlp_batched(torch, ops, gen, row, label=f"{name}_batched",
                           n_sets=1, d=d, ff=ff, ffma=True)
        torch.cuda.empty_cache()
    check_swap_body(torch, ops, gen, row)
    faster = {k: r["ms"] < r["ffma_ms"] for k, r in row["per_shape"].items()
              if "ffma_ms" in r}
    print(f"linked_mlp past d 2048: the tensor-core kernel faster than the "
          f"FFMA kernel at {sum(faster.values())} of {len(faster)} timed "
          f"shapes (slower at {[k for k, v in faster.items() if not v]})")
    row["large_faster_than_ffma"] = faster


def attention_fp64(torch, q, k, v, valid):
    """The masked softmax attention of ``gqa_decode_plain`` in fp64 on the
    same (bf16) inputs: the oracle the kernel's P.V form is measured
    against."""
    B, H, D = q.shape
    K = k.shape[2]
    qg = q.double().reshape(B, K, H // K, D)
    s = torch.einsum("bkgd,bwkd->bkgw", qg, k.double()) / D ** 0.5
    s = torch.where(valid[:, None, None, :], s, -1e30)
    out = torch.einsum("bkgw,bwkd->bkgd", torch.softmax(s, dim=-1),
                       v.double())
    return out.reshape(B, H, D)


def check_decode_groups(torch, ops, gen, bs, report):
    """Both decode kernels at every G the group body serves or may serve
    (``GROUP_GS``: 8 rows of 2048 slots, 2 kv heads of 128), fp32 (the
    heads body) and bf16 (the group body), dense and paged (block size
    ``bs``), element by element against the plain version, two calls the
    same bits; then, in bf16 at the served G (4, 5, 6, 8, 16) and at
    gemma3's one row over 32,768 slots, the kernel's and the plain
    version's worst distance to the fp64 oracle, the kernel's at most
    ``DECODE_ORDER_FACTOR`` times the plain version's (P.V carries P as
    two bf16 terms: ``pv_fp64`` in the row)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    lengths = [600, 512, 0, 2048, 1, 530, 777, 1500]
    kernels = (("gqa_decode", ops.gqa_decode, ops.gqa_decode_plain, None),
               ("gqa_decode_paged", ops.gqa_decode_paged,
                ops.gqa_decode_paged_plain, bs))
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        key = "max_abs_err" if name == "bfloat16" else "max_abs_err_fp32"
        for G in GROUP_GS:
            plan = ops.decode_grid(SLOTS, 2, G, MAX_LEN, sms, D, dtype)
            want = "group" if dtype == torch.bfloat16 else "heads"
            if plan.body != want:
                fail(f"decode plan at G {G} {name}: {tuple(plan)}, want "
                     f"the {want} body")
            for label, fn, plain, pbs in kernels:
                args = shard_decode_inputs(torch, dtype, (2 * G, 2), lengths,
                                           gen, pbs)
                got = fn(*args)
                err = check_close(f"{label} {name} G {G} (plan "
                                  f"{tuple(plan)})", got, plain(*args), name)
                same_bits(torch, f"{label} {name} G {G}", got, fn(*args))
                report[label][key] = max(report[label][key], err)
    pv = report["gqa_decode"]["pv_fp64"] = {}
    cases = [(f"G{G}", (2 * G, 2, D), MAX_LEN,
              [(0, n) for n in (560, 512, 600, 540, 580, 530, 590, 520)])
             for G in (4, 5, 6, 8, 16)]
    cases.append(("gemma3_w32768", (G3_H, G3_K, G3_D), LONG_MAX_LEN,
                  [(0, LONG_PROMPT + LONG_NEW // 2)]))
    for tag, heads, W, spans in cases:
        q, k, v, valid = g3_decode_case(torch, torch.bfloat16, W, spans, gen,
                                        heads)
        want = attention_fp64(torch, q, k, v, valid)
        got = (ops.gqa_decode(q, k, v, valid).double() - want).abs().max()
        ref = (ops.gqa_decode_plain(q, k, v, valid).double()
               - want).abs().max()
        pv[tag] = {"kernel": got.item(), "plain": ref.item()}
        print(f"gqa_decode {tag} bf16 vs fp64: kernel {got.item():.3e}, "
              f"plain {ref.item():.3e}")
        if not got <= DECODE_ORDER_FACTOR * ref:
            fail(f"gqa_decode {tag}: the kernel's distance to fp64 "
                 f"{got.item():.3e} is past {DECODE_ORDER_FACTOR} x the "
                 f"plain version's {ref.item():.3e}")
        del q, k, v, valid, want
    torch.cuda.empty_cache()


def check_decode_large(torch, ops, gen, bs, report):
    """Both decode kernels at the large decoders' head layouts
    (``LARGE_HEADS``, head_dim 128): chatglm3-6b's 32 q / 2 kv (G 16: in
    bf16 the group body, each K/V row read once), internlm2-20b's 48 / 8
    (G 6) and chameleon-34b's 64 / 8 (G 8); element by element against the
    plain version in fp32 and bf16, dense and paged (block size ``bs``),
    then timed over ~560 live of 2048 slots beside SDPA (``enable_gqa``)
    and the bound.  Rows go under each kernel's ``large``."""
    lengths = [600, 512, 0, 2048, 1, 530, 777, 1500]
    kernels = (("gqa_decode", ops.gqa_decode, ops.gqa_decode_plain, None),
               ("gqa_decode_paged", ops.gqa_decode_paged,
                ops.gqa_decode_paged_plain, bs))
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[-1]
        key = "max_abs_err" if name == "bfloat16" else "max_abs_err_fp32"
        for arch, heads in LARGE_HEADS.items():
            for label, fn, plain, pbs in kernels:
                args = shard_decode_inputs(torch, dtype, heads, lengths, gen,
                                           pbs)
                err = check_close(f"{label} {arch} {name} (G "
                                  f"{heads[0] // heads[1]}, D {D})",
                                  fn(*args), plain(*args), name)
                report[label][key] = max(report[label][key], err)
    ls = [560, 512, 600, 540, 580, 530, 590, 520]
    rows = sum(ls)
    for arch, (h, k) in LARGE_HEADS.items():
        for label, _, _, pbs in kernels:
            sets = [shard_decode_inputs(torch, torch.bfloat16, (h, k), ls,
                                        gen, pbs) for _ in range(ROTATE)]
            nbytes = 2 * rows * k * D * 2 + 2 * SLOTS * h * D * 2 \
                + (SLOTS * MAX_LEN if pbs is None
                   else sets[0][3].numel() * 4 + SLOTS * 4)
            r = report[label].setdefault("large", {})[arch] = time_decode_row(
                torch, ops, sets, nbytes, 4 * rows * h * D,
                paged=pbs is not None, shape=[SLOTS, h, k, D, MAX_LEN],
                plan=plan_of(torch, ops, SLOTS, k, h // k, MAX_LEN, D))
            print_share({"name": f"{label} {arch} ({h} q / {k} kv, G "
                         f"{h // k}) ~560 of {MAX_LEN} slots (plan "
                         f"{r['plan']})", **r})
            print(f"{label} {arch}: faster than SDPA "
                  f"{r['ms'] < r['library_ms']}")


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
    # the decode kernels' two bodies (heads: decode_kernel, group:
    # group_kernel)
    dec = [(us, n) for us, key, n in rows
           if "decode_kernel" in key or "group_kernel" in key]
    mlp = [(us, n) for us, key, n in rows if "linked_mlp" in key]
    return {"device_ms_per_tick": total / 1e3 / ticks if total else None,
            # both linked_mlp kernels and their split reduce
            "linked_mlp": {
                "ms_per_tick": sum(us for us, _ in mlp) / 1e3 / ticks,
                "calls_per_tick": sum(n for _, n in mlp) / ticks},
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


def check_launches(label, run, cfg, decode_tc, attn: dict,
                   replanned: bool = False) -> None:
    """Every prefill launch of ``linked_mlp`` goes through the tensor-core
    kernel's prefill body (``linked_mlp_tc_prefill``) and every decode
    one (each verify position too: the slots' rows) through the body the
    planner gives the slots' rows (``mlp_body_key``: the swap body,
    ``linked_mlp_tc_swap``, wherever it takes them; the FFMA kernel where
    the planner picks it for decode).  ``replanned``: the run may have
    adopted 8-token chunks (8 slots x 8 rows, under the prefill body's
    ``PREFILL_ROWS``), whose whole prefill calls (a launch a layer) take
    a 64-row body (swap or decode).  Each decode-attention kernel
    launches ``attn[kernel]`` times every decode step (K1 times that at a
    verify of width K1), and ``fused_mask`` once a sampler dispatch; a
    graphed run's launches are its replays' plus its graphs' warm-ups,
    each warm-up the launches of one replay.  A family with no SwiGLU on
    the linked site (mamba2, olmoe's experts) launches no ``linked_mlp``
    at all."""
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
        for k in ("linked_mlp", *MLP_BODY_KEY.values()):
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
    dkey = mlp_body_key(cfg) if decode_tc else None
    decode_mlp = swiglu_layers(cfg) * run["kernel_steps"] + warm.get(
        "linked_mlp", 0)
    prefill_mlp = ln["linked_mlp"] - decode_mlp
    want_tc = decode_mlp if decode_tc else 0
    small_keys = ("linked_mlp_tc", "linked_mlp_tc_swap")
    # prefill calls of 64 rows or fewer on a 64-row body (replanned runs)
    small = sum(ln.get(k, 0) for k in small_keys) - want_tc \
        if replanned and decode_tc else 0
    if small % swiglu_layers(cfg) or small < 0:
        fail(f"{label}: {small} 64-row-body launches past decode's are no "
             "whole prefill calls")
    prefill_mlp -= small
    print(f"{label}: linked_mlp {ln['linked_mlp']} launches: prefill "
          f"{prefill_mlp}, linked_mlp_tc_prefill "
          f"{ln.get('linked_mlp_tc_prefill', 0)}; decode and verify "
          f"{decode_mlp} on {dkey or 'ffma'}, linked_mlp_tc_swap "
          f"{ln.get('linked_mlp_tc_swap', 0)}, linked_mlp_tc "
          f"{ln.get('linked_mlp_tc', 0)} (warm-ups included); " + "; ".join(
              f"{k} {ln[k]} ({n} a step) over {run['kernel_steps']} "
              f"decode-kernel steps and warm-ups {warm.get(k, 0)}"
              for k, n in attn.items())
          + f"; fused_mask {ln['fused_mask']} over "
          f"{run['sampler_calls']} sampler dispatches and warm-ups "
          f"{warm.get('fused_mask', 0)}")
    if ln.get("linked_mlp_tc_prefill", 0) != prefill_mlp or \
            prefill_mlp <= 0:
        fail(f"{label}: linked_mlp_tc_prefill launched "
             f"{ln.get('linked_mlp_tc_prefill', 0)} times, want every "
             f"prefill launch ({prefill_mlp})")
    if sum(ln.get(k, 0) for k in small_keys) != want_tc + small or \
            (dkey and ln.get(dkey, 0) < want_tc) or \
            (not small and any(ln.get(k, 0) for k in small_keys
                               if k != dkey)):
        fail(f"{label}: linked_mlp_tc_swap / linked_mlp_tc launched "
             f"{ln.get('linked_mlp_tc_swap', 0)} / "
             f"{ln.get('linked_mlp_tc', 0)} times, want every decode and "
             f"verify launch ({want_tc}) on {dkey}"
             + (f" and {small} of short prefill chunks" if small else ""))
    for name in [k for k, n in attn.items() if n] + [
            "fused_mask", "linked_mlp", "linked_mlp_tc_prefill"] + (
                [dkey] if decode_tc else []):
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
                   decode_kernels(model, "dense"), replanned=True)
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
    ``linked_mlp_tc_swap`` once a layer and ``fused_mask`` once; a mamba2
    one
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
                        mlp_body_key(cfg) if n else "linked_mlp_tc_swap": n,
                        "fused_mask": 1}
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
# phase 3h: the reference's large dense decoders at full width
# ---------------------------------------------------------------------------

def tree_bytes(params) -> tuple[int, int]:
    """A param tree's bytes and its largest leaf's elements."""
    from repro_torch.models.layers import tree_leaves
    leaves = tree_leaves(params)
    return (sum(t.numel() * t.element_size() for t in leaves),
            max(t.numel() for t in leaves))


def large_run(torch, kernels, serve, model, params, label, args, seed):
    """One phase 3h run: graphed, then its eager twin on the same
    requests (each engine freed before the next is built), streams equal
    bit for bit.  Every ``linked_mlp`` launch is a tensor-core one: prefill
    on its prefill body, decode on its swap body (``check_launches``);
    a decode replay launches ``linked_mlp_tc_swap`` and the KV layout's
    decode-attention kernel once a layer and ``fused_mask`` once."""
    cfg = model.cfg
    attn = decode_kernels(model, args.kv)
    runs = {}
    for graphed in (True, False):
        name = label if graphed else f"{label}_eager"
        engine = serve.build_engine(args, model, params, graphed=graphed)
        runs[name] = serve_phase(torch, kernels, serve, engine, args, name,
                                 seed, window=LARGE_WINDOW)
        runs[name]["kv_bytes"] = kv_bytes(engine)
        del engine
        ln = runs[name]["launches"]
        check_launches(name, runs[name], cfg, True, attn)
        tc = sum(ln[k] for k in MLP_BODY_KEY.values())
        if ln["linked_mlp"] != tc:
            fail(f"{name}: {ln['linked_mlp'] - tc} linked_mlp launches "
                 "went to the FFMA kernel")
        if graphed:
            want = {**attn, mlp_body_key(cfg): cfg.n_layers,
                    "fused_mask": 1}
            got = runs[name]["graphs"]["serve_sample"]["launches"]
            if {k: got.get(k, 0) for k in want} != want:
                fail(f"{name}: a decode replay launches {got}, want {want}")
    same_streams(f"{label} graphed vs eager", runs[label],
                 runs[f"{label}_eager"])
    return runs


def large_dense_phase(torch, kernels, serve, Model, get_config,
                      card: str) -> dict:
    """Phase 3h: chatglm3-6b, granite-8b and internlm2-20b at full
    width and depth, chameleon-34b at full width and ``LARGE_DEPTH``
    layers; random weights from seed 0 drawn leaf by leaf into bf16
    through ``launch/serve.py``'s ``init_params`` (the init's peak, held
    to the bf16 tree + the largest leaf's fp32 draw + 1 GB, printed
    beside both), 8 slots over 2048, dense KV, chunk 32, ``LARGE_NEW``
    new tokens.  chatglm3-6b: 16 greedy requests of 480-544-token
    prompts (two waves: the second admitted into slots the first freed),
    then 8 paged and sampled (T 0.8, top-k 50, top-p 0.95); the others 8
    greedy.  Each run graphed beside its eager twin (:func:`large_run`).
    Prints each model's steady step, device ms a tick, busy share,
    weights and KV bytes, and the MLP's device ms a tick beside the
    bytes bound of its weights.  Each model, its engines and graphs are
    freed before the next is built."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    print(f"phase 3h starts with {torch.cuda.memory_allocated() / 1e9:.2f} "
          f"GB allocated, {torch.cuda.memory_reserved() / 1e9:.2f} GB "
          f"reserved ({card})")
    sampled = dict(temperature=0.8, top_k=50, top_p=0.95)
    out, models = {}, {}
    for i, arch in enumerate(LARGE_ARCHS):
        cfg = get_config(arch)
        full = cfg.n_layers
        cfg = dataclasses.replace(cfg, n_layers=LARGE_DEPTH.get(arch, full))
        model = Model(cfg, device=DEV)
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        params = serve.init_params(model, 0)
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated() - held
        nbytes, largest = tree_bytes(params)
        limit = nbytes + 4 * largest + 1e9
        cut = f"{cfg.n_layers} of {full} layers" if cfg.n_layers != full \
            else f"{full} layers"
        print(f"{arch} full width ({cut}, d {cfg.d_model}, "
              f"{cfg.n_heads} q / {cfg.n_kv_heads} kv heads of "
              f"{cfg.resolved_head_dim}, ff {cfg.d_ff}, rope_fraction "
              f"{cfg.rope_fraction}, qk_norm {cfg.qk_norm}, vocab "
              f"{cfg.vocab}): {model.param_count() / 1e9:.3f} B params "
              f"drawn leaf by leaf into {cfg.dtype} in {init_s:.1f} s; "
              f"weights {nbytes / 1e9:.2f} GB, largest leaf's fp32 draw "
              f"{4 * largest / 1e9:.2f} GB, init peak "
              f"(max_memory_allocated less the {held / 1e9:.2f} GB held) "
              f"{peak / 1e9:.2f} GB against {limit / 1e9:.2f} GB ({card})")
        if peak > limit:
            fail(f"{arch}: the init's peak {peak / 1e9:.2f} GB exceeds the "
                 f"bf16 tree + one fp32 leaf + 1 GB ({limit / 1e9:.2f})")
        short = arch.split("-")[0]
        plan = [(f"{short}_greedy", dict(kv="dense",
                                         requests=16 if i == 0 else SLOTS))]
        if i == 0:
            plan.append((f"{short}_paged_sampled",
                         dict(kv="paged", requests=SLOTS, **sampled)))
        info = {"layers": cfg.n_layers, "full_layers": full,
                "weights_bytes": nbytes, "init_peak_bytes": peak,
                "init_limit_bytes": limit, "init_s": init_s}
        mlp_bound = bound_ms(2 * 3 * cfg.d_model * cfg.d_ff * cfg.n_layers,
                             0, "bfloat16")[0]
        for j, (label, over) in enumerate(plan):
            args = serve_args(serve, max_new=LARGE_NEW, **over)
            runs = large_run(torch, kernels, serve, model, params,
                             f"large_{label}", args, 60 + 2 * i + j)
            g = runs[f"large_{label}"]
            e = runs[f"large_{label}_eager"]
            prof = g["profile"] or {}
            mlp = prof.get("linked_mlp", {})
            kvb = g["kv_bytes"]
            print(f"{label}: steady decode step graphed "
                  f"{g['mean_decode_ms']:.2f} ms, eager "
                  f"{e['mean_decode_ms']:.2f}; device "
                  f"{prof.get('device_ms_per_tick')} ms a tick, busy "
                  f"{g['busy_share']} (eager {e['busy_share']}); weights "
                  f"{nbytes / 1e9:.2f} GB, KV "
                  + ", ".join(f"{k} {v / 1e9:.3f} GB" for k, v in kvb.items())
                  + f"; linked_mlp {mlp.get('ms_per_tick')} ms a tick "
                  f"({mlp.get('calls_per_tick')} calls) beside its weights' "
                  f"bytes bound {mlp_bound:.3f} ms; wall {g['wall_s']:.1f} / "
                  f"{e['wall_s']:.1f} s ({card})")
            info[label] = {"mlp_bound_ms": mlp_bound,
                           "mlp_ms_per_tick": mlp.get("ms_per_tick")}
            out.update(runs)
        models[arch] = info
        del params, model
        gc.collect()
        torch.cuda.empty_cache()
    print(f"phase 3h in {time.perf_counter() - t0:.1f} s; "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB still allocated")
    return {"runs": out, "models": models}


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
    the same requests.  The ranks' decode kernels take one device's plan
    (``ops.rank_plan``), so the probe's logits must equal the
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
                    or any(ln[k] for k in ("linked_mlp",
                                           *MLP_BODY_KEY.values())):
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
                        "linked_mlp_tc": 0, "linked_mlp_tc_swap": 0}
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
    decode replay launches ``linked_mlp_tc_swap`` once a layer (the dense
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
    want = {"gqa_decode": cfg.n_layers, mlp_body_key(cfg): cfg.n_layers}
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


# ---------------------------------------------------------------------------
# phase 3g: long context
# ---------------------------------------------------------------------------

def long_prompt(vocab: int):
    """Phase 3g's prompt: ``LONG_PROMPT`` tokens from ``LONG_SEED``,
    drawn as :func:`ragged_prompts` draws a request's (the engines' runs
    draw it the same way)."""
    import types
    r = types.SimpleNamespace()
    ragged_prompts([r], vocab, LONG_SEED, (LONG_PROMPT, LONG_PROMPT))
    return r.prompt


def logits_close(label: str, got, want) -> float:
    """Logits of two correct bf16 paths: fail unless max |got - want| <=
    rtol * max(1, max |want|) (the bf16 rtol at the scale phase 4's
    margin rule takes); return the max abs difference."""
    got, want = got.float(), want.float()
    err = (got - want).abs().max().item()
    tol = TOL["bfloat16"]["rtol"] * max(1.0, want.abs().max().item())
    print(f"{label}: max_abs_diff {err:.4e} (tol {tol:.4e}, argmax "
          f"{int(got.argmax())} / {int(want.argmax())})")
    if not err <= tol:
        fail(f"{label}: the logits differ past the bf16 tolerance")
    return err


def cache_bytes(caches) -> int:
    from torch.utils._pytree import tree_leaves
    import torch
    return sum(t.numel() * t.element_size() for t in tree_leaves(caches)
               if isinstance(t, torch.Tensor))


def long_context_run(torch, kernels, serve, Model, cfg, twin_kv: str,
                     exact: str, card: str) -> dict:
    """Phase 3g for one model at full width (bf16, seed 0): one request of
    the ``LONG_PROMPT``-token prompt and ``LONG_NEW`` new tokens, one
    slot, a ``LONG_MAX_LEN`` horizon.

    (i) ``prefill_mode="batched"``, dense KV, graphed: one one-shot
    ``prefill_step`` (``chunked_attention`` on every attention layer),
    then decode steps over the 32,768-slot caches; (ii) the same request
    under ``prefill_mode="chunked"`` at ``LONG_CHUNK`` with ``twin_kv``
    KV, graphed.  (i)'s one ``prefill_step`` call is measured inside the
    engine (so its 'admit' stage holds the measuring): wall ms and
    device ms (the profiler's kernel time), ``max_memory_allocated``
    beside the bytes held before it and its fresh caches, the kernels it
    launched, the scan's calls (a spy: every attention layer, blocks
    dividing S and T), and a copy of its logits and caches.  From that
    copy, at the model level under (i)'s kernel plan: the first decode
    step's logits and the eager decode step (``model.serve_step`` at B
    1, synchronized).  Then an exact path teacher-forced along (i)'s
    stream (``exact``: "chunked", the prompt in ``LONG_CHUNK`` chunks,
    exact where every layer is full attention; "full", one one-shot
    prefill with ``use_chunked=False``): its prefill logits and first decode
    step's logits against the scan's within the bf16 tolerance, and
    phase 4's rule at every step: (i)'s token is the exact path's top-1
    or that top-1 / top-2 margin is under the bf16 tolerance.  (i) ≡ (ii)
    by the same rule up to the first parting, gated where the twin is
    exact (``exact`` "chunked"), reported otherwise (a sliding layer's
    chunks are lossy)."""
    gate_twin = exact == "chunked"
    import numpy as np
    from torch.utils._pytree import tree_map
    from repro_torch.models import attention as A
    from repro_torch.models.layers import tree_leaves
    model = Model(cfg, device=DEV)
    t0 = time.perf_counter()
    params = model.cast_params(model.init(
        torch.Generator(device=DEV).manual_seed(0)))
    torch.cuda.synchronize()
    weights = sum(t.numel() * t.element_size() for t in tree_leaves(params))
    label = cfg.name
    n_attn = sum(f.kv != "none" for f in model.families)
    print(f"{label} full width for phase 3g ({cfg.n_layers} layers, "
          f"{cfg.n_heads} q / {cfg.n_kv_heads} kv heads of "
          f"{cfg.resolved_head_dim}, window {cfg.sliding_window} "
          f"{cfg.layer_pattern or ''}): {weights / 1e9:.2f} GB of weights "
          f"in {time.perf_counter() - t0:.1f} s; prompt {LONG_PROMPT}, "
          f"{LONG_NEW} new, horizon {LONG_MAX_LEN}")
    prompt = long_prompt(cfg.vocab)
    base = dict(requests=1, prompt_len=LONG_PROMPT, max_new=LONG_NEW,
                slots=1, max_len=LONG_MAX_LEN, chunk=LONG_CHUNK)
    out = {}

    # (i) the one-shot prefill through the engine, its one prefill_step
    # call measured where it runs: wall and device ms, the peak, the
    # kernels it launched, the scan's calls (a spy), and its logits and a
    # copy of its caches for the model-level decode below
    args = serve_args(serve, **base, prefill_mode="batched", kv="dense")
    engine = serve.build_engine(args, model, params)
    plan = engine.kernel_plan
    if plan.decode_dense != "cuda":
        fail(f"{label} phase 3g: the engine's plan {plan}")
    scans, seen = [], []
    real_scan, real_prefill = A.chunked_attention, model.prefill_step

    def spy(q, k, v, **kw):
        scans.append(q.shape[1] % kw.get("q_chunk", 512) == 0
                     and k.shape[1] % kw.get("kv_chunk", 1024) == 0)
        return real_scan(q, k, v, **kw)

    def measured_prefill(p, batch, **kw):
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = dict(kernels.LAUNCHES)
        A.chunked_attention = spy
        try:
            with torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                logits, fresh = real_prefill(p, batch, **kw)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
        finally:
            A.chunked_attention = real_scan
        seen.append({
            "tokens": tuple(batch["tokens"].shape), "wall_ms": wall_ms,
            "peak": torch.cuda.max_memory_allocated(), "held": held,
            "launches": {k: n - before.get(k, 0)
                         for k, n in kernels.LAUNCHES.items()},
            "profiled": profile_window(torch, prof, 1),
            "cache_bytes": cache_bytes(fresh),
            "logits": logits[0, :cfg.vocab].clone(),
            "caches": tree_map(torch.clone, fresh)})
        return logits, fresh
    model.prefill_step = measured_prefill
    try:
        run_i = serve_phase(torch, kernels, serve, engine, args,
                            f"{label} long batched", LONG_SEED, window=None,
                            lens=(LONG_PROMPT, LONG_PROMPT))
    finally:
        del model.prefill_step
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    if len(seen) != 1 or seen[0]["tokens"] != (1, LONG_PROMPT):
        fail(f"{label} long batched: prefill_step calls "
             f"{[m['tokens'] for m in seen]}, want one of (1, "
             f"{LONG_PROMPT})")
    pre = seen.pop()
    if len(scans) != n_attn or not all(scans):
        fail(f"{label}: the one-shot prefill's attention calls {scans}, "
             f"want the scan on all {n_attn} attention layers")
    stream = run_i["streams"][0]
    got = run_i["launches"].get("gqa_decode", 0)
    print(f"{label} long batched: gqa_decode launches {got} ({n_attn} a "
          f"decode step, {run_i['kernel_steps']} steps, warm-ups and "
          f"captures)")
    if got < n_attn * (LONG_NEW - 1):
        fail(f"{label} long batched: gqa_decode launched {got} times, "
             f"want at least {n_attn * (LONG_NEW - 1)}")
    out["batched"] = run_i

    # the first decode step and eager decode steps at the model level,
    # from the copy of the one-shot prefill's caches
    logits1, caches = pre.pop("logits"), pre.pop("caches")
    tok = torch.tensor([[stream[0]]], device=DEV)
    if int(logits1.argmax()) != stream[0]:
        fail(f"{label} long batched: the first token {stream[0]} is not "
             f"the prefill logits' argmax {int(logits1.argmax())}")
    with torch.no_grad():
        first1, caches = model.serve_step(params, caches, tok, plan=plan)
        first1 = first1[0, :cfg.vocab].clone()
        t, eager = first1.argmax()[None, None].to(torch.int64), []
        for _ in range(LONG_EAGER_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            lg, caches = model.serve_step(params, caches, t, plan=plan)
            torch.cuda.synchronize()
            eager.append((time.perf_counter() - t0) * 1e3)
            t = lg[:, :cfg.vocab].argmax(-1)[:, None]
    del caches, lg
    torch.cuda.empty_cache()
    wall_ms, peak, before = pre["wall_ms"], pre["peak"], pre["held"]
    dev_ms = pre["profiled"]["device_ms_per_tick"]
    kv = pre["cache_bytes"]
    out["prefill"] = {
        "wall_ms": wall_ms, "device_ms": dev_ms, "peak_bytes": peak,
        "held_before_bytes": before, "own_peak_bytes": peak - before,
        "weight_bytes": weights, "cache_bytes": kv, "scans": len(scans),
        "launches": pre["launches"],
        "top_kernels": pre["profiled"]["top_kernels"],
        "eager_decode_ms": eager,
        "graphed_decode_ms": run_i["mean_decode_ms"]}
    print(f"{label} one-shot prefill of {LONG_PROMPT} tokens in the engine "
          f"({card}): wall {wall_ms:.1f} ms, device "
          f"{'not measured' if dev_ms is None else f'{dev_ms:.1f} ms'}; "
          f"chunked_attention scanned on {len(scans)} of {n_attn} "
          f"attention layers; max_memory_allocated {peak / 1e9:.2f} GB, "
          f"{before / 1e9:.2f} GB held before it (weights "
          f"{weights / 1e9:.2f} GB, the engine's caches and graphs), the "
          f"prefill's own {(peak - before) / 1e9:.2f} GB beside its fresh "
          f"caches {kv / 1e9:.2f} GB; kernel launches {pre['launches']}")
    for k in pre["profiled"]["top_kernels"][:5]:
        print(f"    {k['ms_per_tick']:.2f} ms {k['calls_per_tick']:.0f} "
              f"calls  {k['name']}")
    print(f"{label} decode step over {LONG_MAX_LEN} slots ({card}): graphed "
          f"{run_i['mean_decode_ms']:.2f} ms (engine, steady); eager "
          f"{sum(eager) / len(eager):.2f} ms (model.serve_step, mean of "
          f"{len(eager)}: {[round(x, 2) for x in eager]})")

    # (ii) the chunked twin through the engine
    args = serve_args(serve, **base, prefill_mode="chunked", kv=twin_kv)
    engine = serve.build_engine(args, model, params)
    out["chunked"] = run_ii = serve_phase(
        torch, kernels, serve, engine, args, f"{label} long chunked "
        f"{twin_kv}", LONG_SEED, window=None,
        lens=(LONG_PROMPT, LONG_PROMPT))
    del engine
    gc.collect()
    torch.cuda.empty_cache()
    n_global = sum(f.kv == "full" for f in model.families)
    paged = run_ii["launches"].get("gqa_decode_paged", 0)
    if twin_kv == "paged" and paged < n_global * (LONG_NEW - 1):
        fail(f"{label} long chunked paged: gqa_decode_paged launched "
             f"{paged} times, want at least {n_global * (LONG_NEW - 1)}")

    # the exact path at the model level, teacher-forced along (i): the
    # prompt in LONG_CHUNK chunks (a full-attention layer's cache holds
    # every position: exact), or, where a sliding layer's window-wide
    # ring makes chunks lossy (the reference's chunked prefill writes a
    # chunk before it attends: ROADMAP queue 3), one one-shot prefill
    # through full_attention
    toks = torch.from_numpy(prompt[None].astype(np.int64)).to(DEV)
    with torch.no_grad():
        if exact == "chunked":
            caches = model.init_caches(1, LONG_MAX_LEN)
            for start in range(0, LONG_PROMPT, LONG_CHUNK):
                logits2, caches = model.prefill_chunk(
                    params, caches, toks[:, start:start + LONG_CHUNK],
                    torch.tensor([start], dtype=torch.int32),
                    torch.tensor([LONG_CHUNK], dtype=torch.int32),
                    plan=plan)
        else:
            logits2, caches = model.prefill_step(
                params, {"tokens": toks}, max_len=LONG_MAX_LEN, plan=plan,
                use_chunked=False)
        plain = [logits2[0, :cfg.vocab].float()]
        for t in stream[:-1]:
            lg, caches = model.serve_step(
                params, caches, torch.tensor([[t]], device=DEV), plan=plan)
            plain.append(lg[0, :cfg.vocab].float())
    del caches, logits2, lg
    torch.cuda.empty_cache()
    what = {"chunked": f"chunked prefill ({LONG_CHUNK})",
            "full": "one-shot full_attention prefill"}[exact]
    out["exact_path"] = what
    out["prefill_logits_diff"] = logits_close(
        f"{label} prefill logits, one-shot scan vs {what}",
        logits1, plain[0])
    out["first_decode_logits_diff"] = logits_close(
        f"{label} first decode step's logits, one-shot scan vs {what}",
        first1, plain[1])

    def held(x, j):
        """Phase 4's rule at step j: ``x`` is the exact path's top-1, or
        its top-1 / top-2 margin is under the bf16 tolerance."""
        top = torch.topk(plain[j], 2)
        margin = (top.values[0] - top.values[1]).item()
        tol = TOL["bfloat16"]["rtol"] * max(1.0, abs(top.values[0].item()))
        return int(top.indices[0]) == x or margin <= tol, margin, tol
    low = []
    for j, x in enumerate(stream):
        ok, margin, tol = held(x, j)
        if not ok:
            fail(f"{label} long: (i)'s token {x} at step {j} is not the "
                 f"{what}'s top-1 {int(plain[j].argmax())} at margin "
                 f"{margin:.4f} > tol {tol:.4f}")
        if int(plain[j].argmax()) != x:
            low.append((j, round(margin, 4)))
    compared, parted = 0, None
    for j, (x, y) in enumerate(zip(stream, run_ii["streams"][0])):
        if x != y:
            _, margin, tol = held(x, j)
            parted = (j, margin, tol)
            if gate_twin and margin > tol:
                fail(f"{label} long: the batched and chunked streams differ "
                     f"at step {j} where the plain margin {margin:.4f} > "
                     f"tol {tol:.4f}")
            break
        compared += 1
    out["streams"] = {"compared": compared, "parted": parted,
                      "off_top1_low_margin": low}
    print(f"{label} long: (i)'s {len(stream)} tokens the {what}'s top-1 "
          "at every step"
          + (f" but {low} (step, margin: under the bf16 tolerance)" if low
             else "") + f"; (i) ≡ (ii) over {compared} of {LONG_NEW} tokens, "
          + ("equal streams" if parted is None else
             f"parted at step {parted[0]}, plain margin {parted[1]:.4f} "
             f"(bf16 tolerance {parted[2]:.4f})")
          + ("" if gate_twin else "; not gated: the twin's chunks into "
             "the sliding layers' window-wide rings are lossy"))
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def long_context_phase(torch, kernels, serve, Model, get_config,
                       card: str) -> dict:
    """Phase 3g: qwen3-1.7b (a dense twin, held against its chunked
    prefill) and gemma3-1b (its sliding layers on the banded scan; the
    mixed pool's twin; held against a one-shot ``full_attention``
    prefill, which fits at its 4 q heads) at a 31,744-token prompt
    (:func:`long_context_run`)."""
    t0 = time.perf_counter()
    out = {}
    for arch, twin, exact in (("qwen3-1.7b", "dense", "chunked"),
                              ("gemma3-1b", "paged", "full")):
        out[arch] = long_context_run(torch, kernels, serve, Model,
                                     get_config(arch), twin, exact, card)
    print(f"phase 3g in {time.perf_counter() - t0:.1f} s")
    return out


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


# ---------------------------------------------------------------------------
# phase 6: training
# ---------------------------------------------------------------------------

#: the parity steps' lr (step 0 is warmup's zero), as tests/test_torch_train
TRAIN_SCHED = dict(peak_lr=1e-3, warmup_steps=1, total_steps=10)
#: full-width qwen3-1.7b training: batch x seq, steps, the steady steps
#: the median is over, the cosine's peak and warmup
FULL_BATCH, FULL_SEQ, FULL_STEPS, FULL_STEADY = 8, 512, 20, (2, 20)
FULL_LR, FULL_WARMUP = 3e-4, 5


def hundred_m_config(get_config):
    """``examples/train_lm.py``'s ~100M-parameter qwen3-family config."""
    return dataclasses.replace(
        get_config("qwen3-1.7b"), name="qwen3-100m", n_layers=8,
        d_model=512, n_heads=8, n_kv_heads=4, head_dim=64, d_ff=1536,
        vocab=8192, dtype="float32", param_dtype="float32")


def train_batch(cfg, seed: int, batch: int = 4, seq: int = 16) -> dict:
    import numpy as np
    toks = np.random.default_rng(seed).integers(0, cfg.vocab,
                                                (batch, seq + 1))
    return {"tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32)}


def close_params(want, got, lr_sum: float) -> tuple[float, int]:
    """The CPU parity tests' rule for params after AdamW steps: every
    element within half the summed lr, all but 0.1% within 1e-3 of it
    (plus rtol 1e-5 both).  Returns (worst error / summed lr, elements
    past 1e-3 of it)."""
    off = total = 0
    worst = 0.0
    for a, b in zip(want, got):
        a, b = a.detach().float().cpu(), b.detach().float().cpu()
        err = (a - b).abs() - 1e-5 * a.abs()
        worst = max(worst, err.max().item() / lr_sum)
        off += int((err > 1e-3 * lr_sum).sum())
        total += err.numel()
    if not (worst <= 0.5 and off <= 1e-3 * total):
        fail(f"params parted: worst {worst:.4f} of the summed lr, {off} of "
             f"{total} elements past 1e-3 of it")
    return worst, off


def card_vs_cpu(torch, kernels, Model, plan, cfg, label: str) -> dict:
    """Phase 6 (a): three ``train_step``s of reduced ``cfg`` from one state
    (drawn on the CPU, attention at one layer's fan-in) on the card under
    the ``cuda`` kernel plan and on the CPU: losses at rtol 1e-4, params
    by :func:`close_params`, no kernel launched."""
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.models.model import TrainState
    from repro_torch.optim import adamw_init, cosine_schedule
    cpu = Model(cfg, device="cpu")
    card = Model(cfg, device=DEV, kernel_plan=plan)
    raw = cpu.init(torch.Generator().manual_seed(0))
    layer_fan_in(raw, cfg)
    states = {}
    for name, m in (("cpu", cpu), ("cuda", card)):
        params = tree_map(lambda t, d=m.device: t.detach().clone().to(d)
                          .requires_grad_(True), raw)
        states[name] = TrainState(params, adamw_init(params, m.opt_cfg),
                                  torch.zeros((), dtype=torch.int32,
                                              device=m.device))
    sched = lambda s: cosine_schedule(s, **TRAIN_SCHED)
    before = dict(kernels.LAUNCHES)
    losses = {"cpu": [], "cuda": []}
    for i in range(3):
        batch = train_batch(cfg, seed=i)
        for name, m in (("cpu", cpu), ("cuda", card)):
            states[name], met = m.train_step(states[name], batch,
                                             lr_schedule=sched)
            losses[name].append(float(met["loss"]))
    torch.cuda.synchronize()
    if kernels.LAUNCHES != before:
        fail(f"training {label} launched kernels: {kernels.LAUNCHES} "
             f"(before {before})")
    rel = max(abs(a - b) / abs(a) for a, b in zip(losses["cpu"],
                                                  losses["cuda"]))
    if not rel <= 1e-4:
        fail(f"training {label}: card losses {losses['cuda']} vs cpu "
             f"{losses['cpu']}")
    lr_sum = sum(float(sched(i)) for i in range(3))
    worst, off = close_params(tree_leaves(states["cpu"].params),
                              tree_leaves(states["cuda"].params), lr_sum)
    print(f"train {label} card vs cpu (3 steps, {cfg.dtype}, TF32 off, "
          f"plan linked_matmul={plan.linked_matmul}): losses card "
          f"{losses['cuda']} cpu {losses['cpu']}, max rel {rel:.2e}; params "
          f"worst {worst:.4f} of the summed lr, {off} elements past 1e-3 "
          "of it; no kernel launched")
    return {"losses": losses, "loss_rel": rel, "param_worst": worst,
            "param_off": off}


def converge(torch, Model, cfg, label: str, steps: int, seed: int,
             batch: int, seq: int, peak_lr: float, warmup: int, window: int,
             margin: float, **opt) -> dict:
    """Phase 6 (b): ``steps`` steps on ``SyntheticLM(vocab, seq, seed)``
    from the port's seed-0 init; the mean of the last ``window`` losses
    must lie ``margin`` below that of the first ``window``."""
    import numpy as np

    from repro_torch.data import SyntheticLM, make_train_iterator
    from repro_torch.optim import AdamWConfig, cosine_schedule
    m = Model(cfg, device=DEV, opt_cfg=AdamWConfig(**opt) if opt else None)
    state = m.init_train_state(torch.Generator(device=DEV).manual_seed(0))
    it = make_train_iterator(SyntheticLM(cfg.vocab, seq, seed=seed), batch)
    sched = lambda s: cosine_schedule(s, peak_lr=peak_lr,
                                      warmup_steps=warmup, total_steps=steps)
    losses = []
    t0 = time.perf_counter()
    for _ in range(steps):
        state, met = m.train_step(state, next(it), lr_schedule=sched)
        losses.append(met["loss"])
    losses = [float(x) for x in losses]
    wall = time.perf_counter() - t0
    first, last = np.mean(losses[:window]), np.mean(losses[-window:])
    print(f"train {label}: {steps} steps of {batch} x {seq} in {wall:.1f} s "
          f"({m.param_count():,} params); loss mean first {window} "
          f"{first:.4f} -> last {window} {last:.4f} (must drop by "
          f"{margin})")
    if not (np.isfinite(losses).all() and last < first - margin):
        fail(f"training {label} did not converge: {losses[::max(1, steps // 8)]}")
    return {"first": first, "last": last, "wall_s": wall,
            "losses": losses}


def step_flops(cfg, n_params: int, tokens: int, seq: int) -> tuple[float,
                                                                     float]:
    """(model FLOPs of one training step: 6 N a token plus attention's
    12 L H hd S a token, executed FLOPs: those plus remat's second
    forward of the layers, 2 N_layers a token plus attention's 4 L H hd S)."""
    attn = 12 * cfg.n_layers * cfg.n_heads * cfg.resolved_head_dim * seq
    model = (6 * n_params + attn) * tokens
    layer_params = n_params - cfg.padded_vocab() * cfg.d_model - cfg.d_model
    remat = (2 * layer_params + attn / 3) * tokens if cfg.remat else 0
    return model, model + remat


def split_step(torch, m, state, batch, sched):
    """One train step in its three parts, each between CUDA events: the
    forward (``loss_fn``), the backward (``torch.autograd.grad``) and the
    optimizer (``adamw_update``).  Returns (state, ms of each)."""
    from repro_torch.models.layers import tree_leaves, tree_unflatten
    from repro_torch.models.model import TrainState
    from repro_torch.optim import adamw_update
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    batch = {k: torch.as_tensor(v).to(DEV) for k, v in batch.items()}
    torch.cuda.synchronize()
    ev[0].record()
    loss, _ = m.loss_fn(state.params, batch)
    ev[1].record()
    grads = torch.autograd.grad(loss, tree_leaves(state.params))
    ev[2].record()
    params, opt, _ = adamw_update(state.params, tree_unflatten(
        state.params, grads), state.opt, m.opt_cfg, sched(state.step))
    ev[3].record()
    torch.cuda.synchronize()
    return TrainState(params, opt, state.step + 1), \
        [ev[i].elapsed_time(ev[i + 1]) for i in range(3)]


def moment_bytes(opt) -> int:
    from repro_torch.models.layers import tree_leaves
    total = 0
    for leaf in tree_leaves(opt.m) + tree_leaves(opt.v):
        for t in ((leaf.q, leaf.scale) if hasattr(leaf, "q") else (leaf,)):
            total += t.numel() * t.element_size()
    return total


def full_width_training(torch, kernels, Model, cfg, card: str) -> dict:
    """Phase 6 (c): qwen3-1.7b at full width (bf16 compute, fp32 params
    and moments, remat on), ``FULL_STEPS`` steps of FULL_BATCH x FULL_SEQ
    tokens of ``SyntheticLM(vocab, FULL_SEQ, seed=0)`` under a cosine lr
    (peak FULL_LR, warmup FULL_WARMUP): every loss and grad norm finite.
    Prints the median step over the steady steps (synchronized), tokens/s,
    MFU, peak memory, two profiled steps' busy share and top device ops,
    then three steps split by CUDA events into forward / backward /
    optimizer; then three steps with int8 moments."""
    import numpy as np

    from repro_torch.data import SyntheticLM, make_train_iterator
    from repro_torch.optim import cosine_schedule
    m = Model(cfg, device=DEV)
    n = m.param_count()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held_gb = torch.cuda.memory_allocated() / 1e9
    t0 = time.perf_counter()
    state = m.init_train_state(torch.Generator(device=DEV).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    state_gb = torch.cuda.memory_allocated() / 1e9
    it = make_train_iterator(SyntheticLM(cfg.vocab, FULL_SEQ, seed=0),
                             FULL_BATCH)
    sched = lambda s: cosine_schedule(s, peak_lr=FULL_LR,
                                      warmup_steps=FULL_WARMUP,
                                      total_steps=FULL_STEPS)
    before = dict(kernels.LAUNCHES)
    losses, gnorms, step_ms = [], [], []
    for _ in range(FULL_STEPS):
        batch = next(it)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, met = m.train_step(state, batch, lr_schedule=sched)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t1) * 1e3)
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if not (np.isfinite(losses).all() and np.isfinite(gnorms).all()):
        fail(f"full-width training: a loss or grad norm is not finite: "
             f"{losses} {gnorms}")
    steady = step_ms[FULL_STEADY[0]:FULL_STEADY[1]]
    med = float(np.median(steady))
    tokens = FULL_BATCH * FULL_SEQ
    model_flops, exec_flops = step_flops(cfg, n, tokens, FULL_SEQ)
    peak = PEAK_FLOPS["bfloat16"]
    mfu = model_flops / (med / 1e3) / peak
    # two profiled steps: their device kernel time over the steady median
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            state, met = m.train_step(state, next(it), lr_schedule=sched)
        torch.cuda.synchronize()
    prof_out = profile_window(torch, prof, 2)
    dev_ms = prof_out["device_ms_per_tick"]
    busy = dev_ms / med if dev_ms else None
    splits = []
    for _ in range(3):
        state, ms = split_step(torch, m, state, next(it), sched)
        splits.append(ms)
    fwd, bwd, opt_ms = (float(np.median([s[i] for s in splits]))
                        for i in range(3))
    if kernels.LAUNCHES != before:
        fail(f"full-width training launched kernels: {kernels.LAUNCHES}")
    first5, last5 = float(np.mean(losses[:5])), float(np.mean(losses[-5:]))
    print(f"train qwen3-1.7b full width ({card}): {n:,} params "
          f"({cfg.dtype} compute, {cfg.param_dtype} params, "
          f"{m.opt_cfg.moment_dtype} moments, remat {cfg.remat}), batch "
          f"{FULL_BATCH} x seq {FULL_SEQ}, init {init_s:.1f} s, state "
          f"{state_gb:.2f} GB")
    print(f"train full-width step: median {med:.2f} ms over steps "
          f"{FULL_STEADY[0] + 1}-{FULL_STEADY[1]} (all: "
          f"{[round(x, 1) for x in step_ms]}) ({card})")
    print(f"train full-width split (CUDA events, median of 3 steps): "
          f"forward {fwd:.2f} ms, backward {bwd:.2f} ms, optimizer "
          f"{opt_ms:.2f} ms ({card})")
    print(f"train full-width throughput: {tokens / med * 1e3:.0f} tokens/s; "
          f"MFU {mfu:.4f} ({model_flops:.3e} model FLOPs a step over "
          f"{peak:.3e} FLOP/s bf16 dense peak; executed with remat "
          f"{exec_flops:.3e}, HFU {exec_flops / (med / 1e3) / peak:.4f}) "
          f"({card})")
    print(f"train full-width memory: max_memory_allocated {peak_gb:.2f} GB, "
          f"of it {held_gb:.2f} GB held before the phase ({card})")
    print(f"train full-width busy share (2 profiled steps): "
          f"{'not measured' if busy is None else f'{busy:.3f}'} (device "
          f"{'not measured' if dev_ms is None else f'{dev_ms:.2f} ms'} a "
          f"step) ({card}); top device ops:")
    for k in prof_out["top_kernels"]:
        print(f"    {k['ms_per_tick']:.3f} ms/step "
              f"{k['calls_per_tick']:.0f} calls/step  {k['name']}")
    print(f"train full-width loss: first 5 mean {first5:.4f}, last 5 mean "
          f"{last5:.4f}; grad norms {[round(g, 3) for g in gnorms]}")
    out = {"params": n, "median_step_ms": med, "step_ms": step_ms,
           "forward_ms": fwd, "backward_ms": bwd, "optimizer_ms": opt_ms,
           "tokens_per_s": tokens / med * 1e3, "mfu": mfu,
           "model_flops": model_flops, "executed_flops": exec_flops,
           "max_memory_gb": peak_gb, "held_before_gb": held_gb,
           "state_gb": state_gb,
           "busy_share": busy, "profile": prof_out, "losses": losses,
           "grad_norms": gnorms, "first5": first5, "last5": last5}
    del state, met
    torch.cuda.empty_cache()

    q = Model(dataclasses.replace(cfg, opt_dtype="int8"), device=DEV)
    torch.cuda.reset_peak_memory_stats()
    state = q.init_train_state(torch.Generator(device=DEV).manual_seed(0))
    q_ms, q_losses = [], []
    for _ in range(3):
        batch = next(it)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        state, met = q.train_step(state, batch, lr_schedule=sched)
        torch.cuda.synchronize()
        q_ms.append((time.perf_counter() - t1) * 1e3)
        q_losses.append(float(met["loss"]))
    if not np.isfinite(q_losses).all():
        fail(f"full-width int8-moment training: {q_losses}")
    mb = moment_bytes(state.opt)
    q_peak = torch.cuda.max_memory_allocated() / 1e9
    print(f"train full-width int8 moments: steps {[round(x, 1) for x in q_ms]}"
          f" ms, moments {mb / 1e9:.3f} GB (fp32: {8 * n / 1e9:.3f} GB), "
          f"max_memory_allocated {q_peak:.2f} GB, losses {q_losses} ({card})")
    out["int8"] = {"step_ms": q_ms, "moment_bytes": mb, "losses": q_losses,
                   "max_memory_gb": q_peak}
    del state, met
    torch.cuda.empty_cache()
    return out


def checkpoint_round_trip(torch, Model, cfg) -> dict:
    """Phase 6 (d): reduced ``cfg``'s train state with int8 moments, after
    two steps, saved from the card and loaded back onto it: every leaf
    (each moment's codes and scales) equal bit for bit."""
    import shutil

    from repro_torch.checkpoint import latest_step, load_checkpoint, \
        save_checkpoint
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim import AdamWConfig
    m = Model(cfg, device=DEV, opt_cfg=AdamWConfig(moment_dtype="int8"))
    state = m.init_train_state(torch.Generator(device=DEV).manual_seed(0))
    for i in range(2):
        state, _ = m.train_step(state, train_batch(cfg, seed=i))
    d = REPO / "build" / "ckpt_smoke"
    shutil.rmtree(d, ignore_errors=True)
    save_checkpoint(d, 2, state)
    like = m.init_train_state(torch.Generator(device=DEV).manual_seed(1))
    back = load_checkpoint(d, latest_step(d), like)

    def leaves(s):
        out = [s.step, s.opt.step] + tree_leaves(s.params)
        for leaf in tree_leaves(s.opt.m) + tree_leaves(s.opt.v):
            out += [leaf.q, leaf.scale]
        return out
    a, b = leaves(state), leaves(back)
    if len(a) != len(b) or not all(
            x.device == y.device and x.dtype == y.dtype and torch.equal(x, y)
            for x, y in zip(a, b)):
        fail("a checkpoint of the card's train state did not load back bit "
             "for bit")
    nbytes = sum(p.stat().st_size for p in d.rglob("*") if p.is_file())
    shutil.rmtree(d, ignore_errors=True)
    print(f"train checkpoint: reduced {cfg.name} with int8 moments, "
          f"{len(a)} tensors ({nbytes / 1e6:.2f} MB), saved from and loaded "
          "onto the card, equal bit for bit")
    return {"tensors": len(a), "bytes": nbytes}


def training_phase(torch, kernels, Model, get_config, plan, card: str
                   ) -> dict:
    """Phase 6: training (see the module docstring).  The counts are set
    to 0 before it and must all read 0 after it: training launches none
    of the six kernels."""
    t0 = time.perf_counter()
    kernels.reset_launches()
    out: dict = {}
    for arch in ("qwen3-1.7b", "olmoe-1b-7b", "mamba2-370m"):
        out[f"card_vs_cpu/{arch}"] = card_vs_cpu(
            torch, kernels, Model, plan, get_config(arch).reduced(), arch)
    out["converge/qwen3"] = converge(
        torch, Model, get_config("qwen3-1.7b").reduced(), "reduced qwen3",
        40, 0, 8, 32, 3e-3, 5, 5, 0.2)
    out["converge/olmoe"] = converge(
        torch, Model, get_config("olmoe-1b-7b").reduced(), "reduced olmoe",
        50, 1, 8, 32, 3e-3, 5, 5, 0.05, grad_clip=10.0)
    out["converge/100m"] = converge(
        torch, Model, hundred_m_config(get_config), "qwen3-100m", 200, 0, 8,
        256, 1e-3, 20, 10, 0.0)
    out["full_width"] = full_width_training(
        torch, kernels, Model, get_config("qwen3-1.7b"), card)
    out["checkpoint"] = checkpoint_round_trip(
        torch, Model, get_config("qwen3-1.7b").reduced())
    if any(kernels.LAUNCHES.values()):
        fail(f"the training phase launched kernels: {kernels.LAUNCHES}")
    out["wall_s"] = time.perf_counter() - t0
    print(f"phase 6 (training) in {out['wall_s']:.1f} s; kernel launches "
          f"during it {kernels.LAUNCHES}")
    return out


#: phase 7 (a): the kernel-site bench's geometries (bench_kernel_sites
#: keywords): the reference's defaults in fp32; qwen3-1.7b's served
#: geometry and hymba-1.5b's attention over its window, both in bf16
BENCH_GEOMETRIES = {
    "reference": dict(slots=4, max_len=64, q_heads=8, kv_heads=2,
                      head_dim=64, kv_block_size=8, vocab=512),
    "qwen3": dict(slots=SLOTS, max_len=MAX_LEN, q_heads=H, kv_heads=K,
                  head_dim=D, kv_block_size=32, vocab=VOCAB,
                  dtype="bfloat16"),
    "hymba": dict(slots=SLOTS, max_len=HY_WINDOW, q_heads=HY_H,
                  kv_heads=HY_K, head_dim=HY_D, kv_block_size=32,
                  vocab=HY_VOCAB, dtype="bfloat16"),
}
#: the bench's kernels and its launches of each a geometry (the capture's
#: warm-up, 3 warm-up replays, 20 timed)
BENCH_KERNELS = ("gqa_decode", "gqa_decode_paged", "fused_mask")
BENCH_CALLS = 24
#: phase 7 (b): the routed engine's traffic (phase 3's paged sampled
#: requests, fewer and shorter) and the off engine's
ROUTED_RUN = dict(kv="paged", requests=8, max_new=32, temperature=0.8,
                  top_k=50, top_p=0.95)
OFF_RUN = dict(ROUTED_RUN, requests=4, max_new=16)
#: phase 7 (d): group sizes, Fig. 11's per-rank size (2^20 fp32), the
#: group that syncs resnet18's parameter vector, timed calls, time limit
SYNC_GROUPS = (2, 4, 8)
SYNC_N = 1 << 20
SYNC_RESNET_P = 4
SYNC_ITERS = 5
SYNC_TIMEOUT = 300.0


def plan_options(geo: dict, timings=None) -> dict:
    """``select_kernel_plan``'s options for a bench geometry on the card
    (its pool: every slot's horizon in blocks)."""
    out = {k: geo[k] for k in ("slots", "max_len", "q_heads", "kv_heads",
                               "head_dim", "kv_block_size")}
    out.update(accelerator="cuda", kv_pool_blocks=geo["slots"] * (
        geo["max_len"] // geo["kv_block_size"]))
    if timings:
        out["timings"] = timings
    return out


def bench_phase(torch, kernels, pipeline, card: str) -> dict:
    """Phase 7 (a): ``bench_kernel_sites`` at each BENCH_GEOMETRIES entry
    on the card: every site's three candidates (the kernel's among them)
    timed, the plan ``select_kernel_plan`` derives from them beside the
    heuristic one.  Each kernel must launch BENCH_CALLS times a
    geometry."""
    from repro_torch.launch.autotune import bench_kernel_sites
    torch.cuda.synchronize()
    kernels.reset_launches()
    out: dict = {}
    t0 = time.perf_counter()
    for label, geo in BENCH_GEOMETRIES.items():
        t = bench_kernel_sites(**geo)
        want = {f"{site}:{b}"
                for site in ("decode_dense", "decode_paged", "sampler")
                for b in pipeline.KERNEL_SITE_BACKENDS[site]}
        if set(t) != want or not all(0 < v < 1 for v in t.values()):
            fail(f"bench {label}: timings {t}, want every key of {want}")
        plan, detail = pipeline.select_kernel_plan(plan_options(geo, t))
        heuristic, _ = pipeline.select_kernel_plan(plan_options(geo))
        differs = {site: (b, heuristic.as_dict()[site])
                   for site, b in plan.items()
                   if b != heuristic.as_dict()[site]}
        print(f"bench {label} ({geo.get('dtype', 'float32')}, "
              f"{card}): " + ", ".join(
                  f"{k} {v * 1e6:.1f} us" for k, v in sorted(t.items())))
        print(f"  measured plan {plan.as_dict()}; differs from the "
              f"heuristic plan at {differs or 'no site'} (measured, "
              "heuristic)")
        out[label] = {"timings": t, "plan": plan.as_dict(),
                      "heuristic": heuristic.as_dict(), "differs": differs,
                      "measured_s": {k: v for k, v in detail.items()
                                     if k.endswith("_measured_s")}}
    launches = dict(kernels.LAUNCHES)
    want = BENCH_CALLS * len(BENCH_GEOMETRIES)
    for name in BENCH_KERNELS:
        if launches[name] != want:
            fail(f"bench: {name} launched {launches[name]} times, want "
                 f"{want} ({BENCH_CALLS} a geometry)")
    out["launches"] = launches
    out["wall_s"] = time.perf_counter() - t0
    print(f"phase 7 (a) in {out['wall_s']:.1f} s; launches {launches}")
    return out


def check_routed_launches(label, run, model, plan) -> None:
    """A routed paged qwen3 run launches each kernel its plan routes to
    as often as its steps ask (``gqa_decode_paged`` n_layers a decode
    step, ``fused_mask`` once a sampler dispatch, ``linked_mlp`` at
    least once, each capture's warm-up a replay's worth) and no kernel
    of a site the plan keeps in torch."""
    ln, warm = run["launches"], run["warmup"]
    want = {
        "gqa_decode": 0,
        "gqa_decode_paged": model.cfg.n_layers * run["kernel_steps"]
        + warm.get("gqa_decode_paged", 0)
        if plan.decode_paged == "cuda" else 0,
        "fused_mask": run["sampler_calls"] + warm.get("fused_mask", 0)
        if plan.sampler == "cuda" else 0,
        "cbr_avgpool": 0, "split_matmul": 0}
    for name, n in want.items():
        if ln.get(name, 0) != n:
            fail(f"{label}: {name} launched {ln.get(name, 0)} times, want "
                 f"{n} under {plan.as_dict()}")
    if (ln.get("linked_mlp", 0) > 0) != (plan.linked_matmul == "cuda"):
        fail(f"{label}: linked_mlp launched {ln.get('linked_mlp', 0)} "
             f"times under {plan.as_dict()}")
    print(f"{label}: launches {ln} as the plan routes")


def routed_phase(torch, kernels, serve, pipeline, Model, get_config,
                 timings: dict, card: str) -> dict:
    """Phase 7 (b): a graphed full-width qwen3-1.7b paged engine built
    with ``kernel_timings`` (phase 7 (a)'s qwen3 timings) takes the plan
    ``select_kernel_plan`` gives on them and serves ROUTED_RUN's
    requests, the same token streams, bit for bit, as an engine given
    that plan explicitly; an engine built with ``kernel_plan="off"``
    launches no kernel."""
    from repro_torch.launch import autotune
    cfg = get_config("qwen3-1.7b")
    model = Model(cfg, device=DEV)
    params = model.cast_params(model.init(
        torch.Generator(device=DEV).manual_seed(0)))
    args = serve_args(serve, **ROUTED_RUN)
    engine = serve.build_engine(args, model, params,
                                kernel_timings=timings)
    opts = {"accelerator": engine.device.type, "slots": engine.slots,
            "max_len": engine.max_len, "q_heads": cfg.n_heads,
            "kv_heads": cfg.n_kv_heads, "head_dim": cfg.resolved_head_dim,
            "kv_block_size": engine.pool.cfg.block_size,
            "kv_pool_blocks": engine.pool.cfg.pool_blocks,
            "timings": timings}
    plan, _ = pipeline.select_kernel_plan(opts)
    if engine.kernel_plan != plan:
        fail(f"routed engine: plan {engine.kernel_plan}, select_kernel_plan "
             f"gives {plan} on the same timings")
    report = engine.stats()["kernel_report"]["passes"][-1]["summary"]
    measured = {k: v for k, v in report.items() if k.endswith("_measured_s")}
    print(f"routed engine (block {engine.pool.cfg.block_size}, "
          f"{engine.pool.cfg.pool_blocks} blocks; the bench's block 32): "
          f"plan {plan.as_dict()}, measured {measured} ({card})")
    runs = {}
    runs["routed_timed"] = serve_phase(
        torch, kernels, serve, engine, args, "routed_timed", 14, window=None)
    del engine
    runs["routed_explicit"] = serve_phase(
        torch, kernels, serve,
        serve.build_engine(args, model, params, kernel_plan=plan), args,
        "routed_explicit", 14, window=None)
    for label in ("routed_timed", "routed_explicit"):
        check_routed_launches(label, runs[label], model, plan)
    same_streams("routed by measurement vs the explicit plan",
                 runs["routed_timed"], runs["routed_explicit"])
    off_args = serve_args(serve, **OFF_RUN)
    off = serve.build_engine(off_args, model, params, kernel_plan="off")
    if off.kernel_plan != pipeline.KernelPlan():
        fail(f"kernel_plan='off' gave {off.kernel_plan}")
    runs["routed_off"] = serve_phase(torch, kernels, serve, off, off_args,
                                     "routed_off", 14, window=None)
    if any(runs["routed_off"]["launches"].values()):
        fail(f"kernel_plan='off' launched {runs['routed_off']['launches']}")
    print("routed_off: no kernel launched")
    # the timings cache round trip
    path = REPO / "chiprun_out" / "kernel_timings_qwen3.json"
    autotune.save_timings(str(path), timings, meta={"card": card})
    if autotune.load_timings(str(path)) != timings:
        fail("save_timings then load_timings changed the timings")
    print(f"timings cache {path.name}: load_timings gives back the dict")
    return runs


def tune_phase(torch, kernels, card: str) -> dict:
    """Phase 7 (c): ``python -m repro_torch.launch.kernel_tune`` at the
    reference's defaults (fp32, every block size that tiles 64), its
    cache written to ``chiprun_out/kernel_timings.json`` and read back."""
    from repro_torch.launch import autotune, kernel_tune
    path = REPO / "chiprun_out" / "kernel_timings.json"
    torch.cuda.synchronize()
    kernels.reset_launches()
    t0 = time.perf_counter()
    if kernel_tune.main(["--out", str(path)]) != 0:
        fail("kernel_tune exited non-zero")
    wall = time.perf_counter() - t0
    data = json.loads(path.read_text())
    timings = autotune.load_timings(str(path))
    if not timings or timings != data["timings"] \
            or len(data["meta"]["by_block_size"]) != 3:
        fail(f"kernel_tune's cache {path}: {data}")
    launches = dict(kernels.LAUNCHES)
    print(f"kernel_tune ({card}): {len(data['meta']['by_block_size'])} "
          f"block sizes in {wall:.1f} s, plan {data['meta']['plan']}; "
          f"launches {launches}")
    return {"launches": launches, "timings": timings, "wall_s": wall,
            "plan": data["meta"]["plan"]}


def sync_inputs(torch, kind: str, p: int, device) -> list:
    """The ranks' inputs of a phase 7 (d) workload, every rank's: Fig.
    11's size, 2^20 fp32 a rank, drawn from normal(0, 1) with rank r's
    generator at seed r (Fig. 11's ones would sum exactly in any order);
    or resnet18's parameter vector (the zoo's ResNet18 at 224, width 64,
    1000 classes: every leaf of ``init_params(seed=0)`` in graph order),
    times r + 1 on rank r."""
    if kind == "fig11":
        return [torch.randn(SYNC_N, device=device, generator=torch.Generator(
            device=device).manual_seed(r)) for r in range(p)]
    from repro_torch.configs import cnn_zoo
    from repro_torch.core.engine import init_params
    g = cnn_zoo.resnet18(res=224, width=64, n_classes=1000)
    leaves = init_params(g, seed=0, device=device)
    vec = torch.cat([t.reshape(-1).float() for t in leaves.values()])
    return [vec * (r + 1) for r in range(p)]


def sync_rank(mesh):
    """One rank of phase 7 (d): in each SYNC_GROUPS group of the first p
    ranks (and the resnet18 group), ``ring_allreduce``, ``ps_sync`` and
    ``dist.all_reduce`` of this rank's input: each schedule must equal
    the numpy sum in its order (``schedule_sum``) bit for bit and
    ``all_reduce`` within fp32 rounding.  Times each (SYNC_ITERS calls
    after one, synchronized, a barrier before each) and returns, on the
    group's rank 0, the times and sizes."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from repro_torch.distributed import ps_sync, ring_allreduce
    cases = [("fig11", p) for p in SYNC_GROUPS] + [("resnet18",
                                                     SYNC_RESNET_P)]
    groups = {p: dist.new_group(list(range(p)))
              for p in sorted({p for _, p in cases})}
    out = {}
    for kind, p in cases:
        if mesh.rank >= p:
            continue
        group = groups[p]
        xs = sync_inputs(torch, kind, p, mesh.device)
        x = xs[mesh.rank]
        rows = np.stack([t.cpu().numpy() for t in xs])
        fns = {"ring": lambda: ring_allreduce(x, group),
               "ps": lambda: ps_sync(x, group)}

        def all_reduce():
            y = x.clone()
            dist.all_reduce(y, group=group)
            return y
        fns["all_reduce"] = all_reduce
        got = {name: fn().cpu().numpy() for name, fn in fns.items()}
        for name in ("ring", "ps"):
            want = schedule_sum(rows, name)
            if got[name].tobytes() != want.tobytes():
                bad = int((got[name] != want).sum())
                raise AssertionError(
                    f"{kind} p={p} rank {mesh.rank}: {name} differs from "
                    f"the numpy sum in its order at {bad} elements")
            # fp32 rounding: p - 1 adds in any order part by at most
            # 2 (p - 1) eps of the sum of magnitudes, element by element
            bound = 2 * (p - 1) * np.finfo(np.float32).eps * np.abs(
                rows).sum(0)
            if not (np.abs(got[name] - got["all_reduce"]) <= bound).all():
                raise AssertionError(
                    f"{kind} p={p} rank {mesh.rank}: {name} parts from "
                    "all_reduce past fp32 rounding")
        times = {}
        for name, fn in fns.items():
            ts = []
            for _ in range(SYNC_ITERS):
                dist.barrier(group=group)
                t0 = time.perf_counter()
                fn().sum().item()   # waits for the device
                ts.append(time.perf_counter() - t0)
            times[name] = sorted(ts)[len(ts) // 2]
        diff = float(np.abs(got["ring"] - got["all_reduce"]).max())
        if mesh.rank == 0:
            out[f"{kind}/{p}"] = {"n": int(x.numel()), "median_s": times,
                                  "ring_vs_all_reduce_max": diff,
                                  "backend": mesh.backend}
    return out


def sync_phase(torch, card: str) -> dict:
    """Phase 7 (d): ``sync_rank`` on 8 ranks spawned on this card (gloo:
    NCCL refuses two ranks on one card), printing each schedule's median
    time, labelled as gloo through the host, and the bytes a rank sends
    under each."""
    from repro_torch.launch.mesh import spawn_ranks
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        ranks = spawn_ranks(sync_rank, max(SYNC_GROUPS),
                            devices=["cuda:0"] * max(SYNC_GROUPS),
                            timeout_s=SYNC_TIMEOUT)
    except (RuntimeError, TimeoutError) as e:
        fail(f"sync: {e}")
    out = ranks[0]
    for key, r in out.items():
        p, n = int(key.split("/")[1]), r["n"]
        ring_b = 2 * (p - 1) * (-(-n // p)) * 4
        ps_b = (p - 1) * n * 4
        r.update(ring_bytes_a_rank=ring_b, ps_root_link_bytes=ps_b)
        print(f"sync {key} ({n} fp32 a rank; {r['backend']} staged through "
              f"the host, not card to card; {card}): median ring "
              f"{r['median_s']['ring'] * 1e3:.2f} ms, ps "
              f"{r['median_s']['ps'] * 1e3:.2f} ms, all_reduce "
              f"{r['median_s']['all_reduce'] * 1e3:.2f} ms; ring and ps "
              f"equal the numpy sums in their orders bit for bit, ring "
              f"vs all_reduce max |diff| {r['ring_vs_all_reduce_max']:.3g}; "
              f"bytes a rank sends: ring 2(p-1)/p n = {ring_b / 1e6:.3f} "
              f"MB, ps (p-1) n through the root's link = "
              f"{ps_b / 1e6:.3f} MB")
    wall = time.perf_counter() - t0
    print(f"phase 7 (d) in {wall:.1f} s (8 ranks spawned)")
    return {"cases": out, "wall_s": wall}


def schedule_sum(rows, kind: str):
    """The numpy oracle of phase 7 (d): rows (p, n) fp32, one a rank ->
    the (n,) sum each element gets under ``kind``'s schedule
    (``repro_torch.distributed.collectives``), one fp32 add at a time in
    the schedule's order.  ``ps``: rank 0 adds ranks 1, 2, ... to its own
    row in turn.  ``ring``: chunk c (of p, the row padded to a multiple
    of p) starts at rank c and each next rank round the ring adds its own
    chunk c to what it received."""
    import numpy as np
    p, n = rows.shape
    if kind == "ps":
        acc = rows[0].copy()
        for j in range(1, p):
            acc = acc + rows[j]
        return acc
    if kind != "ring":
        raise ValueError(f"unknown schedule {kind!r}")
    chunks = np.pad(rows, ((0, 0), (0, (-n) % p))).reshape(p, p, -1)
    out = np.empty_like(chunks[0])
    for c in range(p):
        acc = chunks[c, c].copy()
        for j in range(1, p):
            acc = chunks[(c + j) % p, c] + acc
        out[c] = acc
    return out.reshape(-1)[:n]


# ---------------------------------------------------------------------------
# phase 8: the d-Xenos planning tools (fake ranks, in a process of its own)
# ---------------------------------------------------------------------------

def mesh_rank(mesh, reduced: dict, full: dict):
    """One rank of phase 9: each ``reduced`` case's steps from its numpy
    params on this rank's rows (the losses and grad norms' bits, each
    leaf's placements and a digest of its local shard, the whole params
    on rank 0), then ``full``'s full-width steps from the seed (the
    losses, grad norms, synchronized step times, ``max_memory_allocated``
    and the collectives of the second step by kind)."""
    import hashlib

    import numpy as np
    import torch
    import torch.distributed as dist
    from torch.distributed.tensor.debug import CommDebugMode
    from repro_torch.configs.base import ModelConfig, get_config
    from repro_torch.convert import params_from_numpy
    from repro_torch.data import SyntheticLM, make_train_iterator
    from repro_torch.launch.mesh import mesh_device
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.models.model import Model
    from repro_torch.optim import cosine_schedule

    from repro_torch import kernels

    torch.backends.cuda.matmul.allow_tf32 = False
    launched = dict(kernels.LAUNCHES)
    dev = mesh_device(mesh)
    rank = dist.get_rank()
    d = mesh.get_local_rank("data")
    n_data = mesh.size(0)

    def bits(t) -> bytes:
        return np.float32(float(t)).tobytes()
    out = {}
    for name, case in reduced.items():
        model = Model(ModelConfig(**case["cfg"]), mesh=mesh, device=dev)
        state = model.init_train_state(None, params=params_from_numpy(
            case["params"], dev))
        sched = lambda st: cosine_schedule(st, **TRAIN_SCHED)
        losses, gnorms = [], []
        for b in case["batches"]:
            rows = b["tokens"].shape[0] // n_data
            mine = {k: v[d * rows:(d + 1) * rows] for k, v in b.items()}
            state, met = model.train_step(state, mine, lr_schedule=sched,
                                          batch_axes=("data",))
            losses.append(bits(met["loss"]))
            gnorms.append(bits(met["grad_norm"]))
        digests = [([repr(p) for p in t.placements], hashlib.sha1(
            t.detach().to_local().cpu().numpy().tobytes()).hexdigest())
            for t in tree_leaves(state.params)]
        whole = model.gather_params(state.params)
        out[name] = {"loss": losses, "grad_norm": gnorms,
                     "digests": digests, "coord": list(
                         mesh.get_coordinate()),
                     "params": [t.numpy() for t in tree_leaves(whole)]
                     if rank == 0 else None}
        del model, state, whole
    torch.cuda.empty_cache()
    cfg = dataclasses.replace(get_config("qwen3-1.7b"),
                              n_layers=full["n_layers"])
    model = Model(cfg, mesh=mesh, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    state = model.init_train_state(
        torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    held = torch.cuda.memory_allocated()
    data = make_train_iterator(SyntheticLM(cfg.vocab, MESH_FULL_SEQ, seed=0),
                               MESH_FULL_BATCH, shard_index=d,
                               num_shards=n_data)
    sched = lambda st: cosine_schedule(st, peak_lr=FULL_LR,
                                       warmup_steps=FULL_WARMUP,
                                       total_steps=MESH_FULL_STEPS)
    torch.cuda.reset_peak_memory_stats()
    losses, gnorms, step_s, comm = [], [], [], {}
    for i in range(MESH_FULL_STEPS):
        batch = next(data)
        dist.barrier()
        t0 = time.perf_counter()
        mode = CommDebugMode() if i == MESH_FULL_STEPS - 1 else None
        with mode if mode is not None else contextlib.nullcontext():
            state, met = model.train_step(state, batch, lr_schedule=sched,
                                          batch_axes=("data",))
        loss = float(met["loss"])           # waits for the step
        step_s.append(time.perf_counter() - t0)
        losses.append(bits(loss))
        gnorms.append(bits(met["grad_norm"]))
        if mode is not None:
            for op, n in mode.get_comm_counts().items():
                key = str(op).rsplit(".", 1)[-1]
                comm[key] = comm.get(key, 0) + n
    if kernels.LAUNCHES != launched:
        raise AssertionError(f"training on the mesh launched kernels: "
                             f"{kernels.LAUNCHES}")
    return {"reduced": out, "full": {
        "loss": losses, "grad_norm": gnorms, "step_s": step_s,
        "max_memory": torch.cuda.max_memory_allocated(),
        "held_after_init": held, "init_s": init_s, "comm": comm,
        "local_params": sum(t.to_local().numel()
                            for t in tree_leaves(state.params))}}


def mesh_depth(plan: dict, n_layers: int,
               held_gb: float = 0.0) -> tuple[int, str]:
    """Phase 9 (b)'s depth: full depth where four ranks at the dry run's
    per-rank peak plus ``MESH_SLACK_GB`` and the ``held_gb`` this process
    holds on the card fit in ``MESH_CARD_GB``, else the deepest stack
    that does, on the line through the dry run's peaks at full depth and
    at two layers; with the reason."""
    full = plan[str(n_layers)]["peak_bytes"] / 1e9
    two = plan["2"]["peak_bytes"] / 1e9
    extra = MESH_SLACK_GB + held_gb
    need = MESH_RANKS * full + extra
    if need <= MESH_CARD_GB:
        return n_layers, (f"{MESH_RANKS} x {full:.2f} GB + {extra:.2f} GB "
                          f"= {need:.2f} GB fits in {MESH_CARD_GB} GB")
    per_layer = (full - two) / (n_layers - 2)
    fit = (MESH_CARD_GB - extra) / MESH_RANKS
    L = max(2, min(2 + int((fit - two) // per_layer), n_layers))
    return L, (
        f"{MESH_RANKS} x {full:.2f} GB (the dry run's per-rank peak at "
        f"{n_layers} layers) + {MESH_SLACK_GB} GB + {held_gb:.2f} GB held "
        f"by this process = {need:.2f} GB passes {MESH_CARD_GB} GB; at "
        f"{per_layer:.3f} GB a layer above {two:.2f} GB at 2 layers, a "
        f"rank fits {fit:.2f} GB at {L} layers (the widths are full)")


def mesh_training_phase(torch, Model, get_config, planning: dict,
                        card: str) -> dict:
    """Phase 9: ``mesh_rank`` on 4 ranks spawned on this card, its reduced
    runs held against the one-device card steps, its full-width run
    against phase 8's dry run of that step."""
    import numpy as np
    from repro_torch.convert import params_from_numpy
    from repro_torch.launch.mesh import make_debug_mesh, spawn_ranks
    from repro_torch.models.layers import tree_leaves, tree_map
    from repro_torch.optim import cosine_schedule

    t_phase = time.perf_counter()
    gc.collect()             # engines and graphs of earlier phases in cycles
    torch.cuda.empty_cache()
    print(f"held before phase 9: {torch.cuda.memory_allocated() / 1e9:.2f} "
          f"GB allocated ({card})")
    sched = lambda st: cosine_schedule(st, **TRAIN_SCHED)
    reduced, one = {}, {}
    for name, arch, over in (("qwen3", "qwen3-1.7b", {}),
                             ("olmoe", "olmoe-1b-7b",
                              {"capacity_factor": 8.0})):
        cfg = dataclasses.replace(get_config(arch).reduced(), **over)
        raw = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
        layer_fan_in(raw, cfg)
        np_params = tree_map(lambda t: t.numpy(), raw)
        batches = [train_batch(cfg, seed=i, batch=MESH_BATCH, seq=MESH_SEQ)
                   for i in range(MESH_STEPS)]
        reduced[name] = {"cfg": dataclasses.asdict(cfg),
                         "params": np_params, "batches": batches}
        m = Model(cfg, device=DEV)
        state = m.init_train_state(None, params=params_from_numpy(
            np_params, DEV))
        losses, gnorms = [], []
        for b in batches:
            state, met = m.train_step(state, b, lr_schedule=sched)
            losses.append(float(met["loss"]))
            gnorms.append(float(met["grad_norm"]))
        one[name] = (losses, gnorms, [t.detach().cpu()
                                      for t in tree_leaves(state.params)])
        del m, state
    gc.collect()
    torch.cuda.empty_cache()
    qwen = get_config("qwen3-1.7b")
    plan = dict(planning["mesh_train"])
    held = torch.cuda.memory_reserved() / 1e9
    L, why = mesh_depth(plan, qwen.n_layers, held)
    print(f"mesh train depth {L} of {qwen.n_layers}: {why} (phase 8's dry "
          "run)")
    if str(L) not in plan:      # a cut phase 8 did not trace
        more, errors = mesh_plan((L,))
        if errors:
            fail(f"phase 9: the dry run at {L} layers raised: {errors}")
        plan.update(more)
    t0 = time.perf_counter()
    # the ranks' allocator grows segments in place: four ranks at their
    # peaks leave the card no room for the fragments of fixed segments
    # (an H100 ran out at 25 layers with 1.35 GiB of them a rank)
    alloc_conf = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        ranks = spawn_ranks(mesh_rank, MESH_RANKS,
                            args=(reduced, {"n_layers": L}),
                            devices=["cuda:0"] * MESH_RANKS,
                            timeout_s=MESH_TIMEOUT,
                            train_shape=make_debug_mesh(MESH_RANKS))
    except (RuntimeError, TimeoutError) as e:
        fail(f"mesh training: {e}")
    finally:
        if alloc_conf is None:
            os.environ.pop("PYTORCH_CUDA_ALLOC_CONF")
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc_conf
    ranks_s = time.perf_counter() - t0
    out: dict = {"depth": L, "depth_reason": why, "reduced": {}}
    lr_sum = sum(float(sched(i)) for i in range(MESH_STEPS))
    for name in reduced:
        rs = [r["reduced"][name] for r in ranks]
        for key in ("loss", "grad_norm"):
            if any(r[key] != rs[0][key] for r in rs):
                fail(f"mesh {name}: the ranks' {key} bits differ")
        got = {k: [float(np.frombuffer(b, np.float32)[0])
                   for b in rs[0][k]] for k in ("loss", "grad_norm")}
        losses, gnorms, params = one[name]
        rel = max(abs(a - b) / abs(b) for k, want in
                  (("loss", losses), ("grad_norm", gnorms))
                  for a, b in zip(got[k], want))
        if not rel <= 1e-5:
            fail(f"mesh {name}: losses {got['loss']} grad norms "
                 f"{got['grad_norm']} vs one device {losses} {gnorms}")
        worst, off = close_params(params, [torch.from_numpy(a) for a in
                                           rs[0]["params"]], lr_sum)
        shared = 0
        for i, (pls, _) in enumerate(rs[0]["digests"]):
            split = [md for md, p in enumerate(pls) if p.startswith("Shard")]
            for a in rs:
                for b in rs:
                    if all(a["coord"][md] == b["coord"][md] for md in split) \
                            and a["digests"][i][1] != b["digests"][i][1]:
                        fail(f"mesh {name}: leaf {i} ({pls}) differs "
                             "between ranks that share its shard")
            shared += len(split) < len(pls)
        out["reduced"][name] = {"loss": got["loss"],
                                "grad_norm": got["grad_norm"],
                                "one_device": [losses, gnorms],
                                "max_rel": rel, "param_worst": worst,
                                "param_off": off}
        print(f"mesh {name} reduced, {MESH_RANKS} gloo ranks on cuda:0 "
              f"over (data 2, model 2), {MESH_STEPS} steps of {MESH_BATCH} "
              f"x {MESH_SEQ}: losses {got['loss']} grad norms "
              f"{got['grad_norm']} (the same bits on every rank) vs one "
              f"device {losses} {gnorms}: max rel {rel:.2e}; params worst "
              f"{worst:.4f} of the summed lr, {off} elements past 1e-3 of "
              f"it; {shared} leaves replicated on a mesh dim, bit-equal on "
              f"the ranks sharing them ({card})")
    full = [r["full"] for r in ranks]
    for key in ("loss", "grad_norm"):
        if any(f[key] != full[0][key] for f in full):
            fail(f"mesh full width: the ranks' {key} bits differ")
    losses = [float(np.frombuffer(b, np.float32)[0]) for b in full[0]["loss"]]
    gnorms = [float(np.frombuffer(b, np.float32)[0])
              for b in full[0]["grad_norm"]]
    if not all(np.isfinite(losses + gnorms)):
        fail(f"mesh full width: losses {losses} grad norms {gnorms}")
    rec = plan[str(L)]
    for r, f in enumerate(full):
        mem = f["max_memory"] / 1e9
        print(f"mesh full rank {r}: max_memory_allocated {mem:.2f} GB "
              f"(after init {f['held_after_init'] / 1e9:.2f} GB, "
              f"{f['local_params'] / 1e9:.3f} B local params) beside the "
              f"dry run's per-rank peak {rec['peak_bytes'] / 1e9:.2f} GB "
              f"(ratio dry / card {rec['peak_bytes'] / 1e9 / mem:.3f}); "
              f"collectives of step {MESH_FULL_STEPS} "
              f"{dict(sorted(f['comm'].items()))} beside the dry run's "
              f"{rec['collective_counts']}; step s "
              + ", ".join(f"{t:.2f}" for t in f["step_s"])
              + f" (gloo through the host, not card to card; {card})")
    print(f"mesh full width qwen3-1.7b ({L} of {qwen.n_layers} layers, d "
          f"{qwen.d_model}, vocab {qwen.vocab}), {MESH_FULL_STEPS} steps of "
          f"{MESH_FULL_BATCH} x {MESH_FULL_SEQ}, remat on: losses {losses} "
          f"grad norms {gnorms}, the same bits on every rank; init "
          f"{full[0]['init_s']:.1f} s ({card})")
    out["full"] = {"losses": losses, "grad_norms": gnorms, "ranks": full,
                   "dry_run": rec}
    out["ranks_s"] = ranks_s
    out["wall_s"] = time.perf_counter() - t_phase
    print(f"phase 9 in {out['wall_s']:.1f} s ({ranks_s:.1f} s of it the "
          f"{MESH_RANKS} ranks, spawned); no kernel launched")
    return out


def _plan_line(rec: dict) -> dict:
    """The numbers phase 8 prints of one dry-run record."""
    return {k: rec.get(k) for k in (
        "dominant", "bound_s", "compute_s", "memory_s", "collective_s",
        "flops_per_device", "bytes_per_device",
        "collective_bytes_per_device", "collectives", "fits_hbm",
        "compile_s")} | {"peak_bytes": rec["memory"]["peak_estimate"],
                         "notes": rec.get("notes")}


def planning_child(out_path: str) -> int:
    """Phase 8's work, run as ``chip_smoke.py --planning OUT``: host work
    alone (a fake process group, fake tensors), written to OUT as JSON.
    A dry run that raises is recorded under ``errors``."""
    import traceback
    os.environ.pop("REPRO_DRYRUN_DEVICES", None)   # the production mesh
    sys.path.insert(0, str(SRC))
    import torch
    torch.set_num_threads(1)
    from repro_torch.configs.base import InputShape, get_config
    from repro_torch.core import costmodel as cm
    from repro_torch.launch import autotune, dryrun, hillclimb
    from repro_torch.launch import mesh as mesh_lib

    t0 = time.perf_counter()
    out: dict = {"runs": {}, "errors": {}}
    for arch, shape in PLAN_RUNS:
        key = f"{arch}/{shape}"
        try:
            out["runs"][key] = _plan_line(dryrun.run_one(
                arch, shape, "single", verbose=True, calibrate=False))
        except Exception as e:  # noqa: BLE001 - recorded, fails the run
            traceback.print_exc()
            out["errors"][key] = f"{type(e).__name__}: {e}"
    best, results, _ = autotune.tune(*PLAN_TUNE)
    out["tune"] = {"best": best, "results": {
        name: {k: r.get(k) for k in ("bound_s", "dominant", "error",
                                     "collective_bytes_per_device")}
        for name, r in results.items()}}
    out["pair"] = []
    for rec in hillclimb.run_pair(PLAN_PAIR, None):
        if "error" in rec:
            out["errors"][f"{PLAN_PAIR}/{rec['variant']}"] = rec["error"]
            continue
        out["pair"].append({"variant": rec["variant"],
                            "calibrated": rec["calibrated"],
                            "peak_bytes": rec["memory"]["peak_estimate"],
                            "fits_hbm": rec["fits_hbm"]})
    one = mesh_lib.make_debug_mesh(1)
    qwen = get_config("qwen3-1.7b")
    anchors = {
        # phase 3's served decode step: 8 slots over a 2048-slot dense
        # ring, the weights cast to bf16 once as the engine's are
        "serve_decode": (dataclasses.replace(qwen, param_dtype="bfloat16"),
                         InputShape("serve_decode", MAX_LEN, SLOTS,
                                    "decode")),
        # phase 6's full-width train step: fp32 params and moments, bf16
        # compute, remat on, 8 x 512 tokens
        "train_step": (qwen, InputShape("train_step", FULL_SEQ, FULL_BATCH,
                                        "train"))}
    out["anchors"] = {}
    for name, (cfg, shape) in anchors.items():
        try:
            trace, _, _ = dryrun.lower_one("qwen3-1.7b", shape, one, cfg=cfg)
        except Exception as e:  # noqa: BLE001 - recorded, fails the run
            traceback.print_exc()
            out["errors"][f"anchor/{name}"] = f"{type(e).__name__}: {e}"
            continue
        coll = cm.collective_bytes_from_trace(trace.collectives)["total"]
        out["anchors"][name] = {
            "flops": trace.flops, "bytes": trace.bytes,
            "collective_bytes": coll, "peak_bytes":
                trace.memory["peak_estimate"],
            **cm.roofline(trace.flops, trace.bytes, coll).as_dict()}
    out["mesh_train"], errors = mesh_plan()
    out["errors"].update(errors)
    out["wall_s"] = time.perf_counter() - t0
    Path(out_path).write_text(json.dumps(out, default=str))
    return 0


def mesh_plan(depths=None) -> tuple[dict, dict]:
    """Phase 9 (b)'s step traced by the dry run on one rank of its mesh
    (a fake group: host work), at ``depths``, by default at full depth,
    at two layers and, where :func:`mesh_depth` cuts the depth, at the
    cut -> (records by depth: per-rank peak, argument bytes, collectives
    by kind and count, FLOPs; errors)."""
    import traceback
    from repro_torch.configs.base import InputShape, get_config
    from repro_torch.core import costmodel as cm
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_lib

    qwen = get_config("qwen3-1.7b")
    shape = InputShape("mesh_train", MESH_FULL_SEQ, MESH_FULL_BATCH, "train")
    out: dict = {}
    errors: dict = {}
    for L in depths or (qwen.n_layers, 2, None):
        if L is None:   # the depth phase 9 takes, where it is cut
            if len(out) < 2:
                break
            L = mesh_depth(out, qwen.n_layers)[0]
            if str(L) in out:
                break
        try:
            trace, _, _ = dryrun.lower_one(
                "qwen3-1.7b", shape, mesh_lib.make_debug_mesh(MESH_RANKS),
                cfg=dataclasses.replace(qwen, n_layers=L))
        except Exception as e:  # noqa: BLE001 - recorded, fails the run
            traceback.print_exc()
            errors[f"mesh_train/{L}"] = f"{type(e).__name__}: {e}"
            continue
        counts: dict = {}
        for op, _ in trace.collectives:
            counts[op] = counts.get(op, 0) + 1
        out[str(L)] = {
            "peak_bytes": trace.memory["peak_estimate"],
            "argument_bytes": trace.memory["argument_bytes"],
            "collective_counts": counts,
            "collective_bytes": cm.collective_bytes_from_trace(
                trace.collectives), "flops": trace.flops,
            "replicated": trace.replicated, "seconds": trace.seconds}
    return out, errors


def start_planning(out_dir: Path):
    """Start phase 8's process (its log in ``chiprun_out/phase8.log``),
    killed at exit if it still runs (a failing phase exits early)."""
    log = open(out_dir / "phase8.log", "w")
    proc = subprocess.Popen(
        [sys.executable, str(Path(__file__).resolve()), "--planning",
         str(out_dir / "phase8.json")], stdout=log, stderr=subprocess.STDOUT,
        cwd=str(REPO))
    log.close()
    atexit.register(stop_process, proc)
    return proc, time.perf_counter()


def stop_process(proc) -> None:
    if proc.poll() is None:
        proc.kill()
        proc.wait()


def planning_phase(proc, started: float, out_dir: Path, runs: dict,
                   training: dict, card: str) -> dict:
    """Phase 8: wait for its process, then print its dry runs, the
    tuner's ranking, the hillclimb pair and the card anchors.  Fails if
    the process fails, overruns ``PLAN_TIMEOUT`` past this call, or any
    dry run raised, or ``baseline_outC`` scored +inf."""
    t_wait = time.perf_counter()
    try:
        rc = proc.wait(timeout=PLAN_TIMEOUT)
    except subprocess.TimeoutExpired:
        stop_process(proc)
        fail(f"phase 8 ran past {PLAN_TIMEOUT:.0f} s after phase 7 "
             "(chiprun_out/phase8.log)")
    waited = time.perf_counter() - t_wait
    if rc != 0:
        fail(f"phase 8 exited {rc} (chiprun_out/phase8.log)")
    out = json.loads((out_dir / "phase8.json").read_text())
    if out["errors"]:
        fail(f"phase 8: dry runs raised: {out['errors']}")
    model = "priced at the H100 SXM data-sheet peaks (700 W), fake ranks"
    for key, r in out["runs"].items():
        print(f"plan {key} 16x16: dominant {r['dominant']}, bound "
              f"{r['bound_s'] * 1e3:.3f} ms (compute "
              f"{r['compute_s'] * 1e3:.3f}, memory {r['memory_s'] * 1e3:.3f},"
              f" collective {r['collective_s'] * 1e3:.3f}); per rank "
              f"{r['flops_per_device']:.4e} FLOPs, "
              f"{r['bytes_per_device']:.4e} bytes, "
              f"{r['collective_bytes_per_device']:.4e} collective bytes "
              f"{r['collectives']}; peak {r['peak_bytes'] / 1e9:.2f} GB, "
              f"fits {r['fits_hbm']}; replicated ops "
              f"{r['notes']['replicated_ops']}; top collective ops "
              f"{r['notes']['top_collective_ops']}; traced in "
              f"{r['compile_s']} s ({model})")
    tune = out["tune"]["results"]
    base = tune.get("baseline_outC", {}).get("bound_s")
    if base is None or base == float("inf"):
        fail(f"phase 8: baseline_outC scored {base}: {tune}")
    ranking = sorted(tune.items(), key=lambda kv: kv[1]["bound_s"])
    print(f"plan tune {'/'.join(PLAN_TUNE)}: best {out['tune']['best']}; "
          + "; ".join(f"{name} {r['bound_s'] * 1e3:.3f} ms {r['dominant']}"
                      for name, r in ranking) + f" ({model})")
    for r in out["pair"]:
        c = r["calibrated"]
        print(f"plan {PLAN_PAIR}.{r['variant']}: dominant {c['dominant']}, "
              f"bound {c['bound_s'] * 1e3:.3f} ms (compute "
              f"{c['compute_s'] * 1e3:.3f}, memory {c['memory_s'] * 1e3:.3f},"
              f" collective {c['collective_s'] * 1e3:.3f}), peak "
              f"{r['peak_bytes'] / 1e9:.2f} GB, fits {r['fits_hbm']} "
              f"({model})")
    a = out["anchors"]["serve_decode"]
    step = runs["dense_greedy"]["mean_decode_ms"]
    print(f"plan anchor decode (qwen3-1.7b, 1 rank, 8 slots x {MAX_LEN}, "
          f"bf16): dry-run bound {a['bound_s'] * 1e3:.3f} ms ({a['dominant']};"
          f" compute {a['compute_s'] * 1e3:.3f}, memory "
          f"{a['memory_s'] * 1e3:.3f}; {a['flops']:.4e} FLOPs, "
          f"{a['bytes']:.4e} bytes) beside phase 3's graphed dense step "
          f"{step:.3f} ms: bound / step {a['bound_s'] * 1e3 / step:.3f} "
          f"({card})")
    t = out["anchors"]["train_step"]
    fw = training["full_width"]
    print(f"plan anchor train (qwen3-1.7b, 1 rank, {FULL_BATCH} x "
          f"{FULL_SEQ}, remat): dry-run {t['flops']:.4e} FLOPs beside phase "
          f"6's executed {fw['executed_flops']:.4e} (ratio "
          f"{t['flops'] / fw['executed_flops']:.3f}); dry-run peak "
          f"{t['peak_bytes'] / 1e9:.2f} GB beside max_memory_allocated "
          f"{fw['max_memory_gb']:.2f} GB (ratio "
          f"{t['peak_bytes'] / 1e9 / fw['max_memory_gb']:.3f}); dry-run "
          f"bound {t['bound_s'] * 1e3:.1f} ms ({t['dominant']}) beside the "
          f"{fw['median_step_ms']:.1f} ms step ({card})")
    out["anchor_ratios"] = {
        "decode_bound_over_step": a["bound_s"] * 1e3 / step,
        "train_flops_over_executed": t["flops"] / fw["executed_flops"],
        "train_peak_over_max_allocated":
            t["peak_bytes"] / 1e9 / fw["max_memory_gb"]}
    out["waited_s"] = waited
    print(f"phase 8 in {out['wall_s']:.1f} s in its own process beside "
          f"phases 3-7 (waited {waited:.1f} s after phase 7); no kernel "
          "launched")
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--kernels-only", action="store_true",
                    help="stop after phase 2 (build and kernel checks)")
    ap.add_argument("--planning", metavar="OUT",
                    help="run phase 8's host work alone, writing OUT")
    cli = ap.parse_args()
    if cli.planning:
        return planning_child(cli.planning)
    t_start = time.perf_counter()
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
    g3_model = Model(dataclasses.replace(g3cfg, n_layers=G3_DEPTH),
                     device=DEV)
    t0 = time.perf_counter()
    g3_params = g3_model.cast_params(g3_model.init(
        torch.Generator(device=DEV).manual_seed(0)))
    torch.cuda.synchronize()
    print(f"gemma3-1b full width ({G3_DEPTH} of {g3cfg.n_layers} layers "
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
    check_decode_long(torch, dec_ops, gen, g3_bs, report)
    check_decode_large(torch, dec_ops, gen, bs, report)
    check_decode_groups(torch, dec_ops, new_gen(torch, 31), bs, report)
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
    check_linked_mlp_large(torch, lm_ops, gen, get_config, report)
    check_split_matmul(torch, sm_ops, gen, report)
    result["kernels"] = report
    if cli.kernels_only:
        print(json.dumps(result, default=str))
        return 1   # a partial run is never a passing result

    # phase 8's host work runs beside phases 3-7, in its own process
    planning, plan_t0 = start_planning(out_dir)
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
    for arch, depth in RECURRENT_DEPTH.items():
        rcfg = get_config(arch)
        full_depth = rcfg.n_layers
        rcfg = dataclasses.replace(rcfg, n_layers=depth)
        rmodel = Model(rcfg, device=DEV)
        t0 = time.perf_counter()
        recurrent[arch] = (rmodel, rmodel.cast_params(rmodel.init(
            torch.Generator(device=DEV).manual_seed(0))))
        torch.cuda.synchronize()
        print(f"{arch} full width ({depth} of {full_depth} layers, d "
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
    gc.collect()
    torch.cuda.empty_cache()
    result["long_context"] = long_context_phase(torch, kernels, serve,
                                                Model, get_config, card)
    for arch, r in result["long_context"].items():
        runs[f"long_{arch}_batched"] = r["batched"]
        runs[f"long_{arch}_chunked"] = r["chunked"]
    gc.collect()
    torch.cuda.empty_cache()
    large = large_dense_phase(torch, kernels, serve, Model, get_config, card)
    runs.update(large["runs"])
    result["large_dense"] = large["models"]
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
    # the large dense decoders at 2 layers, full width: chatglm3-6b (G 16,
    # partial RoPE) and internlm2-20b without qk-norm, so at one layer's
    # fan-in as olmoe's; chameleon-34b with it
    for arch, fan_in in (("chatglm3-6b", True), ("internlm2-20b", True),
                         ("chameleon-34b", False)):
        result[f"parity_{arch.split('-')[0]}"] = parity_phase(
            torch, serve, pipeline, Model, get_config(arch),
            per_layer_fan_in=fan_in)
        torch.cuda.empty_cache()
    torch.cuda.empty_cache()

    plan, _ = pipeline.select_kernel_plan({"accelerator": "cuda"})
    if plan.linked_matmul != "cuda" or plan.split_matmul != "cuda":
        fail(f"the cuda kernel plan does not route linked_matmul and "
             f"split_matmul: {plan}")
    result["cnn"] = cnn_phase(
        torch, kernels, core, plan,
        cnn_graphs(cnn_zoo, optimize_graph, DeviceSpec.tms320c6678()))
    torch.cuda.empty_cache()
    print(f"held before phase 6: {torch.cuda.memory_allocated() / 1e9:.2f} "
          f"GB allocated ({card})")
    result["training"] = training_phase(torch, kernels, Model, get_config,
                                        plan, card)

    # phase 7: measured kernel-site routing and the d-Xenos collectives
    torch.cuda.empty_cache()
    result["bench"] = bench_phase(torch, kernels, pipeline, card)
    runs["autotune_bench"] = result["bench"]
    runs.update(routed_phase(torch, kernels, serve, pipeline, Model,
                             get_config, result["bench"]["qwen3"]["timings"],
                             card))
    torch.cuda.empty_cache()
    runs["kernel_tune"] = result["tune"] = tune_phase(torch, kernels, card)
    result["sync"] = sync_phase(torch, card)
    result["planning"] = planning_phase(planning, plan_t0, out_dir, runs,
                                        result["training"], card)
    before = dict(kernels.LAUNCHES)
    result["mesh_training"] = mesh_training_phase(
        torch, Model, get_config, result["planning"], card)
    if kernels.LAUNCHES != before:
        fail(f"phase 9 launched kernels: {kernels.LAUNCHES} (before "
             f"{before})")

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
        entry = {k: row[k] for k in (
            "name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")}
        if name == "linked_mlp":
            # the tensor-core kernel's three bodies: each one's launches
            # on the main path, and its time at a shape it serves beside
            # the decode body's there (the swap body at every decode shape
            # past d 2048 too)
            entry["name"] = ("linked_mlp (linked_mlp_tc_swap, linked_mlp_tc, "
                             "linked_mlp_tc_prefill)")
            ps = row["per_shape"]
            entry["bodies"] = {}
            for body, shape in (("linked_mlp_tc_swap", "decode"),
                                ("linked_mlp_tc", "prefill_c8"),
                                ("linked_mlp_tc_prefill", "batched_prefill")):
                entry["bodies"][body] = {
                    "launches": sum(r.get("launches", {}).get(body, 0)
                                    for r in runs.values()),
                    "shape": ps[shape]["shape"], "ms": ps[shape]["ms"],
                    "bound_ms": ps[shape]["bound_ms"],
                    "unlinked_ms": ps[shape]["unlinked_ms"]}
                if "decode_body" in ps[shape]:
                    entry["bodies"][body]["decode_body_ms"] = \
                        ps[shape]["decode_body"]["ms"]
            entry["bodies"]["linked_mlp_tc_swap"]["wide"] = {
                k: {f: r[f] for f in ("shape", "ms", "bound_ms",
                                      "unlinked_ms")}
                | {"decode_body_ms": r["decode_body"]["ms"]}
                for k, r in ps.items() if k.endswith("_decode")
                and r["shape"][1] > 2048 and "decode_body" in r}
        table.append(entry)
    result["table"] = table
    result["smoke_s"] = time.perf_counter() - t_start
    (out_dir / "chip_smoke.json").write_text(json.dumps(result, indent=1,
                                                        default=str))
    print(f"smoke in {result['smoke_s']:.1f} s ({card})")
    print(card)
    print(json.dumps({"kernels": table}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
