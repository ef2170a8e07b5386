"""Time the two GEMM kernels' plans at the main path's shapes on the card.

    PYTHONPATH=src python -m repro_torch.launch.gemm_timing
    PYTHONPATH=src python -m repro_torch.launch.gemm_timing --sweep
    PYTHONPATH=src python -m repro_torch.launch.gemm_timing --swap-grid
    PYTHONPATH=<tree>/src python src/repro_torch/launch/gemm_timing.py \\
        --planned --passes 2 --label parent

``split_matmul`` at bert_s's two DSP-plan FFN tiles (seq 128, d 768):
every (CTA shape, cluster size) the kernel takes, the planner's pick and
``torch.addmm``.  ``linked_mlp`` in bf16 at the shapes of ``MLP_SHAPES``
(qwen3-1.7b's decode, chunks and batched and one-shot prefill; gemma3-1b
and hymba-1.5b at decode and a 32-token chunk; the large decoders and
arctic-480b's dense residual at decode, a chunk and batched prefill):
the planned body, the decode body forced at the same shape where the
planner took the swap or the prefill body (the design before each), the
unlinked three-matmul form, the bound (bytes each read once over 3.35
TB/s, or FLOPs over the 989 TFLOP/s bf16 peak) and the body's share of
it; two weight sets rotate past the 50 MB L2.  Then, at decode rows and
at M = 256, 512 and 4352, each body that takes the shape and the plain
version: worst error from the fp64-summed MLP in units of the bf16 limit
(1e-3 + 2e-2 |ref|).

``--sweep``: the three tensor-core bodies forced by rows, 1 ... 1024,
over every served width (each where it takes the rows; ``mlp_plan``'s
``tc_body`` rule comes from it).
``--swap-grid``: the swap body at every decode shape of ``MLP_SHAPES``
under every (cluster size, ff splits) it takes within a wave, beside the
plan ``mlp_plan`` picks (its ``_swap_plan`` rule was fitted to these).
``--planned``: the planned kernel alone at every shape of
``MLP_SHAPES``, median of ``--passes`` passes, using only what every
tree of the port has (``linked_mlp`` and its plan), so the same script
times an earlier tree put first on ``PYTHONPATH`` (an A/B in one call).

Device ms are CUDA events around calls queued behind a spin kernel.
Prints one line per measurement and one JSON line.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.kernels.linked_matmul import ops as lm
from repro_torch.kernels.split_matmul import ops as sm

SPIN_CYCLES = 200_000_000
#: (M, K, N, block_n, block_k): bert_s's FFN tiles under the DSP spec
SPLIT_SHAPES = {"ffn1": (128, 768, 3072, 1024, 768),
                "ffn2": (128, 3072, 768, 256, 3072)}
#: H100 SXM data-sheet peaks: bytes/s and bf16 FLOP/s
HBM_BW, BF16_PEAK = 3.35e12, 989e12
#: linked_mlp's timed shapes (M, d, ff): qwen3-1.7b (2048, 6144) at
#: decode (8 slots), 8-slot chunks of 8, 32 and 64 tokens, batched prefill
#: (8 x 544) and the one-shot 31,744-token prompt; gemma3-1b, hymba-1.5b,
#: the large dense decoders and arctic-480b's dense residual at decode and
#: a 32-token chunk; chatglm3-6b and internlm2-20b at batched prefill
MLP_SHAPES = {"qwen3_decode": (8, 2048, 6144),
              "qwen3_c8": (64, 2048, 6144),
              "qwen3_c32": (256, 2048, 6144),
              "qwen3_c64": (512, 2048, 6144),
              "qwen3_batched": (4352, 2048, 6144),
              "qwen3_long": (31744, 2048, 6144),
              "gemma3_decode": (8, 1152, 6912),
              "gemma3_c32": (256, 1152, 6912),
              "hymba_decode": (8, 1600, 5504),
              "hymba_c32": (256, 1600, 5504),
              "chatglm3_decode": (8, 4096, 13696),
              "chatglm3_c32": (256, 4096, 13696),
              "granite_decode": (8, 4096, 14336),
              "granite_c32": (256, 4096, 14336),
              "internlm2_decode": (8, 6144, 16384),
              "internlm2_c32": (256, 6144, 16384),
              "chameleon_decode": (8, 8192, 22016),
              "chameleon_c32": (256, 8192, 22016),
              "arctic_residual_decode": (8, 7168, 4864),
              "chatglm3_batched": (4352, 4096, 13696),
              "internlm2_batched": (4352, 6144, 16384)}
#: --sweep: rows and widths
SWEEP_ROWS = (1, 8, 16, 24, 32, 40, 48, 64, 96, 128, 192, 256, 384, 512,
              1024)
SWEEP_WIDTHS = {"qwen3": (2048, 6144), "gemma3": (1152, 6912),
                "hymba": (1600, 5504), "chatglm3": (4096, 13696),
                "internlm2": (6144, 16384), "chameleon": (8192, 22016),
                "arctic": (7168, 4864)}
#: the tensor-core bodies, and the rows each is forced at in --sweep
BODIES = {"swap": lambda M, d: bool(lm.swap_clusters(M, d)),
          "decode": lambda M, d: True, "prefill": lambda M, d: M >= 16}
TOL = dict(rtol=2e-2, atol=1e-3)


def device_ms(fns, iters: int = 20, warmup: int = 3) -> float:
    """Device ms per call, cycling through ``fns``, behind a spin kernel."""
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


def iters_for(M: int, d: int, ff: int) -> int:
    """Fewer calls where one takes milliseconds."""
    return 20 if M * d * ff < 2e11 else 5


def time_split(gen, sms: int) -> dict:
    out = {}
    for label, (M, K, N, bn, bk) in SPLIT_SHAPES.items():
        x = torch.randn((M, K), generator=gen, device="cuda")
        w = torch.randn((K, N), generator=gen, device="cuda") / K ** 0.5
        b = torch.randn((N,), generator=gen, device="cuda")
        picked = sm.split_plan(M, N, K, bn, bk, sms)
        row = {"planned": picked._asdict(), "plans": {}}
        for bm, kh in sm.SHAPES:
            for cl in sm.CL_CHOICES:
                p = picked._replace(bm=bm, kh=kh, cl=cl)
                row["plans"][f"bm{bm}_kh{kh}_cl{cl}"] = device_ms(
                    [lambda p=p: sm.split_matmul(x, w, b, block_n=bn,
                                                 block_k=bk, plan=p)])
        row["ms"] = device_ms([lambda: sm.split_matmul(x, w, b, block_n=bn,
                                                       block_k=bk)])
        row["addmm_ms"] = device_ms([lambda: torch.addmm(b, x, w)])
        print(f"split_matmul {label}: planned {tuple(picked)} "
              f"{row['ms']:.4f} ms, addmm {row['addmm_ms']:.4f} ms; "
              + ", ".join(f"{k} {v:.4f}" for k, v in row["plans"].items()),
              flush=True)
        out[label] = row
    return out


def mlp_inputs(gen, M, d, ff):
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    bf = torch.bfloat16
    return (rnd(M, d).to(bf), (rnd(d, ff) / d ** 0.5).to(bf),
            (rnd(d, ff) / d ** 0.5).to(bf), (rnd(ff, d) / ff ** 0.5).to(bf))


def unlinked(x, wg, wu, wd):
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def bound(M: int, d: int, ff: int) -> tuple[float, str]:
    """The least ms for the MLP on the card: its bytes (x, the three
    weights and y once each) or its matmuls' FLOPs at the bf16 peak."""
    t_bytes = 2 * (3 * d * ff + 2 * M * d) / HBM_BW
    t_ops = (6 * M * d * ff + 4 * M * ff) / BF16_PEAK
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def forced(M, d, ff, sms, slots, body):
    return lm.mlp_plan(M, d, ff, torch.bfloat16, True, sms, path="tc",
                       slots=slots, body=body)


def time_mlp(gen, sms: int) -> dict:
    """Every shape of MLP_SHAPES: the planned body beside the decode body
    forced (where the planner took another), the unlinked form and the
    bound."""
    slots = lm.cluster_slots(torch.device("cuda", 0))
    out = {"slots": {cl: slots(cl) for cl in (5, 7, 8, 9, 13, 16)}}
    print(f"linked_mlp: clusters a wave {out['slots']}", flush=True)
    for label, (M, d, ff) in MLP_SHAPES.items():
        sets = [mlp_inputs(gen, M, d, ff) for _ in range(2)]
        n = iters_for(M, d, ff)
        planned = lm.mlp_plan(M, d, ff, torch.bfloat16, True, sms,
                              slots=slots)
        b_ms, b_by = bound(M, d, ff)
        row = {"shape": [M, d, ff], "planned": planned._asdict(),
               "ms": device_ms([lambda a=a: lm.linked_mlp(*a)
                                for a in sets], iters=n),
               "unlinked_ms": device_ms([lambda a=a: unlinked(*a)
                                         for a in sets], iters=n),
               "bound_ms": b_ms, "bound_by": b_by}
        row["share"] = b_ms / row["ms"]
        if planned.body in ("prefill", "swap"):
            dplan = forced(M, d, ff, sms, slots, "decode")
            row["decode_body"] = {"plan": dplan._asdict(), "ms": device_ms(
                [lambda a=a: lm.linked_mlp(*a, plan=dplan) for a in sets],
                iters=n)}
        print(f"linked_mlp {label} ({M},{d},{ff}): {planned.body} body "
              f"{tuple(planned)} {row['ms']:.4f} ms, bound {b_ms:.4f} ms "
              f"({b_by}), share {row['share']:.3f}, unlinked "
              f"{row['unlinked_ms']:.4f} ms"
              + (f", decode body forced {row['decode_body']['ms']:.4f} ms"
                 if "decode_body" in row else ""), flush=True)
        out[label] = row
        del sets
        torch.cuda.empty_cache()
    return out


def sweep(gen, sms: int) -> dict:
    """The bodies forced, by rows, at the served widths (each body where
    it takes the rows: ``BODIES``), beside the unlinked form up to 64
    rows."""
    slots = lm.cluster_slots(torch.device("cuda", 0))
    out = {}
    for name, (d, ff) in SWEEP_WIDTHS.items():
        for M in SWEEP_ROWS:
            sets = [mlp_inputs(gen, M, d, ff) for _ in range(2)]
            n = iters_for(M, d, ff)
            row = {body: device_ms([lambda a=a, p=forced(
                M, d, ff, sms, slots, body): lm.linked_mlp(*a, plan=p)
                for a in sets], iters=n)
                for body, takes in BODIES.items() if takes(M, d)}
            if M <= 64:
                row["unlinked"] = device_ms([lambda a=a: unlinked(*a)
                                             for a in sets], iters=n)
            print(f"linked_mlp sweep {name} M={M}: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in row.items()), flush=True)
            out[f"{name}_{M}"] = row
            del sets
            torch.cuda.empty_cache()
    return out


def swap_grid(gen, sms: int) -> dict:
    """The swap body at every decode shape under every (cl, S) with S from
    a third of a wave to a wave, beside the planned one."""
    slots = lm.cluster_slots(torch.device("cuda", 0))
    out = {}
    for label, (M, d, ff) in MLP_SHAPES.items():
        if not label.endswith("_decode"):
            continue
        sets = [mlp_inputs(gen, M, d, ff) for _ in range(2)]
        n_blocks = -(-ff // lm.TC_BF)
        planned = lm.mlp_plan(M, d, ff, torch.bfloat16, True, sms,
                              slots=slots)
        grid = {}
        for cl in lm.swap_clusters(M, d):
            wave = min(n_blocks, slots(cl))
            for S in range(max(1, wave // 3), wave + 1):
                p = lm.MlpPlan("tc", lm.swap_rows(M), cl, S, 8,
                               S * M * d if S > 1 else 0, "swap")
                grid[f"{cl}/{S}"] = device_ms([lambda a=a, p=p: lm.linked_mlp(
                    *a, plan=p) for a in sets], iters=10)
        best = sorted(grid.items(), key=lambda kv: kv[1])[:5]
        key = f"{planned.cl}/{planned.S}"
        print(f"linked_mlp swap grid {label} ({M},{d},{ff}): planned {key} "
              f"{grid[key]:.4f} ms ({grid[key] / best[0][1]:.3f} of the "
              f"best); best " + ", ".join(f"{k} {v:.4f}" for k, v in best),
              flush=True)
        out[label] = {"planned": key, "grid": grid}
        del sets
    return out


def planned_passes(gen, passes: int, label: str) -> dict:
    """The planned kernel at every shape, ``passes`` passes over the
    shapes, the median a shape."""
    data = {k: [mlp_inputs(gen, *shape) for _ in range(2)]
            for k, shape in MLP_SHAPES.items() if shape[0] < 8192}
    runs: dict = {k: [] for k in MLP_SHAPES}
    for _ in range(passes):
        for k, shape in MLP_SHAPES.items():
            sets = data.get(k) or [mlp_inputs(gen, *shape)]
            runs[k].append(device_ms([lambda a=a: lm.linked_mlp(*a)
                                      for a in sets],
                                     iters=iters_for(*shape)))
            if k not in data:
                del sets
                torch.cuda.empty_cache()
    out = {k: statistics.median(v) for k, v in runs.items()}
    for k, v in out.items():
        print(f"linked_mlp planned {label} {k} {MLP_SHAPES[k]}: {v:.4f} ms "
              f"(passes {', '.join(f'{t:.4f}' for t in runs[k])})",
              flush=True)
    return out


def mlp_fp64(x, wg, wu, wd):
    x64, g64, u64, d64 = (a.double() for a in (x, wg, wu, wd))
    h = (F.silu(x64 @ g64) * (x64 @ u64)).to(x.dtype)
    return (h.double() @ d64).to(x.dtype)


def limits(got, ref) -> torch.Tensor:
    got, ref = got.float(), ref.float()
    return (got - ref).abs() / (TOL["atol"] + TOL["rtol"] * ref.abs())


def accuracy(gen, sms: int) -> dict:
    """Each body's (where it takes the shape) and the plain version's
    worst error from the fp64-summed MLP (units of the bf16 limit), at
    qwen3's and chameleon-34b's decode and qwen3's chunks and batched
    prefill."""
    slots = lm.cluster_slots(torch.device("cuda", 0))
    out = {}
    for label in ("qwen3_decode", "chameleon_decode", "qwen3_c32",
                  "qwen3_c64", "qwen3_batched"):
        M, d, ff = MLP_SHAPES[label]
        rows = []
        for _ in range(2):
            a = mlp_inputs(gen, M, d, ff)
            ref = mlp_fp64(*a)
            r = {"plain": limits(lm.linked_mlp_plain(*a), ref).max().item()}
            for body in [b for b, takes in BODIES.items() if takes(M, d)]:
                got = lm.linked_mlp(*a, plan=forced(M, d, ff, sms, slots,
                                                    body))
                r[body] = limits(got, ref).max().item()
            rows.append(r)
            del a, ref, got
        print(f"linked_mlp {label} worst err / limit from fp64: "
              + "; ".join(", ".join(f"{k} {v:.3f}" for k, v in r.items())
                          for r in rows), flush=True)
        out[label] = rows
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="both tensor-core bodies by rows")
    ap.add_argument("--swap-grid", action="store_true",
                    help="the swap body under every (cluster, splits)")
    ap.add_argument("--planned", action="store_true",
                    help="the planned kernel alone at every shape")
    ap.add_argument("--passes", type=int, default=1)
    ap.add_argument("--label", default="this tree")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("gemm_timing times the card: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    kernels.build(("linked_mlp",) if args.planned or args.sweep
                  or args.swap_grid else ("linked_mlp", "split_matmul"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"card": smi.stdout.strip(), "sms": sms, "label": args.label}
    if args.planned:
        result["planned"] = planned_passes(gen, args.passes, args.label)
    elif args.sweep:
        result["sweep"] = sweep(gen, sms)
    elif args.swap_grid:
        result["swap_grid"] = swap_grid(gen, sms)
    else:
        result.update({"split_matmul": time_split(gen, sms),
                       "linked_mlp": time_mlp(gen, sms),
                       "accuracy": accuracy(gen, sms)})
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
