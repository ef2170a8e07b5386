"""Time the two GEMM kernels' plans at the main path's shapes on the card.

    PYTHONPATH=src python -m repro_torch.launch.gemm_timing

``split_matmul`` at bert_s's two DSP-plan FFN tiles (seq 128, d 768):
every (CTA shape, cluster size) the kernel takes, the planner's pick and
``torch.addmm``.  ``linked_mlp`` (bf16, d 2048, ff 6144, qwen3-1.7b's
MLP) at decode (M = 8), chunked prefill (M = 256, 512) and batched
prefill (M = 4352): the planner's pick, the FFMA kernel, the tensor-core
kernel at each ff split count S up to two waves of clusters (and S = 1),
and the unlinked three-matmul form; two weight sets rotate past the 50 MB L2.  Then, at
M = 256, 512 and 4352, each kernel's and the plain version's worst error
from the fp64-summed MLP in units of the bf16 limit (1e-3 + 2e-2 |ref|),
and the elements where the kernel and the plain version lie more than a
limit apart.  Device ms are CUDA events around calls queued behind a
spin kernel.  Prints one line per measurement and one JSON line.
"""
from __future__ import annotations

import json
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
D_MODEL, D_FF = 2048, 6144
MLP_ROWS = {"decode": 8, "prefill_c32": 256, "prefill_c64": 512,
            "batched": 4352}
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


def mlp_inputs(gen, M):
    rnd = lambda *s: torch.randn(s, generator=gen, device="cuda")
    bf = torch.bfloat16
    return (rnd(M, D_MODEL).to(bf),
            (rnd(D_MODEL, D_FF) / D_MODEL ** 0.5).to(bf),
            (rnd(D_MODEL, D_FF) / D_MODEL ** 0.5).to(bf),
            (rnd(D_FF, D_MODEL) / D_FF ** 0.5).to(bf))


def unlinked(x, wg, wu, wd):
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def time_mlp(gen, sms: int) -> dict:
    slots = lm.cluster_slots(torch.device("cuda", 0))
    cl = -(-D_MODEL // lm.TC_DS)
    out = {"slots": slots(cl)}
    print(f"linked_mlp_tc: {out['slots']} clusters of {cl} a wave")
    for label, M in MLP_ROWS.items():
        sets = [mlp_inputs(gen, M) for _ in range(2)]
        planned = lm.mlp_plan(M, D_MODEL, D_FF, torch.bfloat16, True, sms,
                              slots=slots)
        ffma = lm.mlp_plan(M, D_MODEL, D_FF, torch.bfloat16, True, sms,
                           path="ffma")
        row = {"planned": planned._asdict(),
               "ms": device_ms([lambda a=a: lm.linked_mlp(*a)
                                for a in sets]),
               "ffma_ms": device_ms([lambda a=a: lm.linked_mlp(
                   *a, plan=ffma) for a in sets]),
               "unlinked_ms": device_ms([lambda a=a: unlinked(*a)
                                         for a in sets]),
               "tc_ms": {}}
        m_tiles = -(-M // lm.TC_BM)
        for S in (1, 2, 3, 4, 6, 8, 12, 16):
            if S > 1 and m_tiles * S > 2 * out["slots"]:
                continue
            p = planned._replace(path="tc", S=S,
                                 workspace=S * M * D_MODEL if S > 1 else 0)
            row["tc_ms"][S] = device_ms(
                [lambda a=a, p=p: lm.linked_mlp(*a, plan=p) for a in sets])
        print(f"linked_mlp {label} M={M}: planned {tuple(planned)} "
              f"{row['ms']:.4f} ms, ffma {row['ffma_ms']:.4f} ms, unlinked "
              f"{row['unlinked_ms']:.4f} ms, tc by S "
              + ", ".join(f"{k}: {v:.4f}" for k, v in row["tc_ms"].items()),
              flush=True)
        out[label] = row
        del sets
    return out


def mlp_fp64(x, wg, wu, wd):
    x64, g64, u64, d64 = (a.double() for a in (x, wg, wu, wd))
    h = (F.silu(x64 @ g64) * (x64 @ u64)).to(x.dtype)
    return (h.double() @ d64).to(x.dtype)


def limits(got, ref) -> torch.Tensor:
    got, ref = got.float(), ref.float()
    return (got - ref).abs() / (TOL["atol"] + TOL["rtol"] * ref.abs())


def accuracy(gen, sms: int) -> dict:
    out = {}
    for label in ("prefill_c32", "prefill_c64", "batched"):
        M = MLP_ROWS[label]
        rows = []
        for _ in range(2):
            a = mlp_inputs(gen, M)
            ref = mlp_fp64(*a)
            plain = lm.linked_mlp_plain(*a)
            r = {"plain": limits(plain, ref).max().item()}
            for path in ("tc", "ffma"):
                got = lm.linked_mlp(*a, plan=lm.mlp_plan(
                    M, D_MODEL, D_FF, torch.bfloat16, True, sms, path=path,
                    slots=lm.cluster_slots(a[0].device)))
                r[path] = limits(got, ref).max().item()
                r[f"{path}_vs_plain_over"] = int(
                    (limits(got, plain) > 1).sum())
            rows.append(r)
            del a, ref, plain, got
        print(f"linked_mlp {label} worst err / limit from fp64: "
              + "; ".join(", ".join(f"{k} {v:.3f}" if isinstance(v, float)
                                    else f"{k} {v}" for k, v in r.items())
                          for r in rows), flush=True)
        out[label] = rows
    return out


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("gemm_timing times the card: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    kernels.build(("linked_mlp", "split_matmul"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    result = {"card": smi.stdout.strip(), "sms": sms,
              "split_matmul": time_split(gen, sms),
              "linked_mlp": time_mlp(gen, sms),
              "accuracy": accuracy(gen, sms)}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
