"""Time ``fused_mask`` and ``cbr_avgpool`` at every plan on the card.

    PYTHONPATH=src python -m repro_torch.launch.mask_cbra_timing
    PYTHONPATH=<other checkout>/src python \
        src/repro_torch/launch/mask_cbra_timing.py --wrappers-only

``fused_mask`` at the served rows (8 x 151,936 fp32, a slice of rows
padded by 128, as the LM head leaves them) under three policies: served
(T 0.8, top-k 50, top-p 0.95), greedy (no filter: one read, one write)
and top-p only (T 0.8, k 0, p 0.9); at every cluster size that holds a
row, with the top-p list (``cap`` 256) and with the radix path over the
masses forced (``cap`` 0); then at B = 1 and 64, the planner's pick and
every cluster size with the list; and the clusters of each size the card
holds one CTA an SM (the planner's ``solo``).
``cbr_avgpool`` at the Figure-5 example and the two Table-4 CBRA
operators: every (CTA shape, cluster size, ring depth, square tiles a
CTA walks) ``cbra_plans`` lists, the planner's pick, its plain version
and the unlinked form (``addmm``, ``relu_``, ``avg_pool2d``).
``--wrappers-only`` times each wrapper as the imported checkout calls it
(its own launch choice), beside the plain and unlinked forms, and needs
no planner: run as a script with another checkout's ``src`` on
PYTHONPATH, it times that checkout's kernels (with that checkout's
``launch/gemm_timing.device_ms``: CUDA events around calls queued behind
a spin kernel).  Prints one line per measurement and one JSON line.
"""
from __future__ import annotations

import argparse
import json
import subprocess

import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.kernels.fused_sampler import ops as fs
from repro_torch.kernels.linked_cbr_pool import ops as cb
from repro_torch.launch.gemm_timing import device_ms

B, V = 8, 151936
#: (T, top_k, top_p) of the three timed policies
POLICIES = {"served": (0.8, 50, 0.95), "greedy": (0.0, 0, 1.0),
            "top_p": (0.8, 0, 0.9)}
#: (N, H, W, C, OC): the Figure-5 example and the Table-4 CBRA operators
CBRA_SHAPES = {"fig5": (1, 16, 16, 64, 128), "t4_8x8": (1, 8, 8, 1024, 1024),
               "t4_224": (1, 224, 224, 24, 224)}


def policy(rows: int, t: float, k: int, p: float):
    return (torch.full((rows,), t, device="cuda"),
            torch.full((rows,), k, dtype=torch.int32, device="cuda"),
            torch.full((rows,), p, device="cuda"))


def time_mask(gen, sms: int, plans: bool) -> dict:
    out = {}
    logits = torch.randn((64, V + 128), generator=gen, device="cuda") * 3
    for label, pol in POLICIES.items():
        args = {b: (logits[:b, :V], *policy(b, *pol)) for b in (1, B, 64)}
        row = {"plans": {}, "ms": device_ms(
            [lambda: fs.fused_mask(*args[B])], iters=30)}
        for b in (1, 64):
            row[f"B{b}_ms"] = device_ms(
                [lambda b=b: fs.fused_mask(*args[b])], iters=30)
        if not plans:
            print(f"fused_mask {label}: {row['ms']:.4f} ms (B 1 "
                  f"{row['B1_ms']:.4f}, B 64 {row['B64_ms']:.4f})",
                  flush=True)
            out[label] = row
            continue
        solo = fs.solo_clusters(torch.device("cuda", 0))
        row["solo_clusters"] = {cl: solo(cl) for cl in fs.CL_CHOICES}
        planned = fs.mask_plan(B, V, sms, solo=solo)
        row["planned"] = planned._asdict()
        for b in (1, 64):
            row[f"B{b}_plan"] = fs.mask_plan(b, V, sms, solo=solo)._asdict()
        # every cluster that holds a row: at B = 8 with the list and with
        # the radix path forced, at B = 1 and 64 with the list
        for b in (B, 1, 64):
            for cl in fs.CL_CHOICES:
                chunk = -(-V // (4 * cl)) * 4
                if fs.mask_smem(chunk) > kernels.CTA_SMEM_MAX:
                    continue
                for cap in (fs.CAP, 0) if b == B else (fs.CAP,):
                    p = fs.MaskPlan(cl, chunk, cap)
                    key = f"cl{cl}_cap{cap}" if b == B else f"B{b}_cl{cl}"
                    row["plans"][key] = device_ms(
                        [lambda b=b, p=p: fs.fused_mask(*args[b], plan=p)],
                        iters=30)
        print(f"fused_mask {label}: clusters held one CTA an SM "
              f"{row['solo_clusters']}; planned {tuple(planned)} "
              f"{row['ms']:.4f} ms (B 1 {row['B1_ms']:.4f}, B 64 "
              f"{row['B64_ms']:.4f}); "
              + ", ".join(f"{k} {v:.4f}" for k, v in row["plans"].items()),
              flush=True)
        out[label] = row
    return out


def unlinked(x, w, b):
    N, H, W, C = x.shape
    y = torch.addmm(b, x.reshape(-1, C), w).relu_()
    return F.avg_pool2d(y.view(N, H, W, -1).permute(0, 3, 1, 2),
                        2).permute(0, 2, 3, 1)


def time_cbra(gen, sms: int, plans: bool) -> dict:
    out = {}
    for label, (N, H, W, C, OC) in CBRA_SHAPES.items():
        x = torch.randn((N, H, W, C), generator=gen, device="cuda")
        w = torch.randn((C, OC), generator=gen, device="cuda") / C ** 0.5
        b = torch.randn((OC,), generator=gen, device="cuda") * 0.1
        row = {"plans": {}, "ms": device_ms(
            [lambda: cb.cbr_avgpool(x, w, b)], iters=30),
            "plain_ms": device_ms(
                [lambda: cb.cbr_avgpool_plain(x, w, b)], iters=30),
            "unlinked_ms": device_ms([lambda: unlinked(x, w, b)], iters=30)}
        if not plans:
            print(f"cbr_avgpool {label}: {row['ms']:.4f} ms, plain "
                  f"{row['plain_ms']:.4f}, unlinked {row['unlinked_ms']:.4f}",
                  flush=True)
            out[label] = row
            continue
        planned = cb.cbra_plan(N, H, W, C, OC, sms)
        row["planned"] = planned._asdict()
        names = {v: k for k, v in cb.SHAPES.items()}
        for p in cb.cbra_plans(N, H, W, C, OC, sms):
            walk = -(-p.sq_tiles // p.sq_ctas)
            key = (f"{names[p.txn, p.tyn, p.kh, p.tsq]}_cl{p.cl}"
                   f"_st{p.stages}_walk{walk}")
            row["plans"][key] = device_ms(
                [lambda p=p: cb.cbr_avgpool(x, w, b, plan=p)], iters=30)
        best = min(row["plans"], key=row["plans"].get)
        print(f"cbr_avgpool {label}: planned {tuple(planned)} "
              f"{row['ms']:.4f} ms, best {best} {row['plans'][best]:.4f}, "
              f"plain {row['plain_ms']:.4f}, unlinked "
              f"{row['unlinked_ms']:.4f}; "
              + ", ".join(f"{k} {v:.4f}" for k, v in row["plans"].items()),
              flush=True)
        out[label] = row
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--wrappers-only", action="store_true",
                    help="time each wrapper's own launch, no plan list")
    cli = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("mask_cbra_timing times the card: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    kernels.build(("fused_sampler", "linked_cbr_pool"))
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    plans = not cli.wrappers_only
    result = {"card": smi.stdout.strip(), "sms": sms,
              "source": kernels.__file__,
              "fused_mask": time_mask(gen, sms, plans),
              "cbr_avgpool": time_cbra(gen, sms, plans)}
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
