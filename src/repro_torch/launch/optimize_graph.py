"""Graph-optimization walkthrough of the port: the paper's CNN path on the
card (the counterpart of ``examples/optimize_graph.py`` and of the CNN
half of ``examples/quickstart.py``).

    PYTHONPATH=src python -m repro_torch.launch.optimize_graph
    PYTHONPATH=src python -m repro_torch.launch.optimize_graph --device cpu

1. The paper's Figure-5 graph (Conv1x1 -> Bn -> Bias -> Relu -> AvgPool2)
   through the pass pipeline: pattern identification, CBR fusion,
   operator linking into a ``cbra`` op, DOS split plans, the PassReport.
2. vanilla == xenos on that graph, and the xenos run under the ``cuda``
   kernel plan, which routes the ``cbra`` op to the ``cbr_avgpool`` kernel
   (on CPU tensors its wrapper runs the plain version).
3. The zoo's MobileNet through the pipeline, vanilla vs xenos.
4. d-Xenos planning: the ``dxenos_plan`` pass and the 4-device scheme
   table (Algorithm 1 over Figure 6's schemes, modeled).

Ends with ``optimize_graph OK``; any disagreement exits nonzero.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .. import kernels, resolve_device
from ..configs import cnn_zoo
from ..core import DeviceSpec, Graph, build_engine, execute, init_params
from ..core import dos, patterns, pipeline, planner
from ..core import graph as G


def fig5_graph() -> Graph:
    """The paper's Figure-5 example: Conv1x1 -> Bn -> Bias -> Relu ->
    AvgPool, (1,16,16,64) -> 128 channels."""
    g = Graph("fig5")
    x = g.add_input("fm", (1, 16, 16, 64))
    y = G.conv2d(g, x, 128, 1, name="conv1x1")
    y = G.bn(g, y)
    y = G.bias(g, y)
    y = G.relu(g, y)
    y = G.pool(g, y, "avg", 2)
    g.mark_output(y)
    return g


def cbra_graph(name: str, shape: tuple[int, int, int, int],
               out_c: int) -> Graph:
    """Conv1x1 -> Bn -> Relu -> AvgPool2 on an NHWC ``shape`` input: the
    chain that links into one ``cbra`` op (Table 4's CBRA operator)."""
    g = Graph(name)
    x = g.add_input("x", shape)
    y = G.conv2d(g, x, out_c, 1)
    y = G.bn(g, y)
    y = G.relu(g, y)
    y = G.pool(g, y, "avg", 2)
    g.mark_output(y)
    return g


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.float() - b.float()).abs().max())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    g = fig5_graph()
    print(f"input graph: {[n.op_type for n in g.nodes]}")
    ident = patterns.identify(g)
    print(f"identified fusions: {[m.nodes for m in ident['fusions']]}")
    opt, report = pipeline.optimize(g, DeviceSpec.tms320c6678())
    print(f"after the pipeline (Fig 5a/5b, CBRA): "
          f"{[n.op_type for n in opt.nodes]}")
    cbra = next(n for n in opt.nodes if n.op_type == "cbra")
    print(f"  linked-op dataflow metadata: {cbra.dataflow}")
    for name, plan in dos.plans(opt).items():
        print(f"DOS plan for {name} (Fig 5d/e): fmap_parts={plan.fmap_parts} "
              f"param_chunks={plan.param_chunks} fits_l2={plan.fits_l2}")
    print(report.format())

    params = init_params(g, device=dev)
    x = {"fm": np.random.default_rng(0).normal(
        size=(1, 16, 16, 64)).astype(np.float32)}
    a = execute(g, params, x, mode="vanilla")[0].clone()
    b = execute(opt, params, x, mode="xenos")[0].clone()
    err = _max_err(a, b)
    print(f"optimized == original on {dev.type}: max err {err:.2e}")
    if not err < 1e-4:
        print("FAIL: vanilla and xenos disagree", file=sys.stderr)
        return 1

    kplan, _ = pipeline.select_kernel_plan({"accelerator": "cuda"})
    eng, _ = build_engine(g, "xenos", plan=kplan)
    kernels.reset_launches()
    c = eng(params, torch.from_numpy(x["fm"]).to(dev))[0].clone()
    launched = kernels.LAUNCHES["cbr_avgpool"]
    err = _max_err(a, c)
    print(f"xenos under the cuda kernel plan (linked_matmul="
          f"{kplan.linked_matmul}): max err vs vanilla {err:.2e}, "
          f"cbr_avgpool launches {launched}")
    if not err < 1e-4 or (dev.type == "cuda" and launched < 1):
        print("FAIL: the routed cbra op disagrees or never launched",
              file=sys.stderr)
        return 1

    print("\n== the zoo's MobileNet (reduced) through the same pipeline ==")
    mg = cnn_zoo.build("mobilenet")
    mopt, mreport = pipeline.optimize(mg, DeviceSpec.tms320c6678())
    linked = [n.op_type for n in mopt.nodes
              if n.op_type in ("cbr", "cbra", "cbrm")]
    print(f"model={mg.name}: {mg.num_ops()} ops -> {mopt.num_ops()} ops in "
          f"{mreport.total_s * 1e3:.1f} ms; fused/linked ops {linked}")
    mparams = init_params(mg, device=dev)
    mx = torch.from_numpy(np.random.default_rng(0).normal(
        size=mg.tensors[mg.inputs[0]].shape).astype(np.float32)).to(dev)
    outs = {}
    for mode in ("vanilla", "xenos"):
        eng, _ = build_engine(mg, mode, plan=kplan)
        eng(mparams, mx)                      # warm-up (and graph capture)
        t0 = time.perf_counter()
        outs[mode] = eng(mparams, mx)[0].clone()
        dt = time.perf_counter() - t0
        print(f"  {mode:8s}: {dt * 1e3:7.2f} ms on {dev.type}  out[0,:3]="
              f"{outs[mode].cpu().numpy().ravel()[:3].round(4)}")
    if not torch.allclose(outs["xenos"], outs["vanilla"], rtol=3e-4,
                          atol=3e-5):     # the reference's engine tolerance
        print("FAIL: MobileNet vanilla and xenos disagree", file=sys.stderr)
        return 1

    _, dreport = pipeline.optimize(
        g, passes=("dxenos_plan",), options={"n_devices": 4})
    print(f"\ndxenos_plan pass: {dreport.passes[0].summary}")
    best, _, all_t = planner.plan_distributed(g, n_devices=4)
    print("d-Xenos schemes (4 devices, modeled with H100 constants):")
    for k, v in sorted(all_t.items(), key=lambda kv: kv[1]):
        mark = " <= best" if k == str(best) else ""
        print(f"  {k:24s} {v * 1e6:9.3f} us{mark}")
    print("optimize_graph OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
