"""Quickstart of the port: the Xenos workflow end to end, the
counterpart of ``examples/quickstart.py``.

1. build a computation graph (the zoo's MobileNet),
2. run the automatic dataflow optimization (fusion -> linking -> DOS),
3. execute vanilla vs optimized and compare,
4. then the transformer side: a reduced assigned architecture through one
   train step and a few greedy decode steps.

    PYTHONPATH=src python -m repro_torch.launch.quickstart
    PYTHONPATH=src python -m repro_torch.launch.quickstart --device cpu

Runs on the card unless ``--device cpu``.  Ends with ``quickstart OK``;
vanilla and xenos disagreeing past the engine's tolerance exits 1.
"""
from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from .. import resolve_device
from ..configs import cnn_zoo
from ..configs.base import get_config
from ..core import DeviceSpec, Engine, init_params, pipeline
from ..core.linking import link_groups
from ..models.layers import tree_map
from ..models.model import Model


def cnn_side(dev: torch.device) -> bool:
    print("== Xenos graph optimization (the paper's CNN path) ==")
    g = cnn_zoo.build("mobilenet")
    # one entry point: the pass pipeline (fuse -> link -> DOS split), with
    # per-pass timing and verification built in
    opt, report = pipeline.optimize(g, DeviceSpec.tms320c6678())
    print(f"model={g.name}: {g.num_ops()} ops -> {opt.num_ops()} ops "
          f"in {report.total_s * 1e3:.1f} ms (Table-2 analogue)")
    linked = [n.op_type for n in opt.nodes
              if n.op_type in ("cbr", "cbra", "cbrm")]
    print(f"fused/linked ops: {linked}")
    print(f"link groups: {len(link_groups(opt))}")
    print(report.format())

    params = init_params(g, device=dev)
    x = torch.from_numpy(np.random.default_rng(0).normal(
        size=g.tensors[g.inputs[0]].shape).astype(np.float32)).to(dev)
    # the pipeline's output for xenos mode; vanilla runs the raw graph
    outs = {}
    for mode, graph in (("vanilla", g), ("xenos", opt)):
        eng = Engine(graph, mode)
        eng(params, x)                    # warm-up (and graph capture)
        t0 = time.perf_counter()
        outs[mode] = eng(params, x)[0].clone()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = time.perf_counter() - t0
        print(f"  {mode:8s}: {dt * 1e3:7.2f} ms  out[0,:3]="
              f"{outs[mode].cpu().numpy().ravel()[:3].round(4)}")
    # the reference's engine tolerance
    return torch.allclose(outs["xenos"], outs["vanilla"], rtol=3e-4,
                          atol=3e-5)


def transformer_side(dev: torch.device) -> None:
    print("\n== Assigned architecture (reduced) through the same framework ==")
    cfg = get_config("qwen3-1.7b").reduced()
    model = Model(cfg, device=dev)
    print(f"arch={cfg.name} family={cfg.family} "
          f"params={model.param_count():,}")
    state = model.init_train_state(
        torch.Generator(device=dev).manual_seed(0))
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(
        rng.integers(0, cfg.vocab, (4, 32)).astype(np.int32)).to(dev)
    state, metrics = model.train_step(state, {"tokens": toks,
                                              "labels": toks})
    print(f"one train step: loss={float(metrics['loss']):.4f}")

    params = tree_map(lambda t: t.detach(), state.params)
    with torch.no_grad():
        logits, caches = model.prefill_step(
            params, {"tokens": toks[:1, :16]}, max_len=64)
        out = []
        tok = logits[:, :cfg.vocab].argmax(-1)[:, None].to(torch.int32)
        for _ in range(8):
            logits, caches = model.serve_step(params, caches, tok)
            tok = logits[:, :cfg.vocab].argmax(-1)[:, None].to(torch.int32)
            out.append(int(tok[0, 0]))
    print(f"greedy decode after prefill: {out}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if not cnn_side(dev):
        print("FAIL: MobileNet vanilla and xenos disagree", file=sys.stderr)
        return 1
    transformer_side(dev)
    print("\nquickstart OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
