"""Long sequences on a CUDA card, for the PyTorch port (``repro_torch``):
the one-shot prefill of a long prompt and a train step at a long
sequence, each as the model runs it (``chunked_attention`` past 2048
tokens where the checkout has the scan) and, with ``--full``, with
``full_attention`` forced through the attention's ``use_chunked=False``.

    PYTHONPATH=src python tools/long_context_probe.py \\
        --arch qwen3-1.7b --prefill 31744 --train 1x4096 --full

Run by path, it measures whichever checkout ``PYTHONPATH`` points at:
an older one, without the scan, runs full attention (leave ``--full``
out there).  Full width, random weights from ``--seed``; the prefill in
bf16 under the model's default kernel plan, the train step as
``chip_smoke.py``'s phase 6 trains (fp32 params and moments, bf16
compute, remat on).  A case that runs out of device memory is reported
with the allocator's message.  Prints one JSON line a case: wall ms
(synchronized; the train step's is its second step),
``max_memory_allocated`` from a reset before the case, and the bytes
held before it.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import gc
import json
import sys
import time

import numpy as np
import torch

from repro_torch.configs.base import get_config
from repro_torch.models import attention as A
from repro_torch.models.model import Model


@contextlib.contextmanager
def full_attention_blocks():
    """Every whole-sequence attention block with ``use_chunked=False``
    while inside (the train step's path to the switch)."""
    real = A.attention_block
    A.attention_block = functools.partial(real, use_chunked=False)
    try:
        yield
    finally:
        A.attention_block = real


def _case(fn, dev) -> dict:
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.synchronize(dev)
    held = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    out = {"held_gb": held / 1e9}
    try:
        out["wall_ms"] = fn()
        out["peak_gb"] = torch.cuda.max_memory_allocated(dev) / 1e9
    except torch.cuda.OutOfMemoryError as e:
        out["oom"] = str(e).splitlines()[0]
        out["peak_gb_before_oom"] = torch.cuda.max_memory_allocated(dev) / 1e9
    gc.collect()
    torch.cuda.empty_cache()
    return out


def prefill_case(model, params, n: int, seed: int, full: bool, dev) -> dict:
    toks = torch.from_numpy(np.random.default_rng(seed).integers(
        0, model.cfg.vocab, (1, n)).astype(np.int64)).to(dev)
    kw = {"use_chunked": False} if full else {}

    def run():
        with torch.no_grad():
            t0 = time.perf_counter()
            logits, caches = model.prefill_step(params, {"tokens": toks},
                                                max_len=n, **kw)
            torch.cuda.synchronize(dev)
            ms = (time.perf_counter() - t0) * 1e3
            if not torch.isfinite(logits).all():
                raise RuntimeError("non-finite prefill logits")
            del logits, caches
        return ms
    return _case(run, dev)


def train_case(model, state, B: int, S: int, seed: int, full: bool,
               dev) -> dict:
    toks = np.random.default_rng(seed).integers(0, model.cfg.vocab,
                                                (B, S + 1))
    batch = {"tokens": torch.from_numpy(toks[:, :-1].astype(np.int32)),
             "labels": torch.from_numpy(toks[:, 1:].astype(np.int32))}

    def run():
        ms = []
        for _ in range(2):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            _, metrics = model.train_step(state, batch)
            torch.cuda.synchronize(dev)
            ms.append((time.perf_counter() - t0) * 1e3)
            if not np.isfinite(float(metrics["loss"])):
                raise RuntimeError("non-finite loss")
        return ms[-1]
    with full_attention_blocks() if full else contextlib.nullcontext():
        return _case(run, dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-1.7b")
    ap.add_argument("--prefill", type=int, default=0,
                    help="prompt tokens of a one-shot prefill (0: none)")
    ap.add_argument("--train", default="",
                    help="BxS of a train step (empty: none)")
    ap.add_argument("--full", action="store_true",
                    help="also each case with full_attention forced")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("FAIL: the peaks are a card's: run on a CUDA device",
              file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config(args.arch)
    modes = [False, True] if args.full else [False]
    head = {"arch": args.arch, "card": torch.cuda.get_device_name(dev),
            "torch": torch.__version__}
    if args.prefill:
        model = Model(cfg, device=dev)
        params = model.cast_params(model.init(
            torch.Generator(device=dev).manual_seed(args.seed)))
        for full in modes:
            rec = prefill_case(model, params, args.prefill, args.seed, full,
                               dev)
            print(json.dumps({**head, "case": "prefill",
                              "tokens": args.prefill,
                              "attention": "full" if full else "default",
                              **rec}), flush=True)
        del model, params
    if args.train:
        B, S = (int(x) for x in args.train.split("x"))
        model = Model(cfg, device=dev)
        state = model.init_train_state(
            torch.Generator(device=dev).manual_seed(args.seed))
        for full in modes:
            rec = train_case(model, state, B, S, args.seed, full, dev)
            print(json.dumps({**head, "case": "train", "batch": B,
                              "seq": S,
                              "attention": "full" if full else "default",
                              **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
