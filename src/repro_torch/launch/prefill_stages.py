"""Time the serving engine's two prefill stages on the card.

    PYTHONPATH=src python -m repro_torch.launch.prefill_stages

Full-width qwen3-1.7b (random weights, seed 0, the bf16 serving copy),
8 slots, max_len 2048, 16 prompts of 480-544 tokens, one new token
each, so that every tick prefills:

- ``chunked``: chunks of C tokens for every slot (M = 8 x C rows
  through each layer's MLP), C = 32 (the engine's first chunk) and 64
  (the chunk ``serve_schedule`` replans 512-token prompts to), never
  replanned; the stage is ``prefill_chunk``;
- ``batched``: 8 prompts admitted at a time and padded to the longest
  (M up to 8 x 544); the stage is ``admit``.

Each engine serves the requests three times, each on a new engine: to
warm up, for the stage's host time (``StageTimer``, closed by a
synchronize), and under ``torch.profiler`` for the device kernel time per
stage call (every kernel of the run over the stage's calls: the chunked
run's ticks also reset admitted rows, and a prompt's last chunk samples
its token).  Prints one JSON line.

It reaches only ``repro_torch.launch.serve``, the model and
``repro_torch.kernels``, so running this file with ``PYTHONPATH`` set to
another checkout's ``src`` times that checkout's engine.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys

import numpy as np
import torch

from repro_torch import kernels
from repro_torch.configs.base import get_config
from repro_torch.launch import serve
from repro_torch.models.model import Model

#: shortest and longest prompt
PROMPT_LENS = (480, 544)
#: chunk lengths of the chunked runs
CHUNKS = (32, 64)
REQUESTS, SEED = 16, 0
#: the engine stage each prefill mode times
STAGE = {"chunked": "prefill_chunk", "batched": "admit"}


def engine_args(mode: str, chunk: int):
    args = serve.build_parser().parse_args(["--arch", "qwen3-1.7b"])
    for k, v in dict(requests=REQUESTS, prompt_len=PROMPT_LENS[1],
                     max_new=1, slots=8, max_len=2048, chunk=chunk,
                     prefill_mode=mode, replan_every=10 ** 9,
                     seed=SEED).items():
        setattr(args, k, v)
    return args


def requests(args, vocab: int):
    reqs = serve.make_requests(args, vocab)
    rng = np.random.default_rng(args.seed + 1)
    for r in reqs:
        n = int(rng.integers(PROMPT_LENS[0], PROMPT_LENS[1] + 1))
        r.prompt = rng.integers(0, vocab, size=n).astype(np.int32)
    return reqs


def device_ms(prof) -> tuple[float, list]:
    """Total device kernel time of a profiled run, and its top kernels."""
    from torch.autograd import DeviceType
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = getattr(e, "self_cuda_time_total", 0.0)
        rows.append((us, e.key, e.count))
    rows.sort(reverse=True)
    return sum(r[0] for r in rows) / 1e3, rows[:6]


def run(model, params, args, profile: bool) -> dict:
    engine = serve.build_engine(args, model, params)
    reqs = requests(args, model.cfg.vocab)
    torch.cuda.synchronize()
    kernels.reset_launches()
    prof = None
    if profile:
        prof = torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA])
        prof.__enter__()
    for r in reqs:
        engine.submit(r)
    engine.run()
    torch.cuda.synchronize()
    if prof is not None:
        prof.__exit__(None, None, None)
    if not all(r.done for r in reqs):
        raise SystemExit(f"{args.prefill_mode}: not every request completed")
    stats = engine.stats()
    stage = stats["stages"][STAGE[args.prefill_mode]]
    out = {"calls": stage["calls"], "host_ms": stage["mean_s"] * 1e3,
           "plan": stats["plan"],
           "launches_per_call": {k: v / stage["calls"]
                                 for k, v in kernels.LAUNCHES.items() if v}}
    if prof is not None:
        total, top = device_ms(prof)
        out["device_ms"] = total / stage["calls"] if total else None
        out["top_kernels"] = [
            {"name": k[:60], "ms_per_call": us / 1e3 / stage["calls"],
             "calls_per_call": n / stage["calls"]} for us, k, n in top]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="", help="a name for the output")
    cli = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("prefill_stages times the card: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    kernels.build()
    model = Model(get_config("qwen3-1.7b"), device="cuda")
    params = model.cast_params(model.init(
        torch.Generator(device="cuda").manual_seed(SEED)))
    result = {"label": cli.label, "card": smi.stdout.strip(),
              "package": str(serve.__file__)}
    cases = [(f"chunked_c{c}", "chunked", c) for c in CHUNKS] + \
        [("batched", "batched", CHUNKS[0])]
    for name, mode, chunk in cases:
        args = engine_args(mode, chunk)
        run(model, params, args, profile=False)            # warm-up
        timed = run(model, params, args, profile=False)
        profiled = run(model, params, args, profile=True)
        timed.update({k: profiled[k] for k in ("device_ms", "top_kernels")})
        result[name] = timed
        print(f"{cli.label} {name}: {timed['calls']} {STAGE[mode]} calls, "
              f"host {timed['host_ms']:.2f} ms, device "
              f"{timed['device_ms']} ms per call; launches per call "
              f"{timed['launches_per_call']}", flush=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
