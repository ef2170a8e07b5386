"""End-to-end training driver of the port, on one device (the card by
default).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --reduced --steps 50 --batch 8 --seq 128

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \
        --reduced --steps 8 --batch 4 --seq 32 --device cpu

The same flags and printed lines as ``python -m repro.launch.train``,
plus ``--device``: the ``arch=... params=...`` line, a ``step ... loss
... gnorm ...`` line every ``--log-every`` steps and at the last, and
``loss a -> b (improved|NOT improved)`` over the means of the first and
last five losses.  Weights are random, drawn on the device from
``--seed``; the data is ``SyntheticLM(vocab, --seq, seed=--seed)``; the
lr follows ``cosine_schedule`` (``--lr`` peak, ``--warmup``, over
``--steps``).  ``--ckpt-dir`` with ``--ckpt-every N`` saves the params
every N steps in the reference's checkpoint layout.  ``--mesh`` other
than ``none`` (sharded training) is not ported yet: ROADMAP queue 1 item
10b.
"""
from __future__ import annotations

import argparse
import time
from functools import partial

import numpy as np
import torch

from ..checkpoint import save_checkpoint
from ..configs.base import get_config
from ..data import SyntheticLM, make_train_iterator
from ..models.model import Model
from ..optim import cosine_schedule


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default="none",
                    choices=["none", "single", "multi", "auto"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    return ap


def main(argv=None) -> list[float]:
    """Train ``--steps`` steps; returns the losses."""
    args = build_parser().parse_args(argv)
    if args.mesh != "none":
        raise SystemExit(
            f"--mesh {args.mesh}: sharded training is not ported yet "
            "(ROADMAP queue 1 item 10b); the port trains on one device, "
            "--mesh none")
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    model = Model(cfg, device=args.device)
    n_dev = torch.cuda.device_count() if model.device.type == "cuda" else 1
    print(f"arch={cfg.name} params={model.param_count():,} "
          f"devices={n_dev}")

    state = model.init_train_state(
        torch.Generator(device=model.device).manual_seed(args.seed))
    sched = partial(cosine_schedule, peak_lr=args.lr,
                    warmup_steps=args.warmup, total_steps=args.steps)
    data = make_train_iterator(
        SyntheticLM(cfg.vocab, args.seq, seed=args.seed), args.batch)
    t0 = time.time()
    losses = []
    for step in range(args.steps):
        state, metrics = model.train_step(state, next(data),
                                          lr_schedule=sched)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({dt / (step + 1):.2f} s/step)")
        if args.ckpt_dir and args.ckpt_every \
                and (step + 1) % args.ckpt_every == 0:
            save_checkpoint(args.ckpt_dir, step + 1, state.params)
            print(f"  checkpoint @ {step + 1}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    print(f"loss {first:.4f} -> {last:.4f} "
          f"({'improved' if last < first else 'NOT improved'})")
    return losses


if __name__ == "__main__":
    main()
