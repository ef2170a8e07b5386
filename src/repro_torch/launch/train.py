"""End-to-end training driver of the port, on one device (the card by
default) or, with ``--mesh``, sharded over a mesh of ranks.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --reduced --steps 50 --batch 8 --seq 128

    PYTHONPATH=src python -m repro_torch.launch.train --arch mamba2-370m \
        --reduced --steps 8 --batch 4 --seq 32 --device cpu

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \
        --reduced --mesh single --ranks 4 --device cpu --steps 8 \
        --batch 8 --seq 32

The same flags and printed lines as ``python -m repro.launch.train``,
plus ``--device``, ``--ranks``, ``--devices`` and ``--rank-timeout``:
the ``arch=... params=... devices=N`` line, a ``step ... loss ... gnorm
...`` line every ``--log-every`` steps and at the last, and ``loss a ->
b (improved|NOT improved)`` over the means of the first and last five
losses.  Weights are random, drawn on the device from ``--seed``; the
data is ``SyntheticLM(vocab, --seq, seed=--seed)``; the lr follows
``cosine_schedule`` (``--lr`` peak, ``--warmup``, over ``--steps``).
``--ckpt-dir`` with ``--ckpt-every N`` saves the params every N steps in
the reference's checkpoint layout.

``--mesh single|multi|auto`` trains over ``make_debug_mesh(n)``'s axes
(``make_production_mesh`` when n >= 256), as the reference's ``main``
does: one process a rank (``launch.mesh.spawn_ranks``), the params and
moments sharded by the d-Xenos rules, the batch split over ``"data"``
(each rank reads its own rows), GSPMD's step over DTensor
(``Model.train_step``).  n is the number of visible cards, a card a
rank (NCCL); ``--ranks N --device cpu`` puts N ranks on the host and
``--devices cuda:0,cuda:0,...`` lists each rank's device (several on one
card: gloo).  A mesh wider than the visible cards, with no device list,
prints ``FAIL: ...`` and exits 2: no silent one-device run.  Rank 0
alone prints; ``--ckpt-dir`` gathers the params and rank 0 writes them.
"""
from __future__ import annotations

import argparse
import sys
import time
from functools import partial

import numpy as np
import torch

from ..checkpoint import save_checkpoint
from ..configs.base import get_config
from ..data import SyntheticLM, make_train_iterator
from ..distributed import sharding as SH
from ..models.model import Model
from ..optim import cosine_schedule
from . import mesh as mesh_lib


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
    ap.add_argument("--ranks", type=int, default=0,
                    help="mesh ranks (default: the visible cards; with "
                         "--device cpu, 1)")
    ap.add_argument("--devices", default=None,
                    help="comma-separated device of each mesh rank, e.g. "
                         "cuda:0,cuda:0 (several ranks may share one)")
    ap.add_argument("--rank-timeout", type=float, default=1800.0)
    return ap


def run(args, mesh=None) -> list[float]:
    """Train ``--steps`` steps on one device, or as this rank of the
    ``DeviceMesh`` ``mesh``; returns the losses."""
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    lead = mesh is None or torch.distributed.get_rank() == 0

    def say(*a):
        if lead:
            print(*a, flush=True)
    if mesh is None:
        model = Model(cfg, device=args.device)
        n_dev = torch.cuda.device_count() \
            if model.device.type == "cuda" else 1
        baxes, shard, n_shards = (), 0, 1
    else:
        model = Model(cfg, mesh=mesh, device=mesh_lib.mesh_device(mesh))
        n_dev = mesh.size()
        baxes = SH.batch_axes_for(SH.mesh_shape(mesh), args.batch)
        sizes = SH.mesh_shape(mesh).shape
        shard, n_shards = 0, 1
        for a in baxes:
            shard = shard * sizes[a] + mesh.get_local_rank(a)
            n_shards *= sizes[a]
    say(f"arch={cfg.name} params={model.param_count():,} devices={n_dev}")

    state = model.init_train_state(
        torch.Generator(device=model.device).manual_seed(args.seed))
    sched = partial(cosine_schedule, peak_lr=args.lr,
                    warmup_steps=args.warmup, total_steps=args.steps)
    data = make_train_iterator(
        SyntheticLM(cfg.vocab, args.seq, seed=args.seed), args.batch,
        shard_index=shard, num_shards=n_shards)
    t0 = time.time()
    losses = []
    for step in range(args.steps):
        state, metrics = model.train_step(state, next(data),
                                          lr_schedule=sched,
                                          batch_axes=baxes)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.time() - t0
            say(f"step {step:5d} loss {losses[-1]:.4f} "
                f"gnorm {float(metrics['grad_norm']):.3f} "
                f"({dt / (step + 1):.2f} s/step)")
        if args.ckpt_dir and args.ckpt_every \
                and (step + 1) % args.ckpt_every == 0:
            params = state.params if mesh is None \
                else model.gather_params(state.params)
            if lead:
                save_checkpoint(args.ckpt_dir, step + 1, params)
            say(f"  checkpoint @ {step + 1}")
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    say(f"loss {first:.4f} -> {last:.4f} "
        f"({'improved' if last < first else 'NOT improved'})")
    return losses


def train_rank(mesh, args) -> list[float]:
    """One rank of ``--mesh``: :func:`run` on this rank's mesh."""
    return run(args, mesh)


def mesh_devices(args) -> list[str]:
    """Each rank's device for ``--mesh``; ``ValueError`` where the visible
    cards cannot hold the mesh asked for."""
    if args.devices:
        return args.devices.split(",")
    if args.device == "cpu":
        return ["cpu"] * max(args.ranks, 1)
    n = args.ranks or torch.cuda.device_count()
    if n < 1:
        raise ValueError("a training mesh needs a card a rank, 0 visible "
                         "(--device cpu --ranks N puts ranks on the host)")
    return mesh_lib.default_devices(n)


def main(argv=None) -> list[float]:
    """Train; returns the losses (rank 0's on a mesh).  A mesh the devices
    cannot hold prints ``FAIL: ...`` and exits 2; a failed rank exits 1."""
    args = build_parser().parse_args(argv)
    if args.mesh == "none":
        return run(args)
    try:
        devices = mesh_devices(args)
        n = len(devices)
        shape = mesh_lib.make_production_mesh(
            multi_pod=args.mesh == "multi") if n >= 256 \
            else mesh_lib.make_debug_mesh(n)
        if shape.size != n:
            raise ValueError(f"the production mesh holds {shape.size} "
                             f"ranks, not {n}")
    except ValueError as e:
        # no silent fallback: a mesh run that quietly trains on one
        # device reports a run that did not happen
        print(f"FAIL: {e}", file=sys.stderr)
        raise SystemExit(2)
    try:
        losses = mesh_lib.spawn_ranks(train_rank, n, args=(args,),
                                      devices=devices,
                                      timeout_s=args.rank_timeout,
                                      train_shape=shape)
    except (RuntimeError, TimeoutError) as e:
        print(f"FAIL: {e}", file=sys.stderr)
        raise SystemExit(1)
    return losses[0]


if __name__ == "__main__":
    main()
