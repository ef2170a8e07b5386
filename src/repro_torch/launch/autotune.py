"""The d-Xenos autotuner (paper §5, Algorithm 1 on transformers), on
PyTorch: the counterpart of ``repro.launch.autotune``.

Its sharding-rule leg enumerates candidate rule sets
(:data:`CANDIDATE_RULESETS`: the Figure-6 schemes translated to
mesh-axis assignments), traces each with the fake-rank dry run
(``launch/dryrun.py``), scores it by the three-term roofline of the
trace (the stand-in for on-device profiling of a production mesh), and
returns the argmin through ``core.planner.algorithm1``, one
``PassRecord`` a candidate::

    PYTHONPATH=src python -m repro_torch.launch.autotune --arch qwen3-1.7b \
        --shape decode_32k

This is also the §Perf hillclimbing harness: each candidate is one
hypothesis, the roofline delta is the measurement.

Its kernel-site leg: :func:`bench_kernel_sites` times each serving kernel site's candidate
backends on the live device, and the resulting ``{"site:backend":
seconds}`` dict (persisted by ``launch/kernel_tune.py``, reloaded with
:func:`load_timings`) overrides the ``kernel_select`` pass's heuristics
site by site (``core.pipeline.select_kernel_plan``'s ``timings``, the
engine's ``kernel_timings``)::

    PYTHONPATH=src python -m repro_torch.launch.kernel_tune --out t.json
    # ... later ...
    ServingEngine(..., kernel_timings=load_timings("t.json"))
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .. import resolve_device
from ..core.pipeline import PassRecord, PassReport
from ..core.planner import algorithm1

#: candidate rule overrides, named.  Baseline = {} (the paper-faithful
#: outC-first DOS rules in distributed/sharding.py).
CANDIDATE_RULESETS: dict[str, dict] = {
    "baseline_outC": {},
    "kv_replicated": {"kv_heads": None},
    "mlp_on_data": {"mlp": "data"},
    "embed_fsdp": {"embed": "data"},
    "vocab_replicated": {"vocab": None},
    "experts_2d": {"expert_mlp": "data"},
    "heads_replicated": {"heads": None, "kv_heads": None, "mlp": "model"},
}


def score(arch: str, shape: str, mesh_name: str, rules: dict) -> dict:
    """The dry run's record of (arch, shape) under ``rules`` on the
    ``mesh_name`` mesh (``"single"`` or ``"multi"``)."""
    from . import dryrun
    mesh = dryrun.build_mesh(multi_pod=(mesh_name == "multi"))
    trace, model, _ = dryrun.lower_one(arch, shape, mesh, rules or None)
    return dryrun.analyze(arch, shape, mesh_name, trace, model)


def tune(arch: str, shape: str, mesh_name: str = "single",
         rulesets: dict[str, dict] | None = None,
         objective: str = "bound_s",
         ) -> tuple[str, dict[str, dict], PassReport]:
    """Algorithm-1 search over rulesets, instrumented as a PassReport.

    Each candidate scores as one pass record (wall time + objective), so the
    tuner's output is the same structured artifact ``pipeline.optimize``
    produces for the graph passes.  A candidate that raises scores +inf
    with its error.  Returns ``(best_name, per-candidate results,
    report)``.
    """
    rulesets = rulesets or CANDIDATE_RULESETS
    results: dict[str, dict] = {}
    report = PassReport(graph_name=f"{arch}/{shape}", device=mesh_name)

    def profiling(name: str) -> float:
        t0 = time.perf_counter()
        try:
            rec = score(arch, shape, mesh_name, rulesets[name])
        except Exception as e:  # noqa: BLE001 - invalid scheme = +inf
            rec = {"error": f"{type(e).__name__}: {e}", objective: float("inf"),
                   "bound_s": float("inf")}
        results[name] = rec
        val = rec.get(objective, float("inf"))
        summary = {objective: round(val, 6)}
        if "dominant" in rec:
            summary["dominant"] = rec["dominant"]
        if "error" in rec:
            summary["error"] = rec["error"]
        report.record(PassRecord(
            name=f"plan:{name}", wall_s=time.perf_counter() - t0,
            nodes_before=0, nodes_after=0, edges_before=0, edges_after=0,
            verified=False, summary=summary))
        return val

    best, best_t = algorithm1(list(rulesets), profiling)
    print(report.format())
    print(f"best scheme: {best} ({objective}={best_t:.6f})")
    return best, results, report

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _block(out) -> None:
    """Wait for ``out`` as ``jax.block_until_ready`` does: synchronize its
    device when it lives on a card (a host result is already there)."""
    if isinstance(out, torch.Tensor) and out.is_cuda:
        torch.cuda.synchronize(out.device)


def _time_call(fn, *args, iters: int = 20, warmup: int = 3) -> float:
    """Mean synchronized wall seconds of one ``fn(*args)`` over ``iters``
    calls, after ``warmup`` calls (the reference's measure)."""
    for _ in range(warmup):
        _block(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        _block(fn(*args))
    return (time.perf_counter() - t0) / iters


def bench_kernel_sites(slots: int = 4, max_len: int = 64, q_heads: int = 8,
                       kv_heads: int = 2, head_dim: int = 64,
                       kv_block_size: int = 8, vocab: int = 512,
                       iters: int = 20, seed: int = 0,
                       include_cuda: bool | None = None,
                       device="cuda", dtype: str = "float32"
                       ) -> dict[str, float]:
    """Time each serving kernel site's candidate backends on ``device``.

    Returns the ``{"site:backend": seconds}`` dict ``select_kernel_plan``
    consumes via its ``timings`` option: ``decode_dense`` (``torch``),
    ``decode_paged`` (``gather``, ``fold``) and ``sampler``
    (``reference``, ``fused``), each site with ``cuda`` too when
    ``include_cuda``.  The inputs are the reference's, drawn in its order
    from ``numpy.random.default_rng(seed)``; queries, caches and logits
    in ``dtype`` (the reference's is ``float32``; a card's engine serves
    ``bfloat16``).

    Each candidate is timed as one dispatch, as the reference times a
    ``jax.jit`` of it: on the card the call is captured once as a CUDA
    graph (``serving.graphs.StepGraph``, as the engine captures its
    steps) and ``_time_call`` times its replays; on the host it is
    called as it is.  Timed eagerly on an H100 80GB HBM3 at 700 W, every
    sampler candidate took 3.0–4.7 ms, the host's dispatch of the keyed
    draw they share, and the argmin moved with that noise (the ~0.02 ms
    ``fused_mask`` kernel lost at qwen3-1.7b's geometry).

    ``include_cuda`` (default: the device is CUDA) adds the CUDA kernels.
    On the host a kernel wrapper runs its plain version, which would file
    a plain time under the kernel's name, so asking for them there raises
    ``ValueError`` (the reference's ``include_pallas`` names the same
    hazard for interpret mode).  A kernel that fails to build, launch or
    be captured fails the bench.  Each kernel launches ``iters`` + 4
    times on the card (the capture's warm-up, 3 warm-up replays, the
    timed ones).  The sampler timing is the standalone dispatch; the
    ``serve_sample`` step saves a dispatch on top of whichever sampler
    wins here (the ``reference`` sampler runs as its own eager dispatch
    after the engine's graphed step, the others inside it)."""
    from ..kernels.fused_sampler.ops import fused_sample
    from ..models import attention as A
    from ..serving.graphs import StepGraph
    from ..serving.sampling import sample_tokens

    dev = resolve_device(device)
    if include_cuda is None:
        include_cuda = dev.type == "cuda"
    if include_cuda and dev.type != "cuda":
        raise ValueError(
            f"include_cuda on {dev}: the kernel wrappers run their plain "
            "versions off the card, so the timings would name the kernels "
            "for the plain versions' times")
    if dtype not in _DTYPES:
        raise ValueError(f"unknown dtype {dtype!r}; have {sorted(_DTYPES)}")
    dt = _DTYPES[dtype]
    rng = np.random.default_rng(seed)
    B, H, K, D, W = slots, q_heads, kv_heads, head_dim, max_len
    bs = kv_block_size
    if W % bs:
        raise ValueError(f"max_len {W} is not a multiple of kv_block_size "
                         f"{bs}")
    M = W // bs
    P = B * M
    cuda = ("cuda",) if include_cuda else ()

    def put(a, dtype=dt):
        return torch.as_tensor(a).to(dev, dtype)

    stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None

    def timed(fn, *args) -> float:
        names = [f"a{i}" for i in range(len(args))]
        step = StepGraph(lambda **kw: fn(*(kw[n] for n in names)),
                         dict(zip(names, args)), key=None, stream=stream)
        return _time_call(step.replay, iters=iters)

    out: dict[str, float] = {}
    with torch.no_grad():
        # decode_dense ------------------------------------------------------
        q = put(rng.normal(size=(B, H, D)))
        kc = put(rng.normal(size=(B, W, K, D)))
        vc = put(rng.normal(size=(B, W, K, D)))
        valid = put(rng.integers(0, 2, (B, W)).astype(bool), torch.bool)
        for backend in ("torch",) + cuda:
            out[f"decode_dense:{backend}"] = timed(
                lambda *a, _b=backend: A.decode_attention(*a, _b),
                q, kc, vc, valid)

        # decode_paged ------------------------------------------------------
        kp = put(rng.normal(size=(P, bs, K, D)))
        vp = put(rng.normal(size=(P, bs, K, D)))
        tables = put(np.stack([rng.permutation(P)[:M] for _ in range(B)]),
                     torch.int32)
        lengths = put(rng.integers(1, W + 1, (B,)), torch.int32)
        for backend in ("gather", "fold") + cuda:
            out[f"decode_paged:{backend}"] = timed(
                lambda *a, _b=backend: A.decode_attention_paged(*a, _b),
                q, kp, vp, tables, lengths)

        # sampler -----------------------------------------------------------
        logits = put(rng.normal(size=(B, vocab)))
        seeds = put(rng.integers(0, 2**31, (B,)), torch.int64)
        steps = torch.zeros((B,), dtype=torch.int64, device=dev)
        temps = torch.full((B,), 0.8, dtype=torch.float32, device=dev)
        ks = torch.full((B,), 40, dtype=torch.int32, device=dev)
        ps = torch.full((B,), 0.9, dtype=torch.float32, device=dev)
        samplers = {"reference": lambda *a: sample_tokens(*a, vocab=vocab),
                    "fused": lambda *a: fused_sample(*a, vocab=vocab)}
        if include_cuda:
            samplers["cuda"] = lambda *a: fused_sample(*a, vocab=vocab,
                                                       backend="cuda")
        for name, fn in samplers.items():
            out[f"sampler:{name}"] = timed(fn, logits, seeds, steps,
                                           temps, ks, ps)
    return out


def save_timings(path: str, timings: dict[str, float],
                 meta: dict | None = None) -> None:
    """Persist a kernel-site timings cache (JSON, the reference's layout)
    for later plan runs."""
    with open(path, "w") as f:
        json.dump({"timings": timings, "meta": meta or {}}, f, indent=2,
                  sort_keys=True)
        f.write("\n")


def load_timings(path: str) -> dict[str, float]:
    """Load a timings cache written by :func:`save_timings` (or by the
    reference's); ``{}`` when the file does not exist (callers fall back
    to the heuristics)."""
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    return {str(k): float(v) for k, v in data.get("timings", {}).items()}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--mesh", default="single")
    ap.add_argument("--objective", default="bound_s")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    best, results, report = tune(args.arch, args.shape, args.mesh,
                                 objective=args.objective)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps({"arch": args.arch, "shape": args.shape,
                                "mesh": args.mesh, "best": best,
                                "results": results,
                                "report": report.as_dict()}) + "\n")


if __name__ == "__main__":
    main()
