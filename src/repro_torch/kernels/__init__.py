"""Hand-written CUDA kernels for Hopper, built from ``csrc/`` at first use.

The counterpart of ``repro.kernels`` (Pallas on the TPU, interpret mode
on the CPU).  Each kernel package holds ``ops.py``: the wrapper that
checks its tensors and launches the kernel on the current CUDA stream,
plus the plain PyTorch version of the same algorithm, which the wrapper
runs for CPU tensors (and only for them — a CUDA tensor launches the
kernel or raises).

Build: every ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a``
into its own shared library with a plain C interface, loaded with
``ctypes``.  Libraries land in ``build/kernels/`` keyed by a hash of the
sources and flags, so a fresh checkout builds on first use and a rebuilt
source never loads a stale library.  :func:`build` starts one ``nvcc`` per
missing library, all at once.  Importing this package needs neither
``nvcc`` nor a card.

:data:`LAUNCHES` counts kernel launches per kernel name: each wrapper
calls :func:`count_launch` where it launches its kernel and nowhere else,
so a run can show which kernels its path reached.  A launch recorded
into a CUDA graph under capture runs nothing: it is counted in
:data:`RECORDED` instead, and whoever replays the graph adds its
recorded launches to :data:`LAUNCHES` at each replay.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
#: repository-root ``build/`` (listed in .gitignore)
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"

#: one shared library per CUDA source
SOURCES: tuple[str, ...] = ("decode_attention", "fused_sampler",
                            "linked_cbr_pool", "linked_mlp", "split_matmul")

NVCC_FLAGS: tuple[str, ...] = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-lineinfo", "-Xptxas", "-v")

#: kernel name -> launches since the last :func:`reset_launches`
LAUNCHES: dict[str, int] = {"gqa_decode": 0, "gqa_decode_paged": 0,
                            "fused_mask": 0, "cbr_avgpool": 0,
                            "linked_mlp": 0, "split_matmul": 0}

#: kernel name -> launches recorded into CUDA graphs under capture
RECORDED: dict[str, int] = dict.fromkeys(LAUNCHES, 0)

_LOADED: dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def count_launch(name: str) -> None:
    """Count one launch of ``name`` on the current stream: in
    :data:`LAUNCHES`, or in :data:`RECORDED` while that stream is
    capturing a CUDA graph."""
    import torch
    if torch.cuda.is_current_stream_capturing():
        RECORDED[name] += 1
    else:
        LAUNCHES[name] += 1


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found: the CUDA kernels are compiled from "
        f"{CSRC} at first use on a machine with the CUDA toolkit")


def library_path(name: str) -> Path:
    """Where the library for ``csrc/<name>.cu`` lives, keyed by content."""
    h = hashlib.sha256()
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build(names: tuple[str, ...] = SOURCES) -> dict[str, Path]:
    """Compile every missing library, one ``nvcc`` per source, started
    together.  Each compiler log (``-Xptxas -v``: registers, shared
    memory, spills) is kept beside its library as ``.log``.  Raises with
    the log of every source that failed."""
    nvcc = None
    jobs = []
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    failed = []
    for name, out, tmp, proc in jobs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        if proc.returncode:
            failed.append(f"--- {name} (nvcc exit {proc.returncode})\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return {name: library_path(name) for name in names}


def library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if missing."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build((name,))[name]))
        _LOADED[name] = lib
    return lib


def check_launch(err: int, kernel: str) -> None:
    """Raise if a kernel's C entry point returned a CUDA error code."""
    if err:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError_t "
                           f"{err}")
