"""Xenos core of the PyTorch port: graph IR, the paper's passes and the
serving planner (``pipeline``), the H100 cost model and the CNN executor
(``engine``).

Pipeline (paper §3/§4, run by the pass manager in core/pipeline.py):
    fuse_cbr (Conv+Bn+Relu -> CBR)  ->  link_operators (VO, §4.1)
    ->  dos_split (HO, §4.2)  [->  dxenos_plan (§5, opt-in)]

``optimize`` keeps the reference's Graph-in/Graph-out signature;
``pipeline.optimize`` is the instrumented entry point returning
``(graph, PassReport)``.
"""
from __future__ import annotations

import time

from . import costmodel, dos, engine, graph, linking, patterns, pipeline, planner
from .dos import DeviceSpec
from .engine import Engine, build_engine, execute, init_params
from .graph import Graph
from .pipeline import (KernelPlan, Pass, PassReport, PassVerificationError,
                       StageTimer, optimize_for_mode, verify_graph)


def optimize(g: Graph, device: DeviceSpec | None = None,
             vertical: bool = True, horizontal: bool = True) -> Graph:
    """The full automatic optimization workflow (§4.4), via the pass manager.

    ``vertical``/``horizontal`` toggle the VO (fuse+link) and HO (DOS split)
    pass groups — the Fig.-7 ablation axes.  Use :func:`optimize_report` /
    ``pipeline.optimize`` when you also want the :class:`PassReport`.
    """
    out, _ = optimize_report(g, device, vertical=vertical, horizontal=horizontal)
    return out


def optimize_report(g: Graph, device: DeviceSpec | None = None,
                    vertical: bool = True, horizontal: bool = True,
                    ) -> tuple[Graph, PassReport]:
    """Like :func:`optimize` but also returns the structured PassReport."""
    passes: list[str] = []
    if vertical:
        passes += ["fuse_cbr", "link_operators"]
    if horizontal:
        passes += ["dos_split"]
    return pipeline.optimize(g, device, passes=passes)


def optimize_timed(g: Graph, device: DeviceSpec | None = None) -> tuple[Graph, float]:
    """Optimization + wall-clock, for the Table-2 reproduction."""
    t0 = time.perf_counter()
    out = optimize(g, device)
    return out, time.perf_counter() - t0


__all__ = [
    "Graph", "Engine", "DeviceSpec", "KernelPlan", "Pass", "PassReport",
    "PassVerificationError", "StageTimer", "build_engine", "execute",
    "init_params", "optimize", "optimize_report", "optimize_timed",
    "optimize_for_mode", "verify_graph", "graph", "patterns", "linking",
    "dos", "planner", "costmodel", "engine", "pipeline",
]
