"""d-Xenos partition-scheme planner (paper §5, Algorithm 1, Figure 6).

The counterpart of ``repro.core.planner``.  The paper enumerates every
combination of partition schemes over the partitionable dims (``inH``,
``inW``, ``outC`` for convolution), profiles each on the device, and keeps
the argmin.  ``algorithm1`` below is the literal Alg.-1 loop; the default
profiling oracle is the static roofline cost model (``core.costmodel``, H100
constants), and a caller may pass a measured ``profiler`` instead.

Synchronization cost (ring all-reduce vs parameter server) is modeled with
the standard bandwidth terms:
    ring:  2 * (p-1)/p * bytes / link_bw      (bandwidth-optimal, [22])
    PS:    2 * (p-1)   * bytes / link_bw      (root link is the bottleneck)
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Iterable, Sequence

from . import costmodel as cm
from .dos import DeviceSpec, _dims_of, COMPUTE_OPS
from .graph import Graph

PARTITION_DIMS = ("inH", "inW", "outC")  # §4.2.1 / Figure 6


@dataclasses.dataclass(frozen=True)
class Scheme:
    """One partition scheme: dim -> number of parts (product == n_devices)."""

    parts: tuple[tuple[str, int], ...]

    @classmethod
    def single(cls, dim: str, n: int) -> "Scheme":
        return cls(((dim, n),))

    def as_dict(self) -> dict[str, int]:
        return dict(self.parts)

    def __str__(self) -> str:
        return "x".join(f"{d}:{n}" for d, n in self.parts) or "replicated"


def _factorizations(n: int, dims: Sequence[str]) -> Iterable[dict[str, int]]:
    """All assignments {dim: parts>=1} with product == n (ordered dims)."""
    if not dims:
        if n == 1:
            yield {}
        return
    d, rest = dims[0], dims[1:]
    f = 1
    while f <= n:
        if n % f == 0:
            for tail in _factorizations(n // f, rest):
                out = {d: f} if f > 1 else {}
                out.update(tail)
                yield out
        f += 1


def enumerate_schemes(n_devices: int, dims: Sequence[str] = PARTITION_DIMS) -> list[Scheme]:
    """Figure 6: every way to spread n_devices over the partition dims."""
    seen: set[tuple[tuple[str, int], ...]] = set()
    out: list[Scheme] = []
    for assign in _factorizations(n_devices, list(dims)):
        key = tuple(sorted(assign.items()))
        if key in seen:
            continue
        seen.add(key)
        out.append(Scheme(tuple((d, assign[d]) for d in dims if d in assign)))
    return out


# -- the profiling oracle -----------------------------------------------------

def model_scheme_time(g: Graph, scheme: Scheme, n_devices: int,
                      device: DeviceSpec | None = None,
                      sync: str = "ring", bytes_per_el: int = 4,
                      linked: bool = False) -> cm.RooflineTerms:
    """Static-roofline stand-in for Algorithm 1's ``Profiling(shm)``.

    * compute/memory terms shrink with the partition (work is spread), but
      a dim that does not evenly divide adds padding waste;
    * ``inH``/``inW`` partitions add halo-exchange bytes for every conv with
      ksize > 1 (the paper's "special handling of boundary rows/columns");
    * ``outC`` partitions add the post-hoc activation gather (concat of
      output channels) — cheap, and parameters are *distributed*, not
      replicated, so no parameter sync is needed for them;
    * parameters replicated under inH/inW partitions must be synchronized
      (ring or PS), which is Fig. 11's effect.
    """
    device = device or DeviceSpec()
    parts = scheme.as_dict()
    total_flops = 0.0
    total_bytes = 0.0
    halo_bytes = 0.0
    replicated_param_bytes = 0.0
    gather_bytes = 0.0

    for node in g.nodes:
        f = cm.op_flops(node, g.tensors)
        b = cm.op_bytes(node, g.tensors, linked=linked, bytes_per_el=bytes_per_el)
        dims = _dims_of(node, g.tensors)
        # padding waste for non-dividing partitions
        waste = 1.0
        for d, p in parts.items():
            extent = dims.get(d, 1)
            if extent > 1 and p > 1:
                waste *= (math.ceil(extent / p) * p) / extent
        total_flops += f * waste
        total_bytes += b * waste
        if node.op_type in COMPUTE_OPS:
            k = node.attrs.get("ksize", 1)
            x = g.tensors[node.inputs[0]]
            if k > 1 and x.rank == 4:
                n_, h_, w_, c_ = x.shape
                if parts.get("inH", 1) > 1:
                    halo_bytes += (k - 1) * w_ * c_ * n_ * bytes_per_el * parts["inH"]
                if parts.get("inW", 1) > 1:
                    halo_bytes += (k - 1) * h_ * c_ * n_ * bytes_per_el * parts["inW"]
            pb = sum(g.tensors[p_].nbytes(bytes_per_el) for p_ in node.params)
            if parts.get("outC", 1) > 1 and dims.get("K", 1) > 1:
                # params are sharded along K; activation gather at the end
                gather_bytes += g.tensors[node.outputs[0]].nbytes(bytes_per_el)
            else:
                replicated_param_bytes += pb

    p = max(n_devices, 1)
    if sync == "ring":
        sync_bytes = 2.0 * (p - 1) / p * replicated_param_bytes
    else:  # parameter server: root link serializes
        sync_bytes = 2.0 * (p - 1) * replicated_param_bytes
    collective = halo_bytes + gather_bytes + sync_bytes
    return cm.roofline(total_flops, total_bytes, collective, chips=p)


# -- Algorithm 1 (verbatim structure) ----------------------------------------

def algorithm1(dset: Sequence[Scheme],
               profiling: Callable[[Scheme], float]) -> tuple[Scheme | None, float]:
    """Enumerating Partition Schemes — the paper's Algorithm 1.

    Input: dset — the set of candidate partition schemes.
    Line-for-line: iterate, profile, keep the best.
    """
    best_shm, best_time = None, float("inf")
    for shm in dset:
        exec_time = profiling(shm)
        if exec_time < best_time:
            best_shm, best_time = shm, exec_time
    return best_shm, best_time


def plan_distributed(g: Graph, n_devices: int, sync: str = "ring",
                     device: DeviceSpec | None = None,
                     profiler: Callable[[Scheme], float] | None = None,
                     ) -> tuple[Scheme, float, dict[str, float]]:
    """Full d-Xenos planning for a graph: enumerate (Fig. 6) + Alg. 1."""
    dset = enumerate_schemes(n_devices)
    if profiler is None:
        profiler = lambda s: model_scheme_time(g, s, n_devices, device, sync).serial_s
    best, best_t = algorithm1(dset, profiler)
    assert best is not None
    all_times = {str(s): profiler(s) for s in dset}
    return best, best_t, all_times


def plan_mix(g: Graph, n_devices: int, sync: str = "ring",
             device: DeviceSpec | None = None) -> dict[str, Scheme]:
    """Per-operator best scheme — the paper's winning "Ring-Mix" (Fig. 11)."""
    out: dict[str, Scheme] = {}
    for node in g.nodes:
        if node.op_type not in COMPUTE_OPS:
            continue
        sub = Graph(f"{g.name}.{node.name}")
        sub.tensors = g.tensors
        sub.nodes = [node]
        best, _, _ = plan_distributed(sub, n_devices, sync, device)
        out[node.name] = best
    return out
