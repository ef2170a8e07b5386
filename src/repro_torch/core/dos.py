"""Horizontal dataflow optimization: DSP-aware operator split (paper §4.2).

The counterpart of ``repro.core.dos``: the same split rules, with the
default :class:`DeviceSpec` retargeted to the H100.

Two decisions per compute op, exactly the paper's priority order:

1. **Partition the feature map across units** (§4.2.1) along
   ``outC`` first (kernels distribute, no reduction), then ``inH``, then
   ``inW`` (boundary halo needed), never ``inC`` (extra reduction).  If the
   product of even splits cannot reach ``n_units``, the remainder is padded —
   the paper "randomly assigns the remaining workload"; we record the
   imbalance fraction.

2. **Split operator parameters to fit private memory** (§4.2.2) along
   ``K`` (output channel, no extra compute) first, then ``r``/``s`` (kernel
   spatial), then ``inC`` — each later dimension adds reduction overhead.

The paper describes its target as compute units with a private and a
shared memory tier.  On the H100 a unit is a streaming multiprocessor,
its private tier the shared memory one thread block can use, and the
shared tier device memory; the executor carries out a param split as a
chunked contraction (``core.engine._matmul_split``).
"""
from __future__ import annotations

import dataclasses
import math

from .costmodel import HBM_BYTES, SMEM_BYTES
from .graph import Graph, OpNode

COMPUTE_OPS = ("conv", "dwconv", "cbr", "cbra", "cbrm", "matmul", "mac")

#: feature-map partition priority (§4.2.1) and param-split priority (§4.2.2)
FMAP_PRIORITY = ("outC", "inH", "inW")
PARAM_PRIORITY = ("K", "r", "s", "inC")


@dataclasses.dataclass
class DeviceSpec:
    """Resource description of the target (paper: DSP count + L2/shared mem)."""

    n_units: int = 132               # H100 SXM: streaming multiprocessors
    l2_bytes: int = SMEM_BYTES       # private per-unit memory (shared memory)
    shared_bytes: int = HBM_BYTES    # shared memory (device memory)
    name: str = "h100_sxm"

    @classmethod
    def tms320c6678(cls) -> "DeviceSpec":
        return cls(n_units=8, l2_bytes=512 * 1024, shared_bytes=4 * 1024**2,
                   name="tms320c6678")


@dataclasses.dataclass
class SplitPlan:
    """HO decision for one op."""

    fmap_parts: dict[str, int] = dataclasses.field(default_factory=dict)
    param_chunks: dict[str, int] = dataclasses.field(default_factory=dict)
    imbalance: float = 0.0           # padded fraction of work (0 = perfectly even)
    fits_l2: bool = True             # does each param chunk fit private memory?
    notes: list[str] = dataclasses.field(default_factory=list)

    @property
    def total_parts(self) -> int:
        p = 1
        for v in self.fmap_parts.values():
            p *= v
        return p


def _dims_of(node: OpNode, tensors) -> dict[str, int]:
    """Partitionable feature-map dims and param dims of a compute op."""
    t = node.op_type
    if t == "matmul":
        x = tensors[node.inputs[0]]
        out = tensors[node.outputs[0]]
        rows = 1
        for s in x.shape[:-1]:
            rows *= s
        return {"outC": out.shape[-1], "inH": rows, "inW": 1,
                "K": out.shape[-1], "r": 1, "s": 1, "inC": x.shape[-1]}
    if t in ("conv", "dwconv", "cbr", "cbra", "cbrm"):
        x = tensors[node.inputs[0]]
        n, h, w, c = x.shape
        out_c = tensors[node.outputs[0]].shape[-1]
        k = node.attrs.get("ksize", 1)
        return {"outC": out_c, "inH": h, "inW": w,
                "K": out_c, "r": k, "s": k, "inC": c}
    if t == "mac":
        out = tensors[node.outputs[0]]
        return {"outC": out.shape[-1], "inH": out.size // out.shape[-1], "inW": 1,
                "K": out.shape[-1], "r": 1, "s": 1, "inC": 1}
    return {}


def _param_bytes(node: OpNode, tensors, bytes_per_el: int = 4) -> int:
    return sum(tensors[p].nbytes(bytes_per_el) for p in node.params)


def plan_op(node: OpNode, tensors, device: DeviceSpec) -> SplitPlan:
    """DOS for one op: feature-map partition, then param split (§4.2)."""
    plan = SplitPlan()
    dims = _dims_of(node, tensors)
    if not dims:
        return plan

    # -- 1. partition feature map across units, priority outC > inH > inW ----
    remaining = device.n_units
    for d in FMAP_PRIORITY:
        if remaining == 1:
            break
        extent = dims[d]
        parts = math.gcd(extent, remaining)
        # prefer the largest even divisor of `remaining` that divides extent
        best = 1
        for cand in range(remaining, 0, -1):
            if remaining % cand == 0 and extent % cand == 0:
                best = cand
                break
        if best > 1:
            plan.fmap_parts[d] = best
            remaining //= best
    if remaining > 1:
        # uneven remainder: pad the highest-priority partitionable dim
        d = next((d for d in FMAP_PRIORITY if dims[d] > 1), "outC")
        extent = dims[d]
        already = plan.fmap_parts.get(d, 1)
        padded = math.ceil(extent / already / remaining) * remaining * already
        plan.imbalance = (padded - extent) / padded
        plan.fmap_parts[d] = already * remaining
        plan.notes.append(
            f"uneven split: {d}={extent} over {already * remaining} units, "
            f"padded fraction {plan.imbalance:.3f}")

    # -- 2. split params to fit private L2, priority K > r > s > inC ---------
    pbytes = _param_bytes(node, tensors)
    per_unit = pbytes / max(plan.fmap_parts.get("outC", 1), 1)
    if per_unit > device.l2_bytes:
        need = math.ceil(per_unit / device.l2_bytes)
        for d in PARAM_PRIORITY:
            if need <= 1:
                break
            extent = max(dims.get(d, 1) // plan.fmap_parts.get("outC", 1), 1) \
                if d == "K" else dims.get(d, 1)
            take = min(extent, need)
            if take > 1:
                plan.param_chunks[d] = take
                need = math.ceil(need / take)
                if d != "K":
                    plan.notes.append(f"param split along {d} adds a reduction")
        plan.fits_l2 = need <= 1
        if not plan.fits_l2:
            plan.notes.append("params exceed L2 even after full split; streaming")
    return plan


def optimize(g: Graph, device: DeviceSpec | None = None) -> Graph:
    """Annotate every compute op with its SplitPlan (HO pass)."""
    device = device or DeviceSpec()
    g = g.clone()
    for node in g.nodes:
        if node.op_type in COMPUTE_OPS:
            node.dataflow["split_plan"] = plan_op(node, g.tensors, device)
    return g


def plans(g: Graph) -> dict[str, SplitPlan]:
    return {n.name: n.dataflow["split_plan"] for n in g.nodes
            if "split_plan" in n.dataflow}
