"""Roofline cost model with NVIDIA H100 SXM constants.

The counterpart of ``repro.core.costmodel``, retargeted from the TPU v5e
to the card the port runs on.  The constants are the data-sheet figures
of one H100 SXM at its full 700 W power limit (NVIDIA H100 data sheet
and Hopper architecture white paper); a card capped lower runs slower
under load.  The analytic per-op counts (:func:`op_flops`,
:func:`op_bytes`) are the reference's, unchanged.  The reference reads
collective bytes from XLA's HLO text (``collective_bytes_from_hlo``);
the port reads them from the collectives a dry-run trace issued
(:func:`collective_bytes_from_trace`, fed by ``launch/dryrun.py``).

Terms (seconds):
    compute    = FLOPs            / (chips * PEAK_FLOPS)
    memory     = HBM bytes        / (chips * HBM_BW)
    collective = collective bytes / (chips * LINK_BW)
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable

# -- H100 SXM hardware constants (per card, data sheet) ----------------------
PEAK_FLOPS = 989e12          # H100: dense bf16 tensor-core FLOP/s
HBM_BW = 3.35e12             # H100: HBM3 bytes/s
LINK_BW = 450e9              # H100: NVLink bytes/s each way, per card
SMEM_BYTES = 227 * 1024      # H100: shared memory one thread block can use
HBM_BYTES = 80 * 10**9       # H100: device memory


@dataclasses.dataclass
class RooflineTerms:
    compute_s: float
    memory_s: float
    collective_s: float

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)  # type: ignore[arg-type]

    @property
    def bound_s(self) -> float:
        """Roofline lower bound on step time (terms overlap perfectly)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def serial_s(self) -> float:
        """Upper bound (no overlap at all)."""
        return self.compute_s + self.memory_s + self.collective_s

    def as_dict(self) -> dict[str, Any]:
        return {"compute_s": self.compute_s, "memory_s": self.memory_s,
                "collective_s": self.collective_s, "dominant": self.dominant,
                "bound_s": self.bound_s}


def roofline(flops: float, hbm_bytes: float, collective_bytes: float,
             chips: int = 1) -> RooflineTerms:
    return RooflineTerms(
        compute_s=flops / (chips * PEAK_FLOPS),
        memory_s=hbm_bytes / (chips * HBM_BW),
        collective_s=collective_bytes / (chips * LINK_BW),
    )


# -- analytic per-op costs (used by the planner fast path) -------------------

def op_flops(node, tensors) -> float:
    """Approximate FLOPs of one graph op (inference, fp32 count)."""
    t = node.op_type
    outs = [tensors[o] for o in node.outputs]
    out = outs[0]
    if t in ("conv", "cbr", "cbra", "cbrm"):
        k = node.attrs.get("ksize", 1)
        in_c = tensors[node.inputs[0]].shape[-1]
        # conv MACs * 2; linked pool adds one more pass over the conv output
        n, oh, ow, oc = _conv_out_shape(node, tensors)
        f = 2.0 * n * oh * ow * oc * k * k * in_c
        if t in ("cbra", "cbrm"):
            f += float(n * oh * ow * oc)
        return f
    if t == "dwconv":
        k = node.attrs.get("ksize", 1)
        return 2.0 * out.size * k * k
    if t == "matmul":
        in_f = tensors[node.inputs[0]].shape[-1]
        return 2.0 * out.size * in_f
    if t in ("add", "mul", "bias", "relu", "bn", "softmax"):
        return float(out.size) * (4.0 if t == "softmax" else 1.0)
    if t == "gampool":
        return float(tensors[node.inputs[0]].size)
    if t == "mac":
        return 2.0 * out.size
    return 0.0


def op_bytes(node, tensors, linked: bool = False,
             bytes_per_el: int = 4) -> float:
    """Device-memory traffic of one op: read inputs+params, write outputs.

    ``linked=True`` models operator linking: the op's inputs that come from
    the same link group stay on chip (registers / shared memory), so their
    device-memory read (and the producer's write) is elided.  This is the
    quantitative content of Figure 4.
    """
    read = sum(tensors[i].nbytes(bytes_per_el) for i in node.inputs
               if not (linked and _same_group_producer(node, i, tensors)))
    read += sum(tensors[p].nbytes(bytes_per_el) for p in node.params)
    write = sum(tensors[o].nbytes(bytes_per_el) for o in node.outputs)
    return float(read + write)


def _same_group_producer(node, tensor_name, tensors) -> bool:
    spec = tensors[tensor_name]
    return (spec.producer is not None
            and node.dataflow.get("link_group") is not None)


def _conv_out_shape(node, tensors):
    out = tensors[node.outputs[0]]
    if node.op_type in ("cbra", "cbrm"):
        # output is post-pool; conv output is pre-pool
        pool_attrs = node.attrs.get("pool", {})
        s = pool_attrs.get("stride", 2)
        n, oh, ow, oc = out.shape
        return n, oh * s, ow * s, oc
    return out.shape


# -- collectives of a dry-run trace -------------------------------------------

#: ``torch.distributed`` functional-collective op names -> the reference's
#: HLO collective kinds
COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def collective_bytes_from_trace(events: Iterable[tuple[str, float]]
                                ) -> dict[str, float]:
    """Sum the result bytes of every collective a traced step issued.

    ``events``: ``(op, bytes)`` pairs, ``op`` a functional-collective op
    name (``all_gather_into_tensor``, ...) or already one of the
    reference's kinds, ``bytes`` the size of the collective's result on
    one rank (for all-gather the gathered size; for all-reduce the
    reduced tensor).  Returns {kind: bytes, ..., 'total': bytes} under
    the reference's kind names (``all-reduce``, ``all-gather``,
    ``reduce-scatter``, ``all-to-all``, ``collective-permute``): the
    proxy of ``collective_bytes_from_hlo``, consistent across schemes,
    which is what the planner needs."""
    out: dict[str, float] = {}
    for op, nbytes in events:
        kind = COLLECTIVE_KINDS.get(op, op)
        out[kind] = out.get(kind, 0.0) + float(nbytes)
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out
