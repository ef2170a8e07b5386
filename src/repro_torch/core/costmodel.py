"""Roofline cost model with NVIDIA H100 SXM constants.

The counterpart of ``repro.core.costmodel``, retargeted from the TPU v5e
to the card the port runs on.  The constants are the data-sheet figures
of one H100 SXM at its full 700 W power limit (NVIDIA H100 data sheet
and Hopper architecture white paper); a card capped lower runs slower
under load.

Terms (seconds):
    compute    = FLOPs            / (chips * PEAK_FLOPS)
    memory     = HBM bytes        / (chips * HBM_BW)
    collective = collective bytes / (chips * LINK_BW)
"""
from __future__ import annotations

import dataclasses

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
    def serial_s(self) -> float:
        """Upper bound (no overlap at all)."""
        return self.compute_s + self.memory_s + self.collective_s


def roofline(flops: float, hbm_bytes: float, collective_bytes: float,
             chips: int = 1) -> RooflineTerms:
    return RooflineTerms(
        compute_s=flops / (chips * PEAK_FLOPS),
        memory_s=hbm_bytes / (chips * HBM_BW),
        collective_s=collective_bytes / (chips * LINK_BW),
    )


def op_flops(node, tensors) -> float:
    """Approximate FLOPs of one graph op (inference) — the ops the serving
    proxy graph holds; the CNN ops follow with ROADMAP queue 1 item 6."""
    t = node.op_type
    out = tensors[node.outputs[0]]
    if t == "matmul":
        in_f = tensors[node.inputs[0]].shape[-1]
        return 2.0 * out.size * in_f
    if t in ("add", "mul", "bias", "relu", "bn", "softmax"):
        return float(out.size) * (4.0 if t == "softmax" else 1.0)
    if t == "mac":
        return 2.0 * out.size
    return 0.0


def op_bytes(node, tensors, linked: bool = False,
             bytes_per_el: int = 4) -> float:
    """HBM traffic of one op: read inputs+params, write outputs.
    ``linked=True`` elides reads of inputs produced inside the op's link
    group (operator linking keeps them on chip)."""
    read = sum(tensors[i].nbytes(bytes_per_el) for i in node.inputs
               if not (linked and tensors[i].producer is not None
                       and node.dataflow.get("link_group") is not None))
    read += sum(tensors[p].nbytes(bytes_per_el) for p in node.params)
    write = sum(tensors[o].nbytes(bytes_per_el) for o in node.outputs)
    return float(read + write)
