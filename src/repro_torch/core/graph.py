"""Computation-graph IR of the PyTorch port (``repro.core.graph``, copied).

The paper (§6.1, Table 3) exposes a small, fixed operator vocabulary and
implements *all* optimization as metadata rewrites over the dataflow between
those operators — never by inventing new operators.  We keep that contract:

  * ``OpNode`` carries a ``dataflow`` metadata dict.  Vertical optimization
    (operator linking, core/linking.py) and horizontal optimization
    (DSP-aware operator split, core/dos.py) only ever *rewrite metadata*
    (``link_group``, ``write_layout``, ``split_plan``); the operator set is
    closed.
  * The engine (core/engine.py) interprets the metadata: a linked ``cbra``
    op may run as the hand-written ``cbr_avgpool`` CUDA kernel, where the
    producer writes in the consumer's read order and the pre-pool map
    never reaches device memory; split plans become blocked execution.

The serving planner builds its per-tick proxy graph with the same IR
(``serving.scheduler.serve_plan_graph``).  Builders and tensor naming are
the reference's, so a parameter dict made for a reference graph carries
over to the port's graph by name (``repro_torch.convert``).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Sequence

# ---------------------------------------------------------------------------
# Layouts
# ---------------------------------------------------------------------------

#: Feature maps are rank-4 (N, spatial, spatial, channel) in one of two
#: physical orders.  ``NHWC`` is the channel-last order the executor
#: computes in (``channels_last`` in memory); ``NCHW`` models the "written
#: channel-by-channel" order of the paper's Figure 2 that mismatches a
#: channel-last reader.
LAYOUTS = ("NHWC", "NCHW")


@dataclasses.dataclass
class TensorSpec:
    """A symbolic tensor in the graph."""

    name: str
    shape: tuple[int, ...]
    dtype: str = "float32"
    layout: str = "NHWC"  # only meaningful for rank-4 feature maps
    producer: str | None = None  # op name, None for graph inputs / params

    @property
    def rank(self) -> int:
        return len(self.shape)

    @property
    def size(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n

    def nbytes(self, bytes_per_el: int = 4) -> int:
        return self.size * bytes_per_el


# ---------------------------------------------------------------------------
# Operator vocabulary (paper Table 3)
# ---------------------------------------------------------------------------

#: op_type -> description.  This is the closed vocabulary; the
#: linked ops (cbr / cbrm / cbra) exist from the start, exactly as in Table 3
#: — linking *selects* them via metadata, it does not mint new ops.
OP_VOCABULARY: dict[str, str] = {
    "add": "Element-wise Addition",
    "mul": "Element-wise Multiplication",
    "mac": "Multiply Accumulate",
    "conv": "Convolution (kernel size, stride, padding)",
    "dwconv": "Depthwise Convolution",
    "matmul": "Matrix Multiplication",
    "gampool": "Global / Average / Max Pooling",
    "transpose": "Matrix Transpose",
    "concat": "Concatenation of Multiple Tensors",
    "split": "Split a Tensor into Multiple Tensors",
    "bn": "Batch Normalization (inference: scale+shift)",
    "bias": "Bias Addition",
    "relu": "ReLU",
    "cbr": "Fused Conv-Bn-Relu operator",
    "cbrm": "Linked CBR-MaxPooling operator",
    "cbra": "Linked CBR-AvgPooling operator",
    "flatten": "Flatten to (N, -1)",
    "softmax": "Softmax over last dim",
}


@dataclasses.dataclass
class OpNode:
    """One operator instance.

    ``dataflow`` metadata keys written by the optimization passes:
      * ``link_group``: int — ops sharing a group id are executed fused
        (operator linking, §4.1).
      * ``write_layout``: str — the layout the producer must write so the
        consumer reads sequentially (Figure 4).
      * ``split_plan``: core.dos.SplitPlan — HO partition/split decision.
      * ``fused_from``: list[str] — provenance after preprocessing fusion.
    """

    name: str
    op_type: str
    inputs: list[str]            # tensor names
    outputs: list[str]           # tensor names
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)
    params: list[str] = dataclasses.field(default_factory=list)  # param tensor names
    dataflow: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.op_type not in OP_VOCABULARY:
            raise ValueError(
                f"op_type {self.op_type!r} is not in the Xenos operator "
                f"vocabulary (Table 3): {sorted(OP_VOCABULARY)}"
            )


class Graph:
    """A static, topologically-ordered computation graph."""

    def __init__(self, name: str = "graph") -> None:
        self.name = name
        self.nodes: list[OpNode] = []
        self.tensors: dict[str, TensorSpec] = {}
        self.inputs: list[str] = []
        self.params: list[str] = []
        self.outputs: list[str] = []
        self._counter = itertools.count()

    # -- construction -------------------------------------------------------
    def add_input(self, name: str, shape: Sequence[int], dtype: str = "float32",
                  layout: str = "NHWC") -> str:
        self.tensors[name] = TensorSpec(name, tuple(shape), dtype, layout)
        self.inputs.append(name)
        return name

    def add_param(self, name: str, shape: Sequence[int], dtype: str = "float32") -> str:
        self.tensors[name] = TensorSpec(name, tuple(shape), dtype, layout="")
        self.params.append(name)
        return name

    def add_node(self, op_type: str, inputs: Sequence[str], out_shape: Sequence[int],
                 attrs: dict[str, Any] | None = None, params: Sequence[str] = (),
                 name: str | None = None, out_layout: str = "NHWC",
                 n_outputs: int = 1) -> OpNode:
        if name is None:
            name = f"{op_type}_{next(self._counter)}"
        outs = []
        for i in range(n_outputs):
            oname = name if n_outputs == 1 else f"{name}.{i}"
            self.tensors[oname] = TensorSpec(oname, tuple(out_shape), "float32",
                                             out_layout, producer=name)
            outs.append(oname)
        node = OpNode(name=name, op_type=op_type, inputs=list(inputs),
                      outputs=outs, attrs=dict(attrs or {}), params=list(params))
        self.nodes.append(node)
        return node

    def mark_output(self, tensor_name: str) -> None:
        self.outputs.append(tensor_name)

    # -- queries -------------------------------------------------------------
    def node_by_name(self, name: str) -> OpNode:
        for n in self.nodes:
            if n.name == name:
                return n
        raise KeyError(name)

    def producer_of(self, tensor_name: str) -> OpNode | None:
        spec = self.tensors[tensor_name]
        return self.node_by_name(spec.producer) if spec.producer else None

    def consumers_of(self, tensor_name: str) -> list[OpNode]:
        return [n for n in self.nodes if tensor_name in n.inputs]

    def successors(self, node: OpNode) -> list[OpNode]:
        out: list[OpNode] = []
        for t in node.outputs:
            out.extend(self.consumers_of(t))
        return out

    def predecessors(self, node: OpNode) -> list[OpNode]:
        preds = []
        for t in node.inputs:
            p = self.producer_of(t)
            if p is not None:
                preds.append(p)
        return preds

    def toposorted(self) -> list[OpNode]:
        """Nodes are appended in topological order by construction; verify."""
        seen: set[str] = set(self.inputs) | set(self.params)
        for n in self.nodes:
            for t in n.inputs + n.params:
                if t not in seen and t not in self.tensors:
                    raise ValueError(f"{n.name} reads unknown tensor {t}")
                if self.tensors[t].producer is not None and t not in seen:
                    raise ValueError(f"graph not topologically ordered at {n.name}")
            seen.update(n.outputs)
        return list(self.nodes)

    # -- stats (used by cost model & benchmarks) ------------------------------
    def num_ops(self) -> int:
        return len(self.nodes)

    def param_bytes(self) -> int:
        return sum(self.tensors[p].nbytes() for p in self.params)

    def intermediate_bytes(self) -> int:
        interm = set(self.tensors) - set(self.inputs) - set(self.params) - set(self.outputs)
        return sum(self.tensors[t].nbytes() for t in interm)

    def clone(self) -> "Graph":
        g = Graph(self.name)
        g.nodes = [dataclasses.replace(n, inputs=list(n.inputs), outputs=list(n.outputs),
                                       attrs=dict(n.attrs), params=list(n.params),
                                       dataflow=dict(n.dataflow)) for n in self.nodes]
        g.tensors = {k: dataclasses.replace(v) for k, v in self.tensors.items()}
        g.inputs = list(self.inputs)
        g.params = list(self.params)
        g.outputs = list(self.outputs)
        return g

    def __repr__(self) -> str:
        return f"Graph({self.name}, {len(self.nodes)} ops, {len(self.params)} params)"


# ---------------------------------------------------------------------------
# Graph builders: convenience layer used by the CNN zoo and tests
# ---------------------------------------------------------------------------

def conv2d(g: Graph, x: str, out_c: int, ksize: int, stride: int = 1,
            padding: str = "SAME", depthwise: bool = False,
            name: str | None = None) -> str:
    """Add a conv (+implicit weight param) node; returns output tensor name."""
    spec = g.tensors[x]
    n, h, w, c = _nhwc_shape(spec)
    if padding == "SAME":
        oh, ow = -(-h // stride), -(-w // stride)
    else:
        oh, ow = (h - ksize) // stride + 1, (w - ksize) // stride + 1
    op = "dwconv" if depthwise else "conv"
    node_name = name or f"{op}_{next(g._counter)}"
    if depthwise:
        wshape = (ksize, ksize, c, 1)
        out_c = c
    else:
        wshape = (ksize, ksize, c, out_c)
    wname = g.add_param(f"{node_name}.w", wshape)
    node = g.add_node(op, [x], (n, oh, ow, out_c),
                      attrs={"ksize": ksize, "stride": stride, "padding": padding},
                      params=[wname], name=node_name)
    return node.outputs[0]


def bn(g: Graph, x: str, name: str | None = None) -> str:
    spec = g.tensors[x]
    c = _nhwc_shape(spec)[-1]
    node_name = name or f"bn_{next(g._counter)}"
    scale = g.add_param(f"{node_name}.scale", (c,))
    shift = g.add_param(f"{node_name}.shift", (c,))
    node = g.add_node("bn", [x], spec.shape, params=[scale, shift], name=node_name)
    return node.outputs[0]


def bias(g: Graph, x: str, name: str | None = None) -> str:
    spec = g.tensors[x]
    c = _nhwc_shape(spec)[-1]
    node_name = name or f"bias_{next(g._counter)}"
    b = g.add_param(f"{node_name}.b", (c,))
    node = g.add_node("bias", [x], spec.shape, params=[b], name=node_name)
    return node.outputs[0]


def relu(g: Graph, x: str, name: str | None = None) -> str:
    spec = g.tensors[x]
    node = g.add_node("relu", [x], spec.shape, name=name)
    return node.outputs[0]


def pool(g: Graph, x: str, kind: str, ksize: int = 2, stride: int | None = None,
         name: str | None = None) -> str:
    """kind in {'avg','max','global_avg'}"""
    spec = g.tensors[x]
    n, h, w, c = _nhwc_shape(spec)
    if kind == "global_avg":
        out_shape: tuple[int, ...] = (n, 1, 1, c)
        attrs = {"kind": kind}
    else:
        stride = stride or ksize
        out_shape = (n, h // stride, w // stride, c)
        attrs = {"kind": kind, "ksize": ksize, "stride": stride}
    node = g.add_node("gampool", [x], out_shape, attrs=attrs, name=name)
    return node.outputs[0]


def matmul(g: Graph, x: str, out_features: int, name: str | None = None) -> str:
    spec = g.tensors[x]
    in_features = spec.shape[-1]
    node_name = name or f"matmul_{next(g._counter)}"
    w = g.add_param(f"{node_name}.w", (in_features, out_features))
    b = g.add_param(f"{node_name}.b", (out_features,))
    node = g.add_node("matmul", [x], spec.shape[:-1] + (out_features,),
                      params=[w, b], name=node_name, out_layout="")
    return node.outputs[0]


def add(g: Graph, a: str, b_: str, name: str | None = None) -> str:
    spec = g.tensors[a]
    node = g.add_node("add", [a, b_], spec.shape, name=name)
    return node.outputs[0]


def concat(g: Graph, xs: Sequence[str], axis: int = -1, name: str | None = None) -> str:
    specs = [g.tensors[x] for x in xs]
    ax = axis if axis >= 0 else len(specs[0].shape) + axis
    out_shape = list(specs[0].shape)
    out_shape[ax] = sum(s.shape[ax] for s in specs)
    node = g.add_node("concat", list(xs), tuple(out_shape), attrs={"axis": ax}, name=name)
    return node.outputs[0]


def flatten(g: Graph, x: str, name: str | None = None) -> str:
    spec = g.tensors[x]
    n = spec.shape[0]
    rest = 1
    for s in spec.shape[1:]:
        rest *= s
    node = g.add_node("flatten", [x], (n, rest), name=name, out_layout="")
    return node.outputs[0]


def softmax(g: Graph, x: str, name: str | None = None) -> str:
    spec = g.tensors[x]
    node = g.add_node("softmax", [x], spec.shape, name=name, out_layout="")
    return node.outputs[0]


def _nhwc_shape(spec: TensorSpec) -> tuple[int, int, int, int]:
    if spec.rank != 4:
        raise ValueError(f"expected rank-4 feature map, got {spec.shape}")
    return spec.shape  # type: ignore[return-value]
