"""Computation-graph IR: the part of ``repro.core.graph`` serving needs.

The port's serving planner runs the ``serve_schedule`` and
``kernel_select`` passes over a tiny proxy graph of the per-tick decode
workload (``serving.scheduler.serve_plan_graph``).  This module keeps the
IR those passes and the pass manager's verifier read, plus the two
builders that graph uses (:func:`matmul`, :func:`softmax`).  The CNN
builders and the vertical/horizontal graph passes follow with ROADMAP
queue 1 item 6.

Same contract as the reference: a closed operator vocabulary (paper
Table 3) and optimization as metadata rewrites (``OpNode.dataflow``).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Any, Sequence

#: rank-4 feature-map layouts (kept so verify_graph checks what the
#: reference checks)
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


#: op_type -> description: the closed vocabulary of paper Table 3
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
    """One operator instance; passes write only its ``dataflow`` dict."""

    name: str
    op_type: str
    inputs: list[str]
    outputs: list[str]
    attrs: dict[str, Any] = dataclasses.field(default_factory=dict)
    params: list[str] = dataclasses.field(default_factory=list)
    dataflow: dict[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self) -> None:
        if self.op_type not in OP_VOCABULARY:
            raise ValueError(
                f"op_type {self.op_type!r} is not in the Xenos operator "
                f"vocabulary (Table 3): {sorted(OP_VOCABULARY)}")


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

    def add_input(self, name: str, shape: Sequence[int], dtype: str = "float32",
                  layout: str = "NHWC") -> str:
        self.tensors[name] = TensorSpec(name, tuple(shape), dtype, layout)
        self.inputs.append(name)
        return name

    def add_param(self, name: str, shape: Sequence[int],
                  dtype: str = "float32") -> str:
        self.tensors[name] = TensorSpec(name, tuple(shape), dtype, layout="")
        self.params.append(name)
        return name

    def add_node(self, op_type: str, inputs: Sequence[str],
                 out_shape: Sequence[int],
                 attrs: dict[str, Any] | None = None,
                 params: Sequence[str] = (), name: str | None = None,
                 out_layout: str = "NHWC") -> OpNode:
        if name is None:
            name = f"{op_type}_{next(self._counter)}"
        self.tensors[name] = TensorSpec(name, tuple(out_shape), "float32",
                                        out_layout, producer=name)
        node = OpNode(name=name, op_type=op_type, inputs=list(inputs),
                      outputs=[name], attrs=dict(attrs or {}),
                      params=list(params))
        self.nodes.append(node)
        return node

    def mark_output(self, tensor_name: str) -> None:
        self.outputs.append(tensor_name)

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

    def num_ops(self) -> int:
        return len(self.nodes)

    def clone(self) -> "Graph":
        g = Graph(self.name)
        g.nodes = [dataclasses.replace(n, inputs=list(n.inputs),
                                       outputs=list(n.outputs),
                                       attrs=dict(n.attrs),
                                       params=list(n.params),
                                       dataflow=dict(n.dataflow))
                   for n in self.nodes]
        g.tensors = {k: dataclasses.replace(v) for k, v in self.tensors.items()}
        g.inputs = list(self.inputs)
        g.params = list(self.params)
        g.outputs = list(self.outputs)
        return g


def link_groups(g: Graph) -> dict[int, list[OpNode]]:
    """Group id -> member nodes, in topological order (operator linking
    metadata; no ported pass writes it yet, the verifier reads it)."""
    groups: dict[int, list[OpNode]] = {}
    for n in g.nodes:
        gid = n.dataflow.get("link_group")
        if gid is not None:
            groups.setdefault(gid, []).append(n)
    return groups


def matmul(g: Graph, x: str, out_features: int, name: str | None = None) -> str:
    spec = g.tensors[x]
    in_features = spec.shape[-1]
    node_name = name or f"matmul_{next(g._counter)}"
    w = g.add_param(f"{node_name}.w", (in_features, out_features))
    b = g.add_param(f"{node_name}.b", (out_features,))
    node = g.add_node("matmul", [x], spec.shape[:-1] + (out_features,),
                      params=[w, b], name=node_name, out_layout="")
    return node.outputs[0]


def softmax(g: Graph, x: str, name: str | None = None) -> str:
    spec = g.tensors[x]
    node = g.add_node("softmax", [x], spec.shape, name=name, out_layout="")
    return node.outputs[0]
