"""Automatic pattern identification (paper §4.4, Table 1).

Scans the computation graph and returns the linkable patterns:

  * ``ConvX -> ConvY``                       (e.g. Conv3x3 -> Conv1x1)
  * ``ConvX -> ConvY -> ZPooling``           (e.g. Conv3x3 -> Conv1x1 -> AvgPool)
  * ``ConvX -> ZPooling -> ConvY``
  * ``ConvX -> {... -> ConvY | ConvZ}``      (shortcut connection, ResNet)
  * ``MatmulX -> MatmulY``

plus the preprocessing fusion pattern ``Conv -> Bn -> Bias? -> Relu`` (CBR).

A match is only emitted when the intermediate tensor has exactly one
consumer (otherwise the restructured write order would break the other
reader), mirroring the paper's "sequence of adjacent operators".
"""
from __future__ import annotations

import dataclasses
from typing import Iterator

from .graph import Graph, OpNode

CONV_TYPES = ("conv", "dwconv", "cbr")
POOL_TYPE = "gampool"


@dataclasses.dataclass
class PatternMatch:
    kind: str               # 'cbr_fuse' | 'conv_conv' | 'conv_conv_pool' | ...
    nodes: list[str]        # op names, in dataflow order

    def __iter__(self) -> Iterator[str]:
        return iter(self.nodes)


def _single_consumer_chain(g: Graph, node: OpNode) -> OpNode | None:
    """The unique consumer of node's single output, or None."""
    if len(node.outputs) != 1:
        return None
    consumers = g.consumers_of(node.outputs[0])
    if len(consumers) != 1:
        return None
    if node.outputs[0] in g.outputs:
        return None  # output escapes the graph; cannot restructure its layout
    return consumers[0]


def find_cbr_fusions(g: Graph) -> list[PatternMatch]:
    """Conv -> Bn -> (Bias ->)? Relu  => CBR  (preprocessing fusion, §3)."""
    matches = []
    for node in g.nodes:
        if node.op_type not in ("conv", "dwconv"):
            continue
        chain = [node]
        cur = node
        for expected in ("bn", "bias", "relu"):
            nxt = _single_consumer_chain(g, cur)
            if nxt is None:
                break
            if nxt.op_type == expected:
                chain.append(nxt)
                cur = nxt
            elif expected == "bias":
                continue  # bias is optional
            else:
                break
        # accept conv(+bn)(+bias)+relu with at least bn or relu present
        types = [n.op_type for n in chain[1:]]
        if types and types[-1] == "relu":
            matches.append(PatternMatch("cbr_fuse", [n.name for n in chain]))
    return matches


def find_link_patterns(g: Graph) -> list[PatternMatch]:
    """Table-1 linkable patterns over the (already CBR-fused) graph."""
    matches: list[PatternMatch] = []
    claimed: set[str] = set()

    def claim(m: PatternMatch) -> None:
        matches.append(m)
        claimed.update(m.nodes)

    # longest patterns first: ConvX -> ConvY -> Pool  /  ConvX -> Pool -> ConvY
    for node in g.nodes:
        if node.name in claimed or node.op_type not in CONV_TYPES:
            continue
        n2 = _single_consumer_chain(g, node)
        if n2 is None or n2.name in claimed:
            continue
        n3 = _single_consumer_chain(g, n2)
        if n2.op_type in CONV_TYPES and n3 is not None and n3.op_type == POOL_TYPE \
                and n3.name not in claimed:
            claim(PatternMatch("conv_conv_pool", [node.name, n2.name, n3.name]))
        elif n2.op_type == POOL_TYPE and n3 is not None and n3.op_type in CONV_TYPES \
                and n3.name not in claimed:
            claim(PatternMatch("conv_pool_conv", [node.name, n2.name, n3.name]))

    # ConvX -> Pool (the cbra/cbrm linked ops of Table 3)
    for node in g.nodes:
        if node.name in claimed or node.op_type not in CONV_TYPES:
            continue
        n2 = _single_consumer_chain(g, node)
        if n2 is not None and n2.op_type == POOL_TYPE and n2.name not in claimed:
            claim(PatternMatch("conv_pool", [node.name, n2.name]))

    # ConvX -> ConvY
    for node in g.nodes:
        if node.name in claimed or node.op_type not in CONV_TYPES:
            continue
        n2 = _single_consumer_chain(g, node)
        if n2 is not None and n2.op_type in CONV_TYPES and n2.name not in claimed:
            claim(PatternMatch("conv_conv", [node.name, n2.name]))

    # MatmulX -> MatmulY (possibly through relu/softmax elementwise glue)
    for node in g.nodes:
        if node.name in claimed or node.op_type != "matmul":
            continue
        chain = [node]
        cur = node
        while True:
            nxt = _single_consumer_chain(g, cur)
            if nxt is None or nxt.name in claimed:
                break
            if nxt.op_type in ("relu", "bias"):
                chain.append(nxt)
                cur = nxt
                continue
            if nxt.op_type == "matmul":
                chain.append(nxt)
                claim(PatternMatch("matmul_matmul", [n.name for n in chain]))
            break

    # shortcut connection: ConvX -> {... -> ConvY | ConvZ} (residual add)
    for node in g.nodes:
        if node.op_type != "add" or node.name in claimed:
            continue
        preds = g.predecessors(node)
        if len(preds) == 2 and all(p.op_type in CONV_TYPES + ("add",) for p in preds):
            claim(PatternMatch("shortcut", [p.name for p in preds] + [node.name]))

    return matches


def identify(g: Graph) -> dict[str, list[PatternMatch]]:
    """Full §4.4 scan: fusions first, then link patterns."""
    return {
        "fusions": find_cbr_fusions(g),
        "links": find_link_patterns(g),
    }
