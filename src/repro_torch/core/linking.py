"""Vertical dataflow optimization: operator linking (paper §4.1).

Two rewrites, both metadata-level (the operator vocabulary is closed):

1. **Preprocessing fusion** (paper §3): ``Conv -> Bn -> Bias? -> Relu``
   collapses into the Table-3 ``cbr`` op.  BN scale/shift are *folded into*
   the conv weight/bias at optimization time — inference-time BN is an affine
   transform, so this is exact.

2. **Operator linking**: for every Table-1 pattern the pass
   (a) rewrites ``Conv->Pool`` pairs into the Table-3 linked ops ``cbra`` /
       ``cbrm`` (conv writes each 2x2 output square in the pool's read order;
       the pooled value is produced on the fly — Figure 4), and
   (b) tags longer chains (``conv->conv``, ``matmul->matmul``, shortcut) with
       a shared ``link_group`` id plus a ``write_layout`` so the engine
       executes the whole group as ONE fused region: the intermediate tensor
       never round-trips through HBM and no transpose is materialized.

On TPU this is precisely the VMEM-residency argument: a linked group lowers
to a single fused XLA computation (or a Pallas kernel from
``repro.kernels``), so the producer's write order *is* the consumer's read
order by construction.
"""
from __future__ import annotations

import itertools
from typing import Any

from . import patterns as P
from .graph import Graph, OpNode, TensorSpec


def fuse_cbr(g: Graph) -> Graph:
    """Collapse Conv->Bn->Bias?->Relu chains into ``cbr`` nodes (in place on a clone)."""
    g = g.clone()
    for match in P.find_cbr_fusions(g):
        nodes = [g.node_by_name(n) for n in match.nodes]
        conv, tail = nodes[0], nodes[1:]
        # fold: keep the conv's params and remember which affine params to fold
        fold_params: list[str] = list(conv.params)
        fold_ops: list[str] = [conv.op_type]
        for n in tail:
            fold_params.extend(n.params)
            fold_ops.append(n.op_type)
        last = nodes[-1]
        cbr = OpNode(
            name=conv.name + ".cbr",
            op_type="cbr",
            inputs=list(conv.inputs),
            outputs=list(last.outputs),
            attrs={**conv.attrs, "chain": fold_ops,
                   "depthwise": conv.op_type == "dwconv"},
            params=fold_params,
            dataflow={"fused_from": [n.name for n in nodes]},
        )
        # splice: replace the chain with the fused node at the conv's position
        idx = g.nodes.index(conv)
        for n in nodes:
            g.nodes.remove(n)
        g.nodes.insert(idx, cbr)
        # the fused node now produces the tail's output tensor
        for t in cbr.outputs:
            g.tensors[t].producer = cbr.name
        # intermediate tensors disappear from the graph
        for n in nodes[:-1]:
            for t in n.outputs:
                if t in g.tensors and not g.consumers_of(t) and t not in g.outputs:
                    del g.tensors[t]
    return g


def link(g: Graph) -> Graph:
    """Apply operator linking to every Table-1 match (returns a rewritten clone)."""
    g = g.clone()
    group_ids = itertools.count(1)

    # (a) Conv/CBR -> Pool  =>  linked cbra/cbrm op
    for match in P.find_link_patterns(g):
        if match.kind not in ("conv_pool", "conv_conv_pool"):
            continue
        names = match.nodes
        # only rewrite the trailing (conv, pool) pair into the linked op; a
        # leading conv joins via link_group below.
        conv = g.node_by_name(names[-2])
        pool_node = g.node_by_name(names[-1])
        if conv.op_type not in ("conv", "cbr") or pool_node.attrs.get("kind") == "global_avg":
            linked_type = None
        else:
            linked_type = {"avg": "cbra", "max": "cbrm"}.get(pool_node.attrs.get("kind", ""))
        if linked_type is None:
            # fall back to pure metadata linking
            gid = next(group_ids)
            for nm in names:
                g.node_by_name(nm).dataflow["link_group"] = gid
            continue
        linked = OpNode(
            name=conv.name + "." + linked_type,
            op_type=linked_type,
            inputs=list(conv.inputs),
            outputs=list(pool_node.outputs),
            attrs={**conv.attrs, "pool": pool_node.attrs,
                   "chain": conv.attrs.get("chain", [conv.op_type])},
            params=list(conv.params),
            dataflow={"fused_from": [conv.name, pool_node.name],
                      "write_layout": "pool_zigzag"},  # Figure-4 zigzag order
        )
        idx = g.nodes.index(conv)
        g.nodes.remove(conv)
        g.nodes.remove(pool_node)
        g.nodes.insert(idx, linked)
        for t in linked.outputs:
            g.tensors[t].producer = linked.name
        for t in conv.outputs:
            if t in g.tensors and not g.consumers_of(t) and t not in g.outputs:
                del g.tensors[t]
        if len(names) == 3:  # leading conv links into the group
            gid = next(group_ids)
            g.node_by_name(names[0]).dataflow["link_group"] = gid
            linked.dataflow["link_group"] = gid

    # (b) remaining multi-op chains: shared link_group + propagated layout
    for match in P.find_link_patterns(g):
        if match.kind in ("conv_pool", "conv_conv_pool"):
            continue
        gid = next(group_ids)
        for nm in match.nodes:
            node = g.node_by_name(nm)
            node.dataflow.setdefault("link_group", gid)
        # producer writes in the consumer's preferred layout: channel-last
        head = g.node_by_name(match.nodes[0])
        for t in head.outputs:
            if g.tensors[t].rank == 4:
                g.tensors[t].layout = "NHWC"
        head.dataflow["write_layout"] = "consumer_order"

    return g


def optimize(g: Graph) -> Graph:
    """The full vertical pass: fuse, then link."""
    return link(fuse_cbr(g))


def link_groups(g: Graph) -> dict[int, list[OpNode]]:
    """Group id -> member nodes, in topological order."""
    groups: dict[int, list[OpNode]] = {}
    for n in g.nodes:
        gid = n.dataflow.get("link_group")
        if gid is not None:
            groups.setdefault(gid, []).append(n)
    return groups
