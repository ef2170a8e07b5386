"""The paper's seven benchmark models (Fig. 7 / Table 2), as Xenos graphs.

The port's copy of ``repro.configs.cnn_zoo``, built on the port's graph
IR with the same builders, signatures and tensor names.  Reduced-resolution
variants of MobileNet, SqueezeNet, ShuffleNet, ResNet18, CentreNet, LSTM
and Bert-S by default — faithful in *structure* (the op sequences that
trigger the Table-1 patterns: CBR chains, conv->pool links, shortcut
connections, matmul->matmul chains) and sized to run in seconds on a CPU;
``mobilenet(res=224, width=1.0, n_classes=1000)`` and
``resnet18(res=224, width=64, n_classes=1000)`` give the published input
size and channel widths at the zoo's own depth.
"""
from __future__ import annotations

from typing import Callable

from ..core import graph as G
from ..core.graph import Graph


def _cbr_block(g: Graph, x: str, out_c: int, ksize: int, stride: int = 1,
               depthwise: bool = False) -> str:
    x = G.conv2d(g, x, out_c, ksize, stride, depthwise=depthwise)
    x = G.bn(g, x)
    x = G.relu(g, x)
    return x


def mobilenet(res: int = 32, width: float = 0.25, n_classes: int = 10) -> Graph:
    """Depthwise-separable stack (MobileNetV1 structure)."""
    g = Graph("mobilenet")
    c = lambda n: max(8, int(n * width))
    x = g.add_input("image", (1, res, res, 3))
    x = _cbr_block(g, x, c(32), 3, stride=2)
    for out_c, stride in [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2)]:
        x = _cbr_block(g, x, 0, 3, stride=stride, depthwise=True)
        x = _cbr_block(g, x, c(out_c), 1)
    x = G.pool(g, x, "global_avg")
    x = G.flatten(g, x)
    x = G.matmul(g, x, n_classes)
    x = G.softmax(g, x)
    g.mark_output(x)
    return g


def squeezenet(res: int = 32, n_classes: int = 10) -> Graph:
    """Fire modules: squeeze conv1x1 -> expand conv1x1 + conv3x3 -> concat."""
    g = Graph("squeezenet")
    x = g.add_input("image", (1, res, res, 3))
    x = _cbr_block(g, x, 16, 3, stride=2)
    x = G.pool(g, x, "max", 2)
    for squeeze_c, expand_c in [(8, 32), (8, 32), (16, 64)]:
        s = _cbr_block(g, x, squeeze_c, 1)
        e1 = _cbr_block(g, s, expand_c, 1)
        e3 = _cbr_block(g, s, expand_c, 3)
        x = G.concat(g, [e1, e3], axis=-1)
    x = G.pool(g, x, "global_avg")
    x = G.flatten(g, x)
    x = G.matmul(g, x, n_classes)
    x = G.softmax(g, x)
    g.mark_output(x)
    return g


def shufflenet(res: int = 32, n_classes: int = 10) -> Graph:
    """Grouped 1x1 convs + depthwise 3x3 (channel shuffle folded into concat)."""
    g = Graph("shufflenet")
    x = g.add_input("image", (1, res, res, 3))
    x = _cbr_block(g, x, 24, 3, stride=2)
    x = G.pool(g, x, "max", 2)
    for out_c in (48, 96):
        a = _cbr_block(g, x, out_c // 2, 1)
        a = _cbr_block(g, a, 0, 3, depthwise=True)
        a = _cbr_block(g, a, out_c // 2, 1)
        b = _cbr_block(g, x, out_c // 2, 1)
        x = G.concat(g, [a, b], axis=-1)
        x = G.pool(g, x, "avg", 2)
    x = G.pool(g, x, "global_avg")
    x = G.flatten(g, x)
    x = G.matmul(g, x, n_classes)
    x = G.softmax(g, x)
    g.mark_output(x)
    return g


def resnet18(res: int = 32, width: int = 16, n_classes: int = 10) -> Graph:
    """Basic blocks with shortcut connections (the Table-1 shortcut pattern)."""
    g = Graph("resnet18")
    x = g.add_input("image", (1, res, res, 3))
    x = _cbr_block(g, x, width, 3)
    for stage, c in enumerate((width, width * 2, width * 4)):
        stride = 1 if stage == 0 else 2
        # block with projection shortcut
        y = _cbr_block(g, x, c, 3, stride=stride)
        y = G.conv2d(g, y, c, 3)
        y = G.bn(g, y)
        sc = G.conv2d(g, x, c, 1, stride=stride)
        x = G.add(g, y, sc)
        x = G.relu(g, x)
        # identity block
        y = _cbr_block(g, x, c, 3)
        y = G.conv2d(g, y, c, 3)
        y = G.bn(g, y)
        x = G.add(g, y, x)
        x = G.relu(g, x)
    x = G.pool(g, x, "global_avg")
    x = G.flatten(g, x)
    x = G.matmul(g, x, n_classes)
    g.mark_output(x)
    return g


def centrenet(res: int = 64) -> Graph:
    """Backbone + upsample-free keypoint heads (center heatmap + wh + offset)."""
    g = Graph("centrenet")
    x = g.add_input("image", (1, res, res, 3))
    x = _cbr_block(g, x, 16, 3, stride=2)
    x = _cbr_block(g, x, 32, 3, stride=2)
    x = _cbr_block(g, x, 64, 3, stride=2)
    hm = _cbr_block(g, x, 32, 3)
    hm = G.conv2d(g, hm, 10, 1)   # heatmap head
    wh = _cbr_block(g, x, 32, 3)
    wh = G.conv2d(g, wh, 2, 1)    # width/height head
    off = _cbr_block(g, x, 32, 3)
    off = G.conv2d(g, off, 2, 1)  # offset head
    for t in (hm, wh, off):
        g.mark_output(t)
    return g


def lstm(seq: int = 8, d: int = 64, n_classes: int = 10) -> Graph:
    """Unrolled LSTM: per-step matmul->matmul chains + mac/mul/add gates.

    Gates are computed as one fused matmul of [x_t, h_{t-1}] -> 4d (the usual
    packed formulation); the elementwise gate math uses the Table-3
    mul/add/mac ops.  Approximate gate nonlinearities (relu-gated) keep the
    vocabulary closed — structure, dataflow and per-step dependencies match.
    """
    g = Graph("lstm")
    steps = []
    for t in range(seq):
        steps.append(g.add_input(f"x_{t}", (1, d), layout=""))
    h = g.add_input("h0", (1, d), layout="")
    c = g.add_input("c0", (1, d), layout="")
    for t in range(seq):
        xh = G.concat(g, [steps[t], h], axis=-1)
        gates = G.matmul(g, xh, 4 * d, name=f"gates_{t}")
        gates = G.relu(g, gates)
        parts = g.add_node("split", [gates], (1, d),
                           attrs={"sections": 4, "axis": -1},
                           name=f"split_{t}", n_outputs=4, out_layout="")
        i, f, o, u = parts.outputs
        fc = g.add_node("mul", [f, c], (1, d), name=f"fc_{t}", out_layout="").outputs[0]
        c = g.add_node("mac", [i, u, fc], (1, d), name=f"c_{t}", out_layout="").outputs[0]
        h = g.add_node("mul", [o, c], (1, d), name=f"h_{t}", out_layout="").outputs[0]
    y = G.matmul(g, h, n_classes)
    y = G.softmax(g, y)
    g.mark_output(y)
    return g


def bert_s(seq: int = 32, d: int = 64, n_layers: int = 2, n_classes: int = 10) -> Graph:
    """Small BERT encoder: QKV/attention/FFN matmul->matmul chains.

    Attention uses the dynamic (two-operand) form of the Table-3 ``matmul``
    op: ``scores = Q @ K^T`` and ``attn = softmax(scores) @ V``.
    """
    g = Graph("bert_s")
    x = g.add_input("tokens", (seq, d), layout="")
    for l in range(n_layers):
        q = G.matmul(g, x, d, name=f"q_{l}")
        k = G.matmul(g, x, d, name=f"k_{l}")
        v = G.matmul(g, x, d, name=f"v_{l}")
        kt = g.add_node("transpose", [k], (d, seq), attrs={"perm": (1, 0)},
                        name=f"kT_{l}", out_layout="").outputs[0]
        scores = g.add_node("matmul", [q, kt], (seq, seq),
                            name=f"scores_{l}", out_layout="").outputs[0]
        probs = G.softmax(g, scores, name=f"probs_{l}")
        att = g.add_node("matmul", [probs, v], (seq, d),
                         name=f"attnv_{l}", out_layout="").outputs[0]
        att = G.matmul(g, att, d, name=f"proj_{l}")
        x = G.add(g, att, x)
        h = G.matmul(g, x, 4 * d, name=f"ffn_up_{l}")
        h = G.relu(g, h)
        h = G.matmul(g, h, d, name=f"ffn_down_{l}")
        x = G.add(g, h, x)
    y = G.matmul(g, x, n_classes)
    y = G.softmax(g, y)
    g.mark_output(y)
    return g


ZOO: dict[str, Callable[[], Graph]] = {
    "mobilenet": mobilenet,
    "squeezenet": squeezenet,
    "shufflenet": shufflenet,
    "resnet18": resnet18,
    "centrenet": centrenet,
    "lstm": lstm,
    "bert_s": bert_s,
}


def build(name: str) -> Graph:
    return ZOO[name]()
