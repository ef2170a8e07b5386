"""Xenos runtime of the port: executes an (optimized) computation graph
with PyTorch on the card (the counterpart of ``repro.core.engine``).

Three execution modes mirror the paper's Fig.-7 ablation:

* ``vanilla`` — the unoptimized dataflow: every operator is dispatched
  separately, unfused, and intermediates are *stored* in the mismatched
  layout (NCHW, a materialized copy) while every operator *reads* NHWC —
  the Figure-2 write/read-order mismatch as explicit transposes and a
  device-memory round trip per op, with a ``torch.cuda.synchronize()``
  at every op boundary on the card.
* ``ho`` — horizontal optimization only: DOS split plans annotate every
  compute op and large contractions execute in private-memory-sized chunks;
  dispatch is still per op and the layout mismatch remains (VO is off).
* ``xenos`` — HO + VO: the linked graph runs as one dispatch with matched
  layouts (no transposes).  On the card the whole forward is captured
  once into a ``torch.cuda.CUDAGraph`` over static input buffers and
  replayed (the counterpart of the reference's single ``jax.jit``); on
  the CPU it runs eagerly.  ``Engine(..., graphed=False)`` runs it eagerly
  on the card too.

Feature maps are NHWC at every op boundary and channel-last in memory, so
cuDNN reads them without a copy (``x.permute(0, 3, 1, 2)`` of a contiguous
NHWC tensor is a ``channels_last`` NCHW view).  Convs run through cuDNN in
the precision ``torch.backends.cudnn.allow_tf32`` sets; callers that hold
the engine to fp32 references turn TF32 off.

The ``linked_matmul`` site of a ``KernelPlan`` routes an eligible linked
``cbra`` op (1x1 conv, stride 1, 2x2 pool) to the hand-written
``cbr_avgpool`` CUDA kernel (``kernels/linked_cbr_pool``); its
``split_matmul`` site routes the DOS parameter split of a matmul (``ho``
and ``xenos``) to the ``split_matmul`` kernel (``kernels/split_matmul``).
On CPU tensors each kernel's wrapper runs its plain version.

``build_engine`` runs the per-mode pipeline and wraps the result; it
returns the PassReport too.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from .. import resolve_device
from .. import kernels
from .dos import SplitPlan
from .graph import Graph, OpNode

# ---------------------------------------------------------------------------
# Parameter initialization & CBR folding
# ---------------------------------------------------------------------------


def init_params(g: Graph, seed: int = 0, device="cuda"
                ) -> dict[str, torch.Tensor]:
    """The reference's draws (same numpy generator, same order), so one
    seed gives one set of weights in both packages."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    out: dict[str, torch.Tensor] = {}
    for name in g.params:
        spec = g.tensors[name]
        if name.endswith(".scale"):
            arr = np.abs(rng.normal(1.0, 0.1, spec.shape))
        elif name.endswith((".shift", ".b")):
            arr = rng.normal(0.0, 0.02, spec.shape)
        else:
            fan_in = int(np.prod(spec.shape[:-1])) or 1
            arr = rng.normal(0.0, (2.0 / fan_in) ** 0.5, spec.shape)
        out[name] = torch.from_numpy(arr.astype(np.float32)).to(dev)
    return out


def fold_cbr(node: OpNode, params: dict[str, torch.Tensor]
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold BN scale/shift (+bias) into the conv weight/bias — exact at
    inference."""
    w = params[node.params[0]]
    depthwise = node.op_type == "dwconv" or node.attrs.get("depthwise")
    out_c = w.shape[2] if depthwise else w.shape[-1]
    scale = torch.ones((out_c,), dtype=torch.float32, device=w.device)
    shift = torch.zeros((out_c,), dtype=torch.float32, device=w.device)
    for p in node.params[1:]:
        if p.endswith(".scale"):
            scale = scale * params[p]
        elif p.endswith(".shift") or p.endswith(".b"):
            shift = shift + params[p]
    if node.attrs.get("depthwise"):
        w = w * scale[None, None, :, None]
    else:
        w = w * scale[None, None, None, :]
    return w, shift


# ---------------------------------------------------------------------------
# Operator semantics (NHWC)
# ---------------------------------------------------------------------------


def same_padding(size: int, ksize: int, stride: int) -> tuple[int, int]:
    """XLA's ``"SAME"`` padding of one spatial dim: (low, high).  The total
    is ``max((out - 1) * stride + ksize - size, 0)`` with ``out =
    ceil(size / stride)``; the low side takes the smaller half, so a
    stride-2 3x3 conv on an even input pads (0, 1)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + ksize - size, 0)
    return total // 2, total - total // 2


def _conv(x, w, stride: int, padding: str, depthwise: bool = False):
    """x (N,H,W,C) NHWC, w HWIO (k,k,C,OC) or depthwise (k,k,C,1)."""
    k = w.shape[0]
    xc = x.permute(0, 3, 1, 2)                     # channels_last NCHW view
    if depthwise:
        wt, groups = w.permute(2, 3, 0, 1), x.shape[-1]    # (C,1,k,k)
    else:
        wt, groups = w.permute(3, 2, 0, 1), 1              # (OC,C,k,k)
    pad: tuple[int, int] = (0, 0)
    if padding == "SAME":
        (hl, hh), (wl, wh) = (same_padding(x.shape[1], k, stride),
                              same_padding(x.shape[2], k, stride))
        if hl == hh and wl == wh:
            pad = (hl, wl)
        else:                       # asymmetric: F.conv2d pads evenly only
            xc = F.pad(xc, (wl, wh, hl, hh))
    elif padding != "VALID":
        raise ValueError(f"unknown padding {padding!r}")
    y = F.conv2d(xc, wt, stride=stride, padding=pad, groups=groups)
    return y.permute(0, 2, 3, 1)


def _pool(x, kind: str, ksize: int = 2, stride: int | None = None):
    if kind == "global_avg":
        return torch.mean(x, dim=(1, 2), keepdim=True)
    stride = stride or ksize
    xc = x.permute(0, 3, 1, 2)
    if kind == "max":
        y = F.max_pool2d(xc, ksize, stride)
    else:
        y = F.avg_pool2d(xc, ksize, stride)
    return y.permute(0, 2, 3, 1)


def _split_kernel(x, w, b, block_n: int, block_k: int):
    """x (..., K) through the ``split_matmul`` kernel, leading dims
    flattened."""
    from ..kernels.split_matmul import ops as split_ops
    y = split_ops.split_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w,
                               b, block_n=block_n, block_k=block_k)
    return y.reshape(*x.shape[:-1], w.shape[1])


def _matmul_split(x, w, b, plan: SplitPlan | None, backend: str = "torch"):
    """Matmul with HO param split: contract in K-chunks sized to the
    private tier (§4.2.2).  ``backend`` is the ``split_matmul`` site of a
    ``KernelPlan``: ``"cuda"`` runs each split the reference makes as one
    ``split_matmul`` launch (``block_n = N / K`` or ``block_k = C / inC``);
    a matmul the reference leaves unsplit stays ``x @ w + b``."""
    if plan is None or not plan.param_chunks:
        return x @ w + b
    k_chunks = plan.param_chunks.get("K", 1)
    if k_chunks > 1 and w.shape[1] % k_chunks == 0:
        if backend == "cuda":
            return _split_kernel(x, w, b, w.shape[1] // k_chunks, w.shape[0])
        # output-channel split: y_i = W_i x + B_i, joined by concat (Eq. 1)
        ws = torch.chunk(w, k_chunks, dim=1)
        bs = torch.chunk(b, k_chunks, dim=0)
        return torch.cat([x @ wi + bi for wi, bi in zip(ws, bs)], dim=-1)
    c_chunks = plan.param_chunks.get("inC", 1)
    if c_chunks > 1 and w.shape[0] % c_chunks == 0:
        if backend == "cuda":
            return _split_kernel(x, w, b, w.shape[1], w.shape[0] // c_chunks)
        xs = torch.chunk(x, c_chunks, dim=-1)
        ws = torch.chunk(w, c_chunks, dim=0)
        acc = b
        for xi, wi in zip(xs, ws):  # inC split needs the extra reduction
            acc = acc + xi @ wi
        return acc
    return x @ w + b


def links_to_kernel(node: OpNode) -> bool:
    """A linked ``cbra`` the ``cbr_avgpool`` kernel computes: 1x1 conv at
    stride 1, then a 2x2 average pool at stride 2."""
    a = node.attrs
    pool = a.get("pool", {})
    return (node.op_type == "cbra" and a.get("ksize", 1) == 1
            and a.get("stride", 1) == 1 and pool.get("ksize", 2) == 2
            and (pool.get("stride") or 2) == 2)


def eval_op(node: OpNode, inputs: list[torch.Tensor],
            params: dict[str, torch.Tensor],
            linked_backend: str = "torch",
            split_backend: str = "torch") -> list[torch.Tensor]:
    """Evaluate one op in NHWC semantics.  ``linked_backend`` is the
    ``linked_matmul`` site of a ``KernelPlan``: ``"cuda"`` lowers eligible
    linked ``cbra`` ops to the ``cbr_avgpool`` kernel.  ``split_backend``
    is its ``split_matmul`` site: ``"cuda"`` lowers a matmul's DOS
    parameter split to the ``split_matmul`` kernel."""
    t = node.op_type
    a = node.attrs
    plan: SplitPlan | None = node.dataflow.get("split_plan")
    x = inputs[0] if inputs else None

    if t in ("conv", "dwconv"):
        w = params[node.params[0]]
        y = _conv(x, w, a.get("stride", 1), a.get("padding", "SAME"),
                  depthwise=(t == "dwconv"))
        return [y]
    if t == "cbr":
        w, b = fold_cbr(node, params)
        y = _conv(x, w, a.get("stride", 1), a.get("padding", "SAME"),
                  depthwise=a.get("depthwise", False))
        return [torch.relu(y + b)]
    if t in ("cbra", "cbrm"):
        w, b = fold_cbr(node, params)
        if linked_backend == "cuda" and links_to_kernel(node):
            from ..kernels.linked_cbr_pool import ops as cbra_ops
            return [cbra_ops.cbr_avgpool(x.contiguous(), w, b)]
        pool_attrs = a.get("pool", {})
        y = torch.relu(_conv(x, w, a.get("stride", 1),
                             a.get("padding", "SAME"),
                             depthwise=a.get("depthwise", False)) + b)
        kind = "avg" if t == "cbra" else "max"
        return [_pool(y, kind, pool_attrs.get("ksize", 2),
                      pool_attrs.get("stride"))]
    if t == "bn":
        scale, shift = params[node.params[0]], params[node.params[1]]
        return [x * scale + shift]
    if t == "bias":
        return [x + params[node.params[0]]]
    if t == "relu":
        return [torch.relu(x)]
    if t == "gampool":
        return [_pool(x, a["kind"], a.get("ksize", 2), a.get("stride"))]
    if t == "matmul":
        if not node.params:  # dynamic two-operand form (attention scores)
            return [inputs[0] @ inputs[1]]
        w, b = params[node.params[0]], params[node.params[1]]
        return [_matmul_split(x, w, b, plan, split_backend)]
    if t == "add":
        return [inputs[0] + inputs[1]]
    if t == "mul":
        return [inputs[0] * inputs[1]]
    if t == "mac":
        return [inputs[0] * inputs[1] + inputs[2]]
    if t == "concat":
        return [torch.cat(inputs, dim=a.get("axis", -1))]
    if t == "split":
        return list(torch.tensor_split(x, a["sections"], dim=a.get("axis", -1)))
    if t == "flatten":
        return [x.reshape(x.shape[0], -1)]
    if t == "softmax":
        return [torch.softmax(x, dim=-1)]
    if t == "transpose":
        return [x.permute(*a.get("perm"))]
    raise NotImplementedError(t)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------


def _to_storage(x: torch.Tensor) -> torch.Tensor:
    """NHWC compute layout -> NCHW storage layout (the mismatched write),
    materialized: a permuted view would make the mismatch free."""
    return x.permute(0, 3, 1, 2).contiguous() if x.dim() == 4 else x


def _from_storage(x: torch.Tensor) -> torch.Tensor:
    """NCHW storage -> a materialized NHWC copy (the mismatched read)."""
    return x.permute(0, 2, 3, 1).contiguous() if x.dim() == 4 else x


class Engine:
    """Executes a graph in one of the three ablation modes.

    ``graphed`` (xenos on the card only, default True) captures the whole
    forward into one CUDA graph at the first call; later calls copy the
    inputs into the static buffers and replay.  The graph reads the
    parameters at the addresses it was captured with, so it is keyed on
    the address, shape and dtype of every parameter the graph names and
    on the input shapes: a call that brings a different tensor for any
    of them captures again (it keeps the tensors it read alive, so no
    address is reused behind its back; writing new values into a
    captured tensor in place is seen by the next replay).  The returned
    tensors are the graph's static outputs, overwritten by the next
    call.  A capture that fails raises.
    """

    def __init__(self, g: Graph, mode: str = "xenos", plan=None,
                 graphed: bool = True):
        from .pipeline import KernelPlan
        if mode not in ("vanilla", "ho", "xenos"):
            raise ValueError(f"unknown engine mode {mode!r}")
        self.graph = g
        self.mode = mode
        #: KernelPlan routing the linked-op and split-matmul lowerings;
        #: defaults to the plain-torch seed plan (``KernelPlan()``).  The
        #: per-op modes (vanilla, ho) link nothing, so only its
        #: ``split_matmul`` site applies there.
        self.plan = plan if plan is not None else KernelPlan()
        self.graphed = graphed
        self._param_names = sorted({p for n in g.nodes for p in n.params})
        self._cuda_graph: dict[str, Any] | None = None

    # -- the whole graph in one dispatch (xenos mode) ------------------------
    def _forward(self, params, inputs):
        g = self.graph
        env: dict[str, torch.Tensor] = dict(zip(g.inputs, inputs))
        for node in g.nodes:
            ins = [env[t] for t in node.inputs]
            outs = eval_op(node, ins, params, self.plan.linked_matmul,
                           self.plan.split_matmul)
            env.update(zip(node.outputs, outs))
        return tuple(env[t] for t in g.outputs)

    def _graph_key(self, params, inputs) -> tuple:
        return (tuple((params[n].data_ptr(), params[n].shape, params[n].dtype)
                      for n in self._param_names),
                tuple((x.shape, x.dtype) for x in inputs))

    def _capture(self, params, inputs, key) -> dict[str, Any]:
        """Warm up on a side stream, then capture one forward.  The
        wrappers count the launches the capture records in
        ``kernels.RECORDED`` (a capture launches nothing)."""
        static_in = [x.clone() for x in inputs]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            self._forward(params, static_in)
        torch.cuda.current_stream().wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        before = dict(kernels.RECORDED)
        with kernels.graph_capture(graph):
            static_out = self._forward(params, static_in)
        recorded = {k: kernels.RECORDED[k] - before[k]
                    for k in kernels.RECORDED}
        return {"key": key, "params": [params[n] for n in self._param_names],
                "graph": graph, "inputs": static_in, "outputs": static_out,
                "launches": recorded}

    def _replay(self, params, inputs):
        key = self._graph_key(params, inputs)
        if self._cuda_graph is None or self._cuda_graph["key"] != key:
            self._cuda_graph = None       # free the old graph's pool first
            self._cuda_graph = self._capture(params, inputs, key)
        cg = self._cuda_graph
        for dst, src in zip(cg["inputs"], inputs):
            dst.copy_(src)
        cg["graph"].replay()
        # a replay launches the recorded kernels without their wrappers:
        # this is where a graphed run's launches are counted
        for k, n in cg["launches"].items():
            kernels.LAUNCHES[k] += n
        return cg["outputs"]

    def __call__(self, params: dict[str, torch.Tensor], *inputs: torch.Tensor,
                 block: bool = True):
        cuda = bool(inputs) and inputs[0].is_cuda
        if self.mode == "xenos":
            if cuda and self.graphed:
                out = self._replay(params, inputs)
            else:
                out = self._forward(params, inputs)
            if cuda and block:
                torch.cuda.synchronize()
            return out
        return self._run_per_op(params, inputs, block and cuda)

    # -- per-op dispatch with layout mismatch (vanilla / ho modes) -----------
    def _run_per_op(self, params, inputs, sync: bool):
        g = self.graph
        env: dict[str, torch.Tensor] = {
            name: _to_storage(x) for name, x in zip(g.inputs, inputs)}
        for node in g.nodes:
            ins = [_from_storage(env[t]) for t in node.inputs]  # mismatched read
            outs = eval_op(node, ins, params, "torch",
                           self.plan.split_matmul)
            env.update(zip(node.outputs, (_to_storage(o) for o in outs)))
            if sync:
                torch.cuda.synchronize()  # per-op dispatch boundary
        result = tuple(_from_storage(env[t]) for t in g.outputs)
        if sync:
            torch.cuda.synchronize()
        return result


def execute(g: Graph, params: dict[str, torch.Tensor], inputs: dict[str, Any],
            mode: str = "xenos", plan=None):
    """One-shot functional execution (used by tests) on the params' device;
    ``inputs`` maps input names to arrays or tensors."""
    dev = next(iter(params.values())).device
    ins = [torch.as_tensor(inputs[name]).to(dev) for name in g.inputs]
    return Engine(g, mode, plan)(params, *ins)


def build_engine(g: Graph, mode: str = "xenos", device=None, plan=None,
                 graphed: bool = True):
    """Optimize ``g`` for ``mode`` through the pass pipeline, then wrap it.

    ``vanilla`` runs no passes, ``ho`` runs ``dos_split`` only, ``xenos``
    the full default pipeline.  ``device`` is the planner's
    :class:`~repro_torch.core.dos.DeviceSpec` (None: the H100's).  Returns
    ``(Engine, PassReport)``.  ``plan`` (``KernelPlan`` or None for the
    seed plan) routes the linked-op and split-matmul lowerings —
    ``select_kernel_plan({"accelerator": "cuda"})`` routes both to the
    CUDA kernels."""
    from .pipeline import optimize_for_mode
    opt, report = optimize_for_mode(g, mode, device)
    return Engine(opt, mode, plan, graphed), report
