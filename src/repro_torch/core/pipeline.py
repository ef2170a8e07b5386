"""Pass manager of the port: the paper's graph passes, the serving
planner and the kernel router (the counterpart of
``repro.core.pipeline``).

Every optimization stage is a registered :class:`Pass`; :func:`optimize`
runs a pass list or a numbered level, checks the graph after every
rewrite (:func:`verify_graph` plus the pass's declared invariants),
memoizes on the graph fingerprint and returns a :class:`PassReport`.

Registered passes:

  ==================  ========================================================
  ``fuse_cbr``        preprocessing fusion Conv+Bn(+Bias)+Relu -> CBR (§3)
  ``link_operators``  vertical optimization: Table-1 linking (§4.1)
  ``dos_split``       horizontal optimization: DSP-aware operator split (§4.2)
  ``dxenos_plan``     d-Xenos partition-scheme planning, Algorithm 1 (§5)
  ``serve_schedule``  serving-schedule planning (slots/chunk/KV pool)
  ``kernel_select``   kernel routing: accelerator + cost model -> ``KernelPlan``
  ==================  ========================================================

Levels are cumulative pass prefixes (``dxenos_plan`` is opt-in because
it needs an ``n_devices`` choice): ``O0`` none (the Fig.-7 *vanilla*
dataflow), ``O1`` ``fuse_cbr``, ``O2`` + ``link_operators``, ``O3`` +
``dos_split`` (the default).

Vocabulary: the reference's ``"xla"`` backend is ``"torch"`` here (plain
PyTorch ops) and ``"pallas"`` is ``"cuda"`` (the hand-written kernels in
``repro_torch/csrc``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import time
from typing import Any, Callable, Sequence

from . import costmodel as cm
from . import dos, linking, patterns, planner
from .dos import DeviceSpec
from .graph import Graph, LAYOUTS, OP_VOCABULARY


class PipelineError(ValueError):
    """Bad pipeline configuration (unknown pass / backend)."""


class PassVerificationError(RuntimeError):
    """A pass produced a graph that fails :func:`verify_graph`."""

    def __init__(self, pass_name: str, problems: Sequence[str]):
        self.pass_name = pass_name
        self.problems = list(problems)
        detail = "\n  - ".join(self.problems)
        super().__init__(
            f"pass {pass_name!r} corrupted the graph:\n  - {detail}")


def verify_graph(g: Graph) -> list[str]:
    """Structural checks every rewrite must preserve (same checks as the
    reference): consistent producers, topological order, the closed op
    vocabulary, known rank-4 layouts, connected link groups."""
    problems: list[str] = []
    node_names = {n.name for n in g.nodes}
    if len(node_names) != len(g.nodes):
        problems.append("duplicate node names")
    produced: set[str] = set(g.inputs) | set(g.params)
    for n in g.nodes:
        for t in list(n.inputs) + list(n.params):
            if t not in g.tensors:
                problems.append(f"{n.name} reads dangling tensor {t!r}")
            elif t not in produced:
                spec = g.tensors[t]
                if spec.producer is None:
                    problems.append(
                        f"{n.name} reads {t!r} which is neither an input, a "
                        f"param, nor produced by any node")
                else:
                    problems.append(
                        f"graph not topologically ordered: {n.name} reads "
                        f"{t!r} before its producer {spec.producer!r} runs")
        for t in n.outputs:
            if t not in g.tensors:
                problems.append(f"{n.name} writes unregistered tensor {t!r}")
            elif g.tensors[t].producer != n.name:
                problems.append(
                    f"tensor {t!r} names producer {g.tensors[t].producer!r} "
                    f"but is written by {n.name}")
            produced.add(t)
        if n.op_type not in OP_VOCABULARY:
            problems.append(f"{n.name} has op_type {n.op_type!r} outside the "
                            f"Table-3 vocabulary")
    for t in g.outputs:
        if t not in g.tensors:
            problems.append(f"graph output {t!r} is a dangling tensor")
        elif t not in produced:
            problems.append(f"graph output {t!r} is never produced")
    for t, spec in g.tensors.items():
        if any((not isinstance(s, int)) or s <= 0 for s in spec.shape):
            problems.append(f"tensor {t!r} has non-positive shape {spec.shape}")
        if spec.rank == 4 and spec.layout and spec.layout not in LAYOUTS:
            problems.append(f"tensor {t!r} has unknown layout {spec.layout!r}")
        if spec.producer is not None and spec.producer not in node_names:
            problems.append(
                f"tensor {t!r} claims producer {spec.producer!r} which is "
                f"not a node in the graph")
    for gid, members in linking.link_groups(g).items():
        if len(members) < 2:
            problems.append(
                f"link_group {gid} has a single member "
                f"({members[0].name}); linking is defined on op *chains*")
            continue
        member_names = {m.name for m in members}
        frontier = [members[0].name]
        reached = {members[0].name}
        while frontier:
            m = g.node_by_name(frontier.pop())
            neighbours = {p.name for p in g.predecessors(m)}
            neighbours |= {s.name for s in g.successors(m)}
            for nb in neighbours & member_names - reached:
                reached.add(nb)
                frontier.append(nb)
        if reached != member_names:
            problems.append(
                f"link_group {gid} is not a connected region: "
                f"{sorted(member_names - reached)} detached from "
                f"{sorted(reached)}")
    return problems


# ---------------------------------------------------------------------------
# Pass + registry
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PassContext:
    """Per-run state handed to every pass."""

    device: DeviceSpec
    options: dict[str, Any] = dataclasses.field(default_factory=dict)
    #: pass-populated artifacts, merged into the pass's PassRecord.summary
    artifacts: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class Pass:
    """One registered optimization stage."""

    name: str
    fn: Callable[[Graph, PassContext], Graph]
    description: str
    invariants: tuple[tuple[str, Callable[[Graph], bool]], ...] = ()
    summarize: Callable[[Graph, Graph], dict[str, Any]] | None = None


REGISTRY: dict[str, Pass] = {}

#: cumulative optimization levels (dxenos_plan is opt-in, see module docstring)
LEVELS: dict[int, tuple[str, ...]] = {
    0: (),
    1: ("fuse_cbr",),
    2: ("fuse_cbr", "link_operators"),
    3: ("fuse_cbr", "link_operators", "dos_split"),
}
DEFAULT_LEVEL = 3


def register_pass(p: Pass) -> Pass:
    if p.name in REGISTRY:
        raise PipelineError(f"pass {p.name!r} is already registered")
    REGISTRY[p.name] = p
    return p


def resolve_passes(level: int | None = None,
                   passes: Sequence[str] | None = None) -> list[Pass]:
    """Pass list for an explicit ``passes`` selection or a numbered level."""
    if passes is not None:
        names = list(passes)
    else:
        lvl = DEFAULT_LEVEL if level is None else level
        if lvl not in LEVELS:
            raise PipelineError(f"unknown level {lvl!r}; have {sorted(LEVELS)}")
        names = list(LEVELS[lvl])
    out = []
    for name in names:
        if name not in REGISTRY:
            raise PipelineError(
                f"unknown pass {name!r}; registered: {sorted(REGISTRY)}")
        out.append(REGISTRY[name])
    return out


# ---------------------------------------------------------------------------
# Reports
# ---------------------------------------------------------------------------

def _edge_count(g: Graph) -> int:
    return sum(len(n.inputs) for n in g.nodes)


@dataclasses.dataclass
class PassRecord:
    """What one pass did to the graph."""

    name: str
    wall_s: float
    nodes_before: int
    nodes_after: int
    edges_before: int
    edges_after: int
    verified: bool
    summary: dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def node_delta(self) -> int:
        return self.nodes_after - self.nodes_before

    def as_dict(self) -> dict[str, Any]:
        return {**dataclasses.asdict(self), "node_delta": self.node_delta}


@dataclasses.dataclass
class PassReport:
    """Structured result of one :func:`optimize` run."""

    graph_name: str
    device: str
    passes: list[PassRecord] = dataclasses.field(default_factory=list)
    total_s: float = 0.0
    modeled_before_s: float = 0.0
    modeled_after_s: float = 0.0
    #: True when this report came out of the pass-result cache
    cache_hit: bool = False

    @property
    def modeled_saving(self) -> float:
        if self.modeled_before_s <= 0:
            return 0.0
        return 1.0 - self.modeled_after_s / self.modeled_before_s

    def record(self, rec: PassRecord) -> None:
        self.passes.append(rec)
        self.total_s += rec.wall_s

    def as_dict(self) -> dict[str, Any]:
        return {
            "graph": self.graph_name, "device": self.device,
            "total_s": self.total_s,
            "modeled_before_s": self.modeled_before_s,
            "modeled_after_s": self.modeled_after_s,
            "modeled_saving": self.modeled_saving,
            "cache_hit": self.cache_hit,
            "passes": [p.as_dict() for p in self.passes],
        }

    def format(self) -> str:
        """Human-readable table (what the launch modules print)."""
        lines = [f"PassReport[{self.graph_name} @ {self.device}] "
                 f"total {self.total_s * 1e3:.2f} ms, modeled saving "
                 f"{100 * self.modeled_saving:.1f}%"
                 f"{' (cache hit)' if self.cache_hit else ''}"]
        for p in self.passes:
            extras = "".join(f" {k}={v}" for k, v in p.summary.items())
            lines.append(
                f"  {p.name:16s} {p.wall_s * 1e3:7.2f} ms  "
                f"nodes {p.nodes_before:3d} -> {p.nodes_after:3d}  "
                f"edges {p.edges_before:3d} -> {p.edges_after:3d}"
                f"{extras}")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Stage timing (shared with the serving engine)
# ---------------------------------------------------------------------------

class _Stage:
    """One timed enter/exit of a named stage (see StageTimer)."""

    __slots__ = ("_timer", "_name", "_t0")

    def __init__(self, timer: "StageTimer", name: str):
        self._timer = timer
        self._name = name

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t = self._timer
        if t.synchronize is not None:
            t.synchronize()
        dt = time.perf_counter() - self._t0
        t.totals[self._name] = t.totals.get(self._name, 0.0) + dt
        t.counts[self._name] = t.counts.get(self._name, 0) + 1
        return False


class StageTimer:
    """Accumulates wall time per named stage.

    ``synchronize`` (e.g. ``torch.cuda.synchronize``) runs before a stage
    closes: CUDA launches return before the card finishes, so without it
    a stage would record launch time, and ``serve_schedule`` would plan
    from enqueue times instead of step times."""

    def __init__(self, synchronize: Callable[[], None] | None = None) -> None:
        self.synchronize = synchronize
        self.totals: dict[str, float] = {}
        self.counts: dict[str, int] = {}

    def stage(self, name: str) -> _Stage:
        return _Stage(self, name)

    def as_dict(self) -> dict[str, dict[str, float]]:
        return {k: {"total_s": v, "calls": self.counts[k],
                    "mean_s": v / self.counts[k]}
                for k, v in self.totals.items()}


# ---------------------------------------------------------------------------
# Pass-result caching + the entry point
# ---------------------------------------------------------------------------

def graph_fingerprint(g: Graph) -> str:
    """Stable content hash of a graph: structure, shapes, attrs and the
    dataflow metadata passes rewrite."""
    h = hashlib.sha256()
    h.update(repr((g.name, g.inputs, g.params, g.outputs)).encode())
    for n in g.nodes:
        h.update(repr((n.name, n.op_type, n.inputs, n.outputs, n.params,
                       sorted(n.attrs.items(), key=lambda kv: kv[0]),
                       sorted(n.dataflow.items(), key=lambda kv: kv[0]),
                       )).encode())
    for t in sorted(g.tensors):
        spec = g.tensors[t]
        h.update(repr((t, spec.shape, spec.dtype, spec.layout,
                       spec.producer)).encode())
    return h.hexdigest()


_OPTIMIZE_CACHE: dict[tuple, tuple[Graph, PassReport]] = {}
_OPTIMIZE_CACHE_MAX = 128


def clear_optimize_cache() -> None:
    _OPTIMIZE_CACHE.clear()


def _cache_key(g: Graph, plist: list[Pass], options: dict[str, Any],
               device: DeviceSpec) -> tuple:
    return (graph_fingerprint(g),
            tuple((p.name, id(p.fn)) for p in plist),
            repr(sorted(options.items(), key=lambda kv: kv[0])),
            repr(device))


def _modeled_serial_s(g: Graph, device: DeviceSpec, linked: bool) -> float:
    flops = sum(cm.op_flops(n, g.tensors) for n in g.nodes)
    byts = sum(cm.op_bytes(n, g.tensors, linked=linked) for n in g.nodes)
    return cm.roofline(flops, byts, 0.0, chips=1).serial_s


def optimize(g: Graph, device: DeviceSpec | None = None, *,
             level: int | None = None, passes: Sequence[str] | None = None,
             options: dict[str, Any] | None = None, cache: bool = True
             ) -> tuple[Graph, PassReport]:
    """Run the pipeline; returns ``(optimized_graph, report)``.

    ``level`` selects a cumulative pass prefix (default ``O3`` = fuse +
    link + DOS split); ``passes`` overrides it with an explicit ordered
    list of registered pass names.  ``options`` is pass-visible
    configuration (e.g. ``n_devices``/``sync`` for ``dxenos_plan``).
    Every pass's output is checked by :func:`verify_graph` plus the
    pass's declared invariants, and results are
    memoized on ``(graph_fingerprint, passes, options, device)`` — a
    repeated call returns clones with ``cache_hit=True``, which is what
    lets the serving scheduler re-plan every N ticks for free."""
    device = device or DeviceSpec()
    ctx = PassContext(device=device, options=dict(options or {}))
    plist = resolve_passes(level, passes)

    key: tuple | None = None
    if cache:
        key = _cache_key(g, plist, ctx.options, device)
        hit = _OPTIMIZE_CACHE.get(key)
        if hit is not None:
            cached_graph, cached_report = hit
            return cached_graph.clone(), dataclasses.replace(
                cached_report, passes=list(cached_report.passes),
                cache_hit=True)

    report = PassReport(graph_name=g.name, device=device.name)
    pre = verify_graph(g)
    if pre:
        raise PassVerificationError("<input>", pre)
    report.modeled_before_s = _modeled_serial_s(g, device, linked=False)
    out = g
    for p in plist:
        before = out
        ctx.artifacts = {}
        t0 = time.perf_counter()
        out = p.fn(before, ctx)
        wall = time.perf_counter() - t0
        problems = verify_graph(out)
        for inv_name, pred in p.invariants:
            if not pred(out):
                problems.append(f"declared invariant violated: {inv_name}")
        if problems:
            raise PassVerificationError(p.name, problems)
        summary = dict(p.summarize(before, out)) if p.summarize else {}
        summary.update(ctx.artifacts)
        report.record(PassRecord(
            name=p.name, wall_s=wall,
            nodes_before=before.num_ops(), nodes_after=out.num_ops(),
            edges_before=_edge_count(before), edges_after=_edge_count(out),
            verified=True, summary=summary))
    report.modeled_after_s = _modeled_serial_s(out, device, linked=True)
    if key is not None:
        if len(_OPTIMIZE_CACHE) >= _OPTIMIZE_CACHE_MAX:
            _OPTIMIZE_CACHE.pop(next(iter(_OPTIMIZE_CACHE)))
        _OPTIMIZE_CACHE[key] = (out.clone(), dataclasses.replace(
            report, passes=list(report.passes)))
    return out, report


# ---------------------------------------------------------------------------
# Built-in passes (the paper's stages, registered)
# ---------------------------------------------------------------------------

def _summarize_fuse(before: Graph, after: Graph) -> dict[str, Any]:
    fused = [n for n in after.nodes if n.op_type == "cbr"]
    return {"cbr_fused": len(fused)}


def _no_fusable_chain_left(g: Graph) -> bool:
    """After fusion the §3 pattern finder must come up empty (fixpoint)."""
    return not patterns.find_cbr_fusions(g)


register_pass(Pass(
    name="fuse_cbr",
    fn=lambda g, ctx: linking.fuse_cbr(g),
    description="Preprocessing fusion: Conv+Bn(+Bias)+Relu -> CBR (paper §3)",
    invariants=(("no_fusable_chain_left", _no_fusable_chain_left),),
    summarize=_summarize_fuse,
))


def _summarize_link(before: Graph, after: Graph) -> dict[str, Any]:
    groups = linking.link_groups(after)
    linked_ops = [n for n in after.nodes if n.op_type in ("cbra", "cbrm")]
    return {"link_groups": len(groups), "linked_ops": len(linked_ops)}


register_pass(Pass(
    name="link_operators",
    fn=lambda g, ctx: linking.link(g),
    description="Vertical optimization: Table-1 operator linking (paper §4.1)",
    summarize=_summarize_link,
))


def _summarize_dos(before: Graph, after: Graph) -> dict[str, Any]:
    plans = dos.plans(after)
    split = [p for p in plans.values() if p.param_chunks]
    worst = max((p.imbalance for p in plans.values()), default=0.0)
    return {"split_plans": len(plans), "param_splits": len(split),
            "max_imbalance": round(worst, 4)}


def _all_compute_planned(g: Graph) -> bool:
    return all("split_plan" in n.dataflow for n in g.nodes
               if n.op_type in dos.COMPUTE_OPS)


register_pass(Pass(
    name="dos_split",
    fn=lambda g, ctx: dos.optimize(g, ctx.device),
    description="Horizontal optimization: DSP-aware operator split (paper §4.2)",
    invariants=(("every_compute_op_has_split_plan", _all_compute_planned),),
    summarize=_summarize_dos,
))


def _dxenos_fn(g: Graph, ctx: PassContext) -> Graph:
    """d-Xenos planning (§5): Algorithm 1 over the Figure-6 scheme set.

    Annotates every compute op with its best per-op scheme (the paper's
    winning "Ring-Mix") and records the best whole-graph scheme in the
    report.  ``options``: ``n_devices`` (default 4), ``sync`` (ring|ps),
    """
    n_devices = int(ctx.options.get("n_devices", 4))
    sync = ctx.options.get("sync", "ring")
    best, best_t, _ = planner.plan_distributed(g, n_devices, sync, ctx.device)
    mix = planner.plan_mix(g, n_devices, sync, ctx.device)
    out = g.clone()
    for node in out.nodes:
        if node.name in mix:
            node.dataflow["partition_scheme"] = str(mix[node.name])
    ctx.artifacts.update({
        "n_devices": n_devices, "sync": sync,
        "best_scheme": str(best), "best_modeled_s": best_t,
    })
    return out


register_pass(Pass(
    name="dxenos_plan",
    fn=_dxenos_fn,
    description="d-Xenos partition-scheme planning, Algorithm 1 (paper §5)",
))


# ---------------------------------------------------------------------------
# serve_schedule
# ---------------------------------------------------------------------------

#: chunk sizes the serving scheduler may choose between
SERVE_CHUNK_SIZES: tuple[int, ...] = (8, 16, 32, 64)

#: KV block sizes the paged pool may be built with
SERVE_KV_BLOCK_SIZES: tuple[int, ...] = (8, 16, 32)

#: target prefill-chunk cost, in decode steps
CHUNK_RATIO = 4.0


def _plan_kv_pool(slots: int, max_len: int, chunk: int,
                  avg_prompt: float) -> dict[str, Any]:
    """Size the paged KV pool from the prompt-length distribution (same
    rules as the reference for full-attention KV: the largest candidate
    block dividing the horizon that does not exceed half the average
    prompt; a dense-equivalent pool without stats, twice the average
    prompt per request with them)."""
    fallback = False
    divisors = [b for b in SERVE_KV_BLOCK_SIZES if max_len % b == 0]
    if not divisors:
        fallback = True
        divisors = [next(b for b in (4, 2, 1) if max_len % b == 0)]
    target = avg_prompt / 2 if avg_prompt > 0 else float(chunk)
    fitting = [b for b in divisors if b <= max(target, divisors[0])]
    bs = max(fitting) if fitting else divisors[0]
    per_seq = -(-max_len // bs)
    if avg_prompt > 0:
        modeled = -(-int(min(max_len, 2 * avg_prompt)) // bs)
        pool_blocks = max(per_seq, slots * modeled)
    else:
        pool_blocks = slots * per_seq
    out = {
        "kv_block_size": bs,
        "kv_pool_blocks": pool_blocks,
        "kv_saving": round(max(0.0, 1.0 - pool_blocks * bs
                                / (slots * max_len)), 4),
    }
    if fallback:
        out["kv_block_fallback"] = True
    return out


def _serve_schedule_fn(g: Graph, ctx: PassContext) -> Graph:
    """Serving-schedule planning: StageTimer stats -> slot/chunk plan.

    The reference pass's options and plan fields for full-attention KV
    that the port's engine sets (``slots``, ``max_len``,
    ``decode_step_s``, ``prefill_token_s``, ``avg_prompt_len``,
    ``can_chunk``, ``replan_every``, ``kv``, ``kernel_plan``); the
    sliding, mixed, constant-state, speculative and mesh options follow
    with the paths that set them (ROADMAP queue 1 items 5, 7 and 8).  On
    a CUDA engine the two timings are synchronized step times (see
    :class:`StageTimer`)."""
    o = ctx.options
    slots = int(o.get("slots", 4))
    max_len = int(o.get("max_len", 256))
    decode_s = float(o.get("decode_step_s", 0.0))
    prefill_tok_s = float(o.get("prefill_token_s", 0.0))
    avg_prompt = float(o.get("avg_prompt_len", 0.0))
    can_chunk = bool(o.get("can_chunk", True))

    if decode_s > 0.0 and prefill_tok_s > 0.0:
        budget_tokens = CHUNK_RATIO * decode_s / prefill_tok_s
        chunk = SERVE_CHUNK_SIZES[0]
        for c in SERVE_CHUNK_SIZES:
            if c <= budget_tokens:
                chunk = c
    else:
        chunk = 32
    chunk = min(chunk, max_len)

    kv = str(o.get("kv", "dense"))
    if kv == "paged":
        mode = "chunked"
    elif not can_chunk:
        mode = "batched"
    elif decode_s > 0.0 and prefill_tok_s > 0.0 and avg_prompt > 0.0:
        stall_steps = avg_prompt * prefill_tok_s / decode_s
        mode = "chunked" if stall_steps > CHUNK_RATIO else "batched"
    else:
        mode = "chunked"

    if decode_s > 0.0 and prefill_tok_s > 0.0:
        restore_steps = max(chunk * prefill_tok_s / decode_s, 1e-9)
        preempt = int(min(max(slots - 1, 0), CHUNK_RATIO / restore_steps))
    else:
        preempt = 1 if slots > 1 else 0

    plan = {
        "slots": slots,
        "chunk": chunk,
        "admit": slots,
        "preempt": preempt,
        "prefill_mode": mode,
        "replan_every": int(o.get("replan_every", 32))
                        if decode_s > 0.0 and prefill_tok_s > 0.0
                        else max(1, int(o.get("replan_every", 32)) // 2),
        "modeled_chunk_cost_steps": round(chunk * prefill_tok_s / decode_s, 2)
                                    if decode_s > 0 else None,
        "kv_growth": "linear",
    }
    if kv == "paged":
        plan["kv"] = kv
        plan.update(_plan_kv_pool(slots, max_len, chunk, avg_prompt))
    kplan = o.get("kernel_plan")
    if kplan:
        plan["kernel_plan"] = dict(kplan)
    out = g.clone()
    for node in out.nodes:
        node.dataflow["serve_plan"] = dict(plan)
    ctx.artifacts.update(plan)
    return out


register_pass(Pass(
    name="serve_schedule",
    fn=_serve_schedule_fn,
    description="Serving-schedule planning: stage stats -> slot/chunk/"
                "admit/preempt/prefill-mode plan for the continuous-"
                "batching scheduler",
))


# ---------------------------------------------------------------------------
# Kernel routing (kernel_select)
# ---------------------------------------------------------------------------

#: per-site backend vocabulary the router chooses from:
#:
#:   * ``decode_dense``  — dense ring-buffer decode attention
#:                         (``torch`` einsum+softmax | ``cuda`` flash-decode);
#:   * ``decode_paged``  — block-paged decode attention (``gather`` the
#:                         block table into a dense view | ``fold`` the K
#:                         gather as an exact one-hot contraction |
#:                         ``cuda`` the paged flash-decode kernel);
#:   * ``prefill_chunk`` — chunked prefill attention (``torch`` only);
#:   * ``linked_matmul`` — operator linking: the CNN executor's linked 1x1
#:                         ``cbra`` op (``torch`` conv+relu+pool | ``cuda``
#:                         the ``cbr_avgpool`` kernel) and the served
#:                         decoder's SwiGLU MLP (``torch`` three matmuls |
#:                         ``cuda`` the ``linked_mlp`` kernel, h on chip),
#:                         which the reference's ``models.layers.swiglu``
#:                         docstring names as the transformer instance of
#:                         Matmul->Matmul linking and where
#:                         ``repro.kernels.linked_matmul`` plugs in;
#:   * ``split_matmul``  — the CNN executor's DOS parameter split of a
#:                         matmul (``torch`` chunked matmuls | ``cuda`` the
#:                         ``split_matmul`` kernel).  Port only: the
#:                         reference has no such site, its split is plain
#:                         XLA (``repro.core.engine._matmul_split``);
#:   * ``sampler``       — token sampling (``reference`` two-sort |
#:                         ``fused`` one-sort | ``cuda`` sort-free
#:                         ``fused_mask`` kernel).
#:
#: The reference's ``decode_ring`` and ``ssm_scan`` sites come with the
#: path that runs them (ROADMAP queue 1 item 7).
KERNEL_SITE_BACKENDS: dict[str, tuple[str, ...]] = {
    "decode_dense": ("torch", "cuda"),
    "decode_paged": ("gather", "fold", "cuda"),
    "prefill_chunk": ("torch",),
    "linked_matmul": ("torch", "cuda"),
    "split_matmul": ("torch", "cuda"),
    "sampler": ("reference", "fused", "cuda"),
}


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """Per-site kernel backend choice, produced by ``kernel_select``.

    The defaults are the seed path (plain-torch attention, gathered paged
    view, two-sort reference sampler).  Frozen and hashable: the engine
    keys its per-model call tables on ``(max_len, plan)``."""

    decode_dense: str = "torch"
    decode_paged: str = "gather"
    prefill_chunk: str = "torch"
    linked_matmul: str = "torch"
    split_matmul: str = "torch"
    sampler: str = "reference"

    def __post_init__(self):
        for site, backend in self.items():
            allowed = KERNEL_SITE_BACKENDS[site]
            if backend not in allowed:
                raise PipelineError(
                    f"unknown backend {backend!r} for kernel site "
                    f"{site!r}; have {allowed}")

    def items(self) -> list[tuple[str, str]]:
        return [(f.name, getattr(self, f.name))
                for f in dataclasses.fields(self)]

    def as_dict(self) -> dict[str, str]:
        return dict(self.items())


#: modeled host cost of one block gather (s)
GATHER_TAKE_S = 2e-7


def _modeled_decode_paged(o: dict[str, Any]) -> tuple[str, dict[str, Any]]:
    """Roofline the two host paged-decode lowerings: gather vs fold
    (same model as the reference, priced with this module's constants)."""
    B = int(o.get("slots", 4))
    H = int(o.get("q_heads", 8))
    K = int(o.get("kv_heads", max(1, H // 4)))
    D = int(o.get("head_dim", 64))
    W = int(o.get("max_len", 256))
    bs = int(o.get("kv_block_size", 0))
    P = int(o.get("kv_pool_blocks", 0))
    if bs <= 0 or P <= 0:
        return "gather", {}
    itemsize = 4
    kv_bytes = K * D * itemsize
    att_flops = 4 * B * H * D * W
    n_blocks = B * (W // bs)
    gather_bytes = 2 * (2 * B * W * kv_bytes)
    fold_flops = (att_flops + 2 * B * W * P * K * D)
    fold_bytes = (P * bs * kv_bytes + 2 * B * W * kv_bytes)
    gather_s = (cm.roofline(att_flops, gather_bytes, 0).serial_s
                + 2 * n_blocks * GATHER_TAKE_S)
    fold_s = (cm.roofline(fold_flops, fold_bytes, 0).serial_s
              + n_blocks * GATHER_TAKE_S)
    choice = "fold" if fold_s < gather_s else "gather"
    return choice, {"decode_paged_modeled_s": {
        "gather": round(gather_s, 12), "fold": round(fold_s, 12)}}


def select_kernel_plan(options: dict[str, Any] | None = None,
                       ) -> tuple[KernelPlan, dict[str, Any]]:
    """Decide the per-site backends.  Returns ``(plan, decision detail)``.

    ``accelerator == "cuda"`` (the engine's device type) routes dense and
    paged decode attention, the linked ``cbra`` op and SwiGLU MLP, the
    DOS-split matmul and the sampler to the hand-written CUDA kernels, the
    way the reference routes ``tpu`` to Pallas; a host keeps
    plain-torch attention, the gather/fold roofline choice and the
    one-sort ``fused`` sampler.  The reference's measured-timings
    override comes with the autotuner that measures them."""
    o = dict(options or {})
    acc = str(o.get("accelerator", "cpu"))
    cuda = acc == "cuda"
    detail: dict[str, Any] = {"accelerator": acc}
    paged_default, paged_detail = _modeled_decode_paged(o)
    detail.update(paged_detail)
    plan = KernelPlan(
        decode_dense="cuda" if cuda else "torch",
        decode_paged="cuda" if cuda else paged_default,
        prefill_chunk="torch",
        linked_matmul="cuda" if cuda else "torch",
        split_matmul="cuda" if cuda else "torch",
        sampler="cuda" if cuda else "fused",
    )
    return plan, detail


def _kernel_select_fn(g: Graph, ctx: PassContext) -> Graph:
    """Kernel-routing lowering: annotate the per-site :class:`KernelPlan`
    on every node and in the report."""
    plan, detail = select_kernel_plan(ctx.options)
    out = g.clone()
    for node in out.nodes:
        node.dataflow["kernel_plan"] = plan.as_dict()
    ctx.artifacts.update({**plan.as_dict(), **detail})
    return out


register_pass(Pass(
    name="kernel_select",
    fn=_kernel_select_fn,
    description="Kernel routing: accelerator + roofline cost model -> "
                "per-site KernelPlan (decode attention, linked matmul, "
                "split matmul, sampler)",
))


#: engine mode -> pass list (the Fig.-7 ablation axes; ``ho`` is DOS without
#: the vertical rewrites, which is why it is not a numbered level)
MODE_PASSES: dict[str, tuple[str, ...]] = {
    "vanilla": (),
    "ho": ("dos_split",),
    "xenos": ("fuse_cbr", "link_operators", "dos_split"),
}


def optimize_for_mode(g: Graph, mode: str,
                      device: DeviceSpec | None = None
                      ) -> tuple[Graph, PassReport]:
    """Pipeline entry keyed by engine execution mode (vanilla/ho/xenos)."""
    if mode not in MODE_PASSES:
        raise PipelineError(f"unknown engine mode {mode!r}; "
                            f"have {sorted(MODE_PASSES)}")
    return optimize(g, device, passes=MODE_PASSES[mode])
