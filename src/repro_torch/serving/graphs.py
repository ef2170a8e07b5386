"""The serving steps as CUDA graphs: the port's form of the reference's
``jax.jit`` of each serving entry (``repro.serving.engine._serving_jits``).

A step is a *body*: a function of static input buffers (tokens, live
mask, sampling policy, ...) that reads the engine's parameters and
caches, updates the caches in place and returns its outputs.  On the
card a :class:`StepGraph` captures the body once and replays it; a CPU
engine runs the same body eagerly on the same buffers, so the host tests
reach everything but the capture.

* **Inputs** are the device buffers of :class:`StaticInputs`, written
  in place before each replay from pinned host twins (``copy_`` with
  ``non_blocking``); :meth:`StaticInputs.read` brings an output back
  through one copy to pinned memory and waits for that copy alone.
* **Outputs** are static: the next replay overwrites them, so a caller
  copies out what it keeps.
* **One pool.**  An engine's graphs are captured into one memory pool
  (``torch.cuda.graph_pool_handle``): a graph's temporaries may lie
  where another graph's outputs do, which is safe because every output
  is read before the next step replays anything.  Without it each graph
  keeps a private pool, and the verify graphs (one per draft width K1,
  each holding K1 steps' vocab-wide logits and sampler temporaries)
  would hold the sum of their pools instead of about the largest.
* **The key.**  A graph reads its tensors at the addresses it was
  captured with, so :class:`StepGraphs` keys each graph on the
  ``(data_ptr, shape, dtype)`` of every parameter, cache and input
  tensor it reads (:func:`tensor_key`) plus whatever else the caller
  names (slots, KV layout, ``KernelPlan``).  Replacing a tensor makes the
  next call capture again; writing one in place is seen by the next
  replay.
* **Warm-up.**  Before a capture the body runs once eagerly on a side
  stream with the caller's *idle* inputs zeroed (a live mask of zeros:
  the step writes no cache row), so every cache filled on first use (the RoPE
  frequencies, the kernels' plans and occupancy queries, cuBLAS's
  workspace) is filled outside the capture, and the real step is not run
  twice.  It runs every layer, so a layer-pattern stack's RoPE tables of
  both thetas (gemma3: 10k and 1M) are made there too; a ring's
  positions do not move (a dead row's write goes to the sink), and its
  caches, a tuple of per-layer caches, are keyed like any other.  A
  recurrent family's SSM state and conv register (``SSMCache`` leaves)
  are keyed like any cache tensor, and the warm-up leaves every row's
  bits as they were: the decode step writes state for live rows only.
* **Launch counts.**  A replay runs no Python, so no kernel wrapper
  counts it: the wrappers count what the capture records in
  ``kernels.RECORDED``, and every replay adds those counts to
  ``kernels.LAUNCHES`` (as ``core.engine.Engine`` does for the CNN path).
  The warm-up launches its kernels for real and counts them as any
  eager call does: one step's launches a capture, kept per entry as
  ``warmup_launches``.

A capture or replay that raises propagates: nothing falls back to eager.
Captures run with the cyclic garbage collector paused
(``kernels.graph_capture``): a dropped engine's graphs, freed by it
mid-capture, would invalidate the capture.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from .. import kernels


def tensor_key(tree) -> tuple:
    """``(data_ptr, shape, dtype)`` of every tensor leaf of a tree of
    dicts, tuples and named tuples, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return ((tree.data_ptr(), tuple(tree.shape), tree.dtype),)
    if isinstance(tree, dict):
        return tuple(x for k in sorted(tree) for x in tensor_key(tree[k]))
    if isinstance(tree, tuple):
        return tuple(x for v in tree for x in tensor_key(v))
    return ()


def _added(before: dict[str, int], after: dict[str, int]) -> dict[str, int]:
    """The counts that rose from ``before`` to ``after``, by how much."""
    return {k: n - before.get(k, 0) for k, n in after.items()
            if n != before.get(k, 0)}


class StaticInputs:
    """The device buffers captured steps read, each filled in place from a
    pinned host twin (on a CPU engine the buffer is its own twin).

    Host twins are rewritten at the next :meth:`put`; the engine reads
    every step's result back (:meth:`read`, or a sampler's copy to the
    host) before it stages the next step, so no earlier asynchronous copy
    is still reading them."""

    def __init__(self, device: torch.device):
        self.device = device
        self._dev: dict[str, torch.Tensor] = {}
        self._host: dict[str, torch.Tensor] = {}
        self._out: dict[tuple, torch.Tensor] = {}
        self._done = torch.cuda.Event() if device.type == "cuda" else None

    def put(self, name: str, array: np.ndarray) -> torch.Tensor:
        """Write ``array`` into buffer ``name`` (made on first use with
        the array's shape and dtype) and return the device buffer."""
        a = np.asarray(array)
        host = self._host.get(name)
        if host is None:
            host = torch.from_numpy(np.array(a))
            if self.device.type == "cuda":
                host = host.pin_memory()
                self._dev[name] = torch.empty_like(host, device=self.device)
            else:
                self._dev[name] = host
            self._host[name] = host
        view = host.numpy()
        if view.shape != a.shape or view.dtype != a.dtype:
            raise ValueError(f"static input {name!r} is {view.shape} "
                             f"{view.dtype}, got {a.shape} {a.dtype}")
        view[...] = a
        dev = self._dev[name]
        if dev is not host:
            dev.copy_(host, non_blocking=True)
        return dev

    def read(self, t: torch.Tensor) -> np.ndarray:
        """``t`` as a host array: one copy to pinned memory, then a wait
        for that copy (the only synchronization of a staged step)."""
        if t.device.type != "cuda":
            return t.numpy().copy()
        key = (tuple(t.shape), t.dtype)
        out = self._out.get(key)
        if out is None:
            out = self._out[key] = torch.empty(
                t.shape, dtype=t.dtype, pin_memory=True)
        out.copy_(t, non_blocking=True)
        self._done.record()
        self._done.synchronize()
        return out.numpy().copy()


class StepGraph:
    """One step body, captured as a CUDA graph when its inputs lie on the
    card (run eagerly at every :meth:`replay` otherwise).

    ``inputs`` are the static buffers passed to ``body`` by name; the
    warm-up zeroes those named in ``idle`` so that it writes no state.
    After capture, ``outputs`` are the body's static results,
    ``launches`` the kernel launches it recorded, ``warmup`` those the
    warm-up launched, ``capture_s`` the warm-up and capture's host time
    and ``pool_bytes`` the memory the capture added to its pool (``pool``:
    a ``torch.cuda.graph_pool_handle()`` shared with other graphs, or
    None for a private one)."""

    def __init__(self, body, inputs: dict[str, torch.Tensor], key,
                 idle: tuple[str, ...] = (),
                 stream: torch.cuda.Stream | None = None, pool=None):
        self.body = body
        self.inputs = inputs
        self.key = key
        self.graph = None
        self.outputs = None
        self.launches: dict[str, int] = {}
        self.warmup: dict[str, int] = {}
        self.capture_s = 0.0
        self.pool_bytes = 0
        device = next(iter(inputs.values())).device
        if device.type != "cuda":
            return
        t0 = time.perf_counter()
        current = torch.cuda.current_stream(device)
        stream.wait_stream(current)
        before = dict(kernels.LAUNCHES)
        with torch.cuda.stream(stream):
            body(**{**inputs, **{n: torch.zeros_like(inputs[n])
                                 for n in idle}})
        current.wait_stream(stream)
        self.warmup = _added(before, kernels.LAUNCHES)
        # torch.cuda.graph empties the allocator's cache as it enters: do
        # it first, so the reserved memory it adds is the graph's pool
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        graph = torch.cuda.CUDAGraph()
        before = dict(kernels.RECORDED)
        with kernels.graph_capture(graph, pool):
            self.outputs = body(**inputs)
        self.launches = _added(before, kernels.RECORDED)
        self.graph = graph
        self.pool_bytes = torch.cuda.memory_reserved(device) - reserved
        self.capture_s = time.perf_counter() - t0

    def replay(self):
        """Run the step once; returns its (static) outputs."""
        if self.graph is None:
            return self.body(**self.inputs)
        self.graph.replay()
        # a replay launches the recorded kernels without their wrappers:
        # this is where a graphed step's launches are counted
        for name, n in self.launches.items():
            kernels.LAUNCHES[name] += n
        return self.outputs


class StepGraphs:
    """One engine's step graphs, one per entry name (``serve``,
    ``serve_sample``, ``verify/<K1>``, ...), captured lazily into one
    shared memory pool and again whenever the entry's key changes."""

    def __init__(self):
        self._graphs: dict[str, StepGraph] = {}
        self._stream: torch.cuda.Stream | None = None
        self._pool = None
        #: captures so far, over every entry
        self.captures = 0
        #: per entry: captures, replays, capture seconds, the pool bytes
        #: its latest capture added, the launches one replay adds and
        #: those its warm-ups launched
        self.counts: dict[str, dict] = {}

    def run(self, name: str, body, inputs: dict[str, torch.Tensor], key,
            idle: tuple[str, ...] = ()):
        """Replay entry ``name`` (capturing it first when it has no graph
        for ``key``) and return its static outputs."""
        graph = self._graphs.get(name)
        if graph is None or graph.key != key:
            self._graphs.pop(name, None)  # free the old graph's pool first
            device = next(iter(inputs.values())).device
            if device.type == "cuda" and self._stream is None:
                self._stream = torch.cuda.Stream(device)
                self._pool = torch.cuda.graph_pool_handle()
            graph = StepGraph(body, inputs, key, idle, self._stream,
                              self._pool)
            self._graphs[name] = graph
            self.captures += 1
            c = self.counts.setdefault(name, {
                "captures": 0, "replays": 0, "capture_s": 0.0,
                "warmup_launches": {}})
            c["captures"] += 1
            c["capture_s"] += graph.capture_s
            c["pool_bytes"] = graph.pool_bytes
            c["launches"] = dict(graph.launches)
            for k, n in graph.warmup.items():
                c["warmup_launches"][k] = c["warmup_launches"].get(k, 0) + n
        self.counts[name]["replays"] += 1
        return graph.replay()
