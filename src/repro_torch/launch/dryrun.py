"""Multi-pod dry run on fake ranks: trace the step of every (arch x shape
x mesh) on one rank of the mesh and emit its per-rank FLOPs, bytes,
collectives and memory: the counterpart of ``repro.launch.dryrun``.

Where the reference lowers and compiles each step with XLA on forced
host devices and reads ``cost_analysis`` / ``memory_analysis`` and the
HLO's collectives, the port traces one rank:

* the process joins a ``"fake"`` process group of the mesh's world size
  as rank 0 (``launch.mesh.fake_mesh``): collectives move nothing;
* parameters (placed by ``Model.partition_specs()``), optimizer state
  (``opt_partition_specs``), caches (``cache_partition_specs``) and
  inputs (batch-sharded, ``activation_spec``) are DTensors whose local
  shards are fake tensors (``FakeTensorMode``): shapes, never memory;
* the step the shape's ``kind`` names (``train_step``, ``prefill_step``,
  ``serve_step``) runs once; DTensor's sharding propagation plays
  GSPMD's part, and a dispatch mode below DTensor sees each local op at
  the shard shapes it ran at, after any redistribution DTensor chose,
  and each collective it issued.

Per rank, the trace counts:
  * ``flops_per_device``: matmul, attention and convolution FLOPs on
    ``torch.utils.flop_counter``'s formulas, over the local shapes;
  * ``bytes_per_device``: the input plus output bytes of every local op
    but views and ops with no tensor output (``prim.device``, sizes): an
    unfused upper bound (XLA's fusions keep intermediates on chip; eager
    torch writes each one);
  * the collectives' result bytes by kind
    (``core.costmodel.collective_bytes_from_trace``);
  * ``memory``: the rank's live fake-tensor bytes at their peak, beside
    the step's arguments and outputs; ``fits_hbm`` against the H100's
    80 GB.

The ``KernelPlan`` is all ``torch``: the CUDA kernels have no fake
implementation (their own bytes are PERF.md's kernel table).  DTensor's
propagation differs from GSPMD's, and between torch versions, where it
gathers what GSPMD partitions: a cache read or write by rows, a lookup
into a row-sharded table, a scatter over a sharded dim, a fresh tensor
made for a sharded gradient, a residual add of a whole and a split
operand.  The trace partitions those itself and sums a partial result at
once, as GSPMD does (``_StepMode``), so the counts do not hang on the
torch version.  The model's embedding lookup and loss over the
vocabulary sharded on ``"model"`` are vocabulary-parallel themselves
(``models.layers``: local work, functional collectives the trace
counts, a backward into the rank's own shard), as in a real sharded
step.  Where DTensor has no strategy
for an op (or its propagation fails), the op runs again with strided
shards read as plain ones (a relabel that moves no data: only shapes
matter here), then, a view or a write, on the local shards, and failing
that on replicated inputs, each gathered input counted as an all-gather
(a pending partial sum as an all-reduce) of its global bytes, as GSPMD
would; the record's ``notes`` list those ops and the ops that issued the
most collective bytes.  The MoE FFN runs the reference's
expert-parallel form at GShard's capacity (``models.moe._moe_capacity``:
fake tensors hold no group sizes for the sorted cut).

Usage::

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3-1.7b \\
        --shape train_4k --mesh single
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out dryrun.jsonl

``REPRO_DRYRUN_DEVICES`` sets the rank count (default 512: the
production meshes), as the reference's does.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import sys
import time
import traceback
import weakref
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs.base import INPUT_SHAPES, all_configs, get_config
from ..core import costmodel as cm
from ..core.pipeline import StageTimer
from ..distributed import sharding as SH
from ..distributed import state_sharding as SS
from ..models.layers import contiguous_stride, tree_map
from ..models.model import Model, TrainState
from ..optim import adamw_init
from ..optim.adamw import AdamWState
from . import mesh as mesh_lib

SKIPS: dict[tuple[str, str], str] = {
    ("seamless-m4t-large-v2", "long_500k"):
        "enc-dec full attention; no faithful sub-quadratic variant (DESIGN.md §4)",
}

#: what ``bytes_per_device`` counts (the record's ``notes``)
BYTES_NOTE = ("input plus output bytes of every local op but views and "
              "ops with no tensor output: an unfused upper bound")


def _devices() -> int:
    return int(os.environ.get("REPRO_DRYRUN_DEVICES", "512"))


def build_mesh(multi_pod: bool) -> SH.MeshShape:
    """The production mesh at 512 ranks, else the debug mesh of
    ``REPRO_DRYRUN_DEVICES`` ranks (axis names and sizes; the fake group
    is joined per trace)."""
    n = _devices()
    if n == 512:
        return mesh_lib.make_production_mesh(multi_pod=multi_pod)
    return mesh_lib.make_debug_mesh(n, multi_pod=multi_pod)


def config_for(arch: str, shape_name: str):
    cfg = get_config(arch)
    if shape_name == "long_500k" and not cfg.sub_quadratic:
        cfg = cfg.long_context_variant()
    return cfg


# ---------------------------------------------------------------------------
# The per-rank trace
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class StepTrace:
    """One rank's counts of one traced step."""
    flops: float
    bytes: float
    collectives: list            # (op, result bytes) per collective
    memory: dict[str, float]
    replicated: dict[str, int]   # op -> times it ran on replicated inputs
    partitioned: dict[str, int]  # op -> times the trace ran it on shards
    collectives_by_op: dict[str, float]  # DTensor op -> its collective bytes
    seconds: float


def _dtensor_type():
    from torch.distributed.tensor import DTensor
    return DTensor


class _Tally:
    """What a trace counts, and which fake tensors are the rank's own.

    A tensor is *real* when it holds this rank's data: a local shard of
    the step's state, a plain tensor the step made, or the output of an
    op on real tensors.  DTensor's sharding propagation also runs ops on
    fake tensors, at global shapes, made inside its dispatch: those are
    not real and are not counted."""

    def __init__(self):
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives: list[tuple[str, float]] = []
        self.replicated: dict[str, int] = {}
        self.partitioned: dict[str, int] = {}
        self.by_op: dict[str, float] = {}
        self._real: dict[int, weakref.ref] = {}
        self._storages: dict[int, list] = {}   # key -> [nbytes, refs]
        self.live = 0
        self.peak = 0

    # -- which tensors are the rank's ----------------------------------------
    def is_real(self, t: torch.Tensor) -> bool:
        ref = self._real.get(id(t))
        return ref is not None and ref() is t

    def mark(self, t: torch.Tensor) -> None:
        if isinstance(t, _dtensor_type()):
            t = t._local_tensor
        if t.device.type == "meta" or self.is_real(t):
            return
        self._real[id(t)] = weakref.ref(t)
        key = _storage_key(t)
        entry = self._storages.get(key)
        if entry is None:
            entry = self._storages[key] = [t.untyped_storage().nbytes(), 0]
            self.live += entry[0]
            self.peak = max(self.peak, self.live)
        entry[1] += 1
        weakref.finalize(t, self._release, id(t), key)

    def _release(self, tid: int, key: int) -> None:
        ref = self._real.get(tid)
        if ref is not None and ref() is None:
            del self._real[tid]
        entry = self._storages[key]
        entry[1] -= 1
        if entry[1] == 0:
            self.live -= entry[0]
            del self._storages[key]

    def hold(self, tree) -> None:
        """Mark every tensor of a state tree real (the step's arguments)."""
        for t in _tensors(tree):
            self.mark(t)

    # -- counting -------------------------------------------------------------
    def snapshot(self):
        return (self.flops, self.bytes, len(self.collectives))

    def restore(self, snap) -> None:
        self.flops, self.bytes, n = snap
        del self.collectives[n:]

    def local(self, func, args, kwargs, top: bool):
        """Run one op on plain (fake) tensors and count it: ``top`` ops
        (outside any DTensor dispatch) are the step's own; inside a
        dispatch an op counts when it reads a real tensor."""
        from torch.utils.flop_counter import flop_registry

        ins = _tensors((args, kwargs))
        if top:
            for t in ins:
                self.mark(t)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(t.device.type == "meta" for t in ins + outs):
            return out
        if func.namespace == "_c10d_functional":
            name = func._overloadpacket.__name__
            if name != "wait_tensor":
                self.collectives.append(
                    (name, float(sum(_nbytes(o) for o in outs))))
            for o in outs:
                self.mark(o)
            return out
        if not (top and not ins) and not any(self.is_real(t) for t in ins):
            return out                       # sharding propagation
        for o in outs:
            self.mark(o)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += float(flop_registry[packet](*args, **kwargs,
                                                      out_val=out))
        # an op with no tensor out (``prim.device``, a size) reads no data
        if outs and (func._schema.is_mutable or not _aliases(ins, outs)):
            self.bytes += float(sum(_nbytes(t) for t in ins + outs))
        return out


def _tensors(tree) -> list:
    from torch.utils._pytree import tree_flatten
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _aliases(ins: list, outs: list) -> bool:
    keys = {_storage_key(t) for t in ins}
    return any(_storage_key(o) in keys for o in outs)


class _LocalMode(TorchDispatchMode):
    """Inside a DTensor dispatch: decline DTensor ops (DTensor runs them
    and issues their local ops and collectives, which come back here)."""

    def __init__(self, tally: _Tally):
        super().__init__()
        self.tally = tally

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if any(issubclass(t, _dtensor_type()) for t in types):
            return NotImplemented
        return self.tally.local(func, args, kwargs or {}, top=False)


class _StepMode(TorchDispatchMode):
    """The step's own ops.  A DTensor op runs under a :class:`_LocalMode`
    as DTensor places it, but for the ops DTensor would answer by
    gathering what GSPMD partitions (``_new_like``, ``_scatter``,
    ``_index``, ``_align``), which run on the local shards
    here; a partial result is summed at once (``_settle``).  Where
    DTensor cannot run an op, it runs again with strided shards read as
    plain ones, then (a view, a write) on the local shards, then on
    replicated inputs."""

    def __init__(self, tally: _Tally):
        super().__init__()
        self.tally = tally
        #: (op, argument signature) -> the fallback stage that ran it: a
        #: propagation that failed once is not tried again
        self.stage: dict[tuple, str] = {}
        #: (shape, dtype) -> the placements of the last DTensor of it an
        #: op made (a forward tensor, whose gradient a backward makes anew)
        self.seen: dict[tuple, list] = {}

    def _attempt(self, func, args, kwargs):
        snap = self.tally.snapshot()
        try:
            with _LocalMode(self.tally):
                return True, func(*args, **kwargs)
        except Exception:  # noqa: BLE001 - no strategy: fall back
            self.tally.restore(snap)
            return False, None

    def _relabel(self, a):
        from torch.distributed.tensor import DTensor
        pl = [_plain_shard(p) for p in a.placements]
        if pl == list(a.placements):
            return a
        out = DTensor.from_local(a._local_tensor, a.device_mesh, pl,
                                 run_check=False, shape=a.shape,
                                 stride=a.stride())
        self.tally.mark(out)
        return out

    def _gather(self, a):
        """GSPMD's replication of an input: an all-gather of its global
        bytes where it is sharded, an all-reduce where it is partial."""
        kinds = {"all_reduce" if p.is_partial() else "all_gather_into_tensor"
                 for md, p in enumerate(a.placements)
                 if not p.is_replicate() and a.device_mesh.size(md) > 1}
        for k in sorted(kinds):
            self.tally.collectives.append((k, float(_nbytes(a))))
        full = torch.empty_strided(a.shape, a.stride(), dtype=a.dtype,
                                   device=a.device)
        self.tally.mark(full)
        return full

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        tally = self.tally
        if not any(issubclass(t, DTensor) for t in types):
            return tally.local(func, args, kwargs, top=True)
        tally.hold((args, kwargs))
        n0 = len(tally.collectives)
        # the op is recorded for autograd above this mode already: its
        # redistributions here are not differentiated apart
        with torch.no_grad():
            out = self._dtensor_op(func, args, kwargs)
            if not func._schema.is_mutable:
                out = self._settle(out)
            for o in _tensors(out):
                if isinstance(o, DTensor):
                    self.seen[(tuple(o.shape), o.dtype)] = list(o.placements)
        spent = sum(b for _, b in tally.collectives[n0:])
        if spent:
            tally.by_op[str(func)] = tally.by_op.get(str(func), 0.0) + spent
        return out

    def _dtensor_op(self, func, args, kwargs):
        from torch.distributed.tensor import DTensor, Replicate
        from torch.utils._pytree import tree_map_only

        tally = self.tally
        name = str(func)
        if func in _NEW_FACTORIES and isinstance(args[0], DTensor):
            return self._new_like(func, args, kwargs)
        if func in _SCATTERS and isinstance(args[0], DTensor):
            out = self._scatter(func, args, kwargs)
            if out is not None:
                return out
        if func in _INDEX_READS or func in _INDEX_WRITES:
            out = self._index(func, args, kwargs)
            if out is not None:
                return out
        if torch.Tag.pointwise in func.tags:
            args = self._align(args)
        if func in _MATMULS:
            args = self._fsdp(args)
        key = (func, _signature((args, kwargs)))
        stage = self.stage.get(key, "dtensor")
        if stage == "dtensor":
            ok, out = self._attempt(func, args, kwargs)
            if ok:
                return out
            stage = self.stage[key] = "relabel"
        if stage == "relabel":
            ra, rk = tree_map_only(DTensor, self._relabel, (args, kwargs))
            ok, out = self._attempt(func, ra, rk)
            if ok:
                tally.partitioned[name] = tally.partitioned.get(name, 0) + 1
                return args[0] if func._schema.is_mutable else out
            stage = self.stage[key] = "local"
        if func in _VIEWS and isinstance(args[0], DTensor):
            out = self._view_local(args[0], args[1])
            if out is not None:
                tally.partitioned[name] = tally.partitioned.get(name, 0) + 1
                return out
        if func._schema.is_mutable and isinstance(args[0], DTensor):
            return self._write_local(func, args, kwargs)
        tally.replicated[name] = tally.replicated.get(name, 0) + 1
        mesh = next(a for a in _tensors((args, kwargs))
                    if isinstance(a, DTensor)).device_mesh
        la, lk = tree_map_only(DTensor, self._gather, (args, kwargs))
        with _LocalMode(tally):
            out = func(*la, **lk)
        if func._schema.is_mutable:
            return args[0]
        rep = [Replicate()] * mesh.ndim
        return tree_map_only(
            torch.Tensor,
            lambda o: DTensor.from_local(o, mesh, rep, run_check=False), out)

    def _align(self, args):
        """Operands of one shape meeting in a pointwise op (a residual
        add): where one is whole on a mesh axis and another is split on
        it, the split one is gathered, as GSPMD keeps a tensor-parallel
        residual stream whole on the model axis; DTensor would split the
        whole one instead (a free slice) and carry the split into the
        next layer's matmuls."""
        from torch.distributed.tensor import DTensor

        ds = [a for a in args if isinstance(a, DTensor)]
        if len(ds) < 2 or len({tuple(a.shape) for a in ds}) != 1:
            return args
        mesh = ds[0].device_mesh
        whole = [md for md in range(mesh.ndim)
                 if any(a.placements[md].is_replicate() for a in ds)
                 and any(not a.placements[md].is_replicate() for a in ds)]
        if not whole:
            return args

        def gather(a):
            if not isinstance(a, DTensor):
                return a
            return self._whole(a, whole)
        return tuple(gather(a) for a in args)

    def _fsdp(self, args):
        """A matmul whose weight (the second operand) is split on a mesh
        dim that also splits the input's rows (the batch: a rule set that
        puts a weight dim on ``"data"``, FSDP) takes the weight gathered
        whole there, an all-gather of the weight, the rows staying split,
        as FSDP computes.  DTensor gathers either operand by its cost
        model, and torch 2.11 and 2.13 choose differently (2.11 the
        rows)."""
        from torch.distributed.tensor import DTensor, Shard

        x, w = args[0], args[1]
        if not (isinstance(x, DTensor) and isinstance(w, DTensor)):
            return args
        mds = [md for md, (p, q) in enumerate(zip(x.placements,
                                                  w.placements))
               if _plain_shard(p) == Shard(0) and isinstance(
                   _plain_shard(q), Shard)]
        if not mds:
            return args
        return (x, self._whole(w, mds)) + tuple(args[2:])

    def _settle(self, out):
        """A partial sum (a matmul over a split contraction) is summed at
        once, an all-reduce, as GSPMD's partitioner does at such a dot;
        left pending, DTensor carries it through the linear ops that
        follow and sums a larger tensor later (an attention's scores)."""
        from torch.distributed.tensor import DTensor, Replicate
        from torch.utils._pytree import tree_map_only

        def settle(o):
            return self._whole(o, [md for md, p in enumerate(o.placements)
                                   if p.is_partial()])
        return tree_map_only(DTensor, settle, out)

    def _whole(self, a, mesh_dims):
        """``a`` made whole on ``mesh_dims``: a shard gathered (an
        all-gather of the result), a partial sum summed (an all-reduce),
        counted here; the new local shard a fresh tensor of its shape
        (DTensor's own redistribution is an autograd function, which
        torch 2.11 cannot run inside a dispatch on a tensor that
        requires grad)."""
        from torch.distributed.tensor import DTensor, Replicate

        mesh = a.device_mesh
        local = list(a._local_tensor.shape)
        pls = list(a.placements)
        for md in mesh_dims:
            p = pls[md]
            if p.is_replicate():
                continue
            if p.is_partial():
                kind = "all_reduce"
            else:
                kind = "all_gather_into_tensor"
                d = _plain_shard(p).dim
                local[d] = min(local[d] * mesh.size(md), a.shape[d])
            pls[md] = Replicate()
            if mesh.size(md) > 1:
                self.tally.collectives.append(
                    (kind, float(_prod(local) * a.element_size())))
        if pls == list(a.placements):
            return a
        out = torch.empty(local, dtype=a.dtype,
                          device=a._local_tensor.device)
        self.tally.mark(out)
        return DTensor.from_local(out, mesh, pls, run_check=False,
                                  shape=a.shape, stride=a.stride())

    def _index(self, func, args, kwargs):
        """Advanced indexing of a sharded tensor, which DTensor answers by
        gathering it whole: the forms the model uses, run on the local
        shards as GSPMD partitions them.  A write whose indexed dims are
        not sharded: each rank writes its shard.  Row-aligned, ``t[rows, j, ...]``
        with one index entry per row of ``t`` (the decode step's cache
        reads and writes): each rank reads / writes its own rows.  A
        lookup ``table[ids]`` into a table sharded on its rows (the
        vocabulary): each rank looks up the ids in its rows (zeros
        elsewhere) and the partial results are summed.  None where
        neither form applies (DTensor's own strategy then runs)."""
        from torch.distributed.tensor import DTensor, Partial, Shard

        t, indices = args[0], list(args[1])
        if not isinstance(t, DTensor):
            return None
        shard_dims = {md: p.dim for md, p in enumerate(t.placements)
                      if not (p.is_replicate() or p.is_partial())}
        if any(not isinstance(t.placements[md], Shard)
               for md in shard_dims):
            return None
        if func in _INDEX_WRITES and not any(
                i is not None and d in shard_dims.values()
                for d, i in enumerate(indices)):
            # a write at positions of unsharded dims (the prefill's
            # ``cache.k[:, slots] = k``): each rank writes its shard
            return self._write_local(func, args, kwargs)
        if any(i is None for i in indices):
            return None
        n = len(indices)
        rows = t.shape[0]
        aligned = all(tuple(i.shape) == (rows,) for i in indices) and \
            all(d == 0 or d >= n for d in shard_dims.values())
        ids = indices[0]
        lookup = n == 1 and t.dim() == 2 and ids.dim() >= 1 and not (
            isinstance(ids, DTensor) and any(
                not ids.placements[md].is_replicate() for md in shard_dims))
        if not (aligned or lookup):
            return None
        mesh = t.device_mesh
        local_t = t._local_tensor
        if func in _INDEX_WRITES:
            return self._write_local(func, args, kwargs) if aligned else None
        if aligned:
            # the output's rows are t's rows, its trailing dims t's
            idx = [torch.empty(local_t.shape[0], dtype=i.dtype,
                               device=local_t.device) for i in indices]
            pls = [p if md not in shard_dims else
                   Shard(0 if shard_dims[md] == 0 else shard_dims[md] - n + 1)
                   for md, p in enumerate(t.placements)]
            shape = (rows,) + tuple(t.shape[n:])
        else:
            idx = [ids._local_tensor if isinstance(ids, DTensor) else ids]
            pls = []
            for md, p in enumerate(t.placements):
                if md in shard_dims:     # a row shard: zeros off its rows
                    pls.append(Partial() if shard_dims[md] == 0
                               else Shard(ids.dim()))
                elif isinstance(ids, DTensor) and isinstance(
                        ids.placements[md], Shard):
                    pls.append(ids.placements[md])
                else:
                    pls.append(p)
            shape = tuple(ids.shape) + (t.shape[1],)
        with _LocalMode(self.tally):
            out = func(local_t, idx, *args[2:], **kwargs)
        self.tally.partitioned[str(func)] = \
            self.tally.partitioned.get(str(func), 0) + 1
        return DTensor.from_local(out, mesh, pls, run_check=False,
                                  shape=torch.Size(shape),
                                  stride=contiguous_stride(shape))

    def _new_like(self, func, args, kwargs):
        """``self.new_zeros(size)`` and kin: DTensor makes the new tensor
        replicated at its global size (an autograd backward's zeros of a
        sharded activation would be whole on every rank); GSPMD shards
        it as its consumers do.  Here it takes the placements of the last
        tensor of its shape and dtype the trace made (the forward tensor
        whose gradient it will hold), else ``self``'s on the dims the new
        shape splits evenly."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        a, size = args[0], list(args[1])
        mesh = a.device_mesh
        dtype = kwargs.get("dtype") or a.dtype
        local = list(size)
        pls = []
        seen = self.seen.get((tuple(size), dtype))
        for md, p in enumerate(seen or a.placements):
            m = mesh.size(md)
            d = getattr(_plain_shard(p), "dim", None) \
                if not (p.is_replicate() or p.is_partial()) else None
            if d is not None and d < len(size) and local[d] % m == 0:
                local[d] //= m
                pls.append(Shard(d))
            else:
                pls.append(Replicate())
        with _LocalMode(self.tally):
            out = func(a._local_tensor, local, *args[2:], **kwargs)
        return DTensor.from_local(out, mesh, pls, run_check=False,
                                  shape=torch.Size(size),
                                  stride=contiguous_stride(size))

    def _scatter(self, func, args, kwargs):
        """An out-of-place scatter into a tensor sharded on the scatter dim
        (the gather's backward into vocabulary-sharded logits): DTensor
        gathers the target whole; GSPMD has each rank scatter into its
        own shard, the indices and sources whole on the axes the target
        is split on (an operand split where the target is whole is
        gathered first).  None where the scatter dim is not sharded."""
        from torch.distributed.tensor import DTensor

        t, dim = args[0], args[1] % args[0].dim()
        if not any(getattr(_plain_shard(p), "dim", None) == dim
                   for p in t.placements
                   if not (p.is_replicate() or p.is_partial())):
            return None
        local = t._local_tensor
        whole = {md for md, p in enumerate(t.placements) if p.is_replicate()}

        def localize(x):
            if not isinstance(x, torch.Tensor):
                return x
            if isinstance(x, DTensor) and any(
                    not p.is_replicate() and md in whole
                    and x.device_mesh.size(md) > 1
                    for md, p in enumerate(x.placements)):
                self.tally.collectives.append(("all_gather_into_tensor",
                                               float(_nbytes(x))))
            shape = list(local.shape)
            shape[dim] = x.shape[dim]
            return torch.empty(shape, dtype=x.dtype, device=local.device)
        with _LocalMode(self.tally):
            out = func(local, args[1], *(localize(a) for a in args[2:]),
                       **{k: localize(v) for k, v in kwargs.items()})
        self.tally.partitioned[str(func)] = \
            self.tally.partitioned.get(str(func), 0) + 1
        return DTensor.from_local(out, t.device_mesh, list(t.placements),
                                  run_check=False, shape=t.shape,
                                  stride=t.stride())

    def _view_local(self, a, size):
        """A view DTensor cannot express on ``a``'s shards (a dim sharded
        over two mesh axes split, or a strided shard): the same local
        shard viewed at a local shape of the same size, each mesh axis
        sharding the outermost output dim of its input dim's span that
        it divides, else the outermost other dim it divides.  The element order may differ from the true view's;
        the trace reads shapes alone.  None where no such shape is."""
        from torch.distributed.tensor import DTensor, Replicate, Shard

        size = list(size)
        if -1 in size:
            rest = 1
            for n in size:
                rest *= n if n != -1 else 1
            size[size.index(-1)] = a.numel() // rest
        mesh = a.device_mesh
        local = list(size)
        pls = []
        for md, p in enumerate(a.placements):
            if p.is_replicate() or p.is_partial():
                pls.append(p)
                continue
            m = mesh.size(md)
            inner = _prod(a.shape[p.dim + 1:])
            outer = inner * a.shape[p.dim]
            # the output dims the input dim spans, outermost first, then
            # the others, outermost first (a batch or sequence dim before
            # a trailing contraction dim such as head_dim)
            span = [j for j in range(len(size))
                    if inner <= _prod(size[j + 1:]) < outer]
            order = span + [j for j in range(len(size)) if j not in span]
            j = next((j for j in order if local[j] % m == 0 and local[j] > 1),
                     None)
            if j is None:
                return None
            local[j] //= m
            pls.append(Shard(j))
        if _prod(local) != a._local_tensor.numel():
            return None
        out = a._local_tensor.reshape(local)
        self.tally.mark(out)
        return DTensor.from_local(out, mesh, pls, run_check=False,
                                  shape=torch.Size(size),
                                  stride=contiguous_stride(size))

    def _write_local(self, func, args, kwargs):
        """An in-place write (``index_put_``, a scatter) into a sharded
        tensor that DTensor has no strategy for, or answers by gathering
        the tensor: GSPMD partitions it, each rank writing its own shard.
        An operand split on a mesh axis the target is not split on is
        gathered first (an all-gather of its bytes); one split only where
        the target is (the batch rows of a cache and of its new entries)
        needs nothing.  The write moves the operands' bytes and leaves
        the shards as they are (the trace reads shapes alone)."""
        from torch.distributed.tensor import DTensor

        tally = self.tally
        name = str(func)
        tally.partitioned[name] = tally.partitioned.get(name, 0) + 1
        t = args[0]
        split = {md for md, p in enumerate(t.placements)
                 if not p.is_replicate()}
        for a in _tensors((args[1:], kwargs)):
            if isinstance(a, DTensor) and any(
                    not p.is_replicate() and a.device_mesh.size(md) > 1
                    and md not in split
                    for md, p in enumerate(a.placements)):
                tally.collectives.append(("all_gather_into_tensor",
                                          float(_nbytes(a))))
            tally.bytes += float(_nbytes(a))
        return args[0]


def _prod(xs) -> int:
    n = 1
    for x in xs:
        n *= int(x)
    return n


_aten = torch.ops.aten
_NEW_FACTORIES = (_aten.new_zeros.default, _aten.new_empty.default,
                  _aten.new_full.default, _aten.new_ones.default)
_VIEWS = (_aten.view.default, _aten._unsafe_view.default,
          _aten.reshape.default)
_INDEX_READS = (_aten.index.Tensor,)
_MATMULS = (_aten.mm.default,)
_SCATTERS = (_aten.scatter_add.default, _aten.scatter.src,
             _aten.scatter.value)
_INDEX_WRITES = (_aten.index_put_.default, _aten.index_put.default)


def _signature(tree) -> tuple:
    """The shapes, dtypes and placements of an op's arguments (and its
    other arguments): what its sharding propagation sees."""
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_flatten

    out = []
    for x in tree_flatten(tree)[0]:
        if isinstance(x, DTensor):
            out.append(("D", tuple(x.shape), x.dtype, tuple(x.placements)))
        elif isinstance(x, torch.Tensor):
            out.append(("T", tuple(x.shape), x.dtype))
        else:
            out.append(x if isinstance(x, (int, float, bool, str,
                                           type(None))) else repr(x))
    return tuple(out)


def _plain_shard(p):
    """A strided shard (a view's merge of a sharded dim) as the plain
    shard of its dim: the same local shape, another element order."""
    from torch.distributed.tensor import Shard
    if p.is_replicate() or p.is_partial() or type(p) is Shard \
            or not hasattr(p, "dim"):
        return p
    return Shard(p.dim)


@contextlib.contextmanager
def _quiet():
    """DTensor warns on every CPU all-to-all and multi-axis all-reduce it
    plans; the trace moves no data, so the warnings say nothing here."""
    log = logging.getLogger("torch.distributed")
    level = log.level
    log.setLevel(logging.ERROR)
    try:
        yield
    finally:
        log.setLevel(level)


def trace_step(fn, hold=()) -> tuple[Any, StepTrace]:
    """Run ``fn()`` once on this rank and count it: call it under the
    ``FakeTensorMode`` its tensors belong to, with the fake group and
    mesh of its DTensors joined.  ``hold`` is the step's state (its
    arguments: counted live from the start)."""
    from torch.distributed.tensor.experimental import implicit_replication

    tally = _Tally()
    tally.hold(hold)
    args = tally.live
    arg_keys = set(tally._storages)
    t0 = time.perf_counter()
    with _quiet(), implicit_replication(), _StepMode(tally):
        out = fn()
    seconds = time.perf_counter() - t0
    tally.hold(out)
    out_keys = {_storage_key(t._local_tensor if isinstance(
        t, _dtensor_type()) else t) for t in _tensors(out)}
    out_keys = {k for k in out_keys if k in tally._storages}
    alias = sum(tally._storages[k][0] for k in out_keys if k in arg_keys)
    output = sum(tally._storages[k][0] for k in out_keys)
    peak = tally.peak
    memory = {"argument_bytes": args, "output_bytes": output,
              "temp_bytes": max(peak - args - output + alias, 0),
              "alias_bytes": alias, "peak_estimate": peak}
    return out, StepTrace(tally.flops, tally.bytes, list(tally.collectives),
                          memory, dict(tally.replicated),
                          dict(tally.partitioned), dict(tally.by_op), seconds)


# ---------------------------------------------------------------------------
# Lowering one (arch, shape) on a mesh
# ---------------------------------------------------------------------------

def lower_one(arch: str, shape_name: str, mesh, rules=None, cfg=None,
              seq_shard=None):
    """Trace the right step for (arch, shape) on one rank of ``mesh`` (a
    ``MeshShape``: its fake group is joined for the trace and left after;
    or a ``DeviceMesh`` already joined).

    ``shape_name`` is a key of ``INPUT_SHAPES`` or an ``InputShape``;
    ``seq_shard`` forces context-parallel KV-cache sharding (decode shapes).
    Returns (trace, model, batch_axes)."""
    shape = INPUT_SHAPES[shape_name] if isinstance(shape_name, str) \
        else shape_name
    cfg = cfg or config_for(arch, shape.name)
    if hasattr(mesh, "mesh_dim_names"):
        return _lower(shape, cfg, mesh, rules, seq_shard)
    with mesh_lib.fake_mesh(mesh) as dmesh:
        return _lower(shape, cfg, dmesh, rules, seq_shard)


def _lower(shape, cfg, dmesh, rules, seq_shard):
    from torch._subclasses.fake_tensor import FakeTensorMode

    ms = SH.mesh_shape(dmesh)
    model = Model(cfg, mesh=dmesh, rules=rules, device="cpu")
    baxes = SH.batch_axes_for(ms, shape.global_batch)
    # real inputs allowed: a constant memoized by an earlier real step
    # (the RoPE frequencies) may enter the trace
    fm = FakeTensorMode(allow_non_fake_inputs=True)
    pspecs = model.partition_specs()
    with fm:
        params = SS.place_tree(model.abstract(fm), pspecs, dmesh)
        inputs = model.input_specs(shape, fm)
        batch = {k: SS.place(v, SH.activation_spec(baxes, v.dim()), dmesh)
                 for k, v in inputs.items() if k != "caches"}
        if shape.kind == "train":
            opt_abs = adamw_init(model.abstract(fm), model.opt_cfg)
            ospecs = SS.opt_partition_specs(opt_abs, pspecs, ms)
            opt = AdamWState(step=torch.zeros((), dtype=torch.int32),
                             m=SS.place_tree(opt_abs.m, ospecs.m, dmesh),
                             v=SS.place_tree(opt_abs.v, ospecs.v, dmesh))
            params = tree_map(lambda t: t.requires_grad_(True), params)
            state = TrainState(params, opt,
                               torch.zeros((), dtype=torch.int32))
            _, trace = trace_step(lambda: model.train_step(state, batch),
                                  hold=(state, batch))
        elif shape.kind == "prefill":
            _, trace = trace_step(lambda: model.prefill_step(params, batch),
                                  hold=(params, batch))
        else:
            kv_axis = (rules or {}).get("kv_heads", "model")
            cspecs = SS.cache_partition_specs(
                inputs["caches"], ms, global_batch=shape.global_batch,
                seq_shard=seq_shard, kv_axis=kv_axis)
            caches = SS.place_tree(inputs["caches"], cspecs, dmesh)
            with torch.no_grad():
                _, trace = trace_step(
                    lambda: model.serve_step(params, caches,
                                             batch["tokens"]),
                    hold=(params, caches, batch))
    return trace, model, baxes


def analyze(arch: str, shape_name: str, mesh_name: str, trace: StepTrace,
            model) -> dict:
    """Per-rank roofline record, the reference's keys."""
    coll = cm.collective_bytes_from_trace(trace.collectives)
    terms = cm.roofline(trace.flops, trace.bytes, coll.get("total", 0.0),
                        chips=1)
    n = model.param_count()
    shape = INPUT_SHAPES[shape_name]
    if shape.kind in ("train", "prefill"):
        tokens = shape.global_batch * shape.seq_len
    else:
        tokens = shape.global_batch
    n_active = _active_params(model.cfg)
    mult = 6.0 if shape.kind == "train" else 2.0
    model_flops_per_dev = mult * n_active * tokens / mesh_size(mesh_name)
    mem = trace.memory
    return {
        "arch": arch, "shape": shape_name, "mesh": mesh_name,
        "params": n, "active_params": n_active,
        "flops_per_device": trace.flops,
        "bytes_per_device": trace.bytes,
        "collective_bytes_per_device": coll.get("total", 0.0),
        "collectives": {k: v for k, v in coll.items() if k != "total"},
        "compute_s": terms.compute_s, "memory_s": terms.memory_s,
        "collective_s": terms.collective_s, "dominant": terms.dominant,
        "bound_s": terms.bound_s,
        "model_flops_per_device": model_flops_per_dev,
        "useful_flops_ratio": (model_flops_per_dev / trace.flops)
                              if trace.flops else 0.0,
        "memory": dict(mem),
        "fits_hbm": mem["peak_estimate"] < cm.HBM_BYTES,
    }


def mesh_size(mesh_name: str) -> int:
    n = _devices()
    return n if mesh_name == "multi" else (256 if n == 512 else n)


def _active_params(cfg) -> int:
    """6*N_active*D for MoE counts only routed+shared experts."""
    if not cfg.n_experts:
        return cfg.param_count()
    full = cfg.param_count()
    expert_params = cfg.n_layers * cfg.n_experts * 3 * cfg.d_model * cfg.d_ff
    active_expert = cfg.n_layers * cfg.top_k * 3 * cfg.d_model * cfg.d_ff
    return full - expert_params + active_expert


CAL_POINTS = (2, 4)


def calibrate_depth(arch: str, shape_name: str, mesh, rules=None,
                    cfg=None, seq_shard=None) -> dict:
    """The reference's depth calibration: trace depth-2 and depth-4
    variants (microbatch off) and extrapolate the per-layer slope:

        X(L) = X(2) + (X(4) - X(2)) / 2 * (L - 2)

    for flops, bytes and collective bytes.  XLA counts a scanned body
    once, so the reference cannot see depth otherwise; an eager trace
    counts every layer, and on a uniform stack this equals the
    full-depth count (``tests/test_torch_dryrun.py``).  It is kept so
    that ``hillclimb.score`` runs as the reference's does."""
    cfg = cfg or config_for(arch, shape_name)
    pts = {}
    for L in CAL_POINTS:
        c = dataclasses.replace(cfg, n_layers=L,
                                encoder_layers=L if cfg.encoder_layers else 0,
                                microbatch=0, scan_layers=False)
        trace, _, _ = lower_one(arch, shape_name, mesh, rules, cfg=c,
                                seq_shard=seq_shard)
        coll = cm.collective_bytes_from_trace(trace.collectives)
        pts[L] = (trace.flops, trace.bytes, coll.get("total", 0.0))
    lo, hi = CAL_POINTS
    L = cfg.n_layers
    out = {}
    for i, key in enumerate(("flops", "bytes", "collective_bytes")):
        x_lo, x_hi = pts[lo][i], pts[hi][i]
        slope = (x_hi - x_lo) / (hi - lo)
        out[key] = max(x_lo + slope * (L - lo), 0.0)
    return out


def serve_plan_for(cfg, shape) -> dict:
    """serve_schedule plan for a decode shape (slots = the decode batch)."""
    from ..core import pipeline
    from ..serving.scheduler import serve_plan_graph

    g = serve_plan_graph(cfg.name, shape.global_batch, cfg.d_model,
                         cfg.d_ff or cfg.d_model, cfg.vocab)
    _, report = pipeline.optimize(
        g, passes=("serve_schedule",),
        options={"slots": shape.global_batch, "max_len": shape.seq_len})
    plan = dict(report.passes[-1].summary)
    plan["cache_hit"] = report.cache_hit
    return plan


def _notes(trace: StepTrace) -> dict:
    """What the record's numbers count, the ops DTensor could not run as
    placed, and the DTensor ops that issued the most collective bytes."""
    top = sorted(trace.collectives_by_op.items(), key=lambda kv: -kv[1])[:5]
    return {"bytes_per_device": BYTES_NOTE,
            "replicated_ops": dict(trace.replicated),
            "partitioned_ops": dict(trace.partitioned),
            "top_collective_ops": dict(top)}


def run_one(arch: str, shape_name: str, mesh_name: str, out=None,
            rules=None, verbose: bool = True, calibrate: bool = True) -> dict:
    if (arch, shape_name) in SKIPS:
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
               "skipped": SKIPS[(arch, shape_name)]}
        if verbose:
            print(f"SKIP {arch} x {shape_name}: {rec['skipped']}")
        return rec
    t0 = time.time()
    timer = StageTimer()  # same stage instrumentation the pass manager uses
    mesh = build_mesh(multi_pod=(mesh_name == "multi"))
    with timer.stage("lower_compile"):
        trace, model, _ = lower_one(arch, shape_name, mesh, rules)
    with timer.stage("analyze"):
        rec = analyze(arch, shape_name, mesh_name, trace, model)
    if calibrate and mesh_name == "single":  # roofline table is single-pod
        with timer.stage("calibrate_depth"):
            cal = calibrate_depth(arch, shape_name, mesh, rules)
        terms = cm.roofline(cal["flops"], cal["bytes"],
                            cal["collective_bytes"], chips=1)
        rec["calibrated"] = {
            **cal, **terms.as_dict(),
            "useful_flops_ratio": (rec["model_flops_per_device"] / cal["flops"])
                                  if cal["flops"] else 0.0,
        }
    if INPUT_SHAPES[shape_name].kind == "decode":
        with timer.stage("serve_plan"):
            rec["serve_plan"] = serve_plan_for(model.cfg,
                                               INPUT_SHAPES[shape_name])
    rec["stages"] = timer.as_dict()
    rec["compile_s"] = round(time.time() - t0, 1)
    rec["notes"] = _notes(trace)
    if verbose:
        print(f"OK {arch:24s} {shape_name:12s} {mesh_name:6s} "
              f"flops/dev {rec['flops_per_device']:.3e} "
              f"dominant {rec['dominant']:10s} bound {rec['bound_s']*1e3:8.2f} ms "
              f"peak {rec['memory']['peak_estimate']/2**30:6.2f} GiB "
              f"fits {rec['fits_hbm']} ({rec['compile_s']}s)")
        print(f"   trace: bytes/dev {rec['bytes_per_device']:.3e} "
              f"collectives {rec['collectives']} "
              f"replicated {trace.replicated} ({trace.seconds:.1f}s)")
        print(f"   top collective ops: {rec['notes']['top_collective_ops']}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=[*INPUT_SHAPES, None])
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    archs = sorted(all_configs()) if (args.all or not args.arch) else [args.arch]
    shapes = list(INPUT_SHAPES) if (args.all or not args.shape) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    out_f = open(args.out, "a") if args.out else None
    failures = []
    try:
        for mesh_name in meshes:
            for arch in archs:
                for shape_name in shapes:
                    try:
                        rec = run_one(arch, shape_name, mesh_name)
                    except Exception as e:  # noqa: BLE001 - report & continue
                        traceback.print_exc()
                        rec = {"arch": arch, "shape": shape_name,
                               "mesh": mesh_name,
                               "error": f"{type(e).__name__}: {e}"}
                        failures.append(rec)
                    if out_f:
                        out_f.write(json.dumps(rec) + "\n")
                        out_f.flush()
    finally:
        if out_f:
            out_f.close()
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print(" ", f["arch"], f["shape"], f["mesh"], f["error"])
        sys.exit(1)
    print("\nall dry-runs passed")


if __name__ == "__main__":
    main()
