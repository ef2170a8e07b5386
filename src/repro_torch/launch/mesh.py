"""The meshes of the port, and the processes that hold their ranks.

The counterpart of ``repro.launch.mesh``.  The reference builds a 1-D
``("model",)`` device mesh inside one process and ``shard_map``s the
serving step over it; the port runs one process per rank, joined by a
``torch.distributed`` process group, and each rank computes its own
shard of every step (``repro_torch.distributed.tp``).

:func:`make_serving_mesh` joins the group from inside a rank;
:func:`spawn_ranks` starts the ranks (``torch.multiprocessing``, the
``spawn`` context), runs one function on each and returns what each
returned, failing if a rank fails or outlives its timeout.

The production and debug meshes (:func:`make_production_mesh`,
:func:`make_debug_mesh`) are the reference's axis names and sizes
(:class:`~repro_torch.distributed.sharding.MeshShape`).  A training
rank joins one as a ``DeviceMesh`` (:func:`make_train_mesh`, through
``spawn_ranks(..., train_shape=)``); the dry run
(``launch/dryrun.py``) holds their ranks as *fake* ones:
:func:`fake_mesh` joins this process, as rank 0, to a ``"fake"``
process group of the mesh's world size, whose collectives move no data,
and yields its ``DeviceMesh``.
"""
from __future__ import annotations

import contextlib
import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback

import torch

from .. import resolve_device
from ..distributed.collectives import route_gloo_cuda_all_gather
from ..distributed.sharding import MeshShape
from ..distributed.tp import ServingMesh


def make_production_mesh(*, multi_pod: bool = False) -> MeshShape:
    """16x16 single-pod (256 ranks) or 2x16x16 multi-pod (512 ranks)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return MeshShape(dict(zip(axes, shape)))


def make_debug_mesh(n_devices: int, *, multi_pod: bool = False) -> MeshShape:
    """Small-rank-count analogue for CI/tests (same axis names)."""
    if multi_pod:
        if n_devices % 2:
            raise ValueError(f"a multi-pod mesh needs an even rank count, "
                             f"got {n_devices}")
        d = _split(n_devices // 2)
        return MeshShape(dict(zip(("pod", "data", "model"), (2,) + d)))
    return MeshShape(dict(zip(("data", "model"), _split(n_devices))))


def _split(n: int) -> tuple[int, int]:
    a = 1
    for c in range(int(n ** 0.5), 0, -1):
        if n % c == 0:
            a = c
            break
    return (n // a, a)


@contextlib.contextmanager
def fake_mesh(mesh: MeshShape):
    """Join a ``"fake"`` process group of ``mesh.size`` ranks as rank 0
    and yield its ``DeviceMesh`` (device type ``"cpu"``, the mesh's axis
    names): collectives on it return at once and move nothing, so one
    process can trace a rank of a production mesh.  The group is
    destroyed on exit, error or not.  Refuses to run while this process
    is in a process group already: the group is process-global."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("fake_mesh: this process is in a process group "
                           "already")
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=mesh.size)
    try:
        yield init_device_mesh("cpu", tuple(mesh.shape.values()),
                               mesh_dim_names=mesh.axis_names)
    finally:
        dist.destroy_process_group()


def make_serving_mesh(shards: int, *, rank: int = 0, devices=None,
                      init_method: str | None = None,
                      timeout_s: float = 600.0) -> ServingMesh:
    """Join rank ``rank`` of a ``shards``-rank concat-TP mesh.

    ``devices`` lists each rank's device; by default rank ``i`` takes
    ``cuda:i``, and a mesh wider than the visible cards raises
    ``ValueError``, as the reference's does: never shrink the mesh
    silently.  An explicit list may place several ranks on one device
    (``["cuda:0", "cuda:0"]``, or ``"cpu"`` for every rank: each rank is
    a process).  Backend: NCCL when every rank has a card of its own,
    else gloo (NCCL refuses two ranks on one card).  ``init_method`` is
    the group's rendezvous (``file://...`` or ``tcp://localhost:<port>``);
    ``timeout_s`` bounds each collective.  A rank on the host takes its
    share of the host's cores as intra-op threads (ranks that each spin
    up every core slow each other several times over).  Rank 0 prints
    the backend it took."""
    if shards < 1:
        raise ValueError(f"serving mesh needs >= 1 shard, got {shards}")
    if shards == 1:
        device = _rank_device(1, 0, devices)[0]
        return ServingMesh(shards=1, rank=0, device=device)
    device, backend, devs = _join(shards, rank, devices, init_method,
                                  timeout_s)
    import torch.distributed as dist
    if rank == 0:
        print(f"serving mesh: {shards} ranks on "
              f"{[str(d) for d in devs]}, backend {backend}", flush=True)
    return ServingMesh(shards=shards, rank=rank, device=device,
                       group=dist.group.WORLD, backend=backend)


def make_train_mesh(shape: MeshShape, *, rank: int = 0, devices=None,
                    init_method: str | None = None,
                    timeout_s: float = 600.0):
    """Join rank ``rank`` of a training mesh of ``shape``'s axis names and
    sizes (:func:`make_debug_mesh`'s, :func:`make_production_mesh`'s) and
    return its ``DeviceMesh``: every rank joins a world group (even one
    rank alone: a DTensor needs a group), ranks laid out in row-major
    order of the shape.  ``devices``, the backend (gloo where ranks share
    a device, NCCL with a card a rank), ``init_method`` and
    ``timeout_s`` as :func:`make_serving_mesh` takes them; gloo with CUDA
    tensors takes DTensor's all-gathers through
    ``distributed.collectives.route_gloo_cuda_all_gather``.  Rank 0
    prints the mesh and backend.  :func:`mesh_device` gives the rank's
    device."""
    from torch.distributed.device_mesh import init_device_mesh

    device, backend, devs = _join(shape.size, rank, devices, init_method,
                                  timeout_s)
    routed = backend == "gloo" and device.type == "cuda"
    if routed:
        route_gloo_cuda_all_gather()
    if rank == 0:
        print(f"training mesh: {dict(shape.shape)} on "
              f"{[str(d) for d in devs]}, backend {backend}"
              + (" (DTensor's all-gathers through c10d's "
                 "all_gather_into_tensor)" if routed else ""), flush=True)
    return init_device_mesh(device.type, tuple(shape.shape.values()),
                            mesh_dim_names=shape.axis_names)


def mesh_device(mesh) -> torch.device:
    """The device of this rank of a ``DeviceMesh`` (its current card, or
    the host)."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _rank_device(shards: int, rank: int, devices) -> tuple:
    """(this rank's device, every rank's) from ``devices`` (default: a card
    a rank, :func:`default_devices`); the rank's card is made current, a
    host rank takes its share of the host's cores."""
    if devices is None:
        devices = default_devices(shards)
    devs = [torch.device(d) for d in devices]
    if len(devs) != shards:
        raise ValueError(f"{len(devs)} devices listed for {shards} shards")
    if not 0 <= rank < shards:
        raise ValueError(f"rank {rank} outside a {shards}-shard mesh")
    device = resolve_device(devs[rank])
    if device.type == "cuda":
        torch.cuda.set_device(device)
    elif shards > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // shards))
    return device, devs


def _join(shards: int, rank: int, devices, init_method, timeout_s):
    """Join the world group as ``rank`` of ``shards`` -> (this rank's
    device, the backend, every rank's device)."""
    import torch.distributed as dist
    device, devs = _rank_device(shards, rank, devices)
    cards = [(d.index or 0) for d in devs if d.type == "cuda"]
    backend = "nccl" if len(set(cards)) == shards else "gloo"
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=shards,
        timeout=datetime.timedelta(seconds=timeout_s))
    return device, backend, devs


def default_devices(shards: int) -> list[str]:
    """One card a rank, ``cuda:0`` .. ``cuda:<shards-1>``; raises
    ``ValueError`` when fewer cards are visible."""
    visible = torch.cuda.device_count()
    if shards > visible:
        raise ValueError(
            f"a {shards}-rank mesh needs {shards} devices, "
            f"{visible} visible (pass devices= to place several ranks on "
            "one device)")
    return [f"cuda:{i}" for i in range(shards)]


def _rank_main(rank, fn, args, shards, devices, init_method, timeout_s,
               results, train_shape) -> None:
    import torch.distributed as dist
    try:
        if train_shape is None:
            mesh = make_serving_mesh(shards, rank=rank, devices=devices,
                                     init_method=init_method,
                                     timeout_s=timeout_s)
        else:
            mesh = make_train_mesh(train_shape, rank=rank, devices=devices,
                                   init_method=init_method,
                                   timeout_s=timeout_s)
        results.put((rank, True, fn(mesh, *args)))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_ranks(fn, shards: int, *, args: tuple = (), devices=None,
                timeout_s: float = 120.0, store_dir=None,
                train_shape: MeshShape | None = None) -> list:
    """Run ``fn(mesh, *args)`` on ``shards`` ranks, one spawned process
    each (``fn`` must be importable by name), and return the ranks'
    results in rank order.  ``mesh`` is the rank's :class:`ServingMesh`
    (:func:`make_serving_mesh`), or with ``train_shape`` (a
    :class:`MeshShape` of ``shards`` ranks) its training ``DeviceMesh``
    (:func:`make_train_mesh`).

    The ranks meet through a ``torch.distributed.FileStore`` in a fresh
    directory under ``store_dir`` (default: the system's temporary
    directory), so no TCP port is taken.  A rank that raises fails the
    call with its traceback; one that dies, or ranks that do not finish
    within ``timeout_s``, fail it too (``RuntimeError`` /
    ``TimeoutError``), and every rank still running is then killed.
    ``devices`` goes to :func:`make_serving_mesh`."""
    if train_shape is not None and train_shape.size != shards:
        raise ValueError(f"a mesh of {train_shape.size} ranks spawned on "
                         f"{shards}")
    ctx = torch.multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="serving-mesh-", dir=store_dir)
    init_method = "file://" + os.path.join(tmp, "store")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, fn, args, shards, devices, init_method,
                               timeout_s, results, train_shape))
             for r in range(shards)]
    deadline = time.monotonic() + timeout_s
    got: dict[int, object] = {}
    try:
        for p in procs:
            p.start()
        while len(got) < shards:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"ranks {sorted(set(range(shards)) - set(got))} of "
                    f"{shards} did not finish within {timeout_s:.0f} s")
            try:
                rank, ok, out = results.get(timeout=min(left, 1.0))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in got and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(
                        f"rank {dead[0]} of {shards} died (exit code "
                        f"{procs[dead[0]].exitcode}) without a result")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {shards} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [got[r] for r in range(shards)]
