"""Parameter-synchronization schedules for d-Xenos (paper §5, Fig. 11), over
``torch.distributed`` (the counterpart of ``repro.distributed.collectives``).

Two explicit schedules built from point-to-point sends and receives
(``dist.batch_isend_irecv``: one exchange a step, where the reference has
one ``lax.ppermute``), so the collective pattern is ours, not the
backend's:

  * :func:`ring_allreduce` — the bandwidth-optimal ring [Patarasuk &
    Yuan]: (p-1) reduce-scatter steps + (p-1) all-gather steps, 2(p-1)/p
    · bytes per link;
  * :func:`ps_sync` — parameter-server emulation: every worker ships its
    full tensor toward rank 0 hop-by-hop around the ring (the root link
    serializes, (p-1) · bytes through the last hop), the root reduces,
    then the result is broadcast back hop-by-hop.

Both keep the reference's schedule step for step (its padding to a
multiple of p, the chunk each rank sends and adds at each step, and the
zeros a parameter-server rank forwards once its sum has gone by), so each
element is summed in the reference's order: an fp32 result equals the
reference's bit for bit, and ``dist.all_reduce`` within fp32 rounding.

One process a rank, on the caller's process group (default: the world;
``launch.mesh.spawn_ranks`` starts such ranks).  gloo's point-to-point
calls take host tensors only (handed a CUDA tensor, ``dist.send`` passes
the device pointer to ``writev``, which fails with ``Bad address``: the
rank raises or aborts, torch 2.11 on an H100), so on a gloo group a CUDA
input is staged through host buffers: each step copies the piece it
sends to the host and the piece it receives back to the card, where the
adds run.  Times taken that way are gloo's through the host, not card
to card; NCCL (a card a rank) takes the device tensors as they are.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _exchange(piece: torch.Tensor, to: int, frm: int, group) -> torch.Tensor:
    """Send ``piece`` to group rank ``to`` and receive a tensor of its
    shape from group rank ``frm`` (every rank does both in the same
    step): one ``lax.ppermute`` of the reference."""
    stage = piece.is_cuda and dist.get_backend(group) == "gloo"
    send = piece.cpu() if stage else piece.contiguous()
    recv = torch.empty_like(send)
    ops = [dist.P2POp(dist.isend, send, dist.get_global_rank(group, to),
                      group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, frm),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(piece.device) if stage else recv


def _group(group):
    return group if group is not None else dist.group.WORLD


def ring_allreduce(x: torch.Tensor, group=None) -> torch.Tensor:
    """Chunked ring all-reduce of ``x`` over ``group`` (call on every
    rank of it); returns a new tensor and leaves ``x`` as it was (one
    rank: ``x`` itself, as the reference's)."""
    group = _group(group)
    p = dist.get_world_size(group)
    if p == 1:
        return x
    rank = dist.get_rank(group)
    flat = x.reshape(-1)
    pad = (-flat.numel()) % p
    chunks = torch.nn.functional.pad(flat, (0, pad)).reshape(p, -1)
    nxt, prev = (rank + 1) % p, (rank - 1) % p

    # reduce-scatter: after p-1 steps, rank r owns the full sum of chunk
    # (r+1)%p
    for i in range(p - 1):
        recv = _exchange(chunks[(rank - i) % p], nxt, prev, group)
        chunks[(rank - i - 1) % p] += recv
    # all-gather: circulate the reduced chunks
    for i in range(p - 1):
        recv = _exchange(chunks[(rank + 1 - i) % p], nxt, prev, group)
        chunks[(rank - i) % p] = recv
    out = chunks.reshape(-1)
    if pad:
        out = out[:-pad]
    return out.reshape(x.shape)


def ps_sync(x: torch.Tensor, group=None) -> torch.Tensor:
    """Parameter-server emulation over ``group``: reduce to rank 0, then
    broadcast, by ring hops (call on every rank of it); returns a new
    tensor and leaves ``x`` as it was (one rank: ``x`` itself)."""
    group = _group(group)
    p = dist.get_world_size(group)
    if p == 1:
        return x
    rank = dist.get_rank(group)
    nxt, prev = (rank + 1) % p, (rank - 1) % p

    # accumulate toward rank 0: each step, every rank forwards its running
    # sum one hop down; rank 0 accumulates everything after p-1 steps
    acc, inflight = x.clone(), x
    for _ in range(p - 1):
        recv = _exchange(inflight, prev, nxt, group)
        if rank == 0:
            acc += recv
        # non-root ranks keep forwarding what they received
        inflight = torch.zeros_like(recv) if rank == 0 else recv
    # broadcast from root: p-1 hops forward
    val = acc
    for i in range(p - 1):
        recv = _exchange(val, nxt, prev, group)
        if rank == i + 1:
            val = recv
    return val


#: the op library of :func:`route_gloo_cuda_all_gather` (kept alive: the
#: registration lasts as long as the library object)
_ROUTES: list = []


def route_gloo_cuda_all_gather() -> bool:
    """Route the functional all-gather (``_c10d_functional.
    all_gather_into_tensor``: DTensor's gather of a shard, a ``Shard`` to
    ``Replicate`` redistribution) of CUDA tensors through c10d's
    ``all_gather_into_tensor``, once a process.  On a gloo group torch
    2.11's functional all-gather of CUDA tensors kills the rank
    (SIGSEGV, an H100 with four ranks on one card), where c10d's call
    and every other collective DTensor calls (all-reduce,
    reduce-scatter, all-to-all) run: gloo stages CUDA tensors through
    the host either way.  Only a process whose CUDA tensors meet gloo
    groups alone calls this (``launch.mesh.make_train_mesh``): the route
    is synchronous, and NCCL's own functional all-gather needs none.
    Returns whether it registered the route now."""
    if _ROUTES:
        return False
    from torch.distributed.distributed_c10d import _resolve_process_group

    def all_gather(x: torch.Tensor, group_size: int, group_name: str):
        out = x.new_empty((x.shape[0] * group_size,) + tuple(x.shape[1:]))
        dist.all_gather_into_tensor(out, x.contiguous(),
                                    group=_resolve_process_group(group_name))
        return out
    lib = torch.library.Library("_c10d_functional", "IMPL")
    lib.impl("all_gather_into_tensor", all_gather, "CUDA")
    _ROUTES.append(lib)
    return True
