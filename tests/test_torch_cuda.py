"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``cuda`` and skips on a host without an NVIDIA
card: a CUDA kernel has no CPU mode.  The file imports no JAX, so it runs
on a card machine that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import ctypes
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.kernels.decode_attention import ops as t_da
from repro_torch.kernels.fused_sampler import ops as t_fs
from repro_torch.kernels.linked_cbr_pool import ops as t_cb
from repro_torch.kernels.linked_matmul import ops as t_lm
from repro_torch.kernels.split_matmul import ops as t_sm


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


#: element-wise |kernel - plain| <= atol + rtol * |plain|, by input type
TOL = {"float32": dict(rtol=3e-5, atol=3e-5),
       "bfloat16": dict(rtol=2e-2, atol=1e-3)}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D,G", [(32, 3), (64, 4), (128, 2), (128, 8),
                                 (256, 4), (256, 1)])
def test_decode_kernels_match_plain(card, dtype, D, G):
    """Dense (ragged W, a row with no valid slot) and paged (-1 table
    entries, a length-0 row) flash-decode vs the plain masked softmax,
    element by element."""
    dt = getattr(torch, dtype)
    B, K, W = 3, 2, 300
    H = K * G
    rnd = lambda *s: torch.randn(s, generator=card, device="cuda").to(dt)
    q, k, v = rnd(B, H, D), rnd(B, W, K, D), rnd(B, W, K, D)
    valid = torch.rand((B, W), generator=card, device="cuda") < 0.5
    valid[1] = False
    want = t_da.gqa_decode_plain(q, k, v, valid).float()
    got = t_da.gqa_decode(q, k, v, valid).float()
    torch.testing.assert_close(got, want, **TOL[dtype])
    bs, M = 16, 5
    kp, vp = rnd(B * M, bs, K, D), rnd(B * M, bs, K, D)
    bt = torch.arange(B * M, dtype=torch.int32, device="cuda").reshape(B, M)
    bt[2, 3:] = -1
    ln = torch.tensor([80, 0, 40], dtype=torch.int32, device="cuda")
    want = t_da.gqa_decode_paged_plain(q, kp, vp, bt, ln).float()
    got = t_da.gqa_decode_paged(q, kp, vp, bt, ln).float()
    torch.testing.assert_close(got, want, **TOL[dtype])


def _rnd(card, dt, *shape):
    return torch.randn(shape, generator=card, device="cuda").to(dt)


def _pool_case(card, dt, lengths, M, bs, K, G, D):
    """q, pools of B*M blocks in a shuffled order, block tables that are
    -1 past each row's length, and the lengths (int32)."""
    B = len(lengths)
    kp, vp = _rnd(card, dt, B * M, bs, K, D), _rnd(card, dt, B * M, bs, K, D)
    perm = torch.randperm(B * M, generator=card, device="cuda").reshape(B, M)
    ln = torch.tensor(lengths, dtype=torch.int32, device="cuda")
    start = torch.arange(M, device="cuda")[None, :] * bs
    bt = torch.where(start < ln[:, None], perm, -1).to(torch.int32)
    return _rnd(card, dt, B, K * G, D), kp, vp, bt.contiguous(), ln


def _check_dense(card, dtype, valid, K, G, D):
    dt = getattr(torch, dtype)
    B, W = valid.shape
    q = _rnd(card, dt, B, K * G, D)
    k, v = _rnd(card, dt, B, W, K, D), _rnd(card, dt, B, W, K, D)
    torch.testing.assert_close(t_da.gqa_decode(q, k, v, valid).float(),
                               t_da.gqa_decode_plain(q, k, v, valid).float(),
                               **TOL[dtype])


def _check_paged(card, dtype, lengths, M, bs, K, G, D):
    args = _pool_case(card, getattr(torch, dtype), lengths, M, bs, K, G, D)
    torch.testing.assert_close(t_da.gqa_decode_paged(*args).float(),
                               t_da.gqa_decode_paged_plain(*args).float(),
                               **TOL[dtype])


def _prefix(lengths, W):
    ln = torch.tensor(lengths, device="cuda")
    return torch.arange(W, device="cuda")[None, :] < ln[:, None]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernels_at_every_length(card, dtype):
    """Every length from 0 to W, eight rows a call: dense prefixes of a
    300-slot ring, paged rows of a 19 x 16-slot table."""
    K, G, D, W = 2, 2, 64, 300
    for a in range(0, W + 1, 8):
        ls = [min(x, W) for x in range(a, a + 8)]
        _check_dense(card, dtype, _prefix(ls, W), K, G, D)
    M, bs = 19, 16
    for a in range(0, M * bs + 1, 8):
        ls = [min(x, M * bs) for x in range(a, a + 8)]
        _check_paged(card, dtype, ls, M, bs, K, G, D)


def _main_edges():
    """The main shape's split count and the lengths where its pieces
    change: each split boundary of a full row, S, 16 S, 32 S and 64 S
    (pieces of one slot, half a 32-slot tile, one tile, two tiles) and
    W."""
    B, K, G, W, D = 8, 8, 2, 2048, 128
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    S = t_da.decode_grid(B, K, G, W, sms, D).splits
    edges = {t_da.split_range(0, W, S, s)[0] for s in range(1, S)}
    edges |= {S, 16 * S, 32 * S, 64 * S, W}
    return S, sorted({min(W, max(0, e + d)) for e in edges
                      for d in (-1, 0, 1)})


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernels_on_split_boundaries(card, dtype):
    """At the main shape (8 rows, W 2048, 8 kv heads, G 2, D 128, bs 32):
    lengths on each split boundary and one slot either side of it, as
    dense prefixes, as dense windows that start there (lo > 0) and as
    paged rows."""
    W, K, G, D, bs = 2048, 8, 2, 128, 32
    _, lengths = _main_edges()
    lengths = lengths + [560] * (-len(lengths) % 8)
    for a in range(0, len(lengths), 8):
        ls = lengths[a:a + 8]
        _check_dense(card, dtype, _prefix(ls, W), K, G, D)
        pos = torch.arange(W, device="cuda")[None, :]
        lo = torch.tensor(ls, device="cuda")[:, None]
        late = (pos >= lo) & (pos < lo + 560)
        _check_dense(card, dtype, late, K, G, D)
        _check_paged(card, dtype, ls, W // bs, bs, K, G, D)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_dense_late_and_wrapped_rings(card, dtype):
    """Ring masks: a late window, one reaching the last slot, a wrapped
    window (a hole in the middle of the span), only the last slot, only
    the first, a scattered half and no valid slot."""
    W = 2048
    valid = torch.zeros(8, W, dtype=torch.bool, device="cuda")
    valid[0, 1500:] = True
    valid[1, 1000:1560] = True
    valid[2, :50] = True
    valid[2, W - 100:] = True
    valid[3, W - 1] = True
    valid[4, 0] = True
    valid[5] = torch.rand(W, generator=card, device="cuda") < 0.5
    valid[7, 777:1337] = True
    _check_dense(card, dtype, valid, 8, 2, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("D", [32, 64, 128, 256])
@pytest.mark.parametrize("G", [1, 2, 3, 4, 8])
def test_decode_kernels_across_group_and_head_sizes(card, dtype, D, G):
    """G query heads per kv head, head_dim D: dense (a random mask, a late
    window, an empty row; ragged W) and paged at block sizes 16 and 32."""
    W, K = 300, 2
    valid = torch.rand((4, W), generator=card, device="cuda") < 0.5
    valid[1] = False
    valid[2] = False
    valid[2, 200:290] = True
    _check_dense(card, dtype, valid, K, G, D)
    for bs in (16, 32):
        M = -(-W // bs)
        _check_paged(card, dtype, [W // 3, 0, M * bs, 1], M, bs, K, G, D)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B", [8, 1])
def test_decode_kernels_at_gemma3_shapes(card, dtype, B):
    """gemma3-1b's decode: one kv head of 256, G = 4.  A sliding layer's
    512-slot ring (full, wrapped with its span starting mid-row, short)
    and a global layer's 2048-slot horizon, dense and paged at block
    sizes 16 and 32.  B = 1 puts fp32's row at the heads body's D = 256
    one-merge cap (24, the merge filling the ring's 48 KB) and bf16's past
    the group body's (16): two merge levels."""
    K, G, D = 1, 4, 256
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if B == 1:
        plan = t_da.decode_grid(B, K, G, 2048, sms, D,
                                getattr(torch, dtype))
        cap = t_da.merge_cap(plan.body, D, plan.gt)
        assert plan.splits == cap if dtype == "float32" else \
            plan.splits > cap
    for W in (512, 2048):
        pos = torch.arange(W, device="cuda")[None, :]
        start = torch.tensor([137, 0, W - 3, 300, 1, 0, 64, 511][:B],
                             device="cuda")[:, None]
        n = torch.tensor([512, 512, 3, 200, 1, 0, 500, 512][:B],
                         device="cuda")[:, None]
        wrapped = ((pos - start) % W) < n        # a ring's live span
        _check_dense(card, dtype, wrapped, K, G, D)
        ls = [W, 600 % W, 0, 1, W - 1, 17, 513 % W, 256][:B]
        _check_dense(card, dtype, _prefix(ls, W), K, G, D)
        for bs in (16, 32):
            _check_paged(card, dtype, ls, W // bs, bs, K, G, D)


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [16, 24])
def test_decode_kernels_on_long_rows(card, bs):
    """Rows longer than the main path's: a paged table of more than 128
    blocks, a block size that is not a power of two, and a 4800-slot dense
    ring (a longer mask row in shared memory)."""
    W = 4800
    ls = [0, 1, 777, 2049, 3000, W - 1, W, 4500]
    _check_paged(card, "float32", ls, W // bs, bs, 2, 2, 128)
    valid = _prefix(ls, W)
    valid[1, 4000:4100] = True
    _check_dense(card, "float32", valid, 2, 2, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernels_repeat_bit_for_bit(card, dtype):
    """The splits merge in a fixed order: two calls give the same bits."""
    dt = getattr(torch, dtype)
    ls = [560, 512, 600, 0, 2048, 1, 530, 777]
    valid = _prefix(ls, 2048)
    q = _rnd(card, dt, 8, 16, 128)
    k, v = _rnd(card, dt, 8, 2048, 8, 128), _rnd(card, dt, 8, 2048, 8, 128)
    assert torch.equal(t_da.gqa_decode(q, k, v, valid),
                       t_da.gqa_decode(q, k, v, valid))
    args = _pool_case(card, dt, ls, 64, 32, 8, 2, 128)
    assert torch.equal(t_da.gqa_decode_paged(*args),
                       t_da.gqa_decode_paged(*args))


@pytest.mark.cuda
def test_decode_kernels_interleave_layouts_on_one_stream(card):
    """Calls of different grids (B, H, D, S) in turn on one stream: each
    layout's tickets stay its own, so every call still agrees."""
    for _ in range(2):
        for ls, K, G, D in (([560] * 8, 8, 2, 128), ([5, 300, 0], 2, 3, 32),
                            ([100, 1], 1, 8, 64), ([2048] * 8, 8, 2, 128)):
            W = max(max(ls), 1)
            _check_dense(card, "float32", _prefix(ls, W), K, G, D)
            _check_paged(card, "float32", ls, -(-W // 16), 16, K, G, D)


@pytest.mark.cuda
def test_decode_kernels_replay_in_a_cuda_graph(card):
    """Captured once, replayed after ``valid`` / ``lengths`` and the block
    tables change in place: each replay follows the new values (it equals
    an eager launch and the plain version)."""
    dt = torch.bfloat16
    valid = _prefix([560] * 8, 2048)
    q = _rnd(card, dt, 8, 16, 128)
    k, v = _rnd(card, dt, 8, 2048, 8, 128), _rnd(card, dt, 8, 2048, 8, 128)
    graph, out = _graphed(lambda: t_da.gqa_decode(q, k, v, valid))
    q2, kp, vp, bt, ln = _pool_case(card, dt, [560] * 8, 64, 32, 8, 2, 128)
    pgraph, pout = _graphed(lambda: t_da.gqa_decode_paged(q2, kp, vp, bt, ln))
    for ls in ([1, 2048, 0, 33, 600, 1999, 17, 560], [0] * 8,
               [2048] * 8):
        valid.copy_(_prefix(ls, 2048))
        graph.replay()
        assert torch.equal(out, t_da.gqa_decode(q, k, v, valid))
        torch.testing.assert_close(
            out.float(), t_da.gqa_decode_plain(q, k, v, valid).float(),
            **TOL["bfloat16"])
        new = _pool_case(card, dt, ls, 64, 32, 8, 2, 128)
        bt.copy_(new[3])
        ln.copy_(new[4])
        pgraph.replay()
        assert torch.equal(pout, t_da.gqa_decode_paged(q2, kp, vp, bt, ln))
        torch.testing.assert_close(
            pout.float(),
            t_da.gqa_decode_paged_plain(q2, kp, vp, bt, ln).float(),
            **TOL["bfloat16"])


@pytest.mark.cuda
def test_decode_graphs_of_one_layout_replay_in_any_order(card):
    """A dense and a paged graph of the same layout, the second replayed
    first: each capture zeroes a scratch of its own (none is shared with
    the other graph or with eager launches), so every replay agrees."""
    dt = torch.bfloat16
    ls = [560, 512, 600, 0, 2048, 1, 530, 777]
    valid = _prefix(ls, 2048)
    q = _rnd(card, dt, 8, 16, 128)
    k, v = _rnd(card, dt, 8, 2048, 8, 128), _rnd(card, dt, 8, 2048, 8, 128)
    pargs = _pool_case(card, dt, ls, 64, 32, 8, 2, 128)
    eager = t_da.gqa_decode(q, k, v, valid)
    peager = t_da.gqa_decode_paged(*pargs)
    graph, out = _graphed(lambda: t_da.gqa_decode(q, k, v, valid))
    pgraph, pout = _graphed(lambda: t_da.gqa_decode_paged(*pargs))
    for buf in t_da._SCRATCH.values():   # nonzero tickets outside the graphs
        buf.fill_(1)
    for g, o, want in ((pgraph, pout, peager), (graph, out, eager),
                       (pgraph, pout, peager), (graph, out, eager)):
        o.zero_()
        g.replay()
        assert torch.equal(o, want)
    for buf in t_da._SCRATCH.values():
        buf.zero_()
    assert torch.equal(t_da.gqa_decode(q, k, v, valid), eager)


@pytest.mark.cuda
def test_decode_wrappers_launch_one_kernel_and_never_sync(card):
    """One kernel per call (qwen3's G 2 in bf16: the group body) and no
    host synchronization (sync debug mode raises on one)."""
    from torch.autograd import DeviceType
    dt = torch.bfloat16
    valid = _prefix([560] * 8, 2048)
    q = _rnd(card, dt, 8, 16, 128)
    k, v = _rnd(card, dt, 8, 2048, 8, 128), _rnd(card, dt, 8, 2048, 8, 128)
    pargs = _pool_case(card, dt, [560] * 8, 64, 32, 8, 2, 128)
    t_da.gqa_decode(q, k, v, valid)           # scratch made outside
    t_da.gqa_decode_paged(*pargs)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        torch.cuda.set_sync_debug_mode("error")
        try:
            t_da.gqa_decode(q, k, v, valid)
            t_da.gqa_decode_paged(*pargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    launched = [(e.key, e.count) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA]
    assert sum(n for _, n in launched) == 2, launched
    assert all("group_kernel" in name for name, _ in launched), launched


# -- the group body and the two-level merge ------------------------------------

def _both(card, dtype, valid, lengths, K, G, D, bs=16, plan=None):
    """Both kernels (dense over ``valid``, paged at ``lengths``) against
    their plain versions, each called twice (the same bits), at the
    shapes' plan or ``plan``."""
    dt = getattr(torch, dtype)
    B, W = valid.shape
    q = _rnd(card, dt, B, K * G, D)
    k, v = _rnd(card, dt, B, W, K, D), _rnd(card, dt, B, W, K, D)
    got = t_da.gqa_decode(q, k, v, valid, plan)
    assert torch.equal(got, t_da.gqa_decode(q, k, v, valid, plan))
    torch.testing.assert_close(got.float(),
                               t_da.gqa_decode_plain(q, k, v, valid).float(),
                               **TOL[dtype])
    args = _pool_case(card, dt, lengths, -(-W // bs), bs, K, G, D)
    got = t_da.gqa_decode_paged(*args, plan)
    assert torch.equal(got, t_da.gqa_decode_paged(*args, plan))
    torch.testing.assert_close(got.float(),
                               t_da.gqa_decode_paged_plain(*args).float(),
                               **TOL[dtype])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [3, 5, 6, 7, 8, 16])
def test_decode_group_body_matches_plain(card, dtype, G):
    """Every G the group body takes in bf16 (the heads body in fp32), at
    head dims 32, 128 and 256 (where these shapes' plan takes the heads
    body, the group body is forced too, at the planned split count): a
    random mask with an empty row and a late window (ragged W), paged
    rows of -1 tables, a length-0 row and a full one; the same bits
    twice."""
    W, K = 300, 2
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for D in (32, 128, 256):
        plan = t_da.decode_grid(4, K, G, W, sms, D, getattr(torch, dtype))
        plans = [None]
        if dtype == "float32":
            assert plan.body == "heads"
        elif D <= 128:
            assert plan.body == "group"
        else:
            plans.append(t_da.DecodePlan("group", G, plan.splits))
        valid = torch.rand((4, W), generator=card, device="cuda") < 0.5
        valid[1] = False
        valid[2] = False
        valid[2, 200:290] = True
        for p in plans:
            _both(card, dtype, valid, [W // 3, 0, W, 1], K, G, D, plan=p)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("G", [1, 2, 4, 16])
def test_decode_merge_levels_match_plain(card, dtype, G):
    """Plans forced across the merge's shapes: one split, one merge full
    (cap), one past it (two levels, the last group one piece), two levels
    of ragged groups and cap^2 splits (cap groups of cap), pieces of no
    slot among them; in bf16 both bodies, in fp32 the heads body."""
    W, K, D = 700, 1, 64
    bodies = ["heads"] + (["group"] if dtype == "bfloat16" else [])
    lengths = [700, 3, 0, 451]
    valid = _prefix(lengths, W)
    valid[3, :100] = False
    for body in bodies:
        gt = G if body == "group" else 2 - G % 2
        cap = t_da.merge_cap(body, D, gt)
        for S in sorted({1, cap, cap + 1, 2 * cap + 3, cap * cap}):
            plan = t_da.DecodePlan(body, gt, S)
            assert t_da.decode_grid(4, K, G, W, 132, D, plan=plan) == plan
            _both(card, dtype, valid, lengths, K, G, D, plan=plan)


def _long_edges(plan, W, cap):
    """Lengths of one row where a 32,768-slot plan's pieces and merge
    groups change: fewer slots than splits (empty pieces, empty groups),
    one slot a piece, the first slot of each group's first piece at a
    full row, a slot either side, and W."""
    S = plan.splits
    groups = t_da.merge_groups(S, cap)
    ls = {1, S - 1, S, S + 1, 16 * S, W - 1, W, 31776}
    for a, _ in groups[1:]:
        e = t_da.split_range(0, W, S, a)[0]
        ls |= {e - 1, e, e + 1}
    return sorted(x for x in ls if 0 < x <= W)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("heads", [(16, 8, 128), (4, 1, 256)],
                         ids=["qwen3", "gemma3"])
def test_decode_kernels_at_one_long_row(card, dtype, heads):
    """One row over 32,768 slots (phase 3g's slot) at qwen3's heads (bf16:
    the group body at 32 splits, one merge) and gemma3's (bf16: the group
    body's 256 splits in 16 groups, two merge levels; fp32: the heads
    body at both): lengths on the split boundaries and the merge groups'
    boundaries, as dense prefixes, as a dense window starting at half the
    length, and as paged rows (block size 32); the same bits twice."""
    H, K, D = heads
    G, W, bs = H // K, 32768, 32
    dt = getattr(torch, dtype)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = t_da.decode_grid(1, K, G, W, sms, D, dt)
    cap = t_da.merge_cap(plan.body, D, plan.gt)
    if dtype == "bfloat16" and D == 256:
        assert len(t_da.merge_groups(plan.splits, cap)) > 1
    q = _rnd(card, dt, 1, H, D)
    k, v = _rnd(card, dt, 1, W, K, D), _rnd(card, dt, 1, W, K, D)
    kp, vp = k.reshape(W // bs, bs, K, D), v.reshape(W // bs, bs, K, D)
    perm = torch.randperm(W // bs, generator=card, device="cuda")
    pos = torch.arange(W, device="cuda")[None, :]
    for n in _long_edges(plan, W, cap):
        for valid in (pos < n, (pos >= n // 2) & (pos < n // 2 + n)):
            got = t_da.gqa_decode(q, k, v, valid)
            assert torch.equal(got, t_da.gqa_decode(q, k, v, valid))
            torch.testing.assert_close(
                got.float(), t_da.gqa_decode_plain(q, k, v, valid).float(),
                **TOL[dtype])
        ln = torch.tensor([n], dtype=torch.int32, device="cuda")
        start = torch.arange(W // bs, device="cuda")[None, :] * bs
        bt = torch.where(start < n, perm[None], -1).to(torch.int32)
        args = (q, kp, vp, bt.contiguous(), ln)
        got = t_da.gqa_decode_paged(*args)
        assert torch.equal(got, t_da.gqa_decode_paged(*args))
        torch.testing.assert_close(
            got.float(), t_da.gqa_decode_paged_plain(*args).float(),
            **TOL[dtype])


@pytest.mark.cuda
def test_decode_group_body_replays_in_a_cuda_graph(card):
    """gemma3's heads at one row over 32,768 slots (the group body, two
    merge levels): captured once, replayed after ``valid`` / ``lengths``
    and the block table change in place; each replay equals an eager
    launch and the plain version."""
    dt, K, G, D, W, bs = torch.bfloat16, 1, 4, 256, 32768, 32
    q = _rnd(card, dt, 1, G, D)
    k, v = _rnd(card, dt, 1, W, K, D), _rnd(card, dt, 1, W, K, D)
    valid = _prefix([31776], W)
    graph, out = _graphed(lambda: t_da.gqa_decode(q, k, v, valid))
    q2, kp, vp, bt, ln = _pool_case(card, dt, [31776], W // bs, bs, K, G, D)
    pgraph, pout = _graphed(lambda: t_da.gqa_decode_paged(q2, kp, vp, bt,
                                                          ln))
    for n in (1, 300, 0, W, 20001):
        valid.copy_(_prefix([n], W))
        graph.replay()
        assert torch.equal(out, t_da.gqa_decode(q, k, v, valid))
        torch.testing.assert_close(
            out.float(), t_da.gqa_decode_plain(q, k, v, valid).float(),
            **TOL["bfloat16"])
        new = _pool_case(card, dt, [n], W // bs, bs, K, G, D)
        bt.copy_(new[3])
        ln.copy_(new[4])
        pgraph.replay()
        assert torch.equal(pout, t_da.gqa_decode_paged(q2, kp, vp, bt, ln))
        torch.testing.assert_close(
            pout.float(),
            t_da.gqa_decode_paged_plain(q2, kp, vp, bt, ln).float(),
            **TOL["bfloat16"])


#: fused_mask policies (T, k, p), cycled over a batch's rows: T = 0,
#: k <= 0, k >= V, k = 1, p = 1, top-p alone and both filters; "V" and
#: "V2" stand for the row length and half of it
MASK_POLICIES = [(0.0, 0, 1.0), (0.8, 50, 0.95), (1.3, "V", 0.5),
                 (0.5, 1, 1.0), (0.0, -3, 0.3), (1.0, 5, 0.7),
                 (0.8, "V2", 1.0), (2.0, 0, 0.9), (0.8, 1, 0.5),
                 (0.7, 50, 1.0), (1.1, 0, 0.95)]


def _mask_policies(B, V, policies=MASK_POLICIES):
    """(temperature, top_k, top_p) on the card, policy i % len for row i."""
    rows = [policies[i % len(policies)] for i in range(B)]
    k = [V if k == "V" else V // 2 if k == "V2" else k for _, k, _ in rows]
    return (torch.tensor([t for t, _, _ in rows], device="cuda"),
            torch.tensor(k, dtype=torch.int32, device="cuda"),
            torch.tensor([p for _, _, p in rows], device="cuda"))


def _mask_rows(seed, B, V, stride=None, tied=False):
    """(B, V) logits ~ 3 N(0, 1) from numpy, as a slice of (B, stride) rows
    (a row stride past V, as served); ``tied`` rounds them to halves, so
    thousands of tokens tie at every value."""
    rng = np.random.default_rng(seed)
    full = rng.normal(size=(B, stride or V)).astype(np.float32) * 3
    if tied:
        full = np.round(full * 2) / 2
    return torch.from_numpy(full).cuda()[:, :V]


def _check_mask(rows, temps, ks, ps, **kw):
    """Equal survivor values and equal -inf support except on the tokens
    ``nucleus_boundary`` marks; returns the kernel's output."""
    got = t_fs.fused_mask(rows, temps, ks, ps, **kw)
    want = t_fs.fused_mask_plain(rows, temps, ks, ps)
    free = t_fs.nucleus_boundary(rows, temps, ks, ps)
    differ = torch.isinf(got) != torch.isinf(want)
    assert not (differ & ~free).any()
    both = ~torch.isinf(got) & ~torch.isinf(want)
    assert torch.equal(got[both], want[both])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("B,V,stride", [
    (8, 17, None), (8, 1000, None), (8, 151936, None), (8, 151936, 152064),
    (8, 151935, 151939), (1, 151936, 152064), (64, 151936, 152064),
    (3, 1001, 1003)])
def test_fused_mask_kernel_matches_plain(card, B, V, stride):
    """Equal survivor values and equal -inf support, on heterogeneous
    policies (T = 0, k <= 0, k >= V, k = 1, p = 1, top-p alone) and on
    tied logits (at k = 50 thousands of survivors: past the top-p list,
    the kernel's radix path), except on the tokens ``nucleus_boundary``
    marks: the kernel decides the nucleus on exact sums of fp64 masses
    and keeps every top-k survivor at p >= 1, the plain version (the
    reference's search) in fp32.  One row (B = 1), more rows than the
    card holds clusters at once (B = 64), V off the clusters' 4-element
    slices (17, 1000, 151935), and row strides past V, 16-byte (152064)
    and not (151939, 1003)."""
    temps, ks, ps = _mask_policies(B, V)
    for tied in (False, True):
        _check_mask(_mask_rows(V + B, B, V, stride, tied), temps, ks, ps)


@pytest.mark.cuda
def test_fused_mask_both_nucleus_paths_and_every_cluster_agree(card):
    """The nucleus cut from the gathered top-k list and by the radix select
    over masses (``cap`` = 0 forces it), and every cluster size that holds
    the row, give the same bits: the masses are summed exactly."""
    B, V = 11, 20000
    temps, ks, ps = _mask_policies(B, V)
    for tied in (False, True):
        rows = _mask_rows(7, B, V, V + 4, tied)
        want = _check_mask(rows, temps, ks, ps)
        for cl in t_fs.CL_CHOICES:
            plan = t_fs.MaskPlan(cl, -(-V // (4 * cl)) * 4, t_fs.CAP)
            for cap in (0, plan.cap, 512):
                got = t_fs.fused_mask(rows, temps, ks, ps,
                                      plan=plan._replace(cap=cap))
                assert torch.equal(got, want), (cl, cap, tied)


@pytest.mark.cuda
@pytest.mark.parametrize("V", [1000, 151936])
def test_fused_mask_repeats_bit_for_bit(card, V):
    temps, ks, ps = _mask_policies(8, V)
    for tied in (False, True):
        rows = _mask_rows(3, 8, V, V + 128, tied)
        first = t_fs.fused_mask(rows, temps, ks, ps)
        for _ in range(3):
            assert torch.equal(t_fs.fused_mask(rows, temps, ks, ps), first)


@pytest.mark.cuda
def test_fused_mask_replays_in_a_cuda_graph(card):
    """Captured once at the served shape, replayed after the rows and every
    policy (T, k, p) are written in place: each replay equals an eager
    launch and holds the plain version's support."""
    B, V = 8, 151936
    logits = torch.zeros((B, V + 128), device="cuda")
    rows = logits[:, :V]
    temps, ks, ps = _mask_policies(B, V)
    kernels.reset_launches()
    graph, out = _graphed(lambda: t_fs.fused_mask(rows, temps, ks, ps))
    assert kernels.RECORDED["fused_mask"] >= 1
    policies = [MASK_POLICIES, MASK_POLICIES[::-1],
                [(0.8, 50, 0.95)] * B, [(0.0, 0, 1.0)] * B]
    for i, pol in enumerate(policies):
        logits.copy_(_mask_rows(11 + i, B, V + 128, tied=i == 2))
        for dst, src in zip((temps, ks, ps), _mask_policies(B, V, pol)):
            dst.copy_(src)
        graph.replay()
        assert torch.equal(out, t_fs.fused_mask(rows, temps, ks, ps))
        _check_mask(rows, temps, ks, ps)


def _graph_node_types(graph) -> list[int]:
    """The CUgraphNodeType of every node of a captured CUDA graph (made
    with ``keep_graph=True``), read through the driver API."""
    cuda = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert cuda.cuGraphGetNodes(raw, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert cuda.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) == 0
    types = []
    for node in nodes:
        kind = ctypes.c_int(-1)
        assert cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                       ctypes.byref(kind)) == 0
        types.append(kind.value)
    return types


@pytest.mark.cuda
def test_fused_mask_launches_one_kernel_and_never_syncs(card):
    """One call enqueues exactly one device operation, a kernel: captured
    into a CUDA graph, it leaves a single kernel node (node type 0) and
    the wrapper records one launch.  No host synchronization (sync debug
    mode raises on one).  At the served shape and at shapes that take the
    radix path over masses."""
    for B, V, tied in ((8, 151936, False), (8, 151936, True), (3, 1001, True)):
        temps, ks, ps = _mask_policies(B, V)
        rows = _mask_rows(5, B, V, V + 128, tied)
        t_fs.fused_mask(rows, temps, ks, ps)   # plan and library outside
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            t_fs.fused_mask(rows, temps, ks, ps)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        kernels.RECORDED["fused_mask"] = 0
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph):
            t_fs.fused_mask(rows, temps, ks, ps)
        assert _graph_node_types(graph) == [0], (B, V, tied)
        assert kernels.RECORDED["fused_mask"] == 1, (B, V, tied)


@pytest.mark.cuda
def test_fused_mask_planner_knows_the_kernel(card):
    """The planner's static shared memory is the kernel's; the card holds
    every SM's CTA alone (cluster of 1) and at most sms // cl clusters of
    cl one CTA an SM; a row no cluster can hold is refused."""
    assert t_fs._lib().repro_fused_mask_static_smem() == t_fs.STATIC_SMEM
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    solo = t_fs.solo_clusters(torch.device("cuda", 0))
    assert solo(1) == sms
    assert all(1 <= solo(cl) <= sms // cl for cl in t_fs.CL_CHOICES)
    V = 16 * 60000
    temps, ks, ps = _mask_policies(1, V)
    with pytest.raises(ValueError, match="does not fit"):
        t_fs.fused_mask(torch.zeros((1, V), device="cuda"), temps, ks, ps)
    with pytest.raises(ValueError, match="unit column stride"):
        t_fs.fused_mask(torch.zeros((8, 2), device="cuda").t(),
                        *_mask_policies(2, 8))


#: cbr_avgpool: |kernel - plain| <= 2e-5 + 2e-5 |plain|, IEEE fp32 both
CBRA_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,W,C,OC", [
    (1, 16, 16, 64, 128), (1, 8, 8, 1024, 1024), (1, 224, 224, 24, 224),
    (2, 7, 9, 3, 10), (3, 33, 31, 40, 70), (1, 2, 2, 1, 1),
    (2, 64, 64, 48, 33), (2, 64, 64, 48, 96), (1, 100, 98, 24, 45),
    (1, 4, 4, 256, 64), (1, 6, 6, 100, 40)])
def test_cbr_avgpool_kernel_matches_plain(card, N, H, W, C, OC):
    """The Figure-5 and Table-4 shapes, odd H and W (floored), C and OC
    off the tiles and off multiples of 4 (4-byte copies, scalar stores),
    N > 1, each with the plan ``cbra_plan`` picks (mid CTAs walking square
    tiles, and the k-split small and tiny ones with C split over
    clusters)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x = torch.randn((N, H, W, C), generator=card, device="cuda")
    w = torch.randn((C, OC), generator=card, device="cuda") / C ** 0.5
    b = torch.randn((OC,), generator=card, device="cuda") * 0.1
    kernels.reset_launches()
    got = t_cb.cbr_avgpool(x, w, b)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["cbr_avgpool"] == 1
    assert got.shape == (N, H // 2, W // 2, OC)
    torch.testing.assert_close(got, t_cb.cbr_avgpool_plain(x, w, b),
                               **CBRA_TOL)
    conv_layout = t_cb.cbr_avgpool(x, w[None, None], b)
    assert torch.equal(conv_layout, got)


def _cbra_case(card, N, H, W, C, OC):
    x = torch.randn((N, H, W, C), generator=card, device="cuda")
    w = torch.randn((C, OC), generator=card, device="cuda") / C ** 0.5
    b = torch.randn((OC,), generator=card, device="cuda") * 0.1
    return x, w, b


@pytest.mark.cuda
@pytest.mark.parametrize("N,H,W,C,OC", [
    (1, 16, 16, 64, 128), (1, 8, 8, 1024, 1024), (1, 40, 36, 24, 224),
    (2, 7, 9, 3, 10), (1, 6, 10, 100, 44), (2, 5, 5, 200, 36)])
def test_cbr_avgpool_every_plan_matches_plain(card, N, H, W, C, OC):
    """Every plan ``cbra_plans`` lists (each CTA shape, cluster size, ring
    depth, and square tiles a CTA walks), at the main path's C and OC and
    off them (C = 3 and OC = 10: 4-byte copies; C = 100:
    a last step of 4 channels; C = 200: 7 steps over clusters of 1, 2 and
    4), each against the plain version, twice (the same bits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    x, w, b = _cbra_case(card, N, H, W, C, OC)
    want = t_cb.cbr_avgpool_plain(x, w, b)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for plan in t_cb.cbra_plans(N, H, W, C, OC, sms):
        got = t_cb.cbr_avgpool(x, w, b, plan=plan)
        torch.testing.assert_close(got, want, **CBRA_TOL, msg=str(plan))
        assert torch.equal(got, t_cb.cbr_avgpool(x, w, b, plan=plan)), plan


@pytest.mark.cuda
def test_cbr_avgpool_replays_in_a_cuda_graph(card):
    """Captured at each Table-4 shape's plan, replayed on new x and w
    written in place: each replay equals an eager launch."""
    for shape in ((1, 8, 8, 1024, 1024), (1, 224, 224, 24, 224)):
        x, w, b = _cbra_case(card, *shape)
        graph, out = _graphed(lambda: t_cb.cbr_avgpool(x, w, b))
        for i in range(2):
            x.copy_(torch.randn(x.shape, generator=card, device="cuda"))
            w.mul_(-0.5)
            graph.replay()
            assert torch.equal(out, t_cb.cbr_avgpool(x, w, b)), (shape, i)


@pytest.mark.cuda
def test_cbr_avgpool_unaligned_tensors_take_4_byte_copies(card):
    """x that starts 4 bytes past a 16-byte boundary: the wrapper must not
    ask for 16-byte copies."""
    base = torch.randn((1 + 12 * 12 * 24,), generator=card, device="cuda")
    x = base[1:].view(1, 12, 12, 24)
    assert x.data_ptr() % 16 != 0
    _, w, b = _cbra_case(card, 1, 12, 12, 24, 32)
    torch.testing.assert_close(t_cb.cbr_avgpool(x, w, b),
                               t_cb.cbr_avgpool_plain(x, w, b), **CBRA_TOL)


@pytest.mark.cuda
def test_cbr_avgpool_rejects_what_it_does_not_take(card):
    x = torch.randn((1, 4, 4, 8), generator=card, device="cuda")
    w = torch.randn((8, 16), generator=card, device="cuda")
    b = torch.zeros((16,), device="cuda")
    with pytest.raises(ValueError, match="float32"):
        t_cb.cbr_avgpool(x.half(), w, b)
    with pytest.raises(ValueError, match="contiguous"):
        t_cb.cbr_avgpool(x.transpose(1, 2), w, b)
    with pytest.raises(ValueError, match="one CUDA device"):
        t_cb.cbr_avgpool(x, w.cpu(), b)
    with pytest.raises(ValueError, match="1x1"):
        t_cb.cbr_avgpool(x, torch.zeros((3, 3, 8, 16), device="cuda"), b)


@pytest.mark.cuda
def test_cnn_engine_routes_cbra_and_graphs_xenos(card):
    """The routed xenos engine launches the kernel, equals the torch-plan
    engine to 2e-5, its CUDA-graph replays equal the eager run, and the
    three modes agree at the engine tolerance."""
    import numpy as np

    from repro_torch.core import build_engine, init_params, pipeline
    from repro_torch.launch.optimize_graph import cbra_graph
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    g = cbra_graph("t", (2, 24, 20, 40), 72)
    params = init_params(g, seed=0)
    x = torch.randn((2, 24, 20, 40), generator=card, device="cuda")
    plan, _ = pipeline.select_kernel_plan({"accelerator": "cuda"})
    out = {}
    for name, mode, p, graphed in (("vanilla", "vanilla", None, True),
                                   ("ho", "ho", None, True),
                                   ("torch", "xenos", None, False),
                                   ("eager", "xenos", plan, False),
                                   ("graphed", "xenos", plan, True)):
        eng, _ = build_engine(g, mode, plan=p, graphed=graphed)
        kernels.reset_launches()
        out[name] = [eng(params, x)[0].clone() for _ in range(3)]
        if p is None:
            assert kernels.LAUNCHES["cbr_avgpool"] == 0, name
        else:
            assert kernels.LAUNCHES["cbr_avgpool"] >= 3, name
    for a in out["graphed"]:
        assert torch.equal(a, out["eager"][0])
    torch.testing.assert_close(out["eager"][0], out["torch"][0], **CBRA_TOL)
    for mode in ("ho", "graphed"):
        np.testing.assert_allclose(out[mode][0].cpu().numpy(),
                                   out["vanilla"][0].cpu().numpy(),
                                   rtol=3e-4, atol=1e-6)


def _two_cbra_graph():
    """Two Conv1x1 -> Bn -> Relu -> AvgPool2 branches on one input, each
    an output: each links into a cbra, so the routed xenos engine
    launches cbr_avgpool twice per call."""
    from repro_torch.core import graph as G
    g = G.Graph("two_cbra")
    x = g.add_input("x", (2, 16, 12, 24))
    for out_c in (40, 24):
        g.mark_output(G.pool(g, G.relu(g, G.bn(g, G.conv2d(g, x, out_c, 1))),
                             "avg", 2))
    return g


@pytest.mark.cuda
def test_cnn_engine_graph_counts_what_eager_launches(card):
    """A capture launches nothing and counts in RECORDED; each replay
    adds exactly the launches one eager call makes."""
    from repro_torch.core import build_engine, init_params, pipeline
    g = _two_cbra_graph()
    params = init_params(g, seed=0)
    x = torch.randn((2, 16, 12, 24), generator=card, device="cuda")
    plan, _ = pipeline.select_kernel_plan({"accelerator": "cuda"})
    eager, _ = build_engine(g, "xenos", plan=plan, graphed=False)
    graphed, _ = build_engine(g, "xenos", plan=plan)
    kernels.reset_launches()
    eager(params, x)
    per_call = kernels.LAUNCHES["cbr_avgpool"]
    assert per_call == 2
    graphed(params, x)                 # warm-up + capture + one replay
    recorded = graphed._cuda_graph["launches"]["cbr_avgpool"]
    assert recorded == per_call
    kernels.reset_launches()
    for _ in range(3):
        graphed(params, x)
    assert kernels.LAUNCHES["cbr_avgpool"] == 3 * per_call


@pytest.mark.cuda
def test_cnn_engine_graph_sees_swapped_weights(card):
    """A weight replaced in the same params dict is read by the next
    call (the graph captures again); one written in place is read by the
    next replay."""
    from repro_torch.core import build_engine, init_params, pipeline
    torch.backends.cudnn.allow_tf32 = False
    g = _two_cbra_graph()
    params = init_params(g, seed=0)
    x = torch.randn((2, 16, 12, 24), generator=card, device="cuda")
    plan, _ = pipeline.select_kernel_plan({"accelerator": "cuda"})
    eager, _ = build_engine(g, "xenos", plan=plan, graphed=False)
    graphed, _ = build_engine(g, "xenos", plan=plan)
    before = graphed(params, x)[0].clone()
    name = next(n for n in params if n.endswith(".w"))   # branch 0's conv
    params[name] = torch.randn(params[name].shape, generator=card,
                               device="cuda")
    swapped = graphed(params, x)[0].clone()
    assert not torch.equal(swapped, before)
    assert torch.equal(swapped, eager(params, x)[0])
    params[name].mul_(0.5)
    halved = graphed(params, x)[0].clone()
    assert not torch.equal(halved, swapped)
    assert torch.equal(halved, eager(params, x)[0])


def _graphed(fn):
    """Capture ``fn()`` into a CUDA graph (after a side-stream warm-up);
    returns (graph, its static output)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    return graph, out


def _mlp(card, M, d, ff, dtype):
    """x ~ N(0, 1), weights at the model's fan-in scale, in ``dtype``."""
    rnd = lambda *s: torch.randn(s, generator=card, device="cuda")
    return (rnd(M, d).to(dtype), (rnd(d, ff) / d ** 0.5).to(dtype),
            (rnd(d, ff) / d ** 0.5).to(dtype),
            (rnd(ff, d) / ff ** 0.5).to(dtype))


def _plan(x, wg, wu, wd):
    """The plan the wrapper picks for these tensors on this card."""
    aligned = all(t.data_ptr() % 16 == 0 for t in (x, wg, wu, wd))
    return t_lm.mlp_plan(x.numel() // x.shape[-1], x.shape[-1],
                         wg.shape[1], x.dtype, aligned,
                         torch.cuda.get_device_properties(0)
                         .multi_processor_count,
                         slots=t_lm.cluster_slots(x.device))


#: linked_mlp: fp32 element-wise against the plain version; bf16 against
#: the fp64-summed MLP (``_hold_bf16``)
MLP_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
           "bfloat16": dict(rtol=2e-2, atol=1e-3)}


def _mlp_faults(x, wg, wu, wd):
    """The planted faults' inputs (``chip_smoke.mlp_faults``'): the
    up-projection term of the largest |x| left out, and the ff column
    whose h is largest left out."""
    x_cut = x.clone()
    x_cut[:, x.float().abs().amax(0).argmax()] = 0
    wd_cut = wd.clone()
    wd_cut[(torch.nn.functional.silu(x.float() @ wg.float())
            * (x.float() @ wu.float())).abs().amax(0).argmax()] = 0
    return [(x_cut, wg, wu, wd), (x, wg, wu, wd_cut)]


def _hold_bf16(got, x, wg, wu, wd, plan=None):
    """The bf16 check (``mlp_reference``, shared with chip_smoke.py): the
    kernel's result and the plain version's within the fp64-summed MLP's
    limit; both planted faults, launched through the kernel (``plan``),
    outside it."""
    ref, limit = t_lm.mlp_reference(x, wg, wu, wd)
    assert t_lm.reference_err(got, ref, limit) <= 1.0
    assert t_lm.reference_err(t_lm.linked_mlp_plain(x, wg, wu, wd), ref,
                              limit) <= 1.0
    for args in _mlp_faults(x, wg, wu, wd):
        assert t_lm.reference_err(t_lm.linked_mlp(*args, plan=plan), ref,
                                  limit) > 1.0


#: each tensor-core body's launch counter
_BODY_KEY = {"decode": "linked_mlp_tc", "swap": "linked_mlp_tc_swap",
             "prefill": "linked_mlp_tc_prefill"}


def _body_launches(plan, n):
    """The launch counts ``n`` launches of ``plan`` leave."""
    return {"linked_mlp": n, **{k: n if plan.body == body else 0
                                for body, k in _BODY_KEY.items()}}


def _launches():
    return {k: kernels.LAUNCHES[k] for k in ("linked_mlp",
                                             *_BODY_KEY.values())}


def _decode_key(cfg, rows=None):
    """The counter of the body ``cfg``'s SwiGLU takes at decode (the
    engine's slots' rows) on this card."""
    x = torch.empty((rows or SERVE_SLOTS, cfg.d_model), dtype=torch.bfloat16,
                    device="cuda")
    w = torch.empty((cfg.d_model, cfg.d_ff), dtype=torch.bfloat16,
                    device="cuda")
    return _BODY_KEY[_plan(x, w, w, w.t()).body]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,M,d,ff", [
    ("bfloat16", 8, 2048, 6144), ("bfloat16", 256, 2048, 6144),
    ("bfloat16", 1, 2048, 6144), ("float32", 64, 512, 1024),
    ("float32", 37, 50, 130), ("bfloat16", 13, 2047, 129),
    ("float32", 8, 6000, 70), ("bfloat16", 1, 1, 1),
    ("bfloat16", 5, 136, 200), ("float32", 37, 64, 136),
    ("bfloat16", 37, 256, 208), ("float32", 1100, 256, 512),
    ("bfloat16", 8, 1152, 6912), ("bfloat16", 256, 1152, 6912),
    ("bfloat16", 8, 4096, 13696), ("bfloat16", 8, 6144, 16384),
    ("bfloat16", 8, 8192, 22016), ("bfloat16", 8, 4096, 14336),
    ("bfloat16", 8, 7168, 4864), ("bfloat16", 1, 8192, 22016)])
def test_linked_mlp_kernel_matches_plain(card, dtype, M, d, ff):
    """The serving shapes (decode M = 8, prefill M = 8 x 32, M = 1; qwen3's
    d 2048, gemma3's d 1152, ff 6912, and the large decoders' decode:
    chatglm3-6b's d 4096, granite-8b's ff 14336, internlm2-20b's 6144,
    chameleon-34b's 8192 (at M 1 too), arctic-480b's dense residual (d
    7168, ff 4864): the swap body, one cluster over d), fp32,
    ragged M, d and ff with 16-byte loads where rows are aligned (a last
    ff block of 8 or 16 columns) and scalar loads where not, a d wide
    enough to shrink the row tile, and more row tiles than SMs (one ff
    split: each CTA walks all of ff); two launches give the same bits (no
    atomics).  fp32 element-wise against the plain version, bf16 against
    the fp64-summed MLP (``_hold_bf16``)."""
    dt = getattr(torch, dtype)
    x, wg, wu, wd = _mlp(card, M, d, ff, dt)
    plan = _plan(x, wg, wu, wd)
    kernels.reset_launches()
    got = t_lm.linked_mlp(x, wg, wu, wd)
    again = t_lm.linked_mlp(x, wg, wu, wd)
    torch.cuda.synchronize()
    want = _body_launches(plan, 2)
    if plan.path != "tc":
        want.update(linked_mlp_tc=0, linked_mlp_tc_swap=0,
                    linked_mlp_tc_prefill=0)
    assert _launches() == want
    assert got.dtype == dt and got.shape == (M, d)
    assert torch.equal(got, again)
    if dtype == "bfloat16":
        _hold_bf16(got, x, wg, wu, wd)
    else:
        torch.testing.assert_close(
            got.float(), t_lm.linked_mlp_plain(x, wg, wu, wd).float(),
            **MLP_TOL[dtype])
    batched = t_lm.linked_mlp(x[None], wg, wu, wd)
    assert batched.shape == (1, M, d) and torch.equal(batched[0], got)


@pytest.mark.cuda
@pytest.mark.parametrize("M,d,ff", [
    (15, 2048, 6144), (16, 2048, 6144), (17, 2048, 6144),
    (63, 2048, 6144), (64, 2048, 6144), (65, 2048, 6144),
    (129, 2048, 6144), (8, 2048, 6144), (200, 2048, 320),
    (70, 136, 200), (300, 1000, 520), (17, 8, 8), (129, 2040, 1032),
    (4352, 2048, 1032), (8, 1152, 6912), (256, 1152, 6912),
    (65, 1152, 6912), (256, 4096, 14336), (256, 6144, 16384),
    (256, 8192, 22016), (8, 7168, 4864), (37, 2056, 6144),
    (8, 4104, 13704), (65, 6152, 16392), (4352, 4096, 13696),
    (1, 2056, 6144), (64, 2056, 6144), (33, 4096, 13696), (13, 4104, 13704),
    (32, 6152, 16392), (16, 8200, 22016), (32, 8192, 22016),
    (33, 6144, 16384)])
def test_linked_mlp_tc_path_at_tile_edges(card, M, d, ff):
    """The tensor-core kernel on either side of its 16-row m16 tiles, its
    64-row M tiles and its 64-column ff blocks; d and ff multiples of 8
    but not of 64 (a partial last slice of y, a last ff block of 8
    columns); S > 1 (partials through the workspace) and S = 1 (y stored
    directly, M = 4352); a cluster dealt fewer ff blocks than it has
    CTAs (ff 320: 5 blocks over 8 ranks).  Past d 2048 clusters split d
    (``tc_columns``): 32-token chunks of the large decoders (d 4096, 6144,
    8192), arctic-480b's dense residual (d 7168), and the ragged
    ownership: d 2056 (one column block past 2048), 4104 and 6152 (no
    cluster's 256-column ranks divide them), with ff no multiple of 64;
    chatglm3-6b's batched prefill; the swap body's rows (one cluster
    over d: 1-64 rows at d 2056 and 4096, up to 32 at 4104-8192, 16 at
    8200) and past them (33 rows at d 6144: the decode body).  The
    planner sends each of these to the tensor-core kernel (``tc_body``:
    the prefill body from PREFILL_ROWS rows on, the swap body at decode
    rows); two launches give the same bits.  Every shape is held
    against the fp64-summed MLP (``_hold_bf16``); past 1024 rows the
    kernel's worst error from it also within MLP_ORDER_FACTOR times the
    plain version's."""
    x, wg, wu, wd = _mlp(card, M, d, ff, torch.bfloat16)
    plan = _plan(x, wg, wu, wd)
    assert plan.path == "tc"
    covers = M <= 64 and d <= 64 * 16 * min(16, 256 // t_lm.swap_rows(M))
    assert plan.body == ("prefill" if M >= t_lm.PREFILL_ROWS else "swap"
                         if covers and (M <= 32 or d > 2048) else "decode")
    if (M, ff) == (200, 320):
        assert -(-ff // 64) < plan.cl
    if M == 4352:
        assert plan.S == 1
    kernels.reset_launches()
    got = t_lm.linked_mlp(x, wg, wu, wd)
    again = t_lm.linked_mlp(x, wg, wu, wd)
    torch.cuda.synchronize()
    assert _launches() == _body_launches(plan, 2)
    assert torch.equal(got, again)
    _hold_bf16(got, x, wg, wu, wd)
    if M > 1024:
        ref = _mlp_fp64(x, wg, wu, wd)
        plain = t_lm.linked_mlp_plain(x, wg, wu, wd)
        assert _mlp_err(got, ref) <= MLP_ORDER_FACTOR * _mlp_err(plain, ref)


@pytest.mark.cuda
def test_linked_mlp_tc_splits_ff_where_the_m_tiles_do_not_fill(card):
    """Both sides of the split: few M tiles take S > 1 ff splits and a
    workspace, as many M tiles as clusters a wave take S = 1."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    slots = t_lm.cluster_slots(torch.device("cuda", 0))
    few = t_lm.mlp_plan(256, 2048, 6144, torch.bfloat16, True, sms,
                        slots=slots)
    many = t_lm.mlp_plan(4352, 2048, 6144, torch.bfloat16, True, sms,
                         slots=slots)
    assert few.path == many.path == "tc"
    assert few.S > 1 and few.workspace == few.S * 256 * 2048
    assert many.S == 1 and many.workspace == 0


@pytest.mark.cuda
def test_linked_mlp_tc_batched_at_internlm2_width_on_real_clusters(card):
    """internlm2-20b's batched prefill, M 4352 at d 6144, ff 16384: the
    occupancy calculator's cluster counts (non-portable sizes past 8
    included) plan the tensor-core kernel on clusters that split d, and
    the launch holds against the fp64-summed MLP as batched prefill's
    shapes are held; the same bits twice."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    slots = t_lm.cluster_slots(torch.device("cuda", 0))
    x, wg, wu, wd = _mlp(card, 4352, 6144, 16384, torch.bfloat16)
    plan = _plan(x, wg, wu, wd)
    assert plan == t_lm.mlp_plan(4352, 6144, 16384, torch.bfloat16, True,
                                 sms, slots=slots)
    assert plan.path == "tc" and plan.body == "prefill"
    assert plan.cl in t_lm.tc_clusters(6144, t_lm.TP_DS)
    assert slots(plan.cl) > 0 and plan.cl * t_lm.TP_DS < 6144
    kernels.reset_launches()
    got = t_lm.linked_mlp(x, wg, wu, wd)
    again = t_lm.linked_mlp(x, wg, wu, wd)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["linked_mlp_tc_prefill"] == 2
    assert torch.equal(got, again)
    ref = _mlp_fp64(x, wg, wu, wd)
    plain = t_lm.linked_mlp_plain(x, wg, wu, wd)
    assert _mlp_err(got, ref) <= MLP_ORDER_FACTOR * _mlp_err(plain, ref)
    _hold_bf16(got, x, wg, wu, wd)


#: batched prefill's shape, bf16: the kernel's worst error from the
#: fp64-summed MLP at most this many times the plain version's
MLP_ORDER_FACTOR = 2.0


def _mlp_fp64(x, wg, wu, wd):
    """Sums in fp64; h and y rounded to x's dtype as in the plain version."""
    x64, g64, u64, d64 = (a.double() for a in (x, wg, wu, wd))
    h = (torch.nn.functional.silu(x64 @ g64) * (x64 @ u64)).to(x.dtype)
    return (h.double() @ d64).to(x.dtype)


def _mlp_err(got, ref):
    tol = MLP_TOL["bfloat16"]
    got, ref = got.float(), ref.float()
    return ((got - ref).abs() / (tol["atol"] + tol["rtol"] * ref.abs())
            ).max().item()


@pytest.mark.cuda
def test_linked_mlp_batched_prefill_within_order_noise(card):
    """Batched prefill pads 8 admitted prompts to the longest (544
    tokens): M = 4352 in bf16, where two correct fp32 summation orders,
    each rounding h to bf16, can land a few ulps apart.  The kernel's
    worst error from the fp64-summed MLP stays within MLP_ORDER_FACTOR
    times the plain version's, and leaving out one up-projection term
    fails that test."""
    x, wg, wu, wd = _mlp(card, 8 * 544, 2048, 6144, torch.bfloat16)
    ref = _mlp_fp64(x, wg, wu, wd)
    e_plain = _mlp_err(t_lm.linked_mlp_plain(x, wg, wu, wd), ref)
    kernels.reset_launches()
    got = t_lm.linked_mlp(x, wg, wu, wd)
    assert kernels.LAUNCHES["linked_mlp_tc_prefill"] == 1
    assert torch.equal(got, t_lm.linked_mlp(x, wg, wu, wd))
    assert _mlp_err(got, ref) <= MLP_ORDER_FACTOR * e_plain
    x[:, -1] = 0
    assert _mlp_err(t_lm.linked_mlp(x, wg, wu, wd), ref) \
        > MLP_ORDER_FACTOR * e_plain


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,path,one_split", [
    ("float32", "ffma", False), ("bfloat16", "tc", False),
    ("bfloat16", "tc", True), ("bfloat16", "swap", False),
    ("bfloat16", "swap", True), ("bfloat16", "swap_wide", False)])
def test_linked_mlp_replays_in_a_cuda_graph(card, dtype, path, one_split):
    """Captured with its workspace from the graph's pool, replayed on new
    inputs written in place: each replay equals an eager launch (the FFMA
    kernel; the tensor-core kernel's decode body, forced, and its swap
    body, planned, with the planner's S > 1 and with S = 1; the swap
    body past d 2048, at 13 rows of d 4104)."""
    M, d, ff = (13, 4104, 13704) if path == "swap_wide" else (8, 512, 1536)
    x, wg, wu, wd = _mlp(card, M, d, ff, getattr(torch, dtype))
    plan = _plan(x, wg, wu, wd)
    if path == "tc":
        plan = t_lm.mlp_plan(8, 512, 1536, x.dtype, True,
                             torch.cuda.get_device_properties(0)
                             .multi_processor_count, path="tc",
                             slots=t_lm.cluster_slots(x.device),
                             body="decode")
    assert plan.body == {"ffma": "ffma", "tc": "decode"}.get(path, "swap")
    assert plan.S > 1
    if one_split:
        plan = plan._replace(S=1, workspace=0)
    graph, out = _graphed(lambda: t_lm.linked_mlp(x, wg, wu, wd, plan=plan))
    for _ in range(3):
        x.copy_(torch.randn(x.shape, generator=card, device="cuda"))
        graph.replay()
        assert torch.equal(out, t_lm.linked_mlp(x, wg, wu, wd, plan=plan))


@pytest.mark.cuda
def test_linked_mlp_rejects_what_it_does_not_take(card):
    x, wg, wu, wd = _mlp(card, 4, 64, 96, torch.float32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        t_lm.linked_mlp(x.half(), wg.half(), wu.half(), wd.half())
    with pytest.raises(ValueError, match="share"):
        t_lm.linked_mlp(x, wg.bfloat16(), wu, wd)
    with pytest.raises(ValueError, match="contiguous"):
        t_lm.linked_mlp(x, wg, wu, wd.t().contiguous().t())
    with pytest.raises(ValueError, match="one CUDA device"):
        t_lm.linked_mlp(x, wg.cpu(), wu, wd)
    with pytest.raises(ValueError, match="want"):
        t_lm.linked_mlp(x, wg, wu, wd[:, :10])
    wide = _mlp(card, 1, 30000, 8, torch.float32)
    with pytest.raises(ValueError, match="does not fit"):
        t_lm.linked_mlp(*wide)


def _prefill_plan(x, wg, wu, wd, **kw):
    """The prefill body's plan for these tensors, forced."""
    return t_lm.mlp_plan(x.numel() // x.shape[-1], x.shape[-1], wg.shape[1],
                         x.dtype, True,
                         torch.cuda.get_device_properties(0)
                         .multi_processor_count, path="tc",
                         slots=t_lm.cluster_slots(x.device), body="prefill",
                         **kw)


@pytest.mark.cuda
@pytest.mark.parametrize("M,d,ff", [
    (127, 2048, 6144), (128, 2048, 6144), (129, 2048, 6144),
    (4352, 2048, 6144), (256, 1152, 6912), (129, 1600, 5504),
    (256, 4096, 13696), (129, 6144, 16384), (1, 2048, 6144),
    (300, 1000, 520), (4352, 2056, 1032)])
def test_linked_mlp_prefill_body_against_fp64(card, M, d, ff):
    """The prefill body (128-row tiles, TMA ring, x multicast to the
    cluster, h pushed between ranks) at tile edges (M 128 +- 1, one row,
    batched prefill's 4352) and at d 1152 / 1600 / 2048 / 4096 / 6144
    (clusters of 9, 13, 16 ranks of 128 columns; past 2048, clusters
    splitting d), a ragged d and ff: held against the fp64-summed MLP
    with the shared check, both planted faults launched through the body
    failing it; two launches give the same bits."""
    x, wg, wu, wd = _mlp(card, M, d, ff, torch.bfloat16)
    plan = _prefill_plan(x, wg, wu, wd)
    assert plan.body == "prefill" and plan.bm == t_lm.TP_BM
    kernels.reset_launches()
    got = t_lm.linked_mlp(x, wg, wu, wd, plan=plan)
    again = t_lm.linked_mlp(x, wg, wu, wd, plan=plan)
    torch.cuda.synchronize()
    assert _launches() == _body_launches(plan, 2)
    assert torch.equal(got, again)
    _hold_bf16(got, x, wg, wu, wd, plan=plan)


@pytest.mark.cuda
def test_linked_mlp_prefill_body_replays_in_a_cuda_graph(card):
    """Captured (tensor maps encoded at capture, the workspace from the
    graph's pool) and replayed on new inputs written in place: each
    replay equals an eager launch, with S > 1 and with S = 1."""
    x, wg, wu, wd = _mlp(card, 256, 1024, 2048, torch.bfloat16)
    for S in (None, 1):
        plan = _prefill_plan(x, wg, wu, wd)
        if S is not None:
            plan = plan._replace(S=1, workspace=0)
        graph, out = _graphed(lambda: t_lm.linked_mlp(x, wg, wu, wd,
                                                      plan=plan))
        for _ in range(2):
            x.copy_(torch.randn(x.shape, generator=card, device="cuda"))
            graph.replay()
            assert torch.equal(out, t_lm.linked_mlp(x, wg, wu, wd,
                                                    plan=plan))


@pytest.mark.cuda
def test_linked_mlp_prefill_body_refuses_what_it_does_not_take(card):
    """No fallback: fp32 and unaligned rows are not the body's (the
    planner raises), and a plan the body refuses (more ranks than d's
    128-column blocks, more splits than ff blocks) raises at launch."""
    x, wg, wu, wd = _mlp(card, 256, 512, 1024, torch.bfloat16)
    with pytest.raises(ValueError, match="does not take"):
        t_lm.mlp_plan(256, 512, 1024, torch.float32, True, 132, path="tc",
                      body="prefill")
    with pytest.raises(ValueError, match="does not take"):
        t_lm.mlp_plan(256, 516, 1024, torch.bfloat16, True, 132,
                      path="tc", body="prefill")
    plan = _prefill_plan(x, wg, wu, wd)
    for bad in (plan._replace(cl=5), plan._replace(S=17, workspace=17 *
                                                   256 * 512)):
        with pytest.raises(RuntimeError, match="CUDA launch failed"):
            t_lm.linked_mlp(x, wg, wu, wd, plan=bad)
    torch.cuda.synchronize()


#: split_matmul: element-wise, IEEE fp32 both sides
SPLIT_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,bn,bk", [
    (128, 768, 3072, 1024, 768), (128, 3072, 768, 256, 3072),
    (128, 768, 3072, 3072, 192), (33, 70, 100, 30, 27), (1, 5, 3, 1, 2),
    (200, 64, 65, 65, 64), (512, 200, 2048, 2048, 64),
    (600, 70, 1000, 333, 27), (128, 768, 3072, 3072, 256),
    (1, 768, 3072, 1024, 768), (1, 3072, 768, 256, 3072)])
def test_split_matmul_kernel_matches_plain(card, M, K, N, bn, bk):
    """bert_s's two DSP-plan FFN tiles (seq 128, d 768), inC splits (the
    plan's K tiles, each split again over a cluster), M = 1, ragged shapes
    and tiles with 4-byte copies."""
    x = torch.randn((M, K), generator=card, device="cuda")
    w = torch.randn((K, N), generator=card, device="cuda") / K ** 0.5
    b = torch.randn((N,), generator=card, device="cuda")
    kernels.reset_launches()
    got = t_sm.split_matmul(x, w, b, block_n=bn, block_k=bk)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["split_matmul"] == 1
    torch.testing.assert_close(
        got, t_sm.split_matmul_plain(x, w, b, bn, bk), **SPLIT_TOL)


def _split_plan(M, K, N, bn, bk):
    return t_sm.split_plan(M, N, K, bn, bk, torch.cuda.get_device_properties(
        0).multi_processor_count)


@pytest.mark.cuda
def test_split_matmul_plans_split_each_k_tile_over_a_cluster(card):
    """The inC plan (3 K tiles of 256) and M = 1 both take a cluster."""
    inc = _split_plan(128, 768, 3072, 3072, 256)
    assert inc.cl > 1 and -(-768 // 256) == 3
    assert _split_plan(1, 768, 3072, 1024, 768).cl > 1


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,bn,bk", [
    (128, 768, 3072, 1024, 768), (128, 3072, 768, 256, 3072),
    (128, 768, 3072, 3072, 256), (1, 768, 3072, 1024, 768),
    (600, 70, 1000, 333, 27)])
def test_split_matmul_repeats_bit_for_bit(card, M, K, N, bn, bk):
    """No atomics: two launches on the same inputs give the same bits,
    cluster reductions included."""
    x = torch.randn((M, K), generator=card, device="cuda")
    w = torch.randn((K, N), generator=card, device="cuda") / K ** 0.5
    b = torch.randn((N,), generator=card, device="cuda")
    got = t_sm.split_matmul(x, w, b, block_n=bn, block_k=bk)
    assert torch.equal(got, t_sm.split_matmul(x, w, b, block_n=bn,
                                              block_k=bk))


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,bn,bk", [(64, 96, 48, 16, 32),
                                         (128, 768, 3072, 1024, 768)])
def test_split_matmul_replays_in_a_cuda_graph(card, M, K, N, bn, bk):
    """A plan without and one with a cluster split, replayed on new
    inputs written in place: each replay equals an eager launch."""
    x = torch.randn((M, K), generator=card, device="cuda")
    w = torch.randn((K, N), generator=card, device="cuda")
    b = torch.randn((N,), generator=card, device="cuda")
    assert (_split_plan(M, K, N, bn, bk).cl > 1) == (M == 128)
    graph, out = _graphed(lambda: t_sm.split_matmul(x, w, b, block_n=bn,
                                                    block_k=bk))
    for _ in range(3):
        x.copy_(torch.randn(x.shape, generator=card, device="cuda"))
        graph.replay()
        assert torch.equal(out, t_sm.split_matmul(x, w, b, block_n=bn,
                                                  block_k=bk))


@pytest.mark.cuda
def test_split_matmul_rejects_what_it_does_not_take(card):
    x = torch.randn((4, 8), generator=card, device="cuda")
    w = torch.randn((8, 6), generator=card, device="cuda")
    b = torch.zeros((6,), device="cuda")
    with pytest.raises(ValueError, match="float32"):
        t_sm.split_matmul(x.bfloat16(), w.bfloat16(), b.bfloat16(),
                          block_n=3, block_k=8)
    with pytest.raises(ValueError, match="contiguous"):
        t_sm.split_matmul(x, w.t().contiguous().t(), b, block_n=3,
                          block_k=8)
    with pytest.raises(ValueError, match="one CUDA device"):
        t_sm.split_matmul(x, w, b.cpu(), block_n=3, block_k=8)


@pytest.mark.cuda
def test_cnn_engine_routes_dsp_split_of_bert_s(card):
    """bert_s(d=768) under the DSP spec: the routed ho and xenos engines
    launch split_matmul 4 times per inference (graphed xenos too) and
    equal the torch plan to 2e-5; lstm(d=512) launches none."""
    from repro_torch.configs import cnn_zoo
    from repro_torch.core import build_engine, init_params, pipeline
    from repro_torch.core.dos import DeviceSpec
    torch.backends.cuda.matmul.allow_tf32 = False
    plan, _ = pipeline.select_kernel_plan({"accelerator": "cuda"})
    dsp = DeviceSpec.tms320c6678()
    g = cnn_zoo.bert_s(seq=64, d=768, n_layers=2)
    params = init_params(g, seed=0)
    x = torch.randn(g.tensors[g.inputs[0]].shape, generator=card,
                    device="cuda")
    for mode, graphed in (("ho", False), ("xenos", False), ("xenos", True)):
        plain, _ = build_engine(g, mode, device=dsp, graphed=False)
        routed, _ = build_engine(g, mode, device=dsp, plan=plan,
                                 graphed=graphed)
        want = plain(params, x)[0].clone()
        routed(params, x)
        kernels.reset_launches()
        for _ in range(2):
            got = routed(params, x)[0]
        assert kernels.LAUNCHES["split_matmul"] == 8, (mode, graphed)
        torch.testing.assert_close(got, want, **SPLIT_TOL)
    g = cnn_zoo.lstm(d=512)
    params = init_params(g, seed=0)
    ins = [torch.randn(g.tensors[n].shape, generator=card, device="cuda")
           for n in g.inputs]
    routed, _ = build_engine(g, "ho", device=dsp, plan=plan)
    kernels.reset_launches()
    routed(params, *ins)
    assert kernels.LAUNCHES["split_matmul"] == 0


# -- the serving step as CUDA graphs -------------------------------------------

SERVE_SLOTS, SERVE_MAX_LEN, SERVE_CHUNK, SERVE_BLOCK = 4, 64, 8, 8


def _serve_model():
    """Reduced qwen3-1.7b in bf16 on the card (head_dim 64): every routed
    site has its kernel (decode attention, ``linked_mlp_tc``,
    ``fused_mask``)."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              dtype="bfloat16")
    model = Model(cfg, device="cuda")
    return model, model.init(torch.Generator(device="cuda").manual_seed(0))


def _serve_trace(seed, sampled, vocab):
    """(gap, prompt, max_new, priority, sampling) per request."""
    from repro_torch.serving import SamplingParams
    rng = np.random.default_rng(seed)
    shared = rng.integers(0, vocab, 16)
    out = []
    for rid in range(7):
        n = int(rng.integers(3, 24))
        prompt = np.concatenate([shared, rng.integers(0, vocab, 4)]) \
            if rng.random() < 0.4 else rng.integers(0, vocab, n)
        max_new = int(rng.integers(1, 14))
        sp = SamplingParams(temperature=float(rng.uniform(0.5, 1.2)),
                            top_k=int(rng.choice([0, 8, 50])),
                            top_p=float(rng.choice([1.0, 0.9])),
                            seed=seed * 100 + rid) if sampled else None
        out.append((int(rng.integers(0, 4)), prompt.astype(np.int32),
                    max_new, 1 if rng.random() < 0.25 else 0, sp))
    return out


def _serve_trace_run(model, params, trace, kv, graphed, spec=None,
                     replan_every=10_000, **engine_kw):
    """The trace through a fresh engine (``engine_kw``: more engine
    keywords).  A replanning engine plans from fixed timings (a 10 ms
    decode step, 0.1 ms a prefill token), so two engines adopt the same
    plans whatever their own timings."""
    from repro_torch.serving import Request, ServingEngine
    eng = ServingEngine(model, params, slots=SERVE_SLOTS,
                        max_len=SERVE_MAX_LEN, chunk=SERVE_CHUNK,
                        prefill_mode="chunked", replan_every=replan_every,
                        kv=kv,
                        kv_block_size=SERVE_BLOCK if kv == "paged" else None,
                        graphed=graphed, spec=spec, spec_k_max=4,
                        **engine_kw)
    replan = eng.scheduler.maybe_replan
    eng.scheduler.maybe_replan = lambda decode_step_s, prefill_token_s, \
        **kw: replan(0.01, 1e-4, **kw)
    reqs = []
    for rid, (gap, prompt, max_new, prio, sp) in enumerate(trace):
        for _ in range(gap):
            eng.step()
        req = Request(rid=rid, prompt=prompt.copy(), max_new_tokens=max_new,
                      priority=prio, sampling=sp)
        eng.submit(req)
        reqs.append(req)
    eng.run()
    assert all(r.done for r in reqs)
    return [list(r.generated) for r in reqs], eng


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["dense", "paged"])
@pytest.mark.parametrize("sampled", [False, True])
@pytest.mark.parametrize("spec", [None, "ngram"])
def test_graphed_engine_matches_eager(card, kv, sampled, spec):
    """The engine's CUDA graphs (``serve_sample``, ``verify_sample/K1``)
    emit the eager engine's streams bit for bit, with the same
    speculative counters; every decode tick replays (none falls back)."""
    from repro_torch.serving.speculative import SpecParams
    model, params = _serve_model()
    trace = _serve_trace(3 + sampled, sampled, model.cfg.vocab)
    sp = SpecParams(mode="ngram", k=4, min_ngram=1) if spec else None
    eager, e_eng = _serve_trace_run(model, params, trace, kv, False, sp)
    graphed, g_eng = _serve_trace_run(model, params, trace, kv, True, sp)
    assert graphed == eager
    assert g_eng.spec_stats == e_eng.spec_stats
    stats = g_eng.stats()
    counts, steps = stats["graphs"], stats["steps"]
    assert counts["serve_sample"]["replays"] == \
        steps[1]["calls"] + steps[1]["captures"]
    assert sum(c["replays"] for n, c in counts.items()
               if n.startswith("verify")) == g_eng.spec_stats.verify_calls
    if spec:
        assert g_eng.spec_stats.verify_calls > 0
    # the warm-up before each capture runs the step once: its launches
    n = model.cfg.n_layers
    attn = "gqa_decode" if kv == "dense" else "gqa_decode_paged"
    for name, c in counts.items():
        width = 1 if name == "serve_sample" else int(name.split("/")[1])
        assert c["launches"][attn] == n * width, name
        assert c["warmup_launches"][attn] == c["captures"] * n * width, name
        assert c["warmup_launches"]["fused_mask"] == c["captures"], name


def _family_model(pattern):
    """gemma3-shaped on the card, bf16: head_dim 256, one kv head, G = 4,
    a 32-token window; ``pattern`` "SG" (a sliding and a global layer:
    the mixed pool) or "" (every layer sliding: the ring pool)."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config("gemma3-1b").reduced(),
                              dtype="bfloat16", head_dim=256,
                              sliding_window=32, layer_pattern=pattern)
    model = Model(cfg, device="cuda")
    return model, model.init(torch.Generator(device="cuda").manual_seed(0))


def _family_trace(vocab, sampled):
    """Prompts of 20-45 tokens and 8-16 new ones: contexts past the
    32-token window, so every ring wraps."""
    from repro_torch.serving import SamplingParams
    rng = np.random.default_rng(7)
    return [(int(rng.integers(0, 3)),
             rng.integers(0, vocab, int(rng.integers(20, 46)))
             .astype(np.int32), int(rng.integers(8, 17)), 0,
             SamplingParams(temperature=0.8, top_k=50, top_p=0.95,
                            seed=rid) if sampled else None)
            for rid in range(6)]


@pytest.mark.cuda
@pytest.mark.parametrize("pattern", ["SG", ""], ids=["mixed", "sliding"])
@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_cache_family_engines_graphed_match_eager(card, pattern, kv):
    """The sliding and layer-pattern engines on the card at head_dim 256
    (dense rings; the ring pool or the mixed pool): the graphed engine
    emits the eager one's sampled streams bit for bit, and a decode
    replay launches ``gqa_decode`` once a sliding layer (over the ring
    or its gathered view) and ``gqa_decode_paged`` once a paged global
    layer."""
    model, params = _family_model(pattern)
    trace = _family_trace(model.cfg.vocab, sampled=True)
    eager, _ = _serve_trace_run(model, params, trace, kv, False)
    graphed, eng = _serve_trace_run(model, params, trace, kv, True)
    assert graphed == eager
    n_global = sum(w == 0 for w in model.layer_windows)
    want = {"gqa_decode": model.cfg.n_layers - (n_global if kv == "paged"
                                                else 0),
            "gqa_decode_paged": n_global if kv == "paged" else 0,
            _decode_key(model.cfg): model.cfg.n_layers, "fused_mask": 1}
    got = eng.stats()["graphs"]["serve_sample"]["launches"]
    assert {k: got.get(k, 0) for k in want} == want


@pytest.mark.cuda
def test_ring_matches_dense_sliding_on_the_card(card):
    """Ring-paged ≡ dense sliding bit for bit on the card, greedy and
    past the window: both attend through ``gqa_decode`` over the same
    ring-slot-order layout."""
    model, params = _family_model("")
    trace = _family_trace(model.cfg.vocab, sampled=False)
    dense, _ = _serve_trace_run(model, params, trace, "dense", True)
    ring, eng = _serve_trace_run(model, params, trace, "paged", True)
    assert ring == dense
    assert eng.stats()["kv_window"] == 32


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_graphed_engine_replans_like_eager(card, kv):
    """A graphed engine that replans (the chunk moves from 8 to 64, the
    draft length follows the observed acceptance) emits the eager
    engine's streams bit for bit given the same plans; a replan replaces
    no tensor a graph reads, so the decode step is captured once."""
    from repro_torch.serving.speculative import SpecParams
    model, params = _serve_model()
    trace = _serve_trace(7, True, model.cfg.vocab)
    sp = SpecParams(mode="ngram", k=None, min_ngram=1)
    eager, e_eng = _serve_trace_run(model, params, trace, kv, False, sp,
                                    replan_every=4)
    graphed, g_eng = _serve_trace_run(model, params, trace, kv, True, sp,
                                      replan_every=4)
    assert graphed == eager
    assert g_eng.spec_stats == e_eng.spec_stats
    assert g_eng.timer.counts["replan"] == e_eng.timer.counts["replan"] > 0
    assert g_eng.scheduler.cfg.chunk == e_eng.scheduler.cfg.chunk == 64
    assert g_eng.stats()["graphs"]["serve_sample"]["captures"] == 1


@pytest.mark.cuda
def test_graphs_of_an_engine_share_one_pool(card):
    """Verify graphs captured into one pool (widest first) add less
    memory together than the same graphs in private pools: a graph's
    temporaries reuse what an earlier capture freed."""
    from repro_torch.core import pipeline
    from repro_torch.serving.graphs import StepGraph, StepGraphs
    model, params = _serve_model()
    params = model.cast_params(params)
    plan, _ = pipeline.select_kernel_plan({"accelerator": "cuda"})
    caches = model.init_caches(SERVE_SLOTS, SERVE_MAX_LEN)
    n_new = torch.zeros((SERVE_SLOTS,), dtype=torch.int32, device="cuda")

    def body(tokens, n_new):
        return model.verify_step(params, caches, tokens, n_new, plan=plan)[0]

    def inputs(k1):
        return {"tokens": torch.zeros((SERVE_SLOTS, k1), dtype=torch.long,
                                      device="cuda"), "n_new": n_new}
    widths = (5, 4, 3, 2)
    private = []
    for k1 in widths:
        g = StepGraph(body, inputs(k1), k1, idle=("n_new",),
                      stream=torch.cuda.Stream())
        private.append(g.pool_bytes)
        del g
    shared = StepGraphs()
    for k1 in widths:
        shared.run(f"verify/{k1}", body, inputs(k1), k1, idle=("n_new",))
    pooled = [shared.counts[f"verify/{k1}"]["pool_bytes"] for k1 in widths]
    assert shared.captures == len(widths)
    assert sum(pooled) < sum(private), (pooled, private)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_graphed_verify_matches_eager_verify(card, kv):
    """``verify_step`` captured once and replayed on restored caches
    equals an eager verify bit for bit, logits and caches, at every
    replay (the decode kernels' tickets start at zero each time)."""
    from repro_torch.core import pipeline
    from repro_torch.serving.graphs import StepGraph
    model, params = _serve_model()
    params = model.cast_params(params)
    plan, _ = pipeline.select_kernel_plan({"accelerator": "cuda"})
    B, W, bs = SERVE_SLOTS, SERVE_MAX_LEN, SERVE_BLOCK
    rng = np.random.default_rng(0)
    if kv == "paged":
        M = W // bs
        caches = model.init_paged_caches(B, pool_blocks=B * M, block_size=bs,
                                         max_blocks=M)
        caches.kv.block_tables.copy_(torch.arange(
            B * M, dtype=torch.int32, device="cuda").reshape(B, M).expand_as(
                caches.kv.block_tables))
    else:
        caches = model.init_caches(B, W)
    lens = torch.tensor([9, 20, 3, 14], dtype=torch.int32)
    prompt = torch.from_numpy(rng.integers(0, model.cfg.vocab, (B, 20)))
    model.prefill_chunk(params, caches, prompt, torch.zeros_like(lens),
                        lens, plan=plan)
    snapshot = [t.clone() for t in caches.kv]
    tokens = torch.zeros((B, 5), dtype=torch.long, device="cuda")
    n_new = torch.zeros((B,), dtype=torch.int32, device="cuda")

    def body(tokens, n_new):
        return model.verify_step(params, caches, tokens, n_new, plan=plan)[0]
    graph = StepGraph(body, {"tokens": tokens, "n_new": n_new}, "k",
                      idle=("n_new",), stream=torch.cuda.Stream())
    assert graph.graph is not None
    assert graph.launches["gqa_decode" if kv == "dense"
                          else "gqa_decode_paged"] == 5 * model.cfg.n_layers
    for i in range(4):
        tokens.copy_(torch.from_numpy(rng.integers(0, model.cfg.vocab,
                                                   (B, 5))))
        n_new.copy_(torch.tensor([5, 1 + i, 0, 3]))
        for t, s in zip(caches.kv, snapshot):
            t.copy_(s)
        got = graph.replay().clone()
        after = [t.clone() for t in caches.kv]
        for t, s in zip(caches.kv, snapshot):
            t.copy_(s)
        want = model.verify_step(params, caches, tokens, n_new, plan=plan)[0]
        assert torch.equal(got, want), i
        for a, b in zip(after, caches.kv):
            assert torch.equal(a, b), i


@pytest.mark.cuda
def test_graph_replay_never_syncs_and_counts_launches(card):
    """Staging the inputs, replaying the decode graph and starting the
    tokens' copy to pinned memory run with no host synchronization (sync
    debug mode raises on one); N replays add N times the launches the
    capture recorded."""
    from repro_torch.serving import Request, RequestState
    from repro_torch.serving.engine import _POLICY
    model, params = _serve_model()
    trace = _serve_trace(5, True, model.cfg.vocab)
    _, eng = _serve_trace_run(model, params, trace, "paged", True)
    graph = eng.graphs._graphs["serve_sample"]
    n = model.cfg.n_layers
    assert (graph.launches["gqa_decode_paged"], graph.launches["linked_mlp"],
            graph.launches["fused_mask"]) == (n, n, 1)
    eng.submit(Request(rid=99, prompt=np.arange(9, dtype=np.int32),
                       max_new_tokens=30))
    rows = [None] * SERVE_SLOTS
    while not any(rows):
        eng.step()
        rows = [s if s is not None and s.state is RequestState.DECODE
                else None for s in eng.scheduler.active]
    st = eng._static
    live = np.array([r is not None for r in rows])
    host = torch.empty((SERVE_SLOTS,), dtype=torch.int32, pin_memory=True)
    torch.cuda.synchronize()
    kernels.reset_launches()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(3):
            st.put("tokens", eng._last_tokens)
            st.put("live", live)
            for name, a in zip(_POLICY, eng._sampling_arrays(rows)):
                st.put(name, a)
            out = graph.replay()
            host.copy_(out, non_blocking=True)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    for name, count in kernels.LAUNCHES.items():
        assert count == 3 * graph.launches.get(name, 0), name


@pytest.mark.cuda
def test_capture_survives_a_dropped_engine(card):
    """A dropped graphed engine lives on in a reference cycle (its step
    bodies refer back to it) until the cyclic collector frees it, and its
    graphs with it; freed in the middle of another engine's capture, they
    would invalidate that capture.  With the collector at its most eager,
    a second engine still captures and emits the first one's streams."""
    import gc
    model, params = _serve_model()
    trace = _serve_trace(3, False, model.cfg.vocab)
    first, _ = _serve_trace_run(model, params, trace, "dense", True)
    old = gc.get_threshold()
    gc.set_threshold(1, 1, 1)
    try:
        again, eng = _serve_trace_run(model, params, trace, "dense", True)
    finally:
        gc.set_threshold(*old)
    assert again == first
    assert eng.stats()["graphs"]["serve_sample"]["captures"] == 1


@pytest.mark.cuda
def test_failed_capture_raises(card, monkeypatch):
    """A body that fails while it is being captured makes the engine's
    step raise; nothing falls back to eager."""
    from repro_torch.serving import Request
    model, params = _serve_model()
    from repro_torch.serving import ServingEngine
    eng = ServingEngine(model, params, slots=SERVE_SLOTS,
                        max_len=SERVE_MAX_LEN, chunk=SERVE_CHUNK,
                        prefill_mode="chunked", replan_every=10_000)
    real = eng._serve_sample

    def failing(*args):
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("planted capture failure")
        return real(*args)
    eng._serve_sample = failing
    eng.submit(Request(rid=0, prompt=np.arange(5, dtype=np.int32),
                       max_new_tokens=4))
    with pytest.raises(RuntimeError, match="planted capture failure"):
        for _ in range(10):
            eng.step()
    assert eng.graphs.counts == {}


# -- the recurrent cache families' shapes (hymba-1.5b, mamba2-370m) -----------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_at_hymba_shapes(card, dtype):
    """hymba-1.5b's decode: 25 q / 5 kv heads of 64 (G = 5, so one query
    head a CTA: 200 work units at B = 8) over its 1024-slot sliding
    rings: full windows whose span starts mid-row, short, empty and
    prefix rows."""
    K, G, D, W = 5, 5, 64, 1024
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = t_da.decode_grid(8, K, G, W, sms, D, getattr(torch, dtype))
    assert plan.gt == (1 if dtype == "float32" else 5)
    pos = torch.arange(W, device="cuda")[None, :]
    start = torch.tensor([137, 0, W - 3, 300, 1, 0, 64, 1023],
                         device="cuda")[:, None]
    n = torch.tensor([1024, 1024, 3, 200, 1, 0, 1000, 1024],
                     device="cuda")[:, None]
    _check_dense(card, dtype, ((pos - start) % W) < n, K, G, D)
    _check_dense(card, dtype, _prefix([W, 600, 0, 1, W - 1, 17, 513, 256],
                                      W), K, G, D)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [8, 256, 4352])
def test_linked_mlp_tc_at_hymba_width(card, M):
    """hymba-1.5b's MLP, d 1600 and ff 5504: a cluster of 13 ranks of 128
    columns whose last rank owns 64, half its columns (the swap body at
    decode: warpgroup 2's 64-column tile idle there; the prefill body:
    half of a warpgroup's 128); decode, a 32-token chunk of 8 slots and
    batched prefill's rows (held as in the tile-edge test)."""
    x, wg, wu, wd = _mlp(card, M, 1600, 5504, torch.bfloat16)
    plan = _plan(x, wg, wu, wd)
    assert plan.body == ("swap" if M == 8 else "prefill")
    ds = t_lm.TP_DS if plan.body == "prefill" else t_lm.swap_ds(1600,
                                                                plan.cl)
    assert plan.path == "tc" and plan.cl == 13 and ds == 128
    assert 1600 - (plan.cl - 1) * ds == 64
    kernels.reset_launches()
    got = t_lm.linked_mlp(x, wg, wu, wd)
    again = t_lm.linked_mlp(x, wg, wu, wd)
    torch.cuda.synchronize()
    assert _launches() == _body_launches(plan, 2)
    assert torch.equal(got, again)
    _hold_bf16(got, x, wg, wu, wd)
    if M > 1024:
        ref = _mlp_fp64(x, wg, wu, wd)
        plain = t_lm.linked_mlp_plain(x, wg, wu, wd)
        assert _mlp_err(got, ref) <= MLP_ORDER_FACTOR * _mlp_err(plain, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("V,stride", [(32001, 32256), (50280, 50432)])
def test_fused_mask_at_the_recurrent_vocabularies(card, V, stride):
    """hymba's vocabulary (32,001: odd, in its 32,256-wide padded row)
    and mamba2's (50,280 in 50,432), on the heterogeneous policies and
    on tied logits."""
    temps, ks, ps = _mask_policies(8, V)
    for tied in (False, True):
        _check_mask(_mask_rows(V, 8, V, stride, tied), temps, ks, ps)


def _recurrent_model(arch):
    """A reduced recurrent config in bf16 on the card."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    model = Model(cfg, device="cuda")
    return model, model.init(torch.Generator(device="cuda").manual_seed(0))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hymba-1.5b", "mamba2-370m"])
@pytest.mark.parametrize("sampled", [False, True])
def test_recurrent_engines_graphed_match_eager(card, arch, sampled):
    """The hybrid and SSM engines on the card: the graphed engine emits
    the eager one's streams bit for bit (admissions, priorities and
    preemption, SSM state carried through the captured decode step), and
    a decode replay launches ``gqa_decode`` and the decode body of
    ``linked_mlp`` (the swap body, ``linked_mlp_tc_swap``) once a hybrid
    layer, none for mamba2, and ``fused_mask`` once."""
    model, params = _recurrent_model(arch)
    trace = _serve_trace(11 + sampled, sampled, model.cfg.vocab)
    eager, _ = _serve_trace_run(model, params, trace, "dense", False)
    graphed, eng = _serve_trace_run(model, params, trace, "dense", True)
    assert graphed == eager
    n = model.cfg.n_layers if model.cfg.family == "hybrid" else 0
    want = {"gqa_decode": n, "gqa_decode_paged": 0,
            "linked_mlp_tc_swap" if n == 0 else _decode_key(model.cfg): n,
            "fused_mask": 1}
    got = eng.stats()["graphs"]["serve_sample"]["launches"]
    assert {k: got.get(k, 0) for k in want} == want


@pytest.mark.cuda
def test_capture_warmup_leaves_ssm_state(card):
    """A capture's warm-up runs the decode step with a zero live mask and
    the capture itself runs nothing: every KV, SSM state and register
    bit stays as it was; the first replay then advances the live rows
    only."""
    from repro_torch.serving import Request, ServingEngine
    from repro_torch.serving.graphs import StepGraph
    model, params = _recurrent_model("hymba-1.5b")
    eng = ServingEngine(model, params, slots=4, max_len=64, chunk=16,
                        prefill_mode="chunked", graphed=False)
    rng = np.random.default_rng(5)
    for rid in range(3):
        eng.submit(Request(rid=rid, prompt=rng.integers(
            0, model.cfg.vocab, 20).astype(np.int32), max_new_tokens=8))
    for _ in range(3):
        eng.step()
    live = torch.tensor([True, True, True, False], device="cuda")
    inputs = {"tokens": torch.ones((4, 1), dtype=torch.long, device="cuda"),
              "live": live}

    def leaves(tree):
        if isinstance(tree, torch.Tensor):
            return [tree]
        return [t for v in tree for t in leaves(v)]
    before = [t.clone() for t in leaves(eng.caches)]
    graph = StepGraph(
        lambda **ins: eng._serve(eng.params, eng.caches, *ins.values())[0],
        inputs, None, ("live",), torch.cuda.Stream(), None)
    torch.cuda.synchronize()
    assert graph.graph is not None
    assert all(torch.equal(a, b) for a, b in zip(before, leaves(eng.caches)))
    graph.replay()
    torch.cuda.synchronize()
    state = eng.caches.ssm.state
    assert not torch.equal(state[:, :3], before[-2][:, :3])
    assert torch.equal(state[:, 3], before[-2][:, 3])


# -- replica routing and concat tensor parallelism ---------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("K", [4, 2])
def test_decode_kernels_at_a_ranks_heads(card, dtype, K):
    """qwen3-1.7b's 16 q / 8 kv heads of 128 over 2 ranks (8 / 4) and 4
    ranks (4 / 2): both decode kernels against their plain versions over
    2048 slots (prefix rows, an empty one, a full one)."""
    lengths = [600, 512, 0, 2048, 1, 530, 777, 1500]
    _check_dense(card, dtype, _prefix(lengths, 2048), K, 2, 128)
    _check_paged(card, dtype, lengths, 2048 // 16, 16, K, 2, 128)


def _routed_requests(vocab, n=8):
    """Two groups sharing a two-block prefix (tails shorter than a block:
    the router's affinity key is the group's), odd ids sampled."""
    from repro_torch.serving import Request, SamplingParams
    rng = np.random.default_rng(7)
    prefixes = [rng.integers(0, vocab, 2 * SERVE_BLOCK) for _ in range(2)]
    return [Request(rid=rid, max_new_tokens=6 + rid % 5,
                    prompt=np.concatenate([
                        prefixes[rid % 2],
                        rng.integers(0, vocab, 1 + rid % (SERVE_BLOCK - 1))])
                    .astype(np.int32),
                    sampling=SamplingParams(temperature=0.9, top_k=50,
                                            seed=rid) if rid % 2 else None)
            for rid in range(n)]


def _paged_engine(model, params, graphed=True, mesh=None):
    from repro_torch.serving import ServingEngine
    return ServingEngine(model, params, slots=SERVE_SLOTS,
                         max_len=SERVE_MAX_LEN, chunk=SERVE_CHUNK,
                         prefill_mode="chunked", replan_every=10_000,
                         kv="paged", kv_block_size=SERVE_BLOCK,
                         graphed=graphed, mesh=mesh)


@pytest.mark.cuda
@pytest.mark.parametrize("fail_at", [None, 4], ids=["steady", "failover"])
def test_router_over_graphed_replicas_matches_solo(card, fail_at):
    """Two graphed paged replicas behind a ReplicaRouter emit a solo
    graphed engine's streams bit for bit, steady (prefix affinity puts
    each group on one replica, both replicas busy) and with replica 1
    failed part-way (its requests requeued and replayed)."""
    from repro_torch.serving import ReplicaRouter
    model, params = _serve_model()
    solo = _paged_engine(model, params)
    reqs = _routed_requests(model.cfg.vocab)
    for r in reqs:
        solo.submit(r)
    solo.run()
    want = [list(r.generated) for r in reqs]
    router = ReplicaRouter([_paged_engine(model, params) for _ in range(2)])
    reqs = _routed_requests(model.cfg.vocab)
    for r in reqs:
        router.submit(r)
    router._dispatch()
    assert {pl.replica for pl in router.placements.values()} == {0, 1}
    steps = 0
    while router.pending():
        if steps == fail_at:
            assert router.fail_replica(1) >= 1
        router.step()
        steps += 1
    assert [list(r.generated) for r in reqs] == want
    assert router.affinity_hits > 0
    for i, eng in enumerate(router.engines):
        if router.alive[i]:
            assert eng.stats()["graphs"]["serve_sample"]["replays"] > 0


def _tp_rank(mesh, kv):
    """One rank of a 2-rank mesh on one card: the reduced bf16 model from
    seed 0, sliced by the engine, serving ``_routed_requests`` eagerly.
    Returns the streams, the launches, the decode steps and sampler
    dispatches, the cache bytes and the kernel plan."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              dtype="bfloat16")
    model = Model(cfg, device=mesh.device)
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    eng = _tp_engine(model, params, kv, mesh)
    kernels.reset_launches()
    reqs = _routed_requests(cfg.vocab)
    for r in reqs:
        eng.submit(r)
    eng.run()
    torch.cuda.synchronize()
    st = eng.stats()
    return ([list(r.generated) for r in reqs], dict(kernels.LAUNCHES),
            st["steps"][1]["calls"], st["sampler_calls"],
            sum(eng.cache_bytes().values()), st["kernel_plan"],
            eng.caches.kv.k.shape[3])


def _tp_engine(model, params, kv, mesh=None, kernel_plan=None):
    from repro_torch.serving import ServingEngine
    return ServingEngine(model, params, slots=SERVE_SLOTS,
                         max_len=SERVE_MAX_LEN, chunk=SERVE_CHUNK,
                         prefill_mode="chunked", replan_every=10_000, kv=kv,
                         kv_block_size=SERVE_BLOCK if kv == "paged" else None,
                         graphed=False, mesh=mesh, kernel_plan=kernel_plan)


def _margin(model, params, req, step, other):
    """How far the one-device plain plan's logits before emitting
    ``req.generated[step]`` must shift for the decision to emit
    ``other`` instead, and its bf16 tolerance:
    ``chip_smoke.decision_margin``."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent
        / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    caches = model.init_caches(1, SERVE_MAX_LEN)
    prompt = req.prompt
    for start in range(0, len(prompt), SERVE_CHUNK):
        n = min(SERVE_CHUNK, len(prompt) - start)
        toks = torch.zeros((1, SERVE_CHUNK), dtype=torch.long)
        toks[0, :n] = torch.as_tensor(prompt[start:start + n])
        logits, caches = model.prefill_chunk(
            params, caches, toks, torch.tensor([start], dtype=torch.int32),
            torch.tensor([n], dtype=torch.int32))
    for t in req.generated[:step]:
        logits, caches = model.serve_step(
            params, caches, torch.tensor([[t]], device="cuda"))
    return chip_smoke.decision_margin(torch, logits[0, :model.cfg.vocab],
                                      req.sampling, step, other)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_tp_engine_on_one_card_within_the_margin_rule(card, kv, tmp_path):
    """Two concat-TP ranks on one card (gloo, eager) against the one-device
    eager engine under the same kernel plan: streams equal, or parting
    only where a shift of the one-device logits under the bf16
    tolerance turns their decision into the ranks' token; both ranks
    agree, each holds half the KV bytes at K / 2
    kv heads, launches its decode kernel n_layers times a decode step,
    fused_mask once a sampler dispatch and no linked_mlp."""
    from repro_torch.core.pipeline import KernelPlan
    from repro_torch.launch.mesh import spawn_ranks
    model, params = _serve_model()
    torch.cuda.synchronize()
    ranks = spawn_ranks(_tp_rank, 2, args=(kv,), devices=["cuda:0"] * 2,
                        timeout_s=300.0, store_dir=tmp_path)
    streams, launches, steps, samples, nbytes, plan, k_loc = ranks[0]
    assert ranks[1][0] == streams
    assert plan["linked_matmul"] == "torch" and plan["decode_dense"] == "cuda"
    one = _tp_engine(model, params, kv, kernel_plan=KernelPlan(**plan))
    reqs = _routed_requests(model.cfg.vocab)
    for r in reqs:
        one.submit(r)
    one.run()
    for r, got in zip(reqs, streams):
        if list(r.generated) != got:
            t = next(i for i, (a, b) in enumerate(zip(r.generated, got))
                     if a != b)
            margin, tol = _margin(model, model.cast_params(params), r, t,
                                  got[t])
            assert margin <= tol, (r.rid, t, margin, tol)
    assert 2 * nbytes == sum(one.cache_bytes().values())
    assert k_loc == model.cfg.n_kv_heads // 2
    attn = "gqa_decode" if kv == "dense" else "gqa_decode_paged"
    for _, ln, st, sc, *_ in ranks:
        assert ln[attn] == model.cfg.n_layers * st > 0
        assert ln["fused_mask"] == sc > 0
        assert ln["linked_mlp"] == 0 and ln["linked_mlp_tc"] == 0
        assert ln["linked_mlp_tc_swap"] == 0


# -- MoE and encoder-decoder ---------------------------------------------------

def _moe_model(arch):
    """Reduced ``arch`` (olmoe-1b-7b: 4 experts top 2; arctic-480b: the
    same with its dense SwiGLU residual) in bf16 on the card."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16")
    model = Model(cfg, device="cuda")
    return model, model.init(torch.Generator(device="cuda").manual_seed(0))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "arctic-480b"])
@pytest.mark.parametrize("kv", ["dense", "paged"])
@pytest.mark.parametrize("spec", [None, "ngram"])
def test_moe_engine_graphed_matches_eager(card, arch, kv, spec):
    """The MoE decode and verify steps captured as CUDA graphs emit the
    eager engine's streams bit for bit (sampled, with preemption and
    speculation); a decode replay launches the decode kernel once a
    layer, ``fused_mask`` once, and ``linked_mlp``'s decode body (the
    swap body) once a layer for arctic's dense residual only (the experts
    have no kernel site)."""
    from repro_torch.serving.speculative import SpecParams
    model, params = _moe_model(arch)
    trace = _serve_trace(11, True, model.cfg.vocab)
    sp = SpecParams(mode="ngram", k=4, min_ngram=1) if spec else None
    eager, e_eng = _serve_trace_run(model, params, trace, kv, False, sp)
    graphed, g_eng = _serve_trace_run(model, params, trace, kv, True, sp)
    assert graphed == eager
    assert g_eng.spec_stats == e_eng.spec_stats
    n = model.cfg.n_layers
    attn = "gqa_decode" if kv == "dense" else "gqa_decode_paged"
    got = g_eng.stats()["graphs"]["serve_sample"]["launches"]
    mlp = n if model.cfg.moe_dense_residual else 0
    key = _decode_key(model.cfg) if mlp else "linked_mlp_tc_swap"
    assert (got.get(attn, 0), got.get("fused_mask", 0),
            got.get(key, 0), got.get("linked_mlp", 0)) == (n, 1, mlp, mlp)


@pytest.mark.cuda
def test_moe_decode_step_never_syncs(card):
    """The MoE decode step (routing, the stable top-k, every expert on the
    rows, the gathered combine) runs with no host synchronization (sync
    debug mode raises on one): what a CUDA graph captures."""
    model, params = _moe_model("olmoe-1b-7b")
    params = model.cast_params(params)
    caches = model.init_caches(SERVE_SLOTS, SERVE_MAX_LEN)
    toks = torch.randint(0, model.cfg.vocab, (SERVE_SLOTS, 1), device="cuda",
                         generator=card)
    live = torch.ones((SERVE_SLOTS,), dtype=torch.bool, device="cuda")
    model.serve_step(params, caches, toks, live=live)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for _ in range(2):
            logits, caches = model.serve_step(params, caches, toks, live=live)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(logits.float()).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_kernel_over_a_cross_span(card, dtype):
    """Cross-attention's decode: seamless's 16 q / 16 kv heads of 64 (G =
    1) over a 512-frame encoder span, every slot valid (the live-span
    split over the whole row), and over short and odd spans."""
    dt = getattr(torch, dtype)
    for W in (512, 24, 509):
        q = _rnd(card, dt, 8, 16, 64)
        k, v = _rnd(card, dt, 8, W, 16, 64), _rnd(card, dt, 8, W, 16, 64)
        valid = torch.ones((8, W), dtype=torch.bool, device="cuda")
        got = t_da.gqa_decode(q, k, v, valid)
        want = t_da.gqa_decode_plain(q, k, v, valid)
        err = (got.float() - want.float()).abs()
        tol = TOL[dtype]
        assert (err <= tol["atol"] + tol["rtol"] * want.float().abs()).all()


def _tp_probe(mesh, max_len, heads=(16, 8)):
    """Teacher-forced logits of a 2-rank mesh's rank (or one device,
    ``mesh`` None) on a wide reduced qwen3 (``heads``: 16 q / 8 kv heads
    of 64, or chatglm3-6b's 32 q / 2 kv) in bf16: a 16-token prefill
    chunk of 4 rows, then 3 greedy decode steps, through the cuda decode
    kernel over a ``max_len``-slot cache."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.core.pipeline import KernelPlan
    from repro_torch.distributed import tp
    from repro_torch.models.model import Model
    cfg = dataclasses.replace(get_config("qwen3-1.7b").reduced(),
                              dtype="bfloat16", n_heads=heads[0],
                              n_kv_heads=heads[1], head_dim=64)
    device = mesh.device if mesh is not None else torch.device("cuda")
    model = Model(cfg, kernel_plan=KernelPlan(decode_dense="cuda"),
                  device=device)
    params = model.cast_params(model.init(
        torch.Generator(device=device).manual_seed(0)))
    shards = 1 if mesh is None else mesh.shards
    if mesh is not None:
        params = tp.shard_params(params, shards, mesh.rank,
                                 tp.serving_param_specs(model.param_specs()))
    caches = model.init_caches(4, max_len, shards=shards)
    toks = torch.from_numpy(np.random.default_rng(2).integers(
        0, cfg.vocab, (4, 16)))
    logits, caches = model.prefill_chunk(
        params, caches, toks, torch.zeros(4, dtype=torch.int32),
        torch.full((4,), 16, dtype=torch.int32), shard_axis=mesh)
    out = [logits]
    for _ in range(3):
        tok = torch.argmax(out[-1][:, :cfg.vocab], dim=-1)[:, None]
        logits, caches = model.serve_step(params, caches, tok,
                                          shard_axis=mesh)
        out.append(logits)
    # numpy: a spawned rank's torch tensors reach the parent through a
    # file descriptor that its exit closes
    return [t.float().cpu().numpy() for t in out]


@pytest.mark.cuda
def test_tp_engine_decode_logits_equal_one_device(card, tmp_path):
    """A rank's decode kernels take one device's plan (8 splits a row
    where its 4 kv heads would take 16, at 4 rows over 2048 slots on a
    132-SM card), so rank 0's decode logits equal one device's bit for
    bit, as its prefill logits do."""
    from repro_torch.launch.mesh import spawn_ranks
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert t_da.rank_plan(4, 4, 2, 2048, sms, 64, 2) == \
        t_da.decode_grid(4, 8, 2, 2048, sms, 64)
    ranks = spawn_ranks(_tp_probe, 2, args=(2048,), devices=["cuda:0"] * 2,
                        timeout_s=300.0, store_dir=tmp_path)
    one = _tp_probe(None, 2048)
    for step, (a, b) in enumerate(zip(ranks[0], one)):
        assert np.array_equal(a, b), (step, np.abs(a - b).max())
    assert all(np.array_equal(a, b) for a, b in zip(ranks[1], ranks[0]))


@pytest.mark.cuda
def test_tp_engine_decode_logits_equal_one_device_at_g16(card, tmp_path):
    """chatglm3-6b's 32 q / 2 kv heads over 2 ranks (a rank's one kv head,
    G 16): both take the group body at one device's split count (12 a
    row, one merge, at 4 rows on a 132-SM card, where the rank's own
    would take 66 in two merge levels), so rank 0's decode logits equal
    one device's bit for bit."""
    from repro_torch.launch.mesh import spawn_ranks
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    one = t_da.decode_grid(4, 2, 16, 2048, sms, 64)
    assert one.body == "group" and t_da.rank_plan(
        4, 1, 16, 2048, sms, 64, 2) == one
    ranks = spawn_ranks(_tp_probe, 2, args=(2048, (32, 2)),
                        devices=["cuda:0"] * 2, timeout_s=300.0,
                        store_dir=tmp_path)
    one = _tp_probe(None, 2048, (32, 2))
    for step, (a, b) in enumerate(zip(ranks[0], one)):
        assert np.array_equal(a, b), (step, np.abs(a - b).max())
    assert all(np.array_equal(a, b) for a, b in zip(ranks[1], ranks[0]))


# -- training ------------------------------------------------------------------

def _train_states(cfg, plan):
    """One state (drawn on the host, attention at one layer's fan-in) on
    the host and on the card, with their models (the card's under
    ``plan``)."""
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import Model, TrainState
    from repro_torch.optim import adamw_init
    host = Model(cfg, device="cpu")
    dev = Model(cfg, device="cuda", kernel_plan=plan)
    raw = host.init(torch.Generator().manual_seed(0))
    L = cfg.n_layers
    attn = raw["layers"].get("attn")
    if attn is not None:
        for k in ("wq", "wk", "wv"):
            attn[k].mul_((L / cfg.d_model) ** 0.5)
        attn["wo"].mul_((L / (cfg.n_heads * cfg.resolved_head_dim)) ** 0.5)
    out = []
    for m in (host, dev):
        p = tree_map(lambda t, d=m.device: t.clone().to(d)
                     .requires_grad_(True), raw)
        out.append((m, TrainState(p, adamw_init(p, m.opt_cfg), torch.zeros(
            (), dtype=torch.int32, device=m.device))))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen3-1.7b", "olmoe-1b-7b"])
def test_train_step_on_the_card_matches_the_host(card, arch):
    """Three reduced ``train_step``s on the card (TF32 off, under the
    ``cuda`` kernel plan) ≡ on the host: losses at rtol 1e-4, params
    within half the summed lr everywhere and 1e-3 of it (plus rtol 1e-5)
    in all but 0.1% of elements, as ``tests/test_torch_train.py`` holds
    the port to the reference; no kernel launched."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.pipeline import select_kernel_plan
    from repro_torch.models.layers import tree_leaves
    from repro_torch.optim import cosine_schedule
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        cfg = get_config(arch).reduced()
        plan, _ = select_kernel_plan({"accelerator": "cuda"})
        assert plan.linked_matmul == "cuda"
        (hm, hs), (dm, ds) = _train_states(cfg, plan)
        sched = lambda s: cosine_schedule(s, peak_lr=1e-3, warmup_steps=1,
                                          total_steps=10)
        rng = np.random.default_rng(0)
        before = dict(kernels.LAUNCHES)
        lr_sum = 0.0
        for i in range(3):
            toks = rng.integers(0, cfg.vocab, (4, 17)).astype(np.int32)
            batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
            hs, hmet = hm.train_step(hs, batch, lr_schedule=sched)
            ds, dmet = dm.train_step(ds, batch, lr_schedule=sched)
            lr_sum += float(sched(i))
            assert float(dmet["loss"]) == pytest.approx(
                float(hmet["loss"]), rel=1e-4)
        torch.cuda.synchronize()
        assert kernels.LAUNCHES == before
        off = total = 0
        for a, b in zip(tree_leaves(hs.params), tree_leaves(ds.params)):
            err = (a.detach() - b.detach().cpu()).abs() - 1e-5 * a.abs()
            assert err.max().item() <= 0.5 * lr_sum
            off += int((err > 1e-3 * lr_sum).sum())
            total += err.numel()
        assert off <= 1e-3 * total, (off, total)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


@pytest.mark.cuda
def test_train_step_launches_no_kernel_under_the_cuda_plan(card):
    """The training forward reaches no kernel site the reference's does
    not: under ``select_kernel_plan``'s ``cuda`` plan a reduced qwen3
    ``train_step`` (its MLP a ``linked_matmul`` site) launches nothing,
    and the same plan's serving forward without grad does launch
    ``linked_mlp``."""
    from repro_torch.configs.base import get_config
    from repro_torch.core.pipeline import select_kernel_plan
    cfg = get_config("qwen3-1.7b").reduced()
    plan, _ = select_kernel_plan({"accelerator": "cuda"})
    (_, _), (dm, ds) = _train_states(cfg, plan)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 9))
    batch = {"tokens": toks[:, :-1].astype(np.int32),
             "labels": toks[:, 1:].astype(np.int32)}
    kernels.reset_launches()
    for _ in range(2):
        ds, met = dm.train_step(ds, batch)
    torch.cuda.synchronize()
    assert all(n == 0 for n in kernels.LAUNCHES.values()), kernels.LAUNCHES
    assert np.isfinite(float(met["loss"]))
    with torch.no_grad():
        dm.forward(dm.cast_params(ds.params),
                   {"tokens": torch.from_numpy(batch["tokens"])})
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["linked_mlp"] == cfg.n_layers


@pytest.mark.cuda
def test_wrapper_refuses_a_cuda_input_that_requires_grad(card):
    """A kernel's output has no ``grad_fn``: ``linked_mlp`` on CUDA
    inputs that require grad raises under grad mode (nothing launches)
    and runs under ``no_grad``."""
    x = _rnd(card, torch.bfloat16, 8, 256).requires_grad_(True)
    w = [_rnd(card, torch.bfloat16, *s) for s in ((256, 512), (256, 512),
                                                   (512, 256))]
    kernels.reset_launches()
    with pytest.raises(ValueError, match="linked_mlp: an input requires"):
        t_lm.linked_mlp(x, *w)
    assert kernels.LAUNCHES["linked_mlp"] == 0
    with torch.no_grad():
        out = t_lm.linked_mlp(x, *w)
    assert out.shape == x.shape and kernels.LAUNCHES["linked_mlp"] == 1


# -- measured kernel-site routing and the collectives ------------------------------

@pytest.mark.cuda
def test_bench_kernel_sites_times_every_candidate(card):
    """On the card the bench times all eight candidates, each as a CUDA
    graph: each kernel launched by the capture's warm-up and once a
    replay (3 warm-ups and ``iters``), in fp32 and bf16."""
    import math

    from repro_torch.launch.autotune import bench_kernel_sites
    for dtype in ("float32", "bfloat16"):
        kernels.reset_launches()
        t = bench_kernel_sites(iters=4, dtype=dtype)
        assert set(t) == {"decode_dense:torch", "decode_dense:cuda",
                          "decode_paged:gather", "decode_paged:fold",
                          "decode_paged:cuda", "sampler:reference",
                          "sampler:fused", "sampler:cuda"}
        assert all(math.isfinite(v) and v > 0 for v in t.values())
        for name in ("gqa_decode", "gqa_decode_paged", "fused_mask"):
            assert kernels.LAUNCHES[name] == 8, (dtype, name)


@pytest.mark.cuda
@pytest.mark.parametrize("kv", ["dense", "paged"])
def test_engine_with_timings_serves_the_explicit_plans_streams(card, kv):
    """Timings that keep the paged site and the sampler off their kernels
    route the graphed engine so (its plan is ``select_kernel_plan``'s),
    and it serves an engine's streams given that plan explicitly;
    ``kernel_plan="off"`` launches no kernel."""
    from repro_torch.core.pipeline import KernelPlan
    model, params = _serve_model()
    trace = _serve_trace(5, True, model.cfg.vocab)
    t = {"decode_paged:fold": 1e-6, "decode_paged:cuda": 1e-3,
         "sampler:fused": 1e-6, "sampler:cuda": 1e-3,
         "decode_dense:cuda": 1e-6, "decode_dense:torch": 1e-3}
    kernels.reset_launches()
    timed, eng = _serve_trace_run(model, params, trace, kv, True,
                                  kernel_timings=t)
    plan = eng.kernel_plan
    assert (plan.decode_paged, plan.sampler, plan.decode_dense) == \
        ("fold", "fused", "cuda")
    assert plan.linked_matmul == "cuda"
    assert kernels.LAUNCHES["fused_mask"] == 0
    assert kernels.LAUNCHES["gqa_decode_paged"] == 0
    assert (kernels.LAUNCHES["gqa_decode"] > 0) == (kv == "dense")
    explicit, _ = _serve_trace_run(model, params, trace, kv, True,
                                   kernel_plan=plan)
    assert timed == explicit
    kernels.reset_launches()
    _, off = _serve_trace_run(model, params, trace, kv, True,
                              kernel_plan="off")
    assert off.kernel_plan == KernelPlan()
    assert not any(kernels.LAUNCHES.values())


def _collectives_rank(mesh, n):
    """Rank ``mesh.rank``'s normal(0, 1) row of ``n`` fp32 on the card
    (seed = rank) through both schedules and ``dist.all_reduce``."""
    import torch.distributed as dist

    from repro_torch.distributed import ps_sync, ring_allreduce
    x = torch.randn(n, device=mesh.device, generator=torch.Generator(
        device=mesh.device).manual_seed(mesh.rank))
    ring, ps = ring_allreduce(x), ps_sync(x)
    summed = x.clone()
    dist.all_reduce(summed)
    return {"x": x.cpu().numpy(), "ring": ring.cpu().numpy(),
            "ps": ps.cpu().numpy(), "all_reduce": summed.cpu().numpy(),
            "on_card": ring.is_cuda and ps.is_cuda}


@pytest.mark.cuda
def test_collectives_equal_all_reduce_on_card_ranks(card, tmp_path):
    """Two gloo ranks on one card, CUDA inputs (1001 elements: the ring
    pads): both schedules return CUDA tensors equal to x0 + x1 bit for
    bit (one add, in either order) and to ``dist.all_reduce``."""
    from repro_torch.launch.mesh import spawn_ranks
    ranks = spawn_ranks(_collectives_rank, 2, args=(1001,),
                        devices=["cuda:0"] * 2, timeout_s=180.0,
                        store_dir=tmp_path)
    want = ranks[0]["x"] + ranks[1]["x"]
    for r in ranks:
        assert r["on_card"]
        for kind in ("ring", "ps"):
            assert r[kind].tobytes() == want.tobytes(), kind
            np.testing.assert_allclose(r[kind], r["all_reduce"], rtol=1e-6,
                                       atol=1e-6)


def _mesh_cases(rng) -> dict:
    """Reduced qwen3's host init and three global batches of 4 x 16 (a
    ``test_torch_ranks.mesh_train_run`` case), and a vocabulary-parallel
    case (``test_torch_ranks.vocab_parallel_run``)."""
    import dataclasses

    from repro_torch.configs.base import get_config
    from repro_torch.models.layers import tree_map
    from repro_torch.models.model import Model

    cfg = get_config("qwen3-1.7b").reduced()
    params = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    batches = []
    for _ in range(3):
        toks = rng.integers(0, cfg.vocab, (4, 17))
        batches.append({"tokens": toks[:, :-1].astype(np.int32),
                        "labels": toks[:, 1:].astype(np.int32)})
    labels = rng.integers(0, 13, (4, 5))
    labels[1, 2] = -1
    return {
        "train": {"kind": "train", "cfg": dataclasses.asdict(cfg),
                  "params": tree_map(lambda t: t.numpy(), params),
                  "batches": batches, "batch_axes": ("data",),
                  "sched": dict(peak_lr=1e-3, warmup_steps=1,
                                total_steps=10)},
        "vocab": {"kind": "vocab", "vocab": 13,
                  "table": rng.normal(size=(16, 6)).astype(np.float32),
                  "ids": rng.integers(0, 13, (4, 5)),
                  "emb_weight": rng.normal(size=(4, 5, 6)).astype(
                      np.float32),
                  "logits": rng.normal(size=(4, 5, 16)).astype(np.float32),
                  "labels": labels}}


@pytest.mark.cuda
@pytest.mark.parametrize("sizes", [(2, 1), (1, 2)])
def test_mesh_train_step_on_card_ranks(card, tmp_path, sizes):
    """Two gloo ranks on one card over a (data, model) mesh of ``sizes``
    (DTensor's all-gathers routed through c10d's
    ``all_gather_into_tensor``: torch 2.11's functional one kills a gloo
    rank holding CUDA tensors): reduced qwen3's three train steps over
    DTensor equal the one-device card step (losses and grad norms at
    rtol 1e-5, the same bits on both ranks), and the
    vocabulary-parallel lookup and loss equal the one-device forms."""
    import test_torch_ranks as R
    from repro_torch.configs.base import ModelConfig
    from repro_torch.convert import params_from_numpy
    from repro_torch.distributed.sharding import MeshShape
    from repro_torch.launch.mesh import spawn_ranks
    from repro_torch.models.layers import cross_entropy, embed_lookup
    from repro_torch.models.model import Model
    from repro_torch.optim import cosine_schedule

    cases = _mesh_cases(np.random.default_rng(0))
    ranks = spawn_ranks(R.train_mesh_rank, 2, args=(cases,),
                        devices=["cuda:0"] * 2, timeout_s=300.0,
                        store_dir=tmp_path, train_shape=MeshShape(
                            {"data": sizes[0], "model": sizes[1]}))
    case = cases["train"]
    model = Model(ModelConfig(**case["cfg"]), device="cuda")
    state = model.init_train_state(None, params=params_from_numpy(
        case["params"], "cuda"))
    losses, gnorms = [], []
    for b in case["batches"]:
        state, met = model.train_step(
            state, b, lr_schedule=lambda s: cosine_schedule(s, **case[
                "sched"]))
        losses.append(float(met["loss"]))
        gnorms.append(float(met["grad_norm"]))
    got = [r["train"] for r in ranks]
    for key in ("loss", "grad_norm"):
        assert got[0][key].tobytes() == got[1][key].tobytes(), key
    np.testing.assert_allclose(got[0]["loss"], losses, rtol=1e-5)
    np.testing.assert_allclose(got[0]["grad_norm"], gnorms, rtol=1e-5)
    v = cases["vocab"]
    table = torch.tensor(v["table"], requires_grad=True)
    logits = torch.tensor(v["logits"], requires_grad=True)
    emb = embed_lookup(table, torch.as_tensor(v["ids"]), torch.float32)
    ce = cross_entropy(logits, torch.as_tensor(v["labels"]), v["vocab"])
    (emb * torch.as_tensor(v["emb_weight"])).sum().backward()
    ce.backward()
    for r in ranks:
        np.testing.assert_array_equal(r["vocab"]["emb"], emb.detach().numpy())
        np.testing.assert_allclose(r["vocab"]["ce"], ce.detach().numpy(),
                                   rtol=1e-6)
        np.testing.assert_allclose(r["vocab"]["table_grad"],
                                   table.grad.numpy(), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(r["vocab"]["logits_grad"],
                                   logits.grad.numpy(), rtol=1e-5, atol=1e-8)
