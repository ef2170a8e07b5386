"""How the decode-attention kernel cuts and merges its work, checked on the
CPU.

The kernel (``src/repro_torch/csrc/decode_attention.cu``) runs only on
the card; what decides its grid, its pieces and its merge order is plain
arithmetic that the wrapper and the kernel share:

* ``decode_grid`` picks the plan (body, query heads per CTA, splits per
  row) from the shapes, the type and the SM count alone;
* ``split_range`` mirrors the kernel's partition of a row's live span
  (the formula in the ``.cu`` header);
* ``merge_cap`` / ``merge_groups`` mirror its two merge levels: the
  pieces of a row in groups of consecutive splits, each group merged in
  split order, then the groups in group order.

A mirror of that merge order, in fp32, is held against the plain version
and the reference's Pallas kernels (interpret mode) at one long row.  The
card tests in ``tests/test_torch_cuda.py`` hold the kernel itself to the
plain version on and around these pieces' boundaries.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.kernels.decode_attention import ops as da_ops
from repro_torch.kernels.decode_attention import ops as t_da

#: the serving path's shape: slots 8, qwen3-1.7b's 8 kv heads of 128, G = 2
MAIN = dict(B=8, K=8, G=2, W=2048, D=128)
#: gemma3-1b's: slots 8, one kv head of 256, G = 4; a global layer's
#: 2048-slot horizon and a sliding layer's 512-slot ring
GEMMA3 = [dict(B=8, K=1, G=4, W=2048, D=256), dict(B=8, K=1, G=4, W=512,
                                                   D=256)]
#: the kernels' element-wise tolerance in fp32 (chip_smoke.py's TOL)
TOL = dict(rtol=3e-5, atol=3e-5)


def _rule(B, K, G, W, sms, D, dtype):
    """The plan rule restated: (body, GT, CTAs an SM, the split limit)."""
    heads_gt = 2 - G % 2
    heads_units = B * K * (G // heads_gt)
    heads_cap = t_da.merge_cap("heads", D, heads_gt)
    if dtype == torch.float32:
        return "heads", heads_gt, t_da.CTAS_PER_SM, heads_cap
    if t_da.GROUP_MIN_G <= G <= t_da.GROUP_MAX_G and (
            D <= 128 or heads_units * heads_cap < sms):
        body, gt, per_sm = "group", G, t_da.CTAS_PER_SM
    else:
        body, gt, per_sm = "heads", heads_gt, 1
    cap = t_da.merge_cap(body, D, gt)
    units = B * K * (G // gt)
    return body, gt, per_sm, cap if 2 * units * cap >= sms else cap * cap


@pytest.mark.parametrize("shape", [MAIN] + GEMMA3,
                         ids=["qwen3", "gemma3_global", "gemma3_sliding"])
@pytest.mark.parametrize("sms", [108, 114, 132, 144])
def test_grid_fills_the_card_once_at_the_main_shape(sms, shape):
    """bf16: qwen3 takes the group body (its two query heads on tensor
    cores) at two CTAs an SM; gemma3's 8 rows the heads body at one (its
    one kv head read twice beat the group's 64 KB merges); each a wave
    that no further split fits, unless the row's 16-slot floor binds
    first.  fp32 keeps the heads body at two CTAs an SM."""
    for dtype in (torch.bfloat16, torch.float32):
        body, gt, S = t_da.decode_grid(sms=sms, dtype=dtype, **shape)
        want = ("group", 2) if shape["G"] == 2 and dtype == torch.bfloat16 \
            else ("heads", 2)
        assert (body, gt) == want
        per_sm = 1 if dtype == torch.bfloat16 and body == "heads" else \
            t_da.CTAS_PER_SM
        units = shape["B"] * shape["K"] * shape["G"] // gt
        floor = -(-shape["W"] // t_da.MIN_SPLIT_SLOTS)
        assert S >= 1
        assert units * S <= per_sm * sms              # one resident wave
        assert S == floor or units * (S + 1) > per_sm * sms
        assert S <= t_da.merge_cap(body, shape["D"], gt)   # one merge


@pytest.mark.parametrize("body,D,gt,cap", [
    ("heads", 32, 1, 32), ("heads", 32, 2, 32), ("heads", 64, 2, 32),
    ("heads", 128, 1, 32), ("heads", 128, 2, 32), ("heads", 256, 1, 32),
    ("heads", 256, 2, 24),
    ("group", 128, 16, 6), ("group", 128, 8, 12), ("group", 128, 6, 16),
    ("group", 64, 5, 32), ("group", 256, 4, 16)])
def test_split_cap_fits_the_merge_in_the_ring(body, D, gt, cap):
    """One merge stages at most ``cap`` pieces of GT x D fp32 accumulators
    in the body's ring (the heads body's 48 KB: only D = 256 at two query
    heads a CTA lowers the cap below 32); two levels take up to cap^2
    splits, a plan asking more is cut to cap^2.  At B = K = 1 over 2048
    slots fp32's heads plan stops at one merge (the cap binds, as before
    the second level existed); cap^2 splits make cap groups of cap, every
    split once."""
    assert t_da.merge_cap(body, D, gt) == cap
    assert cap * gt * D * 4 <= t_da.ring_bytes(body, D)
    assert t_da.max_splits(body, D, gt) == cap * cap
    G = gt if body == "group" else (2 if gt == 2 else 1)
    if body == "heads":
        assert t_da.decode_grid(1, 1, G, 2048, 132, D, torch.float32) == \
            (body, gt, cap)
    for ask in (cap * cap, cap * cap + 5):
        plan = t_da.decode_grid(1, 1, G, 2048, 132, D,
                                plan=t_da.DecodePlan(body, gt, ask))
        assert plan == (body, gt, cap * cap)
    groups = t_da.merge_groups(cap * cap, cap)
    assert groups == [(cap * j, cap * j + cap) for j in range(cap)]


def test_plan_fills_one_wave_at_one_row():
    """gemma3's decode at one row over 32,768 slots (B * K = 1: the long
    context's slot): the heads body's one-merge grid would hold 48 CTAs,
    so bf16 takes the group body's 256 splits in 16 groups of 16, a wave
    of two CTAs on nearly every SM of a 132-SM card; qwen3's 8 kv heads
    fill a wave at one merge (8 units of 32)."""
    plan = t_da.decode_grid(1, 1, 4, 32768, 132, 256)
    assert plan == ("group", 4, 256)
    assert 132 < plan.splits <= 2 * 132
    assert t_da.merge_groups(256, 16) == [(16 * j, 16 * j + 16)
                                          for j in range(16)]
    old = t_da.merge_cap("heads", 256, 2)
    assert 2 * old == 48 < plan.splits
    fp32 = t_da.decode_grid(1, 1, 4, 32768, 132, 256, torch.float32)
    assert fp32 == ("heads", 2, 24)
    assert t_da.decode_grid(1, 8, 2, 32768, 132, 128) == ("group", 2, 32)


@settings(max_examples=300, deadline=None)
@given(B=st.integers(1, 64), K=st.integers(1, 16),
       G=st.sampled_from([1, 2, 3, 4, 5, 6, 7, 8, 16]),
       W=st.integers(1, 40000), sms=st.integers(1, 200),
       D=st.sampled_from(t_da.HEAD_DIMS),
       dtype=st.sampled_from([torch.float32, torch.bfloat16]))
def test_grid_is_a_pure_function_of_the_shapes(B, K, G, W, sms, D, dtype):
    plan = t_da.decode_grid(B, K, G, W, sms, D, dtype)
    body, gt, S = plan
    assert plan == t_da.decode_grid(B, K, G, W, sms, D, dtype)
    want_body, want_gt, per_sm, limit = _rule(B, K, G, W, sms, D, dtype)
    assert (body, gt) == (want_body, want_gt) and G % gt == 0
    assert 1 <= S <= limit <= t_da.max_splits(body, D, gt)
    assert S <= max(1, -(-W // t_da.MIN_SPLIT_SLOTS))
    units = B * K * (G // gt)
    capped = S in (limit, -(-W // t_da.MIN_SPLIT_SLOTS))
    # the splits are as short as one wave of CTAs allows, and no shorter
    assert capped or units * (S + 1) > per_sm * sms
    assert S == 1 or units * S <= per_sm * sms


@settings(max_examples=300, deadline=None)
@given(data=st.data(), cap=st.integers(1, 32))
def test_merge_groups_hold_each_split_once(data, cap):
    """Up to cap^2 splits: groups of consecutive splits in order, at most
    cap of them, all of one length but the last, none empty (a group
    without a piece would never take its last ticket) and none longer
    than cap."""
    S = data.draw(st.integers(1, cap * cap))
    groups = t_da.merge_groups(S, cap)
    assert [s for a, b in groups for s in range(a, b)] == list(range(S))
    assert len(groups) == -(-S // cap) <= cap
    sizes = [b - a for a, b in groups]
    assert all(0 < n <= cap for n in sizes)
    assert len(set(sizes[:-1])) <= 1 and sizes[-1] <= sizes[0]


@settings(max_examples=500, deadline=None)
@given(data=st.data(), W=st.integers(1, 5000), S=st.integers(1, 32))
def test_partition_covers_the_span_exactly_once(data, W, S):
    lo = data.draw(st.integers(0, W))
    hi = data.draw(st.integers(lo, W))
    pieces = [t_da.split_range(lo, hi, S, s) for s in range(S)]
    covered = [t for a, b in pieces for t in range(a, b)]
    assert covered == list(range(lo, hi))
    n = hi - lo
    for a, b in pieces:
        assert lo <= a <= b <= hi
        assert n // S <= b - a <= -(-n // S)      # no piece longer than needed


@pytest.mark.parametrize("lo,hi,S,pieces", [
    (0, 0, 4, [(0, 0)] * 4),                         # no slot to split
    (0, 560, 4, [(0, 140), (140, 280), (280, 420), (420, 560)]),
    (512, 515, 4, [(512, 512), (512, 513), (513, 514), (514, 515)]),
    (2047, 2048, 4, [(2047, 2047)] * 3 + [(2047, 2048)]),  # last slot only
    (0, 2048, 32, [(64 * s, 64 * s + 64) for s in range(32)]),  # all of W
])
def test_partition_cases(lo, hi, S, pieces):
    """A main-path row, fewer slots than splits, a span of only the last
    slot, and the whole ring (the span of a row with no valid slot)."""
    assert [t_da.split_range(lo, hi, S, s) for s in range(S)] == pieces


# -- the merge order, mirrored -------------------------------------------------

def _merge(parts):
    """(max, denominator, accumulator) partials of G heads merged in order,
    as the kernel's merge_pieces: the max first, then weighted sums in
    order."""
    mm = torch.full_like(parts[0][0], t_da.NEG_INF)
    for m, _, _ in parts:
        mm = torch.maximum(mm, m)
    ll = torch.zeros_like(mm)
    aa = torch.zeros_like(parts[0][2])
    for m, l, a in parts:
        w = torch.exp2(m - mm)
        ll = ll + l * w
        aa = aa + a * w[:, None]
    return mm, ll, aa


def mirror_decode(q, k, v, valid, plan):
    """The kernel's pieces and two-level merge order in fp32: each row's
    live span cut by ``split_range`` into ``plan.splits`` pieces, each
    piece's (max, denominator, accumulator) over its slots in log2 units
    (invalid slots of a row with a valid one skipped; a row with none
    takes every slot at score -1e30), the pieces merged group by group
    (``merge_groups`` at the body's ``merge_cap``), then the groups."""
    B, H, D = q.shape
    K = k.shape[2]
    G = H // K
    scale = math.log2(math.e) / math.sqrt(D)
    cap = t_da.merge_cap(plan.body, D, plan.gt)
    groups = t_da.merge_groups(plan.splits, cap)
    out = torch.empty((B, H, D), dtype=torch.float32)
    for b in range(B):
        idx = torch.nonzero(valid[b]).flatten()
        row_any = len(idx) > 0
        lo, hi = (int(idx[0]), int(idx[-1]) + 1) if row_any else \
            (0, valid.shape[1])
        for kh in range(K):
            qg = q[b, kh * G:(kh + 1) * G].float()          # (G, D)
            parts = []
            for s in range(plan.splits):
                t0, t1 = t_da.split_range(lo, hi, plan.splits, s)
                ts = torch.arange(t0, t1)
                if row_any:
                    ts = ts[valid[b, t0:t1]]
                sc = (qg @ k[b, ts, kh].float().T) * scale  # (G, n)
                if not row_any:
                    sc = torch.full_like(sc, t_da.NEG_INF)
                m = torch.cat([torch.full((G, 1), t_da.NEG_INF), sc],
                              1).max(1).values
                p = torch.exp2(sc - m[:, None])
                parts.append((m, p.sum(1), p @ v[b, ts, kh].float()))
            level = [_merge(parts[a:e]) for a, e in groups]
            mm, ll, aa = _merge(level) if len(level) > 1 else level[0]
            out[b, kh * G:(kh + 1) * G] = aa / torch.clamp(ll, min=1e-30)[
                :, None]
    return out


def _long_row(G, seed, paged):
    """One row over 4096 slots at 2 kv heads of 32: dense with a late,
    holed window, or paged (a shuffled pool of 256-slot blocks, -1 past a
    length of 3001)."""
    rng = np.random.default_rng(seed)
    K, D, W = 2, 32, 4096
    q = rng.normal(size=(1, K * G, D)).astype(np.float32)
    if not paged:
        k = rng.normal(size=(1, W, K, D)).astype(np.float32)
        v = rng.normal(size=(1, W, K, D)).astype(np.float32)
        valid = np.zeros((1, W), bool)
        valid[0, 700:3900] = True
        valid[0, 1000:1100] = False
        return q, k, v, valid
    bs, M = 256, W // 256
    kp = rng.normal(size=(M + 2, bs, K, D)).astype(np.float32)
    vp = rng.normal(size=(M + 2, bs, K, D)).astype(np.float32)
    lengths = np.array([3001], np.int32)
    bt = rng.permutation(M + 2)[:M].astype(np.int32)[None]
    bt[0, -(-3001 // bs):] = -1
    return q, kp, vp, bt, lengths


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("G", [1, 2, 4, 5, 6, 8, 16])
def test_two_level_merge_order_matches_the_reference(G, paged):
    """The mirror of the kernel's merge order at the bf16 plan of one row
    over 4096 slots on a 132-SM card (every G takes two merge levels
    there) ≡ the plain version ≡ the reference's Pallas kernel in
    interpret mode, all in fp32 at the kernels' tolerance."""
    args = _long_row(G, 29 + G, paged)
    t = [torch.from_numpy(a) for a in args]
    if paged:
        q, kp, vp, bt, ln = t
        k, v = t_da.paged_view(kp, bt), t_da.paged_view(vp, bt)
        valid = torch.arange(k.shape[1])[None] < ln[:, None]
        plain = t_da.gqa_decode_paged(*t).numpy()
        ref = np.asarray(da_ops.gqa_decode_paged(
            *[jnp.asarray(a) for a in args]))
    else:
        q, k, v, valid = t
        plain = t_da.gqa_decode(*t).numpy()
        ref = np.asarray(da_ops.gqa_decode(*[jnp.asarray(a) for a in args]))
    K, D = k.shape[2], k.shape[3]
    plan = t_da.decode_grid(1, K, G, k.shape[1], 132, D)
    cap = t_da.merge_cap(plan.body, D, plan.gt)
    assert len(t_da.merge_groups(plan.splits, cap)) > 1
    got = mirror_decode(q, k, v, valid, plan).numpy()
    np.testing.assert_allclose(got, plain, **TOL)
    np.testing.assert_allclose(got, ref, **TOL)
