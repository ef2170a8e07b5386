"""How ``fused_mask`` and ``cbr_avgpool`` cut their work, checked on the CPU.

Both kernels (``src/repro_torch/csrc/fused_sampler.cu`` and
``linked_cbr_pool.cu``) run only on the card; their grids come from
Python planners that the wrappers call with the device's SM count:

* ``mask_plan`` picks the cluster of CTAs that holds each row and the
  slice each CTA keeps in shared memory; ``mask_slice`` mirrors the
  kernel's slice of a cluster rank;
* ``cbra_plan`` picks the CTA shape, the cluster that splits C, the
  square tiles a CTA walks and the ring's depth; ``cbra_tiles``,
  ``cbra_tile``, ``cbra_steps`` and ``cbra_pixels`` mirror the kernel's
  mapping of a CTA to its square tiles, of a tile to pooled outputs and
  channels, of a cluster rank to its steps of C, and of a pooled output
  to its four pre-pool pixels.

The card tests in ``tests/test_torch_cuda.py`` hold the kernels to their
plain versions under these plans and their alternatives.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch import kernels
from repro_torch.kernels.fused_sampler import ops as fs
from repro_torch.kernels.linked_cbr_pool import ops as cb

#: the served sampler's rows: slots 8, qwen3's vocabulary
SERVED = (8, 151936)
#: the Figure-5 example and the two Table-4 CBRA operators, (N,H,W,C,OC)
CBRA = {"fig5": (1, 16, 16, 64, 128), "t4_8x8": (1, 8, 8, 1024, 1024),
        "t4_224": (1, 224, 224, 24, 224)}


@settings(max_examples=200, deadline=None)
@given(B=st.integers(1, 300), V=st.integers(1, 800_000),
       sms=st.sampled_from([1, 16, 114, 132]))
def test_mask_slices_hold_every_element_once(B, V, sms):
    """Each element of a row lies in exactly one rank's slice; slices are
    whole float4s; a CTA's shared memory fits; the cluster is a size the
    kernel takes (at most 16), so it divides the B x cl grid."""
    plan = fs.mask_plan(B, V, sms)
    assert plan is not None
    assert plan.cl in fs.CL_CHOICES and plan.cl <= 16
    assert plan.chunk % 4 == 0 and plan.cl * plan.chunk >= V
    assert fs.mask_smem(plan.chunk) <= kernels.CTA_SMEM_MAX
    assert 0 <= plan.cap <= 512
    seen = np.zeros(V, np.int32)
    for r in range(plan.cl):
        lo, hi = fs.mask_slice(V, plan.chunk, r)
        assert lo % 4 == 0 and hi - lo <= plan.chunk
        seen[lo:hi] += 1
    assert (seen == 1).all()
    assert plan == fs.mask_plan(B, V, sms)


def test_mask_plan_refuses_rows_no_cluster_holds():
    most = (kernels.CTA_SMEM_MAX - fs.STATIC_SMEM) // 4 * 16
    assert fs.mask_plan(8, most, 132) is not None
    assert fs.mask_plan(8, most + 64, 132) is None


#: clusters of 1-16 CTAs of ``fused_mask`` an H100 (132 SMs) holds at once
#: with one CTA an SM, as ``repro_fused_mask_solo_clusters`` reports them
#: (``mask_cbra_timing.py`` prints them): at 4, 8 and 16 fewer than
#: 132 // cl, since a GPC's SMs go to whole clusters
H100_SOLO = {1: 132, 2: 66, 4: 30, 8: 15, 16: 7}


@pytest.mark.parametrize("B,sms,solo,cl", [
    (8, 132, H100_SOLO, 8), (1, 132, H100_SOLO, 16), (64, 132, H100_SOLO, 8),
    (8, 132, None, 16), (8, 16, None, 8), (8, 114, None, 8)])
def test_mask_plan_fills_the_card_by_sm_count(B, sms, solo, cl):
    """At qwen3's vocabulary, the clusters the H100's sweep timed fastest
    (``mask_cbra_timing.py``, served policy): one row takes 16 CTAs;
    the served B = 8 takes clusters of 8, since its 8 clusters of 16
    would exceed the 7 the card holds one CTA an SM and share SMs (were
    every SM usable, 16 would win); B = 64 clusters of 8, two CTAs an SM.
    A 16-SM card, or 114 SMs (7 clusters of 16 at most), take 8.  Every
    CTA fits an SM's shared memory."""
    plan = fs.mask_plan(B, SERVED[1], sms,
                        solo=solo.get if solo is not None else None)
    assert plan.cl == cl
    assert fs.mask_smem(plan.chunk) + kernels.CTA_SMEM_RESERVED \
        <= kernels.SM_SMEM


def test_mask_plan_keeps_short_rows_on_few_ctas():
    """A row of 17 stays on one CTA: the cluster's merges would cost more
    than the slice."""
    assert fs.mask_plan(8, 17, 132).cl == 1


def test_mask_cpu_wrapper_runs_the_plain_version_on_any_plan():
    rng = np.random.default_rng(0)
    rows = torch.from_numpy(rng.normal(size=(3, 50)).astype(np.float32))
    t = torch.tensor([0.0, 0.8, 1.0])
    k = torch.tensor([0, 5, 50], dtype=torch.int32)
    p = torch.tensor([1.0, 0.9, 0.5])
    want = fs.fused_mask_plain(rows, t, k, p)
    for plan in (None, fs.MaskPlan(16, 4, 0), fs.MaskPlan(1, 52, 512)):
        assert torch.equal(fs.fused_mask(rows, t, k, p, plan=plan), want)


def _cbra_coverage(plan, Q, OC):
    """How often the grid writes each pooled output (Q, OC)."""
    seen = np.zeros((Q, OC), np.int32)
    for bx in range(plan.sq_ctas):
        for tile in cb.cbra_tiles(plan, bx):
            for by in range(plan.oc_tiles):
                q0, q1, c0, c1 = cb.cbra_tile(plan, Q, OC, tile, by)
                seen[q0:q1, c0:c1] += 1
    return seen


def _check_cbra_plan(plan, N, H, W, C, OC):
    """The grid covers each pooled output and channel exactly once; a
    split (kh or cl) keeps one tile a CTA, a walk takes at most WALK_MAX
    tiles; the cluster's ranks split C's
    steps once, each rank at least one; the ring is 1 to 3 deep and no
    deeper than the busiest CTA's work items; shared memory fits."""
    Q = N * (H // 2) * (W // 2)
    assert (plan.txn, plan.tyn, plan.kh, plan.tsq) in cb.SHAPES.values()
    assert plan.cl in (cb.CL_CHOICES if plan.kh > 1 else (1,))
    assert plan.sq_tiles == -(-Q // (plan.tsq * plan.tyn))
    assert plan.oc_tiles == -(-OC // (8 * plan.txn))
    assert 1 <= plan.sq_ctas <= plan.sq_tiles
    if plan.kh > 1 or plan.cl > 1:
        assert plan.sq_ctas == plan.sq_tiles
    assert (_cbra_coverage(plan, Q, OC) == 1).all()
    steps = -(-C // cb.BK)
    pieces = [cb.cbra_steps(C, plan.cl, r) for r in range(plan.cl)]
    assert pieces[0][0] == 0 and pieces[-1][1] == steps
    assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
    assert all(s1 > s0 for s0, s1 in pieces)
    walk = -(-plan.sq_tiles // plan.sq_ctas)
    assert walk <= cb.WALK_MAX
    items = walk * max(s1 - s0 for s0, s1 in pieces)
    assert 1 <= plan.stages <= min(3, items)
    assert cb.cbra_smem(plan.txn, plan.tyn, plan.kh, plan.tsq, plan.cl,
                        plan.stages) <= kernels.CTA_SMEM_MAX


@settings(max_examples=200, deadline=None)
@given(N=st.integers(1, 3), H=st.integers(2, 70), W=st.integers(2, 70),
       C=st.integers(1, 1100), OC=st.integers(1, 300),
       sms=st.sampled_from([1, 16, 114, 132]))
def test_cbra_grid_writes_every_output_once(N, H, W, C, OC, sms):
    plan = cb.cbra_plan(N, H, W, C, OC, sms)
    _check_cbra_plan(plan, N, H, W, C, OC)
    assert plan == cb.cbra_plan(N, H, W, C, OC, sms)


@pytest.mark.parametrize("label", sorted(CBRA))
def test_every_listed_cbra_plan_is_one_the_kernel_takes(label):
    """``cbra_plans`` (the card tests' and the timing script's list) holds
    the planner's pick, and every plan in it covers the outputs once."""
    plans = cb.cbra_plans(*CBRA[label], 132)
    assert cb.cbra_plan(*CBRA[label], 132) in plans
    assert len(set(plans)) == len(plans)
    for plan in plans:
        _check_cbra_plan(plan, *CBRA[label])


@pytest.mark.parametrize("C,OC,aligned,vec", [
    (3, 10, True, False), (3, 8, True, False), (24, 224, True, True),
    (24, 45, True, False), (100, 40, True, True), (100, 40, False, False),
    (1024, 1024, True, True)])
def test_cbra_copies_16_bytes_only_where_aligned(C, OC, aligned, vec):
    """16-byte copies need whole float4s in every x row (C) and w row (OC)
    and 16-byte aligned tensors: C = 3 never, C = 24 and C = 100 where OC
    is a multiple of 4 and the tensors are aligned."""
    assert cb.cbra_vector_copies(C, OC, aligned) is vec


@pytest.mark.parametrize("label", sorted(CBRA))
def test_cbra_plan_at_the_main_shapes(label):
    """The plans timed fastest on the H100 (``mask_cbra_timing.py``):
    t4_224 (one 24-deep step, 12,544 squares) walks mid CTAs without a
    split; t4_8x8 (16 squares, 32 steps) splits C over clusters of 16
    small CTAs, so 512 CTAs share the 4 MB weight, each byte read once;
    Figure 5 (2 steps) takes tiny CTAs, k in four parts, no cluster."""
    want = {"t4_224": ((8, 16, 1, 2), 1), "t4_8x8": ((4, 8, 2, 2), 16),
            "fig5": ((4, 8, 4, 1), 1)}[label]
    plan = cb.cbra_plan(*CBRA[label], 132)
    assert ((plan.txn, plan.tyn, plan.kh, plan.tsq), plan.cl) == want
    if label == "t4_224":
        assert plan.sq_ctas < plan.sq_tiles     # each CTA walks tiles


def test_cbra_plan_follows_the_sm_count():
    """Fewer SMs, fewer CTAs: t4_8x8 on 16 SMs splits C over fewer ranks."""
    assert cb.cbra_plan(*CBRA["t4_8x8"], 16).cl < \
        cb.cbra_plan(*CBRA["t4_8x8"], 132).cl


@pytest.mark.parametrize("N,H,W", [(1, 4, 6), (2, 7, 9), (3, 5, 4)])
def test_cbra_pixels_are_each_outputs_pooling_window(N, H, W):
    """Pooled output q's four corners, as the kernel addresses them, are
    the pixels its 2x2 window pools: relu(x @ w + b) averaged over them is
    the plain version's output q (odd H and W floored)."""
    rng = np.random.default_rng(N * 100 + H * 10 + W)
    C, OC = 5, 3
    x = torch.from_numpy(rng.normal(size=(N, H, W, C)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(C, OC)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(OC,)).astype(np.float32))
    want = cb.cbr_avgpool_plain(x, w, b).reshape(-1, OC)
    for q in range(N * (H // 2) * (W // 2)):
        corners = [torch.relu(x[n, h, ww] @ w + b)
                   for n, h, ww in cb.cbra_pixels(q, H, W)]
        torch.testing.assert_close(sum(corners) * 0.25, want[q],
                                   rtol=1e-6, atol=1e-6)


def test_cbra_cpu_wrapper_runs_the_plain_version_on_any_plan():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(1, 6, 6, 8)).astype(np.float32))
    w = torch.from_numpy(rng.normal(size=(8, 4)).astype(np.float32))
    b = torch.zeros(4)
    want = cb.cbr_avgpool_plain(x, w, b)
    for plan in (None, cb.cbra_plan(1, 6, 6, 8, 4, 132),
                 cb.CbraPlan(4, 8, 2, 2, 16, 3, 1, 1, 1)):
        assert torch.equal(cb.cbr_avgpool(x, w, b, plan=plan), want)
