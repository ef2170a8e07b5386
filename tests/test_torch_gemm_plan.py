"""How the two GEMM kernels cut their work, checked on the CPU.

``split_matmul`` (``src/repro_torch/csrc/split_matmul.cu``) and
``linked_mlp`` (``src/repro_torch/csrc/linked_mlp.cu``) run only on the
card; their grids come from Python planners that the wrappers call with
the device's SM count:

* ``split_plan`` picks the rows a CTA covers and the cluster that splits
  each of the plan's K tiles; ``tile_of`` and ``piece_steps`` mirror the
  kernel's mapping of a grid cell to y's columns and of a cluster rank to
  its steps of a K tile;
* ``mlp_plan`` picks the kernel (tensor-core or FFMA) and its grid;
  ``split_blocks`` mirrors both kernels' partition of ff.

The card tests in ``tests/test_torch_cuda.py`` hold the kernels to their
plain versions at these plans' edges.
"""
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro_torch import kernels
from repro_torch.kernels.linked_matmul import ops as lm
from repro_torch.kernels.split_matmul import ops as sm

#: bert_s's FFN tiles under the DSP spec (M, K, N, block_n, block_k), and
#: an inC split of the first with a cluster split inside each K tile
BERT_TILES = {"ffn1": (128, 768, 3072, 1024, 768),
              "ffn2": (128, 3072, 768, 256, 3072),
              "inC": (128, 768, 3072, 3072, 256)}
#: qwen3-1.7b's MLP widths
D, FF = 2048, 6144


def _split_coverage(plan, M, N, block_n):
    """How often the grid writes each element of y (M, N)."""
    seen = np.zeros((M, N), np.int32)
    for bx in range(plan.m_tiles):
        for by in range(plan.cols):
            cell = sm.tile_of(plan, block_n, N, bx, by)
            if cell is not None:
                m0, m1, n0, n1 = cell
                seen[m0:min(m1, M), n0:n1] += 1
    return seen


@settings(max_examples=200, deadline=None)
@given(M=st.integers(1, 300), K=st.integers(1, 900), N=st.integers(1, 700),
       bn=st.integers(1, 800), bk=st.integers(1, 900),
       sms=st.sampled_from([1, 16, 114, 132]))
def test_split_grid_writes_every_element_once(M, K, N, bn, bk, sms):
    plan = sm.split_plan(M, N, K, bn, bk, sms)
    assert (plan.bm, plan.kh) in sm.SHAPES and plan.cl in sm.CL_CHOICES
    assert plan.m_tiles * plan.bm >= M > (plan.m_tiles - 1) * plan.bm
    assert (_split_coverage(plan, M, N, bn) == 1).all()
    assert plan == sm.split_plan(M, N, K, bn, bk, sms)


@settings(max_examples=200, deadline=None)
@given(k_lo=st.integers(0, 5000), n=st.integers(1, 4000),
       cl=st.sampled_from(sm.CL_CHOICES))
def test_split_ranks_contract_each_k_once(k_lo, n, cl):
    """The cluster's pieces of a K tile are whole steps, in rank order,
    and together cover the tile exactly once."""
    steps = -(-n // sm.BK)
    pieces = [sm.piece_steps(k_lo, k_lo + n, r, cl) for r in range(cl)]
    assert pieces[0][0] == 0 and pieces[-1][1] == steps
    assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
    assert all(s0 <= s1 for s0, s1 in pieces)


@pytest.mark.parametrize("sms", [114, 132])
@pytest.mark.parametrize("label", sorted(BERT_TILES))
def test_split_plan_fills_the_card_at_bert_s(label, sms):
    """At bert_s's tiles the plan puts at least one warp on each of every
    SM's four schedulers and stays within one resident wave."""
    M, K, N, bn, bk = BERT_TILES[label]
    plan = sm.split_plan(M, N, K, bn, bk, sms)
    warps, per_sm = sm.SHAPES[plan.bm, plan.kh]
    ctas = plan.m_tiles * plan.cols * plan.cl
    assert ctas * warps >= 4 * sms
    assert -(-ctas // sms) <= per_sm
    assert (_split_coverage(plan, M, N, bn) == 1).all()


def test_split_plan_splits_k_tiles_over_clusters_on_the_h100():
    """On 132 SMs bert_s's tiles (one K tile each: 24 or 96 steps) and
    the inC plans (3 K tiles) are too few CTAs without a cluster split."""
    for M, K, N, bn, bk in (*BERT_TILES.values(),
                            (128, 3072, 768, 256, 1024),
                            (1, 768, 3072, 1024, 768)):
        assert sm.split_plan(M, N, K, bn, bk, 132).cl > 1


def test_split_plan_follows_the_sm_count():
    """The same shape on fewer SMs never takes more CTAs a wave, and a
    card of one SM gets no cluster split (nothing to fill)."""
    M, K, N, bn, bk = BERT_TILES["ffn2"]
    for sms in (16, 66, 114, 132):
        plan = sm.split_plan(M, N, K, bn, bk, sms)
        ctas = plan.m_tiles * plan.cols * plan.cl
        assert -(-ctas // sms) <= sm.SHAPES[plan.bm, plan.kh][1] \
            or plan.cl == 1
    assert sm.split_plan(M, N, K, bn, bk, 1).cl == 1


@pytest.mark.parametrize("K,N,bn,bk,vec", [
    (768, 3072, 1024, 768, True), (70, 100, 30, 27, False),
    (768, 3070, 1024, 768, False), (768, 3072, 1022, 768, False),
    (768, 3072, 1024, 766, False), (766, 3072, 1024, 768, False)])
def test_split_copies_16_bytes_only_where_aligned(K, N, bn, bk, vec):
    """16-byte copies need every row and tile edge on 4 floats; any other
    shape takes the kernel's 4-byte copies (zero-filled at the edges), not
    another kernel."""
    x, w = torch.zeros((3, K)), torch.zeros((K, N))
    assert sm.vector_copies(x, w, bn, bk) is vec
    shifted = torch.zeros(3 * K + 1)[1:].view(3, K)   # 4 bytes off
    assert not sm.vector_copies(shifted, w, bn, bk)


def _cost(plan, M, ff, wave):
    """Waves x rounds: the planner's model of a tensor-core plan's time."""
    n_blocks = -(-ff // lm.TC_BF)
    rounds = -(-(-(-n_blocks // plan.S)) // plan.cl)
    return -(-(-(-M // plan.bm) * plan.S) // wave) * rounds


@pytest.mark.parametrize("M", [1, 8, 15, 16, 17, 63, 64, 65, 129, 256,
                               512, 4352])
@pytest.mark.parametrize("wave", [15, 13, 7])
def test_mlp_plan_by_rows(M, wave):
    """qwen3-1.7b's MLP in bf16 takes the tensor-core kernel at every M,
    decode included: up to ``SWAP_ROWS`` (32) rows its swap body (M
    padded to 8, 16 or 32 rows; one cluster over d, S at most a wave of
    clusters), up to 64 its decode body with a cluster of 8 ranks of 256
    columns, from ``PREFILL_ROWS`` on its prefill body (128-row tiles)
    with a cluster of 16 ranks of 128 columns.  Decode and prefill: S = 1
    where the M tiles fill a wave of clusters; else S is the fewest ff
    splits of least waves x rounds.  S never exceeds the ff blocks, and
    only S > 1 has a workspace, (S, M, d) fp32."""
    plan = lm.mlp_plan(M, D, FF, torch.bfloat16, True, 132,
                       slots=lambda cl: wave)
    n_blocks = -(-FF // lm.TC_BF)
    assert 1 <= plan.S <= n_blocks
    assert plan.workspace == (plan.S * M * D if plan.S > 1 else 0)
    if M <= lm.SWAP_ROWS:
        assert (plan.path, plan.body) == ("tc", "swap")
        assert plan.bm == next(n for n in (8, 16, 32) if n >= M)
        assert plan.cl in lm.swap_clusters(M, D) and plan.S <= wave
        return
    if M < lm.PREFILL_ROWS:
        assert (plan.path, plan.body, plan.bm, plan.cl) == (
            "tc", "decode", lm.TC_BM, 8)
    else:
        assert (plan.path, plan.body, plan.bm, plan.cl) == (
            "tc", "prefill", lm.TP_BM, 16)
    if -(-M // plan.bm) >= wave:
        assert plan.S == 1
    else:
        best = min(_cost(plan._replace(S=S), M, FF, wave)
                   for S in range(1, n_blocks + 1))
        assert _cost(plan, M, FF, wave) == best
        assert all(_cost(plan._replace(S=S), M, FF, wave) > best
                   for S in range(1, plan.S))
    assert plan.workspace == (plan.S * M * D if plan.S > 1 else 0)


@pytest.mark.parametrize("sms", [114, 132])
def test_mlp_plan_batched_prefill_stores_y_directly(sms):
    """Batched prefill (8 prompts of 544 tokens): 68 M tiles fill every
    wave of clusters, so S = 1, no workspace and no reduce."""
    plan = lm.mlp_plan(4352, D, FF, torch.bfloat16, True, sms)
    assert plan.path == "tc" and plan.S == 1 and plan.workspace == 0


def test_mlp_plan_follows_the_sm_count():
    """The decode body's 8 M tiles of 512 rows (forced: chunked prefill
    takes the prefill body there): 15 clusters of 8 a wave on 132 SMs run
    12 one-round splits in 7 waves (cost 7), 13 on 114 SMs would need 8
    waves, so 3 splits of 4 rounds in 2 waves (cost 8) win there.
    The decode body's 12 one-round splits at 8 rows fit one wave on
    either."""
    assert lm.mlp_plan(512, D, FF, torch.bfloat16, True, 132,
                       body="decode").S == 12
    assert lm.mlp_plan(512, D, FF, torch.bfloat16, True, 114,
                       body="decode").S == 3
    for sms in (114, 132):
        assert lm.mlp_plan(8, D, FF, torch.bfloat16, True, sms,
                           body="decode").S == 12


@pytest.mark.parametrize("M,d,ff,dtype,aligned", [
    (256, 2048, 6144, torch.float32, True),      # fp32: FFMA (TF32 is not
    (256, 2047, 6144, torch.bfloat16, True),     # allowed at its 2e-5)
    (256, 2048, 6140, torch.bfloat16, True),
    (256, 2048, 6144, torch.bfloat16, False),
    (256, 4100, 13696, torch.bfloat16, True),    # a wide d, not 16-byte rows
    (256, 136, 204, torch.bfloat16, True)])
def test_mlp_shapes_the_tc_kernel_does_not_take_go_to_ffma(M, d, ff, dtype,
                                                            aligned):
    plan = lm.mlp_plan(M, d, ff, dtype, aligned, 132)
    assert plan.path == "ffma" and plan.cl == 1
    assert plan.workspace == plan.S * M * d
    with pytest.raises(ValueError, match="does not take"):
        lm.mlp_plan(M, d, ff, dtype, aligned, 132, path="tc")


@settings(max_examples=200, deadline=None)
@given(M=st.integers(1, 5000), d8=st.integers(1, 256),
       ff8=st.integers(1, 1000), sms=st.sampled_from([8, 114, 132]))
def test_tc_grid_covers_y_and_deals_each_block_once(M, d8, ff8, sms):
    """Every row, every column of d and every ff block once: M tiles of
    bm rows; cluster ranks' slices of d (256 columns in the decode body,
    128 in the prefill body); the S splits' block ranges; within a split,
    each block owned by one rank in one round (whose h every rank then
    reads).  The swap body's one cluster owns all of d (``swap_ds``)."""
    d, ff = 8 * d8, 8 * ff8
    plan = lm.mlp_plan(M, d, ff, torch.bfloat16, True, sms, path="tc")
    assert plan.cl <= lm.TC_MAX_CLUSTER
    ds = {"prefill": lm.TP_DS, "decode": lm.TC_DS}.get(
        plan.body) or lm.swap_ds(d, plan.cl)
    cols = np.zeros(d, np.int32)
    for _, _, c0, c1 in lm.tc_columns(d, plan.cl, ds):
        cols[c0:c1] += 1
    assert (cols == 1).all()
    assert -(-M // plan.bm) * plan.bm >= M
    n_blocks = -(-ff // lm.TC_BF)
    owned = np.zeros(n_blocks, np.int32)
    for s in range(plan.S):
        jb0, jb1 = lm.split_blocks(n_blocks, plan.S, s)
        assert jb1 > jb0                        # no split walks nothing
        rounds = -(-(jb1 - jb0) // plan.cl)
        for r in range(rounds):
            base = jb0 + r * plan.cl
            for c in range(plan.cl):
                if base + c < jb1:
                    owned[base + c] += 1
    assert (owned == 1).all()
    assert plan.workspace == (plan.S * M * d if plan.S > 1 else 0)


def test_tc_cluster_with_fewer_blocks_than_ranks():
    """d 2048 (8 ranks) but ff 320 (5 blocks): in every split some ranks
    own no block, yet each computes its columns from all of the split's
    blocks."""
    plan = lm.mlp_plan(200, 2048, 320, torch.bfloat16, True, 132)
    assert plan.path == "tc" and plan.cl == 8
    for s in range(plan.S):
        jb0, jb1 = lm.split_blocks(5, plan.S, s)
        assert 0 < jb1 - jb0 < plan.cl


def test_cpu_wrapper_runs_the_plain_version_on_any_plan():
    """On CPU tensors neither kernel launches, whatever plan is given
    (the planned one at 20 rows is the swap body's)."""
    rng = np.random.default_rng(0)
    x, wg, wu, wd = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                     .bfloat16() for s in ((20, 64), (64, 96), (64, 96),
                                           (96, 64)))
    kernels.reset_launches()
    for path in (None, "tc", "ffma"):
        plan = lm.mlp_plan(20, 64, 96, torch.bfloat16, True, 132, path)
        assert torch.equal(lm.linked_mlp(x, wg, wu, wd, plan=plan),
                           lm.linked_mlp_plain(x, wg, wu, wd))
    assert kernels.LAUNCHES["linked_mlp"] == 0
    assert kernels.LAUNCHES["linked_mlp_tc"] == 0
    assert kernels.LAUNCHES["linked_mlp_tc_swap"] == 0
