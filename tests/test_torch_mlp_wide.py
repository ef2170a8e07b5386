"""The tensor-core ``linked_mlp``'s swap body, planned on the CPU.

The swap body (``csrc/linked_mlp.cu``, ``linked_mlp_tc_swap``) takes
decode rows with the operands swapped (gᵀ = Wgᵀ xᵀ, yᵀ += Wdᵀ hᵀ): wgmma's
N runs over the rows, M padded to 8, 16, 32 or 64, so a rank's y block is
64-column tiles of N / 2 registers a thread and one cluster of up to 16
ranks owns all of d.  Here, at every registered SwiGLU width (d 1152 to
8192) and at ragged widths, under a stand-in for the H100's occupancy
calculator:

* the body is chosen by rows as ``mlp_plan``'s docstring states;
* y's columns are covered once, by one cluster (no h block computed by
  two clusters), every rank owning at least one tile and at most
  ``swap_max_tiles`` (64 registers of y a thread);
* every ff block is dealt to one rank in one round of one split, and S
  fills at most one wave of clusters;
* the plans the card's occupancy gives at the served decode shapes, and
  the refusals;
* the CPU wrapper runs ``linked_mlp_plain`` under a forced swap plan.

The kernel itself runs on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py`` phase 2).
"""
import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.configs.base import all_configs
from repro_torch.kernels.linked_matmul import ops as lm

#: every registered SwiGLU site's (d, ff): the dense and hybrid decoders'
#: MLPs and arctic-480b's dense residual
SWIGLU_WIDTHS = sorted({(2048, 6144), (1152, 6912), (1600, 5504),
                        (4096, 13696), (4096, 14336), (6144, 16384),
                        (7168, 4864), (8192, 22016)})
#: chip_smoke.py's MLP_RAGGED_WIDE widths, and 8200 (one tile past 8192)
RAGGED = [(2056, 6144), (4104, 13704), (6152, 16392), (8200, 22016)]
ROWS = (1, 8, 13, 32, 33, 37, 64)
#: tests/test_torch_large_dense.py's stand-in for the occupancy
#: calculator on a 132-SM H100: one CTA an SM, clusters within a GPC, 7
#: of the non-portable sizes
H100_SLOTS = {1: 132, 2: 66, 3: 44, 4: 32, 5: 26, 6: 22, 7: 18, 8: 15}
#: what the occupancy calculator gave for the tensor-core kernel on an
#: H100 80GB HBM3 (PERF.md)
CARD_SLOTS = {1: 132, 2: 66, 3: 39, 4: 30, 5: 22, 6: 17, 7: 15, 8: 15,
              9: 9, **{cl: 7 for cl in range(10, 17)}}


def _slots(cl):
    return H100_SLOTS.get(cl, 7)


def test_widths_are_every_registered_swiglu_site():
    sites = set()
    for cfg in all_configs().values():
        if cfg.family == "moe":
            if cfg.moe_dense_residual:
                sites.add((cfg.d_model, cfg.d_ff))
        elif cfg.d_ff and cfg.family != "audio":
            sites.add((cfg.d_model, cfg.d_ff))
    assert sites == set(SWIGLU_WIDTHS)


def _want_body(M, d):
    """mlp_plan's docstring: the swap body up to 32 rows at every width,
    and up to 64 past d 2048, wherever one cluster covers d (16 ranks of
    at most 16 tiles at 8 and 16 rows, 8 at 32 rows, 4 at 64: d 16384,
    8192, 4096); the decode body for the rest of the rows under 65."""
    covers = d <= 64 * 16 * min(16, 256 // lm.swap_rows(M))
    return "swap" if covers and (M <= 32 or d > 2048) else "decode"


@pytest.mark.parametrize("M", ROWS)
@pytest.mark.parametrize("d,ff", SWIGLU_WIDTHS + RAGGED)
def test_swap_plan_covers_y_once_in_one_cluster(d, ff, M):
    """The planned body by rows; for the swap body, one cluster's ranks
    own d's 64-column tiles once (none past d, none empty, at most
    ``swap_max_tiles`` each), the split's ff blocks are dealt once, S is
    at most a wave of clusters and a workspace exists only where S > 1."""
    plan = lm.mlp_plan(M, d, ff, torch.bfloat16, True, 132, slots=_slots)
    assert (plan.path, plan.body) == ("tc", _want_body(M, d))
    if plan.body != "swap":
        return
    assert plan.bm == lm.swap_rows(M) >= M
    assert plan.cl in lm.swap_clusters(M, d)
    ds = lm.swap_ds(d, plan.cl)
    assert ds % lm.TS_TILE == 0
    assert ds // lm.TS_TILE <= lm.swap_max_tiles(M)
    owners = lm.tc_columns(d, plan.cl, ds)
    assert len(owners) == plan.cl
    assert {q for q, _, _, _ in owners} == {0}      # n = 1: one cluster
    cols = np.zeros(d, np.int32)
    for _, c, c0, c1 in owners:
        assert c1 > c0 and c1 - c0 <= ds
        cols[c0:c1] += 1
    assert (cols == 1).all()
    n_blocks = -(-ff // lm.TC_BF)
    assert 1 <= plan.S <= min(n_blocks, _slots(plan.cl))
    dealt = np.zeros(n_blocks, np.int32)
    for s in range(plan.S):
        jb0, jb1 = lm.split_blocks(n_blocks, plan.S, s)
        assert jb1 > jb0
        for r in range(-(-(jb1 - jb0) // plan.cl)):
            for c in range(plan.cl):
                if jb0 + r * plan.cl + c < jb1:
                    dealt[jb0 + r * plan.cl + c] += 1
    assert (dealt == 1).all()
    assert plan.workspace == (plan.S * M * d if plan.S > 1 else 0)


@pytest.mark.parametrize("d,ff", SWIGLU_WIDTHS + RAGGED)
def test_swap_plan_takes_the_fewest_rounds_in_one_wave(d, ff):
    """At 8 rows, S is the fewest splits of the least rounds within a wave
    of clusters of the chosen size, and no other size the body takes
    gives fewer rounds x steps a round (ties to the larger cluster)."""
    M = 8
    plan = lm.mlp_plan(M, d, ff, torch.bfloat16, True, 132, slots=_slots,
                       body="swap")
    n_blocks = -(-ff // lm.TC_BF)
    n_up = -(-d // lm.TC_BF)

    def rounds(cl, S):
        return -(-(-(-n_blocks // S)) // cl)

    def cost(cl):
        wave = min(n_blocks, _slots(cl))
        R = min(rounds(cl, S) for S in range(1, wave + 1))
        T = lm.swap_ds(d, cl) // lm.TS_TILE
        return R * (n_up + cl * -(-T // 2))

    wave = min(n_blocks, _slots(plan.cl))
    best = min(rounds(plan.cl, S) for S in range(1, wave + 1))
    assert rounds(plan.cl, plan.S) == best
    assert all(rounds(plan.cl, S) > best for S in range(1, plan.S))
    for cl in lm.swap_clusters(M, d):
        assert (cost(cl), -cl) >= (cost(plan.cl), -plan.cl)


def test_swap_plans_at_the_cards_occupancy():
    """The (cl, S) the occupancy the H100 80GB HBM3 reported gives at the
    served decode shapes (8 rows): PERF.md's table."""
    want = {(2048, 6144): (16, 6), (1152, 6912): (3, 36),
            (1600, 5504): (13, 7), (4096, 13696): (16, 7),
            (4096, 14336): (16, 7), (6144, 16384): (16, 6),
            (8192, 22016): (8, 15), (7168, 4864): (14, 6)}
    for (d, ff), (cl, S) in want.items():
        plan = lm.mlp_plan(8, d, ff, torch.bfloat16, True, 132,
                           slots=CARD_SLOTS.get)
        assert (plan.body, plan.cl, plan.S) == ("swap", cl, S), (d, ff)


def test_swap_rows_and_register_budget():
    """M pads to wgmma's N of 8, 16, 32 or 64; a rank owns at most 16
    tiles and 256 / N, so each of its two warpgroups holds at most 64
    fp32 registers of y; past 64 rows the body takes nothing."""
    for M in range(1, 65):
        n = lm.swap_rows(M)
        assert n in lm.TS_ROWS and n >= M and (n == 8 or n // 2 < M)
        most = lm.swap_max_tiles(M)
        assert most == min(16, 256 // n)
        assert -(-most // 2) * n // 2 <= 64
    assert lm.swap_rows(65) == 0 and lm.swap_clusters(65, 2048) == []
    assert lm.swap_clusters(8, 8192) == [16, 15, 13, 12, 11, 10, 9, 8]
    assert lm.swap_clusters(64, 4096) == [16]
    assert lm.swap_clusters(64, 4104) == []
    assert lm.swap_clusters(8, 8200) == [15, 13, 12, 11, 10, 9]


def test_swap_plan_refuses_what_the_body_does_not_take():
    """Forced, the swap body raises past 64 rows, at a width no cluster
    covers at 64 rows, for a size it does not take, where the device
    runs none of its sizes, and for what the tensor-core kernel refuses."""
    for M, d in ((65, 2048), (64, 6144)):
        with pytest.raises(ValueError, match="does not take"):
            lm.mlp_plan(M, d, 16384, torch.bfloat16, True, 132, path="tc",
                        body="swap")
    with pytest.raises(ValueError, match="not 7"):
        lm.mlp_plan(8, 8192, 22016, torch.bfloat16, True, 132, path="tc",
                    body="swap", cl=7)
    with pytest.raises(ValueError, match="runs no cluster"):
        lm.mlp_plan(8, 8192, 22016, torch.bfloat16, True, 132,
                    slots=lambda cl: 0)
    with pytest.raises(ValueError, match="does not take"):
        lm.mlp_plan(8, 8192, 22016, torch.float32, True, 132, path="tc",
                    body="swap")
    plan = lm.mlp_plan(8, 8192, 22016, torch.bfloat16, True, 132,
                       path="tc", body="swap", cl=12, slots=_slots)
    assert (plan.cl, lm.swap_ds(8192, 12)) == (12, 704)


@pytest.mark.parametrize("M,d,ff", [(8, 2056, 200), (37, 2056, 136),
                                    (1, 264, 72), (64, 136, 200)])
def test_cpu_wrapper_runs_the_plain_version_under_a_swap_plan(M, d, ff):
    """CPU tensors run ``linked_mlp_plain`` whatever the plan names, the
    swap body's included, and launch nothing."""
    rng = np.random.default_rng(M + d)
    x, wg, wu, wd = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                     .bfloat16() for s in ((M, d), (d, ff), (d, ff), (ff, d)))
    plan = lm.mlp_plan(M, d, ff, torch.bfloat16, True, 132, path="tc",
                       body="swap", slots=_slots)
    assert plan.body == "swap"
    kernels.reset_launches()
    assert torch.equal(lm.linked_mlp(x, wg, wu, wd, plan=plan),
                       lm.linked_mlp_plain(x, wg, wu, wd))
    assert all(kernels.LAUNCHES[k] == 0 for k in (
        "linked_mlp", "linked_mlp_tc", "linked_mlp_tc_swap",
        "linked_mlp_tc_prefill"))
