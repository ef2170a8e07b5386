"""``linked_mlp``'s prefill body and its bf16 check, on the CPU.

The tensor-core kernel (``src/repro_torch/csrc/linked_mlp.cu``) has two
bodies: ``decode`` (64-row tiles) and ``prefill`` (128-row tiles, a TMA
ring, two consumer warpgroups).  They run only on the card; here:

* the bf16 check both are held to (``mlp_reference``): two correct fp32
  summation orders each pass it where the old element-wise limit between
  them fails, and planted faults fail it;
* ``mlp_plan`` picks the body by rows at every registered SwiGLU width;
* the prefill body's grid covers y once and deals every ff block once;
* on CPU tensors the wrapper runs the plain version whatever the plan.

The card tests in ``tests/test_torch_cuda.py`` launch the body.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import kernels
from repro_torch.configs.base import all_configs
from repro_torch.kernels.linked_matmul import ops as lm

#: the old bf16 check: |kernel - plain| <= atol + rtol |plain| element-wise
OLD_TOL = dict(rtol=2e-2, atol=1e-3)
#: a seed at (37, 256, 208) where the plain version and the 64-deep
#: stepped order land more than the old limit apart (1.19 of it)
OLD_LIMIT_FAILS = 35


def _inputs(seed, M, d, ff):
    """x ~ N(0, 1), weights at the fan-in scale, made with numpy, bf16."""
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(a.astype(np.float32)).bfloat16() for a in (
        rng.standard_normal((M, d)), rng.standard_normal((d, ff)) / d ** 0.5,
        rng.standard_normal((d, ff)) / d ** 0.5,
        rng.standard_normal((ff, d)) / ff ** 0.5))


def _stepped(x, wg, wu, wd, step=64):
    """The kernel's order: up-projections summed in ``step``-deep slices,
    each folded into fp32 accumulators in k order; h rounded to bf16; the
    down-projection folded a 64-row block of Wd at a time."""
    xf, gf, uf, df = (a.float() for a in (x, wg, wu, wd))
    g = torch.zeros(x.shape[0], wg.shape[1])
    u = torch.zeros_like(g)
    for k in range(0, x.shape[1], step):
        g = g + xf[:, k:k + step] @ gf[k:k + step]
        u = u + xf[:, k:k + step] @ uf[k:k + step]
    h = (F.silu(g) * u).to(x.dtype).float()
    y = torch.zeros(x.shape[0], wd.shape[1])
    for j in range(0, h.shape[1], 64):
        y = y + h[:, j:j + 64] @ df[j:j + 64]
    return y.to(x.dtype)


def _old_err(got, plain):
    got, plain = got.float(), plain.float()
    return ((got - plain).abs()
            / (OLD_TOL["atol"] + OLD_TOL["rtol"] * plain.abs())).max().item()


def _faults(x, wg, wu, wd):
    """The planted faults, each fed through the stepped order: the last d
    term and the last ff column left out, and the ones the card's checks
    plant: the d term of the largest |x| and the ff column whose h is
    largest left out."""
    x_last, x_big = x.clone(), x.clone()
    x_last[:, -1] = 0
    x_big[:, x.float().abs().amax(0).argmax()] = 0
    last, big = wd.clone(), wd.clone()
    last[-1] = 0
    big[(F.silu(x.float() @ wg.float()) * (x.float() @ wu.float())).abs()
        .amax(0).argmax()] = 0
    return {"d_term": _stepped(x_last, wg, wu, wd),
            "ff_column": _stepped(x, wg, wu, last),
            "largest_d_term": _stepped(x_big, wg, wu, wd),
            "largest_ff_column": _stepped(x, wg, wu, big)}


@pytest.mark.parametrize("shape", [(37, 256, 208), (5, 136, 200)])
def test_correct_orders_pass_and_planted_faults_fail_the_check(shape):
    """On 64 seeds each: the plain version and the 64-deep stepped order
    are within ``mlp_reference``'s limit (the fp64 sum plus one bf16 step
    of each h element a correct order can round apart), and every planted
    fault is outside it."""
    for seed in range(64):
        args = _inputs(seed, *shape)
        ref, limit = lm.mlp_reference(*args)
        for label, got in (("plain", lm.linked_mlp_plain(*args)),
                           ("stepped", _stepped(*args))):
            assert lm.reference_err(got, ref, limit) <= 1.0, (seed, label)
        for label, got in _faults(*args).items():
            assert lm.reference_err(got, ref, limit) > 1.0, (seed, label)


def test_the_old_limit_fails_between_two_correct_orders():
    """The element-wise limit between kernel and plain version fails on a
    named seed although both orders are correct: h rounds to bf16 from
    fp32 sums taken in different orders, and one bf16 step of h carried
    through Wd exceeds it where |y| is small.  The new check passes both
    there."""
    args = _inputs(OLD_LIMIT_FAILS, 37, 256, 208)
    plain, stepped = lm.linked_mlp_plain(*args), _stepped(*args)
    assert _old_err(stepped, plain) > 1.0
    ref, limit = lm.mlp_reference(*args)
    assert max(lm.reference_err(plain, ref, limit),
               lm.reference_err(stepped, ref, limit)) <= 1.0


def _reach_units(x, wg, wu):
    """|h_order - h_fp64| over one unit of ``h_rounding_slack``'s reach
    (2^-24 sqrt(d) times each sum's terms' 2-norm, carried through
    silu(g) u), worst over the elements, for the plain version's and the
    16- and 64-deep stepped orders' fp32 h."""
    x64, g64, u64 = (a.double() for a in (x, wg, wu))
    g, u = x64 @ g64, x64 @ u64
    h64 = F.silu(g) * u
    sig = torch.sigmoid(g)
    x2 = x64 * x64
    unit = 2.0 ** -24 * x.shape[-1] ** 0.5 * (
        (sig * (1 + g * (1 - sig)) * u).abs() * (x2 @ (g64 * g64)).sqrt()
        + (g * sig).abs() * (x2 @ (u64 * u64)).sqrt())
    xf, gf, uf = x.float(), wg.float(), wu.float()
    orders = [F.silu(xf @ gf) * (xf @ uf)]
    for step in (16, 64):
        gs, us = torch.zeros_like(orders[0]), torch.zeros_like(orders[0])
        for k in range(0, x.shape[1], step):
            gs = gs + xf[:, k:k + step] @ gf[k:k + step]
            us = us + xf[:, k:k + step] @ uf[k:k + step]
        orders.append(F.silu(gs) * us)
    return max(((h.double() - h64).abs() / unit).max().item()
               for h in orders)


@pytest.mark.parametrize("shape", [(37, 256, 208), (5, 136, 200),
                                   (4, 2048, 512)])
def test_fp32_orders_stay_well_inside_the_reach(shape):
    """The slack's reach, H_ORDER_MARGIN units, is over four times what
    the plain version and stepped fp32 orders move h from its fp64 value
    on 8 seeds."""
    worst = max(_reach_units(*_inputs(seed, *shape)[:3]) for seed in range(8))
    assert worst < lm.H_ORDER_MARGIN / 4


def test_the_full_slack_cannot_see_a_dropped_ff_column():
    """Why the slack counts only h near a rounding midpoint: at qwen3's
    decode widths, one bf16 step of every h element through |Wd| passes
    the last ff column left out, which the restricted slack fails."""
    x, wg, wu, wd = _inputs(0, 8, 2048, 6144)
    ref, limit = lm.mlp_reference(x, wg, wu, wd)
    x64, g64, u64 = (a.double() for a in (x, wg, wu))
    every = lm._bf16_ulp(F.silu(x64 @ g64) * (x64 @ u64)) @ wd.double().abs()
    full = 1e-3 + 2e-2 * ref.abs() + every
    cut = wd.clone()
    cut[-1] = 0
    fault = _stepped(x, wg, wu, cut)
    assert lm.reference_err(fault, ref, full) < 1.0
    assert lm.reference_err(fault, ref, limit) > 1.0
    assert lm.reference_err(lm.linked_mlp_plain(x, wg, wu, wd), ref,
                            limit) <= 1.0


def test_the_slack_counts_only_h_near_a_rounding_midpoint():
    """``h_rounding_slack`` is at most the sum over every h element and
    zero where no h element can round apart (x all zero); a larger reach
    never shrinks it."""
    x, wg, wu, wd = _inputs(3, 9, 136, 200)
    slack = lm.h_rounding_slack(x, wg, wu, wd)
    x64, g64, u64 = (a.double() for a in (x, wg, wu))
    h = F.silu(x64 @ g64) * (x64 @ u64)
    every = lm._bf16_ulp(h) @ wd.double().abs()
    assert slack.shape == (9, 136) and (slack <= every).all()
    assert 0 < slack.sum() < every.sum()
    assert (lm.h_rounding_slack(torch.zeros_like(x), wg, wu, wd) == 0).all()
    margin = lm.H_ORDER_MARGIN
    try:
        lm.H_ORDER_MARGIN = 4 * margin
        assert (lm.h_rounding_slack(x, wg, wu, wd) >= slack).all()
    finally:
        lm.H_ORDER_MARGIN = margin


def _swiglu_widths():
    """(d, ff) of every registered config whose FFN is a SwiGLU on the
    ``linked_matmul`` site (an MoE's only with a dense residual)."""
    out = set()
    for cfg in all_configs().values():
        if cfg.family == "moe" and not cfg.moe_dense_residual:
            continue
        if cfg.d_ff and cfg.family not in ("audio", "ssm"):
            out.add((cfg.d_model, cfg.d_ff))
    return sorted(out)


def test_every_swiglu_width_is_registered():
    assert [d for d, _ in _swiglu_widths()] == [1152, 1600, 2048, 4096,
                                                4096, 6144, 7168, 8192]


@pytest.mark.parametrize("d,ff", _swiglu_widths())
@pytest.mark.parametrize("sms", [114, 132])
def test_mlp_plan_picks_the_body_by_rows(d, ff, sms):
    """The prefill body from ``PREFILL_ROWS`` rows on (128-row tiles, 128
    columns a CTA); below, the swap body up to 32 rows at every width and
    up to 64 past d 2048 where one cluster covers d at 64 rows (d 4096),
    the decode body for the rest (64-row tiles, 256 columns)."""
    t = lm.PREFILL_ROWS
    for M in (1, 8, 32, 33, 64, t - 1, t, t + 1, 256, 4352, 31744):
        plan = lm.mlp_plan(M, d, ff, torch.bfloat16, True, sms)
        want = "prefill" if M >= t else "swap" if (
            M <= 32 or 2048 < d <= 4096) else "decode"
        assert (plan.path, plan.body) == ("tc", want), M
        if want == "swap":
            assert plan.bm == lm.swap_rows(M)
            assert plan.cl in lm.swap_clusters(M, d)
            continue
        assert plan.bm == (lm.TP_BM if want == "prefill" else lm.TC_BM)
        ds = lm.TP_DS if want == "prefill" else lm.TC_DS
        assert plan.cl in lm.tc_clusters(d, ds)


def _covers(plan, M, d, ff):
    """Every row, every column of d and every ff block once."""
    ds = lm.TP_DS if plan.body == "prefill" else lm.TC_DS
    cols = np.zeros(d, np.int32)
    for _, _, c0, c1 in lm.tc_columns(d, plan.cl, ds):
        cols[c0:c1] += 1
    assert (cols == 1).all()
    assert -(-M // plan.bm) * plan.bm >= M > (-(-M // plan.bm) - 1) * plan.bm
    n_blocks = -(-ff // lm.TC_BF)
    owned = np.zeros(n_blocks, np.int32)
    for s in range(plan.S):
        jb0, jb1 = lm.split_blocks(n_blocks, plan.S, s)
        assert jb1 > jb0
        for r in range(-(-(jb1 - jb0) // plan.cl)):
            for c in range(plan.cl):
                if jb0 + r * plan.cl + c < jb1:
                    owned[jb0 + r * plan.cl + c] += 1
    assert (owned == 1).all()


@pytest.mark.parametrize("M", [1, 127, 128, 129, 4352])
@pytest.mark.parametrize("d,ff", [(2048, 6144), (2056, 6144),
                                  (4104, 13704), (1152, 6912), (1600, 5504)])
def test_prefill_grid_covers_y_and_deals_each_block_once(M, d, ff):
    """The prefill body forced at ragged M (a tile of one row, either side
    of the 128-row tile) and ragged d (one 128-column block past 2048; a
    width no cluster's ranks divide): the grid covers y once and every
    split deals each ff block to one rank in one round."""
    plan = lm.mlp_plan(M, d, ff, torch.bfloat16, True, 132, path="tc",
                       body="prefill")
    assert plan.body == "prefill" and plan.bm == lm.TP_BM
    _covers(plan, M, d, ff)


@pytest.mark.parametrize("M,wave", [(128, 7), (256, 7), (512, 7),
                                    (4352, 7), (4352, 2), (31744, 7)])
def test_prefill_workspace_only_when_ff_splits(M, wave):
    """S > 1 (the M tiles do not fill a wave of clusters) goes through an
    (S, M, d) fp32 workspace; S = 1 stores y directly, with none."""
    plan = lm.mlp_plan(M, 2048, 6144, torch.bfloat16, True, 132,
                       slots=lambda cl: wave)
    assert plan.body == "prefill"
    assert plan.workspace == (plan.S * M * 2048 if plan.S > 1 else 0)
    assert (plan.S > 1) == (-(-M // lm.TP_BM) * -(-2048 // (lm.TP_DS *
                                                              plan.cl))
                            < wave)


def test_cpu_wrapper_runs_the_plain_version_on_either_body():
    """On CPU tensors no kernel launches, whatever body the plan names."""
    x, wg, wu, wd = _inputs(0, 130, 64, 96)
    kernels.reset_launches()
    want = lm.linked_mlp_plain(x, wg, wu, wd)
    for body in ("decode", "prefill"):
        plan = lm.mlp_plan(130, 64, 96, torch.bfloat16, True, 132,
                           path="tc", body=body)
        assert plan.body == body
        assert torch.equal(lm.linked_mlp(x, wg, wu, wd, plan=plan), want)
    plan = lm.mlp_plan(64, 64, 96, torch.bfloat16, True, 132, path="tc",
                       body="swap")
    assert plan.body == "swap"
    assert torch.equal(lm.linked_mlp(x[:64], wg, wu, wd, plan=plan),
                       lm.linked_mlp_plain(x[:64], wg, wu, wd))
    assert all(kernels.LAUNCHES[k] == 0 for k in (
        "linked_mlp", "linked_mlp_tc", "linked_mlp_tc_prefill",
        "linked_mlp_tc_swap"))
