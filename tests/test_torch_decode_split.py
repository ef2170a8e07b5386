"""How the decode-attention kernel cuts its work, checked on the CPU.

The kernel (``src/repro_torch/csrc/decode_attention.cu``) runs only on
the card; what decides its grid and its pieces is plain arithmetic that
the wrapper and the kernel share:

* ``decode_grid`` picks (query heads per CTA, splits per row) from the
  shapes and the SM count alone;
* ``split_range`` mirrors the kernel's partition of a row's live span
  (the formula in the ``.cu`` header).

The card tests in ``tests/test_torch_cuda.py`` hold the kernel itself to
the plain version on and around these pieces' boundaries.
"""
import pytest
from hypothesis import given, settings, strategies as st

from repro_torch.kernels.decode_attention import ops as t_da

#: the serving path's shape: slots 8, qwen3-1.7b's 8 kv heads of 128, G = 2
MAIN = dict(B=8, K=8, G=2, W=2048, D=128)
#: gemma3-1b's: slots 8, one kv head of 256, G = 4; a global layer's
#: 2048-slot horizon and a sliding layer's 512-slot ring
GEMMA3 = [dict(B=8, K=1, G=4, W=2048, D=256), dict(B=8, K=1, G=4, W=512,
                                                   D=256)]


@pytest.mark.parametrize("shape", [MAIN] + GEMMA3,
                         ids=["qwen3", "gemma3_global", "gemma3_sliding"])
@pytest.mark.parametrize("sms", [108, 114, 132, 144])
def test_grid_fills_the_card_once_at_the_main_shape(sms, shape):
    gt, S = t_da.decode_grid(sms=sms, **shape)
    units = shape["B"] * shape["K"] * shape["G"] // gt
    assert gt == 2 and S >= 1
    assert units * S >= sms                       # every SM has a CTA
    assert units * S <= t_da.CTAS_PER_SM * sms    # one resident wave
    assert units * (S + 1) > t_da.CTAS_PER_SM * sms  # no longer splits
    assert S <= t_da.max_splits(shape["D"], gt)


@pytest.mark.parametrize("D,gt,cap", [(32, 1, 32), (32, 2, 32), (64, 2, 32),
                                      (128, 1, 32), (128, 2, 32),
                                      (256, 1, 32), (256, 2, 24)])
def test_split_cap_fits_the_merge_in_the_ring(D, gt, cap):
    """The last CTA of a row merges S x GT x D fp32 accumulators in the
    kernel's 48 KB ring: only D = 256 at two query heads a CTA lowers the
    cap below 32, and at gemma3's B = 1 the cap binds."""
    assert t_da.max_splits(D, gt) == cap
    assert cap * gt * D * 4 <= t_da.RING_BYTES
    G = 2 if gt == 2 else 1
    assert t_da.decode_grid(1, 1, G, 2048, 132, D) == (gt, cap)


@settings(max_examples=300, deadline=None)
@given(B=st.integers(1, 64), K=st.integers(1, 16),
       G=st.sampled_from([1, 2, 3, 4, 8]), W=st.integers(1, 40000),
       sms=st.integers(1, 200), D=st.sampled_from(t_da.HEAD_DIMS))
def test_grid_is_a_pure_function_of_the_shapes(B, K, G, W, sms, D):
    gt, S = t_da.decode_grid(B, K, G, W, sms, D)
    assert (gt, S) == t_da.decode_grid(B, K, G, W, sms, D)
    assert gt in (1, 2) and G % gt == 0 and (gt == 2) == (G % 2 == 0)
    assert 1 <= S <= t_da.max_splits(D, gt) <= t_da.MAX_SPLITS
    assert S <= max(1, -(-W // t_da.MIN_SPLIT_SLOTS))
    units = B * K * (G // gt)
    capped = S in (t_da.max_splits(D, gt), -(-W // t_da.MIN_SPLIT_SLOTS))
    # the splits are as short as one wave of CTAs allows, and no shorter
    assert capped or units * (S + 1) > t_da.CTAS_PER_SM * sms
    assert S == 1 or units * S <= t_da.CTAS_PER_SM * sms


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
