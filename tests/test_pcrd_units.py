"""PCRD layer-allocation unit tests (reference rate_distortion_test.go,
pcrd_opt_test.go, pcrd_target_ratio_precision_test.go, target_ratio_test.go).

End-to-end multi-layer codestream behavior lives in test_termall_layers.py
and test_jpeg2000_lossy.py; this file pins the slope/threshold machinery.
"""

import numpy as np
import pytest

from go_dicom_codec_jax.t2.pcrd import (PassPoint, allocate_layers,
                                        layer_budgets_from_rates, pass_slopes)


# ---- convex-hull pass slopes ------------------------------------------------

def test_pass_slopes_empty():
    assert pass_slopes([], []) == []


def test_pass_slopes_preserve_rates():
    rates = [10, 25, 60]
    pts = pass_slopes(rates, [5, 4, 3])
    assert [p.rate for p in pts] == rates


def test_hull_slopes_non_increasing(rng):
    """Slopes at hull points must be non-increasing in pass order."""
    for _ in range(20):
        n = int(rng.integers(1, 12))
        rates = np.cumsum(rng.integers(1, 50, size=n)).tolist()
        bps = sorted(rng.integers(0, 10, size=n).tolist(), reverse=True)
        pts = pass_slopes(rates, bps)
        slopes = [p.slope for p in pts]
        finite = [s for s in slopes if s != float("inf")]
        # after hulling, each finalized slope step can only decrease
        hull_steps = []
        for s in finite:
            if not hull_steps or s != hull_steps[-1]:
                hull_steps.append(s)
        assert hull_steps == sorted(hull_steps, reverse=True)


def test_higher_bitplane_pass_has_steeper_slope():
    """Equal byte costs: the higher-bitplane pass drops more distortion."""
    pts = pass_slopes([10, 20], [8, 2])
    assert pts[0].slope > pts[1].slope


def test_nmsedec_distortion_weighting():
    """With NMSEDEC data, slope scales linearly with the band weight."""
    a = pass_slopes([10], [3], pass_nmsedecs=[100], weight=1.0)
    b = pass_slopes([10], [3], pass_nmsedecs=[100], weight=2.0)
    assert b[0].slope == pytest.approx(2 * a[0].slope)


def test_nmsedec_zero_pass_contributes_no_distortion():
    pts = pass_slopes([10, 20], [5, 5], pass_nmsedecs=[50, 0])
    assert pts[1].slope < pts[0].slope


# ---- threshold layer allocation ---------------------------------------------

def _block(rates, slopes):
    return [PassPoint(rate=r, slope=s) for r, s in zip(rates, slopes)]


def test_allocate_single_layer_take_all():
    blocks = [_block([10, 20], [5.0, 1.0]), _block([5], [9.0])]
    out = allocate_layers(blocks, budgets=[0])
    assert out == [[2], [1]]  # zero-budget final layer ships everything


def test_allocate_respects_budget():
    blocks = [_block([10, 20, 30], [9.0, 5.0, 1.0]),
              _block([10, 20, 30], [8.0, 4.0, 0.5])]
    out = allocate_layers(blocks, budgets=[25, 0])
    taken = sum(b[c - 1].rate for b, (c, _) in zip(blocks, out) if c)
    assert taken <= 25
    # final layer still ships everything
    assert [c[-1] for c in out] == [3, 3]


def test_allocate_counts_monotone_across_layers():
    blocks = [_block([8, 16, 32], [9.0, 4.0, 2.0]),
              _block([4, 12], [7.0, 3.0])]
    out = allocate_layers(blocks, budgets=[10, 40, 0])
    for per_block in out:
        assert per_block == sorted(per_block)


def test_allocate_highest_slope_first():
    """With a tight budget only the steepest-slope block contributes."""
    blocks = [_block([10], [100.0]), _block([10], [1.0])]
    out = allocate_layers(blocks, budgets=[12, 0])
    assert out[0][0] == 1 and out[1][0] == 0


def test_allocate_budgeted_final_layer_truncates():
    """Target-ratio mode: a budgeted final layer keeps its truncation."""
    blocks = [_block([10, 20, 30], [9.0, 5.0, 1.0])]
    out = allocate_layers(blocks, budgets=[15])
    assert out[0][0] < 3
    assert blocks[0][out[0][0] - 1].rate <= 15


def test_allocate_with_measured_bytes_shrinks_selection():
    """A measure() that adds per-packet overhead admits fewer passes."""
    blocks = [_block([10, 20, 30], [9.0, 5.0, 1.0])]

    def plain(layers):
        counts = layers[-1]
        return sum(blocks[i][c - 1].rate for i, c in enumerate(counts) if c)

    def with_header(layers):
        return plain(layers) + 12

    free = allocate_layers(blocks, budgets=[22], measure=plain)
    taxed = allocate_layers(blocks, budgets=[22], measure=with_header)
    assert taxed[0][0] <= free[0][0]
    assert free[0][0] == 2 and taxed[0][0] == 1


def test_allocate_impossible_budget_takes_nothing():
    blocks = [_block([100], [5.0])]
    out = allocate_layers(blocks, budgets=[3, 0])
    assert out[0][0] == 0 and out[0][1] == 1


# ---- ratio → budget conversion ----------------------------------------------

def test_budgets_from_rates_basic():
    # 100×100 @8bpp = 10000 raw bytes; ratios 10:1 then 5:1
    got = layer_budgets_from_rates(10000, 8, [10, 5], available=100000)
    assert got == [1000, 2000]


def test_budgets_trailing_zero_is_take_all_sentinel():
    got = layer_budgets_from_rates(10000, 8, [10, 0], available=100000)
    assert got == [1000, 0]


def test_budgets_intermediate_zero_becomes_available():
    got = layer_budgets_from_rates(10000, 8, [0, 5], available=1500)
    assert got == [1500, 1500]


def test_budgets_monotone_and_capped():
    got = layer_budgets_from_rates(10000, 8, [2, 10, 1], available=3000)
    assert got == sorted(got)
    assert all(b <= 3000 for b in got)


def test_budgets_bit_depth_scales_raw_size():
    b8 = layer_budgets_from_rates(10000, 8, [10], available=10**6)
    b16 = layer_budgets_from_rates(10000, 16, [10], available=10**6)
    assert b16[0] == 2 * b8[0]
