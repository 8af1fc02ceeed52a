"""ROI subsystem unit tests (reference roi_test.go, roi_config_test.go,
roi_mask_test.go, roi_shift_test.go, roi_mask_integration_test.go).

End-to-end ROI codestream behavior lives in test_j2k_features.py; this
file pins the geometry/rasterization/shift primitives in isolation.
"""

import numpy as np
import pytest

from go_dicom_codec_jax.codecs.j2k_roi import (ROIRegion, apply_maxshift,
                                               band_roi_mask, combined_mask,
                                               parse_roi_com,
                                               rasterize_polygon,
                                               unshift_general,
                                               unshift_maxshift,
                                               write_roi_com)


# ---- rasterization ----------------------------------------------------------

def test_rect_rasterize_basic():
    m = ROIRegion(shape="rect", rect=(2, 1, 3, 2)).rasterize(8, 6)
    exp = np.zeros((6, 8), dtype=bool)
    exp[1:3, 2:5] = True
    np.testing.assert_array_equal(m, exp)


def test_rect_rasterize_clamps_to_frame():
    m = ROIRegion(shape="rect", rect=(-2, -2, 100, 100)).rasterize(8, 6)
    assert m.all()


def test_rect_rasterize_fully_outside_is_empty():
    m = ROIRegion(shape="rect", rect=(50, 50, 4, 4)).rasterize(8, 6)
    assert not m.any()


def test_polygon_square_matches_rect():
    """An axis-aligned square polygon fills the same pixels as the rect."""
    poly = [(2, 1), (5, 1), (5, 3), (2, 3)]
    mp = rasterize_polygon(poly, 8, 6)
    mr = ROIRegion(shape="rect", rect=(2, 1, 3, 2)).rasterize(8, 6)
    np.testing.assert_array_equal(mp, mr)


def test_polygon_triangle_area():
    """Scanline fill of a right triangle covers about half the bbox."""
    m = rasterize_polygon([(0, 0), (20, 0), (0, 20)], 20, 20)
    assert 150 < m.sum() < 250  # ideal 200


def test_polygon_degenerate_is_empty():
    assert not rasterize_polygon([(0, 0), (5, 5)], 8, 8).any()
    assert not rasterize_polygon([], 8, 8).any()


def test_polygon_concave_even_odd():
    """A square with a notch (concave) must not fill the notch."""
    poly = [(0, 0), (10, 0), (10, 10), (6, 10), (6, 4), (4, 4), (4, 10),
            (0, 10)]
    m = rasterize_polygon(poly, 12, 12)
    assert m[2, 2] and m[2, 8]
    assert not m[8, 5]  # inside the notch


def test_mask_region_passthrough_and_shape_check():
    mask = np.zeros((6, 8), dtype=bool)
    mask[0, 0] = True
    m = ROIRegion(shape="mask", mask=mask).rasterize(8, 6)
    np.testing.assert_array_equal(m, mask)
    with pytest.raises(ValueError):
        ROIRegion(shape="mask", mask=mask).rasterize(9, 6)


def test_unknown_shape_raises():
    with pytest.raises(ValueError):
        ROIRegion(shape="blob").rasterize(4, 4)


# ---- combination + component filtering --------------------------------------

def test_combined_mask_union():
    r1 = ROIRegion(shape="rect", rect=(0, 0, 2, 2))
    r2 = ROIRegion(shape="rect", rect=(4, 4, 2, 2))
    m = combined_mask([r1, r2], 8, 8)
    assert m[0, 0] and m[5, 5] and not m[3, 3]


def test_combined_mask_component_filter():
    r1 = ROIRegion(shape="rect", rect=(0, 0, 2, 2), components=[0])
    r2 = ROIRegion(shape="rect", rect=(4, 4, 2, 2), components=[1, 2])
    m0 = combined_mask([r1, r2], 8, 8, component=0)
    m1 = combined_mask([r1, r2], 8, 8, component=1)
    assert m0[0, 0] and not m0[5, 5]
    assert m1[5, 5] and not m1[0, 0]


def test_combined_mask_none_components_apply_everywhere():
    r = ROIRegion(shape="rect", rect=(1, 1, 2, 2))
    for comp in (0, 1, 5):
        assert combined_mask([r], 8, 8, component=comp)[1, 1]


# ---- COM metadata roundtrip -------------------------------------------------

def test_roi_com_rect_roundtrip():
    regions = [ROIRegion(shape="rect", rect=(3, 4, 10, 20), components=[0])]
    out = parse_roi_com(write_roi_com(regions, ncomp=3))
    assert len(out) == 1
    assert out[0].shape == "rect" and out[0].rect == (3, 4, 10, 20)
    assert out[0].components == [0]


def test_roi_com_polygon_roundtrip():
    poly = [(0, 0), (9, 1), (5, 8)]
    regions = [ROIRegion(shape="polygon", polygon=poly)]
    out = parse_roi_com(write_roi_com(regions, ncomp=2))
    assert out[0].shape == "polygon"
    assert [tuple(p) for p in out[0].polygon] == poly
    assert out[0].components == [0, 1]  # None expanded to all components


def test_roi_com_mask_encodes_dimensions_only():
    regions = [ROIRegion(shape="mask", mask=np.ones((4, 6), dtype=bool))]
    payload = write_roi_com(regions, ncomp=1)
    out = parse_roi_com(payload)
    assert out == []  # mask regions are a placeholder (reference parity)


def test_roi_com_rejects_foreign_payloads():
    assert parse_roi_com(b"not ours") is None
    assert parse_roi_com(b"JP2ROI\x02\x00\x01") is None  # bad version
    good = write_roi_com([ROIRegion(shape="rect", rect=(0, 0, 1, 1))], 1)
    assert parse_roi_com(good[:12]) is None  # truncated mid-region


# ---- mask → subband projection ----------------------------------------------

def test_band_full_mask_projects_to_full_band():
    full = np.ones((16, 16), dtype=bool)
    m = band_roi_mask(full, 0, 0, num_levels=1, resolution=1, band=1,
                      band_rect_=(0, 0, 8, 8))
    assert m.shape == (8, 8) and m.all()


def test_band_empty_mask_projects_empty():
    full = np.zeros((16, 16), dtype=bool)
    m = band_roi_mask(full, 0, 0, 1, 1, 1, (0, 0, 8, 8))
    assert not m.any()


def test_band_quadrant_mask_localizes():
    """A top-left image-quadrant ROI maps to the band's top-left quadrant."""
    full = np.zeros((16, 16), dtype=bool)
    full[:8, :8] = True
    m = band_roi_mask(full, 0, 0, 1, 1, 0, (0, 0, 8, 8))
    assert m[:4, :4].all()
    assert not m[5:, 5:].any()


def test_band_empty_rect_returns_empty_array():
    m = band_roi_mask(np.ones((8, 8), dtype=bool), 0, 0, 1, 1, 1,
                      (4, 4, 4, 4))
    assert m.size == 0


def test_band_ll_uses_full_decimation():
    """Resolution 0 (LL) decimates by 2^num_levels with no phase offset."""
    full = np.zeros((16, 16), dtype=bool)
    full[0:4, 0:4] = True
    m = band_roi_mask(full, 0, 0, num_levels=2, resolution=0, band=0,
                      band_rect_=(0, 0, 4, 4))
    assert m[0, 0] and not m[2, 2]


# ---- MaxShift / General Scaling shifts --------------------------------------

def test_maxshift_roundtrip_property(rng):
    shift = 7
    coeffs = rng.integers(-127, 128, size=(8, 8)).astype(np.int32)
    mask = np.zeros((8, 8), dtype=bool)
    mask[2:5, 3:6] = True
    shifted = apply_maxshift(coeffs, mask, shift)
    # background magnitudes stay below 2^shift → decoder separates by size
    got = unshift_maxshift(shifted.astype(np.int64), shift)
    np.testing.assert_array_equal(got, coeffs)


def test_maxshift_background_untouched():
    coeffs = np.array([[3, -5], [0, 100]], dtype=np.int32)
    mask = np.zeros((2, 2), dtype=bool)
    out = apply_maxshift(coeffs, mask, 8)
    np.testing.assert_array_equal(out, coeffs)
    np.testing.assert_array_equal(unshift_maxshift(out, 8), coeffs)


def test_unshift_maxshift_preserves_sign():
    shifted = np.array([-(5 << 6), 5 << 6, -3, 3], dtype=np.int64)
    got = unshift_maxshift(shifted, 6)
    np.testing.assert_array_equal(got, [-5, 5, -3, 3])


def test_unshift_general_only_masked():
    v = np.array([[64, 64], [-64, 7]], dtype=np.int64)
    mask = np.array([[True, False], [True, False]])
    got = unshift_general(v, mask, 3)
    np.testing.assert_array_equal(got, [[8, 64], [-8, 7]])
