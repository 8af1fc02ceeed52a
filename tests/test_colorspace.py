"""Color transform unit tests.

Role of reference jpeg2000/colorspace/{rct,ict,rgb}_test.go (424 LoC):
RCT integer exactness, ICT forward/inverse accuracy, classic YCbCr
fixed-point behavior, and the DC level-shift pair — on random data,
extremes, and known vectors.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from go_dicom_codec_jax.ops.dct8x8 import (rgb_to_ycbcr, rgb_to_ycbcr_np,
                                           ycbcr_to_rgb, ycbcr_to_rgb_np)
from go_dicom_codec_jax.ops.mct import (dc_level_shift, ict_forward,
                                        ict_inverse, inv_dc_level_shift,
                                        rct_forward, rct_inverse)


def _rand_rgb(rng, lo, hi, shape=(16, 16)):
    return [jnp.asarray(rng.integers(lo, hi, shape).astype(np.int32))
            for _ in range(3)]


def test_rct_perfect_reconstruction(rng):
    r, g, b = _rand_rgb(rng, 0, 256)
    y, u, v = rct_forward(r, g, b)
    r2, g2, b2 = rct_inverse(y, u, v)
    np.testing.assert_array_equal(np.asarray(r2), np.asarray(r))
    np.testing.assert_array_equal(np.asarray(g2), np.asarray(g))
    np.testing.assert_array_equal(np.asarray(b2), np.asarray(b))


def test_rct_perfect_reconstruction_16bit(rng):
    r, g, b = _rand_rgb(rng, -32768, 32768)
    y, u, v = rct_forward(r, g, b)
    r2, g2, b2 = rct_inverse(y, u, v)
    np.testing.assert_array_equal(np.asarray(r2), np.asarray(r))
    np.testing.assert_array_equal(np.asarray(g2), np.asarray(g))
    np.testing.assert_array_equal(np.asarray(b2), np.asarray(b))


def test_rct_known_vector():
    """G.1 formulas on hand-computed values (rct.go:6-26 semantics)."""
    r = jnp.asarray([[100]]); g = jnp.asarray([[150]])
    b = jnp.asarray([[200]])
    y, u, v = rct_forward(r, g, b)
    # Y = (100 + 300 + 200) >> 2 = 150; U = 200-150 = 50; V = 100-150
    assert int(y[0, 0]) == 150
    assert int(u[0, 0]) == 50
    assert int(v[0, 0]) == -50


def test_rct_gray_input_zero_chroma():
    v = jnp.full((4, 4), 77)
    y, u, w = rct_forward(v, v, v)
    assert int(jnp.abs(u).max()) == 0 and int(jnp.abs(w).max()) == 0
    np.testing.assert_array_equal(np.asarray(y), np.asarray(v))


def test_rct_negative_floor_semantics():
    """(R + 2G + B) >> 2 floors toward -inf like the Go >> operator."""
    r = jnp.asarray([[-1]]); g = jnp.asarray([[-1]]); b = jnp.asarray([[-1]])
    y, u, v = rct_forward(r, g, b)
    assert int(y[0, 0]) == -1  # (-4) >> 2


def test_ict_roundtrip_error_bounded(rng):
    r, g, b = _rand_rgb(rng, 0, 4096)
    y, cb, cr = ict_forward(r, g, b)
    r2, g2, b2 = ict_inverse(y, cb, cr)
    for a, a2 in ((r, r2), (g, g2), (b, b2)):
        err = np.abs(np.asarray(a2) - np.asarray(a).astype(np.float32))
        assert err.max() < 1.0  # float ICT reconstructs within rounding


def test_ict_luma_weights_sum_to_one():
    one = jnp.ones((2, 2))
    y, cb, cr = ict_forward(one, one, one)
    # float32 T.800 coefficients don't sum exactly to 0/1
    np.testing.assert_allclose(np.asarray(y), 1.0, atol=2e-5)
    np.testing.assert_allclose(np.asarray(cb), 0.0, atol=2e-5)
    np.testing.assert_allclose(np.asarray(cr), 0.0, atol=2e-5)


def test_ycbcr_device_host_bit_identical(rng):
    rgb = rng.integers(0, 256, (32, 24, 3)).astype(np.uint8)
    dev = np.asarray(rgb_to_ycbcr(jnp.asarray(rgb)))
    host = rgb_to_ycbcr_np(rgb)
    np.testing.assert_array_equal(dev, host)
    dev2 = np.asarray(ycbcr_to_rgb(jnp.asarray(dev)))
    host2 = ycbcr_to_rgb_np(host)
    np.testing.assert_array_equal(dev2, host2)


def test_ycbcr_roundtrip_error_bounded(rng):
    rgb = rng.integers(0, 256, (32, 24, 3)).astype(np.uint8)
    back = ycbcr_to_rgb_np(rgb_to_ycbcr_np(rgb))
    err = np.abs(back.astype(int) - rgb.astype(int))
    assert err.max() <= 2  # JFIF fixed-point roundtrip bound


def test_ycbcr_known_primaries():
    """Pure primaries map to the classic JFIF code points."""
    prim = np.array([[[255, 0, 0], [0, 255, 0], [0, 0, 255],
                      [255, 255, 255], [0, 0, 0]]], dtype=np.uint8)
    ycc = rgb_to_ycbcr_np(prim)
    # luma of white = 255, black = 0; red luma ~76, green ~150, blue ~29
    assert ycc[0, 3, 0] == 255 and ycc[0, 4, 0] == 0
    assert abs(int(ycc[0, 0, 0]) - 76) <= 1
    assert abs(int(ycc[0, 1, 0]) - 150) <= 1
    assert abs(int(ycc[0, 2, 0]) - 29) <= 1
    # white/black have neutral chroma
    assert ycc[0, 3, 1] == 128 and ycc[0, 3, 2] == 128


@pytest.mark.parametrize("bits,signed", [(8, False), (12, False),
                                         (16, False), (16, True)])
def test_dc_level_shift_roundtrip(bits, signed, rng):
    lo, hi = (-(1 << (bits - 1)), 1 << (bits - 1)) if signed \
        else (0, 1 << bits)
    x = jnp.asarray(rng.integers(lo, hi, (8, 8)).astype(np.int32))
    s = dc_level_shift(x, bits, signed)
    if signed:
        np.testing.assert_array_equal(np.asarray(s), np.asarray(x))
    else:
        assert int(jnp.max(s)) < (1 << (bits - 1))
    back = inv_dc_level_shift(s, bits, signed)
    np.testing.assert_array_equal(np.asarray(back), np.asarray(x))
