"""RGB JPEG 2000 decode behaviors.

Mirrors reference jpeg2000/decoder_rgb_test.go: basic sizes, component
counts, multiple bit depths, decomposition levels, solid colors, and
color bars, all through the public encoder/decoder pair.
"""

import numpy as np
import pytest

from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder, J2KEncodeParams,
                                                J2KEncoder)


@pytest.fixture
def rng():
    return np.random.default_rng(20260817)


def _roundtrip(img, depth=8, **kw):
    h, w, c = img.shape
    dt = "<u1" if depth <= 8 else "<u2"
    stream = J2KEncoder(J2KEncodeParams(**kw)).encode(
        img.astype(dt).tobytes(), w, h, c, depth)
    arr, siz, _ = J2KDecoder().decode(stream)
    assert (siz.xsiz, siz.ysiz, len(siz.components)) == (w, h, c)
    assert arr.shape == (h, w, c)
    return arr


@pytest.mark.parametrize("size", [8, 16, 32])
def test_rgb_basic_sizes(rng, size):
    """decoder_rgb_test.go TestDecoderRGBBasic: dims + 3 components."""
    img = rng.integers(0, 256, (size, size, 3))
    arr = _roundtrip(img)
    np.testing.assert_array_equal(arr, img)


@pytest.mark.parametrize("depth", [8, 10, 12, 16])
def test_rgb_multiple_bit_depths(rng, depth):
    """decoder_rgb_test.go TestDecoderRGBMultipleBitDepths."""
    img = rng.integers(0, 1 << depth, (16, 16, 3))
    arr = _roundtrip(img, depth=depth)
    np.testing.assert_array_equal(arr, img)


@pytest.mark.parametrize("levels", [0, 1, 3, 5])
def test_rgb_with_levels(rng, levels):
    """decoder_rgb_test.go TestDecoderRGBWithLevels: every decomposition
    depth reconstructs losslessly."""
    img = rng.integers(0, 256, (32, 32, 3))
    arr = _roundtrip(img, num_levels=levels)
    np.testing.assert_array_equal(arr, img)


@pytest.mark.parametrize("color", [(0, 0, 0), (255, 255, 255),
                                   (255, 0, 0), (0, 255, 0), (0, 0, 255),
                                   (128, 128, 128)])
def test_solid_color_rgb(color):
    """decoder_rgb_test.go TestSolidColorRGB: RCT must be exactly
    invertible on constant planes (catches sign/bias errors)."""
    img = np.broadcast_to(np.array(color), (16, 16, 3)).copy()
    arr = _roundtrip(img)
    np.testing.assert_array_equal(arr, img)


def test_color_bars_rgb():
    """decoder_rgb_test.go TestColorBarsRGB: hard vertical edges between
    saturated hues survive the multilevel 5/3 + RCT path bit-exact."""
    bars = [(255, 255, 255), (255, 255, 0), (0, 255, 255), (0, 255, 0),
            (255, 0, 255), (255, 0, 0), (0, 0, 255), (0, 0, 0)]
    img = np.zeros((32, 64, 3), dtype=np.int64)
    for i, c in enumerate(bars):
        img[:, i * 8:(i + 1) * 8] = c
    arr = _roundtrip(img)
    np.testing.assert_array_equal(arr, img)


def test_component_interleaving(rng):
    """decoder_rgb_test.go TestComponentInterleaving: distinct per-plane
    patterns come back on the right component (no plane swap)."""
    img = np.zeros((8, 8, 3), dtype=np.int64)
    img[..., 0] = np.arange(64).reshape(8, 8)
    img[..., 1] = 100
    img[..., 2] = np.arange(64).reshape(8, 8)[::-1]
    arr = _roundtrip(img)
    np.testing.assert_array_equal(arr, img)
