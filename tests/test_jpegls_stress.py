"""JPEG-LS large-image and edge-content stress tests.

Role of reference jpegls/lossless/{very_large,wide,large_8bit}_test.go
and the run-mode/interrupt edge suites: big frames, extreme aspect
ratios, run-mode-heavy flat content, bias-corrector stress, and every
bit depth — all bit-exact.
"""

import numpy as np
import pytest

from go_dicom_codec_jax.codecs import jpegls as jls


def _roundtrip(img, bits, near=0):
    h, w = img.shape[:2]
    comps = 1 if img.ndim == 2 else img.shape[2]
    stream = jls.encode(np.ascontiguousarray(img).tobytes(), w, h, comps,
                        bits, near=near)
    px, rw, rh, rc, rbits, rnear = jls.decode(stream)
    got = np.frombuffer(px, dtype=img.dtype).reshape(img.shape)
    if near == 0:
        np.testing.assert_array_equal(got, img)
    else:
        assert np.abs(got.astype(np.int64)
                      - img.astype(np.int64)).max() <= near
    return stream


def test_very_large_image(rng):
    """1024x1024 16-bit (very_large_test.go scale)."""
    img = (np.cumsum(rng.integers(-50, 51, (1024, 1024)), axis=1)
           % 65536).astype("<u2")
    _roundtrip(img, 16)


def test_wide_image(rng):
    """Extreme aspect ratio (wide_test.go)."""
    img = (np.cumsum(rng.integers(-5, 6, (8, 4096)), axis=1)
           % 256).astype(np.uint8)
    _roundtrip(img, 8)


def test_tall_image(rng):
    img = (np.cumsum(rng.integers(-5, 6, (4096, 8)), axis=0)
           % 256).astype(np.uint8)
    _roundtrip(img, 8)


def test_large_8bit(rng):
    img = rng.integers(0, 256, (768, 768)).astype(np.uint8)
    _roundtrip(img, 8)


def test_flat_image_run_mode():
    """Constant frames exercise maximal run lengths."""
    img = np.full((256, 256), 113, dtype=np.uint8)
    stream = _roundtrip(img, 8)
    assert len(stream) < 1200  # run mode compresses a flat frame hard


def test_stripes_run_interrupts():
    """Alternating flat stripes hit run-interrupt coding constantly."""
    img = np.zeros((128, 128), dtype=np.uint8)
    img[:, ::2] = 200
    _roundtrip(img, 8)


def test_vertical_gradient_bias_correction():
    img = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 64, axis=1)
    _roundtrip(img, 8)


def test_checkerboard_worst_case(rng):
    y, x = np.mgrid[0:128, 0:128]
    img = (((x + y) & 1) * 255).astype(np.uint8)
    _roundtrip(img, 8)


@pytest.mark.parametrize("bits", [2, 4, 6, 10, 14, 16])
def test_unusual_bit_depths(bits, rng):
    img = rng.integers(0, 1 << bits, (64, 64)).astype(
        np.uint8 if bits <= 8 else "<u2")
    _roundtrip(img, bits)


@pytest.mark.parametrize("near", [1, 2, 5, 9])
def test_near_lossless_large(near, rng):
    img = (np.cumsum(rng.integers(-9, 10, (512, 512)), axis=1)
           % 4096).astype("<u2")
    _roundtrip(img, 12, near=near)


def test_rgb_large_interleaved(rng):
    img = (np.cumsum(rng.integers(-5, 6, (256, 256, 3)), axis=1)
           % 256).astype(np.uint8)
    _roundtrip(img, 8)


def test_single_pixel_and_single_row(rng):
    _roundtrip(np.asarray([[200]], dtype=np.uint8), 8)
    _roundtrip(rng.integers(0, 256, (1, 300)).astype(np.uint8), 8)
    _roundtrip(rng.integers(0, 256, (300, 1)).astype(np.uint8), 8)


def test_extreme_values_16bit():
    img = np.zeros((64, 64), dtype="<u2")
    img[::2, ::2] = 65535
    _roundtrip(img, 16)
