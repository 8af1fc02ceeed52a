"""Large/odd-size wavelet roundtrip sweeps.

Role of reference jpeg2000/wavelet/wavelet_256_test.go (192/256 multi-
level perfect-reconstruction checks) widened to a size ladder, odd
dimensions, odd parities, and deep level counts — every case must
reconstruct bit-exactly (reversible 5/3) on the batched jnp path and,
where available, the native host mirror.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from go_dicom_codec_jax.ops.dwt53 import (fwd53_multilevel,
                                          inv53_multilevel, ll_dimensions)


def _gradient(h, w):
    y, x = np.mgrid[0:h, 0:w]
    return ((x + y) % 256).astype(np.int32)


@pytest.mark.parametrize("size", [192, 256])
@pytest.mark.parametrize("levels", [1, 3, 5])
def test_wavelet_large_square_roundtrip(size, levels):
    data = _gradient(size, size)
    c = fwd53_multilevel(jnp.asarray(data), levels)
    rec = np.asarray(inv53_multilevel(c, levels))
    np.testing.assert_array_equal(rec, data)


@pytest.mark.parametrize("shape", [
    (256, 192), (192, 256), (255, 255), (257, 255), (253, 1), (1, 253),
    (129, 127), (96, 33),
])
def test_wavelet_odd_rect_roundtrip(shape, rng):
    # levels=5 subsumes the shallow cases (the multilevel is a loop of
    # single-level transforms over the shrinking LL, so it exercises the
    # level-1/2 structures on intermediate parities); the full level
    # ladder runs once on a representative odd shape below — each extra
    # (shape, levels) pair is a fresh multi-second XLA compile.
    h, w = shape
    data = rng.integers(-2048, 2048, (h, w)).astype(np.int32)
    for levels in ((1, 2, 5) if shape == (129, 127) else (5,)):
        c = fwd53_multilevel(jnp.asarray(data), levels)
        rec = np.asarray(inv53_multilevel(c, levels))
        np.testing.assert_array_equal(rec, data, err_msg=f"levels={levels}")


@pytest.mark.parametrize("parity", [(0, 0), (1, 0), (0, 1), (1, 1)])
def test_wavelet_256_odd_origin_roundtrip(parity, rng):
    x0, y0 = parity
    data = rng.integers(-1 << 14, 1 << 14, (256, 256)).astype(np.int32)
    c = fwd53_multilevel(jnp.asarray(data), 4, x0=x0, y0=y0)
    rec = np.asarray(inv53_multilevel(c, 4, x0=x0, y0=y0))
    np.testing.assert_array_equal(rec, data)


def test_wavelet_deep_levels_roundtrip(rng):
    """More levels than the image can support degrades gracefully."""
    data = rng.integers(-100, 100, (16, 16)).astype(np.int32)
    c = fwd53_multilevel(jnp.asarray(data), 10)
    rec = np.asarray(inv53_multilevel(c, 10))
    np.testing.assert_array_equal(rec, data)


def test_wavelet_extreme_values_roundtrip():
    """16-bit extremes through 5 levels (guard-bit headroom)."""
    data = np.full((64, 64), 32767, dtype=np.int32)
    data[::2, ::2] = -32768
    c = fwd53_multilevel(jnp.asarray(data), 5)
    rec = np.asarray(inv53_multilevel(c, 5))
    np.testing.assert_array_equal(rec, data)


def test_wavelet_batch_matches_per_frame(rng):
    frames = rng.integers(-4096, 4096, (6, 96, 64)).astype(np.int32)
    batched = np.asarray(fwd53_multilevel(jnp.asarray(frames), 3))
    for i in range(6):
        single = np.asarray(fwd53_multilevel(jnp.asarray(frames[i]), 3))
        np.testing.assert_array_equal(batched[i], single)


def test_wavelet_native_mirror_large(rng):
    from go_dicom_codec_jax.native import dwt53_fwd_native, get_lib

    if get_lib() is None:
        pytest.skip("native unavailable")
    data = rng.integers(-4096, 4096, (256, 256)).astype(np.int32)
    jnp_out = np.asarray(fwd53_multilevel(jnp.asarray(data), 5))
    nat = dwt53_fwd_native(data, 5)
    np.testing.assert_array_equal(nat, jnp_out)


@pytest.mark.parametrize("size", [1, 2, 3, 4, 5, 7, 8])
def test_wavelet_tiny_sizes_roundtrip(size, rng):
    data = rng.integers(-500, 500, (size, size)).astype(np.int32)
    for levels in (1, 2):
        c = fwd53_multilevel(jnp.asarray(data), levels)
        rec = np.asarray(inv53_multilevel(c, levels))
        np.testing.assert_array_equal(rec, data)


def test_ll_dimensions_ladder():
    """LL window math for the 256 ladder (layout.go:14-41 semantics)."""
    assert ll_dimensions(256, 256, 1) == (128, 128)
    assert ll_dimensions(256, 256, 5) == (8, 8)
    assert ll_dimensions(255, 255, 1) == (128, 128)
    assert ll_dimensions(255, 255, 5) == (8, 8)
    assert ll_dimensions(1, 253, 5) == (1, 8)
    assert ll_dimensions(0, 10, 2) == (0, 0)
