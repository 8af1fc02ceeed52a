"""9/7 irreversible DWT unit tests (reference wavelet/dwt97_test.go,
layout_test.go, quantization.go norm tables).

The 5/3 path has its own unit file (test_dwt53.py); this mirrors the
reference's 9/7-specific coverage: lifting constants, vanishing moments,
parity variants, multilevel packing, and the OpenJPEG L2 norm tables the
quantization model consumes.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from go_dicom_codec_jax.ops import dwt97 as d97
from go_dicom_codec_jax.ops.dwt53 import ll_dimensions


# ---- lifting constants (T.800 Table F.4) ------------------------------------

def test_lifting_constants_match_t800():
    assert d97.ALPHA == pytest.approx(-1.586134342, abs=1e-9)
    assert d97.BETA == pytest.approx(-0.052980118, abs=1e-9)
    assert d97.GAMMA == pytest.approx(0.882911075, abs=1e-9)
    assert d97.DELTA == pytest.approx(0.443506852, abs=1e-9)
    assert d97.K == pytest.approx(1.230174105, abs=1e-9)


def test_scaling_constants_are_inverses():
    # INV_K is OpenJPEG's truncated constant, not exactly 1/K
    assert d97.K * d97.INV_K == pytest.approx(1.0, abs=2e-6)


# ---- 1D transform -----------------------------------------------------------

@pytest.mark.parametrize("n", [2, 3, 8, 9, 16, 17, 33])
@pytest.mark.parametrize("even", [True, False])
def test_fwd_inv_1d_roundtrip(n, even, rng):
    x = rng.uniform(-1000, 1000, size=n).astype(np.float32)
    y = np.asarray(d97.inv97_1d(d97.fwd97_1d(x, even), even))
    np.testing.assert_allclose(y, x, rtol=0, atol=2e-2)


def test_constant_signal_has_zero_details():
    """9/7 analysis high-pass annihilates constants (vanishing moments)."""
    x = np.full(16, 37.0, dtype=np.float32)
    y = np.asarray(d97.fwd97_1d(x, True))
    lo, hi = y[:8], y[8:]
    np.testing.assert_allclose(hi, 0.0, atol=1e-3)
    # low-pass of a constant is constant (scaled by 1/K per F.4.8.2)
    np.testing.assert_allclose(lo, lo[0], atol=1e-3)


def test_linear_ramp_interior_details_vanish():
    """Two+ vanishing moments: a ramp's interior detail coeffs are ~0."""
    x = np.arange(64, dtype=np.float32)
    y = np.asarray(d97.fwd97_1d(x, True))
    hi = y[32:]
    np.testing.assert_allclose(hi[2:-2], 0.0, atol=1e-2)


def test_1d_singleton_roundtrip():
    for even in (True, False):
        x = np.array([123.0], dtype=np.float32)
        y = np.asarray(d97.inv97_1d(d97.fwd97_1d(x, even), even))
        np.testing.assert_allclose(y, x, atol=1e-3)


def test_parity_changes_coefficients(rng):
    """Odd origin (even=False) must produce a different subband split."""
    x = rng.uniform(-100, 100, size=17).astype(np.float32)
    ye = np.asarray(d97.fwd97_1d(x, True))
    yo = np.asarray(d97.fwd97_1d(x, False))
    assert ye.shape == yo.shape == (17,)
    assert not np.allclose(ye, yo)


# ---- 2D / multilevel --------------------------------------------------------

@pytest.mark.parametrize("shape", [(9, 7), (16, 13), (1, 9)])
@pytest.mark.parametrize("parity", [(True, True), (False, True),
                                    (True, False), (False, False)])
def test_2d_roundtrip(shape, parity, rng):
    er, ec = parity
    x = rng.uniform(-512, 512, size=shape).astype(np.float32)
    y = np.asarray(d97.inv97_2d(d97.fwd97_2d(x, er, ec), er, ec))
    np.testing.assert_allclose(y, x, rtol=0, atol=5e-2)


@pytest.mark.parametrize("origin", [(0, 0), (1, 0), (3, 5)])
@pytest.mark.parametrize("levels", [1, 3])
def test_multilevel_roundtrip(origin, levels, rng):
    x0, y0 = origin
    x = rng.uniform(-512, 512, size=(23, 31)).astype(np.float32)
    y = np.asarray(d97.inv97_multilevel(
        d97.fwd97_multilevel(jnp.asarray(x), levels, x0, y0), levels, x0, y0))
    np.testing.assert_allclose(y, x, rtol=0, atol=1e-1)


def test_multilevel_packs_ll_window(rng):
    """Level-2 transform only rewrites the level-1 LL window in place."""
    x = rng.uniform(-100, 100, size=(16, 16)).astype(np.float32)
    one = np.asarray(d97.fwd97_multilevel(jnp.asarray(x), 1))
    two = np.asarray(d97.fwd97_multilevel(jnp.asarray(x), 2))
    llw, llh = ll_dimensions(16, 16, 1)
    np.testing.assert_allclose(two[llh:, :], one[llh:, :], atol=1e-4)
    np.testing.assert_allclose(two[:llh, llw:], one[:llh, llw:], atol=1e-4)
    assert not np.allclose(two[:llh, :llw], one[:llh, :llw])


def test_batched_matches_per_frame(rng):
    x = rng.uniform(-100, 100, size=(3, 12, 10)).astype(np.float32)
    batched = np.asarray(d97.fwd97_multilevel(jnp.asarray(x), 2))
    for i in range(3):
        single = np.asarray(d97.fwd97_multilevel(jnp.asarray(x[i]), 2))
        np.testing.assert_allclose(batched[i], single, atol=1e-4)


def test_jit_matches_eager(rng):
    x = rng.uniform(-100, 100, size=(11, 13)).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(d97.fwd97_multilevel_jit(x, 2, 1, 0)),
        np.asarray(d97.fwd97_multilevel(jnp.asarray(x), 2, 1, 0)), atol=1e-2)
    np.testing.assert_allclose(
        np.asarray(d97.inv97_multilevel_jit(x, 2, 1, 0)),
        np.asarray(d97.inv97_multilevel(jnp.asarray(x), 2, 1, 0)), atol=1e-2)


# ---- OpenJPEG norm tables (reference quantization.go:10-23) ------------------

def test_dwt97_norm_spot_values():
    assert d97.dwt97_norm(0, 0) == pytest.approx(1.000)
    assert d97.dwt97_norm(1, 0) == pytest.approx(1.965)
    assert d97.dwt97_norm(0, 1) == pytest.approx(2.022)
    assert d97.dwt97_norm(0, 3) == pytest.approx(2.080)
    assert d97.dwt97_norm(4, 3) == pytest.approx(34.71)


def test_dwt53_norm_spot_values():
    assert d97.dwt53_norm(0, 0) == pytest.approx(1.000)
    assert d97.dwt53_norm(1, 0) == pytest.approx(1.500)
    assert d97.dwt53_norm(0, 3) == pytest.approx(0.7186)
    assert d97.dwt53_norm(3, 1) == pytest.approx(5.703)


@pytest.mark.parametrize("fn", [d97.dwt97_norm, d97.dwt53_norm])
def test_norms_roughly_double_per_level(fn):
    """L2 gain doubles per decomposition level (both filter banks)."""
    for orient in range(4):
        for lvl in range(3, 8):
            ratio = fn(lvl + 1, orient) / fn(lvl, orient)
            assert 1.8 < ratio < 2.2


@pytest.mark.parametrize("fn", [d97.dwt97_norm, d97.dwt53_norm])
def test_norm_bounds_clamped(fn):
    assert fn(-3, 0) == fn(0, 0)      # negative level clamps to 0
    assert fn(99, 0) == fn(9, 0)      # LL caps at level 9
    assert fn(99, 1) == fn(8, 1)      # detail bands cap at level 8
    assert fn(0, -1) == 1.0           # invalid orientation → neutral
    assert fn(0, 4) == 1.0
