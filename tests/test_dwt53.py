"""5/3 DWT bit-exactness: vectorized jnp op vs a literal scalar model.

The scalar model below re-states the OpenJPEG/ISO 15444-1 Annex F lifting
recurrences exactly as the reference executes them
(reference jpeg2000/wavelet/dwt53.go:27-234): predict/update with arithmetic
shifts and the documented edge rules per parity. The vectorized op must be
bit-exact against it for every width/height/parity combination, and
roundtrip must be lossless.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from go_dicom_codec_jax.ops.dwt53 import (
    fwd53_1d, fwd53_2d, fwd53_multilevel, inv53_1d, inv53_2d,
    inv53_multilevel, ll_dimensions)


# ---- scalar semantic model (slow, obviously correct) -----------------------

def scalar_fwd1d(data, even):
    data = list(map(int, data))
    w = len(data)
    if even:
        if w <= 1:
            return data
        sn = (w + 1) >> 1
        dn = w - sn
        h = [0] * dn
        for i in range(sn - 1):
            h[i] = data[2 * i + 1] - ((data[2 * i] + data[2 * (i + 1)]) >> 1)
        if w % 2 == 0:
            h[sn - 1] = data[2 * sn - 1] - data[2 * (sn - 1)]
        l = [0] * sn
        l[0] = data[0] + ((h[0] + h[0] + 2) >> 2)
        for i in range(1, dn):
            l[i] = data[2 * i] + ((h[i - 1] + h[i] + 2) >> 2)
        if w % 2 == 1:
            l[sn - 1] = data[2 * (sn - 1)] + ((h[dn - 1] + h[dn - 1] + 2) >> 2)
        return l + h
    else:
        if w == 1:
            return [data[0] * 2]
        sn = w >> 1
        dn = w - sn
        h = [0] * dn
        h[0] = data[0] - data[1]
        for i in range(1, sn):
            h[i] = data[2 * i] - ((data[2 * i + 1] + data[2 * (i - 1) + 1]) >> 1)
        if w % 2 == 1:
            h[dn - 1] = data[2 * (dn - 1)] - data[2 * (sn - 1) + 1]
        l = [0] * sn
        for i in range(dn - 1):
            l[i] = data[2 * i + 1] + ((h[i] + h[i + 1] + 2) >> 2)
        if w % 2 == 0:
            l[sn - 1] = data[2 * sn - 1] + ((h[dn - 1] + h[dn - 1] + 2) >> 2)
        return l + h


def scalar_inv1d(data, even):
    data = list(map(int, data))
    w = len(data)
    if even:
        if w <= 1:
            return data
        sn = (w + 1) >> 1
        dn = w - sn
        l, h = data[:sn], data[sn:]
        s = [0] * sn
        for i in range(sn):
            hm = h[max(i - 1, 0)] if dn else 0
            hc = h[min(i, dn - 1)] if dn else 0
            s[i] = l[i] - ((hm + hc + 2) >> 2)
        out = [0] * w
        out[0::2] = s
        for i in range(dn):
            sp = s[min(i + 1, sn - 1)]
            out[2 * i + 1] = h[i] + ((s[i] + sp) >> 1)
        return out
    else:
        if w == 1:
            v = data[0]
            return [v >> 1]
        sn = w >> 1
        dn = w - sn
        l, h = data[:sn], data[sn:]
        s = [0] * sn
        for i in range(sn):
            hi = h[min(i, dn - 1)]
            hp = h[min(i + 1, dn - 1)]
            s[i] = l[i] - ((hi + hp + 2) >> 2)
        out = [0] * w
        out[1::2] = s
        for i in range(dn):
            sm = s[max(i - 1, 0)] if sn else 0
            sc = s[min(i, sn - 1)] if sn else 0
            out[2 * i] = h[i] + ((sm + sc) >> 1)
        return out


WIDTHS = [2, 3, 4, 5, 7, 8, 9, 16, 17, 31, 64, 127, 128]


@pytest.mark.parametrize("even", [True, False])
@pytest.mark.parametrize("w", WIDTHS)
def test_fwd1d_matches_scalar(w, even, rng):
    x = rng.integers(-(1 << 14), 1 << 14, size=w).astype(np.int32)
    got = np.asarray(fwd53_1d(jnp.asarray(x), even))
    want = np.array(scalar_fwd1d(x, even), dtype=np.int32)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("even", [True, False])
@pytest.mark.parametrize("w", WIDTHS)
def test_inv1d_matches_scalar_and_roundtrips(w, even, rng):
    x = rng.integers(-(1 << 14), 1 << 14, size=w).astype(np.int32)
    fwd = np.array(scalar_fwd1d(x, even), dtype=np.int32)
    got = np.asarray(inv53_1d(jnp.asarray(fwd), even))
    want = np.array(scalar_inv1d(fwd, even), dtype=np.int32)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, x)  # lossless roundtrip


def test_1d_singleton_cas1():
    x = jnp.asarray(np.array([7], dtype=np.int32))
    f = fwd53_1d(x, False)
    assert int(f[0]) == 14
    assert int(inv53_1d(f, False)[0]) == 7


SHAPES_2D = [(1, 8), (8, 1), (2, 2), (3, 5), (5, 3), (8, 8), (9, 7),
             (16, 16), (17, 31), (64, 64), (33, 129)]


@pytest.mark.parametrize("even_row", [True, False])
@pytest.mark.parametrize("even_col", [True, False])
@pytest.mark.parametrize("shape", SHAPES_2D)
def test_2d_roundtrip_and_scalar(shape, even_row, even_col, rng):
    h, w = shape
    x = rng.integers(-(1 << 12), 1 << 12, size=(h, w)).astype(np.int32)
    f = np.asarray(fwd53_2d(jnp.asarray(x), even_row, even_col))

    # scalar model: vertical first, then horizontal (dwt53.go:259-301);
    # size-1 dims at odd parity still pass (single HIGH sample, ×2 rule)
    want = x.astype(np.int64).copy()
    if h > 1 or (h == 1 and not even_col):
        for cx in range(w):
            want[:, cx] = scalar_fwd1d(want[:, cx], even_col)
    if w > 1 or (w == 1 and not even_row):
        for cy in range(h):
            want[cy, :] = scalar_fwd1d(want[cy, :], even_row)
    np.testing.assert_array_equal(f, want.astype(np.int32))

    back = np.asarray(inv53_2d(jnp.asarray(f), even_row, even_col))
    np.testing.assert_array_equal(back, x)


@pytest.mark.parametrize("levels", [1, 2, 3, 5])
@pytest.mark.parametrize("shape,origin", [((64, 64), (0, 0)), ((60, 52), (3, 1)),
                                          ((127, 129), (0, 0)), ((33, 20), (5, 7))])
def test_multilevel_roundtrip(shape, origin, levels, rng):
    h, w = shape
    x0, y0 = origin
    x = rng.integers(-(1 << 12), 1 << 12, size=(2, h, w)).astype(np.int32)
    f = fwd53_multilevel(jnp.asarray(x), levels, x0, y0)
    back = np.asarray(inv53_multilevel(f, levels, x0, y0))
    np.testing.assert_array_equal(back, x)


def test_ll_dimensions():
    assert ll_dimensions(64, 64, 1) == (32, 32)
    assert ll_dimensions(65, 64, 1) == (33, 32)
    assert ll_dimensions(64, 64, 3) == (8, 8)
    assert ll_dimensions(127, 129, 2) == (32, 33)
    # odd origin flips the split
    assert ll_dimensions(5, 5, 1, 1, 0) == (2, 3)
    assert ll_dimensions(1, 1, 5) == (1, 1)
