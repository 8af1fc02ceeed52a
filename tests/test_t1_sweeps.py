"""Exhaustive small-grid T1/T2 sweeps.

Role of the reference's t1/test_square_sizes_test.go,
test_rectangle_sizes_test.go, test_value_range_test.go,
termall_*_test.go, precinct_*_test.go and size_boundary_test.go: pin
the geometry/style corners as deterministic cases instead of fuzz
lottery tickets. Native path for speed; Python parity spot-checked on a
diagonal (full parity is tests/test_native.py's job).
"""

import numpy as np
import pytest

from go_dicom_codec_jax import native as nat
from go_dicom_codec_jax.codecs.jpeg2000 import (J2KEncodeParams, J2KEncoder,
                                                decode_to_pixels)

S_LAZY, S_RESET, S_TERMALL, S_VSC, S_PTERM, S_SEGSYM = (
    0x01, 0x02, 0x04, 0x08, 0x10, 0x20)

SIZES = [1, 2, 3, 4, 5, 8, 9, 16, 17]
STYLES = [0, S_LAZY, S_TERMALL, S_VSC, S_LAZY | S_TERMALL,
          S_VSC | S_TERMALL, S_RESET | S_PTERM | S_SEGSYM, 0x3F]


def _t1_roundtrip(data, style, orient=0):
    r = nat.t1_encode_native(np.ascontiguousarray(data, dtype=np.int64),
                             style=style, orient=orient, roishift=0)
    if r is None:
        pytest.skip("native library unavailable")
    stream, numbps, rates, terms, bps, nmse = r
    # TERMALL/LAZY terminate mid-stream: the decoder needs the segment
    # byte boundaries (cumulative rates at terminating passes)
    seg_ends = [rates[i] for i in range(len(rates)) if terms[i]]
    out = nat.t1_decode_native(stream, data.shape[1], data.shape[0],
                               style, orient, len(rates), numbps, 0,
                               seg_ends)
    np.testing.assert_array_equal(out, data)
    return stream


@pytest.mark.parametrize("style", STYLES)
def test_t1_square_and_rect_sizes(style, rng):
    """Every (w, h) in the small-size grid roundtrips under every style
    (role of test_square_sizes/test_rectangle_sizes)."""
    for w in SIZES:
        for h in SIZES:
            data = rng.integers(-3000, 3001, (h, w)).astype(np.int64)
            _t1_roundtrip(data, style)


@pytest.mark.parametrize("orient", [0, 1, 2, 3])
def test_t1_orientations_small(orient, rng):
    for w, h in [(1, 1), (3, 5), (9, 1), (1, 9), (17, 4), (16, 16)]:
        data = rng.integers(-500, 501, (h, w)).astype(np.int64)
        _t1_roundtrip(data, 0, orient)
        _t1_roundtrip(data, S_VSC | S_TERMALL, orient)


@pytest.mark.parametrize("mag", [1, 2, 3, 255, 1 << 15, (1 << 15) - 1])
def test_t1_value_ranges(mag, rng):
    """Extreme magnitudes incl. ±2^15 (role of test_value_range)."""
    for style in (0, S_LAZY, S_TERMALL):
        data = rng.integers(-mag, mag + 1, (12, 12)).astype(np.int64)
        data[0, 0] = mag
        data[-1, -1] = -mag
        _t1_roundtrip(data, style)


def test_t1_9x1_vsc_termall_bitplane0():
    """The verdict's pinned case: a 9×1 block, VSC+TERMALL, value ±1
    (bitplane 0 only)."""
    for vals in ([1, -1, 0, 1, 0, 0, -1, 1, -1],
                 [0] * 9, [1] * 9, [-1] * 9):
        data = np.asarray(vals, dtype=np.int64).reshape(9, 1)
        _t1_roundtrip(data, S_VSC | S_TERMALL)
        _t1_roundtrip(data.reshape(1, 9), S_VSC | S_TERMALL)


def test_t1_native_python_parity_diagonal(rng):
    """Spot-check native == Python byte-for-byte on the sweep diagonal."""
    from go_dicom_codec_jax.entropy.ebcot import T1Encoder

    for (w, h, style) in [(1, 1, 0), (3, 3, S_LAZY), (5, 5, S_TERMALL),
                          (9, 9, S_VSC), (17, 17, 0x3F),
                          (4, 16, S_RESET | S_SEGSYM)]:
        data = rng.integers(-1000, 1001, (h, w)).astype(np.int64)
        r = nat.t1_encode_native(data, style=style, orient=0, roishift=0)
        if r is None:
            pytest.skip("native library unavailable")
        enc = T1Encoder(w, h, style=style, orientation=0)
        py_stream, py_numbps, py_passes = enc.encode(data)
        assert r[0] == py_stream
        assert r[1] == py_numbps


# ------------------------------------------------------- codec level

@pytest.mark.parametrize("dim", [31, 32, 33, 63, 64, 65, 127, 129])
def test_size_boundary_roundtrip(dim, rng):
    """Image sizes straddling codeblock boundaries (size_boundary)."""
    img = rng.integers(0, 4096, (dim, dim)).astype("<u2")
    enc = J2KEncoder(J2KEncodeParams(lossless=True, num_levels=3))
    s = enc.encode(np.ascontiguousarray(img).tobytes(), dim, dim, 1, 12,
                   False)
    pix, w, h, *_ = decode_to_pixels(s)
    np.testing.assert_array_equal(
        np.frombuffer(pix, "<u2").reshape(dim, dim), img)


@pytest.mark.parametrize("pexp", [(1, 1), (2, 2), (3, 3), (2, 4), (7, 7)])
def test_precinct_geometry_matrix(pexp, rng):
    """Precinct-size sweep incl. tiny 2×2 precincts (precinct_*_test)."""
    img = rng.integers(0, 4096, (70, 50)).astype("<u2")
    enc = J2KEncoder(J2KEncodeParams(
        lossless=True, num_levels=3, cb_width=16, cb_height=16,
        precincts=[pexp] * 4))
    s = enc.encode(np.ascontiguousarray(img).tobytes(), 50, 70, 1, 12,
                   False)
    pix, *_ = decode_to_pixels(s)
    np.testing.assert_array_equal(
        np.frombuffer(pix, "<u2").reshape(70, 50), img)


@pytest.mark.parametrize("prog", [0, 1, 2, 3, 4])
def test_precinct_progressions(prog, rng):
    """Small precincts under every progression order."""
    img = rng.integers(0, 4096, (40, 40)).astype("<u2")
    enc = J2KEncoder(J2KEncodeParams(
        lossless=True, num_levels=2, cb_width=16, cb_height=16,
        precincts=[(3, 3)] * 3, progression=prog, num_layers=2))
    s = enc.encode(np.ascontiguousarray(img).tobytes(), 40, 40, 1, 12,
                   False)
    pix, *_ = decode_to_pixels(s)
    np.testing.assert_array_equal(
        np.frombuffer(pix, "<u2").reshape(40, 40), img)
