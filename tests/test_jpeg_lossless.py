"""JPEG Lossless P14/SV1 + Extended 12-bit: bit-exact roundtrip matrices.

Mirrors reference coverage (jpeg/lossless/*_test.go predictor matrix,
lossless14sv1 16-bit tests, extended native12_test.go).
"""

import numpy as np
import pytest

from go_dicom_codec_jax import MemoryPixelData, get_global_registry, uids
from go_dicom_codec_jax.codecs import jpeg_extended as jx
from go_dicom_codec_jax.codecs import jpeg_lossless as jl
from go_dicom_codec_jax.frames import FrameInfo
from go_dicom_codec_jax.ops.lossless_predict import (encode_diffs,
                                                     reconstruct,
                                                     select_best_predictor)


def _scalar_diffs(plane, predictor, precision):
    """Literal scalar model of the T.81 H.1.2 scan rules: first sample
    2^(P-1), rest of the first line Ra, first column Rb, interior =
    the selected predictor over real neighbors (the round-5 conformance
    fix; the reference's default-substitution edge rule is documented
    as nonconformant in ops/lossless_predict.py)."""
    h, w = plane.shape
    default = 1 << (precision - 1)
    out = np.zeros((h, w), dtype=np.int64)
    s = plane.astype(int)
    for r in range(h):
        for c in range(w):
            if r == 0 and c == 0:
                pred = default
            elif r == 0:
                pred = s[0, c - 1]          # first line: Px = Ra
            elif c == 0:
                pred = s[r - 1, 0]          # first column: Px = Rb
            else:
                ra, rb, rc = s[r, c - 1], s[r - 1, c], s[r - 1, c - 1]
                pred = {1: ra, 2: rb, 3: rc, 4: ra + rb - rc,
                        5: ra + ((rb - rc) >> 1), 6: rb + ((ra - rc) >> 1),
                        7: (ra + rb) >> 1}[predictor]
            d = s[r, c] - pred
            out[r, c] = ((d + 0x8000) & 0xFFFF) - 0x8000
    return out


@pytest.mark.parametrize("predictor", [1, 2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("precision", [8, 12, 16])
def test_predict_matches_scalar_and_roundtrips(predictor, precision, rng):
    h, w = 13, 17
    plane = rng.integers(0, 1 << precision, size=(h, w)).astype(np.int64)
    d = encode_diffs(plane, predictor, precision)
    want = _scalar_diffs(plane, predictor, precision)
    np.testing.assert_array_equal(d, want)
    back = reconstruct(d, predictor, precision)
    np.testing.assert_array_equal(back, plane)


@pytest.mark.parametrize("predictor", [0, 1, 4, 6, 7])
def test_gray16_roundtrip_bitexact(predictor, rng):
    h, w = 61, 47
    img = rng.integers(0, 1 << 16, size=(h, w)).astype("<u2")
    data = jl.encode(img.tobytes(), w, h, 1, 16, predictor)
    out, ow, oh, oc, prec = jl.decode(data)
    assert (ow, oh, oc, prec) == (w, h, 1, 16)
    got = np.frombuffer(out, dtype="<u2").reshape(h, w)
    np.testing.assert_array_equal(got, img)


def test_rgb8_roundtrip_bitexact(rng):
    h, w = 33, 29
    img = rng.integers(0, 256, size=(h, w, 3)).astype(np.uint8)
    data = jl.encode(img.tobytes(), w, h, 3, 8, 4)
    out, ow, oh, oc, prec = jl.decode(data)
    got = np.frombuffer(out, dtype=np.uint8).reshape(h, w, 3)
    np.testing.assert_array_equal(got, img)


def test_extreme_diff_cat16(rng):
    """-32768 wrapped difference exercises category 16."""
    img = np.zeros((2, 2), dtype="<u2")
    img[0, 0] = 0x8000  # first pixel: diff = 0x8000 - 0x8000 = 0... make harder
    img = np.array([[0, 0x8000], [0xFFFF, 1]], dtype="<u2")
    data = jl.encode(img.tobytes(), 2, 2, 1, 16, 1)
    out, _, _, _, _ = jl.decode(data)
    got = np.frombuffer(out, dtype="<u2").reshape(2, 2)
    np.testing.assert_array_equal(got, img)


def test_select_best_predictor_smooth_gradient():
    y = np.arange(32).reshape(-1, 1) * np.ones((1, 32))
    # vertical gradient: Ra+Rb-Rc is exact everywhere but column 0,
    # "above" errs on every row>0 — predictor 4 wins
    p = select_best_predictor([y.astype(np.int64) * 7], 32, 32)
    assert p == 4


def test_registry_p14_sv1_roundtrip(rng):
    for uid in (uids.JPEG_LOSSLESS_P14, uids.JPEG_LOSSLESS_SV1):
        info = FrameInfo(width=40, height=25, bits_allocated=16,
                         bits_stored=12)
        codec = get_global_registry().get_codec(uid)
        img = rng.integers(0, 1 << 12, size=(25, 40)).astype("<u2")
        src = MemoryPixelData(info=info)
        src.add_frame(img.tobytes())
        enc = MemoryPixelData(info=info, encapsulated=True)
        codec.encode(src, enc)
        dec = MemoryPixelData(info=info)
        codec.decode(enc, dec)
        assert dec.get_frame(0) == src.get_frame(0), uid


def test_compression_on_smooth_data(rng):
    """Smooth data should compress well losslessly (README ratios ~2-3x)."""
    base = np.cumsum(rng.integers(-2, 3, size=(64, 64)), axis=1)
    img = (base - base.min()).astype("<u2")
    raw = img.tobytes()
    data = jl.encode(raw, 64, 64, 1, 16, 0)
    assert len(data) < len(raw) / 1.5
    out, _, _, _, _ = jl.decode(data)
    assert out == raw


# ---- extended 12-bit --------------------------------------------------------

def test_extended_12bit_roundtrip(rng):
    h, w = 40, 48
    small = rng.random((6, 7))
    ys = np.linspace(0, 4.999, h).astype(int)
    xs = np.linspace(0, 5.999, w).astype(int)
    img = (small[np.ix_(ys, xs)] * 4095).astype("<u2")
    data = jx.encode(img.tobytes(), w, h, 1, 12, 95)
    assert jx.detect_bit_depth(data) == 12
    out, ow, oh, oc, depth = jx.decode(data)
    assert (ow, oh, oc, depth) == (w, h, 1, 12)
    got = np.frombuffer(out, dtype="<u2").reshape(h, w).astype(int)
    assert np.abs(got - img.astype(int)).max() <= 80  # q95 on smooth 12-bit


def test_extended_8bit_delegates_to_baseline(rng):
    img = np.full((16, 16), 100, dtype=np.uint8)
    data = jx.encode(img.tobytes(), 16, 16, 1, 8, 90)
    assert jx.detect_bit_depth(data) == 8
    out, _, _, _, depth = jx.decode(data)
    assert depth == 8
    got = np.frombuffer(out, dtype=np.uint8)
    assert np.abs(got.astype(int) - 100).max() <= 2


def test_extended_registry(rng):
    info = FrameInfo(width=24, height=16, bits_allocated=16, bits_stored=12)
    codec = get_global_registry().get_codec(uids.JPEG_EXTENDED_12BIT)
    img = np.full((16, 24), 2000, dtype="<u2")
    src = MemoryPixelData(info=info)
    src.add_frame(img.tobytes())
    enc = MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc)
    dec = MemoryPixelData(info=info)
    codec.decode(enc, dec)
    got = np.frombuffer(dec.get_frame(0), dtype="<u2")
    assert np.abs(got.astype(int) - 2000).max() <= 8
