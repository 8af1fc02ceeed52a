"""Spatial window decode (J2KDecoder(window=...), OpenJPEG -d analogue
— beyond the reference, which always reconstructs the full image).

Exactness contract: the window decode must equal the same region
cropped from a full decode, for every stream class — tiles outside the
window skip entirely and code-blocks whose bands cannot influence the
window (Annex B ceil-div mapping + lifting-support margin) skip T1.
"""

import numpy as np
import pytest

from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder,
                                                J2KEncodeParams, J2KEncoder,
                                                decode_to_pixels)
from go_dicom_codec_jax.errors import UnsupportedFormatError


def _img(h=200, w=190, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4096, size=(h, w)).astype(np.int32)


WINDOWS = [(40, 50, 90, 110), (0, 0, 33, 29), (150, 170, 190, 200),
           (7, 0, 190, 13)]

CONFIGS = [
    dict(),
    dict(tile_width=64, tile_height=48),
    dict(htj2k=True),
    dict(lossless=False, quality=70),
    dict(num_layers=3, progression=2),
    dict(packed_headers=True, use_sop=True, use_eph=True),
    dict(cb_width=32, cb_height=32, precincts=[(6, 6)] * 6),
]


@pytest.mark.parametrize("kw", CONFIGS,
                         ids=[",".join(f"{k}={v}" for k, v in c.items())
                              or "default" for c in CONFIGS])
def test_window_equals_full_decode_crop(kw):
    img = _img()
    s = J2KEncoder(J2KEncodeParams(**kw)).encode(img, 190, 200, 1, 12)
    full = J2KDecoder().decode(s)[0]
    for win in WINDOWS:
        got = J2KDecoder(window=win).decode(s)[0]
        crop = full[win[1]:win[3], win[0]:win[2], :]
        assert got.shape == crop.shape
        assert np.array_equal(got, crop), (kw, win)


def test_window_rgb_and_roi():
    from go_dicom_codec_jax.codecs.j2k_roi import ROIRegion
    rng = np.random.default_rng(4)
    rgb = rng.integers(0, 256, (3, 120, 110)).astype(np.int32)
    s = J2KEncoder(J2KEncodeParams()).encode(rgb, 110, 120, 3, 8)
    full = J2KDecoder().decode(s)[0]
    got = J2KDecoder(window=(20, 30, 80, 90)).decode(s)[0]
    assert np.array_equal(got, full[30:90, 20:80, :])

    img = _img()
    s = J2KEncoder(J2KEncodeParams(
        roi_regions=[ROIRegion(shape="rect", rect=(8, 8, 64, 64))]
    )).encode(img, 190, 200, 1, 12)
    full = J2KDecoder().decode(s)[0]
    got = J2KDecoder(window=(30, 30, 100, 100)).decode(s)[0]
    assert np.array_equal(got, full[30:100, 30:100, :])


def test_window_composes_with_reduce():
    img = _img()
    for kw in (dict(), dict(tile_width=64, tile_height=48)):
        s = J2KEncoder(J2KEncodeParams(**kw)).encode(img, 190, 200, 1, 12)
        rfull = J2KDecoder(reduce=1).decode(s)[0]
        got = J2KDecoder(window=(40, 60, 120, 140), reduce=1).decode(s)[0]
        assert np.array_equal(got, rfull[30:70, 20:60, :]), kw


def test_window_clamps_to_grid():
    img = _img(64, 64)
    s = J2KEncoder(J2KEncodeParams()).encode(img, 64, 64, 1, 12)
    full = J2KDecoder().decode(s)[0]
    got = J2KDecoder(window=(-10, -10, 1000, 1000)).decode(s)[0]
    assert np.array_equal(got, full)


def test_window_outside_grid_raises():
    img = _img(64, 64)
    s = J2KEncoder(J2KEncodeParams()).encode(img, 64, 64, 1, 12)
    with pytest.raises(UnsupportedFormatError):
        J2KDecoder(window=(100, 100, 200, 200)).decode(s)
    with pytest.raises(UnsupportedFormatError):
        J2KDecoder(window=(10, 10, 10, 40)).decode(s)  # empty


def test_window_decode_to_pixels():
    img = _img()
    s = J2KEncoder(J2KEncodeParams()).encode(img, 190, 200, 1, 12)
    pix, w, h, c, depth, signed = decode_to_pixels(
        s, window=(10, 20, 74, 84))
    assert (w, h, c) == (64, 64, 1)
    full = np.frombuffer(decode_to_pixels(s)[0], "<u2").reshape(200, 190)
    got = np.frombuffer(pix, "<u2").reshape(64, 64)
    assert np.array_equal(got, full[20:84, 10:74])


def test_window_skips_unneeded_tiles_entirely():
    """A corrupt far-away tile must not affect a window decode that
    never touches it (whole-tile entropy skip)."""
    import struct

    from go_dicom_codec_jax.codestream import j2k
    img = _img()
    s = J2KEncoder(J2KEncodeParams(tile_width=64, tile_height=48)
                   ).encode(img, 190, 200, 1, 12)
    # corrupt the LAST tile's body bytes (bottom-right region)
    pos, last = 2, None
    while pos < len(s):
        m = struct.unpack_from(">H", s, pos)[0]
        if m == j2k.EOC:
            break
        if m == j2k.SOT:
            psot = struct.unpack_from(">I", s, pos + 6)[0]
            last = (pos, psot)
            pos += psot
            continue
        pos += 2 + struct.unpack_from(">H", s, pos + 2)[0]
    d = bytearray(s)
    start = last[0] + last[1] - 40
    for i in range(start, start + 30):
        d[i] ^= 0xFF
    full = J2KDecoder().decode(s)[0]
    got = J2KDecoder(window=(0, 0, 64, 48)).decode(bytes(d))[0]
    assert np.array_equal(got, full[0:48, 0:64, :])


@pytest.mark.parametrize("h,w", [(1, 1), (1, 300), (300, 1), (3, 5)])
def test_window_and_reduce_on_degenerate_shapes(h, w):
    img = _img(h, w, seed=h * 100 + w) if h * w > 1 else \
        np.array([[1234]], dtype=np.int32)
    s = J2KEncoder(J2KEncodeParams()).encode(img, w, h, 1, 12)
    full = J2KDecoder().decode(s)[0]
    # full-cover window
    got = J2KDecoder(window=(0, 0, w, h)).decode(s)[0]
    assert np.array_equal(got, full)
    # single-pixel window
    got = J2KDecoder(window=(w - 1, h - 1, w, h)).decode(s)[0]
    assert np.array_equal(got, full[h - 1:h, w - 1:w, :])
    # reduce past the clamped level count still yields >= 1 px
    lv = J2KEncodeParams().clamped_levels(w, h)
    if lv > 0:
        arr = J2KDecoder(reduce=lv).decode(s)[0]
        assert arr.shape[0] >= 1 and arr.shape[1] >= 1
