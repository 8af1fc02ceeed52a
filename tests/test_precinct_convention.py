"""Pixel-size precinct convention (PrecinctWidth/Height auto-scaling).

Mirrors the reference's precinct battery: precinct_test.go
(TestPrecinctCODMarker, TestPrecinctScalingAcrossResolutions,
TestPrecinctRoundtrip), precinct_verify_test.go
(TestVerifyMultiPrecinctActuallyWorks, TestPrecinctActualPacketCount),
precinct_gradient_test.go and precinct_simple_test.go, against the
reference's getPrecinctSizeExponents rule (encoder.go:1516-1569).
"""

import numpy as np
import pytest

from go_dicom_codec_jax.codecs.jpeg2000 import (J2KEncodeParams, J2KEncoder,
                                                decode_to_pixels)
from go_dicom_codec_jax.codestream import j2k


def _gradient(w, h):
    y, x = np.mgrid[0:h, 0:w]
    return ((x + y) % 256).astype(np.uint8)


def _encode(img, **kw):
    h, w = img.shape
    enc = J2KEncoder(J2KEncodeParams(**kw))
    return enc.encode(img.tobytes(), w, h, 1, 8, False)


def _decode(data):
    pix, w, h, c, depth, signed = decode_to_pixels(data)
    assert (c, depth, signed) == (1, 8, False)
    return np.frombuffer(pix, dtype=np.uint8).reshape(h, w)


# ---- COD marker emission (reference TestPrecinctCODMarker) -----------------

@pytest.mark.parametrize("pw,ph,levels,expect", [
    (0, 0, 3, False),       # default: maximal precincts, no Scod flag
    (128, 128, 3, True),
    (256, 256, 5, True),
    (512, 512, 2, True),
])
def test_precinct_cod_marker(pw, ph, levels, expect):
    img = (np.arange(256 * 256, dtype=np.uint32) % 256).astype(np.uint8)
    data = _encode(img.reshape(256, 256), num_levels=levels,
                   precinct_width=pw, precinct_height=ph)
    cs = j2k.parse_codestream(data)
    if not expect:
        assert cs.cod.precinct_exps is None
        return
    exps = cs.cod.precinct_exps
    assert exps is not None and len(exps) == levels + 1
    for (ppx, ppy) in exps:
        assert 0 <= ppx <= 15 and 0 <= ppy <= 15


def test_precinct_scaling_across_resolutions():
    # reference TestPrecinctScalingAcrossResolutions: 64x32 precincts,
    # 2 levels — exponent reduced by (levels - res), floored at 0
    img = _gradient(128, 128)
    data = _encode(img, num_levels=2, precinct_width=64, precinct_height=32)
    cs = j2k.parse_codestream(data)
    exps = cs.cod.precinct_exps
    assert exps == [(4, 3), (5, 4), (6, 5)]


def test_precinct_default_dimension_is_2_15():
    # one dimension 0 → that axis defaults to 2^15 before scaling
    p = J2KEncodeParams(num_levels=2, precinct_width=64, precinct_height=0)
    assert p.resolved_precincts(2) == [(4, 13), (5, 14), (6, 15)]


def test_precinct_exponent_floor_at_zero():
    p = J2KEncodeParams(num_levels=5, precinct_width=4, precinct_height=4)
    exps = p.resolved_precincts(5)
    assert exps[0] == (0, 0)            # 2 - 5 floors at 0
    assert exps[-1] == (2, 2)


def test_explicit_precincts_win_over_pixel_sizes():
    p = J2KEncodeParams(precincts=[(7, 7)] * 3, precinct_width=64,
                        precinct_height=64)
    assert p.resolved_precincts(2) == [(7, 7)] * 3


# ---- lossless roundtrips (reference TestPrecinctRoundtrip + verify) --------

@pytest.mark.parametrize("w,h,pw,ph,levels", [
    (64, 64, 32, 32, 2),
    (128, 128, 64, 64, 3),
    (256, 256, 128, 128, 3),
    (64, 64, 32, 32, 1),
    (256, 256, 128, 128, 5),
])
def test_precinct_roundtrip_lossless(w, h, pw, ph, levels):
    img = _gradient(w, h)
    data = _encode(img, num_levels=levels, precinct_width=pw,
                   precinct_height=ph)
    cs = j2k.parse_codestream(data)
    assert cs.cod.precinct_exps          # flag actually set
    np.testing.assert_array_equal(_decode(data), img)


def test_precinct_sizes_change_stream_not_pixels():
    # reference TestPrecinctActualPacketCount: default vs large vs
    # small precincts — all decode perfectly, streams differ
    img = ((np.arange(128 * 128) * 7) % 256).astype(np.uint8).reshape(128, 128)
    streams = []
    for pw in (0, 256, 64):
        data = _encode(img, num_levels=2, precinct_width=pw,
                       precinct_height=pw)
        np.testing.assert_array_equal(_decode(data), img)
        streams.append(data)
    # small precincts split packets → different stream bytes
    assert streams[2] != streams[0]


@pytest.mark.parametrize("progression", [0, 2, 4])
def test_precinct_progressions_roundtrip(progression, rng):
    img = rng.integers(0, 256, size=(96, 80)).astype(np.uint8)
    data = _encode(img, num_levels=2, precinct_width=32,
                   precinct_height=32, progression=progression)
    np.testing.assert_array_equal(_decode(data), img)


def test_precinct_lossy_roundtrip(rng):
    img = _gradient(128, 128)
    data = _encode(img, num_levels=3, lossless=False, quality=90,
                   precinct_width=64, precinct_height=64)
    out = _decode(data)
    err = np.abs(out.astype(int) - img.astype(int))
    assert err.max() <= 12 and err.mean() < 2.0
