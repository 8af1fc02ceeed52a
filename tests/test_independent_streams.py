"""Decoder tests on inputs the repo's own encoder NEVER touched.

The generators live in go_dicom_codec_jax/testdata.py (role of
reference jpeg2000/testdata/: an importable package of hand-packed
codestream builders + the spec-direct MQ and cleanup-pass coders).
This module drives them through the decoders: since the streams are
packed byte-by-byte from the standard, the decoder cannot share a
compensating bug with the encode path on these inputs.
"""

import numpy as np
import pytest

from go_dicom_codec_jax import testdata as td
from go_dicom_codec_jax.codecs.jpeg2000 import J2KDecoder


def _decode(stream):
    arr, siz, cod = J2KDecoder().decode(stream)
    return arr


def test_simple_0level_empty_packets():
    """8×8, 0 levels, empty packet: all-zero coefficients decode to the
    DC midpoint (role of GenerateSimpleJ2K)."""
    arr = _decode(td.simple_j2k(8, 8, 8))
    np.testing.assert_array_equal(arr[:, :, 0], 128)


def test_multilevel_empty_packets():
    """17×13, 3 levels (ragged windows), all packets empty
    (role of GenerateMultilevelJ2K)."""
    arr = _decode(td.multilevel_j2k(17, 13, 12, 3))
    np.testing.assert_array_equal(arr[:, :, 0], 1 << 11)


@pytest.mark.parametrize("w,h,tw,th,ncomp", [
    (16, 16, 8, 8, 1),    # 2x2 (role of Generate2x2TileJ2K)
    (24, 16, 8, 8, 1),    # 3x2 (role of Generate3x2TileJ2K)
    (16, 16, 8, 8, 3),    # 2x2 RGB (role of Generate2x2TileRGBJ2K)
    (20, 12, 8, 8, 1),    # ragged right/bottom tiles
])
def test_multitile_empty_packets(w, h, tw, th, ncomp):
    arr = _decode(td.multitile_j2k(w, h, tw, th, 8, 1, ncomp))
    assert arr.shape == (h, w, ncomp)
    np.testing.assert_array_equal(arr, 128)


def test_rgb_rct_empty_packets():
    """3-component with RCT: zero YUV inverts to the gray midpoint
    (role of GenerateRGBJ2K)."""
    arr = _decode(td.rgb_j2k(8, 8, 8, levels=1, mct=1))
    assert arr.shape == (8, 8, 3)
    np.testing.assert_array_equal(arr, 128)


def test_truncated_after_header_resilient():
    """Header-only stream (no tile data) must not crash resilient mode."""
    s = b"\xff\x4f" + td.siz(8, 8, 8) + td.cod(0, 0) + td.qcd(0, 8)
    arr, _, _ = J2KDecoder(resilient=True).decode(s + b"\xff\xd9")
    assert arr.shape == (8, 8, 1)


# ------------------------------------------------------------------
# real entropy-coded data from the spec-direct cleanup coder
# (role of encoded_generator.go)
# ------------------------------------------------------------------


@pytest.mark.parametrize("pattern", ["cross", "corners"])
@pytest.mark.parametrize("w,h,bits", [(8, 8, 8), (11, 7, 12), (16, 16, 16)])
def test_encoded_j2k_decodes_bit_exact(pattern, w, h, bits):
    """Non-empty packet: hand-packed header (inclusion/zero-bitplane
    tag trees, numpasses, Lblock lengths) + a cleanup pass coded by the
    spec-direct MQ + D.4 scan in testdata.py. The production decoder
    must reproduce the coefficients exactly."""
    stream, coeffs = td.encoded_j2k(w, h, bits, pattern=pattern)
    arr = _decode(stream)
    mid = 1 << (bits - 1)
    np.testing.assert_array_equal(
        arr[:, :, 0].astype(np.int64) - mid, coeffs)


def test_pattern_images_shapes_and_ranges():
    for fn, bits in [(td.gradient_image, 8), (td.dense_noise_image, 12),
                     (td.textured_image, 12), (td.checkerboard_image, 8)]:
        img = fn(31, 17, bits)
        assert img.shape == (17, 31)
        assert img.min() >= 0 and img.max() < (1 << bits)
    rgb = td.rgb_pattern_image(9, 5, 8)
    assert rgb.shape == (5, 9, 3)


def test_pattern_roundtrip_through_production_codec():
    """The library patterns drive a full production J2K roundtrip —
    the generators and codecs agree on sample conventions."""
    from go_dicom_codec_jax.codecs.jpeg2000 import J2KEncodeParams, J2KEncoder
    img = td.textured_image(33, 21, 12).astype(np.int32)
    enc = J2KEncoder(J2KEncodeParams(num_levels=2))
    stream = enc.encode(img, 33, 21, 1, 12)
    arr = _decode(stream)
    np.testing.assert_array_equal(arr[:, :, 0].astype(np.int64), img)


# ------------------------------------------------------------------
# independent MQ encoder vs the repo MQ decoder
# ------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(5))
def test_spec_mq_encoder_decodes_with_repo_decoder(seed, rng):
    """Random decision streams encoded by the spec-direct MQ encoder
    (testdata.SpecMQEncoder, Annex C flowcharts) decode bit-exactly
    with entropy/mq.MQDecoder. Neither side shares code; only the
    published standard connects them."""
    from go_dicom_codec_jax.entropy.mq import MQDecoder

    r = np.random.default_rng(900 + seed)
    n = int(r.integers(50, 600))
    nctx = 19
    ctxs = r.integers(0, nctx, n)
    bits = r.integers(0, 2, n)

    enc = td.SpecMQEncoder(nctx)
    for b, cx in zip(bits, ctxs):
        enc.encode(int(b), int(cx))
    data = enc.flush()

    dec = MQDecoder(data)
    got = [dec.decode(int(cx)) for cx in ctxs]
    assert got == [int(b) for b in bits]
