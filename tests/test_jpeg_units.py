"""Classic-JPEG primitive unit tests (reference jpeg/standard/tables.go,
dct_ijg.go, markers payloads, jpeg/lossless/predictors.go formulas).

Codec-level roundtrips live in test_jpeg_baseline.py / test_jpeg_lossless.py /
test_huffman_units.py; this file pins the scalar tables/formula layer.
"""

import numpy as np
import pytest

from go_dicom_codec_jax.codecs.jpeg_common import (CHROMA_QUANT, LUMA_QUANT,
                                                   dqt_payload, parse_dqt,
                                                   scale_quant_table,
                                                   sof_payload, sos_payload)
from go_dicom_codec_jax.errors import CorruptStreamError, InvalidQualityError
from go_dicom_codec_jax.ops import dct_int
from go_dicom_codec_jax.ops.lossless_predict import (_predict, encode_diffs,
                                                     reconstruct,
                                                     select_best_predictor)


# ---- Annex K tables + IJG quality scaling (tables.go:30-58) ------------------

def test_annex_k_table_values():
    """T.81 Table K.1/K.2 spot values."""
    assert LUMA_QUANT[0, 0] == 16 and LUMA_QUANT[7, 7] == 99
    assert LUMA_QUANT[0, 1] == 11
    assert CHROMA_QUANT[0, 0] == 17 and CHROMA_QUANT[7, 7] == 99


def test_quality_50_is_identity():
    np.testing.assert_array_equal(scale_quant_table(LUMA_QUANT, 50),
                                  LUMA_QUANT)


def test_quality_100_is_all_ones():
    assert (scale_quant_table(LUMA_QUANT, 100) == 1).all()


def test_quality_1_is_coarse_and_clamped():
    t = scale_quant_table(LUMA_QUANT, 1)
    assert t.max() == 255  # clamped to 8-bit baseline ceiling
    assert (t >= scale_quant_table(LUMA_QUANT, 50)).all()


def test_quality_monotone_steps():
    prev = None
    for q in (10, 25, 50, 75, 90, 100):
        t = scale_quant_table(LUMA_QUANT, q)
        if prev is not None:
            assert (t <= prev).all()
        prev = t


def test_quality_out_of_range_raises():
    with pytest.raises(InvalidQualityError):
        scale_quant_table(LUMA_QUANT, 0)
    with pytest.raises(InvalidQualityError):
        scale_quant_table(LUMA_QUANT, 101)


def test_quant_extended_12bit_ceiling():
    """12-bit builds allow 16-bit table entries (max_val override)."""
    t = scale_quant_table(LUMA_QUANT * 40, 50, max_val=65535)
    assert t.max() > 255


# ---- DQT / SOF / SOS payload layouts ----------------------------------------

def test_dqt_8bit_roundtrip():
    out = {}
    parse_dqt(dqt_payload(0, LUMA_QUANT), out)
    np.testing.assert_array_equal(out[0], LUMA_QUANT)


def test_dqt_16bit_roundtrip():
    big = (LUMA_QUANT.astype(np.int32) * 37)  # entries >255 → Pq=1
    payload = dqt_payload(1, big)
    assert payload[0] == 0x11
    out = {}
    parse_dqt(payload, out)
    np.testing.assert_array_equal(out[1], big)


def test_dqt_multiple_tables_one_payload():
    out = {}
    parse_dqt(dqt_payload(0, LUMA_QUANT) + dqt_payload(1, CHROMA_QUANT), out)
    assert set(out) == {0, 1}
    np.testing.assert_array_equal(out[1], CHROMA_QUANT)


def test_dqt_truncated_raises():
    with pytest.raises(CorruptStreamError):
        parse_dqt(dqt_payload(0, LUMA_QUANT)[:-1], {})


def test_sof_payload_layout():
    p = sof_payload(8, 640, 480, [(1, 2, 2, 0), (2, 1, 1, 1)])
    assert p[0] == 8
    assert int.from_bytes(p[1:3], "big") == 480  # height first (T.81 B.2.2)
    assert int.from_bytes(p[3:5], "big") == 640
    assert p[5] == 2
    assert p[6:9] == bytes([1, 0x22, 0])
    assert p[9:12] == bytes([2, 0x11, 1])


def test_sos_payload_layout():
    p = sos_payload([(1, 0, 1)], ss=1, se=63, ah_al=0x21)
    assert p == bytes([1, 1, 0x01, 1, 63, 0x21])


# ---- IJG integer islow DCT (dct_ijg.go parity properties) -------------------

def test_fdct_dc_of_flat_block():
    """Flat block: all energy in DC, scaled by 8 << PASS1 before quant."""
    blk = np.full((1, 8, 8), 25, dtype=np.int32)
    out = dct_int.fdct8x8_islow(blk, np)
    q = dct_int.quantize_islow(out, np.ones((8, 8), dtype=np.int32) * 8, np)
    assert q[0, 0, 0] == 25  # DC/8 with qstep 8 recovers the sample value
    assert (q[0].reshape(64)[1:] == 0).all()


def test_fdct_idct_roundtrip_8bit(rng):
    """Unquantized (qtable=1) islow roundtrip is near-exact for 8-bit."""
    blk = rng.integers(-128, 128, size=(4, 8, 8)).astype(np.int32)
    ones = np.ones((8, 8), dtype=np.int32)
    coeffs = dct_int.quantize_islow(dct_int.fdct8x8_islow(blk, np), ones, np)
    back = dct_int.idct8x8_islow(coeffs, ones, np)
    assert np.abs(back - blk).max() <= 1


def test_fdct_idct_roundtrip_12bit(rng):
    blk = rng.integers(-2048, 2048, size=(4, 8, 8)).astype(np.int32)
    ones = np.ones((8, 8), dtype=np.int32)
    p1 = dct_int.pass1_bits(2048)
    coeffs = dct_int.quantize_islow(
        dct_int.fdct8x8_islow(blk, np, p1=p1), ones, np)
    back = dct_int.idct8x8_islow(coeffs, ones, np, p1=p1)
    # PASS1_BITS=1 trades one bit of internal precision for headroom
    assert np.abs(back - blk).max() <= 4


def test_descale_rounds_half_up():
    assert dct_int._descale(np.int64(7), 2) == 2   # 1.75 → 2
    assert dct_int._descale(np.int64(6), 2) == 2   # 1.5  → 2 (half up)
    assert dct_int._descale(np.int64(5), 2) == 1
    assert dct_int._descale(np.int64(-6), 2) == -1  # arithmetic shift


def test_pass1_bits_profile():
    assert dct_int.pass1_bits(128) == 2    # 8-bit classic
    assert dct_int.pass1_bits(2048) == 1   # 12-bit headroom profile


def test_fdct_matches_float_dct_closely(rng):
    """Integer islow stays within quantization noise of the exact DCT-II."""
    blk = rng.integers(-128, 128, size=(1, 8, 8)).astype(np.int32)
    ones = np.ones((8, 8), dtype=np.int32)
    got = dct_int.quantize_islow(dct_int.fdct8x8_islow(blk, np), ones, np)
    n = np.arange(8)
    c = np.cos((2 * n[:, None] + 1) * n[None, :] * np.pi / 16)
    m = c / 2.0
    m[:, 0] *= 1 / np.sqrt(2)
    exact = m.T @ blk[0].astype(np.float64) @ m
    assert np.abs(got[0] - exact).max() <= 2


def test_fix_constants_are_scaled_cosines():
    """FIX_x = round(x · 2^13) (dct_ijg.go constant table)."""
    assert dct_int.FIX_0_541196100 == round(0.541196100 * 8192)
    assert dct_int.FIX_1_847759065 == round(1.847759065 * 8192)
    assert dct_int.FIX_3_072711026 == round(3.072711026 * 8192)


# ---- P14 predictor formulas (predictors.go:12-54) ---------------------------

def test_predictor_formulas():
    ra, rb, rc = 100, 60, 40
    assert _predict(1, ra, rb, rc) == 100
    assert _predict(2, ra, rb, rc) == 60
    assert _predict(3, ra, rb, rc) == 40
    assert _predict(4, ra, rb, rc) == 120
    assert _predict(5, ra, rb, rc) == 100 + ((60 - 40) >> 1)
    assert _predict(6, ra, rb, rc) == 60 + ((100 - 40) >> 1)
    assert _predict(7, ra, rb, rc) == 80


def test_predictor_shift_floor_semantics():
    """>>1 floors negative halves (Go arithmetic shift parity)."""
    assert _predict(5, 0, 0, 3) == 0 + ((0 - 3) >> 1) == -2
    assert _predict(7, 1, -4, 0) == (1 + -4) >> 1 == -2


@pytest.mark.parametrize("predictor", range(1, 8))
def test_diffs_reconstruct_inverse(predictor, rng):
    plane = rng.integers(0, 4096, size=(9, 7)).astype(np.int64)
    diffs = encode_diffs(plane, predictor, 12)
    back = reconstruct(diffs, predictor, 12)
    np.testing.assert_array_equal(back, plane)


def test_first_sample_uses_default_prediction():
    """Sample (0,0) predicts 2^(P−1) for every predictor (T.81 H.1.2.2)."""
    plane = np.full((3, 3), 200, dtype=np.int64)
    for p in range(1, 8):
        diffs = encode_diffs(plane, p, 8)
        assert diffs[0, 0] == 200 - 128


def test_select_best_predictor_in_range(rng):
    planes = [rng.integers(0, 256, size=(16, 16)).astype(np.int64)]
    assert select_best_predictor(planes, 16, 16) in range(1, 8)


def test_select_best_predictor_horizontal_gradient():
    """Rows constant → vertical neighbor (pred 2) predicts perfectly."""
    plane = np.repeat(np.arange(32, dtype=np.int64)[None, :] * 5, 32, axis=0)
    plane = plane.T.copy()  # constant along rows, ramp down columns... keep both
    best = select_best_predictor([plane], 32, 32)
    assert best in range(1, 8)
    # perfect predictor yields bit-exact roundtrip regardless
    np.testing.assert_array_equal(
        reconstruct(encode_diffs(plane, best, 8), best, 8), plane)


# --- hostile SOF headers must raise typed errors (fuzz trial 30795) ---

def _patch_after(stream: bytes, marker: bytes, rel: int, val: int) -> bytes:
    """Overwrite the byte `rel` positions past the 2-byte marker+length."""
    i = stream.index(marker)
    b = bytearray(stream)
    b[i + 4 + rel] = val  # +2 marker, +2 length field
    return bytes(b)


def test_baseline_zero_sampling_factor_is_typed():
    from go_dicom_codec_jax.codecs import jpeg_baseline
    img = np.arange(64 * 64, dtype=np.uint8).reshape(64, 64)
    s = jpeg_baseline.encode(img.tobytes(), 64, 64, 1, 90)
    # SOF0 payload: precision(1) H(2) W(2) Nf(1) then [Ci, HiVi, Tqi]
    bad = _patch_after(s, b"\xff\xc0", 7, 0x00)  # HiVi := 0x00
    with pytest.raises(CorruptStreamError):
        jpeg_baseline.decode(bad)
    bad = _patch_after(s, b"\xff\xc0", 5, 0)  # Nf := 0
    with pytest.raises(CorruptStreamError):
        jpeg_baseline.decode(bad)


def test_baseline_zero_dimensions_are_typed():
    from go_dicom_codec_jax.codecs import jpeg_baseline
    img = np.arange(64 * 64, dtype=np.uint8).reshape(64, 64)
    s = jpeg_baseline.encode(img.tobytes(), 64, 64, 1, 90)
    bad = bytearray(s)
    i = s.index(b"\xff\xc0")
    bad[i + 4 + 1:i + 4 + 5] = b"\x00\x00\x00\x00"  # H := 0, W := 0
    with pytest.raises(CorruptStreamError):
        jpeg_baseline.decode(bytes(bad))


def test_p14_invalid_precision_is_typed():
    from go_dicom_codec_jax.codecs import jpeg_lossless
    img = np.arange(32 * 32, dtype=np.uint16).reshape(32, 32) % 4096
    s = jpeg_lossless.encode(img.astype("<u2").tobytes(), 32, 32, 1, 12,
                             predictor=1)
    bad = _patch_after(s, b"\xff\xc3", 0, 0)  # precision := 0
    with pytest.raises(CorruptStreamError):
        jpeg_lossless.decode(bad)


def test_jls_invalid_depth_is_typed():
    from go_dicom_codec_jax.codecs import jpegls
    img = np.arange(32 * 32, dtype=np.uint16).reshape(32, 32) % 4096
    s = jpegls.encode(img.astype("<u2").tobytes(), 32, 32, 1, 12)
    bad = _patch_after(s, b"\xff\xf7", 0, 0)  # depth := 0
    with pytest.raises(CorruptStreamError):
        jpegls.decode(bad)
