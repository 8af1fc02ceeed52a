"""Entropy-layer edge units toward reference test depth (VERDICT r3 #7):
optimal-Huffman properties (reference optimal_huffman_test.go class),
JPEG marker-level hygiene through the byte codecs, JPEG-LS parameter
edges, and PackBits boundary behavior.
"""

import numpy as np
import pytest

from go_dicom_codec_jax.codecs import jpeg_common as jc
from go_dicom_codec_jax.codecs import jpeg_baseline as jb
from go_dicom_codec_jax.entropy import huffman as hf
from go_dicom_codec_jax.errors import CorruptStreamError


# ---- optimal Huffman properties (T.81 K.2) ----------------------------------

def test_optimal_table_max_code_length_16():
    """Extremely skewed histograms must still produce <=16-bit codes."""
    freq = np.zeros(256, dtype=np.int64)
    for i in range(40):
        freq[i] = 1 << min(i, 40)     # exponential skew
    tab = hf.build_optimal_table(freq)
    lens = [tab.len_of[i] for i in range(256) if tab.len_of[i]]
    assert lens and max(lens) <= 16


def test_optimal_table_single_symbol():
    freq = np.zeros(256, dtype=np.int64)
    freq[42] = 100
    tab = hf.build_optimal_table(freq)
    assert tab.len_of[42] >= 1        # a real code, not zero bits


def test_optimal_table_all_symbols_uniform():
    freq = np.ones(256, dtype=np.int64)
    tab = hf.build_optimal_table(freq)
    lens = [tab.len_of[i] for i in range(256)]
    assert all(1 <= l <= 16 for l in lens)


def test_optimal_table_kraft_inequality():
    rng = np.random.default_rng(0)
    freq = rng.integers(0, 1000, 256).astype(np.int64)
    tab = hf.build_optimal_table(freq)
    kraft = sum(2.0 ** -tab.len_of[i]
                for i in range(256) if tab.len_of[i])
    assert kraft <= 1.0 + 1e-9


def test_optimal_table_codes_prefix_free():
    rng = np.random.default_rng(1)
    freq = rng.integers(0, 50, 256).astype(np.int64)
    freq[freq < 5] = 0
    tab = hf.build_optimal_table(freq)
    codes = [(tab.code_of[i], tab.len_of[i])
             for i in range(256) if tab.len_of[i]]
    as_bits = [format(c, f"0{l}b") for c, l in codes]
    for i, a in enumerate(as_bits):
        for j, b in enumerate(as_bits):
            if i != j:
                assert not b.startswith(a)


def test_optimal_table_reserves_all_ones():
    """K.2 reserves the all-ones code (pseudo-symbol 256)."""
    freq = np.ones(256, dtype=np.int64)
    tab = hf.build_optimal_table(freq)
    for i in range(256):
        l = tab.len_of[i]
        if l:
            assert tab.code_of[i] != (1 << l) - 1 or l == 16


def test_dht_payload_parse_roundtrip():
    freq = np.zeros(256, dtype=np.int64)
    freq[:12] = np.arange(1, 13)
    tab = hf.build_optimal_table(freq)
    payload = hf.dht_payload([(0, 0, tab)])
    assert payload[0] == 0x00          # class 0, id 0
    assert sum(payload[1:17]) == len(payload) - 17


# ---- quant table scaling (Annex K quality curve) ----------------------------

@pytest.mark.parametrize("q", [1, 25, 50, 75, 100])
def test_scale_quant_table_range(q):
    t = jc.scale_quant_table(jc.LUMA_QUANT, q, 255)
    assert t.min() >= 1 and t.max() <= 255


def test_scale_quant_table_monotone_quality():
    t10 = jc.scale_quant_table(jc.LUMA_QUANT, 10, 255)
    t90 = jc.scale_quant_table(jc.LUMA_QUANT, 90, 255)
    assert t10.sum() > t90.sum()       # lower quality = coarser steps


def test_scale_quant_table_q50_is_base():
    t = jc.scale_quant_table(jc.LUMA_QUANT, 50, 255)
    np.testing.assert_array_equal(t, np.clip(jc.LUMA_QUANT, 1, 255))


# ---- JPEG stream hygiene through the byte codec ------------------------------

def _gray(rng, h=48, w=40):
    return rng.integers(0, 256, (h, w)).astype(np.uint8)


def test_jpeg_appn_and_com_segments_skipped(rng):
    img = _gray(rng)
    data = jb.encode(img.tobytes(), 40, 48, 1, 90)
    # inject APP1 + COM right after SOI
    app1 = b"\xff\xe1" + (10).to_bytes(2, "big") + b"Exif\x00\x00ab"
    com = b"\xff\xfe" + (7).to_bytes(2, "big") + b"hello"
    spliced = data[:2] + app1 + com + data[2:]
    pix, w, h, c = jb.decode(spliced)
    assert (w, h, c) == (40, 48, 1)
    assert pix == jb.decode(data)[0]


def test_jpeg_trailing_garbage_after_eoi_tolerated(rng):
    img = _gray(rng)
    data = jb.encode(img.tobytes(), 40, 48, 1, 90)
    pix, *_ = jb.decode(data + b"\x00garbage\xff\xd9")
    assert pix == jb.decode(data)[0]


def test_jpeg_truncated_scan_raises(rng):
    img = _gray(rng)
    data = jb.encode(img.tobytes(), 40, 48, 1, 90)
    with pytest.raises((CorruptStreamError, Exception)):
        jb.decode(data[: len(data) // 2])


def test_jpeg_restart_interval_wraps_past_rst7(rng):
    """More than 8 restart intervals cycles RST0..RST7 (T.81 B.2.4.4) —
    driven through PIL's encoder; our decoder must resync each RSTn."""
    PIL_Image = pytest.importorskip("PIL.Image")
    import io

    img = _gray(rng, 80, 80)           # 100 blocks
    buf = io.BytesIO()
    PIL_Image.fromarray(img).save(buf, format="JPEG", quality=90,
                                  restart_marker_blocks=1)
    data = buf.getvalue()
    rsts = {data[i + 1] - 0xD0 for i in range(len(data) - 1)
            if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7}
    assert rsts == set(range(8))       # wraps past RST7
    pix, w, h, c = jb.decode(data)
    got = np.frombuffer(pix, np.uint8).reshape(80, 80)
    assert np.abs(got.astype(int) - img.astype(int)).max() <= 32


def test_jpeg_16bit_dqt_for_12bit(rng):
    """12-bit extended uses 16-bit DQT entries when steps exceed 255."""
    from go_dicom_codec_jax.codecs import jpeg_extended as je
    img = rng.integers(0, 4096, (48, 40)).astype("<u2")
    data = je.encode(img.tobytes(), 40, 48, 1, 12, 20)   # low quality
    pix, w, h, c, bd = je.decode(data)
    assert (w, h, c, bd) == (40, 48, 1, 12)


# ---- JPEG-LS parameter edges -------------------------------------------------

def test_jls_custom_thresholds_roundtrip(rng):
    from go_dicom_codec_jax.codecs.jpegls import Traits
    t = Traits(maxval=255, near=0)
    # T.87 defaults for 8-bit
    assert (t.t1, t.t2, t.t3) == (3, 7, 21)
    t2 = Traits(maxval=1023, near=0)
    assert t2.t1 >= 3 and t2.t3 >= t2.t2 >= t2.t1


def test_jls_small_maxval(rng):
    from go_dicom_codec_jax.codecs import jpegls
    img = rng.integers(0, 16, (24, 20)).astype(np.uint8)
    data = jpegls.encode(img.tobytes(), 20, 24, 1, 4, 0)
    out, w, h, c, bits, near = jpegls.decode(data)
    assert bits == 4 and out == img.tobytes()


@pytest.mark.parametrize("near", [1, 2, 7])
def test_jls_near_error_bound_exact(near, rng):
    from go_dicom_codec_jax.codecs import jpegls
    img = rng.integers(0, 256, (32, 32)).astype(np.uint8)
    data = jpegls.encode(img.tobytes(), 32, 32, 1, 8, near)
    out, *_ = jpegls.decode(data)
    err = np.abs(np.frombuffer(out, np.uint8).astype(int)
                 - img.reshape(-1).astype(int))
    assert err.max() <= near


def test_jls_truncated_header_raises(rng):
    from go_dicom_codec_jax.codecs import jpegls
    img = rng.integers(0, 256, (32, 32)).astype(np.uint8)
    data = jpegls.encode(img.tobytes(), 32, 32, 1, 8, 0)
    with pytest.raises(Exception):
        jpegls.decode(data[:10])       # cut inside the header


# ---- PackBits boundaries -----------------------------------------------------

def _pb_roundtrip(data: bytes) -> bytes:
    from go_dicom_codec_jax.entropy.rlepack import (packbits_decode,
                                                    packbits_encode)
    enc = packbits_encode(np.frombuffer(data, dtype=np.uint8))
    return np.asarray(packbits_decode(enc, len(data))).tobytes()


def test_packbits_literal_run_127_boundary():
    data = bytes(range(200)) * 2       # long literal stretches
    assert _pb_roundtrip(data) == data


def test_packbits_replicate_run_128_boundary():
    for n in (127, 128, 129, 255, 256, 300):
        data = b"\xAB" * n
        assert _pb_roundtrip(data) == data


def test_packbits_alternating_worst_case():
    data = bytes([0, 255] * 100)
    assert _pb_roundtrip(data) == data


def test_packbits_empty():
    assert _pb_roundtrip(b"") == b""
