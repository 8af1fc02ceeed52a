"""JPEG bit IO + marker segment IO unit tests.

Role of reference jpeg/standard/{huffman_encoder,reader,writer}_test.go:
0xFF-stuffing writer/reader rules, marker framing, fill-byte handling,
scan-end detection with RSTn, and JPEG-LS's different stuffing regime.
"""

import numpy as np
import pytest

from go_dicom_codec_jax.codestream import jpeg_markers as mk
from go_dicom_codec_jax.errors import CorruptStreamError
from go_dicom_codec_jax.utils.npbits import (BitReader, destuff_ff,
                                             pack_bits_msb, stuff_ff)


def test_pack_bits_msb_known_vector():
    vals = np.asarray([0b1, 0b01, 0b111], dtype=np.int64)
    lens = np.asarray([1, 2, 3], dtype=np.int64)
    data = pack_bits_msb(vals, lens)
    # 1 01 111 + pad(1s) -> 0b10111111
    assert bytes(data[:1]) == bytes([0b10111111])


def test_stuff_destuff_inverse(rng):
    raw = rng.integers(0, 256, 500).astype(np.uint8)
    stuffed = stuff_ff(raw)
    back = destuff_ff(stuffed)
    np.testing.assert_array_equal(back, raw)


def test_stuff_inserts_zero_after_ff():
    out = stuff_ff(np.asarray([0x12, 0xFF, 0x34], dtype=np.uint8))
    assert out == bytes([0x12, 0xFF, 0x00, 0x34])


def test_bitreader_msb_first():
    br = BitReader(np.asarray([0b10110001], dtype=np.uint8))
    assert br.take(1) == 1
    assert br.take(3) == 0b011
    assert br.take(4) == 0b0001


def test_jpeg_writer_reader_roundtrip():
    w = mk.JpegWriter()
    w.write_marker(mk.SOI)
    w.write_segment(mk.COM, b"hello")
    w.write_marker(mk.EOI)
    data = w.get_bytes()
    r = mk.JpegReader(data)
    assert r.read_marker() == mk.SOI
    assert r.read_marker() == mk.COM
    assert r.read_segment() == b"hello"
    assert r.read_marker() == mk.EOI


def test_reader_skips_fill_bytes():
    """0xFF fill bytes before a marker are consumed (T.81 B.1.1.2)."""
    data = bytes([0xFF, 0xD8, 0xFF, 0xFF, 0xFF, 0xD9])
    r = mk.JpegReader(data)
    assert r.read_marker() == mk.SOI
    assert r.read_marker() == mk.EOI


def test_find_scan_end_stops_at_marker():
    w = mk.JpegWriter()
    w.write_marker(mk.SOI)
    data = w.get_bytes() + bytes([0x11, 0xFF, 0x00, 0x22, 0xFF, 0xD9])
    r = mk.JpegReader(data)
    r.read_marker()
    scan, pos = r.find_scan_end()
    assert scan == bytes([0x11, 0xFF, 0x00, 0x22])
    assert r.read_marker() == mk.EOI


def test_find_scan_end_keeps_rst_markers():
    data = bytes([0xFF, 0xD8, 0x01, 0xFF, 0xD0, 0x02, 0xFF, 0xD9])
    r = mk.JpegReader(data)
    r.read_marker()
    scan, _ = r.find_scan_end()
    assert scan == bytes([0x01, 0xFF, 0xD0, 0x02])


def test_find_scan_end_ls_mode():
    """JPEG-LS: 0xFF + <0x80 is data, only 0xFF + >=0x80 ends the scan
    (T.87 A.1)."""
    data = bytes([0xFF, 0xD8, 0xFF, 0x7F, 0x55, 0xFF, 0xD9])
    r = mk.JpegReader(data)
    r.read_marker()
    scan, _ = r.find_scan_end(ls_mode=True)
    assert scan == bytes([0xFF, 0x7F, 0x55])


def test_truncated_segment_raises():
    data = bytes([0xFF, 0xD8, 0xFF, 0xFE, 0x00, 0x10, 0x01])
    r = mk.JpegReader(data)
    r.read_marker()
    r.read_marker()
    with pytest.raises(CorruptStreamError):
        r.read_segment()


def test_segment_length_includes_itself():
    w = mk.JpegWriter()
    w.write_segment(mk.COM, b"abc")
    data = w.get_bytes()
    assert data[0] == 0xFF and data[1] == mk.COM
    assert (data[2] << 8 | data[3]) == 5  # 2 length bytes + 3 payload
