"""Tag-tree and packet-header bit IO unit tests.

Role of reference jpeg2000/t2/tagtree_test.go (410 LoC) and the bit-
stuffed header IO checks in packet_header_bitio.go tests: threshold-
incremental encode/decode agreement on grids of every shape, plus the
JPEG 2000 bit-stuffing rule (a 0 bit is forced after any 0xFF byte).
"""

import numpy as np
import pytest

from go_dicom_codec_jax.t2.bitio import BioReader, BioWriter
from go_dicom_codec_jax.t2.tagtree import TagTree


def _roundtrip_tree(values: np.ndarray, thresholds) -> None:
    h, w = values.shape
    enc = TagTree(w, h)
    for y in range(h):
        for x in range(w):
            enc.set_value(x, y, int(values[y, x]))
    bw = BioWriter()
    for t in thresholds:
        for y in range(h):
            for x in range(w):
                enc.encode(bw, x, y, t)
    data = bw.flush()

    dec = TagTree(w, h)
    br = BioReader(data)
    for t in thresholds:
        for y in range(h):
            for x in range(w):
                got = dec.decode(br, x, y, t)
                want = int(values[y, x])
                # decode reports whether value < t once determined
                if want < t:
                    assert got == want, (x, y, t)


@pytest.mark.parametrize("shape", [(1, 1), (2, 2), (3, 3), (4, 4),
                                   (1, 7), (7, 1), (5, 3), (8, 8),
                                   (6, 9)])
def test_tagtree_shapes_roundtrip(shape, rng):
    h, w = shape
    values = rng.integers(0, 8, (h, w))
    _roundtrip_tree(values, thresholds=range(1, 10))


def test_tagtree_uniform_values(rng):
    _roundtrip_tree(np.full((4, 4), 3), thresholds=range(1, 6))


def test_tagtree_zero_values():
    _roundtrip_tree(np.zeros((5, 5), dtype=int), thresholds=range(1, 4))


def test_tagtree_single_large_value():
    v = np.zeros((4, 4), dtype=int)
    v[2, 1] = 12
    _roundtrip_tree(v, thresholds=range(1, 15))


def test_tagtree_reset_reuses_tree(rng):
    t = TagTree(3, 3)
    for y in range(3):
        for x in range(3):
            t.set_value(x, y, int(rng.integers(0, 5)))
    bw = BioWriter()
    t.encode(bw, 0, 0, 5)
    t.reset()
    for y in range(3):
        for x in range(3):
            t.set_value(x, y, 1)
    bw2 = BioWriter()
    t.encode(bw2, 0, 0, 3)
    dec = TagTree(3, 3)
    got = dec.decode(BioReader(bw2.flush()), 0, 0, 3)
    assert got == 1


def test_bitio_roundtrip(rng):
    bits = rng.integers(0, 2, 300).tolist()
    w = BioWriter()
    for b in bits:
        w.write_bit(b)
    r = BioReader(w.flush())
    assert [r.read_bit() for _ in bits] == bits


def test_bitio_stuffing_after_ff():
    """After emitting 0xFF the writer uses a 7-bit byte (B.10.1)."""
    w = BioWriter()
    for _ in range(8):
        w.write_bit(1)  # first byte 0xFF
    for _ in range(8):
        w.write_bit(0)
    data = w.flush()
    assert data[0] == 0xFF
    # second byte carries only 7 payload bits: MSB is the stuffed 0
    assert data[1] & 0x80 == 0
    r = BioReader(data)
    assert [r.read_bit() for _ in range(16)] == [1] * 8 + [0] * 8


def test_bitio_write_bits_wide_values(rng):
    vals = [(0x1FF, 9), (0, 3), (0b101, 3), (0xFFFF, 16), (1, 1)]
    w = BioWriter()
    for v, n in vals:
        w.write_bits(v, n)
    r = BioReader(w.flush())
    for v, n in vals:
        assert r.read_bits(n) == v


def test_bitio_align_skips_to_byte(rng):
    w = BioWriter()
    w.write_bits(0b101, 3)
    data = w.flush()
    r = BioReader(data)
    r.read_bits(3)
    r.align_to_byte()
    assert r.bytes_read() >= 1
