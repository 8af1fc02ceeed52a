"""Golomb-Rice coder unit tests.

Role of reference jpegls/lossless/golomb*_test.go: bit-level writer/
reader contracts (T.87 A.1 stuffing), mapped-value coding with the
limit escape, and k-parameter sweeps.
"""

import numpy as np
import pytest

from go_dicom_codec_jax.entropy.golomb import GolombReader, GolombWriter


def test_bit_writer_reader_roundtrip(rng):
    bits = rng.integers(0, 2, 200).tolist()
    w = GolombWriter()
    for b in bits:
        w.write_bit(b)
    data = w.finish()
    r = GolombReader(data)
    assert [r.read_bit() for _ in bits] == bits


def test_write_bits_matches_write_bit(rng):
    values = [(0b1011, 4), (0, 1), (1, 1), (0x7F, 7), (0b110010101, 9)]
    w1 = GolombWriter()
    w2 = GolombWriter()
    for v, n in values:
        w1.write_bits(v, n)
        for i in range(n - 1, -1, -1):
            w2.write_bit((v >> i) & 1)
    assert w1.finish() == w2.finish()


def test_ff_stuffing_inserted():
    """After an 0xFF byte only 7 data bits follow (T.87 A.1)."""
    w = GolombWriter()
    for _ in range(16):
        w.write_bit(1)
    data = w.finish()
    assert data[0] == 0xFF
    # next byte's top bit is a stuffed 0
    assert data[1] & 0x80 == 0 or data[1] <= 0x7F


def test_ff_stuffing_roundtrips(rng):
    """Long all-ones runs (maximal stuffing) survive."""
    w = GolombWriter()
    n = 500
    for _ in range(n):
        w.write_bit(1)
    r = GolombReader(w.finish())
    assert all(r.read_bit() == 1 for _ in range(n))


def test_unary_roundtrip():
    w = GolombWriter()
    for n in (0, 1, 5, 31):
        w.write_unary(n)
    r = GolombReader(w.finish())
    for n in (0, 1, 5, 31):
        got = 0
        while r.read_bit() == 0:
            got += 1
        assert got == n


@pytest.mark.parametrize("k", [0, 1, 2, 4, 7])
def test_mapped_value_roundtrip(k, rng):
    limit, qbpp = 64, 8
    vals = rng.integers(0, 1 << qbpp, 100).tolist()
    w = GolombWriter()
    for v in vals:
        w.encode_mapped(k, v, limit, qbpp)
    r = GolombReader(w.finish())
    assert [r.decode_value(k, limit, qbpp) for _ in vals] == vals


def test_mapped_limit_escape():
    """Values whose unary part would exceed limit take the escape
    (limit - qbpp - 1 zeros + qbpp raw bits, T.87 A.5.3)."""
    k, limit, qbpp = 0, 16, 8
    big = 255  # unary part 255 >> 0 = 255 >= limit - qbpp - 1
    w = GolombWriter()
    w.encode_mapped(k, big, limit, qbpp)
    data = w.finish()
    r = GolombReader(data)
    assert r.decode_value(k, limit, qbpp) == big
    # escape representation is far shorter than 255 unary bits
    assert len(data) <= (limit + 7) // 8 + 2


def test_mapped_many_random_k_mix(rng):
    limit, qbpp = 32, 12
    seq = [(int(rng.integers(0, 8)), int(rng.integers(0, 1 << qbpp)))
           for _ in range(300)]
    w = GolombWriter()
    for k, v in seq:
        w.encode_mapped(k, v, limit, qbpp)
    r = GolombReader(w.finish())
    for k, v in seq:
        assert r.decode_value(k, limit, qbpp) == v


def test_reader_past_end_returns_one_fill():
    """Reads past the stream see 1-bits (0xFF marker-fill semantics,
    matching CharLS reading into padding)."""
    r = GolombReader(b"")
    assert [r.read_bit() for _ in range(16)] == [1] * 16
