"""MQ coder + EBCOT T1 roundtrip tests.

Mirrors the reference's mqc state-machine checks and t1 geometry sweeps
(mqc/*_test.go, t1/test_square_sizes_test.go, partial_block_test.go).
"""

import numpy as np
import pytest

from go_dicom_codec_jax.entropy.ebcot import (
    SC_LUT, SPB_LUT, STYLE_LAZY, STYLE_RESET, STYLE_SEGSYM, STYLE_TERMALL,
    STYLE_VSC, ZC_LUT, T1Decoder, T1Encoder, max_bitplanes)
from go_dicom_codec_jax.entropy.mq import MQDecoder, MQEncoder


def test_mq_roundtrip_random_bits(rng):
    bits = rng.integers(0, 2, size=2000).tolist()
    ctxs = rng.integers(0, 19, size=2000).tolist()
    enc = MQEncoder()
    for b, c in zip(bits, ctxs):
        enc.encode(b, c)
    enc.flush()
    data = enc.get_buffer()
    dec = MQDecoder(data)
    got = [dec.decode(c) for c in ctxs]
    assert got == bits


def test_mq_roundtrip_skewed(rng):
    # mostly-MPS stream exercises renormalization rarely
    bits = (rng.random(5000) < 0.02).astype(int).tolist()
    enc = MQEncoder()
    for b in bits:
        enc.encode(b, 5)
    enc.flush()
    dec = MQDecoder(enc.get_buffer())
    got = [dec.decode(5) for _ in bits]
    assert got == bits
    # skewed stream compresses far below 1 bit/symbol
    assert len(enc.get_buffer()) < len(bits) // 16


def test_mq_empty_flush():
    enc = MQEncoder()
    enc.flush()
    data = enc.get_buffer()
    dec = MQDecoder(data)  # must not crash
    dec.decode(0)


def test_zc_lut_spec_values():
    """Spot-check T.800 Table D.1 derivations (9-bit idx: NW,N,NE,W,-,E,SW,S,SE)."""
    # orientation 0 (LL): no neighbors → 0; one diagonal → 1; N only → 3
    assert ZC_LUT[0, 0] == 0
    assert ZC_LUT[0, 1] == 1          # NW
    assert ZC_LUT[0, 2] == 3          # N
    assert ZC_LUT[0, 8] == 5          # W
    assert ZC_LUT[0, 8 | 2] == 7      # W+N
    assert ZC_LUT[0, 8 | 32] == 8     # W+E
    # HL swaps h/v: N alone behaves like W
    assert ZC_LUT[1, 2] == 5
    assert ZC_LUT[1, 8] == 3
    # LH same table as LL
    np.testing.assert_array_equal(ZC_LUT[0], ZC_LUT[2])
    # HH: diag-driven
    assert ZC_LUT[3, 1] == 3          # d=1, h+v=0
    assert ZC_LUT[3, 2] == 1          # d=0, h+v=1
    assert ZC_LUT[3, 1 | 4 | 64] == 8  # d=3


def test_sc_lut_spec_values():
    # no neighbors → ctx 9, predict positive
    assert SC_LUT[0] == 9 and SPB_LUT[0] == 0
    # W significant positive → H=1 → ctx 12, predict +
    assert SC_LUT[1 << 3] == 12 and SPB_LUT[1 << 3] == 0
    # W significant negative → H=-1 → ctx 12, predict -
    assert SC_LUT[(1 << 3) | 1] == 12 and SPB_LUT[(1 << 3) | 1] == 1
    # N sig positive → V=1 → ctx 10
    assert SC_LUT[1 << 1] == 10 and SPB_LUT[1 << 1] == 0
    # W+ and N+ → ctx 13
    assert SC_LUT[(1 << 3) | (1 << 1)] == 13


def _t1_roundtrip(data, style=0, orient=0):
    h, w = data.shape
    enc = T1Encoder(w, h, style=style, orientation=orient)
    stream, numbps, passes = enc.encode(data)
    assert numbps == max_bitplanes(data)
    dec = T1Decoder(w, h, style=style, orientation=orient)
    segs = None
    if style & (STYLE_TERMALL | STYLE_LAZY):
        segs = [p.rate for p in passes if p.terminated]
    got = dec.decode(stream, len(passes), numbps, seg_lengths=segs)
    np.testing.assert_array_equal(got, data)
    return stream


SIZES = [(4, 4), (8, 8), (64, 64), (5, 7), (1, 1), (3, 64), (64, 3), (13, 29)]


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("orient", [0, 1, 2, 3])
def test_t1_roundtrip_sizes(size, orient, rng):
    h, w = size
    data = rng.integers(-200, 200, size=(h, w)).astype(np.int32)
    _t1_roundtrip(data, orient=orient)


@pytest.mark.parametrize("style", [0, STYLE_TERMALL, STYLE_RESET,
                                   STYLE_TERMALL | STYLE_RESET, STYLE_SEGSYM,
                                   STYLE_LAZY, STYLE_LAZY | STYLE_TERMALL,
                                   STYLE_VSC, STYLE_VSC | STYLE_SEGSYM])
def test_t1_roundtrip_styles(style, rng):
    data = rng.integers(-4000, 4000, size=(16, 16)).astype(np.int32)
    _t1_roundtrip(data, style=style)


def test_t1_sparse_and_extreme(rng):
    data = np.zeros((32, 32), dtype=np.int32)
    data[3, 7] = -1
    data[30, 31] = 1 << 20
    data[0, 0] = -(1 << 19)
    _t1_roundtrip(data)


def test_t1_all_zero():
    data = np.zeros((16, 16), dtype=np.int32)
    enc = T1Encoder(16, 16)
    stream, numbps, passes = enc.encode(data)
    assert numbps == 0 and passes == []
    dec = T1Decoder(16, 16)
    got = dec.decode(stream, 0, 0)
    np.testing.assert_array_equal(got, data)


def test_t1_compresses_smooth(rng):
    base = np.cumsum(rng.integers(-3, 4, size=(64, 64)), axis=1)
    data = base.astype(np.int32)
    stream = _t1_roundtrip(data)
    assert len(stream) < 64 * 64 * 2  # beats raw 16-bit
