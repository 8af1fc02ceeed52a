"""HTJ2K primitive unit tests: MEL / VLC / MagSgn / UVLC writers+readers.

Mirrors the reference's per-primitive suites (htj2k/mel.go tests via
openjph_cleanup_test.go, magsgn.go tests, uvlc_{encoder,decoder,tables}
_test.go, vlc_roundtrip_test.go, block_layout_test.go, unsigned_test.go)
at the unit level — the stream machinery the block-level roundtrips in
test_htj2k.py exercise only end-to-end.
"""

import numpy as np
import pytest

from go_dicom_codec_jax.entropy.htcleanup import (HTCleanupDecoder,
                                                  HTCleanupEncoder,
                                                  MELReader, MELWriter,
                                                  MagSgnReader, MagSgnWriter,
                                                  VLCReader, VLCWriter,
                                                  _uvlc_code)
from go_dicom_codec_jax.errors import CorruptStreamError


# ---- MEL adaptive run-length coder ------------------------------------------

def _mel_decode_events(cleanup: bytes, n: int) -> list:
    """Replay the decoder's run-consumption protocol to recover events."""
    rdr = MELReader(cleanup)
    run = rdr.get_run()
    out = []
    while len(out) < n:
        run -= 2
        out.append(1 if run == -1 else 0)
        if run < 0:
            run = rdr.get_run()
    return out


def _mel_terminate(mel: MELWriter) -> bytes:
    mel_b, vlc_b = HTCleanupEncoder._terminate(mel, VLCWriter())
    return mel_b + vlc_b


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mel_event_roundtrip_random(seed):
    rng = np.random.default_rng(seed)
    events = (rng.random(120) < 0.3).astype(int).tolist()
    wtr = MELWriter()
    for e in events:
        wtr.encode(bool(e))
    got = _mel_decode_events(_mel_terminate(wtr), len(events))
    assert got == events


def test_mel_all_zero_events():
    wtr = MELWriter()
    for _ in range(64):
        wtr.encode(False)
    assert _mel_decode_events(_mel_terminate(wtr), 64) == [0] * 64


def test_mel_all_one_events():
    wtr = MELWriter()
    for _ in range(32):
        wtr.encode(True)
    assert wtr.k == 0  # ones keep the state at minimum
    assert _mel_decode_events(_mel_terminate(wtr), 32) == [1] * 32


def test_mel_alternating_events():
    events = [0, 1] * 40
    wtr = MELWriter()
    for e in events:
        wtr.encode(bool(e))
    assert _mel_decode_events(_mel_terminate(wtr), len(events)) == events


def test_mel_writer_stuffing_after_ff():
    """A 0xFF output byte leaves only 7 valid bits in the next byte."""
    wtr = MELWriter()
    # thresholds 1,1,1,2,2,2,4,4: 17 zero events complete 8 runs → 8 '1' bits
    for _ in range(17):
        wtr.encode(False)
    # 8 ones → first byte 0xFF; writer must switch to 7-bit stuffing mode
    assert bytes(wtr.buf) == b"\xff"
    assert wtr.rem == 7


def test_mel_reader_exhausted_returns_ones():
    """Reading past the segment yields 1-bits (spec: all-ones tail)."""
    rdr = MELReader(b"\x00\x00")
    for _ in range(64):
        assert rdr._read_bit() in (0, 1)
    # now exhausted — must keep returning 1 forever, not raise
    assert all(rdr._read_bit() == 1 for _ in range(16))


def test_mel_k_bounds():
    wtr = MELWriter()
    for _ in range(10_000):
        wtr.encode(False)
    assert wtr.k == 12
    for _ in range(50):
        wtr.encode(True)
    assert wtr.k == 0  # never below zero


# ---- VLC backward-grown writer / reader -------------------------------------

def _vlc_roundtrip(codewords):
    """Write (cwd, n) pairs, terminate as the encoder does, read back."""
    vlc = VLCWriter()
    for cwd, n in codewords:
        vlc.encode(cwd, n)
    mel_b, vlc_b = HTCleanupEncoder._terminate(MELWriter(), vlc)
    cleanup = mel_b + vlc_b
    rdr = VLCReader(cleanup[::-1])
    return [rdr.read_bits(n) for _, n in codewords]


def test_vlc_roundtrip_simple():
    cws = [(0x5, 3), (0x1, 1), (0x7F, 7), (0x0, 4), (0x3A, 6)]
    assert _vlc_roundtrip(cws) == [c for c, _ in cws]


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_vlc_roundtrip_random(seed):
    rng = np.random.default_rng(seed)
    cws = [(int(rng.integers(0, 1 << n)), n)
           for n in rng.integers(1, 8, size=100).tolist()]
    assert _vlc_roundtrip(cws) == [c for c, _ in cws]


def test_vlc_roundtrip_stuff_heavy():
    """All-ones codewords exercise the >0x8F / 0x7F unstuffing rule."""
    cws = [((1 << 7) - 1, 7)] * 40
    assert _vlc_roundtrip(cws) == [(1 << 7) - 1] * 40


def test_vlc_initial_byte_prefilled():
    """buf[0] is the 0xFF Scup placeholder; first nibble of data is 0xF."""
    vlc = VLCWriter()
    assert bytes(vlc.buf) == b"\xff"
    assert vlc.tmp == 0xF and vlc.used == 4


def test_vlc_bytes_reversed_layout():
    """Final segment = payload reversed with the 0xFF placeholder last."""
    vlc = VLCWriter()
    vlc.encode(0xA, 4)  # fills byte 1 to 0xAF
    vlc.encode(0x55, 7)
    seg = vlc.bytes_reversed()
    assert seg[-1] == 0xFF
    assert seg[0] == vlc.buf[-1]


# ---- MagSgn LSB-first packer / reader ---------------------------------------

@pytest.mark.parametrize("seed", [6, 7])
def test_magsgn_roundtrip_random(seed):
    rng = np.random.default_rng(seed)
    fields = [(int(rng.integers(0, 1 << n)), n)
              for n in rng.integers(0, 16, size=80).tolist()]
    wtr = MagSgnWriter()
    for v, n in fields:
        wtr.encode(v, n)
    wtr.terminate()
    rdr = MagSgnReader(bytes(wtr.buf))
    assert [rdr.fetch(n) for _, n in fields] == [v for v, _ in fields]


def test_magsgn_ff_stuffing():
    """After writing 0xFF the next byte carries only 7 payload bits."""
    wtr = MagSgnWriter()
    wtr.encode(0xFF, 8)
    assert bytes(wtr.buf) == b"\xff" and wtr.maxbits == 7
    wtr.encode(0x55, 8)
    wtr.terminate()
    rdr = MagSgnReader(bytes(wtr.buf))
    assert rdr.fetch(8) == 0xFF
    assert rdr.fetch(8) == 0x55


def test_magsgn_terminate_pads_with_ones():
    wtr = MagSgnWriter()
    wtr.encode(0x1, 3)
    wtr.terminate()
    # partial byte flushed with 1-padding: 0b11111001
    assert bytes(wtr.buf) == bytes([0b11111001])


def test_magsgn_terminate_drops_redundant_ff_tail():
    """A clean 0xFF boundary with no residue drops the implied tail byte."""
    wtr = MagSgnWriter()
    wtr.encode(0xFF, 8)
    wtr.terminate()
    assert bytes(wtr.buf) == b""  # reader refetches 0xFF implicitly
    rdr = MagSgnReader(b"")
    assert rdr.fetch(8) == 0xFF  # exhausted reader yields ones


def test_magsgn_zero_length_fetch():
    rdr = MagSgnReader(b"\xaa")
    assert rdr.fetch(0) == 0
    assert rdr.fetch(8) == 0xAA


# ---- UVLC u-value coding -----------------------------------------------------

def test_uvlc_code_table():
    """Prefix/suffix split per 15444-15 Table C.23 (encoder :172-194)."""
    assert _uvlc_code(0) == (0, 0, 0, 0)
    assert _uvlc_code(1) == (1, 1, 0, 0)
    assert _uvlc_code(2) == (2, 2, 0, 0)
    assert _uvlc_code(3) == (4, 3, 0, 1)
    assert _uvlc_code(4) == (4, 3, 1, 1)
    assert _uvlc_code(5) == (0, 3, 0, 5)
    assert _uvlc_code(36) == (0, 3, 31, 5)


def test_uvlc_code_monotone_total_length():
    """Total bit cost is non-decreasing in the coded value."""
    costs = []
    for u in range(1, 37):
        _, plen, _, slen = _uvlc_code(u)
        costs.append(plen + slen)
    assert costs == sorted(costs)


def test_uvlc_suffix_range():
    for u in range(1, 37):
        pre, plen, suf, slen = _uvlc_code(u)
        assert 0 <= suf < (1 << slen) if slen else suf == 0
        assert 0 <= pre < (1 << plen) if plen else pre == 0


# ---- block-level edges (block_layout / unsigned / partial-quad mirrors) ------

def _roundtrip(data: np.ndarray) -> np.ndarray:
    h, w = data.shape
    numbps = int(np.abs(data).max()).bit_length()
    kmax = max(numbps + 2, 2)
    blob = HTCleanupEncoder(w, h, kmax).encode(data.astype(np.int32))
    if blob is None:
        return np.zeros_like(data)
    return HTCleanupDecoder(w, h, kmax, kmax - 1).decode(blob)


@pytest.mark.parametrize("corner", [(0, 0), (0, -1), (-1, 0), (-1, -1)])
def test_ht_single_sample_corners(corner):
    data = np.zeros((12, 12), dtype=np.int32)
    data[corner] = -77
    np.testing.assert_array_equal(_roundtrip(data), data)


@pytest.mark.parametrize("shape", [(1, 1), (1, 4), (4, 1), (2, 5), (5, 2),
                                   (3, 9), (9, 3), (6, 6)])
def test_ht_partial_quad_shapes(shape, rng):
    data = rng.integers(-9, 9, size=shape).astype(np.int32)
    np.testing.assert_array_equal(_roundtrip(data), data)


def test_ht_negative_only_block(rng):
    data = -rng.integers(1, 100, size=(8, 8)).astype(np.int32)
    np.testing.assert_array_equal(_roundtrip(data), data)


def test_ht_large_magnitudes():
    """Values near the kmax=30 ceiling survive the magnitude-exponent path."""
    data = np.array([[(1 << 27) - 1, -(1 << 27)],
                     [1, -1]], dtype=np.int32)
    h, w = data.shape
    blob = HTCleanupEncoder(w, h, 30).encode(data)
    got = HTCleanupDecoder(w, h, 30, 29).decode(blob)
    np.testing.assert_array_equal(got, data)


def test_ht_checkerboard_significance(rng):
    """Alternating significance exercises every quad context transition."""
    data = np.indices((16, 16)).sum(axis=0) % 2 * 100
    data = data.astype(np.int32)
    data[::2, ::2] = -50
    np.testing.assert_array_equal(_roundtrip(data), data)


def test_ht_decoder_rejects_short_block():
    with pytest.raises(CorruptStreamError):
        HTCleanupDecoder(4, 4, 5, 4).decode(b"\x01")


def test_ht_decoder_rejects_bad_scup():
    # Scup = 0 (< 2) encoded in the trailing locator bytes
    with pytest.raises(CorruptStreamError):
        HTCleanupDecoder(4, 4, 5, 4).decode(b"\x00\x00\x00\x00")


def test_ht_decoder_rejects_bad_kmax():
    with pytest.raises(CorruptStreamError):
        HTCleanupDecoder(4, 4, 0, 0).decode(b"\x00\x00\x0f\x00")
    with pytest.raises(CorruptStreamError):
        HTCleanupDecoder(4, 4, 5, 31).decode(b"\x00\x00\x0f\x00")


def test_ht_encoder_rejects_bad_kmax():
    data = np.ones((4, 4), dtype=np.int32)
    with pytest.raises(CorruptStreamError):
        HTCleanupEncoder(4, 4, 0).encode(data)
    with pytest.raises(CorruptStreamError):
        HTCleanupEncoder(4, 4, 31).encode(data)


def test_ht_empty_codeblock_decodes_to_zero():
    got = HTCleanupDecoder(6, 6, 5, 4).decode(b"")
    np.testing.assert_array_equal(got, np.zeros((6, 6), dtype=np.int32))


def test_ht_scup_locator_layout(rng):
    """Last two bytes hold Scup: ((last<<4)|(prev&0xF)) == len(cleanup)."""
    data = rng.integers(-40, 40, size=(8, 8)).astype(np.int32)
    blob = HTCleanupEncoder(8, 8, 9).encode(data)
    scup = (blob[-1] << 4) | (blob[-2] & 0x0F)
    assert 2 <= scup <= len(blob)
