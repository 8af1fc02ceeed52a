"""T2 packet-header edge behavior, mirrored from the reference's T2 test
depth (VERDICT r3 #7): jpeg2000/t2/{packet_header_test.go,
parser_test.go, openjpeg_length_segments_test.go,
packet_header_compare_test.go} — bit IO with B.10.1 stuffing, the
B.10.6 comma code, Lblock growth, segment-length signaling under the
pass-termination styles, and multi-band/multi-layer packet roundtrips
on paths the corruption fuzzer doesn't deterministically reach.
"""

import numpy as np
import pytest

from go_dicom_codec_jax.entropy.ebcot import STYLE_LAZY, STYLE_TERMALL
from go_dicom_codec_jax.errors import CorruptStreamError
from go_dicom_codec_jax.t2.bitio import BioReader, BioWriter
from go_dicom_codec_jax.t2.packets import (BlockState, PrecinctState,
                                           _decode_num_passes,
                                           _encode_num_passes,
                                           _floor_log2, _segments,
                                           _terminates_at, decode_packet,
                                           encode_packet)


# ---- BioWriter / BioReader (reference packet_header_test.go /
#      parser_test.go surface) -------------------------------------------------

def test_bio_single_bits_roundtrip():
    bw = BioWriter()
    bits = [1, 0, 1, 1, 0, 0, 1, 0, 1, 1]
    for b in bits:
        bw.write_bit(b)
    br = BioReader(bw.flush())
    assert [br.read_bit() for _ in range(len(bits))] == bits


def test_bio_write_bits_read_bits():
    bw = BioWriter()
    bw.write_bits(0b1011011, 7)
    bw.write_bits(0x1F3, 9)
    br = BioReader(bw.flush())
    assert br.read_bits(7) == 0b1011011
    assert br.read_bits(9) == 0x1F3


def test_bio_ff_stuffing_on_write():
    """A 0xFF data byte is followed by a 7-bit byte (B.10.1)."""
    bw = BioWriter()
    bw.write_bits(0xFF, 8)
    bw.write_bits(0x7F, 7)   # exactly fills the stuffed byte
    out = bw.flush()
    assert out[0] == 0xFF
    assert out[1] == 0x7F    # 7 bits in the high-but-one positions


def test_bio_ff_stuffing_roundtrip():
    bw = BioWriter()
    bw.write_bits(0xFF, 8)
    bw.write_bits(0b1010101, 7)
    bw.write_bits(0xAB, 8)
    br = BioReader(bw.flush())
    assert br.read_bits(8) == 0xFF
    assert br.read_bits(7) == 0b1010101
    assert br.read_bits(8) == 0xAB


def test_bio_flush_trailing_ff_emits_stuffed_byte():
    bw = BioWriter()
    bw.write_bits(0xFF, 8)
    out = bw.flush()
    assert len(out) == 2 and out[0] == 0xFF


def test_bio_align_to_byte_consumes_stuffed_byte():
    bw = BioWriter()
    bw.write_bits(0xFF, 8)
    data = bw.flush() + b"\xCD"
    br = BioReader(data)
    assert br.read_bits(8) == 0xFF
    br.align_to_byte()
    assert data[br.bytes_read()] == 0xCD


def test_bio_reader_eof_raises():
    br = BioReader(b"\xAA")
    br.read_bits(8)
    with pytest.raises(CorruptStreamError):
        br.read_bit()


def test_bio_bytes_read_position():
    bw = BioWriter()
    bw.write_bits(0x123, 12)
    data = bw.flush()
    br = BioReader(data)
    br.read_bits(12)
    br.align_to_byte()
    assert br.bytes_read() == len(data)


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_bio_random_pattern_roundtrip(seed):
    """Reference TestPacketParserComplexBitPattern / StressTest."""
    rng = np.random.default_rng(seed)
    runs = [(int(v), int(n)) for v, n in
            zip(rng.integers(0, 1 << 16, 200), rng.integers(1, 17, 200))]
    bw = BioWriter()
    for v, n in runs:
        bw.write_bits(v & ((1 << n) - 1), n)
    br = BioReader(bw.flush())
    for v, n in runs:
        assert br.read_bits(n) == (v & ((1 << n) - 1))


# ---- comma code (B.10.6) -----------------------------------------------------

@pytest.mark.parametrize("n,bits", [(1, 1), (2, 2), (3, 4), (5, 4),
                                    (6, 9), (36, 9), (37, 16), (164, 16)])
def test_num_passes_code_lengths(n, bits):
    class CountingWriter(BioWriter):
        nbits = 0

        def write_bit(self, bit):
            self.nbits += 1
            super().write_bit(bit)

        def write_bits(self, value, n):
            self.nbits += n
            super().write_bits(value, n)

    bw = CountingWriter()
    _encode_num_passes(bw, n)
    assert bw.nbits == bits


def test_num_passes_roundtrip_full_range():
    for n in range(1, 165):
        bw = BioWriter()
        _encode_num_passes(bw, n)
        assert _decode_num_passes(BioReader(bw.flush())) == n


def test_num_passes_over_164_raises():
    with pytest.raises(ValueError):
        _encode_num_passes(BioWriter(), 165)


def test_floor_log2_values():
    assert [_floor_log2(n) for n in (0, 1, 2, 3, 4, 7, 8, 1023, 1024)] \
        == [0, 0, 1, 1, 2, 2, 3, 9, 10]


# ---- segment derivation under termination styles ----------------------------
# (reference openjpeg_length_segments_test.go: one length field per
# terminated segment plus one for the trailing open segment)

def test_segments_style0_single_segment():
    assert tuple(_segments(0, 5, 0, 7)) == (7,)


def test_segments_termall_every_pass():
    assert tuple(_segments(STYLE_TERMALL, 5, 0, 7)) == (1,) * 7


def test_segments_termall_mid_start():
    assert tuple(_segments(STYLE_TERMALL, 5, 3, 4)) == (1,) * 4


def test_segments_lazy_pattern():
    """LAZY: cleanup terminated right before the first raw pass, then
    each raw SPP/MRP pair and each MQ cleanup terminate."""
    numbps = 8
    segs = _segments(STYLE_LAZY, numbps, 0, 3 * numbps - 2)
    assert sum(segs) == 3 * numbps - 2
    assert len(segs) > 1          # lazy introduces real segment breaks


@pytest.mark.parametrize("style", [0, STYLE_TERMALL, STYLE_LAZY,
                                   STYLE_LAZY | STYLE_TERMALL])
@pytest.mark.parametrize("numbps", [1, 4, 9])
def test_segments_counts_always_sum(style, numbps, rng):
    total = 3 * numbps - 2
    for start in range(total):
        for n in range(1, total - start + 1):
            segs = _segments(style, numbps, start, n)
            assert sum(segs) == n
            assert all(c > 0 for c in segs)


def test_terminates_at_consistency():
    """_terminates_at must agree with _segments' split points."""
    style, numbps = STYLE_LAZY, 6
    total = 3 * numbps - 2
    segs = _segments(style, numbps, 0, total)
    idx = -1
    for cnt in segs[:-1]:
        idx += cnt
        assert _terminates_at(style, numbps, idx)


# ---- packet roundtrips -------------------------------------------------------

def _mk_band(ncbw, ncbh, mb=10):
    blocks = [BlockState(cbx=x, cby=y)
              for y in range(ncbh) for x in range(ncbw)]
    return PrecinctState(ncbw=ncbw, ncbh=ncbh, blocks=blocks, mb=mb)


def _fill_block(blk, rng, numbps=4, npasses=None, style=0, mb=10):
    npasses = npasses if npasses is not None else 3 * numbps - 2
    blk.numbps = numbps
    blk.zero_bitplanes = mb - numbps
    sizes = rng.integers(1, 40, npasses)
    blk.pass_rates = [int(v) for v in np.cumsum(sizes)]
    blk.data = bytes(rng.integers(0, 256, blk.pass_rates[-1],
                                  dtype=np.uint8))
    blk.pass_terms = [_terminates_at(style, numbps, i)
                      for i in range(npasses)]


def _decode_band_like(enc_band):
    d = _mk_band(enc_band.ncbw, enc_band.ncbh, enc_band.mb)
    return d


def test_packet_empty_no_blocks():
    header, body = encode_packet([PrecinctState(ncbw=0, ncbh=0,
                                                blocks=[])], 0, 0)
    assert header == b"\x00" and body == b""


def test_packet_empty_no_contributions(rng):
    band = _mk_band(1, 1)
    _fill_block(band.blocks[0], rng)
    band.blocks[0].layer_passes = [0]     # nothing ships in layer 0
    header, body = encode_packet([band], 0, 0)
    assert header == b"\x00" and body == b""
    # decoder consumes exactly one byte and includes nothing
    dec = _decode_band_like(band)
    pos = decode_packet(header + body, 0, [dec], 0, 0)
    assert pos == 1
    assert not dec.blocks[0].included


def test_packet_single_block_roundtrip(rng):
    band = _mk_band(1, 1)
    _fill_block(band.blocks[0], rng, numbps=4)
    header, body = encode_packet([band], 0, 0)
    dec = _decode_band_like(band)
    pos = decode_packet(header + body, 0, [dec], 0, 0)
    b = dec.blocks[0]
    assert pos == len(header) + len(body)
    assert b.included and b.numbps == 4
    assert b.num_passes == len(band.blocks[0].pass_rates)
    assert bytes(b.seg_data) == band.blocks[0].data


def test_packet_lblock_growth_long_segment(rng):
    """A long single segment forces Lblock signaling beyond the initial
    3 (reference packet_header.go Lblock growth)."""
    band = _mk_band(1, 1)
    blk = band.blocks[0]
    blk.numbps = 2
    blk.zero_bitplanes = band.mb - 2
    blk.pass_rates = [100000]             # 17-bit length, 1 pass
    blk.data = bytes(100000)
    header, body = encode_packet([band], 0, 0)
    assert band.blocks[0].lblock > 3
    dec = _decode_band_like(band)
    decode_packet(header + body, 0, [dec], 0, 0)
    assert dec.blocks[0].lblock == band.blocks[0].lblock
    assert len(dec.blocks[0].seg_data) == 100000


def test_packet_termall_length_per_segment(rng):
    """TERMALL: one length field per pass (openjpeg_length_segments)."""
    band = _mk_band(1, 1)
    _fill_block(band.blocks[0], rng, numbps=3, style=STYLE_TERMALL)
    h_termall, _ = encode_packet([band], 0, STYLE_TERMALL)
    band2 = _mk_band(1, 1)
    _fill_block(band2.blocks[0], rng, numbps=3, style=0)
    h_single, _ = encode_packet([band2], 0, 0)
    # 7 separate length fields cost more header bits than one
    assert len(h_termall) > len(h_single)


def test_packet_multi_band_roundtrip(rng):
    bands = [_mk_band(2, 1), _mk_band(1, 1), _mk_band(1, 2)]
    for ps in bands:
        for blk in ps.blocks:
            _fill_block(blk, rng, numbps=int(rng.integers(1, 6)))
    header, body = encode_packet(bands, 0, 0)
    decs = [_decode_band_like(ps) for ps in bands]
    pos = decode_packet(header + body, 0, decs, 0, 0)
    assert pos == len(header) + len(body)
    for ps, dec in zip(bands, decs):
        for eb, db in zip(ps.blocks, dec.blocks):
            assert db.numbps == eb.numbps
            assert bytes(db.seg_data) == eb.data


def test_packet_multi_layer_inclusion(rng):
    """First inclusion via tag tree in layer 1; raw bit afterwards."""
    band = _mk_band(1, 1)
    blk = band.blocks[0]
    _fill_block(blk, rng, numbps=4)
    npasses = len(blk.pass_rates)
    blk.layer_passes = [0, 3, npasses]    # joins in layer 1
    packets = []
    for layer in range(3):
        packets.append(encode_packet([band], layer, 0, num_layers=3))
    dec = _decode_band_like(band)
    stream = b"".join(h + b for h, b in packets)
    pos = 0
    for layer in range(3):
        pos = decode_packet(stream, pos, [dec], layer, 0)
    assert dec.blocks[0].included
    assert dec.blocks[0].num_passes == npasses
    assert bytes(dec.blocks[0].seg_data) == blk.data
    assert packets[0][0] == b"\x00"       # empty layer-0 packet


def test_packet_layer_skip_then_rejoin(rng):
    """Included block contributing nothing in a middle layer writes a
    0 bit (not a tag-tree code) and resumes cleanly."""
    band = _mk_band(1, 1)
    blk = band.blocks[0]
    _fill_block(blk, rng, numbps=4)
    npasses = len(blk.pass_rates)
    blk.layer_passes = [2, 2, npasses]    # layer 1 contributes nothing
    packets = [encode_packet([band], layer, 0, num_layers=3)
               for layer in range(3)]
    dec = _decode_band_like(band)
    stream = b"".join(h + b for h, b in packets)
    pos = 0
    for layer in range(3):
        pos = decode_packet(stream, pos, [dec], layer, 0)
    assert dec.blocks[0].num_passes == npasses
    assert bytes(dec.blocks[0].seg_data) == blk.data


def test_packet_2x2_grid_tagtree_order(rng):
    band = _mk_band(2, 2)
    for i, blk in enumerate(band.blocks):
        _fill_block(blk, rng, numbps=i + 1)
    header, body = encode_packet([band], 0, 0)
    dec = _decode_band_like(band)
    decode_packet(header + body, 0, [dec], 0, 0)
    for eb, db in zip(band.blocks, dec.blocks):
        assert db.numbps == eb.numbps
        assert bytes(db.seg_data) == eb.data


def test_packet_truncated_header_raises(rng):
    band = _mk_band(2, 2)
    for blk in band.blocks:
        _fill_block(blk, rng, numbps=5)
    header, body = encode_packet([band], 0, 0)
    dec = _decode_band_like(band)
    with pytest.raises(CorruptStreamError):
        decode_packet(header[:2], 0, [dec], 0, 0)


def test_packet_truncated_body_raises(rng):
    band = _mk_band(1, 1)
    _fill_block(band.blocks[0], rng, numbps=5)
    header, body = encode_packet([band], 0, 0)
    dec = _decode_band_like(band)
    with pytest.raises(CorruptStreamError):
        decode_packet(header + body[: len(body) // 2], 0, [dec], 0, 0)


def test_packet_negative_numbps_rejected(rng):
    """zbp > Mb in the header must raise, not wrap (decoder front)."""
    band = _mk_band(1, 1, mb=3)
    blk = band.blocks[0]
    blk.numbps = 1
    blk.zero_bitplanes = 9               # > Mb: hostile header
    blk.pass_rates = [4]
    blk.data = b"abcd"
    header, body = encode_packet([band], 0, 0)
    dec = _decode_band_like(band)
    dec.mb = 3
    with pytest.raises(CorruptStreamError):
        decode_packet(header + body, 0, [dec], 0, 0)


def test_packet_sop_eph_markers(rng):
    band = _mk_band(1, 1)
    _fill_block(band.blocks[0], rng, numbps=3)
    header, body = encode_packet([band], 0, 0)
    sop = b"\xff\x91\x00\x04\x00\x00"
    eph = b"\xff\x92"
    # decoder must skip SOP before the header; EPH handling rides after
    stream = sop + header + body
    dec = _decode_band_like(band)
    pos = decode_packet(stream, 0, [dec], 0, 0, use_sop=True)
    assert bytes(dec.blocks[0].seg_data) == band.blocks[0].data
    assert pos == len(stream)
    del eph


@pytest.mark.parametrize("style", [0, STYLE_TERMALL, STYLE_LAZY])
@pytest.mark.parametrize("seed", [10, 11])
def test_packet_layered_property_roundtrip(style, seed, rng):
    """Stress: random grids, random layer splits, every style — decoded
    state must exactly mirror the encoder's (reference
    TestPacketParserStressTest analogue)."""
    r = np.random.default_rng(seed)
    bands = [_mk_band(int(r.integers(1, 4)), int(r.integers(1, 4)))]
    nl = int(r.integers(1, 4))
    for blk in bands[0].blocks:
        numbps = int(r.integers(1, 7))
        _fill_block(blk, r, numbps=numbps, style=style)
        npasses = len(blk.pass_rates)
        splits = sorted(r.integers(0, npasses + 1, nl - 1).tolist())
        blk.layer_passes = splits + [npasses]
    packets = [encode_packet(bands, layer, style, num_layers=nl)
               for layer in range(nl)]
    stream = b"".join(h + b for h, b in packets)
    decs = [_decode_band_like(bands[0])]
    pos = 0
    for layer in range(nl):
        pos = decode_packet(stream, pos, decs, layer, style)
    assert pos == len(stream)
    for eb, db in zip(bands[0].blocks, decs[0].blocks):
        assert db.num_passes == eb.num_passes
        assert bytes(db.seg_data) == eb.data[:len(db.seg_data)]
        if eb.num_passes:
            assert db.numbps == eb.numbps


# ---- progression iteration properties ---------------------------------------

def _pinfo(comp, res):
    return [(0, 0, 0)]          # one precinct everywhere


def _order(progression, nl=2, nr=3, nc=2):
    from go_dicom_codec_jax.t2.packets import progression_order
    return list(progression_order(progression, nl, nr, nc, _pinfo))


@pytest.mark.parametrize("progression", [0, 1, 2, 3, 4])
def test_progression_orders_cover_each_packet_once(progression):
    seq = _order(progression)
    assert len(seq) == len(set(seq)) == 2 * 3 * 2


def test_progression_lrcp_layer_major():
    seq = _order(0)
    layers = [t[0] for t in seq]
    assert layers == sorted(layers)


def test_progression_rlcp_resolution_major():
    seq = _order(1)
    res = [t[1] for t in seq]
    assert res == sorted(res)


def test_progression_cprl_component_major():
    seq = _order(4)
    comps = [t[2] for t in seq]
    assert comps == sorted(comps)


def test_progression_orders_same_packet_set():
    sets = {frozenset(_order(p)) for p in range(5)}
    assert len(sets) == 1


def test_progression_degenerate_single_everything():
    for p in range(5):
        assert _order(p, nl=1, nr=1, nc=1) == [(0, 0, 0, 0)]
