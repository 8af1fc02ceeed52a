"""PLT-assisted reduced-resolution decode.

The encoder's plt_markers option (T.800 A.8.2) records every packet's
bitstream length in the tile-part header. The decoder now READS those
(TileInfo.plt) and, under reduce=R, jumps over dropped-resolution
packets by recorded length instead of bit-parsing their headers —
random-access use of PLT the reference never implements (it only
defines the marker, codestream/markers.go:65-66).

The load-bearing property: a skipped packet's BYTES ARE NEVER READ.
Pinned below by corrupting dropped-resolution packets and requiring a
bit-exact reduced decode anyway.
"""

import struct

import numpy as np
import pytest

from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder,
                                                J2KEncodeParams, J2KEncoder)
from go_dicom_codec_jax.codestream import j2k
from go_dicom_codec_jax.errors import CorruptStreamError


def _img(h=160, w=150, seed=3, bits=12):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << bits, size=(h, w)).astype(np.int32)


def _enc(img, **kw):
    p = J2KEncodeParams(**kw)
    return J2KEncoder(p).encode(img, img.shape[1], img.shape[0], 1, 12)


def test_parse_codestream_captures_plt():
    img = _img()
    s = _enc(img, plt_markers=True)
    cs = j2k.parse_codestream(s)
    tile = cs.tiles[0]
    assert tile.plt is not None
    # every packet byte is accounted for: lengths tile the body exactly
    assert sum(tile.plt) == len(tile.data)
    # non-PLT stream → no lengths
    assert j2k.parse_codestream(_enc(img)).tiles[0].plt is None


def test_plt_split_segments_reparse_across_the_join():
    """Lengths split between PLT segments (Zplt 0,1,…) merge back."""
    img = _img()
    s = _enc(img, plt_markers=True, num_levels=4)
    cs = j2k.parse_codestream(s)
    want = cs.tiles[0].plt
    # re-write the tile-part header with the PLT varints split into
    # tiny segments (max_chunk=3 → many Zplt parts)
    body = cs.tiles[0].data
    plt_bytes = j2k.write_plt_segments(want, max_chunk=3)
    sot_at = s.find(b"\xff\x90")
    lsot = struct.unpack_from(">H", s, sot_at + 2)[0]
    seg_end = sot_at + 2 + lsot
    psot = struct.unpack_from(">I", s, sot_at + 6)[0]
    # drop the original single-PLT header segs up to SOD, keep SOD+body
    sod_at = s.find(b"\xff\x93", seg_end)
    rebuilt = (s[:seg_end] + plt_bytes + s[sod_at:])
    new_psot = psot - (sod_at - seg_end) + len(plt_bytes)
    rebuilt = (rebuilt[:sot_at + 6] + struct.pack(">I", new_psot)
               + rebuilt[sot_at + 10:])
    cs2 = j2k.parse_codestream(rebuilt)
    assert cs2.tiles[0].plt == want
    assert cs2.tiles[0].data == body


@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("kw", [
    dict(),                                         # LRCP (interleaved)
    dict(progression=j2k.PROG_RPCL),                # resolution-major
    dict(num_layers=3, layer_rates=[8.0, 4.0], append_lossless_layer=True),
    dict(use_sop=True, use_eph=True),
    dict(tile_width=64, tile_height=64),
    dict(htj2k=True),
], ids=["lrcp", "rpcl", "layered", "sop-eph", "multi-tile", "ht"])
def test_plt_reduce_matches_plain_stream(r, kw):
    """PLT skip tracks positions exactly: the reduced decode of a PLT
    stream equals the reduced decode of the PLT-free stream (kept
    packets desync and this fails if any skip length were misapplied)."""
    img = _img()
    a = J2KDecoder(reduce=r).decode(_enc(img, plt_markers=True, **kw))[0]
    b = J2KDecoder(reduce=r).decode(_enc(img, **kw))[0]
    assert np.array_equal(a, b)


def _tile_body_span(s: bytes):
    """(start, end) byte span of the single tile-part's post-SOD body."""
    sot_at = s.find(b"\xff\x90")
    psot = struct.unpack_from(">I", s, sot_at + 6)[0]
    sod_at = s.find(b"\xff\x93", sot_at)
    return sod_at + 2, sot_at + psot


def test_skipped_packets_are_never_read():
    """Corrupt every dropped-resolution packet; reduced decode stays
    bit-exact because PLT skip never parses those bytes."""
    img = _img()
    s = _enc(img, plt_markers=True, progression=j2k.PROG_RPCL)
    want = J2KDecoder(reduce=1).decode(s)[0]
    cs = j2k.parse_codestream(s)
    plt = cs.tiles[0].plt
    # RPCL, levels=5, single precinct, 1 layer, 1 comp → packet i is
    # resolution i; the last packet is the top (dropped at reduce=1)
    # resolution and carries most of the stream
    b0, b1 = _tile_body_span(s)
    assert b1 - b0 == sum(plt)
    last_off = b0 + sum(plt[:-1])
    corrupted = bytearray(s)
    for i in range(last_off + 1, b1):  # keep byte 0: not SOP-marker-like
        corrupted[i] = 0x55
    got = J2KDecoder(reduce=1).decode(bytes(corrupted))[0]
    assert np.array_equal(got, want)
    # sanity: the corruption is real — a FULL strict decode must not
    # return the original pixels (it raises or decodes garbage)
    try:
        full = J2KDecoder().decode(bytes(corrupted))[0]
        orig = J2KDecoder().decode(s)[0]
        assert not np.array_equal(full, orig)
    except CorruptStreamError:
        pass


def test_short_plt_is_ignored():
    """A PLT that doesn't cover the packet count falls back to header
    parsing (and still decodes exactly)."""
    img = _img()
    s = _enc(img)
    want = J2KDecoder(reduce=1).decode(s)[0]
    # splice a bogus 2-entry PLT into the tile-part header
    sot_at = s.find(b"\xff\x90")
    lsot = struct.unpack_from(">H", s, sot_at + 2)[0]
    seg_end = sot_at + 2 + lsot
    psot = struct.unpack_from(">I", s, sot_at + 6)[0]
    fake = j2k.write_plt_segments([5, 7])
    rebuilt = s[:seg_end] + fake + s[seg_end:]
    rebuilt = (rebuilt[:sot_at + 6]
               + struct.pack(">I", psot + len(fake))
               + rebuilt[sot_at + 10:])
    cs = j2k.parse_codestream(rebuilt)
    assert cs.tiles[0].plt == [5, 7]
    got = J2KDecoder(reduce=1).decode(rebuilt)[0]
    assert np.array_equal(got, want)


def test_inconsistent_plt_falls_back_to_bit_parsing():
    """Lengths individually <= len(body) but not tiling it exactly
    desync the KEPT packets if trusted — the decoder must reject the
    whole PLT (sum-check) and bit-parse instead, matching PLT-ignoring
    decoders like OpenJPEG (advisor finding, round 4)."""
    img = _img()
    s = _enc(img)  # levels=5 single precinct → 6 packets
    want = J2KDecoder(reduce=1).decode(s)[0]
    b0, b1 = _tile_body_span(s)
    body_len = b1 - b0
    # 6 entries, each valid alone, sum != body_len (off by one packet)
    lens = [3, 3, 3, 3, 3, min(body_len, 40)]
    assert sum(lens) != body_len and all(ln <= body_len for ln in lens)
    sot_at = s.find(b"\xff\x90")
    lsot = struct.unpack_from(">H", s, sot_at + 2)[0]
    seg_end = sot_at + 2 + lsot
    psot = struct.unpack_from(">I", s, sot_at + 6)[0]
    fake = j2k.write_plt_segments(lens)
    rebuilt = s[:seg_end] + fake + s[seg_end:]
    rebuilt = (rebuilt[:sot_at + 6]
               + struct.pack(">I", psot + len(fake))
               + rebuilt[sot_at + 10:])
    assert j2k.parse_codestream(rebuilt).tiles[0].plt == lens
    got = J2KDecoder(reduce=1).decode(rebuilt)[0]
    assert np.array_equal(got, want)


def test_plt_full_decode_unchanged():
    """reduce=0 keeps the native whole-tile parse; PLT presence must
    not change full-resolution output."""
    img = _img()
    a = J2KDecoder().decode(_enc(img, plt_markers=True))[0]
    b = J2KDecoder().decode(_enc(img))[0]
    assert np.array_equal(a, b)


@pytest.mark.parametrize("kw", [
    dict(precinct_width=64, precinct_height=64),
    dict(precinct_width=64, precinct_height=64,
         progression=j2k.PROG_RPCL, num_layers=2, layer_rates=[8.0],
         append_lossless_layer=True),
], ids=["precincts", "rpcl-layered"])
def test_plt_window_matches_plain_stream(kw):
    """Out-of-window precinct packets skip via PLT; the windowed decode
    still equals the plain stream's windowed decode exactly."""
    img = _img(h=256, w=256)
    win = (16, 24, 80, 96)
    a = J2KDecoder(window=win).decode(_enc(img, plt_markers=True, **kw))[0]
    b = J2KDecoder(window=win).decode(_enc(img, **kw))[0]
    assert np.array_equal(a, b)


def test_window_skips_far_precinct_packets():
    """Corrupt the far-corner precinct's packet: a top-left window
    decode never reads it (PLT skip) and stays bit-exact."""
    img = _img(h=256, w=256)
    s = _enc(img, plt_markers=True, progression=j2k.PROG_RPCL,
             precinct_width=64, precinct_height=64)
    win = (0, 0, 48, 48)
    want = J2KDecoder(window=win).decode(s)[0]
    cs = j2k.parse_codestream(s)
    plt = cs.tiles[0].plt
    b0, b1 = _tile_body_span(s)
    # RPCL raster precinct order: the LAST packet is the bottom-right
    # precinct of the top resolution — far outside the window
    last_off = b0 + sum(plt[:-1])
    corrupted = bytearray(s)
    for i in range(last_off + 1, b1):
        corrupted[i] = 0x55
    got = J2KDecoder(window=win).decode(bytes(corrupted))[0]
    assert np.array_equal(got, want)


def test_plt_window_composes_with_reduce():
    img = _img(h=256, w=256)
    kw = dict(precinct_width=64, precinct_height=64)
    win = (16, 24, 80, 96)
    a = J2KDecoder(window=win, reduce=1).decode(
        _enc(img, plt_markers=True, **kw))[0]
    b = J2KDecoder(window=win, reduce=1).decode(_enc(img, **kw))[0]
    assert np.array_equal(a, b)


def test_hostile_plt_length_is_ignored():
    """A PLT entry larger than the tile body (even > 2^63, which would
    overflow the native int64 marshalling) is rejected as bogus — the
    walk falls back to header parsing and decodes exactly."""
    img = _img()
    s = _enc(img)  # levels=5 single precinct → 6 packets
    want = J2KDecoder(reduce=1).decode(s)[0]
    sot_at = s.find(b"\xff\x90")
    lsot = struct.unpack_from(">H", s, sot_at + 2)[0]
    seg_end = sot_at + 2 + lsot
    psot = struct.unpack_from(">I", s, sot_at + 6)[0]
    fake = j2k.write_plt_segments([3, 3, 3, 3, 3, 1 << 70])
    rebuilt = s[:seg_end] + fake + s[seg_end:]
    rebuilt = (rebuilt[:sot_at + 6]
               + struct.pack(">I", psot + len(fake))
               + rebuilt[sot_at + 10:])
    assert j2k.parse_codestream(rebuilt).tiles[0].plt[-1] == 1 << 70
    got = J2KDecoder(reduce=1).decode(rebuilt)[0]
    assert np.array_equal(got, want)
