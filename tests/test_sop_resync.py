"""SOP-marker resynchronization in resilient decode.

The reference decodes the use_sop/use_eph flags but never uses SOP for
recovery (t2/packet_header.go); here a resilient decode that hits a
corrupt packet scans forward for the next SOP marker (T.800 A.8.1,
Nsop = packet count per tile mod 65536) and resumes at the packet it
names — only the damaged packet's blocks are lost instead of every
packet after it.

The strong pin: corrupt the r=1 packet of a levels=2 single-precinct
stream and require the r=0 and r=2 band COEFFICIENTS bit-exact, with
damage confined to the level-2 detail ring.
"""

import struct

import numpy as np

from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder,
                                                J2KEncodeParams, J2KEncoder,
                                                _sop_resync)
from go_dicom_codec_jax.codestream import j2k


def _img(h=128, w=120, seed=7, bits=12):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << bits, size=(h, w)).astype(np.int32)


def _enc(img, **kw):
    p = J2KEncodeParams(use_sop=True, plt_markers=True, **kw)
    return J2KEncoder(p).encode(img, img.shape[1], img.shape[0], 1, 12)


def _packet_spans(s: bytes):
    """[(start, end)] absolute byte spans of each packet (via PLT)."""
    cs = j2k.parse_codestream(s)
    plt = cs.tiles[0].plt
    sot_at = s.find(b"\xff\x90")
    sod_at = s.find(b"\xff\x93", sot_at)
    b0 = sod_at + 2
    spans, off = [], b0
    for ln in plt:
        spans.append((off, off + ln))
        off += ln
    return spans


def test_sop_resync_scan():
    body = (b"\x00" * 10 + b"\xff\x91\x00\x04\x00\x05" + b"\x00" * 4
            + b"\xff\x91\x00\x04\x00\x09")
    assert _sop_resync(body, 0, 2, 20) == (10, 5)
    # markers naming already-done packets are skipped
    assert _sop_resync(body, 0, 7, 20) == (20, 9)
    # none usable → None
    assert _sop_resync(body, 0, 12, 20) is None
    # mod-65536 wrap: Nsop 5 after index 70000 → 70000+1+((5-70001)%65536)
    j = 70001 + ((5 - 70001) % 65536)
    assert _sop_resync(body, 0, 70000, j + 1) == (10, j)


def test_resilient_decode_recovers_later_packets():
    """Coefficient-level pin: with packet r=1 destroyed, r=0 and r=2
    bands parse bit-exact through the resync."""
    img = _img()
    s = _enc(img, num_levels=2)  # LRCP, 1 layer → packets r0, r1, r2
    spans = _packet_spans(s)
    assert len(spans) == 3
    # clean packed coefficients (pre-inverse)
    from go_dicom_codec_jax.codecs.jpeg2000 import decode_to_packed_tiles
    clean = decode_to_packed_tiles(s)[0][0][1]

    p0, p1 = spans[1]
    corrupted = bytearray(s)
    for i in range(p0 + 6, p1):  # keep the SOP header itself
        corrupted[i] = 0xFF
    corrupted = bytes(corrupted)

    # strict decode must fail or mismatch; resilient + resync recovers
    dec = J2KDecoder(resilient=True)
    arr, siz, cod = dec.decode(corrupted)
    assert arr.shape == (128, 120, 1)

    # coefficient-level check through the internal hook
    from go_dicom_codec_jax.codestream.j2k import parse_codestream
    cs = parse_codestream(corrupted)
    tile = cs.tiles[0]
    ncomp = 1
    cods = [cs.cod_for(0, tile)]
    qcds = [cs.qcd_for(0, tile)]
    rect = cs.siz.tile_rect(0, 0)
    packed = dec._decode_tile(
        tile.data, rect, cods, qcds, ncomp, 12, False,
        cs.rgn_shifts, None, plt_lengths=tile.plt,
        _return_packed=True)
    h, w = clean.shape[:2]
    h1, w1 = -(-h // 2), -(-w // 2)   # level-1 LL dims
    h2, w2 = -(-h1 // 2), -(-w1 // 2)  # level-2 LL dims
    got = packed[:, :, 0] if packed.ndim == 3 else packed
    ref = clean[:, :, 0] if clean.ndim == 3 else clean
    # r=0 packet (LL2): exact — parsed before the damage
    assert np.array_equal(got[:h2, :w2], ref[:h2, :w2])
    # r=2 packet (level-1 detail ring): exact — recovered via resync
    assert np.array_equal(got[:h1, w1:], ref[:h1, w1:])
    assert np.array_equal(got[h1:, :], ref[h1:, :])
    # r=1 ring (level-2 details inside the LL1 quadrant) is the damaged
    # region; the corrupt packet must not have survived bit-exact
    assert not np.array_equal(got[:h1, :w1], ref[:h1, :w1])


def test_resync_beats_break_on_pixels():
    """Public-API view: with resync, the resilient decode of a stream
    whose FIRST detail packet is damaged stays closer to the original
    than losing every post-damage packet would (the no-SOP stream
    cannot resync and drops everything after the hit)."""
    img = _img(h=160, w=160)
    s_sop = _enc(img, num_levels=3)
    s_plain = J2KEncoder(J2KEncodeParams(num_levels=3, plt_markers=True)
                         ).encode(img, 160, 160, 1, 12)
    full = J2KDecoder().decode(s_sop)[0].astype(np.int64)

    spans = _packet_spans(s_sop)
    p0, p1 = spans[1]
    bad = bytearray(s_sop)
    for i in range(p0 + 6, p1):
        bad[i] = 0xFF
    got = J2KDecoder(resilient=True).decode(bytes(bad))[0].astype(np.int64)
    err_resync = float(np.abs(got - full).mean())

    # same damage position in the no-SOP stream (no resync possible)
    cs = j2k.parse_codestream(s_plain)
    plt = cs.tiles[0].plt
    sod_at = s_plain.find(b"\xff\x93", s_plain.find(b"\xff\x90"))
    q0 = sod_at + 2 + plt[0]
    bad2 = bytearray(s_plain)
    for i in range(q0 + 2, q0 + plt[1]):
        bad2[i] = 0xFF
    got2 = J2KDecoder(resilient=True).decode(bytes(bad2))[0].astype(np.int64)
    err_break = float(np.abs(got2 - full).mean())
    assert err_resync < err_break


def test_resync_handles_multiple_hits():
    """Two damaged packets, two resyncs — later packets still land."""
    img = _img()
    s = _enc(img, num_levels=3, progression=j2k.PROG_RPCL)
    spans = _packet_spans(s)
    assert len(spans) == 4
    bad = bytearray(s)
    for (p0, p1) in (spans[1], spans[2]):
        for i in range(p0 + 6, p1):
            bad[i] = 0xFF
    arr = J2KDecoder(resilient=True).decode(bytes(bad))[0]
    assert arr.shape == (128, 120, 1)
    # the final (r=3) packet must have been recovered: its detail ring
    # is non-trivial in the packed domain for noise content
    from go_dicom_codec_jax.codestream.j2k import parse_codestream
    cs = parse_codestream(bytes(bad))
    tile = cs.tiles[0]
    dec = J2KDecoder(resilient=True)
    packed = dec._decode_tile(
        tile.data, cs.siz.tile_rect(0, 0), [cs.cod_for(0, tile)],
        [cs.qcd_for(0, tile)], 1, 12, False, cs.rgn_shifts, None,
        plt_lengths=tile.plt, _return_packed=True)
    from go_dicom_codec_jax.codecs.jpeg2000 import decode_to_packed_tiles
    ref = decode_to_packed_tiles(s)[0][0][1]
    got = packed[:, :, 0] if packed.ndim == 3 else packed
    ref = ref[:, :, 0] if ref.ndim == 3 else ref
    h, w = ref.shape
    h1, w1 = -(-h // 2), -(-w // 2)
    assert np.array_equal(got[:h1, w1:], ref[:h1, w1:])
    assert np.array_equal(got[h1:, :], ref[h1:, :])


def test_sop_resync_strict_mode_still_raises():
    """Strict decode is untouched by the resync path."""
    import pytest
    from go_dicom_codec_jax.errors import CorruptStreamError
    img = _img()
    s = _enc(img, num_levels=2)
    spans = _packet_spans(s)
    p0, p1 = spans[1]
    bad = bytearray(s)
    for i in range(p0 + 6, p1):
        bad[i] = 0xFF
    with pytest.raises(CorruptStreamError):
        J2KDecoder().decode(bytes(bad))
