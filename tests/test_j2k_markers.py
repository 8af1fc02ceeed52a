"""COC/QCC/POC/PLT/TLM marker support (reference codestream/parser.go
main-header dispatch :104-306, types.go per-component resolution
:4-355, encoder.go writeTLM :1219)."""

import numpy as np
import pytest

from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder, J2KEncodeParams,
                                                J2KEncoder, band_mb)
from go_dicom_codec_jax.codecs.j2k_geometry import build_tile_geometry
from go_dicom_codec_jax.codestream import j2k
from go_dicom_codec_jax.t2.packets import (BlockState, PrecinctState,
                                           decode_packet, poc_progression_order,
                                           progression_order)


def _encode_gray(img, levels, cb=64):
    h, w = img.shape
    enc = J2KEncoder(J2KEncodeParams(num_levels=levels, lossless=True,
                                     cb_width=cb, cb_height=cb))
    return enc.encode(img.astype("<u2").tobytes(), w, h, 1, 16, False)


def _decode(data):
    arr, siz, cod = J2KDecoder().decode(data)
    return arr


# ---- segment writers/parsers roundtrip -------------------------------------

def test_tlm_roundtrip():
    seg = j2k.write_tlm(3, [(0, 1000), (1, 70000)])
    assert seg[:2] == b"\xff\x55"
    ztlm, entries = j2k.parse_tlm(seg[4:])
    assert ztlm == 3
    assert entries == [(0, 1000), (1, 70000)]


def test_plt_roundtrip_varint():
    lengths = [0, 1, 127, 128, 300, 16384, 2**21 + 5]
    seg = j2k.write_plt(7, lengths)
    assert seg[:2] == b"\xff\x58"
    z, got = j2k.parse_plt(seg[4:])
    assert z == 7
    assert got == lengths


def test_poc_roundtrip():
    entries = [j2k.PocEntry(rs=0, cs=0, lye=2, re=3, ce=1, prog=0),
               j2k.PocEntry(rs=3, cs=0, lye=2, re=6, ce=1, prog=2)]
    seg = j2k.write_poc(entries, 1)
    assert seg[:2] == b"\xff\x5f"
    got = j2k.parse_poc(seg[4:], 1)
    assert got == entries


def test_coc_roundtrip():
    coc = j2k.CocInfo(comp=1, num_levels=3, cb_width=32, cb_height=16,
                      cb_style=0x08, transform=0,
                      precinct_exps=[(8, 8), (7, 7), (7, 7), (6, 6)])
    seg = j2k.write_coc(coc, 3)
    assert seg[:2] == b"\xff\x53"
    got = j2k.parse_coc(seg[4:], 3)
    assert got == coc


def test_qcc_roundtrip():
    q = j2k.QcdInfo(style=0, guard_bits=2, exponents=[10, 11, 11, 12])
    seg = j2k.write_qcc(2, q, 3)
    assert seg[:2] == b"\xff\x5d"
    comp, got = j2k.parse_qcc(seg[4:], 3)
    assert comp == 2
    assert (got.style, got.guard_bits, got.exponents) == (0, 2, [10, 11, 11, 12])


# ---- resolution precedence --------------------------------------------------

def _insert_after_qcd(data: bytes, seg: bytes) -> bytes:
    """Splice a main-header segment right after the QCD segment."""
    import struct
    pos = 2
    while pos < len(data):
        marker, length = struct.unpack_from(">HH", data, pos)
        end = pos + 2 + length
        if marker == j2k.QCD:
            return data[:end] + seg + data[end:]
        pos = end
    raise AssertionError("QCD not found")


def test_cod_for_qcd_for_precedence():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 4096, (64, 64), dtype=np.uint16)
    data = _encode_gray(img, levels=2)
    cs = j2k.parse_codestream(data)
    # no overrides: falls through to main COD/QCD
    assert cs.cod_for(0) is cs.cod
    assert cs.qcd_for(0) is cs.qcd
    coc = j2k.CocInfo(comp=0, num_levels=cs.cod.num_levels,
                      cb_width=cs.cod.cb_width, cb_height=cs.cod.cb_height,
                      cb_style=cs.cod.cb_style, transform=cs.cod.transform)
    cs.coc[0] = coc
    eff = cs.cod_for(0)
    assert eff.num_levels == cs.cod.num_levels
    assert eff.progression == cs.cod.progression  # COD-only field survives
    q = j2k.QcdInfo(style=0, guard_bits=3, exponents=list(cs.qcd.exponents))
    cs.qcc[0] = q
    assert cs.qcd_for(0) is q
    # tile-level overrides beat main-level
    tile = cs.tiles[0]
    tq = j2k.QcdInfo(style=0, guard_bits=1, exponents=list(cs.qcd.exponents))
    tile.qcc[0] = tq
    assert cs.qcd_for(0, tile) is tq


def test_decode_with_identity_coc_qcc_markers():
    """A stream carrying COC/QCC that restate COD/QCD decodes bit-exact."""
    rng = np.random.default_rng(1)
    img = rng.integers(0, 4096, (64, 64), dtype=np.uint16)
    data = _encode_gray(img, levels=2)
    cs = j2k.parse_codestream(data)
    coc = j2k.CocInfo(comp=0, num_levels=cs.cod.num_levels,
                      cb_width=cs.cod.cb_width, cb_height=cs.cod.cb_height,
                      cb_style=cs.cod.cb_style, transform=cs.cod.transform)
    patched = _insert_after_qcd(data, j2k.write_coc(coc, 1))
    patched = _insert_after_qcd(patched, j2k.write_qcc(0, cs.qcd, 1))
    out = _decode(patched)
    np.testing.assert_array_equal(out[:, :, 0], img.astype(np.int32))


def test_decode_with_full_range_poc():
    """A POC restating the stream's own LRCP progression decodes
    bit-exact through poc_progression_order."""
    rng = np.random.default_rng(2)
    img = rng.integers(0, 4096, (64, 64), dtype=np.uint16)
    data = _encode_gray(img, levels=2)
    cs = j2k.parse_codestream(data)
    poc = [j2k.PocEntry(rs=0, cs=0, lye=cs.cod.num_layers,
                        re=cs.cod.num_levels + 1, ce=1, prog=0)]
    patched = _insert_after_qcd(data, j2k.write_poc(poc, 1))
    assert j2k.parse_codestream(patched).poc == poc
    out = _decode(patched)
    np.testing.assert_array_equal(out[:, :, 0], img.astype(np.int32))


def test_poc_progression_order_covers_once():
    """Split-resolution POC entries cover every packet exactly once."""
    def pinfo(c, r):
        return [(0, 0, 0)] if r < 3 else []

    entries = [j2k.PocEntry(rs=0, cs=0, lye=2, re=2, ce=2, prog=0),
               j2k.PocEntry(rs=0, cs=0, lye=2, re=3, ce=2, prog=1)]
    got = list(poc_progression_order(entries, 2, 3, 2, pinfo))
    assert len(got) == len(set(got)) == 2 * 3 * 2  # l×r×c
    full = set(progression_order(0, 2, 3, 2, pinfo))
    assert set(got) == full
    # first entry's span comes first, in its own (LRCP) order
    assert got[:8] == list(progression_order(0, 2, 2, 2, pinfo))


# ---- heterogeneous per-component styles (real COC/QCC decode) ---------------

def _split_packets(body: bytes, rect, cod, qcd):
    """Packet byte-ranges of a single-component single-layer tile body."""
    tx0, ty0, tx1, ty1 = rect
    resolutions = build_tile_geometry(tx0, ty0, tx1, ty1, cod.num_levels,
                                      cod.cb_width, cod.cb_height,
                                      cod.precinct_exp)
    states = {}
    for res in resolutions:
        for prec in res.precincts:
            plist = []
            for pb in prec.bands:
                mb = band_mb(qcd, res.r, pb.band.band, cod.num_levels)
                plist.append(PrecinctState(
                    ncbw=pb.ncbw, ncbh=pb.ncbh,
                    blocks=[BlockState(cbx=g.cbx, cby=g.cby)
                            for g in pb.blocks],
                    mb=mb))
            states[(res.r, prec.index)] = plist

    def pinfo(c, r):
        res = resolutions[r]
        lv = cod.num_levels
        return [(p.index, p.x0 << (lv - r), p.y0 << (lv - r))
                for p in res.precincts]

    bounds = []
    pos = 0
    for (l, r, c, pidx) in progression_order(cod.progression,
                                             cod.num_layers,
                                             cod.num_levels + 1, 1, pinfo):
        start = pos
        pos = decode_packet(body, pos, states[(r, pidx)], l, cod.cb_style)
        bounds.append((r, body[start:pos]))
    return bounds


def test_heterogeneous_coc_qcc_decode():
    """Two components with different decomposition levels via COC, and
    per-component quantization via QCC: remux two single-component
    streams into one 2-component codestream and decode it."""
    import struct
    rng = np.random.default_rng(3)
    img_a = rng.integers(0, 4096, (64, 64), dtype=np.uint16)
    img_b = rng.integers(0, 4096, (64, 64), dtype=np.uint16)
    enc_a = _encode_gray(img_a, levels=2)
    enc_b = _encode_gray(img_b, levels=1)
    cs_a = j2k.parse_codestream(enc_a)
    cs_b = j2k.parse_codestream(enc_b)
    rect = cs_a.siz.tile_rect(0, 0)
    pk_a = _split_packets(cs_a.tiles[0].data, rect, cs_a.cod, cs_a.qcd)
    pk_b = _split_packets(cs_b.tiles[0].data, rect, cs_b.cod, cs_b.qcd)

    # LRCP over 2 comps: within each resolution, comp 0 then comp 1
    tagged = [(r, 0, blob) for (r, blob) in pk_a] + \
             [(r, 1, blob) for (r, blob) in pk_b]
    tagged.sort(key=lambda t: (t[0], t[1]))
    body = b"".join(blob for (_, _, blob) in tagged)

    siz = j2k.SizInfo(
        xsiz=cs_a.siz.xsiz, ysiz=cs_a.siz.ysiz, xosiz=0, yosiz=0,
        xtsiz=cs_a.siz.xtsiz, ytsiz=cs_a.siz.ytsiz, xtosiz=0, ytosiz=0,
        components=[cs_a.siz.components[0], cs_b.siz.components[0]])
    coc = j2k.CocInfo(comp=1, num_levels=cs_b.cod.num_levels,
                      cb_width=cs_b.cod.cb_width,
                      cb_height=cs_b.cod.cb_height,
                      cb_style=cs_b.cod.cb_style,
                      transform=cs_b.cod.transform)
    out = bytearray(b"\xff\x4f")
    out += j2k.write_siz(siz)
    out += j2k.write_cod(cs_a.cod)
    out += j2k.write_coc(coc, 2)
    out += j2k.write_qcd(cs_a.qcd)
    out += j2k.write_qcc(1, cs_b.qcd, 2)
    out += j2k.write_tile_part(0, body)
    out += j2k.EOC.to_bytes(2, "big")

    arr = _decode(bytes(out))
    np.testing.assert_array_equal(arr[:, :, 0], img_a.astype(np.int32))
    np.testing.assert_array_equal(arr[:, :, 1], img_b.astype(np.int32))


def test_subsampled_component_decode():
    """XRsiz/YRsiz component subsampling: remux a full-res and a
    2×2-subsampled component into one stream; the decoder builds each
    component's ceil-divided grid (reference tile_decoder.go:330-392)
    and upsamples by replication for interleaved output."""
    rng = np.random.default_rng(5)
    img_a = rng.integers(0, 4096, (64, 64), dtype=np.uint16)
    img_b = rng.integers(0, 4096, (32, 32), dtype=np.uint16)

    def enc_gray(img):
        h, w = img.shape
        return J2KEncoder(J2KEncodeParams(num_levels=2)).encode(
            img.astype("<u2").tobytes(), w, h, 1, 16, False)

    cs_a = j2k.parse_codestream(enc_gray(img_a))
    cs_b = j2k.parse_codestream(enc_gray(img_b))
    pk_a = _split_packets(cs_a.tiles[0].data, cs_a.siz.tile_rect(0, 0),
                          cs_a.cod, cs_a.qcd)
    pk_b = _split_packets(cs_b.tiles[0].data, cs_b.siz.tile_rect(0, 0),
                          cs_b.cod, cs_b.qcd)
    tagged = [(r, 0, blob) for (r, blob) in pk_a] + \
             [(r, 1, blob) for (r, blob) in pk_b]
    tagged.sort(key=lambda t: (t[0], t[1]))
    body = b"".join(blob for (_, _, blob) in tagged)

    siz = j2k.SizInfo(xsiz=64, ysiz=64, xtsiz=64, ytsiz=64,
                      components=[(16, False, 1, 1), (16, False, 2, 2)])
    out = bytearray(b"\xff\x4f")
    out += j2k.write_siz(siz)
    out += j2k.write_cod(cs_a.cod)
    out += j2k.write_qcd(cs_a.qcd)
    out += j2k.write_tile_part(0, body)
    out += j2k.EOC.to_bytes(2, "big")

    arr = _decode(bytes(out))
    assert arr.shape == (64, 64, 2)
    np.testing.assert_array_equal(arr[:, :, 0], img_a.astype(np.int32))
    np.testing.assert_array_equal(
        arr[:, :, 1], np.repeat(np.repeat(img_b, 2, 0), 2, 1).astype(np.int32))


def test_htj2k_emits_tlm():
    rng = np.random.default_rng(4)
    img = rng.integers(0, 4096, (64, 64), dtype=np.uint16)
    enc = J2KEncoder(J2KEncodeParams(num_levels=2, lossless=True, htj2k=True))
    data = enc.encode(img.astype("<u2").tobytes(), 64, 64, 1, 16, False)
    import struct
    pos = 2
    tlm = None
    while pos < len(data):
        marker, length = struct.unpack_from(">HH", data, pos)
        if marker == j2k.TLM:
            tlm = data[pos + 4: pos + 2 + length]
            break
        if marker == j2k.SOT:
            break
        pos += 2 + length
    assert tlm is not None, "HTJ2K stream missing TLM"
    _, entries = j2k.parse_tlm(tlm)
    assert len(entries) == 1
    # Ptlm covers SOT..end of tile-part; verify against actual SOT Psot
    sot_pos = data.index(b"\xff\x90")
    psot = struct.unpack_from(">I", data, sot_pos + 6)[0]
    assert entries[0] == (0, psot)
    out = _decode(data)
    np.testing.assert_array_equal(out[:, :, 0], img.astype(np.int32))


def test_sop_marked_stream_decode():
    """SOP packet markers (Scod bit 1): the decoder skips FF91 segments
    before each packet when the COD flags them (the reference never
    emits SOP; decode-side support only)."""
    import dataclasses
    import struct

    rng = np.random.default_rng(11)
    img = rng.integers(0, 4096, (64, 64)).astype("<u2")
    enc = J2KEncoder(J2KEncodeParams(num_levels=2)).encode(
        img.tobytes(), 64, 64, 1, 16, False)
    cs = j2k.parse_codestream(enc)
    pk = _split_packets(cs.tiles[0].data, cs.siz.tile_rect(0, 0),
                        cs.cod, cs.qcd)
    out_body = bytearray()
    for nsop, (_, blob) in enumerate(pk):
        out_body += struct.pack(">HHH", 0xFF91, 4, nsop & 0xFFFF)
        out_body += blob
    cod2 = dataclasses.replace(cs.cod, use_sop=True)
    out = bytearray(b"\xff\x4f")
    out += j2k.write_siz(cs.siz)
    out += j2k.write_cod(cod2)
    out += j2k.write_qcd(cs.qcd)
    out += j2k.write_tile_part(0, bytes(out_body))
    out += j2k.EOC.to_bytes(2, "big")
    arr = _decode(bytes(out))
    np.testing.assert_array_equal(arr[:, :, 0], img.astype(np.int32))
