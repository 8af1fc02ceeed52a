"""PPM/PPT packed packet headers (T.800 A.7.4/A.7.5).

The reference defines the PPM/PPT marker constants but neither writes
nor reads them (/root/reference/jpeg2000/codestream/markers.go:69-72 is
their only appearance) — real-world encoders (OpenJPEG -PPM/-PPT
options, Kakadu ORGgen_plt variants) do emit them, so this repo goes
beyond the reference: the encoder can write PPT (packed_headers=True)
and the decoder reads both PPT and PPM. Pixels must be identical to the
in-bitstream-headers decode; OpenJPEG (via the PIL oracle, where
available) must accept our PPT streams.
"""

import struct

import numpy as np
import pytest

from go_dicom_codec_jax.codecs.jpeg2000 import (J2KEncodeParams, J2KEncoder,
                                                decode_to_pixels)
from go_dicom_codec_jax.codestream import j2k
from go_dicom_codec_jax.errors import CorruptStreamError


def _find_seg(data, marker):
    """Offset of the first `marker` segment, walking the marker
    structure (a raw byte search can false-match entropy data)."""
    pos = 2
    while pos < len(data):
        m = struct.unpack_from(">H", data, pos)[0]
        if m == j2k.EOC:
            break
        if m == marker:
            return pos
        if m == j2k.SOT:
            ln = struct.unpack_from(">H", data, pos + 2)[0]
            psot = struct.unpack_from(">I", data, pos + 6)[0]
            p = pos + 2 + ln
            while struct.unpack_from(">H", data, p)[0] != j2k.SOD:
                m2, l2 = struct.unpack_from(">HH", data, p)
                if m2 == marker:
                    return p
                p += 2 + l2
            pos += psot
            continue
        ln = struct.unpack_from(">H", data, pos + 2)[0]
        pos += 2 + ln
    return -1


def _img(h=120, w=110, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4096, size=(h, w), dtype=np.uint16).astype(
        np.int32)


def _encode(img, packed, **kw):
    p = J2KEncodeParams(packed_headers=packed, **kw)
    return J2KEncoder(p).encode(img, img.shape[1], img.shape[0], 1, 12)


CONFIGS = [
    dict(),
    dict(cb_style=0),
    dict(num_layers=3, progression=j2k.PROG_RPCL),
    dict(tile_width=64, tile_height=48),
    dict(lossless=False, quality=60),
    dict(lossless=False, quality=60, num_layers=2, progression=j2k.PROG_PCRL),
    dict(htj2k=True),
    dict(precincts=[(6, 6)] * 6),
]


@pytest.mark.parametrize("kw", CONFIGS,
                         ids=[",".join(f"{k}={v}" for k, v in c.items())
                              or "default" for c in CONFIGS])
def test_ppt_roundtrip_matches_inline_headers(kw):
    img = _img()
    inline = _encode(img, False, **kw)
    packed = _encode(img, True, **kw)
    cs_p = j2k.parse_codestream(packed)
    cs_i = j2k.parse_codestream(inline)
    assert all(t.ppt is not None for t in cs_p.tiles.values())
    assert all(t.ppt is None for t in cs_i.tiles.values())
    assert decode_to_pixels(packed) == decode_to_pixels(inline)


def test_ppt_lossless_bit_exact():
    img = _img()
    packed = _encode(img, True)
    pix, w, h, c, depth, signed = decode_to_pixels(packed)
    assert (w, h, c, depth, signed) == (110, 120, 1, 12, False)
    assert np.frombuffer(pix, "<u2").reshape(120, 110).astype(
        np.int32).tolist() == img.tolist()


def test_ppt_segment_split_and_reorder():
    """Multi-segment PPT (tiny max_chunk) and Zppt arriving out of
    order must reassemble identically."""
    img = _img()
    packed = _encode(img, True, tile_width=64, tile_height=48)
    ref = decode_to_pixels(packed)

    # re-split every tile's PPT payload into 37-byte segments
    def resplit(data, reorder):
        pos, out = 2, bytearray(data[:2])
        while pos < len(data):
            marker = struct.unpack_from(">H", data, pos)[0]
            if marker == j2k.EOC:
                break
            if marker == j2k.SOT:
                ln = struct.unpack_from(">H", data, pos + 2)[0]
                isot, psot, tpsot, tnsot = struct.unpack_from(
                    ">HIBB", data, pos + 4)
                p = pos + 2 + ln
                hdrs = bytearray()
                other = bytearray()
                while struct.unpack_from(">H", data, p)[0] != j2k.SOD:
                    m2, l2 = struct.unpack_from(">HH", data, p)
                    if m2 == j2k.PPT:
                        hdrs += data[p + 5:p + 2 + l2]
                    else:
                        other += data[p:p + 2 + l2]
                    p += 2 + l2
                body = data[p + 2:pos + psot]
                segs = j2k.write_ppt(bytes(hdrs), max_chunk=37)
                if reorder:  # whole segments, reversed Zppt order
                    parts = []
                    q = 0
                    while q < len(segs):
                        l2 = struct.unpack_from(">H", segs, q + 2)[0]
                        parts.append(segs[q:q + 2 + l2])
                        q += 2 + l2
                    segs = b"".join(reversed(parts))
                new_psot = 12 + len(other) + len(segs) + 2 + len(body)
                out += struct.pack(">HHHIBB", j2k.SOT, 10, isot, new_psot,
                                   tpsot, tnsot)
                out += other + segs + struct.pack(">H", j2k.SOD) + body
                pos += psot
                continue
            ln = struct.unpack_from(">H", data, pos + 2)[0]
            out += data[pos:pos + 2 + ln]
            pos += 2 + ln
        out += j2k.EOC.to_bytes(2, "big")
        return bytes(out)

    for reorder in (False, True):
        remuxed = resplit(packed, reorder)
        assert decode_to_pixels(remuxed) == ref


def _ppt_to_ppm(data, max_chunk=65532):
    """Move every tile-part's PPT payload into main-header PPM."""
    pos, records, parts, main = 2, [], [], bytearray()
    while pos < len(data):
        marker = struct.unpack_from(">H", data, pos)[0]
        if marker == j2k.EOC:
            break
        if marker == j2k.SOT:
            ln = struct.unpack_from(">H", data, pos + 2)[0]
            isot, psot, tpsot, tnsot = struct.unpack_from(">HIBB", data,
                                                          pos + 4)
            p = pos + 2 + ln
            hdrs = bytearray()
            other = bytearray()
            while struct.unpack_from(">H", data, p)[0] != j2k.SOD:
                m2, l2 = struct.unpack_from(">HH", data, p)
                if m2 == j2k.PPT:
                    hdrs += data[p + 5:p + 2 + l2]
                else:
                    other += data[p:p + 2 + l2]
                p += 2 + l2
            body = data[p + 2:pos + psot]
            records.append(bytes(hdrs))
            parts.append((isot, tpsot, tnsot, bytes(other), body))
            pos += psot
            continue
        ln = struct.unpack_from(">H", data, pos + 2)[0]
        main += data[pos:pos + 2 + ln]
        pos += 2 + ln
    out = bytearray(data[:2]) + main
    out += j2k.write_ppm(records, max_chunk=max_chunk)
    for (isot, tpsot, tnsot, other, body) in parts:
        psot = 12 + len(other) + 2 + len(body)
        out += struct.pack(">HHHIBB", j2k.SOT, 10, isot, psot, tpsot, tnsot)
        out += other + struct.pack(">H", j2k.SOD) + body
    out += j2k.EOC.to_bytes(2, "big")
    return bytes(out)


@pytest.mark.parametrize("max_chunk", [65532, 41])
def test_ppm_decode(max_chunk):
    """Main-header PPM: multi-tile records assigned per tile-part in
    codestream order; small max_chunk makes records straddle segment
    boundaries (the spec allows splitting anywhere)."""
    img = _img()
    packed = _encode(img, True, tile_width=64, tile_height=48,
                     num_layers=2)
    ppm_stream = _ppt_to_ppm(packed, max_chunk=max_chunk)
    assert _find_seg(ppm_stream, j2k.PPM) > 0
    assert _find_seg(ppm_stream, j2k.PPT) == -1
    cs = j2k.parse_codestream(ppm_stream)
    assert all(t.ppt is not None for t in cs.tiles.values())
    assert decode_to_pixels(ppm_stream) == decode_to_pixels(packed)


def test_ppm_truncated_record_raises():
    img = _img(64, 64)
    packed = _encode(img, True)
    ppm_stream = _ppt_to_ppm(packed)
    # chop the last PPM segment's payload mid-record: shrink Nppm's data
    i = _find_seg(ppm_stream, j2k.PPM)
    ln = struct.unpack_from(">H", ppm_stream, i + 2)[0]
    corrupt = (ppm_stream[:i + 2] + struct.pack(">H", ln) +
               ppm_stream[i + 4:i + 2 + ln - 5] +
               ppm_stream[i + 2 + ln:])
    with pytest.raises(CorruptStreamError):
        decode_to_pixels(corrupt)


def test_empty_ppt_segment_raises():
    img = _img(64, 64)
    packed = _encode(img, True)
    i = _find_seg(packed, j2k.PPT)
    # replace the PPT segment with an empty-payload one (Lppt=2)
    ln = struct.unpack_from(">H", packed, i + 2)[0]
    corrupt = packed[:i + 2] + struct.pack(">H", 2) + packed[i + 2 + ln:]
    with pytest.raises(CorruptStreamError):
        decode_to_pixels(corrupt)


def test_adapter_packed_headers_param():
    import go_dicom_codec_jax as dc
    img = _img()
    info = dc.FrameInfo(width=110, height=120, bits_allocated=16,
                        bits_stored=12)
    src = dc.MemoryPixelData(info=info)
    src.add_frame(img.astype("<u2").tobytes())
    codec = dc.get_global_registry().get_codec(dc.uids.JPEG_2000_LOSSLESS)
    enc = dc.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc, dc.Parameters(packed_headers=True))
    assert _find_seg(enc.get_frame(0), j2k.PPT) > 0
    dec = dc.MemoryPixelData(info=info)
    codec.decode(enc, dec)
    assert dec.get_frame(0) == src.get_frame(0)


def test_ppt_openjpeg_oracle():
    PIL_Image = pytest.importorskip("PIL.Image")
    import io
    img = _img()
    packed = _encode(img, True, tile_width=64, tile_height=48)
    arr = np.asarray(PIL_Image.open(io.BytesIO(packed),
                                    formats=["JPEG2000"]))
    # PIL/OpenJPEG returns N-bit in 16-bit containers shifted by (16-N)
    assert np.array_equal(arr >> 4, img.astype(arr.dtype))


def test_ppt_pipelined_encode_matches_scalar():
    from go_dicom_codec_jax.pipeline import encode_frames_pipelined
    imgs = np.stack([_img(seed=i) for i in range(3)])
    streams = encode_frames_pipelined(
        imgs, bit_depth=12,
        params=J2KEncodeParams(packed_headers=True))
    scalar = [_encode(imgs[i], True) for i in range(3)]
    assert [bytes(s) for s in streams] == scalar


def test_all_marker_options_pipelined_matches_scalar():
    """The batched multi-frame encoder must stay byte-identical to the
    scalar encoder under the full marker-option surface (regression:
    it silently dropped TLM)."""
    from go_dicom_codec_jax.pipeline import encode_frames_pipelined
    kw = dict(packed_headers=True, use_sop=True, use_eph=True,
              plt_markers=True, tlm_markers=True)
    imgs = np.stack([_img(seed=i) for i in range(3)])
    streams = encode_frames_pipelined(imgs, bit_depth=12,
                                      params=J2KEncodeParams(**kw))
    scalar = [J2KEncoder(J2KEncodeParams(**kw)).encode(
        imgs[i], 110, 120, 1, 12) for i in range(3)]
    assert [bytes(s) for s in streams] == scalar


# ---- SOP/EPH resync-marker WRITE support (decode predates it) ----------
# The reference decodes Scod SOP/EPH flags (t2/packet_header.go) but its
# encoder never sets them; here both directions work, composing with
# packed headers (EPH rides in the PPT stream, SOP stays in the body).

SOP_CONFIGS = [
    dict(use_sop=True),
    dict(use_eph=True),
    dict(use_sop=True, use_eph=True),
    dict(use_sop=True, use_eph=True, packed_headers=True),
    dict(use_sop=True, use_eph=True, num_layers=3,
         progression=j2k.PROG_RPCL),
    dict(use_sop=True, use_eph=True, lossless=False, quality=60,
         target_ratio=6.0, num_layers=2),
    dict(use_sop=True, use_eph=True, htj2k=True),
]


@pytest.mark.parametrize("kw", SOP_CONFIGS,
                         ids=[",".join(f"{k}={v}" for k, v in c.items())
                              for c in SOP_CONFIGS])
def test_sop_eph_roundtrip(kw):
    img = _img()
    plain = _encode(img, False)
    marked = J2KEncoder(J2KEncodeParams(**kw)).encode(img, 110, 120, 1, 12)
    cs = j2k.parse_codestream(marked)
    assert cs.cod.use_sop == bool(kw.get("use_sop"))
    assert cs.cod.use_eph == bool(kw.get("use_eph"))
    got = decode_to_pixels(marked)
    if kw.get("lossless", True):
        assert got == decode_to_pixels(plain)
    else:
        assert got[1:] == decode_to_pixels(plain)[1:]  # same geometry


def test_sop_markers_in_body():
    """First packet's SOP carries Nsop=0 and markers count up."""
    img = _img(64, 64)
    marked = J2KEncoder(J2KEncodeParams(use_sop=True, num_levels=2)
                        ).encode(img, 64, 64, 1, 12)
    cs = j2k.parse_codestream(marked)
    body = cs.tiles[0].data
    # LRCP, 1 layer, 3 resolutions, 1 precinct each → 3 packets
    for n in range(3):
        assert body[:6] != b"" and struct.unpack_from(">HHH", body)[0:3] \
            == (j2k.SOP, 4, n)
        # skip SOP; find the next one by parsing is overkill — re-scan
        nxt = body[6:].find(struct.pack(">HHH", j2k.SOP, 4, n + 1))
        if n < 2:
            assert nxt >= 0
            body = body[6 + nxt:]


def test_sop_eph_native_disabled_parity():
    """SOP/EPH assembly is Python-side; the native-disabled lane must
    produce the identical stream (native T2 is gated off for it)."""
    import subprocess
    import sys
    code = (
        "import os, hashlib, numpy as np\n"
        "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
        "from go_dicom_codec_jax.codecs.jpeg2000 import (J2KEncoder,\n"
        "    J2KEncodeParams)\n"
        "rng = np.random.default_rng(3)\n"
        "img = rng.integers(0, 4096, (120, 110)).astype(np.int32)\n"
        "s = J2KEncoder(J2KEncodeParams(use_sop=True, use_eph=True,\n"
        "    num_layers=2)).encode(img, 110, 120, 1, 12)\n"
        "print(hashlib.sha256(s).hexdigest())\n")
    outs = []
    for disable in ("", "1"):
        env = dict(**__import__("os").environ)
        if disable:
            env["GDCT_DISABLE_NATIVE"] = disable
        else:
            env.pop("GDCT_DISABLE_NATIVE", None)
        r = subprocess.run([sys.executable, "-c", code], env=env,
                           capture_output=True, text=True, timeout=300)
        assert r.returncode == 0, r.stderr
        outs.append(r.stdout.strip())
    assert outs[0] == outs[1]


def test_sop_eph_openjpeg_oracle():
    PIL_Image = pytest.importorskip("PIL.Image")
    import io
    img = _img()
    marked = J2KEncoder(J2KEncodeParams(use_sop=True, use_eph=True)
                        ).encode(img, 110, 120, 1, 12)
    arr = np.asarray(PIL_Image.open(io.BytesIO(marked),
                                    formats=["JPEG2000"]))
    assert np.array_equal(arr >> 4, img.astype(arr.dtype))


# ---- PLT packet-length pointers (write; parse predates it) --------------

def _collect_plt_lengths(stream):
    """All PLT varint lengths for tile 0, Zplt order."""
    pos = 2
    segs = []
    while pos < len(stream):
        m = struct.unpack_from(">H", stream, pos)[0]
        if m == j2k.EOC:
            break
        if m == j2k.SOT:
            ln = struct.unpack_from(">H", stream, pos + 2)[0]
            psot = struct.unpack_from(">I", stream, pos + 6)[0]
            p = pos + 2 + ln
            while struct.unpack_from(">H", stream, p)[0] != j2k.SOD:
                m2, l2 = struct.unpack_from(">HH", stream, p)
                if m2 == j2k.PLT:
                    segs.append(stream[p + 4:p + 2 + l2])
                p += 2 + l2
            body = stream[p + 2:pos + psot]
            lengths = []
            for seg in sorted(segs, key=lambda s: s[0]):
                _, ls = j2k.parse_plt(seg)
                lengths.extend(ls)
            return lengths, body
        ln = struct.unpack_from(">H", stream, pos + 2)[0]
        pos += 2 + ln
    return [], b""


@pytest.mark.parametrize("kw", [
    dict(plt_markers=True),
    dict(plt_markers=True, use_sop=True, use_eph=True),
    dict(plt_markers=True, packed_headers=True),
    dict(plt_markers=True, num_layers=3, progression=j2k.PROG_RPCL),
    dict(plt_markers=True, htj2k=True),
], ids=["plain", "sop+eph", "ppt", "layers", "ht"])
def test_plt_lengths_cover_the_bitstream(kw):
    img = _img()
    plain = _encode(img, False)
    marked = J2KEncoder(J2KEncodeParams(**kw)).encode(img, 110, 120, 1, 12)
    lengths, body = _collect_plt_lengths(marked)
    assert lengths and sum(lengths) == len(body)
    assert decode_to_pixels(marked) == decode_to_pixels(plain)


def test_plt_boundaries_hit_sop_markers():
    """With SOP on, every PLT length lands exactly on the next SOP."""
    img = _img()
    marked = J2KEncoder(J2KEncodeParams(plt_markers=True, use_sop=True)
                        ).encode(img, 110, 120, 1, 12)
    lengths, body = _collect_plt_lengths(marked)
    pos = 0
    for n, ln in enumerate(lengths):
        assert struct.unpack_from(">HHH", body, pos) == (j2k.SOP, 4, n)
        pos += ln
    assert pos == len(body)


def test_write_plt_segments_splits_between_varints():
    lengths = [5, 300, 70000, 1, 128]
    segs = j2k.write_plt_segments(lengths, max_chunk=3)
    # parse back: multiple Zplt segments, concatenated varints intact
    pos = 0
    got = []
    zs = []
    while pos < len(segs):
        m, ln = struct.unpack_from(">HH", segs, pos)
        assert m == j2k.PLT
        z, ls = j2k.parse_plt(segs[pos + 4:pos + 2 + ln])
        zs.append(z)
        got.extend(ls)
        pos += 2 + ln
    assert zs == sorted(zs) and len(zs) > 1
    assert got == lengths


# ---- TLM tile-part pointers for classic J2K (tlm_markers) ---------------

def test_tlm_markers_on_classic_j2k():
    """TLM entries must point at the exact tile-part extents (the
    reference writes TLM only on the HT path; tlm_markers extends it
    to classic streams, composing with PPT/PLT header segments)."""
    img = _img()
    s = J2KEncoder(J2KEncodeParams(tlm_markers=True, tile_width=64,
                                   tile_height=48, packed_headers=True,
                                   plt_markers=True)
                   ).encode(img, 110, 120, 1, 12)
    i = _find_seg(s, j2k.TLM)
    assert i > 0
    ln = struct.unpack_from(">H", s, i + 2)[0]
    z, entries = j2k.parse_tlm(s[i + 4:i + 2 + ln])
    # walk the real tile-parts and compare (Ttlm, Ptlm) pairwise
    pos, seen = 2, []
    while pos < len(s):
        m = struct.unpack_from(">H", s, pos)[0]
        if m == j2k.EOC:
            break
        if m == j2k.SOT:
            isot, psot = struct.unpack_from(">HI", s, pos + 4)
            seen.append((isot, psot))
            pos += psot
            continue
        pos += 2 + struct.unpack_from(">H", s, pos + 2)[0]
    assert entries == seen and len(entries) == 6  # 2x3 tile grid
    assert decode_to_pixels(s) == decode_to_pixels(
        J2KEncoder(J2KEncodeParams()).encode(img, 110, 120, 1, 12))


def test_ppt_writer_rejects_256_segments():
    with pytest.raises(ValueError):
        j2k.write_ppt(b"x" * 300, max_chunk=1)
    with pytest.raises(ValueError):
        j2k.write_ppm([b"x" * 300], max_chunk=1)
    with pytest.raises(ValueError):
        j2k.write_plt_segments([1] * 300, max_chunk=1)


def test_packed_layered_truncation_decodes_gracefully():
    """Rate truncation cuts packet bodies while PPT headers stay whole;
    a STRICT decode must still return the surviving layers (same
    graceful break as the in-bitstream layout)."""
    img = _img()
    s = J2KEncoder(J2KEncodeParams(packed_headers=True, plt_markers=True,
                                   num_layers=2, layer_rates=[16.0, 0])
                   ).encode(img, 110, 120, 1, 12)
    # layer-0 body size = sum of the first half of the PLT lengths
    # (LRCP is layer-major; 1 tile, maximal precincts)
    pos, lengths = 2, []
    sot = None
    while pos < len(s):
        m = struct.unpack_from(">H", s, pos)[0]
        if m == j2k.EOC:
            break
        if m == j2k.SOT:
            sot = pos
            ln = struct.unpack_from(">H", s, pos + 2)[0]
            psot = struct.unpack_from(">I", s, pos + 6)[0]
            p = pos + 2 + ln
            while struct.unpack_from(">H", s, p)[0] != j2k.SOD:
                m2, l2 = struct.unpack_from(">HH", s, p)
                if m2 == j2k.PLT:
                    lengths.extend(j2k.parse_plt(s[p + 4:p + 2 + l2])[1])
                p += 2 + l2
            body_start = p + 2
            pos += psot
            continue
        pos += 2 + struct.unpack_from(">H", s, pos + 2)[0]
    assert lengths and len(lengths) % 2 == 0
    l0 = sum(lengths[:len(lengths) // 2])
    truncated = s[:body_start + l0]
    full = np.frombuffer(decode_to_pixels(s)[0], "<u2").astype(np.int64)
    assert np.array_equal(full, img.reshape(-1))
    pix, w, h, c, depth, signed = decode_to_pixels(truncated)  # STRICT
    part = np.frombuffer(pix, "<u2").astype(np.int64)
    # strict and resilient must agree on the truncated stream, and
    # layer 0 alone (16:1 on noise) is lossy but not garbage
    from go_dicom_codec_jax.codecs.jpeg2000 import J2KDecoder
    res = J2KDecoder(resilient=True).decode(truncated)[0][:, :, 0]
    assert np.array_equal(part.reshape(120, 110),
                          np.clip(res, 0, 4095))
    err = np.abs(part - img.reshape(-1)).mean()
    assert 0 < err < 1500
