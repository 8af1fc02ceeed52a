"""JP2/JPH container WRITE (codestream/j2k.wrap_jp2) — write direction
of the transparent unwrap the decoder already does.

Beyond the reference: it transports raw codestreams only (its
codestream/markers.go has no box layer at all). Box layout is written
from ISO 15444-1 Annex I (ihdr/colr/jp2c) and ISO 15444-15 Annex A
(brand "jph "); PIL/OpenJPEG serves as the foreign oracle that the
files — not just the embedded codestreams — are well-formed.
"""

import io
import struct

import numpy as np
import pytest

from go_dicom_codec_jax.codestream import j2k
from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder, J2KEncodeParams,
                                                J2KEncoder)
from go_dicom_codec_jax.errors import CorruptStreamError


def _img(bits=8, h=64, w=48, comps=1, seed=3):
    rng = np.random.default_rng(seed)
    a = np.cumsum(rng.integers(-5, 6, (h, w, comps)), axis=1)
    a = (a % ((1 << bits) - 8) + 4).astype(np.int32)
    return a[..., 0] if comps == 1 else a


def _encode(img, bits=8, comps=1, **kw):
    h, w = img.shape[:2]
    return J2KEncoder(J2KEncodeParams(**kw)).encode(img, w, h, comps, bits)


def _boxes(data):
    """[(type, payload)] top-level box walk."""
    out = []
    pos = 0
    while pos + 8 <= len(data):
        lbox = struct.unpack_from(">I", data, pos)[0]
        tbox = data[pos + 4:pos + 8]
        end = len(data) if lbox == 0 else pos + lbox
        out.append((tbox, data[pos + 8:end]))
        pos = end
    return out


def test_wrap_roundtrips_through_unwrap():
    cs = _encode(_img(), 8)
    for brand in ("jp2", "jph"):
        wrapped = j2k.wrap_jp2(cs, brand=brand)
        assert wrapped.startswith(j2k._JP2_SIGNATURE)
        assert j2k.unwrap_jp2(wrapped) == cs


def test_box_structure_and_ihdr_fields():
    img = _img(bits=12, h=50, w=70)
    cs = _encode(img, 12)
    boxes = _boxes(j2k.wrap_jp2(cs))
    types = [t for t, _ in boxes]
    # signature first, ftyp second, header before codestream (I.4)
    assert types[0] == b"jP  " and types[1] == b"ftyp"
    assert types.index(b"jp2h") < types.index(b"jp2c")
    ftyp = dict(boxes)[b"ftyp"]
    assert ftyp[:4] == b"jp2 " and ftyp[8:12] == b"jp2 "
    sub = dict(_boxes(dict(boxes)[b"jp2h"]))
    h, w, nc, bpc, ctyp, unkc, ipr = struct.unpack(">IIHBBBB", sub[b"ihdr"])
    assert (h, w, nc) == (50, 70, 1)
    assert bpc == 11 and ctyp == 7 and unkc == 0 and ipr == 0
    meth, prec, approx, enumcs = struct.unpack(">BBBI", sub[b"colr"])
    assert (meth, enumcs) == (1, 17)  # enumerated greyscale


def test_rgb_ihdr_and_srgb_colr():
    img = _img(8, comps=3)
    wrapped = j2k.wrap_jp2(_encode(img, 8, comps=3))
    sub = dict(_boxes(dict(_boxes(wrapped))[b"jp2h"]))
    *_, nc, bpc, _, unkc, _ = struct.unpack(">IIHBBBB", sub[b"ihdr"])
    assert nc == 3 and bpc == 7 and unkc == 0
    assert struct.unpack(">BBBI", sub[b"colr"])[3] == 16  # sRGB


def test_jph_brand():
    cs = _encode(_img(), 8, htj2k=True)
    ftyp = dict(_boxes(j2k.wrap_jp2(cs, brand="jph")))[b"ftyp"]
    assert ftyp[:4] == b"jph " and ftyp[8:12] == b"jph "


def test_signed_and_heterogeneous_depths():
    # signed uniform → BPC sign bit; hetero depths → BPC=255 + bpcc
    siz = j2k.write_siz(j2k.SizInfo(
        xsiz=16, ysiz=16, xtsiz=16, ytsiz=16,
        components=[(12, True, 1, 1), (12, True, 1, 1)]))
    cs = j2k.SOC.to_bytes(2, "big") + siz
    sub = dict(_boxes(dict(_boxes(j2k.wrap_jp2(cs)))[b"jp2h"]))
    bpc = struct.unpack(">IIHBBBB", sub[b"ihdr"])[3]
    assert bpc == (11 | 0x80)
    assert b"bpcc" not in sub
    # 2 components is neither grey nor RGB → UnkC set
    assert struct.unpack(">IIHBBBB", sub[b"ihdr"])[5] == 1

    siz = j2k.write_siz(j2k.SizInfo(
        xsiz=16, ysiz=16, xtsiz=16, ytsiz=16,
        components=[(8, False, 1, 1), (12, True, 1, 1)]))
    cs = j2k.SOC.to_bytes(2, "big") + siz
    sub = dict(_boxes(dict(_boxes(j2k.wrap_jp2(cs)))[b"jp2h"]))
    assert struct.unpack(">IIHBBBB", sub[b"ihdr"])[3] == 255
    assert sub[b"bpcc"] == bytes([7, 11 | 0x80])


def test_wrap_rejects_garbage():
    with pytest.raises(CorruptStreamError):
        j2k.wrap_jp2(b"\x00" * 32)
    with pytest.raises(ValueError):
        j2k.wrap_jp2(_encode(_img(), 8), brand="mj2")


def test_encoder_container_param_decodes_transparently():
    img = _img(bits=12, h=40, w=56)
    for kw, brand in (({"container": "jp2"}, b"jp2 "),
                      ({"container": "jph", "htj2k": True}, b"jph ")):
        wrapped = _encode(img, 12, **kw)
        assert wrapped.startswith(j2k._JP2_SIGNATURE)
        assert dict(_boxes(wrapped))[b"ftyp"][:4] == brand
        out = np.squeeze(J2KDecoder().decode(wrapped)[0])
        np.testing.assert_array_equal(out, img)


@pytest.mark.parametrize("bits,comps", [(8, 1), (8, 3), (12, 1)])
def test_pil_oracle_reads_our_jp2_files(bits, comps):
    PIL_Image = pytest.importorskip("PIL.Image")
    img = _img(bits=bits, comps=comps, h=64, w=64)
    wrapped = _encode(img, bits, comps=comps, container="jp2")
    pil = np.array(PIL_Image.open(io.BytesIO(wrapped)))
    if bits > 8:
        pil = pil.astype(np.int64) >> (16 - bits)  # PIL container shift
    np.testing.assert_array_equal(np.squeeze(pil), np.squeeze(img))


def test_unwrap_hostile_boxes_never_crash():
    """Truncations and bit flips over a wrapped file either unwrap to
    SOMETHING or raise CorruptStreamError — never crash or hang."""
    rng = np.random.default_rng(11)
    wrapped = bytearray(j2k.wrap_jp2(_encode(_img(h=16, w=16), 8)))
    for cut in range(0, len(wrapped), 7):
        try:
            j2k.unwrap_jp2(bytes(wrapped[:cut]))
        except CorruptStreamError:
            pass
    for _ in range(300):
        m = bytes(wrapped[:12]) + bytes(
            rng.integers(0, 256, rng.integers(0, 96), dtype=np.uint8))
        try:
            j2k.unwrap_jp2(m)
        except CorruptStreamError:
            pass
    # XLBox (lbox=1 + 64-bit length) wrapping the jp2c payload
    cs = _encode(_img(h=16, w=16), 8)
    xl = (j2k._JP2_SIGNATURE
          + struct.pack(">I", 1) + b"jp2c" + struct.pack(">Q", 16 + len(cs))
          + cs)
    assert j2k.unwrap_jp2(xl) == cs
    # hostile XLBox lengths
    for q in (0, 15, 2**63, len(xl) + 1):
        bad = (j2k._JP2_SIGNATURE
               + struct.pack(">I", 1) + b"jp2c" + struct.pack(">Q", q) + cs)
        try:
            j2k.unwrap_jp2(bad)
        except CorruptStreamError:
            pass


def test_decoder_rejects_wrapped_garbage_codestream():
    # a well-formed container around a non-codestream payload must
    # surface the CODESTREAM error (missing SOC), not a box error
    wrapped = j2k.wrap_jp2(_encode(_img(h=16, w=16), 8))
    cs = j2k.unwrap_jp2(wrapped)
    garbage = wrapped.replace(cs, b"\x00" * len(cs))
    with pytest.raises(CorruptStreamError, match="SOC"):
        J2KDecoder().decode(garbage)


def test_container_param_validated_before_encoding():
    with pytest.raises(ValueError, match="container"):
        J2KEncoder(J2KEncodeParams(container="jpx")).encode(
            _img(h=16, w=16), 16, 16, 1, 8)


def test_pipelined_encoder_honors_container():
    from go_dicom_codec_jax.pipeline import encode_frames_pipelined
    imgs = np.stack([(_img(8, h=32, w=32, seed=s)).astype(np.int32)
                     for s in range(3)])
    p = J2KEncodeParams(container="jp2")
    streams = encode_frames_pipelined(imgs, params=p, bit_depth=8)
    scalar = J2KEncoder(p)
    for s, im in zip(streams, imgs):
        assert s.startswith(j2k._JP2_SIGNATURE)
        assert s == scalar.encode(im, 32, 32, 1, 8)


def test_batched_decoders_unwrap_transparently():
    from go_dicom_codec_jax.pipeline import decode_frames_pipelined
    imgs = [(_img(8, h=32, w=32, seed=s)).astype(np.int32)
            for s in range(3)]
    enc = J2KEncoder(J2KEncodeParams(container="jp2"))
    streams = [enc.encode(im, 32, 32, 1, 8) for im in imgs]
    for out, im in zip(decode_frames_pipelined(streams), imgs):
        np.testing.assert_array_equal(np.squeeze(np.asarray(out)), im)


def test_pil_oracle_reads_our_jph_file():
    PIL_Image = pytest.importorskip("PIL.Image")
    img = _img(bits=8, h=64, w=64)
    wrapped = _encode(img, 8, htj2k=True, container="jph")
    try:
        pil = np.array(PIL_Image.open(io.BytesIO(wrapped)))
    except Exception:
        pytest.skip("PIL/OpenJPEG build rejects the jph brand")
    np.testing.assert_array_equal(np.squeeze(pil), img)
