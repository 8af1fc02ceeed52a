"""JPEG 2000 lossless vertical slice: geometry, T2, full roundtrips.

Mirrors reference coverage: jpeg2000/roundtrip_test.go, precinct/tagtree
tests, size_boundary_test.go, progression orders, multi-tile.
"""

import numpy as np
import pytest

from go_dicom_codec_jax.codecs.j2k_geometry import (band_rect,
                                                    build_tile_geometry,
                                                    packed_band_layout,
                                                    resolution_rect)
from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder, J2KEncodeParams,
                                                J2KEncoder, decode_to_pixels)
from go_dicom_codec_jax.codestream import j2k
from go_dicom_codec_jax.t2.bitio import BioReader, BioWriter
from go_dicom_codec_jax.t2.tagtree import TagTree


# ---- bit IO & tag trees ----------------------------------------------------

def test_bio_stuffing_roundtrip(rng):
    bits = rng.integers(0, 2, size=300).tolist()
    # force some 0xFF bytes: long runs of ones
    bits[:40] = [1] * 40
    bw = BioWriter()
    for b in bits:
        bw.write_bit(b)
    data = bw.flush()
    br = BioReader(data)
    got = [br.read_bit() for _ in bits]
    assert got == bits


def test_tagtree_roundtrip(rng):
    for (w, h) in [(1, 1), (3, 2), (4, 4), (7, 5)]:
        vals = rng.integers(0, 6, size=(h, w))
        enc = TagTree(w, h)
        for y in range(h):
            for x in range(w):
                enc.set_value(x, y, int(vals[y, x]))
        bw = BioWriter()
        order = [(x, y) for y in range(h) for x in range(w)]
        for (x, y) in order:
            enc.encode(bw, x, y, 999)
        data = bw.flush()
        dec = TagTree(w, h)
        br = BioReader(data)
        for (x, y) in order:
            thr = 1
            while dec.decode(br, x, y, thr) >= thr:
                thr += 1
            assert dec.decode(br, x, y, thr) == vals[y, x]


# ---- geometry --------------------------------------------------------------

def test_resolution_and_band_rects():
    # 64x64 tile, 2 levels
    assert resolution_rect(0, 0, 64, 64, 2, 2) == (0, 0, 64, 64)
    assert resolution_rect(0, 0, 64, 64, 2, 1) == (0, 0, 32, 32)
    assert resolution_rect(0, 0, 64, 64, 2, 0) == (0, 0, 16, 16)
    assert band_rect(0, 0, 64, 64, 2, 0, 0) == (0, 0, 16, 16)
    assert band_rect(0, 0, 64, 64, 2, 2, 1) == (0, 0, 32, 32)  # HL res 2


@pytest.mark.parametrize("rect,levels", [
    ((0, 0, 64, 64), 3), ((0, 0, 127, 129), 4), ((3, 5, 61, 67), 2),
    ((17, 9, 33, 20), 3), ((0, 0, 8, 8), 1),
])
def test_packed_layout_consistency(rect, levels):
    tx0, ty0, tx1, ty1 = rect
    bands = packed_band_layout(tx0, ty0, tx1, ty1, levels)
    # every sample of the tile is covered exactly once
    total = sum(b.width * b.height for b in bands)
    assert total == (tx1 - tx0) * (ty1 - ty0)


def test_geometry_codeblocks_cover_band():
    res = build_tile_geometry(0, 0, 200, 130, 3, 64, 64, lambda r: (15, 15))
    for rg in res:
        for prec in rg.precincts:
            for pb in prec.bands:
                area = sum(b.width * b.height for b in pb.blocks)
                bg = pb.band
                assert area == bg.width * bg.height


# ---- end-to-end lossless roundtrips ---------------------------------------

def _roundtrip(img, components=1, bit_depth=16, signed=False, **kw):
    h, w = img.shape[:2]
    enc = J2KEncoder(J2KEncodeParams(**kw))
    data = enc.encode(img.tobytes(), w, h, components, bit_depth, signed)
    pix, ow, oh, oc, depth, osigned = decode_to_pixels(data)
    assert (ow, oh, oc, depth, osigned) == (w, h, components, bit_depth,
                                            signed)
    assert pix == img.tobytes()
    return data


@pytest.mark.parametrize("size", [(32, 32), (64, 64), (33, 29), (13, 7)])
def test_gray16_lossless(size, rng):
    h, w = size
    img = rng.integers(0, 1 << 12, size=(h, w)).astype("<u2")
    data = _roundtrip(img, num_levels=3)
    assert data[:2] == b"\xff\x4f" and data[-2:] == b"\xff\xd9"


def test_gray8_lossless(rng):
    img = rng.integers(0, 256, size=(40, 56)).astype(np.uint8)
    _roundtrip(img, bit_depth=8, num_levels=5)


def test_signed16_lossless(rng):
    img = rng.integers(-2048, 2048, size=(32, 32)).astype("<i2")
    _roundtrip(img, bit_depth=12, signed=True, num_levels=2)


def test_rgb_rct_lossless(rng):
    img = rng.integers(0, 256, size=(32, 48, 3)).astype(np.uint8)
    _roundtrip(img, components=3, bit_depth=8, num_levels=3)


def test_smooth_compresses(rng):
    base = np.cumsum(rng.integers(-4, 5, size=(64, 64)), axis=1)
    img = (base - base.min()).astype("<u2")
    data = _roundtrip(img, num_levels=5)
    assert len(data) < img.nbytes  # beats raw


def test_multitile_lossless(rng):
    img = rng.integers(0, 1 << 10, size=(70, 90)).astype("<u2")
    data = _roundtrip(img, num_levels=2, tile_width=32, tile_height=48)
    cs = j2k.parse_codestream(data)
    assert len(cs.tiles) == 6  # 3x2 tile grid


@pytest.mark.parametrize("prog", [0, 1, 2, 3, 4])
def test_progression_orders(prog, rng):
    img = rng.integers(0, 4096, size=(48, 48)).astype("<u2")
    _roundtrip(img, bit_depth=12, num_levels=2, progression=prog)


@pytest.mark.parametrize("style", [0x04, 0x01, 0x05, 0x02, 0x20])
def test_codeblock_styles(style, rng):
    """TERMALL / LAZY / both / RESET / SEGSYM survive T2 roundtrip."""
    img = rng.integers(0, 4096, size=(40, 40)).astype("<u2")
    _roundtrip(img, bit_depth=12, num_levels=2, cb_style=style)


def test_small_codeblocks(rng):
    img = rng.integers(0, 1 << 10, size=(40, 40)).astype("<u2")
    _roundtrip(img, num_levels=2, cb_width=16, cb_height=16)


def test_custom_precincts(rng):
    img = rng.integers(0, 1 << 10, size=(64, 64)).astype("<u2")
    _roundtrip(img, num_levels=2, cb_width=32, cb_height=32,
               precincts=[(6, 6), (6, 6), (6, 6)])


def test_extreme_values(rng):
    img = np.zeros((16, 16), dtype="<u2")
    img[0, 0] = 0xFFFF
    img[15, 15] = 1
    img[7, 8] = 0x8000
    _roundtrip(img, num_levels=2)


def test_all_zero_image():
    img = np.zeros((32, 32), dtype="<u2")
    data = _roundtrip(img, num_levels=3)
    assert len(data) < 400


def test_decoder_rejects_garbage():
    with pytest.raises(Exception):
        J2KDecoder().decode(b"\x00" * 40)
    with pytest.raises(Exception):
        J2KDecoder().decode(b"\xff\x4f\xff\xd9")


def test_decode_frames_pipelined_bit_identical(rng):
    """The batched decode pipeline (host T1 overlapped with device
    inverse stage) reproduces the scalar decoder bit-for-bit, gray and
    RGB-RCT."""
    from go_dicom_codec_jax.pipeline import (decode_frames_pipelined,
                                             encode_frames_pipelined)

    frames = (np.cumsum(rng.integers(-9, 10, (5, 48, 40)), axis=2)
              % 4096).astype(np.int32)
    streams = encode_frames_pipelined(frames, bit_depth=12, levels=3)
    got = decode_frames_pipelined(streams, chunk=2)
    assert len(got) == 5
    for k, s in enumerate(streams):
        arr, _, _ = J2KDecoder().decode(s)
        np.testing.assert_array_equal(got[k], arr)

    rgb = rng.integers(0, 256, (4, 32, 32, 3)).astype(np.uint8)
    streams = encode_frames_pipelined(rgb, bit_depth=8, levels=2)
    got = decode_frames_pipelined(streams, chunk=3)
    for k, s in enumerate(streams):
        arr, _, _ = J2KDecoder().decode(s)
        np.testing.assert_array_equal(got[k], arr)

    # ROI streams (both styles) carry through the batched pipeline:
    # the unshift happens on the packed host coefficients
    from go_dicom_codec_jax.codecs.j2k_roi import ROIRegion
    from go_dicom_codec_jax.codecs.jpeg2000 import (J2KEncodeParams,
                                                    J2KEncoder)
    for style in ("maxshift", "general"):
        enc = J2KEncoder(J2KEncodeParams(
            num_levels=3, cb_style=0, roi_style=style,
            roi_regions=[ROIRegion(shape="rect", rect=(8, 8, 24, 24))]))
        streams = [enc.encode(frames[i], 40, 48, 1, 12)
                   for i in range(3)]
        got = decode_frames_pipelined(streams, chunk=2)
        for k, s in enumerate(streams):
            arr, _, _ = J2KDecoder().decode(s)
            np.testing.assert_array_equal(got[k], arr, err_msg=style)


def test_adapter_multiframe_decode_batched(rng):
    """Multi-frame .90 decode takes the batched pipeline and matches the
    per-frame scalar output byte for byte (incl. 16-bit container
    widening)."""
    import go_dicom_codec_jax as dc

    frames = (np.cumsum(rng.integers(-9, 10, (4, 40, 40)), axis=2)
              % 4096).astype("<u2")
    info = dc.FrameInfo(width=40, height=40, bits_allocated=16,
                        bits_stored=12)
    codec = dc.get_global_registry().get_codec(dc.uids.JPEG_2000_LOSSLESS)
    src = dc.MemoryPixelData(info=info)
    for f in frames:
        src.add_frame(f.tobytes())
    enc = dc.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc)
    dec = dc.MemoryPixelData(info=info)
    codec.decode(enc, dec)
    for i in range(4):
        assert dec.get_frame(i) == src.get_frame(i)

    # scalar single-frame path must agree with each batched frame
    for i in range(4):
        one = dc.MemoryPixelData(info=info, encapsulated=True)
        one.add_frame(enc.get_frame(i))
        d1 = dc.MemoryPixelData(info=info)
        codec.decode(one, d1)
        assert d1.get_frame(0) == dec.get_frame(i)


def test_adapter_multiframe_decode_fallback_classes(rng):
    """Review-found: stream classes the batched decode can't handle must
    fall back to the scalar path and still decode exactly — custom
    Part-2 MCT, General-Scaling ROI, and mixed-geometry frame sets."""
    import go_dicom_codec_jax as dc
    from go_dicom_codec_jax.codecs.j2k_roi import ROIRegion

    reg = dc.get_global_registry()

    # (a) .92 with a custom MCT matrix carried in MCT/MCC markers
    rgb = rng.integers(0, 256, (3, 32, 32, 3)).astype(np.uint8)
    info = dc.FrameInfo(width=32, height=32, bits_allocated=8,
                        bits_stored=8, samples_per_pixel=3,
                        photometric_interpretation="RGB")
    codec = reg.get_codec(dc.uids.JPEG_2000_MC_LOSSLESS)
    m = [[0.5, 0.25, 0.25], [0.25, 0.5, 0.25], [0.25, 0.25, 0.5]]
    minv = np.linalg.inv(np.asarray(m)).tolist()
    src = dc.MemoryPixelData(info=info)
    for f in rgb:
        src.add_frame(f.tobytes())
    enc = dc.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc, dc.Parameters(mct_matrix=m, mct_inverse=minv))
    dec = dc.MemoryPixelData(info=info)
    codec.decode(enc, dec)
    for i in range(3):
        one = dc.MemoryPixelData(info=info, encapsulated=True)
        one.add_frame(enc.get_frame(i))
        d1 = dc.MemoryPixelData(info=info)
        codec.decode(one, d1)
        assert dec.get_frame(i) == d1.get_frame(0)

    # (b) General-Scaling ROI (Srgn=1 + COM geometry)
    gray = (np.cumsum(rng.integers(-9, 10, (3, 48, 48)), axis=2)
            % 4096).astype("<u2")
    ginfo = dc.FrameInfo(width=48, height=48, bits_allocated=16,
                         bits_stored=12)
    gcodec = reg.get_codec(dc.uids.JPEG_2000_LOSSLESS)
    gsrc = dc.MemoryPixelData(info=ginfo)
    for f in gray:
        gsrc.add_frame(f.tobytes())
    genc = dc.MemoryPixelData(info=ginfo, encapsulated=True)
    gcodec.encode(gsrc, genc, dc.Parameters(
        roi_regions=[ROIRegion(shape="rect", rect=(8, 8, 16, 16))],
        roi_style="general"))
    gdec = dc.MemoryPixelData(info=ginfo)
    gcodec.decode(genc, gdec)
    for i in range(3):
        assert gdec.get_frame(i) == gsrc.get_frame(i)

    # (c) mixed geometry across frames: pipeline must refuse, adapter
    # falls back and decodes each frame correctly
    from go_dicom_codec_jax.codecs.jpeg2000 import (J2KEncodeParams,
                                                    J2KEncoder)
    from go_dicom_codec_jax.pipeline import decode_frames_pipelined

    a = (rng.integers(0, 256, (16, 16))).astype(np.uint8)
    b = (rng.integers(0, 4096, (16, 16))).astype("<u2")
    s1 = J2KEncoder(J2KEncodeParams(num_levels=2)).encode(
        a.tobytes(), 16, 16, 1, 8, False)
    s2 = J2KEncoder(J2KEncodeParams(num_levels=2)).encode(
        b.tobytes(), 16, 16, 1, 12, False)
    with pytest.raises(ValueError):
        decode_frames_pipelined([s1, s2], chunk=1)


def test_pipeline_host_strategy_identical(rng):
    """device='host' (the slow-transfer auto choice) produces the same
    codestreams and pixels as the device path."""
    from go_dicom_codec_jax.pipeline import (decode_frames_pipelined,
                                             encode_frames_pipelined)

    frames = (np.cumsum(rng.integers(-9, 10, (5, 64, 48)), axis=2)
              % 4096).astype(np.int32)
    via_dev = encode_frames_pipelined(frames, bit_depth=12, levels=3,
                                      device="device")
    via_host = encode_frames_pipelined(frames, bit_depth=12, levels=3,
                                       device="host")
    assert via_dev == via_host
    px_dev = decode_frames_pipelined(via_dev, device="device")
    px_host = decode_frames_pipelined(via_dev, device="host")
    for a, b in zip(px_dev, px_host):
        np.testing.assert_array_equal(a, b)


def test_pipeline_host_strategy_rgb(rng):
    from go_dicom_codec_jax.pipeline import (decode_frames_pipelined,
                                             encode_frames_pipelined)

    rgb = (np.cumsum(rng.integers(-5, 6, (3, 32, 40, 3)), axis=2)
           % 256).astype(np.int32)
    via_dev = encode_frames_pipelined(rgb, bit_depth=8, levels=2,
                                      device="device")
    via_host = encode_frames_pipelined(rgb, bit_depth=8, levels=2,
                                       device="host")
    assert via_dev == via_host
    px_host = decode_frames_pipelined(via_host, device="host")
    for k in range(3):
        np.testing.assert_array_equal(
            px_host[k].astype(np.int64),
            rgb[k].astype(np.int64))
