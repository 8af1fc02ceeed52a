"""RLE pixel-layout parity matrix + multi-frame adapter sweeps.

Role of reference rle/parity_test.go:10-56 (8/16-bit mono, RGB
interleaved+planar layout matrix) widened to 32-bit containers, odd
widths, and a frame-loop sweep over every registered lossless codec
(the reference's per-codec frame loops, rle/rle.go:44-57 pattern).
"""

import numpy as np
import pytest

import go_dicom_codec_jax as dc
from go_dicom_codec_jax.codecs.rle import decode_frame, encode_frame


@pytest.mark.parametrize("bits_allocated", [8, 16, 32])
@pytest.mark.parametrize("samples", [1, 3])
@pytest.mark.parametrize("width", [64, 63])
def test_rle_layout_matrix(bits_allocated, samples, width, rng):
    h = 40
    dt = {8: np.uint8, 16: np.dtype("<u2"), 32: np.dtype("<u4")}[
        bits_allocated]
    img = rng.integers(0, 1 << min(bits_allocated, 31),
                       (h, width, samples)).astype(dt)
    info = dc.FrameInfo(width=width, height=h,
                        bits_allocated=bits_allocated,
                        bits_stored=bits_allocated,
                        samples_per_pixel=samples)
    stream = encode_frame(np.ascontiguousarray(img).tobytes(), info)
    # segment count: one per sample-byte plane (Annex G, <= 15)
    nseg = int.from_bytes(stream[:4], "little")
    assert nseg == samples * (bits_allocated // 8) <= 15
    back = decode_frame(stream, info)
    assert back == np.ascontiguousarray(img).tobytes()


def test_rle_planar_configuration_roundtrip(rng):
    """Planar RGB (PlanarConfiguration=1) frames roundtrip through the
    registry adapter."""
    img = rng.integers(0, 255, (3, 32, 48)).astype(np.uint8)  # planar
    info = dc.FrameInfo(width=48, height=32, bits_allocated=8,
                        bits_stored=8, samples_per_pixel=3,
                        planar_configuration=1,
                        photometric_interpretation="RGB")
    src = dc.MemoryPixelData(info=info)
    src.add_frame(img.tobytes())
    codec = dc.get_global_registry().get_codec(dc.uids.RLE_LOSSLESS)
    enc = dc.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc)
    dec = dc.MemoryPixelData(info=info)
    codec.decode(enc, dec)
    assert dec.get_frame(0) == src.get_frame(0)


def test_rle_segment_offsets_header(rng):
    """64-byte little-endian segment offset header (Annex G.5)."""
    img = rng.integers(0, 65535, (16, 16)).astype("<u2")
    info = dc.FrameInfo(width=16, height=16, bits_allocated=16,
                        bits_stored=16)
    stream = encode_frame(img.tobytes(), info)
    nseg = int.from_bytes(stream[:4], "little")
    assert nseg == 2
    off1 = int.from_bytes(stream[4:8], "little")
    off2 = int.from_bytes(stream[8:12], "little")
    assert off1 == 64 and off2 > off1
    # unused offsets zeroed
    assert all(int.from_bytes(stream[4 + 4 * i:8 + 4 * i], "little") == 0
               for i in range(nseg, 15))


LOSSLESS_UIDS = [
    ("rle", "1.2.840.10008.1.2.5"),
    ("p14", "1.2.840.10008.1.2.4.57"),
    ("sv1", "1.2.840.10008.1.2.4.70"),
    ("jls", "1.2.840.10008.1.2.4.80"),
    ("j2k", "1.2.840.10008.1.2.4.90"),
    ("ht", "1.2.840.10008.1.2.4.201"),
]


@pytest.mark.parametrize("name,uid", LOSSLESS_UIDS,
                         ids=[n for n, _ in LOSSLESS_UIDS])
def test_multiframe_roundtrip(name, uid, rng):
    """Three distinct frames encode to three distinct streams and each
    decodes to its own pixels (the frame loop every adapter mirrors
    from the reference)."""
    frames = [rng.integers(0, 4095, (40, 32)).astype("<u2")
              for _ in range(3)]
    info = dc.FrameInfo(width=32, height=40, bits_allocated=16,
                        bits_stored=12)
    src = dc.MemoryPixelData(info=info)
    for fr in frames:
        src.add_frame(fr.tobytes())
    codec = dc.get_global_registry().get_codec(uid)
    enc = dc.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc)
    assert enc.frame_count() == 3
    assert len({enc.get_frame(i) for i in range(3)}) == 3
    dec = dc.MemoryPixelData(info=info)
    codec.decode(enc, dec)
    for i, fr in enumerate(frames):
        got = np.frombuffer(dec.get_frame(i), "<u2").reshape(40, 32)
        np.testing.assert_array_equal(got, fr)


def test_multiframe_empty_pixeldata():
    info = dc.FrameInfo(width=8, height=8, bits_allocated=8,
                        bits_stored=8)
    src = dc.MemoryPixelData(info=info)
    codec = dc.get_global_registry().get_codec(dc.uids.RLE_LOSSLESS)
    enc = dc.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc)
    assert enc.frame_count() == 0
