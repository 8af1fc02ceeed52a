"""JPEG Baseline: DCT exactness, Huffman tables, roundtrip quality matrix.

Mirrors the reference's baseline coverage (jpeg/baseline/*_test.go,
external_codec_test.go): gray + RGB roundtrips at several qualities with
bounded error, header structure, optimal-Huffman validity, odd sizes.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from go_dicom_codec_jax import MemoryPixelData, get_global_registry, uids
from go_dicom_codec_jax.codecs.jpeg_baseline import decode, encode
from go_dicom_codec_jax.codecs import jpeg_common as jc
from go_dicom_codec_jax.entropy import huffman as hf
from go_dicom_codec_jax.frames import FrameInfo
from go_dicom_codec_jax.ops.dct8x8 import (rgb_to_ycbcr, ycbcr_to_rgb,
                                           zigzag_scan, inv_zigzag_scan)


def _smooth_image(rng, h, w, c=1, amp=255):
    """Smooth random field (JPEG-friendly) in [0, amp]."""
    small = rng.random((h // 8 + 2, w // 8 + 2, c))
    ys = np.linspace(0, small.shape[0] - 1.001, h)
    xs = np.linspace(0, small.shape[1] - 1.001, w)
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    a = small[y0][:, x0]
    b = small[y0][:, x0 + 1]
    cc = small[y0 + 1][:, x0]
    d = small[y0 + 1][:, x0 + 1]
    out = a * (1 - fy) * (1 - fx) + b * (1 - fy) * fx + cc * fy * (1 - fx) + d * fy * fx
    return np.round(out * amp).astype(np.uint8).squeeze(-1) if c == 1 else \
        np.round(out * amp).astype(np.uint8)


# ---- primitives -------------------------------------------------------------

def test_zigzag_roundtrip(rng):
    x = rng.integers(-100, 100, size=(5, 8, 8)).astype(np.int32)
    zz = zigzag_scan(jnp.asarray(x))
    back = np.asarray(inv_zigzag_scan(zz))
    np.testing.assert_array_equal(back, x)
    # spot-check the scan order start (T.81 fig A.6)
    flat = np.asarray(zz)[0]
    assert flat[0] == x[0, 0, 0]
    assert flat[1] == x[0, 0, 1]
    assert flat[2] == x[0, 1, 0]
    assert flat[3] == x[0, 2, 0]


def test_ycbcr_fixed_point_roundtrip(rng):
    rgb = rng.integers(0, 256, size=(1, 16, 16, 3), dtype=np.uint8)
    ycc = rgb_to_ycbcr(jnp.asarray(rgb))
    back = np.asarray(ycbcr_to_rgb(ycc)).astype(np.int32)
    assert np.abs(back - rgb.astype(np.int32)).max() <= 3


def test_quality_scaling_curve():
    t50 = jc.scale_quant_table(jc.LUMA_QUANT, 50)
    np.testing.assert_array_equal(t50, jc.LUMA_QUANT)
    t100 = jc.scale_quant_table(jc.LUMA_QUANT, 100)
    assert t100.max() == 1
    t1 = jc.scale_quant_table(jc.LUMA_QUANT, 1)
    assert t1.max() == 255 and t1.min() >= 1
    # quality 25 → scale 200
    np.testing.assert_array_equal(
        jc.scale_quant_table(jc.LUMA_QUANT, 25),
        np.clip((jc.LUMA_QUANT.astype(np.int64) * 200 + 50) // 100, 1, 255))


def test_optimal_huffman_valid(rng):
    freq = np.zeros(256, dtype=np.int64)
    freq[:12] = rng.integers(1, 1000, size=12)
    t = hf.build_optimal_table(freq)
    assert sum(t.bits) == 12
    # Kraft inequality (strict: all-ones code reserved)
    kraft = sum(n / (1 << (i + 1)) for i, n in enumerate(t.bits))
    assert kraft < 1.0
    # all symbols get codes, decodable via LUT
    lens = t.len_of[np.nonzero(freq)[0]]
    assert (lens > 0).all() and lens.max() <= 16


def test_huffman_code_stream_roundtrip(rng):
    """Encode symbols with a table, decode with BitReader+LUT."""
    from go_dicom_codec_jax.utils.npbits import BitReader, pack_bits_msb

    t = hf.DC_LUMA
    syms = rng.integers(0, 12, size=500)
    vals = t.code_of[syms]
    lens = t.len_of[syms]
    packed = pack_bits_msb(vals, lens)
    br = BitReader(packed)
    got = [t.decode(br) for _ in range(500)]
    np.testing.assert_array_equal(got, syms)


# ---- end-to-end -------------------------------------------------------------

@pytest.mark.parametrize("size", [(64, 64), (61, 67), (8, 8), (128, 96)])
@pytest.mark.parametrize("quality", [50, 90, 100])
def test_gray_roundtrip(size, quality, rng):
    h, w = size
    img = _smooth_image(rng, h, w)
    data = encode(img.tobytes(), w, h, 1, quality)
    assert data[:2] == b"\xff\xd8" and data[-2:] == b"\xff\xd9"
    out, ow, oh, oc = decode(data)
    assert (ow, oh, oc) == (w, h, 1)
    got = np.frombuffer(out, dtype=np.uint8).reshape(h, w)
    err = np.abs(got.astype(int) - img.astype(int))
    # smooth content: high quality ≈ near-lossless
    tol = {100: 4, 90: 12, 50: 30}[quality]
    assert err.max() <= tol, f"max err {err.max()} at q{quality}"


@pytest.mark.parametrize("quality", [75, 95])
def test_rgb_roundtrip(quality, rng):
    h, w = 48, 56
    img = _smooth_image(rng, h, w, c=3)
    data = encode(img.tobytes(), w, h, 3, quality)
    out, ow, oh, oc = decode(data)
    assert (ow, oh, oc) == (w, h, 3)
    got = np.frombuffer(out, dtype=np.uint8).reshape(h, w, 3)
    err = np.abs(got.astype(int) - img.astype(int))
    assert err.max() <= 40
    assert err.mean() <= 6


def test_flat_image_compresses_tiny():
    img = np.full((64, 64), 128, dtype=np.uint8)
    data = encode(img.tobytes(), 64, 64, 1, 90)
    assert len(data) < 400
    out, _, _, _ = decode(data)
    got = np.frombuffer(out, dtype=np.uint8)
    assert np.abs(got.astype(int) - 128).max() <= 1


def test_registry_roundtrip(rng):
    info = FrameInfo(width=40, height=32, bits_allocated=8, samples_per_pixel=3,
                     photometric_interpretation="RGB")
    codec = get_global_registry().get_codec(uids.JPEG_BASELINE_8BIT)
    src = MemoryPixelData(info=info)
    img = _smooth_image(rng, 32, 40, c=3)
    src.add_frame(img.tobytes())
    enc = MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc, codec.get_default_parameters().with_quality(95))
    dec = MemoryPixelData(info=info)
    codec.decode(enc, dec)
    got = np.frombuffer(dec.get_frame(0), dtype=np.uint8).reshape(32, 40, 3)
    assert np.abs(got.astype(int) - img.astype(int)).mean() < 8


def test_rejects_16bit():
    info = FrameInfo(width=8, height=8, bits_allocated=16)
    codec = get_global_registry().get_codec(uids.JPEG_BASELINE_8BIT)
    src = MemoryPixelData(info=info)
    src.add_frame(bytes(128))
    from go_dicom_codec_jax.errors import UnsupportedFormatError
    with pytest.raises(UnsupportedFormatError):
        codec.encode(src, MemoryPixelData(info=info))


def test_decoder_rejects_garbage():
    from go_dicom_codec_jax.errors import CodecError
    with pytest.raises(CodecError):
        decode(b"\x00\x01\x02")
    with pytest.raises(CodecError):
        decode(b"\xff\xd8\xff\xd9")  # SOI+EOI, no frame


def test_multiframe_adapter_and_jpeg_pipeline_agree(rng):
    """The batched JPEG pipeline (device path) and the per-frame adapter
    both decode to within quantizer tolerance of the source; pipeline
    streams equal per-frame streams encoded with the device DCT."""
    import go_dicom_codec_jax as dc
    from go_dicom_codec_jax.pipeline import encode_frames_pipelined_jpeg

    frames = np.stack([
        np.clip(np.cumsum(rng.integers(-5, 6, (48, 64)), axis=1) + 100,
                0, 255).astype(np.uint8)
        for _ in range(3)])
    info = dc.FrameInfo(width=64, height=48, bits_allocated=8,
                        bits_stored=8)
    src = dc.MemoryPixelData(info=info)
    for fr in frames:
        src.add_frame(fr.tobytes())
    codec = dc.get_global_registry().get_codec(dc.uids.JPEG_BASELINE_8BIT)
    enc = dc.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc)         # CPU backend in tests → per-frame path
    assert enc.frame_count() == 3
    piped = encode_frames_pipelined_jpeg(frames, quality=90)
    assert len(piped) == 3
    dec = dc.MemoryPixelData(info=info)
    codec.decode(enc, dec)
    for k in range(3):
        got = np.frombuffer(dec.get_frame(k), np.uint8).reshape(48, 64)
        assert np.abs(got.astype(int)
                      - frames[k].astype(int)).max() <= 32
        # pipeline stream decodes to the same tolerance
        px, w, h, c = decode(piped[k])
        got2 = np.frombuffer(px, np.uint8).reshape(48, 64)
        assert np.abs(got2.astype(int)
                      - frames[k].astype(int)).max() <= 32


def test_multiframe_extended12_adapter(rng):
    import go_dicom_codec_jax as dc

    frames = [np.clip(np.cumsum(rng.integers(-40, 41, (32, 40)), axis=1)
                      + 2000, 0, 4095).astype("<u2") for _ in range(2)]
    info = dc.FrameInfo(width=40, height=32, bits_allocated=16,
                        bits_stored=12)
    src = dc.MemoryPixelData(info=info)
    for fr in frames:
        src.add_frame(fr.tobytes())
    codec = dc.get_global_registry().get_codec(dc.uids.JPEG_EXTENDED_12BIT)
    enc = dc.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc)
    dec = dc.MemoryPixelData(info=info)
    codec.decode(enc, dec)
    for k in range(2):
        got = np.frombuffer(dec.get_frame(k), "<u2").reshape(32, 40)
        assert np.abs(got.astype(int)
                      - frames[k].astype(int)).max() <= 128


def test_fancy_upsample_440_replicates_like_libjpeg(rng):
    """Regression (round-3 review): libjpeg only fancy-filters h2v1 and
    h2v2 (jinit_upsampler); 4:4:0 (fh=1, fv=2) and any other factor get
    int_upsample — plain replication. The triangular vertical filter we
    applied for fh=1/fv=2 broke the claimed oracle parity."""
    from go_dicom_codec_jax.codecs.jpeg_common import fancy_upsample

    plane = rng.integers(0, 256, (5, 8)).astype(np.int32)
    out = fancy_upsample(plane, 1, 2, 10, 8)
    np.testing.assert_array_equal(out, np.repeat(plane, 2, axis=0))
    # generic factors (e.g. 4x) also replicate
    out = fancy_upsample(plane, 4, 4, 20, 32)
    np.testing.assert_array_equal(
        out, np.repeat(np.repeat(plane, 4, axis=0), 4, axis=1))
    # the fancy 2x cases keep triangular filtering (not replication)
    grad = np.arange(64, dtype=np.int32).reshape(4, 16) * 4
    assert not np.array_equal(fancy_upsample(grad, 2, 2, 8, 32),
                              np.repeat(np.repeat(grad, 2, 0), 2, 1))
