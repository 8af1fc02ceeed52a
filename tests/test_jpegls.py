"""JPEG-LS roundtrip matrix: lossless bit-exactness, NEAR error bound.

Mirrors reference coverage (jpegls/lossless/*_test.go,
nearlossless/near_all_test.go |err|<=NEAR sweep).
"""

import numpy as np
import pytest

from go_dicom_codec_jax import MemoryPixelData, get_global_registry, uids
from go_dicom_codec_jax.codecs.jpegls import Traits, decode, encode
from go_dicom_codec_jax.frames import FrameInfo


def test_traits_defaults_8bit():
    t = Traits(maxval=255, near=0)
    assert (t.t1, t.t2, t.t3) == (3, 7, 21)
    assert t.range == 256 and t.qbpp == 8 and t.limit == 32 and t.reset == 64


def test_traits_defaults_12bit():
    t = Traits(maxval=4095, near=0)
    assert t.qbpp == 12 and t.limit == 2 * (12 + 12)
    assert t.t1 > 3 and t.t3 > 21


@pytest.mark.parametrize("size", [(8, 8), (16, 16), (31, 17), (1, 64), (64, 1)])
def test_gray8_lossless_roundtrip(size, rng):
    h, w = size
    img = rng.integers(0, 256, size=(h, w)).astype(np.uint8)
    data = encode(img.tobytes(), w, h, 1, 8, 0)
    out, ow, oh, oc, depth, near = decode(data)
    assert (ow, oh, oc, depth, near) == (w, h, 1, 8, 0)
    assert out == img.tobytes()


def test_gray16_lossless_roundtrip(rng):
    img = rng.integers(0, 1 << 16, size=(32, 48)).astype("<u2")
    data = encode(img.tobytes(), 48, 32, 1, 16, 0)
    out, *_ = decode(data)
    assert out == img.tobytes()


def test_gray12_lossless_roundtrip(rng):
    img = rng.integers(0, 4096, size=(40, 24)).astype("<u2")
    data = encode(img.tobytes(), 24, 40, 1, 12, 0)
    out, *_ = decode(data)
    assert out == img.tobytes()


def test_rgb8_interleaved_roundtrip(rng):
    img = rng.integers(0, 256, size=(24, 16, 3)).astype(np.uint8)
    data = encode(img.tobytes(), 16, 24, 3, 8, 0)
    out, ow, oh, oc, _, _ = decode(data)
    assert (ow, oh, oc) == (16, 24, 3)
    assert out == img.tobytes()


def test_flat_image_run_mode(rng):
    """Constant image exercises run mode + end-of-line runs heavily."""
    img = np.full((64, 64), 77, dtype=np.uint8)
    data = encode(img.tobytes(), 64, 64, 1, 8, 0)
    assert len(data) < 120  # runs compress massively
    out, *_ = decode(data)
    assert out == img.tobytes()


def test_mostly_flat_with_edges(rng):
    img = np.full((32, 32), 100, dtype=np.uint8)
    img[8:12, 8:24] = 200
    img[20, :] = rng.integers(0, 256, size=32)
    data = encode(img.tobytes(), 32, 32, 1, 8, 0)
    out, *_ = decode(data)
    assert out == img.tobytes()


def test_smooth_compression_ratio(rng):
    """README claims ~4.17x on smooth gray8 (README.md:330)."""
    y, x = np.mgrid[0:64, 0:64]
    img = ((np.sin(x / 9.0) + np.cos(y / 7.0) + 2) * 60).astype(np.uint8)
    data = encode(img.tobytes(), 64, 64, 1, 8, 0)
    assert len(img.tobytes()) / len(data) > 2.5
    out, *_ = decode(data)
    assert out == img.tobytes()


@pytest.mark.parametrize("near", [1, 3, 7])
def test_near_lossless_error_bound(near, rng):
    """|reconstructed − original| ≤ NEAR (nearlossless/near_all_test.go)."""
    img = rng.integers(0, 256, size=(24, 24)).astype(np.uint8)
    data = encode(img.tobytes(), 24, 24, 1, 8, near)
    out, _, _, _, _, onear = decode(data)
    assert onear == near
    got = np.frombuffer(out, dtype=np.uint8).astype(int)
    err = np.abs(got - img.reshape(-1).astype(int))
    assert err.max() <= near
    # near-lossless should compress better than lossless
    lossless = encode(img.tobytes(), 24, 24, 1, 8, 0)
    assert len(data) < len(lossless)


def test_near_lossless_16bit(rng):
    img = rng.integers(0, 1 << 12, size=(16, 16)).astype("<u2")
    data = encode(img.tobytes(), 16, 16, 1, 12, 3)
    out, *_ = decode(data)
    got = np.frombuffer(out, dtype="<u2").astype(int)
    assert np.abs(got - img.reshape(-1).astype(int)).max() <= 3


def test_registry_lossless(rng):
    info = FrameInfo(width=32, height=20, bits_allocated=16, bits_stored=12)
    codec = get_global_registry().get_codec(uids.JPEG_LS_LOSSLESS)
    img = rng.integers(0, 4096, size=(20, 32)).astype("<u2")
    src = MemoryPixelData(info=info)
    src.add_frame(img.tobytes())
    enc = MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc)
    dec = MemoryPixelData(info=info)
    codec.decode(enc, dec)
    assert dec.get_frame(0) == src.get_frame(0)


def test_registry_near_lossless(rng):
    info = FrameInfo(width=24, height=24, bits_allocated=8)
    codec = get_global_registry().get_codec(uids.JPEG_LS_NEAR_LOSSLESS)
    img = rng.integers(0, 256, size=(24, 24)).astype(np.uint8)
    src = MemoryPixelData(info=info)
    src.add_frame(img.tobytes())
    enc = MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc, codec.get_default_parameters().with_near(3))
    dec = MemoryPixelData(info=info)
    codec.decode(enc, dec)
    got = np.frombuffer(dec.get_frame(0), dtype=np.uint8).astype(int)
    assert np.abs(got - img.reshape(-1).astype(int)).max() <= 3


def test_decoder_rejects_non_jls():
    from go_dicom_codec_jax.errors import CodecError
    with pytest.raises(CodecError):
        decode(b"\xff\xd8\xff\xc0\x00\x0b" + bytes(9))
