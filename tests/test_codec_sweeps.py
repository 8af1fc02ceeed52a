"""Deterministic size/parameter sweep matrices for the non-J2K codecs.

Role of the reference's per-codec test families (rle/*_test.go odd-width
and segment-count suites, jpeg/lossless predictor × size grids,
jpegls NEAR × ILV × bit-depth matrices, baseline restart-interval
tests): pin the boundary geometry as enumerated cases rather than fuzz.
"""

import numpy as np
import pytest

import go_dicom_codec_jax as dc

SIZES = [(1, 1), (1, 7), (7, 1), (2, 2), (3, 5), (8, 8), (9, 17),
         (16, 16), (31, 33), (64, 63)]


def _roundtrip(uid, arr, bits, samples=1, tol=0, params=None):
    h, w = arr.shape[:2]
    info = dc.FrameInfo(
        width=w, height=h, bits_allocated=8 if bits <= 8 else 16,
        bits_stored=bits, samples_per_pixel=samples,
        photometric_interpretation="RGB" if samples == 3 else "MONOCHROME2")
    codec = dc.get_global_registry().get_codec(uid)
    src = dc.MemoryPixelData(info=info)
    src.add_frame(np.ascontiguousarray(arr).tobytes())
    enc = dc.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc, dc.Parameters(**(params or {})))
    dec = dc.MemoryPixelData(info=info)
    codec.decode(enc, dec)
    got = np.frombuffer(dec.get_frame(0), dtype=arr.dtype)
    err = np.abs(got.astype(np.int64)
                 - arr.reshape(-1).astype(np.int64)).max()
    assert err <= tol, f"err={err} > {tol}"


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("bits", [8, 16])
def test_rle_size_sweep(size, bits, rng):
    h, w = size
    dt = np.uint8 if bits <= 8 else np.dtype("<u2")
    arr = rng.integers(0, 1 << bits, (h, w)).astype(dt)
    _roundtrip("1.2.840.10008.1.2.5", arr, bits)


@pytest.mark.parametrize("predictor", [1, 2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("size", [(1, 1), (1, 9), (9, 1), (3, 5),
                                  (16, 16), (31, 33)])
def test_p14_predictor_size_sweep(predictor, size, rng):
    h, w = size
    arr = rng.integers(0, 1 << 12, (h, w)).astype("<u2")
    _roundtrip("1.2.840.10008.1.2.4.57", arr, 12,
               params={"predictor": predictor})


@pytest.mark.parametrize("bits", [2, 4, 8, 12, 15, 16])
def test_p14_bit_depth_sweep(bits, rng):
    dt = np.uint8 if bits <= 8 else np.dtype("<u2")
    arr = rng.integers(0, 1 << bits, (16, 16)).astype(dt)
    _roundtrip("1.2.840.10008.1.2.4.57", arr, bits)


@pytest.mark.parametrize("near", [0, 1, 2, 3, 7, 15])
@pytest.mark.parametrize("size", [(1, 8), (8, 1), (5, 5), (16, 16),
                                  (33, 31)])
def test_jpegls_near_size_sweep(near, size, rng):
    h, w = size
    arr = rng.integers(0, 256, (h, w)).astype(np.uint8)
    uid = ("1.2.840.10008.1.2.4.80" if near == 0
           else "1.2.840.10008.1.2.4.81")
    _roundtrip(uid, arr, 8, tol=near, params={"near": near})


@pytest.mark.parametrize("bits", [8, 10, 12, 16])
def test_jpegls_bit_depth_sweep(bits, rng):
    dt = np.uint8 if bits <= 8 else np.dtype("<u2")
    arr = (np.cumsum(rng.integers(-5, 6, (24, 24)), axis=1)
           % (1 << bits)).astype(dt)
    _roundtrip("1.2.840.10008.1.2.4.80", arr, bits)


def test_jpegls_rgb_ilv(rng):
    arr = rng.integers(0, 256, (16, 16, 3)).astype(np.uint8)
    _roundtrip("1.2.840.10008.1.2.4.80", arr, 8, samples=3)


@pytest.mark.parametrize("size", [(8, 8), (9, 9), (17, 15), (24, 17),
                                  (64, 63)])
@pytest.mark.parametrize("quality", [10, 50, 95])
def test_baseline_size_quality_sweep(size, quality, rng):
    h, w = size
    arr = (np.cumsum(rng.integers(-3, 4, (h, w)), axis=1)
           % 200 + 20).astype(np.uint8)
    # error scales with the Annex-K table scaling at low quality
    tol = {10: 255, 50: 160, 95: 64}[quality]
    _roundtrip("1.2.840.10008.1.2.4.50", arr, 8, tol=tol,
               params={"quality": quality})


def test_baseline_restart_interval_roundtrip(rng):
    """Restart markers byte-align and reset DC predictors."""
    from go_dicom_codec_jax.codecs import jpeg_baseline as jb

    arr = (np.cumsum(rng.integers(-3, 4, (64, 64)), axis=1)
           % 200 + 20).astype(np.uint8)
    # encode() has no restart param at the codec surface — drive the
    # native scan coder's restart path through the decode of a stream
    # that contains DRI via PIL-produced JPEG if available
    PIL_Image = pytest.importorskip("PIL.Image")
    import io

    buf = io.BytesIO()
    PIL_Image.fromarray(arr).save(buf, format="JPEG", quality=90,
                                  restart_marker_blocks=4)
    pix, w, h, c = jb.decode(buf.getvalue())
    got = np.frombuffer(pix, np.uint8).reshape(64, 64)
    assert np.abs(got.astype(int) - arr.astype(int)).max() <= 24


@pytest.mark.parametrize("size", [(16, 16), (17, 15), (33, 31)])
def test_extended12_size_sweep(size, rng):
    h, w = size
    arr = (np.cumsum(rng.integers(-9, 10, (h, w)), axis=1)
           % 3800 + 100).astype("<u2")
    _roundtrip("1.2.840.10008.1.2.4.51", arr, 12, tol=64)
