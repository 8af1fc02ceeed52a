"""Multi-frame pipeline boundary behavior (VERDICT r3 #7 depth): chunk
edges, device/host forcing equivalence, RGB batches, and the JPEG
batched path — the configurations between the unit tests and the
benchmarks.
"""

import numpy as np
import pytest

from go_dicom_codec_jax.codecs.jpeg2000 import decode_to_pixels
from go_dicom_codec_jax.pipeline import (decode_frames_pipelined,
                                         encode_frames_pipelined)


def _frames(rng, n, h=48, w=40, bits=12):
    return (np.cumsum(rng.integers(-9, 10, (n, h, w)), axis=2)
            % (1 << bits)).astype(np.int32)


@pytest.mark.parametrize("n,chunk", [(1, 8), (3, 2), (8, 8), (9, 4)])
def test_pipeline_chunk_boundaries(n, chunk, rng):
    """Frame counts below/at/above the chunk size all roundtrip."""
    frames = _frames(rng, n)
    streams = encode_frames_pipelined(frames, bit_depth=12, levels=2,
                                      chunk=chunk)
    assert len(streams) == n
    for i, s in enumerate(streams):
        raw, w, h, c, d, sg = decode_to_pixels(s)
        got = np.frombuffer(raw, "<u2").reshape(48, 40)
        np.testing.assert_array_equal(got, frames[i])


def test_pipeline_host_device_byte_identical(rng):
    """Forcing device vs host transform engines yields the same bytes
    (the host-native 5/3 is bit-parity with the jit lane)."""
    frames = _frames(rng, 4)
    a = encode_frames_pipelined(frames, bit_depth=12, levels=2,
                                device="host")
    b = encode_frames_pipelined(frames, bit_depth=12, levels=2,
                                device="device")
    assert a == b


def test_pipeline_decode_matches_scalar(rng):
    frames = _frames(rng, 5)
    streams = encode_frames_pipelined(frames, bit_depth=12, levels=2)
    outs = decode_frames_pipelined(streams)
    for i, raw in enumerate(outs):
        got = np.asarray(raw).reshape(48, 40)
        np.testing.assert_array_equal(got.astype(np.int64), frames[i])


def test_pipeline_single_frame_degenerate(rng):
    frames = _frames(rng, 1, h=16, w=16)
    streams = encode_frames_pipelined(frames, bit_depth=12, levels=1)
    raw, *_ = decode_to_pixels(streams[0])
    np.testing.assert_array_equal(
        np.frombuffer(raw, "<u2").reshape(16, 16), frames[0])


def test_pipeline_8bit_frames(rng):
    frames = (rng.integers(0, 256, (3, 32, 32))).astype(np.int32)
    streams = encode_frames_pipelined(frames, bit_depth=8, levels=2)
    for i, s in enumerate(streams):
        raw, w, h, c, d, sg = decode_to_pixels(s)
        got = np.frombuffer(raw, np.uint8).reshape(32, 32)
        np.testing.assert_array_equal(got.astype(np.int32), frames[i])


def test_pipeline_nonsquare_odd_dims(rng):
    frames = _frames(rng, 2, h=33, w=47)
    streams = encode_frames_pipelined(frames, bit_depth=12, levels=3)
    for i, s in enumerate(streams):
        raw, w, h, c, d, sg = decode_to_pixels(s)
        got = np.frombuffer(raw, "<u2").reshape(33, 47)
        np.testing.assert_array_equal(got, frames[i])


def test_pipeline_jpeg_batched_matches_per_frame(rng):
    """The batched JPEG pipeline's streams equal the per-frame encoder's
    (the integer islow DCT is deterministic across lanes)."""
    from go_dicom_codec_jax.codecs.jpeg_baseline import encode
    from go_dicom_codec_jax.pipeline import encode_frames_pipelined_jpeg

    frames = rng.integers(0, 256, (5, 40, 48)).astype(np.uint8)
    batched = list(encode_frames_pipelined_jpeg(frames, quality=85))
    scalar = [encode(frames[i].tobytes(), 48, 40, 1, 85)
              for i in range(5)]
    assert batched == scalar


def test_pipeline_empty_batch():
    streams = encode_frames_pipelined(np.zeros((0, 16, 16), np.int32),
                                      bit_depth=12, levels=1)
    assert streams == []


def test_pipeline_decode_empty():
    assert decode_frames_pipelined([]) == []


@pytest.mark.parametrize("ncomp,lane", [(1, "device"), (1, "host"),
                                        (3, "device"), (3, "host")])
def test_pipeline_decode_lossy_matches_scalar(ncomp, lane, rng):
    """Round-4: the decode pipeline also carries irreversible streams
    (host per-band dequant + 9/7 inverse on either lane), within one
    rounding tie of the scalar decoder on every lane."""
    from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder,
                                                    J2KEncodeParams,
                                                    J2KEncoder)

    shape = (4, 48, 64) if ncomp == 1 else (4, 48, 64, 3)
    frames = (np.cumsum(rng.integers(-9, 10, shape), axis=2)
              % 256).astype(np.int32)
    enc = J2KEncoder(J2KEncodeParams(num_levels=3, lossless=False,
                                     quality=90))
    streams = [enc.encode(f, 64, 48, ncomp, 8) for f in frames]
    scalar = [J2KDecoder().decode(s)[0] for s in streams]
    got = decode_frames_pipelined(streams, device=lane)
    for g, s in zip(got, scalar):
        assert np.abs(g.astype(np.int64) - s.astype(np.int64)).max() <= 1


def test_pipeline_decode_rejects_mixed_transforms(rng):
    from go_dicom_codec_jax.codecs.jpeg2000 import (J2KEncodeParams,
                                                    J2KEncoder)

    img = rng.integers(0, 256, (32, 32)).astype(np.int32)
    s_ll = J2KEncoder(J2KEncodeParams(num_levels=2)).encode(
        img, 32, 32, 1, 8)
    s_ir = J2KEncoder(J2KEncodeParams(num_levels=2, lossless=False)
                      ).encode(img, 32, 32, 1, 8)
    with pytest.raises(ValueError):
        decode_frames_pipelined([s_ll, s_ir])


@pytest.mark.parametrize("lane", ["device", "host"])
def test_pipeline_decode_lossy_range_edges_no_wrap(lane, rng):
    """Regression: lossy reconstructions that overshoot the declared
    range (values at 0 / 4095) must clip, not wrap, through the 16-bit
    device readback (an unclipped -1 wrapped to 65535)."""
    from go_dicom_codec_jax.codecs.jpeg2000 import (J2KEncodeParams,
                                                    J2KEncoder)

    img = np.zeros((3, 64, 64), dtype=np.int32)
    img[:, ::2, ::2] = 4095        # harsh checkerboard → ringing
    enc = J2KEncoder(J2KEncodeParams(num_levels=3, lossless=False,
                                     quality=70))
    streams = [enc.encode(f, 64, 64, 1, 12) for f in img]
    got = decode_frames_pipelined(streams, device=lane)
    for g in got:
        assert g.min() >= 0 and g.max() <= 4095


def test_htj2k_adapter_batched_decode_matches_scalar(rng):
    """Multi-frame HT decode through the registry uses the batched
    pipeline; bytes equal the per-frame scalar path (lossless)."""
    import go_dicom_codec_jax as dc

    info = dc.FrameInfo(width=48, height=48, bits_allocated=16,
                        bits_stored=12)
    frames = (np.cumsum(rng.integers(-9, 10, (3, 48, 48)), axis=2)
              % 4096).astype("<u2")
    codec = dc.get_global_registry().get_codec(dc.uids.HTJ2K_LOSSLESS)
    src = dc.MemoryPixelData(info=info)
    for f in frames:
        src.add_frame(f.tobytes())
    enc = dc.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc)
    dec = dc.MemoryPixelData(info=info)
    codec.decode(enc, dec)
    for i in range(3):
        one = dc.MemoryPixelData(info=info, encapsulated=True)
        one.add_frame(enc.get_frame(i))
        d1 = dc.MemoryPixelData(info=info)
        codec.decode(one, d1)
        assert dec.get_frame(i) == d1.get_frame(0)


@pytest.mark.parametrize("style", [0x00, 0x01, 0x05, 0x08])
def test_pipeline_encode_honors_cb_style(style, rng):
    """Regression: the pipelined encoder's hand-built COD dropped
    cb_style, so the adapters' DEFAULT (lazy 0x01) multi-frame encodes
    never matched — and were gated off — the batched path. All styles
    are byte-identical to the scalar encoder now."""
    from go_dicom_codec_jax.codecs.jpeg2000 import (J2KEncodeParams,
                                                    J2KEncoder)

    frames = (np.cumsum(rng.integers(-9, 10, (3, 64, 64)), axis=2)
              % 4096).astype(np.int32)
    p = J2KEncodeParams(num_levels=3, cb_style=style)
    piped = encode_frames_pipelined(frames, bit_depth=12, params=p)
    enc = J2KEncoder(J2KEncodeParams(num_levels=3, cb_style=style))
    assert piped == [enc.encode(f, 64, 64, 1, 12) for f in frames]


def test_adapter_default_multiframe_uses_batched_path(rng):
    """The registry .90 adapter's default params (lazy code-blocks) now
    take the batched encode path, byte-identical to per-frame encodes."""
    import go_dicom_codec_jax as dc

    info = dc.FrameInfo(width=48, height=48, bits_allocated=16,
                        bits_stored=12)
    frames = (np.cumsum(rng.integers(-9, 10, (3, 48, 48)), axis=2)
              % 4096).astype("<u2")
    codec = dc.get_global_registry().get_codec(dc.uids.JPEG_2000_LOSSLESS)
    src = dc.MemoryPixelData(info=info)
    for f in frames:
        src.add_frame(f.tobytes())
    enc = dc.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc)
    for i in range(3):
        one = dc.MemoryPixelData(info=info)
        one.add_frame(frames[i].tobytes())
        e1 = dc.MemoryPixelData(info=info, encapsulated=True)
        codec.encode(one, e1)
        assert enc.get_frame(i) == e1.get_frame(0)
