"""RLE Lossless roundtrip matrix.

Mirrors the reference's pixel-layout parity matrix (rle/parity_test.go:10-56:
8/16-bit mono, RGB interleaved + planar) plus stream-level invariants of
PS3.5 Annex G (64-byte header, even segment offsets).
"""

import numpy as np
import pytest

from go_dicom_codec_jax import MemoryPixelData, get_global_registry, uids
from go_dicom_codec_jax.codecs.rle import decode_frame, encode_frame
from go_dicom_codec_jax.entropy.rlepack import packbits_decode, packbits_encode
from go_dicom_codec_jax.errors import CorruptStreamError
from go_dicom_codec_jax.frames import FrameInfo


def _roundtrip(frame: bytes, info: FrameInfo) -> bytes:
    enc = encode_frame(frame, info)
    assert len(enc) >= 64 and len(enc) % 2 == 0
    nseg = int.from_bytes(enc[:4], "little")
    assert nseg == info.bytes_allocated * info.samples_per_pixel
    return decode_frame(enc, info)


LAYOUTS = [
    ("mono8", FrameInfo(width=31, height=17, bits_allocated=8)),
    ("mono16", FrameInfo(width=64, height=48, bits_allocated=16)),
    ("rgb8_interleaved", FrameInfo(width=23, height=19, bits_allocated=8,
                                   samples_per_pixel=3, planar_configuration=0,
                                   photometric_interpretation="RGB")),
    ("rgb8_planar", FrameInfo(width=23, height=19, bits_allocated=8,
                              samples_per_pixel=3, planar_configuration=1,
                              photometric_interpretation="RGB")),
    ("mono16_signed", FrameInfo(width=40, height=25, bits_allocated=16,
                                pixel_representation=1)),
]


@pytest.mark.parametrize("name,info", LAYOUTS, ids=[l[0] for l in LAYOUTS])
def test_roundtrip_random(name, info, rng):
    n = info.uncompressed_frame_size
    frame = rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
    assert _roundtrip(frame, info) == frame


@pytest.mark.parametrize("name,info", LAYOUTS, ids=[l[0] for l in LAYOUTS])
def test_roundtrip_gradient(name, info):
    n = info.uncompressed_frame_size
    frame = (np.arange(n, dtype=np.int64) // 97 % 256).astype(np.uint8).tobytes()
    assert _roundtrip(frame, info) == frame


def test_roundtrip_constant():
    info = FrameInfo(width=512, height=512, bits_allocated=16)
    frame = bytes(info.uncompressed_frame_size)
    enc = encode_frame(frame, info)
    # all-zero 16-bit: two segments of maximal repeat runs — tiny stream
    assert len(enc) < 64 + 2 * (2 * ((512 * 512 + 127) // 128) + 2)
    assert decode_frame(enc, info) == frame


def test_roundtrip_via_registry(rng):
    info = FrameInfo(width=128, height=64, bits_allocated=16)
    codec = get_global_registry().get_codec(uids.RLE_LOSSLESS)
    src = MemoryPixelData(info=info)
    for _ in range(3):
        src.add_frame(rng.integers(0, 1 << 12, size=info.pixel_count,
                                   dtype=np.uint16).astype("<u2").tobytes())
    encoded = MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, encoded)
    assert encoded.frame_count() == 3
    decoded = MemoryPixelData(info=info)
    codec.decode(encoded, decoded)
    for i in range(3):
        assert decoded.get_frame(i) == src.get_frame(i)


def test_packbits_primitives(rng):
    for data in [
        np.zeros(1000, dtype=np.uint8),
        np.arange(300, dtype=np.int64).astype(np.uint8),
        rng.integers(0, 4, size=2000, dtype=np.uint8),
        np.array([1], dtype=np.uint8),
        np.array([5, 5], dtype=np.uint8),
        np.array([5, 5, 5], dtype=np.uint8),
        np.repeat(np.array([1, 2], dtype=np.uint8), [200, 129]),
    ]:
        enc = packbits_encode(data)
        out = packbits_decode(enc, data.size)
        np.testing.assert_array_equal(out, data)


def test_decoder_rejects_bad_header():
    info = FrameInfo(width=4, height=4, bits_allocated=8)
    with pytest.raises(CorruptStreamError):
        decode_frame(b"\x00" * 10, info)
    # 0 segments invalid
    bad = (0).to_bytes(4, "little") + b"\x00" * 60
    with pytest.raises(CorruptStreamError):
        decode_frame(bad, info)
    # wrong segment count for format
    bad = (3).to_bytes(4, "little") + b"\x00" * 60
    with pytest.raises(CorruptStreamError):
        decode_frame(bad, info)


@pytest.mark.parametrize("name,info", LAYOUTS[:3] + LAYOUTS[4:],
                         ids=["mono8", "mono16", "rgb8_interleaved",
                              "mono16_signed"])
def test_batched_device_paths_byte_identical(name, info, rng):
    """encode_frames_batched/decode_frames_batched (ONE device planes
    launch per stack) produce the exact per-frame bytes (VERDICT r4 #9:
    the codec now routes multi-frame batches through ops/planes' jnp
    forms when the measured transfer policy prefers the device)."""
    from go_dicom_codec_jax.codecs.rle import (decode_frames_batched,
                                               encode_frames_batched)

    n = info.uncompressed_frame_size
    frames = [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
              for _ in range(3)]
    want = [encode_frame(f, info) for f in frames]
    assert encode_frames_batched(frames, info) == want
    assert decode_frames_batched(want, info) == frames


def test_codec_uses_batched_path_when_policy_prefers_device(rng, monkeypatch):
    """Fake the measured policy to 'device' and pin that the registry
    codec still roundtrips byte-identically through the batched path."""
    import go_dicom_codec_jax.codecs.rle as rle_mod

    calls = {"enc": 0, "dec": 0}
    real_enc, real_dec = rle_mod.encode_frames_batched, rle_mod.decode_frames_batched
    monkeypatch.setattr(rle_mod, "_use_device_planes",
                        lambda info, n: n >= 2)
    monkeypatch.setattr(
        rle_mod, "encode_frames_batched",
        lambda f, i: (calls.__setitem__("enc", calls["enc"] + 1),
                      real_enc(f, i))[1])
    monkeypatch.setattr(
        rle_mod, "decode_frames_batched",
        lambda d, i: (calls.__setitem__("dec", calls["dec"] + 1),
                      real_dec(d, i))[1])
    info = FrameInfo(width=32, height=16, bits_allocated=16)
    codec = rle_mod.RLECodec()
    src = MemoryPixelData(info=info)
    for _ in range(3):
        src.add_frame(rng.integers(0, 256, size=info.uncompressed_frame_size,
                                   dtype=np.uint8).tobytes())
    enc = MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc)
    per_frame = [encode_frame(src.get_frame(i), info) for i in range(3)]
    assert [enc.get_frame(i) for i in range(3)] == per_frame
    dec = MemoryPixelData(info=info)
    codec.decode(enc, dec)
    assert [dec.get_frame(i) for i in range(3)] == \
        [src.get_frame(i) for i in range(3)]
    assert calls == {"enc": 1, "dec": 1}


def test_device_plane_split_matches_host(rng):
    import jax.numpy as jnp

    from go_dicom_codec_jax.ops.planes import (
        merge_byte_planes, split_byte_planes, split_byte_planes_np)

    info = FrameInfo(width=16, height=8, bits_allocated=16,
                     samples_per_pixel=3, planar_configuration=0)
    n = info.uncompressed_frame_size
    frames = rng.integers(0, 256, size=(4, n), dtype=np.uint8)
    dev = split_byte_planes(jnp.asarray(frames), info.bytes_allocated,
                            info.samples_per_pixel)
    for f in range(4):
        host = split_byte_planes_np(frames[f].tobytes(), info)
        np.testing.assert_array_equal(np.asarray(dev[f]), host)
    back = merge_byte_planes(dev, info.bytes_allocated, info.samples_per_pixel)
    np.testing.assert_array_equal(np.asarray(back), frames)
