"""HTJ2K: HT cleanup block coder + full codestream roundtrips.

Mirrors reference coverage (htj2k/htj2k_roundtrip_test.go, ht_test.go,
interop byte-exact lossless decode requirement).
"""

import numpy as np
import pytest

from go_dicom_codec_jax import MemoryPixelData, get_global_registry, uids
from go_dicom_codec_jax.codecs.jpeg2000 import (J2KEncodeParams, J2KEncoder,
                                                decode_to_pixels)
from go_dicom_codec_jax.codecs.ht_tables import (DEC_LUT0, DEC_LUT1,
                                                 ENC_LUT0, VLC_TBL0)
from go_dicom_codec_jax.entropy.htcleanup import (HTCleanupDecoder,
                                                  HTCleanupEncoder,
                                                  MELReader, MELWriter)
from go_dicom_codec_jax.frames import FrameInfo


def test_vlc_tables_complete():
    assert len(VLC_TBL0) == 444
    assert all(v for v in DEC_LUT0)  # every 7-bit window decodable
    assert all(v for v in DEC_LUT1)
    # rho=1 cq=0 u_off=0 must map to a valid codeword
    e = ENC_LUT0[(0 << 8) | (1 << 4) | 0]
    assert e != 0 and (e >> 4) & 7 > 0


def test_mel_state_machine_monotone():
    """MEL k adapts up on zeros, down on ones (15444-15 Table 4)."""
    wtr = MELWriter()
    for _ in range(200):
        wtr.encode(False)
    assert wtr.k == 12  # saturates at max state
    wtr.encode(True)
    assert wtr.k == 11


SIZES = [(2, 2), (4, 4), (8, 8), (5, 7), (1, 8), (64, 64), (33, 29), (3, 3)]


@pytest.mark.parametrize("size", SIZES)
def test_ht_block_roundtrip(size, rng):
    h, w = size
    data = rng.integers(-500, 500, size=(h, w)).astype(np.int32)
    numbps = int(np.abs(data).max()).bit_length()
    kmax = numbps + 2
    blob = HTCleanupEncoder(w, h, kmax).encode(data)
    got = HTCleanupDecoder(w, h, kmax, kmax - 1).decode(blob)
    np.testing.assert_array_equal(got, data)


def test_ht_block_sparse(rng):
    data = np.zeros((16, 16), dtype=np.int32)
    data[0, 0] = 1
    data[15, 15] = -1000
    data[7, 8] = 513
    blob = HTCleanupEncoder(16, 16, 13).encode(data)
    got = HTCleanupDecoder(16, 16, 13, 12).decode(blob)
    np.testing.assert_array_equal(got, data)


def test_ht_block_all_zero():
    data = np.zeros((8, 8), dtype=np.int32)
    assert HTCleanupEncoder(8, 8, 10).encode(data) is None
    got = HTCleanupDecoder(8, 8, 10, 9).decode(b"")
    np.testing.assert_array_equal(got, data)


@pytest.mark.parametrize("size", [(32, 32), (48, 40), (17, 23)])
def test_htj2k_lossless_codestream_roundtrip(size, rng):
    h, w = size
    img = rng.integers(0, 1 << 12, size=(h, w)).astype("<u2")
    enc = J2KEncoder(J2KEncodeParams(lossless=True, htj2k=True,
                                     num_levels=2, progression=2))
    data = enc.encode(img.tobytes(), w, h, 1, 12)
    # CAP marker present
    assert b"\xff\x50" in data[:64]
    pix, ow, oh, oc, depth, signed = decode_to_pixels(data)
    assert pix == img.tobytes()


def test_htj2k_rgb_lossless(rng):
    img = rng.integers(0, 256, size=(24, 24, 3)).astype(np.uint8)
    enc = J2KEncoder(J2KEncodeParams(lossless=True, htj2k=True,
                                     num_levels=2))
    data = enc.encode(img.tobytes(), 24, 24, 3, 8)
    pix, *_ = decode_to_pixels(data)
    assert pix == img.tobytes()


def test_htj2k_lossy(rng):
    small = rng.random((8, 8))
    ys = np.linspace(0, 6.99, 48).astype(int)
    img = (small[np.ix_(ys, ys)] * 250).astype(np.uint8)
    enc = J2KEncoder(J2KEncodeParams(lossless=False, htj2k=True, quality=90,
                                     num_levels=3))
    data = enc.encode(img.tobytes(), 48, 48, 1, 8)
    pix, *_ = decode_to_pixels(data)
    got = np.frombuffer(pix, np.uint8).reshape(48, 48).astype(int)
    assert np.abs(got - img.astype(int)).mean() < 3


@pytest.mark.parametrize("uid", [uids.HTJ2K_LOSSLESS,
                                 uids.HTJ2K_LOSSLESS_RPCL])
def test_registry_htj2k_lossless(uid, rng):
    info = FrameInfo(width=32, height=24, bits_allocated=16, bits_stored=12)
    codec = get_global_registry().get_codec(uid)
    img = rng.integers(0, 4096, size=(24, 32)).astype("<u2")
    src = MemoryPixelData(info=info)
    src.add_frame(img.tobytes())
    enc = MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc)
    dec = MemoryPixelData(info=info)
    codec.decode(enc, dec)
    assert dec.get_frame(0) == src.get_frame(0), uid


def test_registry_htj2k_lossy(rng):
    info = FrameInfo(width=32, height=32, bits_allocated=8)
    codec = get_global_registry().get_codec(uids.HTJ2K)
    img = np.full((32, 32), 99, dtype=np.uint8)
    src = MemoryPixelData(info=info)
    src.add_frame(img.tobytes())
    enc = MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc)
    dec = MemoryPixelData(info=info)
    codec.decode(enc, dec)
    got = np.frombuffer(dec.get_frame(0), np.uint8).astype(int)
    assert np.abs(got - 99).max() <= 2
