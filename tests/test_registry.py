"""Registry + frames + params contract tests (reference codec/ layer)."""

import numpy as np
import pytest

from go_dicom_codec_jax import (
    CodecNotFoundError,
    FrameInfo,
    MemoryPixelData,
    Parameters,
    get_global_registry,
    uids,
)
from go_dicom_codec_jax.frames import array_to_frame, frame_to_array


def test_lookup_unknown_uid_raises():
    with pytest.raises(CodecNotFoundError):
        get_global_registry().get_codec("9.9.9")


def test_rle_registered():
    reg = get_global_registry()
    assert reg.has_codec(uids.RLE_LOSSLESS)
    codec = reg.get_codec(uids.RLE_LOSSLESS)
    assert codec.transfer_syntax() == uids.RLE_LOSSLESS
    assert "RLE" in codec.name()


def test_parameters_bag():
    p = Parameters(quality=90)
    assert p.get_parameter("quality") == 90
    q = p.with_("near", 3)
    assert q.get_parameter("near") == 3
    assert not p.has_parameter("near")


def test_frame_info_derived_fields():
    info = FrameInfo(width=10, height=4, bits_allocated=12)
    assert info.bytes_allocated == 2
    assert info.bits_stored == 12
    assert info.high_bit == 11
    assert info.uncompressed_frame_size == 10 * 4 * 2


@pytest.mark.parametrize("planar", [0, 1])
def test_frame_array_roundtrip(planar, rng):
    info = FrameInfo(width=7, height=5, bits_allocated=16, samples_per_pixel=3,
                     planar_configuration=planar)
    arr = rng.integers(0, 1 << 16, size=(5, 7, 3)).astype(np.uint16)
    frame = array_to_frame(arr, info)
    assert len(frame) == info.uncompressed_frame_size
    back = frame_to_array(frame, info)
    np.testing.assert_array_equal(back, arr)


def test_memory_pixel_data():
    pd = MemoryPixelData(info=FrameInfo(width=2, height=2))
    pd.add_frame(b"\x01\x02\x03\x04")
    assert pd.frame_count() == 1
    assert pd.get_frame(0) == b"\x01\x02\x03\x04"
    with pytest.raises(IndexError):
        pd.get_frame(1)
    assert not pd.is_encapsulated()
