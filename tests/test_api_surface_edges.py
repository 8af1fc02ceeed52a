"""Registry / Parameters / FrameInfo / PixelData contract edges
(reference codec/registry_test.go, codec/parameters_test.go,
codec/frame_info_test.go class of tests — VERDICT r3 #7 depth), plus
Golomb bit-IO boundary units.
"""

import threading

import numpy as np
import pytest

import go_dicom_codec_jax as dc
from go_dicom_codec_jax.errors import UnsupportedFormatError
from go_dicom_codec_jax.frames import (FrameInfo, MemoryPixelData,
                                       array_to_frame, frame_to_array,
                                       frames_as_array, frames_from_array)
from go_dicom_codec_jax.params import (Parameters, optional_int,
                                       require_range)
from go_dicom_codec_jax.registry import CodecRegistry, get_global_registry


# ---- registry ----------------------------------------------------------------

def test_registry_all_14_uids_registered():
    reg = get_global_registry()
    u = dc.uids
    for uid in (u.RLE_LOSSLESS, u.JPEG_BASELINE_8BIT, u.JPEG_EXTENDED_12BIT,
                u.JPEG_LOSSLESS_P14, u.JPEG_LOSSLESS_SV1, u.JPEG_LS_LOSSLESS,
                u.JPEG_LS_NEAR_LOSSLESS, u.JPEG_2000_LOSSLESS,
                u.JPEG_2000_LOSSY, u.JPEG_2000_MC_LOSSLESS,
                u.JPEG_2000_MC_LOSSY, u.HTJ2K_LOSSLESS,
                u.HTJ2K_LOSSLESS_RPCL, u.HTJ2K):
        assert reg.has_codec(uid), uid


def test_registry_unknown_uid_raises():
    with pytest.raises(Exception):
        get_global_registry().get_codec("1.2.3.4.5.6.7")


def test_registry_register_unregister_cycle():
    reg = CodecRegistry()
    codec = get_global_registry().get_codec(dc.uids.RLE_LOSSLESS)
    reg.register_codec("x.y.z", codec)
    assert reg.has_codec("x.y.z")
    assert reg.get_codec("x.y.z") is codec
    reg.unregister_codec("x.y.z")
    assert not reg.has_codec("x.y.z")


def test_registry_reregistration_latest_wins():
    reg = CodecRegistry()
    a = get_global_registry().get_codec(dc.uids.RLE_LOSSLESS)
    b = get_global_registry().get_codec(dc.uids.JPEG_LS_LOSSLESS)
    reg.register_codec("x", a)
    reg.register_codec("x", b)
    assert reg.get_codec("x") is b


def test_registry_listing_sorted_unique():
    reg = get_global_registry()
    lst = reg.registered_transfer_syntaxes()
    assert len(lst) == len(set(lst))


def test_registry_thread_safe_reads():
    reg = get_global_registry()
    errors = []

    def worker():
        try:
            for _ in range(200):
                reg.get_codec(dc.uids.RLE_LOSSLESS)
                reg.has_codec(dc.uids.HTJ2K)
        except Exception as e:  # noqa: BLE001
            errors.append(e)

    ts = [threading.Thread(target=worker) for _ in range(8)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errors


# ---- Parameters --------------------------------------------------------------

def test_parameters_get_set_default():
    p = Parameters(quality=80)
    assert p.get_parameter("quality") == 80
    assert p.get_parameter("missing", 7) == 7
    assert p.has_parameter("quality") and not p.has_parameter("missing")


def test_parameters_with_is_copy():
    p = Parameters(a=1)
    q = p.with_("a", 2)
    assert p.get_parameter("a") == 1 and q.get_parameter("a") == 2


def test_parameters_copy_independent():
    p = Parameters(a=[1, 2])
    q = p.copy()
    q.set_parameter("a", [3])
    assert p.get_parameter("a") == [1, 2]


def test_parameters_iter_contains_dict():
    p = Parameters(a=1, b=2)
    assert set(iter(p)) == {"a", "b"}
    assert "a" in p and "z" not in p
    assert p.as_dict() == {"a": 1, "b": 2}


def test_require_range_bounds():
    assert require_range("x", 5, 1, 10) == 5
    with pytest.raises(Exception):
        require_range("x", 0, 1, 10)
    with pytest.raises(Exception):
        require_range("x", 11, 1, 10)


def test_optional_int_none_and_missing():
    assert optional_int(None, "k", 3) == 3
    assert optional_int(Parameters(), "k", 3) == 3
    assert optional_int(Parameters(k=9), "k", 3) == 9


# ---- FrameInfo / MemoryPixelData --------------------------------------------

def test_frame_info_derived_sizes():
    info = FrameInfo(width=10, height=20, bits_allocated=16,
                     bits_stored=12, samples_per_pixel=3)
    assert info.bytes_allocated == 2
    assert info.pixel_count == 200
    assert info.uncompressed_frame_size == 10 * 20 * 3 * 2


def test_frame_info_numpy_dtype_signed():
    info = FrameInfo(width=4, height=4, bits_allocated=16,
                     pixel_representation=1)
    assert info.is_signed
    assert info.numpy_dtype == np.dtype("<i2")


def test_frame_info_with_updates():
    info = FrameInfo(width=4, height=4, bits_allocated=8)
    info2 = info.with_(width=8)
    assert info.width == 4 and info2.width == 8


def test_memory_pixel_data_frames():
    info = FrameInfo(width=2, height=2, bits_allocated=8)
    pd = MemoryPixelData(info=info)
    pd.add_frame(b"abcd")
    pd.add_frame(b"efgh")
    assert pd.frame_count() == 2
    assert pd.get_frame(1) == b"efgh"
    assert not pd.is_encapsulated()
    with pytest.raises(Exception):
        pd.get_frame(5)


def test_frame_array_roundtrip_interleaved_rgb():
    info = FrameInfo(width=3, height=2, bits_allocated=8,
                     samples_per_pixel=3,
                     photometric_interpretation="RGB")
    arr = np.arange(18, dtype=np.uint8).reshape(2, 3, 3)
    frame = array_to_frame(arr, info)
    back = frame_to_array(frame, info)
    np.testing.assert_array_equal(back, arr)


def test_frame_array_roundtrip_16bit():
    info = FrameInfo(width=4, height=3, bits_allocated=16, bits_stored=12)
    arr = np.arange(12, dtype="<u2").reshape(3, 4, 1)
    np.testing.assert_array_equal(
        frame_to_array(array_to_frame(arr, info), info), arr)


def test_frames_as_array_and_back():
    info = FrameInfo(width=4, height=2, bits_allocated=8)
    batch = np.arange(24, dtype=np.uint8).reshape(3, 2, 4, 1)
    pd = frames_from_array(batch, info)
    assert pd.frame_count() == 3
    np.testing.assert_array_equal(frames_as_array(pd), batch)


def test_codec_rejects_wrong_bit_depth():
    info = FrameInfo(width=8, height=8, bits_allocated=16, bits_stored=16)
    src = MemoryPixelData(info=info)
    src.add_frame(bytes(128))
    codec = get_global_registry().get_codec(dc.uids.JPEG_BASELINE_8BIT)
    enc = MemoryPixelData(info=info, encapsulated=True)
    with pytest.raises(UnsupportedFormatError):
        codec.encode(src, enc)


# ---- Golomb bit IO boundaries -----------------------------------------------

def test_golomb_unary_roundtrip():
    from go_dicom_codec_jax.entropy.golomb import GolombReader, GolombWriter
    gw = GolombWriter()
    for n in (0, 1, 7, 31, 64):
        gw.write_unary(n)
    data = gw.finish()
    gr = GolombReader(data)
    for n in (0, 1, 7, 31, 64):
        c = 0
        while gr.read_bit() == 0:
            c += 1
        assert c == n


def test_golomb_mapped_limit_escape():
    """Values beyond the unary limit take the escape (limit) path and
    still roundtrip through encode_mapped's bit layout."""
    from go_dicom_codec_jax.entropy.golomb import GolombReader, GolombWriter
    k, limit, qbpp = 0, 23, 8
    big = 200                          # forces the limit escape
    small = 3
    gw = GolombWriter()
    gw.encode_mapped(k, small, limit, qbpp)
    gw.encode_mapped(k, big, limit, qbpp)
    data = gw.finish()
    gr = GolombReader(data)

    def read_mapped():
        q = 0
        while gr.read_bit() == 0:
            q += 1
        if q < limit - qbpp - 1:
            return (q << k) | gr.read_bits(k) if k else q
        return gr.read_bits(qbpp) + 1
    assert read_mapped() == small
    assert read_mapped() == big


def test_golomb_writer_bit_packing_msb_first():
    from go_dicom_codec_jax.entropy.golomb import GolombWriter
    gw = GolombWriter()
    gw.write_unary(0)                  # '1'
    gw.write_unary(2)                  # '001'
    data = gw.finish()
    assert (data[0] >> 4) == 0b1001
