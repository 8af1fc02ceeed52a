"""Arbitrary component counts through the J2K core and MC adapters.

Mirrors the reference's multi-component codec suites
(jpeg2000/lossless/mc_codec_test.go, jpeg2000/lossy/mc_codec_test.go:
2-component frames with MCT bindings write MCT/MCC markers through the
registry codec) and its EncodeComponents surface (encoder.go takes
[][]int32 of any length — component count is not restricted to 1/3).
"""

import numpy as np
import pytest

import go_dicom_codec_jax as dc
from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder, J2KEncodeParams,
                                                J2KEncoder)
from go_dicom_codec_jax.codecs.mct_builder import MCTBinding
from go_dicom_codec_jax.codestream import j2k
from go_dicom_codec_jax.errors import UnsupportedFormatError


@pytest.mark.parametrize("ncomp", [2, 4, 5])
def test_ncomp_lossless_roundtrip(ncomp, rng):
    img = rng.integers(0, 256, (24, 16, ncomp)).astype(np.uint8)
    data = J2KEncoder(J2KEncodeParams(num_levels=2)).encode(
        img.tobytes(), 16, 24, ncomp, 8)
    arr, siz, _ = J2KDecoder().decode(data)
    assert len(siz.components) == ncomp
    np.testing.assert_array_equal(arr, img.astype(np.int32))


@pytest.mark.parametrize("ncomp", [2, 4])
def test_ncomp_bindings_write_markers_and_roundtrip(ncomp, rng):
    # identity matrix + offsets binding over all components (reference
    # TestLosslessCodecWithMCTBindingsWritesMarkers shape)
    img = rng.integers(0, 256, (16, 16, ncomp)).astype(np.uint8)
    b = MCTBinding(component_ids=list(range(ncomp)),
                   matrix=np.eye(ncomp).tolist(),
                   inverse=np.eye(ncomp).tolist(),
                   offsets=[5.0] * ncomp)
    data = J2KEncoder(J2KEncodeParams(num_levels=2, mct_bindings=[b])
                      ).encode(img.tobytes(), 16, 16, ncomp, 8)
    cs = j2k.parse_codestream(data)
    assert cs.mct_segments and cs.mcc_segments
    arr, _, _ = J2KDecoder().decode(data)
    np.testing.assert_array_equal(arr, img.astype(np.int32))


def test_two_component_mc_adapter_writes_markers(rng):
    # reference mc_codec_test.go via the registry: SamplesPerPixel=2,
    # identity bindings → MCT and MCC markers present, exact roundtrip
    reg = dc.get_global_registry()
    info = dc.FrameInfo(width=8, height=8, bits_allocated=8,
                        bits_stored=8, samples_per_pixel=2)
    img = np.stack([(np.arange(64) % 256),
                    ((np.arange(64) * 3) % 256)],
                   axis=-1).astype(np.uint8)
    b = MCTBinding(component_ids=[0, 1],
                   matrix=[[1.0, 0.0], [0.0, 1.0]],
                   inverse=[[1.0, 0.0], [0.0, 1.0]],
                   offsets=[5.0, -5.0])
    codec = reg.get_codec(dc.uids.JPEG_2000_MC_LOSSLESS)
    src = dc.MemoryPixelData(info=info)
    src.add_frame(img.tobytes())
    enc = dc.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc, dc.Parameters(mct_bindings=[b]))
    cs = j2k.parse_codestream(enc.get_frame(0))
    assert cs.mct_segments and cs.mcc_segments
    dec = dc.MemoryPixelData(info=info)
    codec.decode(enc, dec)
    assert dec.get_frame(0) == src.get_frame(0)


def test_two_component_mc_lossy_adapter(rng):
    # reference lossy/mc_codec_test.go analogue: .93 with bindings
    reg = dc.get_global_registry()
    info = dc.FrameInfo(width=16, height=16, bits_allocated=8,
                        bits_stored=8, samples_per_pixel=2)
    img = rng.integers(0, 256, (16, 16, 2)).astype(np.uint8)
    b = MCTBinding(component_ids=[0, 1],
                   matrix=[[1.0, 0.0], [0.0, 1.0]],
                   inverse=[[1.0, 0.0], [0.0, 1.0]],
                   offsets=None)
    codec = reg.get_codec(dc.uids.JPEG_2000_MC_LOSSY)
    src = dc.MemoryPixelData(info=info)
    src.add_frame(img.tobytes())
    enc = dc.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc, dc.Parameters(mct_bindings=[b], quality=95))
    cs = j2k.parse_codestream(enc.get_frame(0))
    assert cs.mct_segments and cs.mcc_segments
    dec = dc.MemoryPixelData(info=info)
    codec.decode(enc, dec)
    out = np.frombuffer(dec.get_frame(0), dtype=np.uint8).reshape(16, 16, 2)
    err = np.abs(out.astype(int) - img.astype(int))
    assert err.max() <= 16 and err.mean() < 4.0


def test_zero_components_rejected():
    with pytest.raises(UnsupportedFormatError):
        J2KEncoder(J2KEncodeParams()).encode(b"", 4, 4, 0, 8)
