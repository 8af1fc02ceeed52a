"""Clinical-pixel interop checks through the public registry.

Role of the reference interop tool's 5 embedded anonymized .dcm
fixtures (cmd/dicom-interop-validation/main.go:89-90): every transfer
syntax must handle REAL modality pixels — XR (8-bit), CT (12-bit),
signed MR (16-bit) — not just synthetic gradients. Mirrors
tools/interop.py --fixture clinical inside the pytest suite.
"""

import numpy as np
import pytest

import go_dicom_codec_jax as dc
from go_dicom_codec_jax.tools.interop import (FORMAT_DEFINITIONS,
                                              _clinical_fixture)


@pytest.mark.parametrize(
    "label,uid,bits,samples,tol,enc_params",
    [(r + (None,))[:6] for r in FORMAT_DEFINITIONS],
    ids=[row[0] for row in FORMAT_DEFINITIONS])
def test_clinical_roundtrip(label, uid, bits, samples, tol, enc_params):
    img, signed = _clinical_fixture(bits, samples)
    h, w = img.shape[:2]
    info = dc.FrameInfo(
        width=w, height=h, bits_allocated=8 if bits <= 8 else 16,
        bits_stored=bits, samples_per_pixel=samples,
        pixel_representation=1 if signed else 0,
        photometric_interpretation="RGB" if samples == 3 else
        "MONOCHROME2")
    src = dc.MemoryPixelData(info=info)
    src.add_frame(np.ascontiguousarray(img).tobytes())
    codec = dc.get_global_registry().get_codec(uid)
    enc = dc.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc,
                 dc.Parameters(**enc_params) if enc_params else None)
    dec = dc.MemoryPixelData(info=info)
    codec.decode(enc, dec)
    got = np.frombuffer(dec.get_frame(0), dtype=img.dtype)
    err = np.abs(got.astype(np.int64)
                 - img.reshape(-1).astype(np.int64)).max()
    assert err <= tol, f"{label}: maxerr={err} > tol={tol}"


def test_clinical_fixture_provenance():
    """The three fixtures keep their real dtypes and content."""
    xr, s8 = _clinical_fixture(8, 1)
    ct, s12 = _clinical_fixture(12, 1)
    mr, s16 = _clinical_fixture(16, 1)
    assert not s8 and not s12 and s16
    assert xr.dtype == np.uint8 and xr.max() > 128
    assert ct.dtype == np.dtype("<u2") and ct.max() > 256
    # MR ships in a signed container (PixelRepresentation=1) even
    # though this series' values happen to be positive
    assert mr.dtype == np.dtype("<i2") and mr.max() > 1024
