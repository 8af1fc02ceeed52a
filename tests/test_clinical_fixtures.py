"""Real clinical pixel data through every lossless codec.

Fixtures extracted from the reference interop tool's anonymized DICOM
samples (cmd/dicom-interop-validation/fixtures/sample-0*.dcm):

- us_fodicom_sv1.jpg — the JPEG Lossless SV1 (.4.70) stream exactly as
  fo-dicom encoded it (golden external-encoder fixture for P14 decode)
- clinical_pixels.npz — raw pixels from the uncompressed samples
  (signed 16-bit MR, 8-bit X-ray, 12-bit CT) for roundtrip testing on
  real image statistics rather than synthetic noise
"""

import hashlib
import os

import numpy as np
import pytest

import go_dicom_codec_jax as dc
from go_dicom_codec_jax.codecs import jpeg_lossless

BASE = os.path.join(os.path.dirname(__file__), "..", "test-data")

SV1_PIXEL_SHA = ("bae1813f165ae41351acbffb87ee982c"
                 "e80ea942c1c88f5ee83b0824ab5e377a")


def test_fodicom_sv1_golden_decode():
    """Decode the fo-dicom-encoded clinical SV1 stream; pin the output."""
    with open(os.path.join(BASE, "us_fodicom_sv1.jpg"), "rb") as f:
        stream = f.read()
    pixels, w, h, nc, prec = jpeg_lossless.decode(stream)
    assert (w, h, nc, prec) == (512, 512, 1, 12)
    assert hashlib.sha256(pixels).hexdigest() == SV1_PIXEL_SHA
    # the decoded image is a real picture, not noise
    arr = np.frombuffer(pixels, dtype="<u2").reshape(h, w).astype(float)
    corr = np.corrcoef(arr[:, :-1].ravel(), arr[:, 1:].ravel())[0, 1]
    assert corr > 0.95
    # our encoder reproduces the pixels bit-exact (and no larger stream)
    re = jpeg_lossless.encode(pixels, w, h, nc, prec, predictor=1)
    assert len(re) <= len(stream)
    p2, *_ = jpeg_lossless.decode(re)
    assert p2 == pixels


def _clinical():
    z = np.load(os.path.join(BASE, "clinical_pixels.npz"))
    out = []
    for key in ("mr_s16", "xr_u8", "ct_u12"):
        bits, signed = (int(v) for v in z[key + "_meta"])
        out.append((key, z[key], bits, bool(signed)))
    return out


LOSSLESS_UIDS = [
    dc.uids.RLE_LOSSLESS,
    dc.uids.JPEG_2000_LOSSLESS,
    dc.uids.HTJ2K_LOSSLESS,
    dc.uids.JPEG_LS_LOSSLESS,
    dc.uids.JPEG_LOSSLESS_SV1,
]


@pytest.mark.parametrize("uid", LOSSLESS_UIDS)
@pytest.mark.parametrize("name", ["mr_s16", "xr_u8", "ct_u12"])
def test_clinical_roundtrip(uid, name):
    data = {k: v for (k, v, b, s) in _clinical()}
    meta = {k: (b, s) for (k, v, b, s) in _clinical()}
    arr = data[name]
    bits, signed = meta[name]
    # signed MR through the unsigned-core codecs (JPEG-LS / SV1) passes
    # container bytes straight through, exactly like the reference
    # (jpegls/lossless/codec.go:74-77) — asserted end-to-end, not skipped.
    h, w = arr.shape
    info = dc.FrameInfo(width=w, height=h,
                        bits_allocated=arr.dtype.itemsize * 8,
                        bits_stored=bits,
                        pixel_representation=1 if signed else 0)
    src = dc.MemoryPixelData(info=info)
    src.add_frame(np.ascontiguousarray(arr).tobytes())
    codec = dc.get_global_registry().get_codec(uid)
    enc = dc.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc)
    dec = dc.MemoryPixelData(info=info)
    codec.decode(enc, dec)
    assert dec.get_frame(0) == src.get_frame(0), uid
