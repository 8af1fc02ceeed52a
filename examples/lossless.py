"""JPEG Lossless (Process 14 / SV1) usage (role of reference
examples/lossless/lossless_usage.go): direct codec use, registry use,
and predictor selection through Parameters.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import go_dicom_codec_jax as dc


def roundtrip(codec, info, raw, parameters=None):
    src = dc.MemoryPixelData(info=info)
    src.add_frame(raw)
    enc = dc.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc, parameters)
    dec = dc.MemoryPixelData(info=info)
    codec.decode(enc, dec)
    assert dec.get_frame(0) == raw, "lossless roundtrip mismatch"
    return len(raw) / len(enc.get_frame(0))


def main():
    rng = np.random.default_rng(0)
    img = (np.cumsum(rng.integers(-9, 10, (256, 256)), axis=1)
           % 4096).astype("<u2")
    info = dc.FrameInfo(width=256, height=256, bits_allocated=16,
                        bits_stored=12)
    registry = dc.get_global_registry()

    # Process 14 (UID .57): predictor selectable 1..7, or auto-select
    p14 = registry.get_codec(dc.uids.JPEG_LOSSLESS_P14)
    for pred in (1, 4, 7):
        ratio = roundtrip(p14, info, img.tobytes(),
                          dc.Parameters(predictor=pred))
        print(f"P14 predictor {pred}: {ratio:.2f}x")
    print(f"P14 auto-select:   "
          f"{roundtrip(p14, info, img.tobytes()):.2f}x")

    # SV1 (UID .70): first-order prediction, the DICOM default lossless
    sv1 = registry.get_codec(dc.uids.JPEG_LOSSLESS_SV1)
    print(f"SV1:               {roundtrip(sv1, info, img.tobytes()):.2f}x")


if __name__ == "__main__":
    main()
