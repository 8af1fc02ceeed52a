"""Transcoder CLI between any two registered transfer syntaxes
(role of reference examples/dicom_transcoder/main.go — the blank-import
registration pattern becomes `import go_dicom_codec_jax`).

Usage:
    python examples/dicom_transcoder.py <from_uid> <to_uid>

Runs on a synthetic frame; swap in real pixel bytes for production use.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import go_dicom_codec_jax as dc


def transcode(pixels: bytes, info: dc.FrameInfo, from_uid: str,
              to_uid: str) -> bytes:
    """raw pixels → from_uid stream → raw → to_uid stream."""
    reg = dc.get_global_registry()
    raw = dc.MemoryPixelData(info=info)
    raw.add_frame(pixels)

    src_codec = reg.get_codec(from_uid)
    enc = dc.MemoryPixelData(info=info, encapsulated=True)
    src_codec.encode(raw, enc)

    mid = dc.MemoryPixelData(info=info)
    src_codec.decode(enc, mid)

    dst_codec = reg.get_codec(to_uid)
    out = dc.MemoryPixelData(info=info, encapsulated=True)
    dst_codec.encode(mid, out)
    return out.get_frame(0)


def main() -> None:
    from_uid = sys.argv[1] if len(sys.argv) > 1 else dc.uids.RLE_LOSSLESS
    to_uid = sys.argv[2] if len(sys.argv) > 2 else dc.uids.JPEG_2000_LOSSLESS
    info = dc.FrameInfo(width=256, height=256, bits_allocated=16,
                        bits_stored=12)
    rng = np.random.default_rng(0)
    frame = (np.cumsum(rng.integers(-9, 10, (256, 256)), axis=1)
             % 4096).astype("<u2").tobytes()
    out = transcode(frame, info, from_uid, to_uid)
    print(f"{from_uid} -> {to_uid}: {len(frame)} raw bytes -> "
          f"{len(out)} encoded bytes")


if __name__ == "__main__":
    main()
