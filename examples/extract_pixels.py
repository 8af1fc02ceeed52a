"""Decode an encoded frame back to raw pixels and inspect them
(role of reference examples/extract_pixels).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import go_dicom_codec_jax as dc


def main() -> None:
    info = dc.FrameInfo(width=128, height=128, bits_allocated=16,
                        bits_stored=12)
    rng = np.random.default_rng(0)
    frame = (np.cumsum(rng.integers(-9, 10, (128, 128)), axis=1)
             % 4096).astype("<u2")

    reg = dc.get_global_registry()
    for uid in (dc.uids.RLE_LOSSLESS, dc.uids.JPEG_2000_LOSSLESS,
                dc.uids.JPEG_LS_LOSSLESS, dc.uids.HTJ2K_LOSSLESS):
        codec = reg.get_codec(uid)
        src = dc.MemoryPixelData(info=info)
        src.add_frame(frame.tobytes())
        enc = dc.MemoryPixelData(info=info, encapsulated=True)
        codec.encode(src, enc)
        dec = dc.MemoryPixelData(info=info)
        codec.decode(enc, dec)
        pixels = np.frombuffer(dec.get_frame(0), dtype="<u2").reshape(128,
                                                                      128)
        print(f"{codec.name():40s} min={pixels.min():4d} "
              f"max={pixels.max():4d} mean={pixels.mean():8.2f} "
              f"exact={bool(np.array_equal(pixels, frame))}")


if __name__ == "__main__":
    main()
