"""Decode a J2K codestream and export PNG (reference examples/export_png).

Pure-stdlib PNG writer (zlib + struct), no imaging dependency.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import struct
import sys
import zlib

import numpy as np

from go_dicom_codec_jax.codecs.jpeg2000 import (J2KEncodeParams, J2KEncoder,
                                                decode_to_pixels)


def write_png(path, arr):
    """arr: [H, W] uint8 or [H, W, 3] uint8."""
    h, w = arr.shape[:2]
    color = 2 if arr.ndim == 3 else 0
    raw = b"".join(b"\x00" + arr[y].tobytes() for y in range(h))

    def chunk(tag, data):
        c = tag + data
        return struct.pack(">I", len(data)) + c + struct.pack(
            ">I", zlib.crc32(c))

    png = b"\x89PNG\r\n\x1a\n"
    png += chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color, 0, 0, 0))
    png += chunk(b"IDAT", zlib.compress(raw))
    png += chunk(b"IEND", b"")
    with open(path, "wb") as f:
        f.write(png)


def main():
    rng = np.random.default_rng(0)
    img = (np.cumsum(rng.integers(-3, 4, (128, 128)), axis=1) % 256
           ).astype(np.uint8)
    data = J2KEncoder(J2KEncodeParams(num_levels=3)).encode(
        img.tobytes(), 128, 128, 1, 8)
    pix, w, h, c, depth, signed = decode_to_pixels(data)
    arr = np.frombuffer(pix, np.uint8).reshape(h, w)
    out = sys.argv[1] if len(sys.argv) > 1 else "/tmp/decoded.png"
    write_png(out, arr)
    print(f"wrote {out} ({w}x{h}, lossless={pix == img.tobytes()})")


if __name__ == "__main__":
    main()
