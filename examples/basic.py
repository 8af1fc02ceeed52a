"""Basic registry usage (role of reference examples/basic).

Encode and decode one frame through the global codec registry.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import go_dicom_codec_jax as dc


def main():
    info = dc.FrameInfo(width=256, height=256, bits_allocated=16,
                        bits_stored=12)
    rng = np.random.default_rng(0)
    frame = (np.cumsum(rng.integers(-9, 10, (256, 256)), axis=1)
             % 4096).astype("<u2")

    codec = dc.get_global_registry().get_codec(dc.uids.JPEG_2000_LOSSLESS)
    src = dc.MemoryPixelData(info=info)
    src.add_frame(frame.tobytes())

    encoded = dc.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, encoded)
    print(f"{codec.name()}: {len(src.get_frame(0))} -> "
          f"{len(encoded.get_frame(0))} bytes "
          f"({len(src.get_frame(0)) / len(encoded.get_frame(0)):.2f}x)")

    decoded = dc.MemoryPixelData(info=info)
    codec.decode(encoded, decoded)
    print("lossless:", decoded.get_frame(0) == src.get_frame(0))


if __name__ == "__main__":
    main()
