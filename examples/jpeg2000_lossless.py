"""JPEG 2000 lossless through the DICOM adapter (role of reference
examples/jpeg2000_lossless): UID .90 with typed parameters, multi-frame
batching, and signed/16-bit content.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import go_dicom_codec_jax as dc


def main():
    rng = np.random.default_rng(0)
    frames = (np.cumsum(rng.integers(-9, 10, (4, 256, 256)), axis=2)
              % 4096).astype("<u2")
    info = dc.FrameInfo(width=256, height=256, bits_allocated=16,
                        bits_stored=12)
    codec = dc.get_global_registry().get_codec(dc.uids.JPEG_2000_LOSSLESS)

    # multi-frame: the adapter batches the device stage over all frames
    src = dc.MemoryPixelData(info=info)
    for f in frames:
        src.add_frame(f.tobytes())
    enc = dc.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc,
                 dc.Parameters(num_levels=4, progression=2,  # RPCL
                               cb_width=32, cb_height=32))
    dec = dc.MemoryPixelData(info=info)
    codec.decode(enc, dec)
    total_in = sum(len(src.get_frame(i)) for i in range(4))
    total_out = sum(len(enc.get_frame(i)) for i in range(4))
    for i in range(4):
        assert dec.get_frame(i) == src.get_frame(i)
    print(f"4 frames lossless: {total_in} -> {total_out} bytes "
          f"({total_in / total_out:.2f}x), all bit-exact")

    # signed pixel data is supported on the lossless path
    sinfo = dc.FrameInfo(width=128, height=128, bits_allocated=16,
                         bits_stored=16, pixel_representation=1)
    simg = rng.integers(-2048, 2048, (128, 128)).astype("<i2")
    ssrc = dc.MemoryPixelData(info=sinfo)
    ssrc.add_frame(simg.tobytes())
    senc = dc.MemoryPixelData(info=sinfo, encapsulated=True)
    codec.encode(ssrc, senc)
    sdec = dc.MemoryPixelData(info=sinfo)
    codec.decode(senc, sdec)
    assert sdec.get_frame(0) == ssrc.get_frame(0)
    print("signed 16-bit lossless roundtrip OK")


if __name__ == "__main__":
    main()
