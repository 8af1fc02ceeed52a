"""Direct JPEG 2000 encoder/decoder usage (role of reference
examples/jpeg2000_basic/jpeg2000_basic_example.go): drive J2KEncoder /
J2KDecoder below the DICOM registry — raw codestreams in and out.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder, J2KEncodeParams,
                                                J2KEncoder, decode_to_pixels)


def main():
    rng = np.random.default_rng(0)
    img = (np.cumsum(rng.integers(-9, 10, (256, 256)), axis=1)
           % 4096).astype("<u2")

    # lossless: reversible 5/3, bit-exact
    enc = J2KEncoder(J2KEncodeParams(lossless=True, num_levels=5))
    stream = enc.encode(img.tobytes(), 256, 256, 1, 12, False)
    pix, w, h, c, depth, signed = decode_to_pixels(stream)
    assert np.array_equal(np.frombuffer(pix, "<u2").reshape(256, 256), img)
    print(f"lossless: {img.nbytes} -> {len(stream)} bytes "
          f"({img.nbytes / len(stream):.2f}x), roundtrip bit-exact")

    # lossy: irreversible 9/7 + scalar quantization, quality knob
    for quality in (90, 60, 30):
        enc = J2KEncoder(J2KEncodeParams(lossless=False, quality=quality))
        stream = enc.encode(img.tobytes(), 256, 256, 1, 12, False)
        pix, *_ = decode_to_pixels(stream)
        err = np.abs(np.frombuffer(pix, "<u2").astype(int)
                     - img.reshape(-1).astype(int)).max()
        print(f"lossy q{quality}: {img.nbytes / len(stream):.1f}x, "
              f"maxerr {err}")

    # the decoder object exposes resilience and metadata
    arr, siz, cod = J2KDecoder(resilient=True).decode(stream)
    print(f"decoded {siz.xsiz}x{siz.ysiz}, {len(siz.components)} comp, "
          f"{cod.num_levels} levels, shape {arr.shape}")


if __name__ == "__main__":
    main()
