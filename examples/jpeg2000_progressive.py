"""Progressive / layered streams demo (role of reference
examples/jpeg2000_progressive): quality layers, target ratio, and
decode-from-prefix behavior.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder, J2KEncodeParams,
                                                J2KEncoder)


def main() -> None:
    rng = np.random.default_rng(0)
    base = np.cumsum(rng.integers(-6, 7, size=(256, 256)), axis=1)
    img = (base - base.min()).astype("<u2")

    # three quality layers: 32:1, 8:1, lossless
    enc = J2KEncoder(J2KEncodeParams(num_levels=4, num_layers=3,
                                     layer_rates=[32.0, 8.0, 0]))
    data = enc.encode(img.tobytes(), 256, 256, 1, 12, False)
    print(f"layered stream: {len(data)} bytes")
    for frac in (0.1, 0.3, 1.0):
        cut = data[: int(len(data) * frac)]
        arr, _, _ = J2KDecoder(resilient=True).decode(cut)
        err = np.abs(arr[:, :, 0].astype(float) - img.astype(float)).mean()
        print(f"  decode first {frac:4.0%}: mean |err| = {err:8.3f}")

    # single-layer target ratio: PCRD truncation to a byte budget
    enc_tr = J2KEncoder(J2KEncodeParams(num_levels=4, target_ratio=16.0))
    data_tr = enc_tr.encode(img.tobytes(), 256, 256, 1, 12, False)
    raw = 256 * 256 * 12 / 8
    print(f"target_ratio=16: {len(data_tr)} bytes "
          f"(byte target {raw / 16:.0f})")

    # rate layers + appended lossless final layer
    enc_al = J2KEncoder(J2KEncodeParams(num_levels=4, num_layers=2,
                                        layer_rates=[32.0, 8.0],
                                        append_lossless_layer=True))
    data_al = enc_al.encode(img.tobytes(), 256, 256, 1, 12, False)
    arr, _, _ = J2KDecoder().decode(data_al)
    print("append_lossless_layer full decode lossless:",
          bool(np.array_equal(arr[:, :, 0], img.astype(np.int32))))


if __name__ == "__main__":
    main()
