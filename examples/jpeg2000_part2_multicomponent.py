"""Part 2 custom multi-component transform demo (role of reference
examples/jpeg2000_part2_multicomponent): a user matrix carried in
MCT/MCC/MCO markers, built with the fluent MCTBindingBuilder.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder, J2KEncodeParams,
                                                J2KEncoder)
from go_dicom_codec_jax.codecs.mct_builder import MCTBindingBuilder


def main() -> None:
    rng = np.random.default_rng(0)
    rgb = rng.integers(0, 256, size=(128, 128, 3)).astype(np.uint8)

    # a custom decorrelation matrix (here: a simple orthonormal-ish mix)
    m = [[0.5, 0.25, 0.25],
         [-0.5, 0.5, 0.0],
         [0.0, -0.5, 0.5]]
    params = J2KEncodeParams(num_levels=3, lossless=False, quality=80)
    (MCTBindingBuilder()
        .components([0, 1, 2])
        .matrix(m)                 # inverse derived automatically
        .offsets([0.0, 0.0, 0.0])
        .apply_to(params))

    enc = J2KEncoder(params)
    data = enc.encode(rgb.tobytes(), 128, 128, 3, 8, False)
    arr, _, _ = J2KDecoder().decode(data)
    err = np.abs(arr.astype(float) - rgb.astype(float)).mean()
    print(f"custom-MCT lossy stream: {len(data)} bytes, mean |err| = "
          f"{err:.2f}")

    # the markers round-trip: a fresh decoder recovers the inverse from
    # the MCT/MCC/MCO segments — no side channel needed
    from go_dicom_codec_jax.codestream import j2k
    cs = j2k.parse_codestream(data)
    print(f"markers present: MCT={len(cs.mct_segments)} "
          f"MCC={len(cs.mcc_segments)} MCO={len(cs.mco_segments)}")


if __name__ == "__main__":
    main()
