"""JPEG 2000 feature tour: ROI, progression orders, layers, Part 2 MCT.

(Role of reference examples/jpeg2000_roi, jpeg2000_progressive,
jpeg2000_part2_mc.)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from go_dicom_codec_jax.codecs.j2k_roi import ROIRegion
from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder, J2KEncodeParams,
                                                J2KEncoder, decode_to_pixels)
from go_dicom_codec_jax.codestream import j2k


def main():
    rng = np.random.default_rng(0)
    img = (np.cumsum(rng.integers(-9, 10, (128, 128)), axis=1)
           % 4096).astype("<u2")

    # 1. ROI (MaxShift on a rectangle + polygon)
    data = J2KEncoder(J2KEncodeParams(num_levels=3, roi_regions=[
        ROIRegion(shape="rect", rect=(32, 32, 48, 48)),
        ROIRegion(shape="polygon", polygon=[(90, 10), (120, 40), (90, 70)]),
    ])).encode(img.tobytes(), 128, 128, 1, 12)
    pix, *_ = decode_to_pixels(data)
    print(f"ROI MaxShift: {len(data)} bytes, lossless="
          f"{pix == img.tobytes()}")

    # 2. all five progression orders
    for prog in range(5):
        data = J2KEncoder(J2KEncodeParams(num_levels=2, progression=prog)
                          ).encode(img.tobytes(), 128, 128, 1, 12)
        pix, *_ = decode_to_pixels(data)
        print(f"progression {j2k.PROG_NAMES[prog]}: "
              f"lossless={pix == img.tobytes()}")

    # 3. quality layers with rate targets + truncated decode
    data = J2KEncoder(J2KEncodeParams(num_levels=3, num_layers=3,
                                      layer_rates=[32.0, 8.0, 0])
                      ).encode(img.tobytes(), 128, 128, 1, 12)
    for frac in (0.3, 0.7, 1.0):
        arr, _, _ = J2KDecoder(resilient=True).decode(
            data[: int(len(data) * frac)])
        err = np.abs(arr[:, :, 0].astype(float) - img.astype(float)).mean()
        print(f"layered stream at {int(frac * 100)}%: mean err {err:.1f}")

    # 4. Part 2 custom multi-component transform
    rgb = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    M = [[0.6, 0.5, 0.5], [0.5, 0.6, -0.5], [0.5, -0.5, 0.6]]
    data = J2KEncoder(J2KEncodeParams(num_levels=2, mct_matrix=M)
                      ).encode(rgb.tobytes(), 64, 64, 3, 8)
    pix, *_ = decode_to_pixels(data)
    got = np.frombuffer(pix, np.uint8).reshape(64, 64, 3).astype(int)
    print(f"Part 2 MCT: maxerr={np.abs(got - rgb.astype(int)).max()}")

    # 5. packed packet headers + resync + packet-length markers
    data = J2KEncoder(J2KEncodeParams(num_levels=3, packed_headers=True,
                                      use_sop=True, use_eph=True,
                                      plt_markers=True)
                      ).encode(img.tobytes(), 128, 128, 1, 12)
    pix, *_ = decode_to_pixels(data)
    print(f"PPT+SOP+EPH+PLT: {len(data)} bytes, lossless="
          f"{pix == img.tobytes()}")

    # 6. reduced-resolution decode (thumbnail from the same stream)
    data = J2KEncoder(J2KEncodeParams(num_levels=4)
                      ).encode(img.tobytes(), 128, 128, 1, 12)
    for r in (1, 2):
        arr, _, _ = J2KDecoder(reduce=r).decode(data)
        print(f"reduce={r}: {arr.shape[1]}x{arr.shape[0]} thumbnail")

    # 7. damage tolerance: PLT lets reduce/window decode skip packets
    # without reading them; SOP lets resilient decode resync after a
    # corrupt packet instead of dropping everything behind it
    data = J2KEncoder(J2KEncodeParams(num_levels=3, use_sop=True,
                                      plt_markers=True)
                      ).encode(img.tobytes(), 128, 128, 1, 12)
    bad = bytearray(data)
    for i in range(len(bad) - 40, len(bad) - 2):  # wreck the tail
        bad[i] = 0x55
    thumb = J2KDecoder(reduce=2).decode(bytes(bad))[0]
    ok = np.array_equal(thumb, J2KDecoder(reduce=2).decode(data)[0])
    print(f"thumbnail from damaged stream bit-exact={ok}")
    arr = J2KDecoder(resilient=True).decode(bytes(bad))[0]
    print(f"resilient full decode still returns {arr.shape}")


if __name__ == "__main__":
    main()
