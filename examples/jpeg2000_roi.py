"""Region-of-interest encoding demo (role of reference
examples/jpeg2000_roi): MaxShift and General Scaling, rectangle and
polygon regions, quality comparison under truncation.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from go_dicom_codec_jax.codecs.j2k_roi import ROIRegion
from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder, J2KEncodeParams,
                                                J2KEncoder)


def main() -> None:
    rng = np.random.default_rng(0)
    img = rng.integers(0, 4096, size=(128, 128)).astype("<u2")
    roi = ROIRegion(shape="rect", rect=(40, 40, 48, 48))
    mask = np.zeros((128, 128), bool)
    mask[40:88, 40:88] = True

    # MaxShift: decoder needs no side info (magnitude threshold)
    enc = J2KEncoder(J2KEncodeParams(num_levels=2, num_layers=2,
                                     layer_rates=[16.0, 0],
                                     roi_regions=[roi]))
    data = enc.encode(img.tobytes(), 128, 128, 1, 12, False)
    cut = int(128 * 128 * 12 / 8 / 16) + 160
    arr, _, _ = J2KDecoder(resilient=True).decode(data[:cut])
    d = np.abs(arr[:, :, 0].astype(float) - img.astype(float))
    print(f"MaxShift @ layer-0 cut: roi_err={d[mask].mean():.1f} "
          f"bg_err={d[~mask].mean():.1f} (full stream {len(data)}B lossless)")

    # General Scaling: arbitrary shift, geometry rides in a JP2ROI COM
    enc_gs = J2KEncoder(J2KEncodeParams(num_levels=2, roi_regions=[roi],
                                        roi_style="general", roi_shift=4))
    data_gs = enc_gs.encode(img.tobytes(), 128, 128, 1, 12, False)
    arr_gs, _, _ = J2KDecoder().decode(data_gs)
    print("General Scaling lossless:",
          bool(np.array_equal(arr_gs[:, :, 0], img.astype(np.int32))),
          f"({len(data_gs)}B)")

    # polygon-shaped region
    poly = ROIRegion(shape="polygon",
                     polygon=[(30, 20), (100, 45), (60, 110)])
    data_p = J2KEncoder(J2KEncodeParams(num_levels=2, roi_regions=[poly])
                        ).encode(img.tobytes(), 128, 128, 1, 12, False)
    arr_p, _, _ = J2KDecoder().decode(data_p)
    print("Polygon MaxShift lossless:",
          bool(np.array_equal(arr_p[:, :, 0], img.astype(np.int32))))


if __name__ == "__main__":
    main()
