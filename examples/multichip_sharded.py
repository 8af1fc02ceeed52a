"""Multi-chip sharded J2K encode AND decode over a jax.sharding.Mesh.

Beyond the reference's example set (it has no distributed layer —
SURVEY.md §2.10): the device transform stage runs frame-sharded across
every chip in the mesh while the host runs the full encoder per frame,
and the codestreams are byte-identical to the single-device scalar
encoder. Runs over every device of the default backend: each GPU of the
host, or, with JAX_PLATFORMS=cpu, the 8 virtual CPU devices that the
XLA flag below provides as a rehearsal without cards.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

os.environ.setdefault("XLA_FLAGS", "--xla_force_host_platform_device_count=8")

import jax

import numpy as np

from go_dicom_codec_jax.codecs.jpeg2000 import (J2KEncodeParams, J2KEncoder,
                                                decode_to_pixels)
from go_dicom_codec_jax.parallel.mesh import (decode_frames_sharded,
                                              encode_frames_sharded,
                                              make_mesh)


def main():
    rng = np.random.default_rng(0)
    print(f"devices: {len(jax.devices())}")
    mesh = make_mesh()

    # 1. grayscale lossless, 6-frame batch
    frames = (np.cumsum(rng.integers(-9, 10, (6, 128, 128)), axis=2)
              % 4096).astype(np.int32)
    streams = encode_frames_sharded(frames, bit_depth=12, levels=4,
                                    mesh=mesh)
    enc = J2KEncoder(J2KEncodeParams(num_levels=4))
    scalar = [enc.encode(frames[i], 128, 128, 1, 12) for i in range(6)]
    assert streams == scalar, "sharded must be byte-identical to scalar"
    raw, *_ = decode_to_pixels(streams[0])
    assert np.array_equal(np.frombuffer(raw, "<u2").reshape(128, 128),
                          frames[0])
    print(f"gray lossless: 6 frames sharded over {len(jax.devices())} "
          f"devices, byte-identical to scalar, "
          f"{sum(map(len, streams))} bytes total")

    # 2. multi-tile RGB with the reversible color transform
    rgb = rng.integers(0, 256, (4, 96, 96, 3)).astype(np.int32)
    p = J2KEncodeParams(num_levels=3, tile_width=48, tile_height=48)
    streams = encode_frames_sharded(rgb, bit_depth=8, mesh=mesh, params=p)
    enc = J2KEncoder(J2KEncodeParams(num_levels=3, tile_width=48,
                                     tile_height=48))
    scalar = [enc.encode(rgb[i], 96, 96, 3, 8) for i in range(4)]
    assert streams == scalar
    print("multi-tile RGB/MCT: 4 frames × 4 tiles sharded, "
          "byte-identical to scalar")

    # 3. lossy 9/7 with quality layers — the full encoder (PCRD, layer
    # allocation, packet headers) runs on precomputed sharded coefficients
    p = J2KEncodeParams(num_levels=3, lossless=False, num_layers=2,
                        layer_rates=[8.0, 0.0])
    streams = encode_frames_sharded(frames[:4], bit_depth=12, mesh=mesh,
                                    params=p)
    raw, *_ = decode_to_pixels(streams[0])
    got = np.frombuffer(raw, "<u2").reshape(128, 128)
    err = np.abs(got.astype(int) - frames[0].astype(int)).max()
    print(f"lossy 9/7 two-layer: decoded maxerr={err} "
          f"({len(streams[0])} bytes vs {frames[0].nbytes} raw)")

    # 4. the decode direction: host entropy per frame, then ONE
    # frame-axis-sharded inverse-transform launch for the whole batch
    streams = encode_frames_sharded(frames, bit_depth=12, mesh=mesh)
    decoded = decode_frames_sharded(streams, mesh=mesh)
    assert all(np.array_equal(d[..., 0], f)
               for d, f in zip(decoded, frames))
    print(f"sharded decode: {len(decoded)} frames inverted in one "
          f"sharded launch, bit-identical to the scalar decoder")


if __name__ == "__main__":
    main()
