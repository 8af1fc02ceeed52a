"""Sweep every registered transfer syntax (reference examples/all_codecs)."""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import go_dicom_codec_jax as dc


def main():
    rng = np.random.default_rng(1)
    reg = dc.get_global_registry()
    for uid in reg.registered_transfer_syntaxes():
        codec = reg.get_codec(uid)
        bits = 8 if "4.50" in uid or "4.81" in uid or uid.endswith(".203") \
            else 12
        info = dc.FrameInfo(width=64, height=64,
                            bits_allocated=8 if bits == 8 else 16,
                            bits_stored=bits)
        maxv = (1 << bits) - 1
        dt = np.uint8 if bits == 8 else np.dtype("<u2")
        img = (np.cumsum(rng.integers(-5, 6, (64, 64)), axis=1)
               % (maxv + 1)).astype(dt)
        src = dc.MemoryPixelData(info=info)
        src.add_frame(img.tobytes())
        enc = dc.MemoryPixelData(info=info, encapsulated=True)
        dec = dc.MemoryPixelData(info=info)
        try:
            codec.encode(src, enc)
            codec.decode(enc, dec)
            got = np.frombuffer(dec.get_frame(0), dtype=dt)
            err = np.abs(got.astype(int) - img.reshape(-1).astype(int)).max()
            ratio = len(src.get_frame(0)) / len(enc.get_frame(0))
            print(f"{uid:26s} {codec.name():42s} "
                  f"ratio={ratio:5.2f}x maxerr={err}")
        except Exception as e:  # noqa: BLE001
            print(f"{uid:26s} {codec.name():42s} ERROR: {e}")


if __name__ == "__main__":
    main()
