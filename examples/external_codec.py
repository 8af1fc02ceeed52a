"""User-registered external codec (role of reference
examples/external_codec/external_codec_usage.go).

Shows the three extension points a user has without touching the
library: (1) registering their own Codec implementation in the global
registry under a private transfer syntax, (2) retrieving and driving it
through the same registry API as the built-ins, and (3) injecting a
custom code-block decoder into the JPEG 2000 decoder
(J2KDecoder.set_block_decoder_factory, reference decoder.go:76).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import zlib

import numpy as np

import go_dicom_codec_jax as dc
from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder, J2KEncodeParams,
                                                J2KEncoder)
from go_dicom_codec_jax.entropy.ebcot import T1Decoder

PRIVATE_UID = "1.2.840.99999.1.2.3.4"


class DeflateCodec(dc.Codec):
    """A complete user codec: byte-shuffled DEFLATE, lossless."""

    def name(self) -> str:
        return "Example External Deflate"

    def transfer_syntax(self) -> str:
        return PRIVATE_UID

    def get_default_parameters(self):
        return dc.Parameters(level=6)

    def encode(self, old_pixel_data, new_pixel_data, parameters=None):
        level = int((parameters or self.get_default_parameters())
                    .get_parameter("level", 6))
        for i in range(old_pixel_data.frame_count()):
            new_pixel_data.add_frame(
                zlib.compress(old_pixel_data.get_frame(i), level))

    def decode(self, old_pixel_data, new_pixel_data, parameters=None):
        for i in range(old_pixel_data.frame_count()):
            new_pixel_data.add_frame(
                zlib.decompress(old_pixel_data.get_frame(i)))


class CountingT1Factory:
    """Custom block decoder for J2KDecoder: wraps the stock T1 and
    counts code-block invocations (a real user would plug in their own
    HT or hardware decoder here)."""

    def __init__(self):
        self.calls = 0

    def __call__(self, width, height, style, orient):
        self.calls += 1
        inner = T1Decoder(width, height, style=style, orientation=orient)

        class _Dec:
            def decode(_self, stream, num_passes, numbps, seg_lengths=None,
                       mb=None):
                return inner.decode(stream, num_passes, numbps,
                                    seg_lengths=seg_lengths)

        return _Dec()


def main():
    rng = np.random.default_rng(0)
    frame = (np.cumsum(rng.integers(-9, 10, (128, 128)), axis=1)
             % 4096).astype("<u2")
    info = dc.FrameInfo(width=128, height=128, bits_allocated=16,
                        bits_stored=12)

    # 1) register the external codec
    registry = dc.get_global_registry()
    registry.register_codec(PRIVATE_UID, DeflateCodec())

    # 2) drive it through the registry like any built-in
    codec = registry.get_codec(PRIVATE_UID)
    src = dc.MemoryPixelData(info=info)
    src.add_frame(frame.tobytes())
    enc = dc.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc, dc.Parameters(level=9))
    dec = dc.MemoryPixelData(info=info)
    codec.decode(enc, dec)
    assert dec.get_frame(0) == src.get_frame(0)
    print(f"{codec.name()}: {len(src.get_frame(0))} -> "
          f"{len(enc.get_frame(0))} bytes, lossless roundtrip OK")

    # 3) inject a custom block decoder into the J2K decoder
    stream = J2KEncoder(J2KEncodeParams(lossless=True)).encode(
        frame.tobytes(), 128, 128, 1, 12, False)
    factory = CountingT1Factory()
    decoder = J2KDecoder()
    decoder.set_block_decoder_factory(factory)
    arr, _siz, _cod = decoder.decode(stream)
    assert np.array_equal(arr[:, :, 0].astype("<u2"), frame)
    print(f"custom block decoder handled {factory.calls} code-blocks, "
          f"decode bit-exact")


if __name__ == "__main__":
    main()
