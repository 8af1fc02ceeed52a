"""DICOM pixel-data codec framework on JAX.

A from-scratch JAX re-implementation of the capability surface of
``cocosip/go-dicom-codec`` (reference: /root/reference): RLE Lossless, JPEG
(Baseline / Extended / Lossless P14 / Lossless SV1), JPEG-LS (lossless and
near-lossless), JPEG 2000 Part 1 (lossless 5/3 + lossy 9/7) and Part 2 MCT,
and HTJ2K — addressable through a transfer-syntax-UID codec registry.

Architecture (accelerator-first, not a port):
  - ``ops/``        batched device transforms (jnp under XLA): DCT, DWT,
                    RCT/ICT, LOCO-I wavefront, byte-plane transforms.
  - ``entropy/``    host-side sequential entropy coders (Huffman, MQ,
                    Golomb-Rice, PackBits, MEL/VLC).
  - ``codestream/`` marker-level IO (JPEG markers, J2K codestream).
  - ``t2/``         JPEG 2000 Tier-2 (tag trees, packets, progressions).
  - ``codecs/``     transfer-syntax adapters wiring kernels + entropy.
  - ``parallel/``   frame/tile batching, meshes, pjit/shard_map scale-out.

Reference layer map: see SURVEY.md §1 and /root/reference layering
(registry → adapter → core → primitives); our registry mirrors the external
``go-dicom`` codec contract proven at reference rle/rle.go:18-84.
"""

from .errors import (
    CodecError,
    CodecNotFoundError,
    CorruptStreamError,
    InvalidParameterError,
    InvalidQualityError,
    UnsupportedFormatError,
)
from .frames import FrameInfo, MemoryPixelData, PixelData
from .params import Parameters
from .registry import Codec, CodecRegistry, get_global_registry
from . import uids

__version__ = "0.1.0"


def register_all_codecs() -> None:
    """Register every built-in codec with the global registry.

    Mirrors the reference's per-package ``init()`` self-registration
    (e.g. reference rle/rle.go:417, jpeg2000/lossless/codec.go:306-322),
    but explicit rather than import-side-effect driven.
    """
    from .codecs import register_builtin_codecs

    register_builtin_codecs()


# Register on import, like the reference's blank-import pattern
# (reference examples/dicom_transcoder/main.go:10-20).
register_all_codecs()

__all__ = [
    "CodecError",
    "CodecNotFoundError",
    "CorruptStreamError",
    "InvalidParameterError",
    "InvalidQualityError",
    "UnsupportedFormatError",
    "FrameInfo",
    "PixelData",
    "MemoryPixelData",
    "Parameters",
    "Codec",
    "CodecRegistry",
    "get_global_registry",
    "register_all_codecs",
    "uids",
]
