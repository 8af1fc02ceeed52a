"""File-level transcoder across every supported compressed format.

Beyond the reference's cmd/ surface (it ships only the interop
validator and benchmarks; transcoding requires writing Go): sniff any
supported input — raw codestream or JP2/JPH file, any JPEG family
SOF0/SOF1/SOF2/SOF3/SOF55 stream, RLE (with geometry flags), .npy, or
raw samples — decode it, and re-encode to any target format, optionally
wrapping J2K/HTJ2K output in a JP2/JPH container.

Usage:
    python -m go_dicom_codec_jax.tools.transcode IN OUT --to TARGET
        [--width W --height H --bits N --samples S --signed]  # raw/RLE in
        [--quality Q] [--near N] [--predictor P] [--ilv I]
        [--container jp2|jph] [--lossless-levels N]

TARGET aliases: rle, baseline, extended, p14, sv1, jls, jls-near,
j2k, j2k-lossy, htj2k, htj2k-lossy, npy, raw — or a DICOM transfer
syntax UID.

Prints one TRANSCODE| JSON line; exit 0 on success.
"""

from __future__ import annotations

import argparse
import io
import json
import struct
import sys
from typing import Optional, Tuple

import numpy as np

# (pixels bytes <u1/<u2, width, height, components, bit_depth, signed)
Decoded = Tuple[bytes, int, int, int, int, bool]


def _jp2_magic() -> bytes:
    from ..codestream.j2k import _JP2_SIGNATURE
    return _JP2_SIGNATURE

ALIASES = {
    "rle": "1.2.840.10008.1.2.5",
    "baseline": "1.2.840.10008.1.2.4.50",
    "jpeg": "1.2.840.10008.1.2.4.50",
    "extended": "1.2.840.10008.1.2.4.51",
    "p14": "1.2.840.10008.1.2.4.57",
    "sv1": "1.2.840.10008.1.2.4.70",
    "jls": "1.2.840.10008.1.2.4.80",
    "jls-near": "1.2.840.10008.1.2.4.81",
    "j2k": "1.2.840.10008.1.2.4.90",
    "j2k-lossy": "1.2.840.10008.1.2.4.91",
    "htj2k": "1.2.840.10008.1.2.4.201",
    "htj2k-lossy": "1.2.840.10008.1.2.4.203",
}


def sniff(data: bytes) -> str:
    """Input format key from magic bytes."""
    if data.startswith(_jp2_magic()):
        return "j2k"
    if len(data) >= 4 and data[:2] == b"\xff\x4f" and data[2:4] == b"\xff\x51":
        return "j2k"
    if data.startswith(b"\x93NUMPY"):
        return "npy"
    if len(data) >= 2 and data[:2] == b"\xff\xd8":
        # first SOF marker decides the JPEG family
        pos = 2
        while pos + 4 <= len(data):
            if data[pos] != 0xFF:
                break
            m = data[pos + 1]
            if m in (0xC0, 0xC2):
                return "jpeg-dct"        # baseline / progressive
            if m == 0xC1:
                return "jpeg-extended"
            if m == 0xC3:
                return "jpeg-lossless"
            if m == 0xF7:
                return "jpeg-ls"
            if m in (0x01,) or 0xD0 <= m <= 0xD9:
                pos += 2
                continue
            pos += 4 + struct.unpack_from(">H", data, pos + 2)[0] - 2
        return "jpeg-dct"
    # PS3.5 Annex G RLE header: u32le segment count in [1, 15]
    if len(data) >= 64 and 1 <= struct.unpack_from("<I", data, 0)[0] <= 15:
        return "rle"
    return "raw"


def _frame_info(w: int, h: int, comps: int, depth: int):
    from ..frames import FrameInfo
    return FrameInfo(width=w, height=h,
                     bits_allocated=8 if depth <= 8 else 16,
                     bits_stored=depth, samples_per_pixel=comps,
                     photometric_interpretation="RGB" if comps == 3
                     else "MONOCHROME2")


def decode_any(data: bytes, *, width: int = 0, height: int = 0,
               bits: int = 0, samples: int = 1, signed: bool = False,
               kind: Optional[str] = None) -> Decoded:
    """Decode any sniffable input to raw little-endian samples.

    kind overrides the magic-byte sniff — needed when raw pixel data
    happens to look like an RLE header (--from raw)."""
    kind = kind or sniff(data)
    if kind == "j2k":
        from ..codecs.jpeg2000 import decode_to_pixels
        return decode_to_pixels(data)
    if kind in ("jpeg-dct", "jpeg-extended"):
        # jpeg_extended.decode dispatches SOF0/SOF1/SOF2 itself
        from ..codecs import jpeg_extended
        px, w, h, c, d = jpeg_extended.decode(data)
        return px, w, h, c, d, False
    if kind == "jpeg-lossless":
        from ..codecs import jpeg_lossless
        px, w, h, c, d = jpeg_lossless.decode(data)
        return px, w, h, c, d, False
    if kind == "jpeg-ls":
        from ..codecs import jpegls
        px, w, h, c, d, _near = jpegls.decode(data)
        return px, w, h, c, d, False
    if kind == "npy":
        arr = np.load(io.BytesIO(data))
        if arr.ndim == 2:
            arr = arr[..., None]
        if arr.ndim != 3:
            raise ValueError(f"npy must be [H,W] or [H,W,C], got {arr.shape}")
        sgn = arr.dtype.kind == "i"
        depth = bits or (8 if arr.dtype.itemsize == 1 else 16)
        dt = ((np.int8 if sgn else np.uint8) if depth <= 8
              else np.dtype("<i2" if sgn else "<u2"))
        h, w, c = arr.shape
        return (np.ascontiguousarray(arr.astype(dt)).tobytes(),
                w, h, c, depth, sgn)
    # rle / raw need explicit geometry
    if not (width and height and bits):
        raise ValueError(
            f"{kind} input needs --width/--height/--bits")
    if kind == "rle":
        from ..codecs import rle
        info = _frame_info(width, height, samples, bits)
        return (rle.decode_frame(data, info), width, height, samples,
                bits, signed)
    return data, width, height, samples, bits, signed


def encode_any(target: str, dec: Decoded, *, quality: int = 90,
               near: int = 3, predictor: int = 0, ilv: Optional[int] = None,
               container: Optional[str] = None,
               lossless_levels: int = 5) -> bytes:
    px, w, h, c, depth, signed = dec
    uid = ALIASES.get(target, target)
    if container and not (uid.startswith("1.2.840.10008.1.2.4.9")
                          or uid.startswith("1.2.840.10008.1.2.4.2")):
        raise ValueError("--container applies to J2K/HTJ2K targets only")
    if target == "npy":
        dt = ((np.int8 if signed else np.uint8) if depth <= 8
              else np.dtype("<i2" if signed else "<u2"))
        arr = np.frombuffer(px, dtype=dt).reshape(h, w, c)
        buf = io.BytesIO()
        np.save(buf, np.squeeze(arr))
        return buf.getvalue()
    if target == "raw":
        return px
    if uid == ALIASES["rle"]:
        from ..codecs import rle
        return rle.encode_frame(px, _frame_info(w, h, c, depth))
    # JPEG-family coders are unsigned: signed samples travel as raw
    # two's-complement CONTAINER bytes at the container width (the
    # reference adapters' documented signed policy for JLS/SV1) —
    # values like int16 -1 would otherwise overflow a <16-bit range
    jdepth = depth if not signed else (8 if depth <= 8 else 16)
    if uid == ALIASES["baseline"]:
        from ..codecs import jpeg_baseline
        if jdepth > 8:
            raise ValueError(
                f"baseline JPEG is 8-bit; input is {jdepth}-bit "
                "(use --to extended, jls or a J2K target)")
        return jpeg_baseline.encode(px, w, h, c, quality)
    if uid == ALIASES["extended"]:
        from ..codecs import jpeg_extended
        if jdepth > 12:
            raise ValueError(
                f"extended JPEG is 12-bit; input is {jdepth}-bit "
                "(use --to jls, p14 or a J2K target)")
        return jpeg_extended.encode(px, w, h, c, 12 if jdepth > 8 else 8,
                                    quality)
    if uid in (ALIASES["p14"], ALIASES["sv1"]):
        from ..codecs import jpeg_lossless
        pred = 1 if uid == ALIASES["sv1"] else predictor
        return jpeg_lossless.encode(px, w, h, c, jdepth, predictor=pred)
    if uid in (ALIASES["jls"], ALIASES["jls-near"]):
        from ..codecs import jpegls
        nr = near if uid == ALIASES["jls-near"] else 0
        return jpegls.encode(px, w, h, c, jdepth, near=nr, ilv=ilv)
    if uid in (ALIASES["j2k"], ALIASES["j2k-lossy"], ALIASES["htj2k"],
               ALIASES["htj2k-lossy"], "1.2.840.10008.1.2.4.92",
               "1.2.840.10008.1.2.4.93", "1.2.840.10008.1.2.4.202"):
        from ..codecs.jpeg2000 import J2KEncodeParams, J2KEncoder
        lossy = uid in ("1.2.840.10008.1.2.4.91", "1.2.840.10008.1.2.4.93",
                        "1.2.840.10008.1.2.4.203")
        ht = uid.startswith("1.2.840.10008.1.2.4.20")
        p = J2KEncodeParams(lossless=not lossy, quality=quality, htj2k=ht,
                            num_levels=lossless_levels, container=container)
        dt = ((np.int8 if signed else np.uint8) if depth <= 8
              else np.dtype("<i2" if signed else "<u2"))
        arr = np.frombuffer(px, dtype=dt)
        return J2KEncoder(p).encode(arr, w, h, c, depth, signed=signed)
    raise ValueError(f"unknown target {target!r}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Transcode between supported image codecs")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument("--to", required=True, help="target alias or UID")
    ap.add_argument("--from", dest="from_kind", default=None,
                    choices=("j2k", "jpeg-dct", "jpeg-extended",
                             "jpeg-lossless", "jpeg-ls", "rle", "npy",
                             "raw"),
                    help="override input sniffing (e.g. raw samples "
                         "whose first bytes look like an RLE header)")
    ap.add_argument("--width", type=int, default=0)
    ap.add_argument("--height", type=int, default=0)
    ap.add_argument("--bits", type=int, default=0)
    ap.add_argument("--samples", type=int, default=1)
    ap.add_argument("--signed", action="store_true")
    ap.add_argument("--quality", type=int, default=90)
    ap.add_argument("--near", type=int, default=3)
    ap.add_argument("--predictor", type=int, default=0)
    ap.add_argument("--ilv", type=int, default=None)
    ap.add_argument("--container", choices=("jp2", "jph"), default=None)
    ap.add_argument("--lossless-levels", type=int, default=5)
    args = ap.parse_args(argv)

    data = open(args.input, "rb").read()
    kind = args.from_kind or sniff(data)
    dec = decode_any(data, width=args.width, height=args.height,
                     bits=args.bits, samples=args.samples,
                     signed=args.signed, kind=kind)
    out = encode_any(args.to, dec, quality=args.quality, near=args.near,
                     predictor=args.predictor, ilv=args.ilv,
                     container=args.container,
                     lossless_levels=args.lossless_levels)
    with open(args.output, "wb") as f:
        f.write(out)
    print("TRANSCODE|" + json.dumps({
        "from": kind, "to": args.to,
        "width": dec[1], "height": dec[2], "components": dec[3],
        "bit_depth": dec[4], "in_bytes": len(data), "out_bytes": len(out)}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
