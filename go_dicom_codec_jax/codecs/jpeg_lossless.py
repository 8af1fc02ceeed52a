"""JPEG Lossless Process 14 (SOF3) codecs — UIDs .4.57 (all predictors) and
.4.70 (Selection Value 1).

Parity with reference jpeg/lossless/ and jpeg/lossless14sv1/: predictive
coding with the 7 T.81 predictors, boundary defaults 2^(P-1) with the
predictor-1 first-column exception, int16-wrapped differences, category-16
= -32768 with no amplitude bits (huffman_encoder.go:125-133), per-image
optimal Huffman, auto predictor selection by variance
(predictors.go:80-96), headers: JFIF APP0 + SOF3 (IDs 1..n, Tq=0) + one
class-0 DHT + SOS with Ss=predictor.

Device/host split: prediction differences for the whole plane are one vectorized
expression (ops/lossless_predict.py); the category symbol stream is packed
in one numpy pass. Decode separates the serial Huffman stage from the
vectorized reconstruction recurrences.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .. import uids
from ..codestream import jpeg_markers as mk
from ..entropy import huffman as hf
from ..errors import CorruptStreamError, UnsupportedFormatError
from ..frames import FrameInfo, PixelData, frame_to_array
from ..ops.lossless_predict import (encode_diffs, reconstruct,
                                    select_best_predictor)
from ..params import Parameters, require_range
from ..registry import Codec, get_global_registry
from ..utils.npbits import BitReader, destuff_ff, pack_bits_msb, stuff_ff


def _pixels_to_planes(pixels: bytes, width: int, height: int,
                      components: int, precision: int) -> List[np.ndarray]:
    dt = np.uint8 if precision <= 8 else np.dtype("<u2")
    arr = np.frombuffer(pixels, dtype=dt, count=width * height * components)
    # int32 is what the fused native path consumes; the Python
    # encode_diffs/select_best_predictor widen internally
    arr = arr.reshape(height, width, components).astype(np.int32)
    return [arr[:, :, i] for i in range(components)]


def _planes_to_pixels(planes: List[np.ndarray], precision: int) -> bytes:
    dt = np.uint8 if precision <= 8 else np.dtype("<u2")
    if len(planes) == 1:
        return planes[0].astype(dt, copy=False).tobytes()
    # interleave via per-plane strided stores (cheaper than stacking in
    # the wide dtype and converting the whole stack)
    h, w = planes[0].shape
    out = np.empty((h, w, len(planes)), dtype=dt)
    for c, p in enumerate(planes):
        out[:, :, c] = p
    return out.tobytes()


def encode(pixels: bytes, width: int, height: int, components: int,
           bit_depth: int, predictor: int = 1) -> bytes:
    """Byte-level encode (reference jpeg/lossless/encoder.go:24-116).

    predictor: 0 auto-select, 1-7 fixed.
    """
    if width <= 0 or height <= 0:
        raise UnsupportedFormatError("invalid dimensions")
    if components not in (1, 3):
        raise UnsupportedFormatError("components must be 1 or 3")
    if not (2 <= bit_depth <= 16):
        raise UnsupportedFormatError(f"bit depth {bit_depth} out of [2, 16]")
    if not (0 <= predictor <= 7):
        raise UnsupportedFormatError(f"predictor {predictor} out of [0, 7]")

    planes = _pixels_to_planes(pixels, width, height, components, bit_depth)
    if predictor == 0:
        predictor = select_best_predictor(planes, width, height)

    from ..native import (p14_cat_hist_native, p14_diffs_hist_native,
                          p14_pack_scan32_native, p14_pack_scan_native)

    scan = None
    fused = [p14_diffs_hist_native(p, predictor, bit_depth) for p in planes]
    if all(f is not None for f in fused):
        # fused native path: predict+diff+histogram in one pass per
        # plane, single-put int32 packer
        hist = np.sum([f[1] for f in fused], axis=0)
        d32 = (fused[0][0] if len(fused) == 1 else
               np.stack([f[0] for f in fused], axis=-1))
        freq = np.zeros(256, dtype=np.int64)
        freq[:17] = hist
        table = hf.build_optimal_table(freq)
        scan = p14_pack_scan32_native(d32, table.code_of[:17],
                                      table.len_of[:17])
    if scan is None:
        # vectorized diffs per component, interleaved per pixel
        diffs = np.stack([encode_diffs(p, predictor, bit_depth)
                          for p in planes], axis=-1).reshape(-1)
        hist = p14_cat_hist_native(diffs)
        if hist is not None:
            freq = np.zeros(256, dtype=np.int64)
            freq[:17] = hist
            table = hf.build_optimal_table(freq)
            scan = p14_pack_scan_native(diffs, table.code_of[:17],
                                        table.len_of[:17])
    if scan is None:
        cats = hf.categories(diffs)
        ebits = hf.extend_bits(diffs, cats)
        elens = np.where(cats == 16, 0, cats)  # cat 16 ⇒ -32768, no bits
        ebits = np.where(cats == 16, 0, ebits)
        freq = np.bincount(cats, minlength=256)
        table = hf.build_optimal_table(freq)
        codes = table.code_of[cats]
        lens = table.len_of[cats]
        vals = np.stack([codes, ebits], axis=1).reshape(-1)
        vl = np.stack([lens, elens], axis=1).reshape(-1)
        scan = stuff_ff(pack_bits_msb(vals, vl))

    w = mk.JpegWriter()
    w.write_marker(mk.SOI)
    w.write_segment(mk.APP0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    sof = bytearray([bit_depth, height >> 8, height & 0xFF,
                     width >> 8, width & 0xFF, components])
    for i in range(components):
        sof += bytes([i + 1, 0x11, 0])
    w.write_segment(mk.SOF3, bytes(sof))
    w.write_segment(mk.DHT, hf.dht_payload([(0, 0, table)]))
    sos = bytearray([components])
    for i in range(components):
        sos += bytes([i + 1, 0x00])
    sos += bytes([predictor, 0, 0])
    w.write_segment(mk.SOS, bytes(sos))
    w.write_bytes(scan)
    w.write_marker(mk.EOI)
    return w.get_bytes()


def decode(data: bytes):
    """Byte-level decode → (pixels, width, height, components, bit_depth).

    Mirrors reference jpeg/lossless/decoder.go (serial Huffman stage, then
    vectorized reconstruction per component).
    """
    r = mk.JpegReader(data)
    if r.read_marker() != mk.SOI:
        raise CorruptStreamError("missing SOI")
    dc_tables = {}
    frame = None
    predictor = None
    scan_sel = None
    while True:
        marker = r.read_marker()
        if marker == mk.SOF3:
            p = r.read_segment()
            if len(p) < 6:
                raise CorruptStreamError("truncated SOF3 header")
            precision = p[0]
            h = (p[1] << 8) | p[2]
            w = (p[3] << 8) | p[4]
            nc = p[5]
            if w < 1 or h < 1 or nc < 1 or not (2 <= precision <= 16):
                raise CorruptStreamError("invalid SOF3 dimensions")
            if len(p) < 6 + nc * 3:
                raise CorruptStreamError("truncated SOF3 component table")
            comps = [(p[6 + i * 3], p[8 + i * 3]) for i in range(nc)]
            frame = (precision, w, h, comps)
        elif marker == mk.DHT:
            for cls, tid, tab in hf.parse_dht(r.read_segment()):
                if cls == 0:
                    dc_tables[tid] = tab
        elif marker == mk.SOS:
            p = r.read_segment()
            if len(p) < 1 or len(p) < 4 + p[0] * 2:
                raise CorruptStreamError("truncated SOS header")
            ns = p[0]
            scan_sel = [(p[1 + i * 2], p[2 + i * 2] >> 4) for i in range(ns)]
            predictor = p[1 + ns * 2]
            # Al = point transform Pt (T.81 H.1: samples coded as
            # v >> Pt, predicted from 2^(P-Pt-1); output shifts back)
            point_transform = p[3 + ns * 2] & 0x0F
            scan_bytes, _ = r.find_scan_end()
            break
        elif marker == mk.EOI:
            raise CorruptStreamError("EOI before scan")
        elif marker in (mk.SOF0, mk.SOF1, mk.SOF2, mk.SOF55):
            raise UnsupportedFormatError(
                f"not a lossless P14 stream (SOF 0x{marker:02X})")
        else:
            if mk.has_length(marker):
                r.read_segment()

    if frame is None or predictor is None:
        raise CorruptStreamError("missing SOF3/SOS")
    precision, width, height, comps = frame
    nc = len(comps)
    if not (1 <= predictor <= 7):
        raise CorruptStreamError(f"invalid predictor {predictor}")

    tables = []
    for cid, td in scan_sel:
        if td not in dc_tables:
            raise CorruptStreamError(f"missing Huffman table {td}")
        tables.append(dc_tables[td])

    # serial stage: Huffman-decode every difference
    destuffed = destuff_ff(scan_bytes)
    from ..native import jpg_lossless_decode_scan_native

    tids = [td for (_, td) in scan_sel]
    native = jpg_lossless_decode_scan_native(destuffed, width, height, nc,
                                             tids, dc_tables)
    n = width * height
    if native is not None:
        diffs = native      # int32 — p14_reconstruct takes it as-is, and
        # the Python reconstruct fallback widens internally
    else:
        br = BitReader(destuffed)
        diffs = np.zeros(n * nc, dtype=np.int64)
        for i in range(n * nc):
            t = tables[i % nc]
            cat = t.decode(br)
            if cat == 0:
                continue
            if cat == 16:
                diffs[i] = -32768
            elif cat > 16:
                # corrupted DHT symbol: P14 categories are 0..16
                raise CorruptStreamError(f"invalid SSSS category {cat}")
            else:
                diffs[i] = hf.receive_extend(br.take(cat), cat)

    # vectorized stage: reconstruct each component plane (point
    # transform: reconstruct in the shifted P-Pt domain, shift back up)
    eff_prec = precision - point_transform
    if eff_prec < 1:
        raise CorruptStreamError(
            f"point transform {point_transform} >= precision {precision}")
    planes = []
    d = diffs.reshape(height, width, nc)
    for c in range(nc):
        from ..native import p14_reconstruct_native
        rec = p14_reconstruct_native(d[:, :, c], predictor, eff_prec)
        if rec is None:
            rec = reconstruct(d[:, :, c], predictor, eff_prec)
        if point_transform:
            rec = rec << point_transform
        planes.append(rec)
    return (_planes_to_pixels(planes, precision), width, height, nc,
            precision)


class _LosslessBase(Codec):
    _fixed_predictor: Optional[int] = None

    def __init__(self, predictor: int = 1):
        self._predictor = predictor

    def get_default_parameters(self) -> Parameters:
        return Parameters(predictor=self._effective_predictor(None))

    def _effective_predictor(self, parameters: Optional[Parameters]) -> int:
        if self._fixed_predictor is not None:
            return self._fixed_predictor
        p = self._predictor
        if parameters is not None:
            pv = parameters.get_parameter("predictor")
            if isinstance(pv, int) and 0 <= pv <= 7:
                p = pv
        return p

    def encode(self, old_pixel_data: PixelData, new_pixel_data: PixelData,
               parameters: Optional[Parameters] = None) -> None:
        info = old_pixel_data.get_frame_info()
        pred = self._effective_predictor(parameters)
        for i in range(old_pixel_data.frame_count()):
            frame = old_pixel_data.get_frame(i)
            if info.samples_per_pixel == 3 and info.planar_configuration == 1:
                frame = np.ascontiguousarray(
                    frame_to_array(frame, info)).tobytes()
            new_pixel_data.add_frame(encode(
                frame, info.width, info.height, info.samples_per_pixel,
                info.bits_stored, pred))

    def decode(self, old_pixel_data: PixelData, new_pixel_data: PixelData,
               parameters: Optional[Parameters] = None) -> None:
        for i in range(old_pixel_data.frame_count()):
            pixels, _, _, _, _ = decode(old_pixel_data.get_frame(i))
            new_pixel_data.add_frame(pixels)


class JPEGLosslessP14Codec(_LosslessBase):
    """All 7 predictors (reference jpeg/lossless/codec.go:194-201)."""

    def name(self) -> str:
        return f"JPEG Lossless Process 14 (Predictor {self._predictor})"

    def transfer_syntax(self) -> str:
        return uids.JPEG_LOSSLESS_P14


class JPEGLosslessSV1Codec(_LosslessBase):
    """Selection Value 1 only (reference jpeg/lossless14sv1/codec.go)."""

    _fixed_predictor = 1

    def name(self) -> str:
        return "JPEG Lossless Process 14 SV1"

    def transfer_syntax(self) -> str:
        return uids.JPEG_LOSSLESS_SV1


def register() -> None:
    reg = get_global_registry()
    reg.register_codec(uids.JPEG_LOSSLESS_P14, JPEGLosslessP14Codec())
    reg.register_codec(uids.JPEG_LOSSLESS_SV1, JPEGLosslessSV1Codec())
