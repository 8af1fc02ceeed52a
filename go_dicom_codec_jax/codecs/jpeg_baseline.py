"""JPEG Baseline (Process 1, SOF0) codec — UID 1.2.840.10008.1.2.4.50.

Behavioral parity with reference jpeg/baseline/: 8-bit lossy, grayscale or
RGB→YCbCr 1:1:1 (no subsampling), per-image optimal Huffman tables
(two-pass), fo-dicom-compatible headers (gray component ID 0, RGB IDs
1/2/3, no APP0 — encoder.go:82-257), IJG quality curve, edge-replicated
partial blocks.

Device/host split: the whole MCU grid's DCT+quant+zigzag runs as one device launch
(ops/dct8x8.py); symbol-stream assembly and bit packing are vectorized
numpy (codecs/jpeg_common.py); decode parses markers host-side, entropy-
decodes sequentially, then dequant+IDCT+color-convert in one device launch.
The decoder also handles subsampled (H,V) streams and restart intervals
(reference decoder.go:359-498 with proper RST predictor resets).
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import jax.numpy as jnp

from .. import uids
from ..codestream import jpeg_markers as mk
from ..entropy import huffman as hf
from ..errors import CorruptStreamError, UnsupportedFormatError
from ..frames import FrameInfo, PixelData, frame_to_array
from ..ops.dct8x8 import (encode_plane_to_zigzag, rgb_to_ycbcr_np,
                          ycbcr_to_rgb_np)
from ..params import Parameters, require_range
from ..registry import Codec, get_global_registry
from . import jpeg_common as jc


class JPEGBaselineParameters(Parameters):
    """Quality 1-100 (reference jpeg/baseline/parameters.go:10-71)."""

    def __init__(self, quality: int = 90, **kw):
        super().__init__(quality=quality, **kw)

    @property
    def quality(self) -> int:
        return int(self.get_parameter("quality", 90))

    def with_quality(self, q: int) -> "JPEGBaselineParameters":
        return self.with_("quality", q)

    def validate(self) -> None:
        require_range("quality", self.quality, 1, 100)


def encode(pixels: bytes | np.ndarray, width: int, height: int,
           components: int, quality: int = 90,
           sof_marker: int = mk.SOF0, precision: int = 8,
           write_jfif: bool = False,
           optimize_huffman: Optional[bool] = None) -> bytes:
    """Byte-level encode (reference jpeg/baseline/encoder.go:26-116).

    precision=12 + sof_marker=SOF1 gives the Extended sequential path
    (reference jpeg/extended/sequential12.go:24-125: mono only, JFIF APP0,
    component ID 1, luma table).

    optimize_huffman: None matches the reference — baseline uses the
    T.81 K.3 standard tables (encoder.go:56-66, no histogram pass),
    Extended 12-bit builds optimal tables (sequential12.go:127-164).
    """
    if width <= 0 or height <= 0:
        raise UnsupportedFormatError("invalid dimensions")
    if components not in (1, 3):
        raise UnsupportedFormatError(f"components={components} not in (1, 3)")
    require_range("quality", quality, 1, 100)

    dt = np.uint8 if precision <= 8 else np.dtype("<u2")
    if isinstance(pixels, (bytes, bytearray, memoryview)):
        arr = np.frombuffer(pixels, dtype=dt,
                            count=width * height * components)
    else:
        arr = np.asarray(pixels, dtype=dt)
    arr = arr.reshape(height, width, components)

    # byte-precision DQT like the reference (sequential12.go:86-91)
    max_q = 255
    qtables = [jc.scale_quant_table(jc.LUMA_QUANT, quality, max_q)]
    if components == 3:
        qtables.append(jc.scale_quant_table(jc.CHROMA_QUANT, quality, max_q))

    level = 1 << (precision - 1)
    plane_tables = [0] if components == 1 else [0, 1, 1]

    # fused native fast path: gray + standard K.3 tables (the default
    # baseline configuration) runs DCT+quant+Huffman in ONE native call
    # per frame — coefficient blocks never leave L1
    if (components == 1 and precision <= 8
            and (optimize_huffman is None or optimize_huffman is False)):
        from ..native import jpg_encode_frame_native
        plane = (arr[:, :, 0] if isinstance(pixels,
                                            (bytes, bytearray, memoryview))
                 else arr[:, :, 0])
        scan = jpg_encode_frame_native(plane, qtables[0], level,
                                       hf.DC_LUMA, hf.AC_LUMA)
        if scan is not None:
            return _assemble_stream(scan, qtables, [hf.DC_LUMA],
                                    [hf.AC_LUMA], width, height, 1,
                                    precision, sof_marker, write_jfif)

    # Host-native fast path: single-frame DCT+quant never pays a device
    # dispatch round trip (same policy as the J2K 5/3 host fast path in
    # jpeg2000.py).
    from ..native import jpg_fdct_quant_native

    comp_zz = None
    if components == 1:
        planes_np = [arr[:, :, 0]]
    else:
        ycc = rgb_to_ycbcr_np(arr)
        planes_np = [ycc[:, :, i] for i in range(3)]
    native_zz = [jpg_fdct_quant_native(p, qtables[t], level)
                 for p, t in zip(planes_np, plane_tables)]
    if all(z is not None for z in native_zz):
        comp_zz = [z.reshape(-1, 64) for z in native_zz]

    if comp_zz is None:
        # Device stage: color transform + full-grid DCT/quant/zigzag
        comp_zz = []
        for p, t in zip(planes_np, plane_tables):
            zz = np.asarray(encode_plane_to_zigzag(
                jnp.asarray(p.astype(np.int32)), jnp.asarray(qtables[t]),
                level_shift=level))
            comp_zz.append(zz.reshape(-1, 64))

    return encode_from_zigzag(comp_zz, qtables, plane_tables, width,
                              height, components, precision, sof_marker,
                              write_jfif, optimize_huffman)


def encode_from_zigzag(comp_zz, qtables, plane_tables, width: int,
                       height: int, components: int, precision: int = 8,
                       sof_marker: int = mk.SOF0, write_jfif: bool = False,
                       optimize_huffman: Optional[bool] = None) -> bytes:
    """Host stage only: Huffman + framing from precomputed zigzag blocks
    (the device stage may have run batched elsewhere — pipeline.py)."""
    # Host stage: optimal Huffman + entropy coding (native one-pass scan
    # walker first; vectorized numpy pipeline as behavioral reference)
    n_tables = 2 if components == 3 else 1
    from ..native import jpg_encode_scan2_native, jpg_scan_hist_native

    if optimize_huffman is None:
        optimize_huffman = precision > 8
    # K.3 tables only cover 8-bit categories — deeper precisions always
    # build their own tables
    optimize_huffman = optimize_huffman or precision > 8
    scan = None
    if not optimize_huffman:
        # standard K.3 tables, no histogram pass (reference baseline)
        dc_tabs = [hf.DC_LUMA, hf.DC_CHROMA][:n_tables]
        ac_tabs = [hf.AC_LUMA, hf.AC_CHROMA][:n_tables]
        scan = jpg_encode_scan2_native(comp_zz, plane_tables, dc_tabs,
                                       ac_tabs)
        if scan is None:
            stream = jc.build_scan_symbols(comp_zz, plane_tables)
            scan = jc.encode_scan(stream, dc_tabs, ac_tabs)
    if scan is None and optimize_huffman:
        hist = jpg_scan_hist_native(comp_zz, plane_tables)
        if hist is not None:
            dc_freq, ac_freq = hist
            dc_tabs = [hf.build_optimal_table(dc_freq[t])
                       for t in range(n_tables)]
            ac_tabs = [hf.build_optimal_table(ac_freq[t])
                       for t in range(n_tables)]
            scan = jpg_encode_scan2_native(comp_zz, plane_tables, dc_tabs,
                                           ac_tabs)
    if scan is None:
        stream = jc.build_scan_symbols(comp_zz, plane_tables)
        dc_freq, ac_freq = jc.count_frequencies(stream, n_tables)
        dc_tabs = [hf.build_optimal_table(dc_freq[t])
                   for t in range(n_tables)]
        ac_tabs = [hf.build_optimal_table(ac_freq[t])
                   for t in range(n_tables)]
        scan = jc.encode_scan(stream, dc_tabs, ac_tabs)

    return _assemble_stream(scan, qtables, dc_tabs, ac_tabs, width,
                            height, components, precision, sof_marker,
                            write_jfif)


def _assemble_stream(scan: bytes, qtables, dc_tabs, ac_tabs, width: int,
                     height: int, components: int, precision: int,
                     sof_marker: int, write_jfif: bool) -> bytes:
    """SOI..EOI framing around precomputed tables + scan bytes."""
    n_tables = 2 if components == 3 else 1
    w = mk.JpegWriter()
    w.write_marker(mk.SOI)
    if write_jfif:
        w.write_segment(mk.APP0,
                        b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for t in range(n_tables):
        w.write_segment(mk.DQT, jc.dqt_payload(t, qtables[t]))
    if components == 1:
        # fo-dicom gray component ID 0 for baseline; ID 1 for 12-bit SOF1
        cid = 0 if sof_marker == mk.SOF0 else 1
        sof_comps = [(cid, 1, 1, 0)]
        sos_comps = [(cid, 0, 0)]
    else:
        sof_comps = [(1, 1, 1, 0), (2, 1, 1, 1), (3, 1, 1, 1)]
        sos_comps = [(1, 0, 0), (2, 1, 1), (3, 1, 1)]
    w.write_segment(sof_marker,
                    jc.sof_payload(precision, width, height, sof_comps))
    dht = [(0, t, dc_tabs[t]) for t in range(n_tables)]
    dht += [(1, t, ac_tabs[t]) for t in range(n_tables)]
    w.write_segment(mk.DHT, hf.dht_payload(dht))
    w.write_segment(mk.SOS, jc.sos_payload(sos_comps))
    w.write_bytes(scan)
    w.write_marker(mk.EOI)
    return w.get_bytes()


def decode(data: bytes,
           expected_sofs: Tuple[int, ...] = (mk.SOF0,),
           max_precision: int = 8):
    """Byte-level decode → (pixels bytes, width, height, components).

    Mirrors reference jpeg/baseline/decoder.go:40-111's marker loop.
    """
    r = mk.JpegReader(data)
    if r.read_marker() != mk.SOI:
        raise CorruptStreamError("missing SOI")

    qtables: Dict[int, np.ndarray] = {}
    dc_tables: Dict[int, hf.HuffmanTable] = {}
    ac_tables: Dict[int, hf.HuffmanTable] = {}
    restart = 0
    frame = None  # (precision, W, H, [(id, h, v, tq)])
    scan_info = None

    while True:
        marker = r.read_marker()
        if marker in expected_sofs:
            p = r.read_segment()
            if len(p) < 6:
                raise CorruptStreamError("truncated SOF header")
            precision = p[0]
            if precision > max_precision:
                raise UnsupportedFormatError(
                    f"unsupported precision {precision}")
            h = (p[1] << 8) | p[2]
            w = (p[3] << 8) | p[4]
            nc = p[5]
            if w < 1 or h < 1 or nc < 1:
                raise CorruptStreamError("invalid SOF dimensions")
            if len(p) < 6 + nc * 3:
                raise CorruptStreamError("truncated SOF component table")
            comps = []
            for i in range(nc):
                off = 6 + i * 3
                ch, cv = p[off + 1] >> 4, p[off + 1] & 0x0F
                if not (1 <= ch <= 4 and 1 <= cv <= 4):  # T.81 B.2.2
                    raise CorruptStreamError(
                        f"invalid sampling factors {ch}x{cv}")
                comps.append((p[off], ch, cv, p[off + 2]))
            frame = (precision, w, h, comps)
        elif marker in (mk.SOF1, mk.SOF2, mk.SOF3, mk.SOF5, mk.SOF6, mk.SOF7,
                        mk.SOF9, mk.SOF10, mk.SOF11, mk.SOF13, mk.SOF14,
                        mk.SOF15, mk.SOF0, mk.SOF55):
            raise UnsupportedFormatError(
                f"unsupported SOF marker 0x{marker:02X} for this codec")
        elif marker == mk.DQT:
            jc.parse_dqt(r.read_segment(), qtables)
        elif marker == mk.DHT:
            for cls, tid, tab in hf.parse_dht(r.read_segment()):
                (dc_tables if cls == 0 else ac_tables)[tid] = tab
        elif marker == mk.DRI:
            p = r.read_segment()
            restart = (p[0] << 8) | p[1]
        elif marker == mk.SOS:
            p = r.read_segment()
            if len(p) < 1 or len(p) < 1 + p[0] * 2:
                raise CorruptStreamError("truncated SOS header")
            ns = p[0]
            sel = []
            for i in range(ns):
                sel.append((p[1 + i * 2], p[2 + i * 2] >> 4,
                            p[2 + i * 2] & 0x0F))
            scan_info = sel
            scan_bytes, _ = r.find_scan_end()
            break
        elif marker == mk.EOI:
            raise CorruptStreamError("EOI before scan data")
        else:
            if mk.has_length(marker):
                r.read_segment()

    if frame is None or scan_info is None:
        raise CorruptStreamError("missing SOF/SOS")
    precision, width, height, comps = frame
    max_h = max(c[1] for c in comps)
    max_v = max(c[2] for c in comps)
    mcu_cols = -(-width // (8 * max_h))
    mcu_rows = -(-height // (8 * max_v))

    layout = []
    order = []
    for cid, td, ta in scan_info:
        match = [c for c in comps if c[0] == cid]
        if not match:
            raise CorruptStreamError(f"scan references unknown component {cid}")
        _, ch, cv, tq = match[0]
        layout.append((ch, cv, td, ta, mcu_cols * ch))
        order.append((ch, cv, tq))

    comp_zz = jc.decode_scan(scan_bytes, layout, dc_tables, ac_tables,
                             mcu_cols, mcu_rows, restart)

    # Dequant + IDCT + clamp per component (host-native fast path, else
    # one device launch), then upsample
    planes = []
    for (ch, cv, tq), zz in zip(order, comp_zz):
        if tq not in qtables:
            raise CorruptStreamError(f"missing quant table {tq}")
        planes.append(jc.idct_and_assemble(
            zz.reshape(mcu_rows * cv, mcu_cols * ch, 64), qtables[tq],
            precision, ch, cv, max_h, max_v, height, width))

    nc = len(planes)
    if nc == 1:
        out = planes[0].astype(np.uint8 if precision == 8 else "<u2")
        return out.tobytes(), width, height, 1
    ycc = np.stack(planes, axis=-1).astype(np.uint8)
    return ycbcr_to_rgb_np(ycc).tobytes(), width, height, 3


class JPEGBaselineCodec(Codec):
    """Registry adapter (reference jpeg/baseline/codec.go:14-188)."""

    def __init__(self, quality: int = 90):
        self._quality = quality if 1 <= quality <= 100 else 90

    def name(self) -> str:
        return f"JPEG Baseline (Quality {self._quality})"

    def transfer_syntax(self) -> str:
        return uids.JPEG_BASELINE_8BIT

    def get_default_parameters(self) -> Parameters:
        return JPEGBaselineParameters(quality=self._quality)

    def encode(self, old_pixel_data: PixelData, new_pixel_data: PixelData,
               parameters: Optional[Parameters] = None) -> None:
        info = old_pixel_data.get_frame_info()
        if info.bits_stored > 8:
            raise UnsupportedFormatError(
                f"JPEG Baseline only supports 8-bit data, got "
                f"{info.bits_stored} bits")
        q = self._quality
        if parameters is not None:
            qv = parameters.get_parameter("quality")
            if isinstance(qv, int) and 1 <= qv <= 100:
                q = qv
        nframes = old_pixel_data.frame_count()
        if nframes > 1 and info.samples_per_pixel == 1:
            # batched multi-frame path: device DCT for chunk k+1 overlaps
            # host Huffman for chunk k when the measured transfer policy
            # prefers the device; otherwise the per-frame native DCT below
            from ..pipeline import (encode_frames_pipelined_jpeg,
                                    prefer_batched_device)

            if prefer_batched_device():
                frames = np.stack([
                    np.frombuffer(old_pixel_data.get_frame(i),
                                  dtype=np.uint8).reshape(
                                      info.height, info.width)
                    for i in range(nframes)])
                for stream in encode_frames_pipelined_jpeg(frames,
                                                           quality=q):
                    new_pixel_data.add_frame(stream)
                return
        for i in range(nframes):
            frame = old_pixel_data.get_frame(i)
            if info.samples_per_pixel == 3 and info.planar_configuration == 1:
                frame = np.ascontiguousarray(
                    frame_to_array(frame, info)).tobytes()
            new_pixel_data.add_frame(encode(
                frame, info.width, info.height, info.samples_per_pixel, q))

    def decode(self, old_pixel_data: PixelData, new_pixel_data: PixelData,
               parameters: Optional[Parameters] = None) -> None:
        for i in range(old_pixel_data.frame_count()):
            data = old_pixel_data.get_frame(i)
            try:
                pixels, _, _, _ = decode(data)
            except UnsupportedFormatError as exc:
                # third-party .50 streams are occasionally progressive;
                # the reference decodes those through Go stdlib
                # image/jpeg in its Extended path — accept them here too
                from . import jpeg_progressive as jp

                try:
                    pixels, _, _, _ = jp.decode(data)
                except Exception:
                    raise exc
            new_pixel_data.add_frame(pixels)


def register() -> None:
    get_global_registry().register_codec(uids.JPEG_BASELINE_8BIT,
                                         JPEGBaselineCodec())
