"""Device-side encode transform pipelines (the flagship compute step).

The JPEG 2000 lossless encode transform — DC shift → (RCT) → multilevel 5/3
DWT → per-codeblock stats — is the north-star kernel (BASELINE.json): one
jit launch over a whole batch of frames replaces the reference's sequential
tile loop (jpeg2000/encoder.go:1986-2018 writeTiles → transformTile:2213).
"""

from __future__ import annotations

from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp

from .ops.blockstats import codeblock_max_abs, max_bitplane
from .ops.dwt53 import fwd53_multilevel
from .ops.mct import dc_level_shift, rct_forward


def j2k_lossless_encode_transform(frames: jnp.ndarray, levels: int = 5,
                                  bits: int = 16, signed: bool = False,
                                  cb: int = 64):
    """Grayscale J2K lossless device stage: [B, H, W] int32 → coeffs + stats.

    Returns (coeffs [B,H,W] packed-Mallat, cb_max [B,nby,nbx],
    cb_bitplanes [B,nby,nbx]).
    """
    x = dc_level_shift(frames.astype(jnp.int32), bits, signed)
    coeffs = fwd53_multilevel(x, levels)
    m = codeblock_max_abs(coeffs, cb, cb)
    return coeffs, m, max_bitplane(m)


@partial(jax.jit, static_argnames=("levels", "bits", "signed", "cb"))
def j2k_lossless_encode_transform_jit(frames, levels: int = 5, bits: int = 16,
                                      signed: bool = False, cb: int = 64):
    return j2k_lossless_encode_transform(frames, levels, bits, signed, cb)


@partial(jax.jit, static_argnames=("bits", "signed", "lv", "narrow"))
def _pipeline_device_stage(x, bits, signed, lv, narrow=False):
    c = fwd53_multilevel(dc_level_shift(x.astype(jnp.int32), bits,
                                        signed), lv)
    if not narrow:
        return c
    # int16 readback halves the device→host bytes. Typical 5/3
    # coefficients for ≤12-bit input fit int16, but the worst-case
    # lifting gain compounds per level, so a max-abs flag rides along;
    # the host re-fetches int32 on overflow.
    return c.astype(jnp.int16), jnp.max(jnp.abs(c))


@partial(jax.jit, static_argnames=("bits", "lv", "narrow"))
def _pipeline_device_stage_rgb(x, bits, lv, narrow=False):
    """[B, 3, H, W] → DC shift → RCT → per-component 5/3."""
    s = dc_level_shift(x.astype(jnp.int32), bits, signed=False)
    y, u, v = rct_forward(s[:, 0], s[:, 1], s[:, 2])
    c = fwd53_multilevel(jnp.stack([y, u, v], axis=1), lv)
    if not narrow:
        return c
    return c.astype(jnp.int16), jnp.max(jnp.abs(c))


def _start_host_copy(arr) -> None:
    """Begin the device→host transfer in the background (overlaps with
    host entropy coding; np.asarray later completes near-instantly)."""
    try:
        arr.copy_to_host_async()
    except Exception:  # noqa: BLE001 — backend without async copies
        pass


# One-shot MEASURED transfer policy. At first use the pipeline times a
# real host->device->host round trip and the host-native transform on
# the same shape; the device path is preferred only when the measured
# transfer cost leaves room for a win. Cached for the process and logged
# as a "pipeline.transfer_policy" event; tests can inject fake probes.
_POLICY = None


_PROBE_CHUNK, _PROBE_REPEATS = 4, 5


def _best_ms(fn, repeats: int = _PROBE_REPEATS) -> float:
    """Fastest of ``repeats`` timed calls, in ms (one sample is noise)."""
    import time as _time

    best = float("inf")
    for _ in range(repeats):
        t0 = _time.perf_counter()
        fn()
        best = min(best, (_time.perf_counter() - t0) * 1000)
    return best


def _measure_roundtrip_ms_per_frame() -> float:
    """Measured host->device->host round trip, ms per 512² frame, of
    what the pipelines move: one chunk of _PROBE_CHUNK frames up and
    back as 16-bit samples (compact uploads and narrow readbacks)."""
    import numpy as np

    x = np.zeros((_PROBE_CHUNK, 512, 512), dtype=np.uint16)
    np.asarray(jnp.asarray(x))         # warm path
    return _best_ms(lambda: np.asarray(jnp.asarray(x))) / _PROBE_CHUNK


def _measure_host_transform_ms_per_frame() -> float:
    """Measured host lane, ms per 512² frame: the work a device dispatch
    would replace — widen a 16-bit frame to int32 with the DC shift,
    then the native 5/3. Falls back to a conservative estimate when the
    native library is unavailable."""
    import numpy as np

    from .native import dwt53_fwd_native, get_lib

    if get_lib() is None:
        return 3.0   # typical native cost; Python lane is far slower
    frame = np.zeros((512, 512), dtype=np.uint16)

    def host_lane():
        dwt53_fwd_native(frame.astype(np.int32) - 2048, 5, 0, 0)

    host_lane()                        # warm
    return _best_ms(host_lane)


def transfer_policy(force_remeasure: bool = False,
                    _probe_roundtrip=None, _probe_host=None) -> dict:
    """The cached measured policy: {"prefer_device", "reason",
    "roundtrip_ms", "host_ms"}. _probe_* let tests fake both regimes."""
    global _POLICY
    if _POLICY is not None and not force_remeasure:
        return _POLICY
    try:
        backend = jax.default_backend()
    except Exception:  # noqa: BLE001
        backend = "cpu"
    if backend == "cpu":
        _POLICY = {"prefer_device": False, "reason": "cpu backend",
                   "roundtrip_ms": None, "host_ms": None}
    else:
        rt = (_probe_roundtrip or _measure_roundtrip_ms_per_frame)()
        host = (_probe_host or _measure_host_transform_ms_per_frame)()
        # the device path must amortize the round trip against the host
        # transform it replaces; 0.75 margin keeps ties on the host
        # (no pipeline regression when the device barely breaks even)
        prefer = rt < host * 0.75
        _POLICY = {
            "prefer_device": prefer,
            "reason": (f"measured roundtrip {rt:.2f} ms/frame vs host "
                       f"transform {host:.2f} ms/frame"),
            "roundtrip_ms": round(rt, 3),
            "host_ms": round(host, 3),
        }
    from .utils.profiling import log_event
    log_event("pipeline.transfer_policy", _POLICY)
    return _POLICY


def _host_transform_faster() -> bool:
    """True when the measured host<->device round trip costs more than
    the host transform it would replace (see transfer_policy), so the
    batched pipelines run their transforms on the host."""
    try:
        if jax.default_backend() == "cpu":
            return False
    except Exception:  # noqa: BLE001
        return True
    return not transfer_policy()["prefer_device"]


def prefer_batched_device() -> bool:
    """True when a batched device compute path beats the per-frame host
    path for multi-frame pipelines, per the MEASURED transfer policy.
    Adapters use this to pick their strategy."""
    try:
        return (jax.default_backend() != "cpu"
                and transfer_policy()["prefer_device"])
    except Exception:  # noqa: BLE001
        return False


def _host_dwt(native_fn, jnp_fn, arr, levels, x0=0, y0=0,
              as_int32=True):
    """Host-lane multilevel DWT: the native mirror when built, else the
    jnp reference op (bit-exact for 5/3 — native mirrors it). Keeps the
    forced device=\"host\" pipelines working under GDCT_DISABLE_NATIVE=1
    (the native helpers return None there)."""
    import numpy as np

    r = native_fn(arr, levels, x0, y0)
    if r is not None:
        return r
    out = np.asarray(jnp_fn(jnp.asarray(arr)[None], levels, x0=x0,
                            y0=y0))[0]
    return out.astype(np.int32) if as_int32 and out.dtype != np.float32 \
        else out


def encode_frames_pipelined(frames, bit_depth: int = 16,
                            signed: bool = False, levels: int = 5,
                            chunk: int = 8, params=None,
                            device: str = "auto"):
    """Double-buffered J2K-lossless multi-frame encode.

    The device transforms chunk k+1 (async jit dispatch + async host
    copy) while the host entropy-codes chunk k — the host↔HBM overlap
    the SURVEY north star calls for (§2.10 item 4; replaces the
    reference's sequential frame loop, rle/rle.go:44-57 pattern).

    device: "auto" picks the transform engine from transfer_policy —
    the batched device stage when the measured round trip beats the
    host transform (and always on the CPU backend, where transfers are
    free), else the bit-parity host-native 5/3; "device"/"host" force
    one. Output bytes are identical either way.

    frames: [F, H, W] (grayscale) or [F, H, W, 3] (RGB — encoded with the
    reversible RCT like the scalar path). Returns list of codestream
    bytes, one per frame.
    """
    import numpy as np

    from .codecs.jpeg2000 import J2KEncodeParams, J2KEncoder
    from .codestream import j2k as j2kcs

    frames = np.asarray(frames)
    if frames.shape[0] == 0:
        return []
    rgb = frames.ndim == 4
    if rgb:
        f, h, w, nc = frames.shape
        if nc != 3:
            raise ValueError("RGB pipeline expects 3 components")
        frames = np.moveaxis(frames, -1, 1)  # [F, 3, H, W]
    else:
        f, h, w = frames.shape
        nc = 1
    p = params or J2KEncodeParams(num_levels=levels)
    p.num_levels = p.clamped_levels(w, h)
    enc = J2KEncoder(p)

    if device == "auto":
        from . import native as _n  # noqa: F401 (import check only)
        from .native import get_lib

        use_host = _host_transform_faster() and get_lib() is not None
    else:
        use_host = device == "host"
    if use_host:
        from .native import dwt53_fwd_native
        from .ops.mct import rct_forward as _rct

        def host_transform(arr):
            x = arr.astype(np.int32) - (
                0 if signed else (1 << (bit_depth - 1)))
            if rgb:
                y, u, v = _rct(x[:, 0], x[:, 1], x[:, 2])
                x = np.stack([np.asarray(y), np.asarray(u),
                              np.asarray(v)], axis=1)
                return np.stack([
                    np.stack([_host_dwt(dwt53_fwd_native,
                                        fwd53_multilevel, x[k, c],
                                        p.num_levels)
                              for c in range(3)])
                    for k in range(x.shape[0])])
            return np.stack([_host_dwt(dwt53_fwd_native, fwd53_multilevel,
                                       x[k], p.num_levels)
                             for k in range(x.shape[0])])

    # RCT widens U/V by one bit beyond the subband gain, hence the
    # tighter RGB cutoff for the int16 readback
    narrow = bit_depth <= (12 if rgb else 13) and not signed
    # compact uploads: the device stage widens to int32 on-chip
    if not signed and bit_depth <= 16 and frames.dtype.itemsize > 2:
        frames = frames.astype(np.uint16)
    elif signed and bit_depth <= 15 and frames.dtype.itemsize > 2:
        frames = frames.astype(np.int16)

    def device_stage(x):
        if rgb:
            r = _pipeline_device_stage_rgb(x, bit_depth, p.num_levels,
                                           narrow)
        else:
            r = _pipeline_device_stage(x, bit_depth, signed, p.num_levels,
                                       narrow)
        _start_host_copy(r[0] if narrow else r)
        return (r, x) if narrow else (r, None)

    def fetch(pending_pair):
        r, x = pending_pair
        if not narrow:
            return np.asarray(r)
        c16, maxabs = r
        if int(np.asarray(maxabs)) <= 32767:
            return np.asarray(c16).astype(np.int32)
        # rare: worst-case lifting gain overflowed int16 — redo wide
        if rgb:
            wide = _pipeline_device_stage_rgb(x, bit_depth, p.num_levels,
                                              False)
        else:
            wide = _pipeline_device_stage(x, bit_depth, signed,
                                          p.num_levels, False)
        return np.asarray(wide)

    # overlap needs >= 2 chunks in flight; small chunks also bound the
    # serial fill (first chunk's upload+compute+readback is unhidden)
    if f > 1:
        chunk = max(1, min(chunk, -(-f // 2), 4))
    chunks = [frames[i : i + chunk] for i in range(0, f, chunk)]
    if not use_host:
        # dispatch chunk 0 (device_put returns immediately; the transfer
        # proceeds while the host assembles headers below)
        pending = device_stage(jax.device_put(chunks[0]))
    out = []
    siz = j2kcs.SizInfo(xsiz=w, ysiz=h, xtsiz=w, ytsiz=h,
                        components=[(bit_depth, signed, 1, 1)] * nc)
    cod = j2kcs.CodInfo(progression=p.progression, num_layers=1,
                        mct=1 if rgb else 0,
                        num_levels=p.num_levels, cb_width=p.cb_width,
                        cb_height=p.cb_height, cb_style=p.cb_style,
                        transform=1, use_sop=p.use_sop, use_eph=p.use_eph)
    qcd = j2kcs.QcdInfo(style=0, guard_bits=p.guard_bits)
    from .codecs.j2k_geometry import band_gain
    from .codecs import j2k_quant as jq
    for (r, band) in jq.band_sequence(p.num_levels):
        qcd.exponents.append(bit_depth + band_gain(band))

    header = bytearray(b"\xff\x4f")
    header += j2kcs.write_siz(siz)
    header += j2kcs.write_cod(cod)
    header += j2kcs.write_qcd(qcd)
    if p.comment:
        header += j2kcs.write_com(p.comment)

    for ci in range(len(chunks)):
        if use_host:
            coeffs = host_transform(chunks[ci])
        else:
            if ci + 1 < len(chunks):  # overlap: dispatch next device work
                nxt = device_stage(jax.device_put(chunks[ci + 1]))
            else:
                nxt = None
            coeffs = fetch(pending)   # completes chunk ci's async copy
            pending = nxt
        for k in range(coeffs.shape[0]):
            frame_coeffs = coeffs[k] if rgb else coeffs[k : k + 1]
            split = bool(enc.params.packed_headers)
            want_plt = bool(enc.params.plt_markers)
            res = enc._encode_tile_entropy(frame_coeffs, (0, 0, w, h),
                                           cod, qcd, bit_depth,
                                           split=split, want_plt=want_plt)
            if split or want_plt:  # PPT/PLT tile-part header segments
                head = b""
                if split:
                    head += j2kcs.write_ppt(res.headers)
                if want_plt:
                    head += j2kcs.write_plt_segments(res.pkt_lengths)
                tp = j2kcs.write_tile_part(0, res.body,
                                           head_segments=head)
            else:
                tp = j2kcs.write_tile_part(0, res)
            tlm = b""
            if getattr(enc.params, "tlm_markers", False):
                # Ptlm covers the whole tile-part incl. PPT/PLT segs
                tlm = j2kcs.write_tlm(0, [(0, len(tp))])
            stream = (bytes(header) + tlm + tp
                      + j2kcs.EOC.to_bytes(2, "big"))
            if enc.params.container is not None:
                # same JP2/JPH wrapping as J2KEncoder.encode — the
                # pipelined path must emit identical bytes per params
                stream = j2kcs.wrap_jp2(stream,
                                        brand=enc.params.container)
            out.append(stream)
    return out


def j2k_rgb_lossless_encode_transform(frames: jnp.ndarray, levels: int = 5,
                                      bits: int = 8, cb: int = 64):
    """RGB J2K lossless device stage: [B, 3, H, W] int32 → 3×(coeffs, stats).

    DC shift → RCT (ops/mct.py) → per-component multilevel 5/3.
    """
    x = dc_level_shift(frames.astype(jnp.int32), bits, signed=False)
    y, u, v = rct_forward(x[:, 0], x[:, 1], x[:, 2])
    comps = jnp.stack([y, u, v], axis=1)
    coeffs = fwd53_multilevel(comps, levels)
    m = codeblock_max_abs(coeffs, cb, cb)
    return coeffs, m, max_bitplane(m)


@partial(jax.jit, static_argnames=("level",))
def _jpeg_device_stage(x, qtable, level):
    """Batched JPEG device stage: [B, H, W] → [B, nby, nbx, 64] int32."""
    from .ops.dct8x8 import encode_plane_to_zigzag

    return encode_plane_to_zigzag(x, qtable, level_shift=level)


def encode_frames_pipelined_jpeg(frames, quality: int = 90,
                                 precision: int = 8, chunk: int = 8):
    """Double-buffered JPEG baseline/extended multi-frame encode.

    The device runs DCT+quant+zigzag for chunk k+1 (one batched jit
    dispatch) while the host Huffman-codes chunk k — the same
    host↔device overlap as the J2K pipeline. Grayscale frames [F, H, W];
    returns a list of JPEG byte streams, byte-identical to the
    per-frame encoder on EVERY lane (r4 determinism invariant: the
    integer islow DCT is the one transform everywhere — see CLAUDE.md).
    """
    import numpy as np

    from .codecs import jpeg_common as jc
    from .codecs.jpeg_baseline import encode_from_zigzag
    from .codestream import jpeg_markers as mk

    frames = np.asarray(frames)
    f, h, w = frames.shape
    if f == 0:
        return []
    qtable = jc.scale_quant_table(jc.LUMA_QUANT, quality, 255)
    level = 1 << (precision - 1)
    sof = mk.SOF0 if precision <= 8 else mk.SOF1

    chunks = [frames[i : i + chunk] for i in range(0, f, chunk)]
    pending = _jpeg_device_stage(
        jnp.asarray(chunks[0].astype(np.int32)), jnp.asarray(qtable), level)
    out = []
    for ci in range(len(chunks)):
        zz = np.asarray(pending)  # sync chunk ci
        if ci + 1 < len(chunks):  # overlap: dispatch next device work
            pending = _jpeg_device_stage(
                jnp.asarray(chunks[ci + 1].astype(np.int32)),
                jnp.asarray(qtable), level)
        for k in range(zz.shape[0]):
            out.append(encode_from_zigzag(
                [zz[k].reshape(-1, 64)], [qtable], [0], w, h, 1,
                precision=precision, sof_marker=sof,
                write_jfif=precision > 8))
    return out


@partial(jax.jit, static_argnames=("levels", "x0", "y0", "bits", "signed",
                                   "mct", "narrow"))
def _j2k_decode_device_stage(packed, levels, x0, y0, bits, signed, mct,
                             narrow=False):
    """Batched inverse device stage: [B, C, th, tw] packed coefficients
    (int32, or int16 when the host verified they fit) → reconstructed
    samples (inverse 5/3 + inverse RCT + DC unshift)."""
    from .ops.dwt53 import inv53_multilevel
    from .ops.mct import inv_dc_level_shift, rct_inverse

    rec = inv53_multilevel(packed.astype(jnp.int32), levels, x0=x0, y0=y0)
    if mct and rec.shape[1] >= 3:
        r_, g_, b_ = rct_inverse(rec[:, 0], rec[:, 1], rec[:, 2])
        rec = jnp.concatenate(
            [jnp.stack([r_, g_, b_], axis=1), rec[:, 3:]], axis=1)
    px = inv_dc_level_shift(rec, bits, signed)
    if narrow:  # pixels fit 16 bits: halve the readback
        # identity for conformant streams (reversible reconstruction is
        # exact); clips hostile coefficients that would otherwise wrap
        # through the 16-bit cast
        lo, hi = ((-(1 << (bits - 1)), (1 << (bits - 1)) - 1) if signed
                  else (0, (1 << bits) - 1))
        px = jnp.clip(px, lo, hi)
        return px.astype(jnp.int16 if signed else jnp.uint16)
    return px


@partial(jax.jit, static_argnames=("levels", "x0", "y0", "bits", "signed",
                                   "mct", "narrow"))
def _j2k_decode_device_stage_97(fbatch, levels, x0, y0, bits, signed, mct,
                                narrow=False):
    """Batched irreversible inverse device stage: [B, C, th, tw]
    dequantized float32 coefficients → reconstructed samples (float 9/7
    inverse + inverse ICT + round + DC unshift)."""
    from .ops.dwt97 import inv97_multilevel
    from .ops.mct import ict_inverse, inv_dc_level_shift

    rec = inv97_multilevel(fbatch, levels, x0=x0, y0=y0)
    if mct and rec.shape[1] >= 3:
        y, cb, cr = rec[:, 0], rec[:, 1], rec[:, 2]
        r_, g_, b_ = ict_inverse(y, cb, cr)
        rec = jnp.concatenate(
            [jnp.stack([r_, g_, b_], axis=1), rec[:, 3:]], axis=1)
    px = inv_dc_level_shift(jnp.round(rec).astype(jnp.int32), bits, signed)
    if narrow:
        # lossy reconstructions can overshoot the declared range by a
        # few codes; clip BEFORE the 16-bit readback cast (the final
        # pack clips identically — an unclipped -1 would wrap to 65535)
        lo, hi = ((-(1 << (bits - 1)), (1 << (bits - 1)) - 1) if signed
                  else (0, (1 << bits) - 1))
        px = jnp.clip(px, lo, hi)
        return px.astype(jnp.int16 if signed else jnp.uint16)
    return px


def decode_frames_pipelined(streams, chunk: int = 8,
                            return_info: bool = False,
                            device: str = "auto", reduce: int = 0):
    """Double-buffered J2K multi-frame DECODE.

    The host entropy-decodes (T1 + T2) chunk k+1 while the device runs
    the batched inverse DWT + inverse color transform + DC unshift for
    chunk k — the decode-side mirror of encode_frames_pipelined (same
    backend-aware `device` selection). Requires homogeneous single-tile
    streams of equal geometry (the shape the encode pipelines emit).
    Reversible output is bit-identical to J2KDecoder.decode per frame;
    irreversible streams (host per-band dequant + float 9/7 inverse)
    come back clipped to the declared dynamic range (what the final
    pixel pack does anyway) and match the scalar decoder within ±1
    rounding ties (float program shapes — same policy as
    parallel.mesh.decode_frames_sharded).

    Returns a list of [H, W, C] int32 arrays.
    """
    import numpy as np

    from .codecs.jpeg2000 import (J2KEncoder, decode_to_packed,
                                  dequantize_packed)

    if not streams:
        return ([], None) if return_info else []

    if device == "auto":
        from .native import get_lib

        use_host = _host_transform_faster() and get_lib() is not None
    else:
        use_host = device == "host"

    global_meta = [None]  # enforced across ALL chunks, not just within

    def rdiv(v):  # reduced-grid coordinate (level-R LL window)
        return -(-v // (1 << reduce))

    def host_stage(group):
        packs = []
        for s in group:
            packed, siz, cod, qcd = decode_to_packed(s, return_qcd=True,
                                                     reduce=reduce)
            m = (packed.shape, cod.num_levels - reduce, rdiv(siz.xosiz),
                 rdiv(siz.yosiz),
                 siz.components[0][:2], cod.mct, cod.transform, qcd)
            if global_meta[0] is None:
                global_meta[0] = m
            elif m != global_meta[0]:
                raise ValueError("decode pipeline needs equal-geometry "
                                 "streams")
            if cod.transform != 1:
                # irreversible: per-band dequant on the host (QCD steps,
                # shared helper with the scalar decoder; deltas build
                # over the FULL level count — band indices are a
                # prefix-stable subset under reduce)
                _, th_, tw_ = packed.shape
                deltas = J2KEncoder._band_deltas(qcd, cod.num_levels,
                                                 siz.components[0][0])
                packed = dequantize_packed(
                    packed, (rdiv(siz.xosiz), rdiv(siz.yosiz),
                             rdiv(siz.xosiz) + tw_,
                             rdiv(siz.yosiz) + th_),
                    cod.num_levels - reduce, deltas)
            packs.append(packed)
        return np.stack(packs)

    groups = [streams[i : i + chunk] for i in range(0, len(streams), chunk)]
    out = []
    prev = None  # device array pending readback
    for group in groups:
        batch = host_stage(group)  # host T1 (+dequant) for THIS chunk
        (shape, levels, x0, y0, (bits, signed), mct, transform,
         _qcd) = global_meta[0]
        if use_host:
            from .native import dwt53_inv_native, dwt97_inv_native
            from .ops.dwt53 import inv53_multilevel
            from .ops.dwt97 import inv97_multilevel
            from .ops.mct import ict_inverse_np
            from .ops.mct import rct_inverse as _rcti

            recs = []
            for k in range(batch.shape[0]):
                if transform == 1:
                    rec = np.stack([
                        _host_dwt(dwt53_inv_native, inv53_multilevel,
                                  batch[k, c], levels, x0, y0)
                        for c in range(batch.shape[1])])
                    if mct and rec.shape[0] >= 3:
                        r_, g_, b_ = _rcti(rec[0], rec[1], rec[2])
                        rec = np.stack([np.asarray(r_), np.asarray(g_),
                                        np.asarray(b_)]
                                       + [rec[i]
                                          for i in range(3, rec.shape[0])])
                else:
                    rec = np.stack([
                        _host_dwt(dwt97_inv_native, inv97_multilevel,
                                  batch[k, c].astype(np.float32), levels,
                                  x0, y0, as_int32=False)
                        for c in range(batch.shape[1])])
                    if mct and rec.shape[0] >= 3:
                        r_, g_, b_ = ict_inverse_np(rec[0], rec[1], rec[2])
                        rec = np.stack([r_, g_, b_]
                                       + [rec[i]
                                          for i in range(3, rec.shape[0])])
                    rec = np.round(rec).astype(np.int32)
                if not signed:
                    rec = rec + (1 << (bits - 1))
                if transform != 1:
                    # match the device lane: lossy output is clipped to
                    # the declared range (what the final pack does)
                    lo, hi = ((-(1 << (bits - 1)), (1 << (bits - 1)) - 1)
                              if signed else (0, (1 << bits) - 1))
                    rec = np.clip(rec, lo, hi)
                recs.append(rec)
            out.extend(recs)
            continue
        # compact upload when the (host-known) coefficients fit int16
        if batch.dtype == np.int32 and np.abs(batch).max() <= 32767:
            batch = batch.astype(np.int16)
        # the narrow readback's clip is an identity only for FULL
        # reversible reconstruction; a reduced decode's LL can over/
        # undershoot the declared range (lowpass ringing), so reversible
        # reduce keeps the int32 path and stays bit-identical to
        # J2KDecoder. Irreversible output is ALWAYS clipped — the
        # documented batched-lossy policy, matching the host lane and
        # decode_frames_sharded.
        narrow = bits <= 16 and (reduce == 0 or transform != 1)
        if transform == 1:
            pending = _j2k_decode_device_stage(
                jnp.asarray(batch), levels, x0, y0, bits, signed,
                bool(mct), narrow)
        else:
            pending = _j2k_decode_device_stage_97(
                jnp.asarray(batch), levels, x0, y0, bits, signed,
                bool(mct), narrow)
        _start_host_copy(pending)
        if prev is not None:
            out.extend(np.asarray(prev))  # sync previous chunk's device work
        prev = pending
    if prev is not None:
        out.extend(np.asarray(prev))
    frames = [np.moveaxis(np.asarray(f).astype(np.int32), 0, -1)
              for f in out]
    if return_info:
        (bits, signed) = global_meta[0][4]
        return frames, (bits, signed)
    return frames
