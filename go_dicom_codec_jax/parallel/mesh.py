"""Device mesh + sharding for frame/tile batches.

The reference has no distributed layer (SURVEY.md §2.10): frames and tiles
encode in sequential loops. Here those loops are the parallel axes — frames
(data parallel) × tiles (spatial) over a jax.sharding.Mesh, with XLA
collectives for the few cross-shard reductions (aggregate stats). Frame
shards are independent, so the frame axis needs no interconnect traffic
beyond the host uploads and readbacks; on one host of GPUs joined all to
all, any device order serves either axis equally.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..ops.mct import MCT_PRECISION
from ..utils.profiling import log_event


FRAME_AXIS = "frames"
TILE_AXIS = "tiles"


def make_mesh(n_devices: Optional[int] = None,
              tile_parallel: int = 1) -> Mesh:
    """Mesh over (frames, tiles). tile_parallel divides n_devices."""
    devices = np.asarray(jax.devices())
    if n_devices is not None:
        devices = devices[:n_devices]
    n = devices.size
    if n % tile_parallel != 0:
        raise ValueError(f"tile_parallel={tile_parallel} must divide {n}")
    grid = devices.reshape(n // tile_parallel, tile_parallel)
    return Mesh(grid, (FRAME_AXIS, TILE_AXIS))


def frame_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a [F, ...] frame batch over the frame axis."""
    return NamedSharding(mesh, P(FRAME_AXIS))


def frame_tile_sharding(mesh: Mesh) -> NamedSharding:
    """Shard a [F, T, ...] frame×tile batch over both mesh axes."""
    return NamedSharding(mesh, P(FRAME_AXIS, TILE_AXIS))


def shard_frames(batch: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
    """Place a [F, ...] batch sharded over frames."""
    return jax.device_put(batch, frame_sharding(mesh))


def _log_shard_devices(name: str, arr) -> None:
    """Record which device holds each shard of a sharded output, so a
    caller can see that the work was spread over the mesh."""
    log_event(name, {"shard_devices": [
        str(s.device) for s in arr.addressable_shards]})


def pad_batch_to_devices(batch: np.ndarray, n: int) -> Tuple[np.ndarray, int]:
    """Pad the leading dim to a multiple of n; returns (padded, orig_len)."""
    f = batch.shape[0]
    pad = (-f) % n
    if pad:
        batch = np.concatenate([batch, np.zeros((pad,) + batch.shape[1:],
                                                dtype=batch.dtype)], axis=0)
    return batch, f


def encode_frames_sharded(frames, bit_depth: int = 16,
                          signed: bool = False, levels: int = 5,
                          mesh: Optional[Mesh] = None, params=None):
    """Multi-chip J2K multi-frame encode over the FULL parameter surface.

    The device stage — DC shift (+RCT/ICT MCT) + multilevel 5/3 or 9/7
    per tile — runs ONCE over the whole batch, sharded across the mesh's
    frame axis; XLA partitions the jit per-device and each chip
    transforms its frame shard in parallel. The host then runs the FULL
    scalar encoder (headers, T1, PCRD, all progressions/layers) per
    frame with the precomputed per-tile coefficients
    (J2KEncoder.encode(precomputed_tiles=...)) — so multi-tile, RGB/MCT,
    multi-layer, lossy 9/7, HTJ2K, Part-2 custom matrices/bindings,
    ROI, and every marker-surface feature shards.

    Codestreams are byte-identical to the scalar encoder running its jit
    transform lane (frame-axis sharding adds no cross-frame math; for
    lossless the native host lane is bit-identical too, for lossy 9/7
    compare against a native-disabled scalar encode — the float DWT host
    fast path is a different lossy rounding profile, see CLAUDE.md).

    frames: [F, H, W] grayscale or [F, H, W, C]. Pads F up to the mesh
    size and drops the padding on output.

    Custom matrices/bindings apply in the batched device stage (same
    order as the scalar transform; they replace RCT/ICT). The ROI mask
    pre-shift applies on the host, post-transform, inside
    encode(precomputed_tiles=...). HTJ2K shards like classic J2K — the
    device transform is the same DWT; only the host block coder
    differs (HT cleanup instead of MQ).
    """
    from ..codecs import j2k_quant as jq
    from ..codecs.j2k_geometry import packed_band_layout
    from ..codecs.jpeg2000 import (J2KEncodeParams, J2KEncoder,
                                   _band_index)
    from ..codestream import j2k as j2kcs
    from ..ops.dwt53 import fwd53_multilevel
    from ..ops.dwt97 import fwd97_multilevel
    from ..ops.mct import dc_level_shift, ict_forward, rct_forward

    frames = np.asarray(frames)
    if frames.ndim == 3:
        frames = frames[..., None]
    f, h, w, ncomp = frames.shape
    mesh = mesh or make_mesh()
    nshard = mesh.shape[FRAME_AXIS] * mesh.shape[TILE_AXIS]
    padded, orig = pad_batch_to_devices(frames, nshard)

    p = params or J2KEncodeParams(num_levels=levels)
    # ROI needs no exclusion: the mask pre-shift applies on the HOST,
    # post-transform, inside encode(precomputed_tiles=...) —
    # J2KEncoder._roi_shift_coeffs runs on precomputed tiles too.
    nlv = p.clamped_levels(w, h)
    use_mct = p.mct if p.mct is not None else (ncomp == 3)
    if p.mct_matrix is not None or p.mct_bindings:
        use_mct = False    # bindings/custom matrix replace RCT/ICT
        #                    (same override as J2KEncoder.encode)
    lossless = p.lossless
    tw = p.tile_width or w
    th = p.tile_height or h
    siz = j2kcs.SizInfo(xsiz=w, ysiz=h, xtsiz=tw, ytsiz=th,
                        components=[(bit_depth, signed, 1, 1)] * ncomp)
    ntx, nty = siz.num_tiles
    rects = [siz.tile_rect(ti, tj)
             for tj in range(nty) for ti in range(ntx)]

    tile_batches = sharded_tile_coeffs(
        padded, rects, nlv, bit_depth, signed, use_mct, ncomp, lossless,
        mesh, mct_bindings=p.mct_bindings, mct_matrix=p.mct_matrix,
        mct_offsets=p.mct_offsets)

    enc = J2KEncoder(p)
    if not lossless:   # loop-invariant quantization model
        qcd = enc._build_qcd(nlv, bit_depth, use_mct, ncomp)
        band_steps = enc._band_deltas(qcd, nlv, bit_depth)
    out = []
    for k in range(orig):
        tiles_k = []
        for tidx, (tx0, ty0, tx1, ty1) in enumerate(rects):
            tc = tile_batches[tidx][k]
            if not lossless:
                # same numpy deadzone quant as the scalar device path
                fcoeffs = tc
                tc = np.zeros_like(fcoeffs, dtype=np.int32)
                for bg in packed_band_layout(tx0, ty0, tx1, ty1, nlv):
                    delta = band_steps[_band_index(bg.resolution,
                                                   bg.band)]
                    sl = (slice(None),
                          slice(bg.row_off, bg.row_off + bg.height),
                          slice(bg.col_off, bg.col_off + bg.width))
                    tc[sl] = jq.deadzone_quantize(fcoeffs[sl], delta)
            tiles_k.append(tc)
        out.append(enc.encode(frames[k], w, h, ncomp, bit_depth,
                              signed, precomputed_tiles=tiles_k))
    return out


def decode_frames_sharded(streams, mesh: Optional[Mesh] = None,
                          reduce: int = 0):
    """Multi-chip J2K multi-frame DECODE (the scale-out mirror of
    encode_frames_sharded; the reference decodes frames in a sequential
    loop, decoder.go:91-124).

    The host entropy-decodes each stream (T2 + T1) to per-tile packed
    subband coefficients (codecs.jpeg2000.decode_to_packed_tiles;
    irreversible streams also dequantize per band on the host), then
    one frame-axis-sharded jit PER TILE runs the inverse transform —
    inverse 5/3 or 9/7 + inverse RCT/ICT + DC unshift — over the whole
    frame batch (the decode mirror of the per-tile encode batches),
    each chip inverting its frame shard in parallel. Reversible pixels
    are bit-identical to J2KDecoder.decode per frame (all-integer
    math); irreversible pixels come back clipped to the declared range
    and match within ±1 (XLA may emit one-ulp-different float programs
    for the batched shape — same policy as the sharded encode, see
    sharded_tile_coeffs).

    Part-2 custom MCT streams shard too — the batched stage applies
    the marker-carried inverse matrices (reverse MCO order) like the
    scalar decoder. Heterogeneous streams — XRsiz/YRsiz-subsampled
    components, per-component COD/QCD (COC/QCC), per-tile overrides —
    shard through the per-component path (_decode_frames_sharded_hetero:
    one frame-batched inverse launch per tile-component on its own grid,
    replication upsample on the host, no cross-component math — the
    scalar decoder's heterogeneous branch semantics). Requires streams
    of equal geometry (same SIZ/COD/QCD/COC/QCC/MCT and tile grid);
    raises UnsupportedFormatError otherwise. ROI streams of both styles
    shard — the unshift runs on the packed host coefficients. Returns
    [H, W, C] int32 arrays.
    """
    from ..codecs.j2k_geometry import ceil_div
    from ..codecs.jpeg2000 import (J2KEncoder, decode_to_packed_tiles,
                                   dequantize_packed)
    from ..errors import UnsupportedFormatError
    from ..ops.dwt53 import inv53_multilevel
    from ..ops.dwt97 import inv97_multilevel
    from ..ops.mct import ict_inverse, inv_dc_level_shift, rct_inverse

    if not streams:
        return []
    packs, meta, qcd0, mct_inv = [], None, None, None
    for s in streams:
        try:
            tiles, siz, cod, qcd, minv = decode_to_packed_tiles(
                s, reduce=reduce)
        except UnsupportedFormatError:
            if meta is not None or reduce:
                raise  # mixed batch / reduce on a heterogeneous stream
            return _decode_frames_sharded_hetero(streams, mesh)
        mkey = tuple((tuple(ids), inv.tobytes(),
                      offs.tobytes() if offs is not None else None)
                     for (ids, inv, offs) in minv)
        m = ([(r, p.shape) for (r, p) in tiles], cod.num_levels - reduce,
             tuple(ceil_div(v, 1 << reduce)
                   for v in (siz.xsiz, siz.ysiz, siz.xosiz, siz.yosiz)),
             siz.components[0][:2], cod.mct, cod.transform, qcd, mkey)
        if meta is None:
            meta, qcd0, mct_inv = m, qcd, minv
        elif m != meta:
            raise UnsupportedFormatError(
                "sharded decode needs equal-geometry streams")
        packs.append(tiles)
    (tile_shapes, levels, (xs, ys, xos, yos), (bits, signed), mct,
     transform, _, _) = meta
    nframes = len(packs)
    mesh = mesh or make_mesh()
    nshard = mesh.shape[FRAME_AXIS] * mesh.shape[TILE_AXIS]
    sharding = NamedSharding(mesh, P((FRAME_AXIS, TILE_AXIS)))

    # deltas build over the FULL level count (band indices are a
    # prefix-stable subset under reduce)
    deltas = (J2KEncoder._band_deltas(qcd0, levels + reduce, bits)
              if transform != 1 else None)
    height, width = ys - yos, xs - xos
    ncomp = tile_shapes[0][1][0]
    out = np.zeros((nframes, height, width, ncomp), dtype=np.int32)

    def _apply_inv_bindings(rec):
        # batched mirror of _apply_mct_bindings_inverse ([F, C, h, w]):
        # inverse matrix, then +offsets, in the (already reversed)
        # MCO order
        recf = rec.astype(jnp.float32)
        for (ids, inv, offs) in mct_inv:
            idx = jnp.asarray(list(ids))
            sub = jnp.einsum("ij,fjhw->fihw", jnp.asarray(inv),
                             recf[:, idx], precision=MCT_PRECISION,
                             preferred_element_type=jnp.float32)
            if offs is not None:
                sub = sub + jnp.asarray(offs)[None, :, None, None]
            recf = recf.at[:, idx].set(sub)
        return recf

    def stage(x, tx0, ty0):
        if transform == 1:
            rec = inv53_multilevel(x.astype(jnp.int32), levels,
                                   x0=tx0, y0=ty0)
            if mct_inv:
                rec = jnp.round(_apply_inv_bindings(rec)
                                ).astype(jnp.int32)
            elif mct and rec.shape[1] >= 3:
                r_, g_, b_ = rct_inverse(rec[:, 0], rec[:, 1], rec[:, 2])
                rec = jnp.concatenate(
                    [jnp.stack([r_, g_, b_], axis=1), rec[:, 3:]], axis=1)
        else:
            rec = inv97_multilevel(x, levels, x0=tx0, y0=ty0)
            if mct_inv:
                rec = _apply_inv_bindings(rec)
            elif mct and rec.shape[1] >= 3:
                r_, g_, b_ = ict_inverse(rec[:, 0], rec[:, 1], rec[:, 2])
                rec = jnp.concatenate(
                    [jnp.stack([r_, g_, b_], axis=1), rec[:, 3:]], axis=1)
            rec = jnp.round(rec).astype(jnp.int32)
        px = inv_dc_level_shift(rec, bits, signed)
        if transform != 1:
            # lossy reconstructions can overshoot; clip to the declared
            # range like the final pixel pack (pipeline policy)
            lo, hi = ((-(1 << (bits - 1)), (1 << (bits - 1)) - 1)
                      if signed else (0, (1 << bits) - 1))
            px = jnp.clip(px, lo, hi)
        return px

    jstage = jax.jit(stage, static_argnums=(1, 2),
                     out_shardings=sharding)
    for t, ((tx0, ty0, tx1, ty1), _shape) in enumerate(tile_shapes):
        batch = np.stack([packs[f][t][1] for f in range(nframes)])
        if transform != 1:
            # per-band host dequantization with the QCD steps (shared
            # helper with the scalar decoder)
            batch = dequantize_packed(batch, (tx0, ty0, tx1, ty1),
                                      levels, deltas)
        padded, orig = pad_batch_to_devices(batch, nshard)
        x = jax.device_put(jnp.asarray(padded), sharding)
        rec = jstage(x, tx0, ty0)
        _log_shard_devices("mesh.decode_frames_sharded", rec)
        rec = np.asarray(rec)[:orig]
        out[:, ty0 - yos:ty1 - yos, tx0 - xos:tx1 - xos, :] = \
            np.moveaxis(rec, 1, -1)
    return [out[k] for k in range(nframes)]


def _decode_frames_sharded_hetero(streams, mesh: Optional[Mesh]):
    """decode_frames_sharded for HETEROGENEOUS streams (subsampled
    components, COC/QCC per-component overrides, per-tile COD/QCD):
    the host entropy-decodes each component onto its own ceil-divided
    grid (codecs.jpeg2000.decode_to_component_tiles), then one
    frame-axis-sharded jit PER TILE-COMPONENT runs that component's
    inverse transform (its own levels and 5/3-or-9/7 choice; QCC
    streams dequantize per component on the host first). No
    cross-component math — mirroring the scalar decoder's heterogeneous
    branch, where MCT is undefined across mixed grids/transforms and
    components reconstruct independently (jpeg2000._decode_tile) —
    then subsampled components upsample to the tile grid by sample
    replication on the host. Tiles that ARE homogeneous in the scalar
    sense (uniform component grids, one transform/levels across
    components — e.g. per-tile-COD streams that differ only in
    progression) take a whole-tile MCT launch instead, applying the
    inverse RCT/ICT exactly like jpeg2000._decode_tile's homogeneous
    branch. Reversible components are bit-identical to
    J2KDecoder.decode; irreversible ones clip to the declared range
    (same policy as the uniform sharded path). T.800 B.3 empty
    tile-components contribute a DC-unshifted zero plane, like the
    scalar decoder."""
    from ..codecs.jpeg2000 import (J2KEncoder, decode_to_component_tiles,
                                   dequantize_packed)
    from ..errors import UnsupportedFormatError
    from ..ops.dwt53 import inv53_multilevel
    from ..ops.dwt97 import inv97_multilevel
    from ..ops.mct import ict_inverse, inv_dc_level_shift, rct_inverse

    packs, meta, first = [], None, None
    for s in streams:
        tiles, siz = decode_to_component_tiles(s)
        m = ((siz.xsiz, siz.ysiz, siz.xosiz, siz.yosiz),
             siz.components,
             tuple((rect, tuple(crs), tuple(cods), tuple(qcds))
                   for (rect, crs, _pk, cods, qcds) in tiles))
        if meta is None:
            meta, first = m, tiles
        elif m != meta:
            raise UnsupportedFormatError(
                "sharded decode needs equal-geometry streams")
        packs.append(tiles)

    (xs, ys, xos, yos), components, _ = meta
    bits, signed = components[0][:2]
    nframes = len(packs)
    mesh = mesh or make_mesh()
    nshard = mesh.shape[FRAME_AXIS] * mesh.shape[TILE_AXIS]
    sharding = NamedSharding(mesh, P((FRAME_AXIS, TILE_AXIS)))
    height, width = ys - yos, xs - xos
    ncomp = len(components)
    fill = 0 if signed else (1 << (bits - 1))
    out = np.full((nframes, height, width, ncomp), fill, dtype=np.int32)

    def stage(x, levels, transform, cx0, cy0):
        if transform == 1:
            rec = inv53_multilevel(x.astype(jnp.int32), levels,
                                   x0=cx0, y0=cy0)
        else:
            rec = jnp.round(inv97_multilevel(x, levels, x0=cx0, y0=cy0)
                            ).astype(jnp.int32)
        px = inv_dc_level_shift(rec, bits, signed)
        if transform != 1:
            lo, hi = ((-(1 << (bits - 1)), (1 << (bits - 1)) - 1)
                      if signed else (0, (1 << bits) - 1))
            px = jnp.clip(px, lo, hi)
        return px

    def stage_mct(x, levels, transform, cx0, cy0):
        # whole-tile launch with inverse RCT/ICT — the batched mirror of
        # the scalar decoder's homogeneous branch (jpeg2000._decode_tile
        # applies MCT whenever the tile's component grids and
        # transform/levels agree, even when the stream as a whole is
        # heterogeneous, e.g. a per-tile COD override)
        if transform == 1:
            rec = inv53_multilevel(x.astype(jnp.int32), levels,
                                   x0=cx0, y0=cy0)
            r_, g_, b_ = rct_inverse(rec[:, 0], rec[:, 1], rec[:, 2])
            rec = jnp.concatenate(
                [jnp.stack([r_, g_, b_], axis=1), rec[:, 3:]], axis=1)
        else:
            rec = inv97_multilevel(x, levels, x0=cx0, y0=cy0)
            r_, g_, b_ = ict_inverse(rec[:, 0], rec[:, 1], rec[:, 2])
            rec = jnp.concatenate(
                [jnp.stack([r_, g_, b_], axis=1), rec[:, 3:]], axis=1)
            rec = jnp.round(rec).astype(jnp.int32)
        px = inv_dc_level_shift(rec, bits, signed)
        if transform != 1:
            lo, hi = ((-(1 << (bits - 1)), (1 << (bits - 1)) - 1)
                      if signed else (0, (1 << bits) - 1))
            px = jnp.clip(px, lo, hi)
        return px

    jstage = jax.jit(stage, static_argnums=(1, 2, 3, 4),
                     out_shardings=sharding)
    jstage_mct = jax.jit(stage_mct, static_argnums=(1, 2, 3, 4),
                         out_shardings=sharding)
    for t, (rect, comp_rects, _pk, cods, qcds) in enumerate(first):
        tx0, ty0, tx1, ty1 = rect
        th, tw = ty1 - ty0, tx1 - tx0
        cod_t = cods[0]
        homog = (all(tuple(cr) == tuple(rect) for cr in comp_rects)
                 and all(cc.transform == cod_t.transform
                         and cc.num_levels == cod_t.num_levels
                         for cc in cods))
        if homog and cod_t.mct == 1 and ncomp >= 3:
            planes = []
            for c in range(ncomp):
                pb = np.stack([packs[f][t][2][c] for f in range(nframes)])
                if cod_t.transform != 1:
                    pb = dequantize_packed(
                        pb, rect, cod_t.num_levels,
                        J2KEncoder._band_deltas(qcds[c], cod_t.num_levels,
                                                bits))
                planes.append(pb)
            batch = np.stack(planes, axis=1)    # [F, C, th, tw]
            padded, orig = pad_batch_to_devices(batch, nshard)
            x = jax.device_put(jnp.asarray(padded), sharding)
            rec = np.asarray(jstage_mct(x, cod_t.num_levels,
                                        cod_t.transform, tx0, ty0))[:orig]
            out[:, ty0 - yos:ty1 - yos, tx0 - xos:tx1 - xos, :] = \
                np.moveaxis(rec, 1, -1)
            continue
        for c in range(ncomp):
            cx0, cy0, cx1, cy1 = comp_rects[c]
            cth, ctw = cy1 - cy0, cx1 - cx0
            if cth == 0 or ctw == 0:
                continue    # out prefilled with the unshifted zero plane
            cod_c, qcd_c = cods[c], qcds[c]
            batch = np.stack([packs[f][t][2][c] for f in range(nframes)])
            if cod_c.transform != 1:
                batch = dequantize_packed(
                    batch, comp_rects[c], cod_c.num_levels,
                    J2KEncoder._band_deltas(qcd_c, cod_c.num_levels,
                                            bits))
            padded, orig = pad_batch_to_devices(batch, nshard)
            x = jax.device_put(jnp.asarray(padded), sharding)
            rec = np.asarray(jstage(x, cod_c.num_levels, cod_c.transform,
                                    cx0, cy0))[:orig]
            if (cth, ctw) != (th, tw):
                # replication upsample (reference tile_decoder.go
                # sample-replication interleave; scalar _decode_tile)
                ry = -(-th // cth)
                rx = -(-tw // ctw)
                rec = np.repeat(np.repeat(rec, ry, axis=1), rx, axis=2)
                rec = rec[:, :th, :tw]
            out[:, ty0 - yos:ty1 - yos, tx0 - xos:tx1 - xos, c] = rec
    return [out[k] for k in range(nframes)]


def sharded_tile_coeffs(padded, rects, nlv, bit_depth, signed, use_mct,
                        ncomp, lossless, mesh, mct_bindings=None,
                        mct_matrix=None, mct_offsets=None):
    """The sharded device stage: per-tile DC shift (+MCT) + DWT over a
    padded frame batch, frame-axis sharded.  Returns one [F, C, th, tw]
    array per tile (int32 for 5/3, float32 pre-quant for 9/7).

    Integer (lossless, no float MCT) results are bitwise identical to
    every scalar lane.  Float stages — the 9/7, and Part-2 custom
    matrices/bindings (applied before the DWT like the scalar
    _tile_coeffs_device, with the same lossless re-rounding) — match
    the scalar jit lane except for occasional one-ulp differences
    between differently-compiled XLA programs (batched/partitioned vs
    per-frame), which can flip a rounding or quantization tie;
    byte-level determinism claims therefore hold for a FIXED transform
    program, not across program shapes (same policy as the
    native-vs-jit float 9/7 lanes, CLAUDE.md)."""
    from ..ops.dwt53 import fwd53_multilevel
    from ..ops.dwt97 import fwd97_multilevel
    from ..ops.mct import dc_level_shift, ict_forward, rct_forward

    def _apply_matrix(comps, matrix, offsets):
        # batched mirror of ops.mct.mct_matrix_forward ([F, C, h, w]):
        # offsets SUBTRACT before the matrix, float32 accumulation
        x = comps.astype(jnp.float32)
        if offsets is not None:
            x = x - jnp.asarray(np.asarray(offsets, dtype=np.float32)
                                )[None, :, None, None]
        m = jnp.asarray(np.asarray(matrix, dtype=np.float32))
        return jnp.einsum("ij,fjhw->fihw", m, x, precision=MCT_PRECISION,
                          preferred_element_type=jnp.float32)

    def stage(x):
        # x: [F, H, W, C] int32 — same op sequence per tile as the
        # scalar _tile_coeffs_device (all elementwise, so results are
        # bitwise identical under frame-axis sharding)
        outs = []
        for (tx0, ty0, tx1, ty1) in rects:
            tile = jnp.moveaxis(x[:, ty0:ty1, tx0:tx1, :], -1, 1)
            comps = dc_level_shift(tile, bit_depth, signed)  # [F,C,h,w]
            if mct_bindings:
                for b in mct_bindings:
                    ids = list(b.component_ids) or list(range(ncomp))
                    idx = jnp.asarray(ids)
                    offs = (np.asarray(b.offsets, dtype=np.float32)
                            if b.offsets else None)
                    sub = _apply_matrix(comps[:, idx].astype(jnp.float32),
                                        b.matrix, offs)
                    comps = comps.astype(jnp.float32).at[:, idx].set(sub)
                if lossless:
                    comps = jnp.round(comps).astype(jnp.int32)
            elif mct_matrix is not None:
                comps = _apply_matrix(comps, mct_matrix, mct_offsets)
                if lossless:
                    comps = jnp.round(comps).astype(jnp.int32)
            if lossless:
                if use_mct and ncomp == 3 and mct_matrix is None:
                    y, u, v = rct_forward(comps[:, 0], comps[:, 1],
                                          comps[:, 2])
                    comps = jnp.stack([y, u, v], axis=1)
                outs.append(fwd53_multilevel(comps.astype(jnp.int32),
                                             nlv, x0=tx0, y0=ty0))
            else:
                if use_mct and ncomp == 3 and mct_matrix is None:
                    y, cb, cr = ict_forward(comps[:, 0], comps[:, 1],
                                            comps[:, 2])
                    comps = jnp.stack([y, cb, cr], axis=1)
                else:
                    comps = comps.astype(jnp.float32)
                outs.append(fwd97_multilevel(comps, nlv, x0=tx0, y0=ty0))
        return tuple(outs)

    sharding = NamedSharding(mesh, P((FRAME_AXIS, TILE_AXIS)))
    x = jax.device_put(jnp.asarray(np.asarray(padded).astype(np.int32)),
                       sharding)
    tiles = jax.jit(stage, out_shardings=sharding)(x)
    _log_shard_devices("mesh.sharded_tile_coeffs", tiles[0])
    return [np.asarray(t) for t in tiles]
