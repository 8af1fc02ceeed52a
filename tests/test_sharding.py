"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

The device test layer SURVEY.md §4 calls for: device-vs-host kernel
equivalence under sharding, frame/tile mesh scale-out, and the collective
aggregation used for global rate allocation.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
from jax import shard_map

from go_dicom_codec_jax.ops.dwt53 import fwd53_multilevel, inv53_multilevel
from go_dicom_codec_jax.parallel import (FRAME_AXIS, TILE_AXIS, make_mesh,
                                         frame_sharding, pad_batch_to_devices)
from go_dicom_codec_jax.pipeline import j2k_lossless_encode_transform


def test_eight_virtual_devices():
    assert len(jax.devices()) == 8


def test_make_mesh_shapes():
    m = make_mesh(8, tile_parallel=2)
    assert m.shape[FRAME_AXIS] == 4 and m.shape[TILE_AXIS] == 2
    m1 = make_mesh(8)
    assert m1.shape[FRAME_AXIS] == 8
    with pytest.raises(ValueError):
        make_mesh(8, tile_parallel=3)


def test_sharded_dwt_matches_single_device(rng):
    """DWT over a frame-sharded batch == per-frame single-device DWT."""
    frames = rng.integers(-2048, 2048, size=(8, 64, 64)).astype(np.int32)
    mesh = make_mesh(8)
    sharded = jax.device_put(jnp.asarray(frames), frame_sharding(mesh))
    out_sharded = np.asarray(jax.jit(
        lambda x: fwd53_multilevel(x, 3))(sharded))
    out_single = np.asarray(fwd53_multilevel(jnp.asarray(frames), 3))
    np.testing.assert_array_equal(out_sharded, out_single)


def test_shard_map_tile_pipeline_with_collective(rng):
    """Full sharded encode-transform step with a psum over the mesh."""
    mesh = make_mesh(8, tile_parallel=2)
    F, T, H, W = 8, 4, 32, 32
    frames = rng.integers(0, 1 << 12, size=(F, T, H, W)).astype(np.int32)

    def step(local):
        f, t = local.shape[0], local.shape[1]
        coeffs, cb_max, cb_bits = j2k_lossless_encode_transform(
            local.reshape(f * t, H, W), levels=2, bits=12, cb=16)
        total_bits = jax.lax.psum(jnp.sum(cb_bits.astype(jnp.int32)),
                                  axis_name=(FRAME_AXIS, TILE_AXIS))
        return coeffs.reshape(f, t, H, W), total_bits

    fn = shard_map(step, mesh=mesh, in_specs=P(FRAME_AXIS, TILE_AXIS),
                   out_specs=(P(FRAME_AXIS, TILE_AXIS), P()),
                   check_vma=False)
    x = jax.device_put(jnp.asarray(frames),
                       NamedSharding(mesh, P(FRAME_AXIS, TILE_AXIS)))
    coeffs, total = jax.jit(fn)(x)
    assert coeffs.shape == (F, T, H, W)

    # reference: unsharded computation
    ref_coeffs, ref_max, ref_bits = j2k_lossless_encode_transform(
        jnp.asarray(frames.reshape(F * T, H, W)), levels=2, bits=12, cb=16)
    np.testing.assert_array_equal(
        np.asarray(coeffs).reshape(F * T, H, W), np.asarray(ref_coeffs))
    assert int(total) == int(np.asarray(ref_bits).sum())


def test_sharded_roundtrip_inverse(rng):
    """fwd + inv DWT under frame sharding is identity."""
    frames = rng.integers(-500, 500, size=(8, 40, 56)).astype(np.int32)
    mesh = make_mesh(8)
    x = jax.device_put(jnp.asarray(frames), frame_sharding(mesh))

    @jax.jit
    def roundtrip(v):
        return inv53_multilevel(fwd53_multilevel(v, 2), 2)

    np.testing.assert_array_equal(np.asarray(roundtrip(x)), frames)


def test_pad_batch_to_devices():
    batch = np.ones((5, 4, 4), dtype=np.int32)
    padded, orig = pad_batch_to_devices(batch, 8)
    assert padded.shape[0] == 8 and orig == 5
    assert (padded[5:] == 0).all()


def test_encode_frames_sharded_byte_identical(rng):
    """The mesh-sharded multi-frame encode produces byte-identical
    codestreams to the scalar single-frame encoder, across all 8
    virtual devices."""
    from go_dicom_codec_jax.parallel.mesh import (encode_frames_sharded,
                                                  make_mesh)
    from go_dicom_codec_jax.pipeline import encode_frames_pipelined

    frames = (np.cumsum(rng.integers(-9, 10, (5, 64, 64)), axis=2)
              % 4096).astype(np.int32)
    mesh = make_mesh(tile_parallel=2)
    sharded = encode_frames_sharded(frames, bit_depth=12, levels=3,
                                    mesh=mesh)
    scalar = encode_frames_pipelined(frames, bit_depth=12, levels=3)
    assert len(sharded) == 5
    assert sharded == scalar


@pytest.mark.parametrize("name,kw,shape,bits", [
    ("multi_tile", dict(tile_width=48, tile_height=40), (3, 96, 80), 12),
    ("rgb_mct", dict(), (2, 64, 64, 3), 8),
    ("lossy_97", dict(lossless=False, quality=60), (2, 96, 80), 12),
    ("rgb_lossy_layers",
     dict(lossless=False, num_layers=3, layer_rates=[8.0, 4.0, 0.0]),
     (2, 64, 64, 3), 8),
    ("precincts",
     dict(precincts=[(6, 6)] * 4, progression=2), (2, 96, 80), 12),
    ("htj2k", dict(htj2k=True), (2, 64, 64), 12),
    ("packed_markers",
     dict(packed_headers=True, use_sop=True, use_eph=True,
          plt_markers=True, tlm_markers=True, tile_width=48,
          tile_height=40), (2, 96, 80), 12),
])
def test_encode_frames_sharded_full_surface(name, kw, shape, bits, rng):
    """VERDICT r3 #3: the mesh-sharded encode covers the full parameter
    surface — multi-tile, RGB/MCT, multi-layer, lossy 9/7, precincts —
    each byte-identical to the scalar encoder on the same transform
    lane (jit; lossy 9/7 compares native-disabled because the native
    f32 host path is a different lossy rounding profile)."""
    import go_dicom_codec_jax.native as natmod
    from go_dicom_codec_jax.codecs.jpeg2000 import (J2KEncodeParams,
                                                    J2KEncoder)
    from go_dicom_codec_jax.parallel.mesh import (encode_frames_sharded,
                                                  make_mesh)

    from go_dicom_codec_jax.codecs.jpeg2000 import decode_to_pixels

    frames = rng.integers(0, 1 << bits, shape).astype(np.int32)
    mesh = make_mesh()
    sharded = encode_frames_sharded(
        frames, bit_depth=bits, levels=3, mesh=mesh,
        params=J2KEncodeParams(num_levels=3, **kw))
    lossless = kw.get("lossless", True)
    ncomp = shape[3] if len(shape) == 4 else 1
    nf, hh, ww = shape[0], shape[1], shape[2]
    enc = J2KEncoder(J2KEncodeParams(num_levels=3, **kw))
    if lossless:
        # integer transforms: bitwise identical on every lane ->
        # full end-to-end byte-identity vs the scalar encoder
        scalar = [enc.encode(frames[i], ww, hh, ncomp, bits)
                  for i in range(nf)]
        assert sharded == scalar
    else:
        # float 9/7: XLA may emit one-ulp-different programs for the
        # batched/partitioned vs per-frame shapes (can flip a quant
        # tie), so (a) byte-identity is asserted for the host side —
        # entropy/PCRD/headers given the SAME coefficients — and
        # (b) the end-to-end streams decode within a tie tolerance.
        from go_dicom_codec_jax.codecs.j2k_geometry import (
            packed_band_layout)
        from go_dicom_codec_jax.codecs import j2k_quant as jq
        from go_dicom_codec_jax.codecs.jpeg2000 import _band_index
        from go_dicom_codec_jax.parallel.mesh import (pad_batch_to_devices,
                                                      sharded_tile_coeffs)
        padded, _ = pad_batch_to_devices(
            frames if frames.ndim == 4 else frames[..., None], 8)
        # same tiles the sharded encode used
        nlv = 3
        use_mct = ncomp == 3
        from go_dicom_codec_jax.codestream import j2k as j2kcs
        siz = j2kcs.SizInfo(xsiz=ww, ysiz=hh, xtsiz=kw.get(
            "tile_width", 0) or ww, ytsiz=kw.get("tile_height", 0) or hh,
            components=[(bits, False, 1, 1)] * ncomp)
        ntx, nty = siz.num_tiles
        rects = [siz.tile_rect(ti, tj)
                 for tj in range(nty) for ti in range(ntx)]
        batches = sharded_tile_coeffs(padded, rects, nlv, bits, False,
                                      use_mct, ncomp, False, mesh)
        qcd = enc._build_qcd(nlv, bits, use_mct, ncomp)
        band_steps = enc._band_deltas(qcd, nlv, bits)
        scalar = []
        for i in range(nf):
            tiles = []
            for tidx, (tx0, ty0, tx1, ty1) in enumerate(rects):
                fcoeffs = batches[tidx][i]
                tc = np.zeros_like(fcoeffs, dtype=np.int32)
                for bg in packed_band_layout(tx0, ty0, tx1, ty1, nlv):
                    delta = band_steps[_band_index(bg.resolution,
                                                   bg.band)]
                    sl = (slice(None),
                          slice(bg.row_off, bg.row_off + bg.height),
                          slice(bg.col_off, bg.col_off + bg.width))
                    tc[sl] = jq.deadzone_quantize(fcoeffs[sl], delta)
                tiles.append(tc)
            scalar.append(enc.encode(frames[i], ww, hh, ncomp, bits,
                                     precomputed_tiles=tiles))
        assert sharded == scalar     # host side fully deterministic
        # end-to-end: sharded streams track the true scalar encode
        orig = natmod.get_lib
        natmod.get_lib = lambda: None
        try:
            enc2 = J2KEncoder(J2KEncodeParams(num_levels=3, **kw))
            true_scalar = [enc2.encode(frames[i], ww, hh, ncomp, bits)
                           for i in range(nf)]
        finally:
            natmod.get_lib = orig
        for a, b in zip(sharded, true_scalar):
            ra = np.frombuffer(decode_to_pixels(a)[0], dtype="<u2")
            rb = np.frombuffer(decode_to_pixels(b)[0], dtype="<u2")
            err = np.abs(ra.astype(np.int64) - rb.astype(np.int64))
            assert err.max() <= 16, err.max()


@pytest.mark.parametrize("style", ["maxshift", "general"])
def test_encode_frames_sharded_roi(style, rng):
    """ROI shards too: the mask pre-shift applies on the host inside
    encode(precomputed_tiles=...) — byte-identical to scalar."""
    from go_dicom_codec_jax.codecs.j2k_roi import ROIRegion
    from go_dicom_codec_jax.codecs.jpeg2000 import (J2KEncodeParams,
                                                    J2KEncoder)
    from go_dicom_codec_jax.parallel.mesh import (encode_frames_sharded,
                                                  make_mesh)

    frames = (np.cumsum(rng.integers(-9, 10, (3, 64, 64)), axis=2)
              % 4096).astype(np.int32)
    kw = dict(num_levels=3, cb_style=0,
              roi_regions=[ROIRegion(shape="rect", rect=(8, 8, 24, 24))],
              roi_style=style)
    sharded = encode_frames_sharded(frames, bit_depth=12,
                                    mesh=make_mesh(),
                                    params=J2KEncodeParams(**kw))
    enc = J2KEncoder(J2KEncodeParams(**kw))
    assert sharded == [enc.encode(f, 64, 64, 1, 12) for f in frames]


def test_decode_frames_sharded_roi_both_styles(rng):
    """ROI streams shard on decode too: MaxShift unshifts by
    magnitude, General-Scaling by the JP2ROI COM geometry masks, both
    on the packed host coefficients — bit-identical to scalar."""
    from go_dicom_codec_jax.codecs.j2k_roi import ROIRegion
    from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder,
                                                    J2KEncodeParams,
                                                    J2KEncoder)
    from go_dicom_codec_jax.parallel.mesh import (decode_frames_sharded,
                                                  make_mesh)

    frames = (np.cumsum(rng.integers(-9, 10, (3, 64, 64)), axis=2)
              % 4096).astype(np.int32)
    mesh = make_mesh()
    for style in ("maxshift", "general"):
        kw = dict(num_levels=3, cb_style=0,
                  roi_regions=[ROIRegion(shape="rect",
                                         rect=(8, 8, 24, 24))],
                  roi_style=style)
        enc = J2KEncoder(J2KEncodeParams(**kw))
        streams = [enc.encode(f, 64, 64, 1, 12) for f in frames]
        sharded = decode_frames_sharded(streams, mesh=mesh)
        dec = J2KDecoder()
        for i, df in enumerate(sharded):
            scalar, _, _ = dec.decode(streams[i])
            np.testing.assert_array_equal(df, scalar, err_msg=style)


@pytest.mark.parametrize("name,shape,bits,kw", [
    ("gray", (5, 64, 64), 12, {}),
    ("rgb_rct", (3, 48, 56), 8, {}),
    ("gray_deep", (2, 96, 80), 16, {"num_levels": 4}),
    ("htj2k", (3, 64, 64), 12, {"htj2k": True}),
])
def test_decode_frames_sharded_bit_identical(name, shape, bits, kw, rng):
    """Round-4: the mesh-sharded DECODE (host entropy per frame + one
    frame-axis-sharded inverse-transform launch) is bit-identical to
    the scalar decoder across the 8 virtual devices."""
    from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder,
                                                    J2KEncodeParams,
                                                    J2KEncoder)
    from go_dicom_codec_jax.parallel.mesh import (decode_frames_sharded,
                                                  make_mesh)

    frames = rng.integers(0, 1 << bits, shape).astype(np.int32)
    ncomp = shape[3] if len(shape) == 4 else 1
    nf, hh, ww = shape[0], shape[1], shape[2]
    enc = J2KEncoder(J2KEncodeParams(**{"num_levels": 3, **kw}))
    streams = [enc.encode(frames[i], ww, hh, ncomp, bits)
               for i in range(nf)]

    mesh = make_mesh()
    sharded = decode_frames_sharded(streams, mesh=mesh)
    dec = J2KDecoder()
    for i, df in enumerate(sharded):
        scalar, _, _ = dec.decode(streams[i])
        np.testing.assert_array_equal(df, scalar)
        want = frames[i] if ncomp > 1 else frames[i][..., None]
        np.testing.assert_array_equal(df.astype(np.int64),
                                      want.astype(np.int64))


def test_decode_frames_sharded_lossy_within_tie_tolerance(rng):
    """Irreversible streams shard too: host dequant + sharded float 9/7
    inverse. Pixels match the scalar decoder within ±1 (one-ulp float
    program differences can flip a rounding tie — same policy as the
    sharded lossy encode)."""
    from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder,
                                                    J2KEncodeParams,
                                                    J2KEncoder)
    from go_dicom_codec_jax.parallel.mesh import decode_frames_sharded

    frames = (np.cumsum(rng.integers(-9, 10, (3, 64, 64)), axis=2)
              % 256).astype(np.int32)
    enc = J2KEncoder(J2KEncodeParams(num_levels=3, lossless=False,
                                     quality=90))
    streams = [enc.encode(frames[i], 64, 64, 1, 8) for i in range(3)]
    sharded = decode_frames_sharded(streams)
    dec = J2KDecoder()
    for i, df in enumerate(sharded):
        scalar, _, _ = dec.decode(streams[i])
        diff = np.abs(df.astype(np.int64) - scalar.astype(np.int64))
        assert diff.max() <= 1
        err = np.abs(df[..., 0].astype(np.int64)
                     - frames[i].astype(np.int64))
        assert err.max() <= 12 and err.mean() < 2.5


@pytest.mark.parametrize("case", ["matrix", "bindings", "two_bindings",
                                  "lossy_matrix"])
def test_encode_frames_sharded_custom_mct(case, rng):
    """Part-2 custom matrices and MCT bindings shard too (the batched
    stage mirrors _tile_coeffs_device's binding order and the encode's
    use_mct override — bindings/matrix replace RCT/ICT), byte-identical
    to the scalar encoder on this backend."""
    from go_dicom_codec_jax.codecs.jpeg2000 import (J2KEncodeParams,
                                                    J2KEncoder)
    from go_dicom_codec_jax.codecs.mct_builder import MCTBinding
    from go_dicom_codec_jax.parallel.mesh import (encode_frames_sharded,
                                                  make_mesh)

    m = [[0.5, 0.25, 0.25], [0.25, 0.5, 0.25], [0.25, 0.25, 0.5]]
    minv = np.linalg.inv(np.asarray(m)).tolist()
    b1 = MCTBinding(component_ids=[0, 1, 2], matrix=np.eye(3).tolist(),
                    inverse=np.eye(3).tolist(), offsets=[5.0, 0.0, -5.0])
    b2 = MCTBinding(component_ids=[0, 1],
                    matrix=[[0.7, 0.3], [0.3, 0.7]],
                    inverse=np.linalg.inv([[0.7, 0.3],
                                           [0.3, 0.7]]).tolist(),
                    offsets=None)
    kw = {
        "matrix": dict(mct_matrix=m, mct_inverse=minv),
        "bindings": dict(mct_bindings=[b1]),
        "two_bindings": dict(mct_bindings=[b1, b2]),
        "lossy_matrix": dict(mct_matrix=m, mct_inverse=minv,
                             lossless=False, quality=90),
    }[case]
    rgb = rng.integers(0, 256, (3, 48, 48, 3)).astype(np.int32)
    sharded = encode_frames_sharded(
        rgb, bit_depth=8, mesh=make_mesh(),
        params=J2KEncodeParams(num_levels=3, **kw))
    enc = J2KEncoder(J2KEncodeParams(num_levels=3, **kw))
    assert sharded == [enc.encode(rgb[i], 48, 48, 3, 8) for i in range(3)]


@pytest.mark.parametrize("case", ["gray_lossless", "rgb_lossy"])
def test_decode_frames_sharded_multitile(case, rng):
    """Multi-tile streams shard on decode too: one frame-batched
    inverse launch per tile (the decode mirror of the per-tile encode
    batches)."""
    from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder,
                                                    J2KEncodeParams,
                                                    J2KEncoder)
    from go_dicom_codec_jax.parallel.mesh import (decode_frames_sharded,
                                                  make_mesh)

    mesh = make_mesh()
    if case == "gray_lossless":
        frames = (np.cumsum(rng.integers(-9, 10, (3, 96, 80)), axis=2)
                  % 4096).astype(np.int32)
        enc = J2KEncoder(J2KEncodeParams(num_levels=3, tile_width=48,
                                         tile_height=40))
        streams = [enc.encode(f, 80, 96, 1, 12) for f in frames]
        dec = decode_frames_sharded(streams, mesh=mesh)
        for d, f in zip(dec, frames):
            np.testing.assert_array_equal(d[..., 0], f)
    else:
        rgb = rng.integers(0, 256, (3, 96, 96, 3)).astype(np.int32)
        enc = J2KEncoder(J2KEncodeParams(num_levels=3, tile_width=48,
                                         tile_height=48, lossless=False,
                                         quality=90))
        streams = [enc.encode(f, 96, 96, 3, 8) for f in rgb]
        dec = decode_frames_sharded(streams, mesh=mesh)
        scalar = [J2KDecoder().decode(s)[0] for s in streams]
        for d, s in zip(dec, scalar):
            assert np.abs(d.astype(np.int64)
                          - s.astype(np.int64)).max() <= 1


@pytest.mark.parametrize("case", ["matrix_lossless", "bindings_lossless",
                                  "matrix_lossy"])
def test_decode_frames_sharded_custom_mct(case, rng):
    """Part-2 custom MCT streams shard on decode: the batched stage
    applies the marker-carried inverse matrices (reverse MCO order)
    like the scalar decoder, within one rounding tie."""
    from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder,
                                                    J2KEncodeParams,
                                                    J2KEncoder)
    from go_dicom_codec_jax.codecs.mct_builder import MCTBinding
    from go_dicom_codec_jax.parallel.mesh import (decode_frames_sharded,
                                                  make_mesh)

    m = [[0.5, 0.25, 0.25], [0.25, 0.5, 0.25], [0.25, 0.25, 0.5]]
    minv = np.linalg.inv(np.asarray(m)).tolist()
    b = MCTBinding(component_ids=[0, 1, 2], matrix=np.eye(3).tolist(),
                   inverse=np.eye(3).tolist(), offsets=[5.0, 0.0, -5.0])
    kw = {
        "matrix_lossless": dict(mct_matrix=m, mct_inverse=minv),
        "bindings_lossless": dict(mct_bindings=[b]),
        "matrix_lossy": dict(mct_matrix=m, mct_inverse=minv,
                             lossless=False, quality=90),
    }[case]
    rgb = rng.integers(0, 256, (3, 48, 48, 3)).astype(np.int32)
    enc = J2KEncoder(J2KEncodeParams(num_levels=3, **kw))
    streams = [enc.encode(rgb[i], 48, 48, 3, 8) for i in range(3)]
    dec = decode_frames_sharded(streams, mesh=make_mesh())
    for d, s in zip(dec, streams):
        scalar, _, _ = J2KDecoder().decode(s)
        assert np.abs(d.astype(np.int64)
                      - scalar.astype(np.int64)).max() <= 1


# ---- heterogeneous streams (subsampled / COC / QCC / per-tile) -------------

def _remux_two_component(frame_a, frame_b, sub, levels_b=None):
    """One 2-component codestream from two gray frames: comp 1 either
    2x2-subsampled (sub=True) or COC/QCC-overridden to its own levels
    (the remux recipes of tests/test_j2k_markers.py, reused here to
    drive the sharded decoder's heterogeneous path)."""
    from test_j2k_markers import _encode_gray, _split_packets

    from go_dicom_codec_jax.codestream import j2k

    cs_a = j2k.parse_codestream(_encode_gray(frame_a, levels=2))
    cs_b = j2k.parse_codestream(_encode_gray(
        frame_b, levels=2 if levels_b is None else levels_b))
    pk_a = _split_packets(cs_a.tiles[0].data, cs_a.siz.tile_rect(0, 0),
                          cs_a.cod, cs_a.qcd)
    pk_b = _split_packets(cs_b.tiles[0].data, cs_b.siz.tile_rect(0, 0),
                          cs_b.cod, cs_b.qcd)
    tagged = [(r, 0, blob) for (r, blob) in pk_a] + \
             [(r, 1, blob) for (r, blob) in pk_b]
    tagged.sort(key=lambda t: (t[0], t[1]))
    body = b"".join(blob for (_, _, blob) in tagged)

    h, w = frame_a.shape
    sb = 2 if sub else 1
    siz = j2k.SizInfo(xsiz=w, ysiz=h, xtsiz=w, ytsiz=h,
                      components=[cs_a.siz.components[0],
                                  (16, False, sb, sb)])
    out = bytearray(b"\xff\x4f")
    out += j2k.write_siz(siz)
    out += j2k.write_cod(cs_a.cod)
    if levels_b is not None:
        coc = j2k.CocInfo(comp=1, num_levels=cs_b.cod.num_levels,
                          cb_width=cs_b.cod.cb_width,
                          cb_height=cs_b.cod.cb_height,
                          cb_style=cs_b.cod.cb_style,
                          transform=cs_b.cod.transform)
        out += j2k.write_coc(coc, 2)
    out += j2k.write_qcd(cs_a.qcd)
    out += j2k.write_qcc(1, cs_b.qcd, 2)
    out += j2k.write_tile_part(0, body)
    out += j2k.EOC.to_bytes(2, "big")
    return bytes(out)


@pytest.mark.parametrize("case", ["subsampled", "coc_levels"])
def test_decode_frames_sharded_heterogeneous(case, rng):
    """Subsampled-component and COC/QCC-override streams shard on
    decode through the per-component path: one frame-batched inverse
    launch per tile-component on its own grid, bit-identical to the
    scalar decoder (which reconstructs such components independently
    and replication-upsamples)."""
    from go_dicom_codec_jax.codecs.jpeg2000 import J2KDecoder
    from go_dicom_codec_jax.parallel.mesh import (decode_frames_sharded,
                                                  make_mesh)

    streams = []
    for k in range(3):
        a = rng.integers(0, 1 << 16, (64, 64), dtype=np.uint16)
        if case == "subsampled":
            b = rng.integers(0, 1 << 16, (32, 32), dtype=np.uint16)
            streams.append(_remux_two_component(a, b, sub=True))
        else:
            b = rng.integers(0, 1 << 16, (64, 64), dtype=np.uint16)
            streams.append(_remux_two_component(a, b, sub=False,
                                                levels_b=1))
    dec = decode_frames_sharded(streams, mesh=make_mesh())
    for d, s in zip(dec, streams):
        scalar, _, _ = J2KDecoder().decode(s)
        np.testing.assert_array_equal(d, scalar)


def test_decode_frames_sharded_per_tile_cod_override(rng):
    """Per-tile COD overrides (a tile-part COD segment) shard through
    the heterogeneous path too. The injected COD differs only in
    progression order — for a single-component single-layer
    one-precinct tile every progression emits the same packet
    sequence, so the stream stays self-consistent while exercising
    the per-tile override plumbing end to end."""
    import dataclasses
    import struct

    from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder,
                                                    J2KEncodeParams,
                                                    J2KEncoder)
    from go_dicom_codec_jax.codestream import j2k
    from go_dicom_codec_jax.parallel.mesh import (decode_frames_sharded,
                                                  make_mesh)

    frames = (np.cumsum(rng.integers(-9, 10, (3, 64, 48)), axis=2)
              % 4096).astype(np.int32)
    enc = J2KEncoder(J2KEncodeParams(num_levels=2, tile_width=24,
                                     tile_height=64))
    streams = []
    for f in frames:
        s = enc.encode(f, 48, 64, 1, 12)
        cs = j2k.parse_codestream(s)
        cod1 = dataclasses.replace(cs.cod, progression=1)  # RLCP
        # rebuild: main header + tile 0 as-is + tile 1 with a local COD
        sot1 = s.index(struct.pack(">HHH", j2k.SOT, 10, 1))
        body1 = cs.tiles[1].data
        cod_seg = j2k.write_cod(cod1)
        psot = 12 + len(cod_seg) + 2 + len(body1)
        tile1 = struct.pack(">HHHIBB", j2k.SOT, 10, 1, psot, 0, 1)
        tile1 += cod_seg + struct.pack(">H", j2k.SOD) + body1
        streams.append(s[:sot1] + tile1 + j2k.EOC.to_bytes(2, "big"))
    dec = decode_frames_sharded(streams, mesh=make_mesh())
    for d, s, f in zip(dec, streams, frames):
        scalar, _, _ = J2KDecoder().decode(s)
        np.testing.assert_array_equal(d, scalar)
        np.testing.assert_array_equal(d[..., 0], f)


def test_decode_frames_sharded_per_tile_cod_rgb_mct(rng):
    """Per-tile-COD RGB RCT streams route through the heterogeneous
    sharded path, but each tile is homogeneous in the scalar sense
    (uniform grids, one transform/levels) — so the scalar decoder
    applies inverse RCT and the sharded mirror must too (whole-tile MCT
    launch), bit-identical. Regression: the hetero path used to
    reconstruct Y/Cb/Cr independently and emit them as R/G/B."""
    import dataclasses
    import struct

    from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder,
                                                    J2KEncodeParams,
                                                    J2KEncoder)
    from go_dicom_codec_jax.codestream import j2k
    from go_dicom_codec_jax.parallel.mesh import (decode_frames_sharded,
                                                  make_mesh)

    frames = (np.cumsum(rng.integers(-5, 6, (3, 64, 48, 3)), axis=2)
              % 256).astype(np.uint8)
    enc = J2KEncoder(J2KEncodeParams(num_levels=2, tile_width=24,
                                     tile_height=64))
    streams = []
    for f in frames:
        s = enc.encode(f.tobytes(), 48, 64, 3, 8)
        cs = j2k.parse_codestream(s)
        assert cs.cod.mct == 1
        cod1 = dataclasses.replace(cs.cod, progression=1)  # RLCP
        sot1 = s.index(struct.pack(">HHH", j2k.SOT, 10, 1))
        body1 = cs.tiles[1].data
        cod_seg = j2k.write_cod(cod1)
        psot = 12 + len(cod_seg) + 2 + len(body1)
        tile1 = struct.pack(">HHHIBB", j2k.SOT, 10, 1, psot, 0, 1)
        tile1 += cod_seg + struct.pack(">H", j2k.SOD) + body1
        streams.append(s[:sot1] + tile1 + j2k.EOC.to_bytes(2, "big"))
    dec = decode_frames_sharded(streams, mesh=make_mesh())
    for d, s, f in zip(dec, streams, frames):
        scalar, _, _ = J2KDecoder().decode(s)
        np.testing.assert_array_equal(d, scalar)
        np.testing.assert_array_equal(d.astype(np.uint8), f)


def test_decode_frames_sharded_qcc_override_rgb_ict(rng):
    """A lossy RGB stream with a chroma QCC override is rejected by the
    packed path (per-component dequant) and shards through the hetero
    path — whose whole-tile MCT launch must apply inverse ICT like the
    scalar decoder (±1: one-ulp float program differences)."""
    import dataclasses
    import struct

    from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder,
                                                    J2KEncodeParams,
                                                    J2KEncoder)
    from go_dicom_codec_jax.codestream import j2k
    from go_dicom_codec_jax.parallel.mesh import (decode_frames_sharded,
                                                  make_mesh)

    frames = (np.cumsum(rng.integers(-5, 6, (3, 64, 64, 3)), axis=2)
              % 256).astype(np.uint8)
    enc = J2KEncoder(J2KEncodeParams(num_levels=3, lossless=False,
                                     quality=90))
    streams = []
    for f in frames:
        s = enc.encode(f.tobytes(), 64, 64, 3, 8)
        cs = j2k.parse_codestream(s)
        assert cs.cod.mct == 1 and cs.cod.transform == 0
        # inject a comp-2 QCC whose steps differ from the QCD (both
        # lanes see the same stream, so parity must still hold)
        qcd2 = dataclasses.replace(
            cs.qcd, steps=[(e, max(m - 64, 0))
                           for (e, m) in cs.qcd.steps])
        qcc = j2k.write_qcc(2, qcd2, 3)
        sot0 = s.index(struct.pack(">HHH", j2k.SOT, 10, 0))
        streams.append(s[:sot0] + qcc + s[sot0:])
    dec = decode_frames_sharded(streams, mesh=make_mesh())
    for d, s in zip(dec, streams):
        scalar, _, _ = J2KDecoder().decode(s)
        diff = np.abs(d.astype(np.int64) - scalar.astype(np.int64))
        assert diff.max() <= 1


def test_decode_frames_sharded_mixed_batch_raises(rng):
    """A batch mixing a uniform stream with a heterogeneous one is not
    equal-geometry: the fallback dispatch must raise, not silently
    decode through the wrong path."""
    from go_dicom_codec_jax.codecs.jpeg2000 import (J2KEncodeParams,
                                                    J2KEncoder)
    from go_dicom_codec_jax.errors import UnsupportedFormatError
    from go_dicom_codec_jax.parallel.mesh import (decode_frames_sharded,
                                                  make_mesh)

    a = rng.integers(0, 1 << 16, (64, 64), dtype=np.uint16)
    b = rng.integers(0, 1 << 16, (32, 32), dtype=np.uint16)
    uniform = J2KEncoder(J2KEncodeParams(num_levels=2)).encode(
        a.astype(np.int32), 64, 64, 1, 16)
    hetero = _remux_two_component(a, b, sub=True)
    with pytest.raises(UnsupportedFormatError):
        decode_frames_sharded([uniform, hetero], mesh=make_mesh())
    with pytest.raises(UnsupportedFormatError):
        decode_frames_sharded([hetero, uniform], mesh=make_mesh())
