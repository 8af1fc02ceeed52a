"""Reduced-resolution decode (J2KDecoder(reduce=R), OpenJPEG -r
analogue — beyond the reference, which always reconstructs full size).

Ground truth for reversible streams: the decoder's level-R output must
equal the forward 5/3 DWT's LL window of the (DC-shifted) source —
T1 is lossless and the kept bands reconstruct the LL exactly. The
inverse runs R levels short, so a reduce=2 thumbnail costs ~1/10th of
a full decode (see BENCHMARKS.md).
"""

import numpy as np
import pytest

from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder,
                                                J2KEncodeParams, J2KEncoder,
                                                decode_to_pixels)
from go_dicom_codec_jax.ops.dwt53 import fwd53_multilevel, ll_dimensions
from go_dicom_codec_jax.errors import UnsupportedFormatError


def _img(h=200, w=190, seed=0, bits=12):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 1 << bits, size=(h, w)).astype(np.int32)


def _ll(img, levels, bits=12):
    """Forward-DWT LL window of a single-tile image (+DC shift undone,
    clipped like pack_decoded_pixels)."""
    import jax.numpy as jnp
    sh = img - (1 << (bits - 1))
    coeffs = np.asarray(fwd53_multilevel(jnp.asarray(sh), levels))
    lw, lh = ll_dimensions(img.shape[1], img.shape[0], levels)
    ll = coeffs[:lh, :lw] + (1 << (bits - 1))
    return np.clip(ll, 0, (1 << bits) - 1)


@pytest.mark.parametrize("r", [1, 2, 3, 5])
@pytest.mark.parametrize("kw", [dict(), dict(htj2k=True), dict(cb_style=0),
                                dict(htj2k=True, ht_refinement=True)],
                         ids=["mq-lazy", "ht", "mq", "ht-refined"])
def test_reversible_reduce_is_the_exact_ll(r, kw):
    img = _img()
    s = J2KEncoder(J2KEncodeParams(**kw)).encode(img, 190, 200, 1, 12)
    arr, siz, cod = J2KDecoder(reduce=r).decode(s)
    lw, lh = ll_dimensions(190, 200, r)
    assert arr.shape == (lh, lw, 1)
    got = np.clip(arr[:, :, 0], 0, 4095)
    assert np.array_equal(got, _ll(img, r))


def test_reduce_multi_tile_mosaic():
    """Each reduced tile equals its own tile's LL window."""
    img = _img()
    s = J2KEncoder(J2KEncodeParams(tile_width=96, tile_height=80)
                   ).encode(img, 190, 200, 1, 12)
    r = 2
    arr = J2KDecoder(reduce=r).decode(s)[0][:, :, 0]
    lw, lh = ll_dimensions(190, 200, r)
    assert arr.shape == (lh, lw)

    def rd(v):
        return -(-v // (1 << r))

    for ty in range(0, 200, 80):
        for tx in range(0, 190, 96):
            tile = img[ty:ty + 80, tx:tx + 96]
            exp = _ll(tile, r)
            got = np.clip(arr[rd(ty):rd(min(ty + 80, 200)),
                              rd(tx):rd(min(tx + 96, 190))], 0, 4095)
            assert np.array_equal(got, exp), (tx, ty)


def test_reduce_with_odd_dims_and_deep_reduce():
    img = _img(h=97, w=61, seed=3)
    s = J2KEncoder(J2KEncodeParams()).encode(img, 61, 97, 1, 12)
    for r in (1, 4):
        arr = J2KDecoder(reduce=r).decode(s)[0][:, :, 0]
        assert np.array_equal(np.clip(arr, 0, 4095), _ll(img, r))


def test_reduce_rgb_rct():
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, size=(120, 110, 3)).astype(np.int32)
    s = J2KEncoder(J2KEncodeParams()).encode(
        np.ascontiguousarray(np.moveaxis(img, -1, 0)), 110, 120, 3, 8)
    arr = J2KDecoder(reduce=1).decode(s)[0]
    lw, lh = ll_dimensions(110, 120, 1)
    assert arr.shape == (lh, lw, 3)
    # RCT is applied before the DWT; reconstructing the LL through the
    # inverse RCT has no simple closed form vs the source — pin shape +
    # value plausibility + determinism instead
    assert 0 <= np.clip(arr, 0, 255).mean() <= 255
    again = J2KDecoder(reduce=1).decode(s)[0]
    assert np.array_equal(arr, again)


def test_reduce_lossy_and_layers_shape_and_scale():
    img = _img()
    for kw in (dict(lossless=False, quality=70),
               dict(num_layers=3, progression=2),
               dict(packed_headers=True, use_sop=True, use_eph=True)):
        s = J2KEncoder(J2KEncodeParams(**kw)).encode(img, 190, 200, 1, 12)
        pix, w, h, c, depth, signed = decode_to_pixels(s, reduce=2)
        assert (w, h) == ll_dimensions(190, 200, 2)
        small = np.frombuffer(pix, "<u2").reshape(h, w).astype(np.float64)
        # the LL is a lowpass of the image: means must agree closely
        assert abs(small.mean() - img.mean()) < 16, kw


def test_reduce_maxshift_roi_exact():
    from go_dicom_codec_jax.codecs.j2k_roi import ROIRegion
    img = _img()
    s = J2KEncoder(J2KEncodeParams(
        roi_regions=[ROIRegion(shape="rect", rect=(8, 8, 64, 64))]
    )).encode(img, 190, 200, 1, 12)
    arr = J2KDecoder(reduce=2).decode(s)[0][:, :, 0]
    assert np.array_equal(np.clip(arr, 0, 4095), _ll(img, 2))


def test_reduce_beyond_levels_raises():
    img = _img(64, 64)
    s = J2KEncoder(J2KEncodeParams(num_levels=3)).encode(img[:64, :64],
                                                         64, 64, 1, 12)
    with pytest.raises(UnsupportedFormatError):
        J2KDecoder(reduce=4).decode(s)


def test_reduce_general_scaling_roi_raises():
    from go_dicom_codec_jax.codecs.j2k_roi import ROIRegion
    img = _img()
    s = J2KEncoder(J2KEncodeParams(
        roi_style="general",
        roi_regions=[ROIRegion(shape="rect", rect=(8, 8, 64, 64))]
    )).encode(img, 190, 200, 1, 12)
    with pytest.raises(UnsupportedFormatError):
        J2KDecoder(reduce=1).decode(s)


def test_reduce_zero_matches_default():
    img = _img(96, 96, seed=9)
    s = J2KEncoder(J2KEncodeParams()).encode(img, 96, 96, 1, 12)
    a = J2KDecoder().decode(s)[0]
    b = J2KDecoder(reduce=0).decode(s)[0]
    assert np.array_equal(a, b)


# ---- reduce through the batched/sharded decode paths --------------------

@pytest.mark.parametrize("r", [1, 2])
def test_reduce_pipelined_matches_scalar(r):
    from go_dicom_codec_jax.pipeline import decode_frames_pipelined
    imgs = [_img(seed=i) for i in range(3)]
    enc = J2KEncoder(J2KEncodeParams(num_levels=4))
    streams = [enc.encode(im, 190, 200, 1, 12) for im in imgs]
    got = decode_frames_pipelined(streams, reduce=r)
    for g, im, s in zip(got, imgs, streams):
        ref = J2KDecoder(reduce=r).decode(s)[0]
        assert np.array_equal(g, ref)  # bit-identical incl. overshoot


@pytest.mark.parametrize("kw,exact", [
    (dict(), True),
    (dict(htj2k=True), True),
    (dict(tile_width=96, tile_height=80), True),
    (dict(lossless=False, quality=70), False),
])
def test_reduce_sharded_matches_scalar(kw, exact):
    from go_dicom_codec_jax.parallel.mesh import (decode_frames_sharded,
                                                  make_mesh)
    imgs = [_img(seed=i) for i in range(3)]
    enc = J2KEncoder(J2KEncodeParams(num_levels=4, **kw))
    streams = [enc.encode(im, 190, 200, 1, 12) for im in imgs]
    got = decode_frames_sharded(streams, mesh=make_mesh(), reduce=2)
    for g, s in zip(got, streams):
        ref = J2KDecoder(reduce=2).decode(s)[0]
        if exact:
            assert np.array_equal(g, ref)
        else:
            # float program shapes may flip a quant tie (documented
            # batched-lossy policy); sharded output is range-clipped
            d = np.abs(np.clip(g, 0, 4095).astype(np.int64)
                       - np.clip(ref, 0, 4095).astype(np.int64))
            assert d.max() <= 1


def test_reduce_lossy_pipelined_lanes_agree():
    """Regression: the host and device lanes of decode_frames_pipelined
    must return the SAME pixels for lossy + reduce (both clipped to the
    declared range, the documented batched-lossy policy — the device
    lane's clip was once disabled under reduce while the host lane's
    stayed)."""
    from go_dicom_codec_jax.pipeline import decode_frames_pipelined
    rng = np.random.default_rng(6)
    # step image: the reduced LL rings hard past the declared range
    img = np.where(np.arange(200)[:, None] % 32 < 16, 4095, 0
                   ).astype(np.int32) * np.ones((1, 190), np.int32)
    s = J2KEncoder(J2KEncodeParams(lossless=False, quality=70)
                   ).encode(img, 190, 200, 1, 12)
    dev = decode_frames_pipelined([s], reduce=1, device="device")[0]
    host = decode_frames_pipelined([s], reduce=1, device="host")[0]
    assert dev.min() >= 0 and dev.max() <= 4095  # clipped policy
    d = np.abs(dev.astype(np.int64) - host.astype(np.int64))
    assert d.max() <= 1  # one-ulp float-tie policy between lanes
