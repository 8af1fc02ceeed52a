"""J2K advanced features: multi-layer PCRD, progressive decode, ROI MaxShift.

Mirrors reference multilayer_test.go, progressive_decode_test.go, and the
ROI subsystem tests (roi*.go usage).
"""

import numpy as np
import pytest

from go_dicom_codec_jax.codecs.j2k_roi import (ROIRegion, combined_mask,
                                               rasterize_polygon,
                                               unshift_maxshift)
from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder, J2KEncodeParams,
                                                J2KEncoder, decode_to_pixels)
from go_dicom_codec_jax.codestream import j2k
from go_dicom_codec_jax.t2.pcrd import (allocate_layers,
                                        layer_budgets_from_rates,
                                        pass_slopes)


def test_pass_slopes_monotone():
    rates = [10, 30, 35, 60]
    bitplanes = [3, 2, 2, 1]
    pts = pass_slopes(rates, bitplanes)
    slopes = [p.slope for p in pts]
    assert all(slopes[i] >= slopes[i + 1] - 1e-9 for i in range(len(slopes) - 1))


def test_allocate_layers_monotone():
    blocks = [pass_slopes([10, 20, 30], [2, 1, 0]),
              pass_slopes([5, 50], [3, 0])]
    alloc = allocate_layers(blocks, [30, 80])
    for counts in alloc:
        assert counts == sorted(counts)
        assert counts[-1] == len(blocks[alloc.index(counts)])


def test_layer_budgets():
    b = layer_budgets_from_rates(64 * 64, 16, [16.0, 4.0, 0], 5000)
    assert b[0] == 64 * 64 * 2 // 16
    assert b[1] == 64 * 64 * 2 // 4
    assert b[2] == 0  # trailing rate-0: take-all sentinel
    # a budgeted final layer keeps its byte target (target-ratio mode)
    b2 = layer_budgets_from_rates(64 * 64, 16, [16.0, 4.0], 5000)
    assert b2[1] == 64 * 64 * 2 // 4


@pytest.mark.parametrize("layers", [2, 4])
def test_multilayer_lossless_roundtrip(layers, rng):
    img = rng.integers(0, 4096, size=(48, 48)).astype("<u2")
    enc = J2KEncoder(J2KEncodeParams(num_levels=2, num_layers=layers))
    data = enc.encode(img.tobytes(), 48, 48, 1, 12)
    pix, *_ = decode_to_pixels(data)
    assert pix == img.tobytes()
    cs = j2k.parse_codestream(data)
    assert cs.cod.num_layers == layers


def test_multilayer_with_rates_roundtrip(rng):
    base = np.cumsum(rng.integers(-4, 5, size=(64, 64)), axis=1)
    img = (base - base.min()).astype("<u2")
    enc = J2KEncoder(J2KEncodeParams(num_levels=3, num_layers=3,
                                     layer_rates=[32.0, 8.0, 0]))
    data = enc.encode(img.tobytes(), 64, 64, 1, 12)
    pix, *_ = decode_to_pixels(data)
    assert pix == img.tobytes()  # full decode stays lossless


def test_progressive_truncated_decode(rng):
    """Decoding a truncated layered stream degrades gracefully
    (reference progressive_decode_test.go)."""
    base = np.cumsum(rng.integers(-4, 5, size=(64, 64)), axis=1)
    img = (base - base.min()).astype("<u2")
    enc = J2KEncoder(J2KEncodeParams(num_levels=3, num_layers=3,
                                     layer_rates=[32.0, 8.0, 0]))
    data = enc.encode(img.tobytes(), 64, 64, 1, 12)
    errs = []
    for frac in (0.3, 0.6, 1.0):
        cut = data[: int(len(data) * frac)]
        try:
            arr, _, _ = J2KDecoder(resilient=True).decode(cut)
            err = np.abs(arr[:, :, 0].astype(float)
                         - img.astype(float)).mean()
        except Exception:
            err = float("inf")
        errs.append(err)
    assert errs[2] == 0.0            # full stream lossless
    assert errs[0] >= errs[1] >= errs[2]  # more data, closer image


# ---- ROI -------------------------------------------------------------------

def test_polygon_rasterizer():
    tri = rasterize_polygon([(0, 0), (10, 0), (0, 10)], 12, 12)
    assert tri[1, 1] and not tri[10, 10]
    assert 30 < tri.sum() < 70  # ~half the 10x10 box


def test_combined_mask_shapes():
    regions = [ROIRegion(shape="rect", rect=(2, 2, 4, 4)),
               ROIRegion(shape="polygon", polygon=[(8, 8), (14, 8), (8, 14)])]
    m = combined_mask(regions, 16, 16)
    assert m[3, 3] and m[9, 9] and not m[0, 15]


def test_unshift_maxshift():
    v = np.array([3, -5, 1 << 12, -(7 << 10)], dtype=np.int64)
    out = unshift_maxshift(v, 10)
    np.testing.assert_array_equal(out, [3, -5, 4, -7])


def test_roi_lossless_roundtrip(rng):
    """MaxShift ROI: full image still decodes bit-exact losslessly."""
    img = rng.integers(0, 4096, size=(48, 48)).astype("<u2")
    enc = J2KEncoder(J2KEncodeParams(
        num_levels=2,
        roi_regions=[ROIRegion(shape="rect", rect=(8, 8, 16, 16))]))
    data = enc.encode(img.tobytes(), 48, 48, 1, 12)
    cs = j2k.parse_codestream(data)
    assert cs.rgn_shifts.get(0, 0) > 0  # RGN marker present
    pix, *_ = decode_to_pixels(data)
    assert pix == img.tobytes()


def test_roi_truncated_stream_degrades_monotonically(rng):
    """ROI streams stay decodable and improve with more data."""
    img = rng.integers(0, 4096, size=(64, 64)).astype("<u2")
    roi = ROIRegion(shape="rect", rect=(16, 16, 24, 24))
    enc = J2KEncoder(J2KEncodeParams(num_levels=2, num_layers=2,
                                     roi_regions=[roi]))
    data = enc.encode(img.tobytes(), 64, 64, 1, 12)
    errs = []
    for frac in (0.4, 0.7, 1.0):
        arr, _, _ = J2KDecoder(resilient=True).decode(
            data[: int(len(data) * frac)])
        errs.append(np.abs(arr[:, :, 0].astype(float)
                           - img.astype(float)).mean())
    assert errs[2] == 0.0
    assert errs[0] >= errs[1] >= errs[2]


def test_roi_beats_background_at_layer_boundary(rng):
    """NMSEDEC-weighted PCRD puts MaxShift-scaled ROI passes into the
    first layer: truncating at the layer-0 boundary reconstructs the ROI
    more accurately than the background (reference
    rate_distortion.go + t1/nmsedec.go behavior)."""
    img = rng.integers(0, 4096, size=(128, 128)).astype("<u2")
    roi = ROIRegion(shape="rect", rect=(40, 40, 88, 88))
    params = dict(num_levels=2, num_layers=2, layer_rates=[16.0, 0],
                  cb_width=32, cb_height=32)
    with_roi = J2KEncoder(J2KEncodeParams(**params, roi_regions=[roi])
                          ).encode(img.tobytes(), 128, 128, 1, 12)
    plain = J2KEncoder(J2KEncodeParams(**params)
                       ).encode(img.tobytes(), 128, 128, 1, 12)
    m = np.zeros((128, 128), bool)
    m[40:88, 40:88] = True
    # cut just past the measured layer-0 boundary (byte target + headers):
    # layer-0 packets decode fully, partial layer-1 packets are dropped
    # by the resilient decoder
    cut = int(128 * 128 * 12 / 8 / 16.0) + 160

    def roi_err(data):
        arr, _, _ = J2KDecoder(resilient=True).decode(data[:cut])
        d = np.abs(arr[:, :, 0].astype(float) - img.astype(float))
        return d[m].mean()

    # the ROI-prioritized stream reconstructs the ROI better than a plain
    # stream at the same truncation point
    assert roi_err(with_roi) < roi_err(plain)


def test_target_ratio_truncation(rng):
    """target_ratio > 0 bounds the stream near raw/ratio via PCRD
    truncation (reference encodeFrameWithTargetRatio
    lossy/codec.go:378-388; budgeted final layer)."""
    img = rng.integers(0, 4096, size=(128, 128)).astype("<u2")
    raw = 128 * 128 * 12 / 8
    prev_size = None
    for ratio in (8.0, 16.0):
        data = J2KEncoder(J2KEncodeParams(num_levels=3, target_ratio=ratio)
                          ).encode(img.tobytes(), 128, 128, 1, 12)
        # within headers + pass granularity of the byte target
        assert len(data) < raw / ratio + 400, (ratio, len(data))
        arr, _, _ = J2KDecoder().decode(data)
        assert arr.shape == (128, 128, 1)
        if prev_size is not None:
            assert len(data) < prev_size   # higher ratio ⇒ smaller stream
        prev_size = len(data)


def test_global_multitile_pcrd(rng):
    """Multi-tile rate-targeted streams pool every tile's passes into
    one global budget (reference useGlobalPCRD encoder.go:2004): bits
    flow to complex tiles while the total honors the target."""
    img = np.zeros((128, 128), dtype=np.uint16)
    img[:, :64] = rng.integers(0, 4096, (128, 64))   # hard half
    img[:, 64:] = 1000                               # easy half
    raw = 128 * 128 * 12 / 8
    data = J2KEncoder(J2KEncodeParams(num_levels=2, tile_width=64,
                                      tile_height=64, target_ratio=8.0)
                      ).encode(img.tobytes(), 128, 128, 1, 12)
    assert len(data) < raw / 8 + 700    # 4 tile headers + pass granularity
    arr, _, _ = J2KDecoder().decode(data)
    err_hard = np.abs(arr[:, :64, 0].astype(float)
                      - img[:, :64].astype(float)).mean()
    err_easy = np.abs(arr[:, 64:, 0].astype(float)
                      - img[:, 64:].astype(float)).mean()
    # global allocation gives the easy half far better fidelity per bit
    assert err_easy < err_hard
    # multi-tile layered stream with take-all final layer stays lossless
    d2 = J2KEncoder(J2KEncodeParams(num_levels=2, tile_width=64,
                                    tile_height=64, num_layers=2,
                                    layer_rates=[8.0, 0])
                    ).encode(img.tobytes(), 128, 128, 1, 12)
    a2, _, _ = J2KDecoder().decode(d2)
    np.testing.assert_array_equal(a2[:, :, 0], img.astype(np.int32))


def test_append_lossless_layer(rng):
    """append_lossless_layer adds a final take-all layer: the stream has
    an extra layer in COD and full decode is bit-exact (reference
    initRDLayerConfig encoder.go:2674-2684)."""
    img = rng.integers(0, 4096, size=(64, 64)).astype("<u2")
    data = J2KEncoder(J2KEncodeParams(num_levels=2, num_layers=2,
                                      layer_rates=[32.0, 8.0],
                                      append_lossless_layer=True)
                      ).encode(img.tobytes(), 64, 64, 1, 12)
    cs = j2k.parse_codestream(data)
    assert cs.cod.num_layers == 3
    arr, _, _ = J2KDecoder().decode(data)
    np.testing.assert_array_equal(arr[:, :, 0], img.astype(np.int32))


def test_general_scaling_roi_lossless(rng):
    """Srgn=1 General Scaling: encoder shifts masked coefficients by an
    arbitrary Srgn; decoder rebuilds the mask from the JP2ROI COM marker
    and unshifts exactly those (reference roi_config.go styles +
    tile_decoder.go applyInverseGeneralScalingMasked)."""
    img = rng.integers(0, 4096, size=(96, 96)).astype("<u2")
    roi = ROIRegion(shape="rect", rect=(24, 24, 40, 40))
    enc = J2KEncoder(J2KEncodeParams(num_levels=2, roi_regions=[roi],
                                     roi_style="general", roi_shift=4))
    data = enc.encode(img.tobytes(), 96, 96, 1, 12)
    cs = j2k.parse_codestream(data)
    assert cs.rgn_styles.get(0) == 1      # Srgn = General Scaling
    assert cs.rgn_shifts.get(0) == 4
    arr, _, _ = J2KDecoder().decode(data)
    np.testing.assert_array_equal(arr[:, :, 0], img.astype(np.int32))


def test_general_scaling_component_filter(rng):
    """Regions limited to a component subset shift (and unshift) only
    those components."""
    rgb = rng.integers(0, 256, size=(64, 64, 3)).astype(np.uint8)
    roi = ROIRegion(shape="rect", rect=(16, 16, 24, 24), components=[0, 2])
    enc = J2KEncoder(J2KEncodeParams(num_levels=2, roi_regions=[roi],
                                     roi_style="general", roi_shift=3,
                                     mct=False))
    data = enc.encode(rgb.tobytes(), 64, 64, 3, 8)
    cs = j2k.parse_codestream(data)
    assert set(cs.rgn_shifts) == {0, 2}   # RGN only for covered comps
    arr, _, _ = J2KDecoder().decode(data)
    np.testing.assert_array_equal(arr, rgb.astype(np.int32))


def test_roi_com_metadata_roundtrip():
    from go_dicom_codec_jax.codecs.j2k_roi import (parse_roi_com,
                                                   write_roi_com)
    regs = [ROIRegion(shape="rect", rect=(10, 20, 30, 40), components=[0]),
            ROIRegion(shape="polygon", polygon=[(1, 2), (50, 3), (25, 60)])]
    back = parse_roi_com(write_roi_com(regs, 3))
    assert back[0].rect == (10, 20, 30, 40)
    assert back[0].components == [0]
    assert back[1].polygon == [(1, 2), (50, 3), (25, 60)]
    assert back[1].components == [0, 1, 2]
    assert parse_roi_com(b"not-roi-data") is None


# ---- Part 2 custom MCT -----------------------------------------------------

def test_part2_custom_mct_markers_and_roundtrip(rng):
    """MCT/MCC/MCO markers roundtrip a custom decorrelation matrix
    (reference encoder.go:668-784, decoder.go:206-353)."""
    img = rng.integers(0, 256, size=(32, 32, 3)).astype(np.uint8)
    M = [[0.6, 0.5, 0.5], [0.5, 0.6, -0.5], [0.5, -0.5, 0.6]]
    Minv = np.linalg.inv(M).tolist()
    enc = J2KEncoder(J2KEncodeParams(num_levels=2, mct_matrix=M,
                                     mct_inverse=Minv))
    data = enc.encode(img.tobytes(), 32, 32, 3, 8)
    assert b"\xff\x74" in data and b"\xff\x75" in data and b"\xff\x77" in data
    cs = j2k.parse_codestream(data)
    assert len(cs.mct_segments) == 1 and len(cs.mcc_segments) == 1
    idx, atype, etype, vals = j2k.parse_mct_segment(cs.mct_segments[0])
    assert atype == j2k.MCT_ARRAY_DECORRELATE and len(vals) == 9
    np.testing.assert_allclose(np.array(vals).reshape(3, 3), Minv, atol=1e-6)
    pix, *_ = decode_to_pixels(data)
    got = np.frombuffer(pix, np.uint8).reshape(32, 32, 3).astype(int)
    assert np.abs(got - img.astype(int)).max() <= 1  # float matrix rounding


def test_mcc_segment_parser_roundtrip():
    seg = j2k.write_mcc_record(3, [0, 1, 2], True, 1, 2)
    payload = seg[4:]  # strip marker+length
    idx, ids, rev, deco, off = j2k.parse_mcc_segment(payload)
    assert (idx, ids, rev, deco, off) == (3, [0, 1, 2], True, 1, 2)


def test_multi_binding_mct_roundtrip(rng):
    """Multiple MCT binding groups (reference MCTBindings
    encoder.go:111-121, applyMCTBindings :527): each group carries its
    own matrix/offsets via MCT records + one MCC collection each + MCO
    order; decoder inverts in reverse MCO order."""
    from go_dicom_codec_jax.codecs.mct_builder import MCTBindingBuilder

    rgb = rng.integers(0, 256, (64, 64, 3)).astype(np.uint8)
    b1 = MCTBindingBuilder().components([0, 1]).matrix(
        [[0.5, 0.5], [-0.5, 0.5]]).offsets([1.0, -2.0]).build()
    b2 = MCTBindingBuilder().components([2]).matrix([[2.0]]).build()
    data = J2KEncoder(J2KEncodeParams(num_levels=2, lossless=False,
                                      quality=85, mct_bindings=[b1, b2])
                      ).encode(rgb.tobytes(), 64, 64, 3, 8)
    cs = j2k.parse_codestream(data)
    assert len(cs.mcc_segments) == 2
    assert len(cs.mco_segments) == 1
    arr, _, _ = J2KDecoder().decode(data)
    err = np.abs(arr.astype(float) - rgb.astype(float)).mean()
    assert err < 3.0


def test_block_encoder_factory(rng):
    """Pluggable block coder (reference BlockEncoderFactory
    encoder.go:94-103): factory(width, height) supplies the block
    encoder; like the reference, the factory object receives no band
    orientation (intended for orientation-agnostic coders such as HT)."""
    from go_dicom_codec_jax.entropy.ebcot import T1Encoder

    img = rng.integers(0, 4096, (64, 64)).astype("<u2")
    calls = []

    def factory(w, h):
        calls.append((w, h))
        return T1Encoder(w, h, style=0, orientation=0)

    d1 = J2KEncoder(J2KEncodeParams(num_levels=0,
                                    block_encoder_factory=factory)
                    ).encode(img.tobytes(), 64, 64, 1, 12)
    d2 = J2KEncoder(J2KEncodeParams(num_levels=0)
                    ).encode(img.tobytes(), 64, 64, 1, 12)
    assert calls and d1 == d2  # orientation-0 band: byte-identical
    arr, _, _ = J2KDecoder().decode(d1)
    np.testing.assert_array_equal(arr[:, :, 0], img.astype(np.int32))


@pytest.mark.parametrize("strategy", ["EXPONENTIAL", "EQUAL_RATE",
                                      "EQUAL_QUALITY", "ADAPTIVE"])
def test_layer_budget_strategies(strategy, rng):
    """Budget-curve strategies (reference ComputeLayerBudgets
    rate_distortion.go:438-464) shape intermediate layers; full decode
    stays lossless and target_ratio stays byte-bounded."""
    img = rng.integers(0, 4096, (64, 64)).astype("<u2")
    d = J2KEncoder(J2KEncodeParams(num_levels=2, num_layers=3,
                                   layer_budget_strategy=strategy)
                   ).encode(img.tobytes(), 64, 64, 1, 12)
    arr, _, _ = J2KDecoder().decode(d)
    np.testing.assert_array_equal(arr[:, :, 0], img.astype(np.int32))
    dt = J2KEncoder(J2KEncodeParams(num_levels=2, num_layers=2,
                                    target_ratio=8.0,
                                    layer_budget_strategy=strategy)
                    ).encode(img.tobytes(), 64, 64, 1, 12)
    assert len(dt) < 64 * 64 * 12 / 8 / 8 + 400


def test_block_decoder_factory_injection(rng):
    """Reference decoder.go:63-88 SetBlockDecoderFactory: a user-supplied
    factory overrides the built-in block decoders — classic T1 and HT."""
    from go_dicom_codec_jax.entropy.ebcot import T1Decoder
    from go_dicom_codec_jax.entropy.htcleanup import HTCleanupDecoder

    img = (np.cumsum(rng.integers(-9, 10, (64, 64)), axis=1)
           % 4096).astype("<u2")

    calls = {"n": 0}

    def classic_factory(width, height, style, orient):
        calls["n"] += 1
        inner = T1Decoder(width, height, style=style, orientation=orient)

        class _Dec:
            def decode(_self, stream, num_passes, numbps,
                       seg_lengths=None, mb=None):
                return inner.decode(stream, num_passes, numbps,
                                    seg_lengths=seg_lengths)
        return _Dec()

    stream = J2KEncoder(J2KEncodeParams(lossless=True)).encode(
        img.tobytes(), 64, 64, 1, 12, False)
    dec = J2KDecoder(block_decoder_factory=classic_factory)
    arr, _, _ = dec.decode(stream)
    assert calls["n"] > 0
    np.testing.assert_array_equal(arr[:, :, 0].astype("<u2"), img)

    # HT injection: the factory receives the HT cb_style (0x40) and mb
    def ht_factory(width, height, style, orient):
        assert style & 0x40
        class _Dec:
            def decode(_self, stream, num_passes, numbps,
                       seg_lengths=None, mb=None):
                return HTCleanupDecoder(width, height, mb,
                                        mb - numbps).decode(stream)
        return _Dec()

    ht_stream = J2KEncoder(J2KEncodeParams(lossless=True, htj2k=True)
                           ).encode(img.tobytes(), 64, 64, 1, 12, False)
    dec = J2KDecoder()
    dec.set_block_decoder_factory(ht_factory)
    arr, _, _ = dec.decode(ht_stream)
    np.testing.assert_array_equal(arr[:, :, 0].astype("<u2"), img)


def test_maxshift_roi_16bit_roundtrip(rng):
    """Regression (round-3 review): 16-bit MaxShift ROI drives block
    numbps past 31 bits (Srgn = depth+3), so the native T1 decode must
    return int64 for those blocks — the int32 fast path silently
    wrapped the scaled magnitudes (maxerr 43264 on this exact shape)."""
    from go_dicom_codec_jax.codecs.j2k_roi import ROIRegion
    from go_dicom_codec_jax.codecs.jpeg2000 import (J2KEncodeParams,
                                                    J2KEncoder,
                                                    decode_to_pixels)

    img = rng.integers(0, 65535, (48, 48)).astype("<u2")
    params = J2KEncodeParams(
        num_levels=2,
        roi_regions=[ROIRegion(shape="rect", rect=(8, 8, 24, 24))])
    stream = J2KEncoder(params).encode(img.tobytes(), 48, 48, 1, 16)
    raw, w, h, c, depth, signed = decode_to_pixels(stream)
    got = np.frombuffer(raw, "<u2").reshape(48, 48)
    np.testing.assert_array_equal(got.astype(np.int64),
                                  img.astype(np.int64))


def test_adapter_defaults_bypass_style(rng):
    """DICOM J2K adapters default to selective-arithmetic-bypass (lazy)
    code-blocks — measured faster AND smaller than style 0 — while ROI
    encodes fall back to pure MQ (foreign decoders disagree with the
    ROI plane-skip schedule under bypass)."""
    import go_dicom_codec_jax as dc
    from go_dicom_codec_jax.codestream import j2k

    img = rng.integers(0, 4096, (64, 64)).astype("<u2")
    info = dc.FrameInfo(width=64, height=64, bits_allocated=16,
                        bits_stored=12)
    codec = dc.get_global_registry().get_codec(dc.uids.JPEG_2000_LOSSLESS)

    def cod_style(params=None, exact=True):
        src = dc.MemoryPixelData(info=info)
        src.add_frame(img.tobytes())
        enc = dc.MemoryPixelData(info=info, encapsulated=True)
        codec.encode(src, enc, params)
        cs = j2k.parse_codestream(enc.get_frame(0))
        dec = dc.MemoryPixelData(info=info)
        codec.decode(enc, dec)
        if exact:
            assert dec.get_frame(0) == src.get_frame(0)
        return cs.cod.cb_style

    assert cod_style() == 0x01                       # bypass default
    assert cod_style(dc.Parameters(cb_style=0)) == 0  # explicit override
    from go_dicom_codec_jax.codecs.j2k_roi import ROIRegion
    roi = dc.Parameters(
        roi_regions=[ROIRegion(shape="rect", rect=(8, 8, 24, 24))],
        roi_shift=6)
    # low Srgn => background planes are dropped (not exact); only the
    # style choice is under test here
    assert cod_style(roi, exact=False) == 0          # ROI falls back to MQ
