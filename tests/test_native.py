"""Native C++ EBCOT/MQ equivalence vs the Python reference implementation.

Byte-exact encoder parity and value-exact decoder parity across the style
matrix, sizes, and dynamic ranges.
"""

import numpy as np
import pytest

from go_dicom_codec_jax.entropy.ebcot import (STYLE_LAZY, STYLE_RESET,
                                              STYLE_SEGSYM, STYLE_TERMALL,
                                              STYLE_VSC, T1Decoder,
                                              T1Encoder)
from go_dicom_codec_jax.native import (get_lib, t1_decode_native,
                                       t1_encode_native)

pytestmark = pytest.mark.skipif(get_lib() is None,
                                reason="native toolchain unavailable")

STYLES = [0, STYLE_TERMALL, STYLE_RESET, STYLE_SEGSYM, STYLE_LAZY,
          STYLE_LAZY | STYLE_TERMALL, STYLE_TERMALL | STYLE_RESET,
          STYLE_VSC, STYLE_VSC | STYLE_TERMALL]
SIZES = [(4, 4), (8, 8), (64, 64), (5, 7), (33, 29), (1, 16), (16, 1)]


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("size", SIZES[:4])
def test_encoder_byte_parity(style, size, rng):
    h, w = size
    for orient in (0, 3):
        data = rng.integers(-3000, 3000, size=(h, w)).astype(np.int32)
        py_stream, py_numbps, py_passes = T1Encoder(
            w, h, style=style, orientation=orient).encode(data)
        native = t1_encode_native(data, style, orient)
        assert native is not None
        n_stream, n_numbps, n_rates, n_terms, n_bps, n_nmse = native
        assert n_numbps == py_numbps
        assert n_stream == py_stream, (
            f"stream mismatch style={style} orient={orient}")
        assert n_rates == [p.rate for p in py_passes]
        assert n_terms == [p.terminated for p in py_passes]
        assert n_bps == [p.bitplane for p in py_passes]
        assert n_nmse == [p.nmsedec for p in py_passes]


@pytest.mark.parametrize("style", STYLES)
@pytest.mark.parametrize("size", SIZES)
def test_native_roundtrip(style, size, rng):
    h, w = size
    data = rng.integers(-30000, 30000, size=(h, w)).astype(np.int32)
    stream, numbps, rates, terms, bps, _ = t1_encode_native(data, style, 0)
    segs = [r for r, t in zip(rates, terms) if t]
    got = t1_decode_native(stream, w, h, style, 0, len(rates), numbps,
                           seg_ends=segs)
    np.testing.assert_array_equal(got, data)


@pytest.mark.parametrize("style", STYLES[:4])
def test_cross_decode(style, rng):
    """Python decodes native streams; native decodes Python streams."""
    h = w = 16
    data = rng.integers(-500, 500, size=(h, w)).astype(np.int32)
    py_stream, numbps, py_passes = T1Encoder(w, h, style=style).encode(data)
    segs = [p.rate for p in py_passes if p.terminated]
    native_dec = t1_decode_native(py_stream, w, h, style, 0,
                                  len(py_passes), numbps, seg_ends=segs)
    np.testing.assert_array_equal(native_dec, data)

    n_stream, n_numbps, n_rates, n_terms, _, _ = t1_encode_native(data, style, 0)
    py_dec = T1Decoder(w, h, style=style).decode(
        n_stream, len(n_rates), n_numbps,
        seg_lengths=[r for r, t in zip(n_rates, n_terms) if t])
    np.testing.assert_array_equal(py_dec, data)


def test_native_sparse_and_zero(rng):
    data = np.zeros((32, 32), dtype=np.int32)
    stream, numbps, rates, terms, bps, _ = t1_encode_native(data, 0, 0)
    assert numbps == 0 and rates == []
    got = t1_decode_native(b"", 32, 32, 0, 0, 0, 0)
    np.testing.assert_array_equal(got, data)

    data[5, 5] = 1 << 20
    data[0, 0] = -1
    stream, numbps, rates, terms, bps, _ = t1_encode_native(data, 0, 0)
    got = t1_decode_native(stream, 32, 32, 0, 0, len(rates), numbps)
    np.testing.assert_array_equal(got, data)


def test_native_speedup(rng):
    """Native T1 should be at least 10x the Python path on a 64x64 block."""
    import time

    data = rng.integers(-2000, 2000, size=(64, 64)).astype(np.int32)
    t0 = time.perf_counter()
    T1Encoder(64, 64).encode(data)
    t_py = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in range(10):
        t1_encode_native(data, 0, 0)
    t_native = (time.perf_counter() - t0) / 10
    assert t_native * 10 < t_py, (t_py, t_native)


# ---- JPEG-LS native equivalence ---------------------------------------------

from go_dicom_codec_jax.codecs.jpegls import (Traits, _Scan, _code_component,
                                              _code_interleaved)
from go_dicom_codec_jax.entropy.golomb import GolombWriter
from go_dicom_codec_jax.native import (jls_decode_scan_native,
                                       jls_encode_scan_native)


@pytest.mark.parametrize("near", [0, 2])
@pytest.mark.parametrize("size", [(8, 8), (17, 23), (1, 32)])
def test_jls_native_byte_parity(near, size, rng):
    h, w = size
    img = rng.integers(0, 256, size=(h, w, 1)).astype(np.int64)
    t = Traits(maxval=255, near=near)
    native = jls_encode_scan_native(img.copy(), 255, near, t.reset,
                                    t.t1, t.t2, t.t3)
    scan = _Scan(t)
    gw = GolombWriter()
    py_img = img.copy()
    _code_component(scan, gw, py_img[:, :, 0], encode=True)
    py_bytes = gw.finish()
    assert native == py_bytes


@pytest.mark.parametrize("near", [0, 3])
def test_jls_native_rgb_parity(near, rng):
    img = rng.integers(0, 256, size=(12, 16, 3)).astype(np.int64)
    t = Traits(maxval=255, near=near)
    native = jls_encode_scan_native(img.copy(), 255, near, t.reset,
                                    t.t1, t.t2, t.t3)
    scan = _Scan(t)
    gw = GolombWriter()
    _code_interleaved(scan, gw, img.copy(), encode=True)
    assert native == gw.finish()


@pytest.mark.parametrize("near", [0, 1])
def test_jls_native_roundtrip_16bit(near, rng):
    img = rng.integers(0, 1 << 16, size=(24, 20, 1)).astype(np.int64)
    t = Traits(maxval=(1 << 16) - 1, near=near)
    data = jls_encode_scan_native(img.copy(), t.maxval, near, t.reset,
                                  t.t1, t.t2, t.t3)
    out = jls_decode_scan_native(data, 20, 24, 1, t.maxval, near, t.reset,
                                 t.t1, t.t2, t.t3, 0)
    if near == 0:
        np.testing.assert_array_equal(out, img)
    else:
        assert np.abs(out - img).max() <= near


@pytest.mark.parametrize("near", [0, 2])
def test_jls_native_line_interleaved_parity(near, rng):
    """ILV=1 native mirror: byte-identical scan bytes vs the Python
    _code_line_interleaved, and decode round-trips through native."""
    from go_dicom_codec_jax.codecs.jpegls import _code_line_interleaved
    img = rng.integers(0, 256, size=(18, 14, 3)).astype(np.int64)
    t = Traits(maxval=255, near=near)
    native = jls_encode_scan_native(img.copy(), 255, near, t.reset,
                                    t.t1, t.t2, t.t3, ilv=1)
    scan = _Scan(t)
    gw = GolombWriter()
    _code_line_interleaved(scan, gw, img.copy(), encode=True)
    assert native == gw.finish()
    out = jls_decode_scan_native(native, 14, 18, 3, 255, near, t.reset,
                                 t.t1, t.t2, t.t3, 1)
    if near == 0:
        np.testing.assert_array_equal(out, img)
    else:
        assert np.abs(out - img).max() <= near


def test_jls_codec_uses_native_speed(rng):
    """512x512 JPEG-LS through the codec should be fast with native."""
    import time

    from go_dicom_codec_jax.codecs.jpegls import decode as jls_decode
    from go_dicom_codec_jax.codecs.jpegls import encode as jls_encode

    img = rng.integers(0, 4096, size=(512, 512)).astype("<u2")
    t0 = time.perf_counter()
    data = jls_encode(img.tobytes(), 512, 512, 1, 12, 0)
    t_enc = time.perf_counter() - t0
    t0 = time.perf_counter()
    out, *_ = jls_decode(data)
    t_dec = time.perf_counter() - t0
    assert out == img.tobytes()
    assert t_enc < 1.0 and t_dec < 1.0, (t_enc, t_dec)


# ---- HT SigProp/MagRef native parity ----------------------------------------


@pytest.mark.parametrize("causal", [False, True])
def test_ht_refinement_native_parity(causal, rng):
    """Native SigProp/MagRef mirror emits byte-identical refinement
    segments and applies them bit-exact vs entropy/htrefine.py."""
    from go_dicom_codec_jax.entropy.htrefine import (apply_refinement,
                                                     encode_refinement)
    from go_dicom_codec_jax.native import (get_lib,
                                           ht_refine_apply_native,
                                           ht_refine_encode_native)

    if get_lib() is None:
        pytest.skip("native unavailable")
    for _ in range(40):
        h, w = rng.integers(1, 40, size=2)
        dense = rng.random() < 0.5
        lo, hi = (-40, 41) if dense else (-2, 3)
        v = rng.integers(lo, hi, size=(h, w)).astype(np.int32)
        py = encode_refinement(v, causal)
        assert ht_refine_encode_native(v, causal) == py
        u = (np.abs(v.astype(np.int64)) >> 1) * np.sign(v)
        wcu = 2 * np.abs(u) * np.sign(v) + np.sign(v) * (np.abs(u) > 0)
        for z in (2, 3):
            dref = py[0] if z == 3 else py[0][:py[1]]
            a = apply_refinement(wcu, dref, z, causal)
            b = ht_refine_apply_native(wcu, dref, z, causal)
            assert isinstance(b, np.ndarray) and np.array_equal(a, b)


def test_ht_refinement_native_flags_stuff_bit_error(rng):
    """A set SigProp stuff bit returns a corrupt marker (the caller
    re-runs the Python path, which raises CorruptStreamError)."""
    from go_dicom_codec_jax.native import get_lib, ht_refine_apply_native

    if get_lib() is None:
        pytest.skip("native unavailable")
    w = np.zeros((8, 8), dtype=np.int64)
    w[0, 0] = 9  # significant seed so neighbours become eligible
    r = ht_refine_apply_native(w, bytes([0xFF, 0x80]), 2, False)
    assert isinstance(r, tuple) and r[0] == "corrupt"


# ---- HT cleanup native parity ------------------------------------------------

HT_SIZES = [(64, 64), (32, 32), (17, 23), (1, 64), (64, 1), (5, 5), (2, 2)]


@pytest.mark.parametrize("size", HT_SIZES)
def test_ht_cleanup_native_parity(size, rng):
    """Native HT cleanup coder emits byte-identical streams and decodes
    bit-exact vs the Python reference implementation."""
    from go_dicom_codec_jax.entropy.htcleanup import (HTCleanupDecoder,
                                                      HTCleanupEncoder)
    from go_dicom_codec_jax.native import (ht_cleanup_decode_native,
                                           ht_cleanup_encode_native)

    h, w = size
    for mag in (3, 300, 30000):
        data = rng.integers(-mag, mag + 1, (h, w)).astype(np.int64)
        kmax = max(int(np.abs(data).max()).bit_length() + 2, 2)
        py = HTCleanupEncoder(w, h, kmax).encode(data)
        nat = ht_cleanup_encode_native(data, kmax)
        assert (py or b"") == (nat or b"")
        if not py:
            continue
        dec_py = HTCleanupDecoder(w, h, kmax, kmax - 1).decode(py)
        dec_nat = ht_cleanup_decode_native(py, w, h, kmax, kmax - 1)
        assert not isinstance(dec_nat, tuple)
        np.testing.assert_array_equal(dec_py, dec_nat)


def test_ht_cleanup_native_corrupt(rng):
    from go_dicom_codec_jax.native import ht_cleanup_decode_native
    r = ht_cleanup_decode_native(b"\x00\x00\x00\xff\xff", 8, 8, 10, 9)
    assert r is None or isinstance(r, tuple) or r.shape == (8, 8)
    r2 = ht_cleanup_decode_native(b"\x01", 8, 8, 10, 9)
    assert isinstance(r2, tuple)  # too short → stream error


DWT_CASES = [
    (512, 512, 5, 0, 0), (64, 64, 3, 0, 0), (17, 33, 2, 1, 0),
    (1, 7, 1, 0, 1), (7, 1, 2, 1, 1), (5, 5, 3, 3, 5), (2, 2, 1, 0, 0),
    # (31, 65) runs 3 levels: deep-level parity is pinned by the
    # (512, 512, 5) case (jnp side cache-shared with the codec tests);
    # a unique ragged 5-level jnp reference costs a ~14 s XLA compile
    (3, 2, 2, 1, 0), (16, 1, 2, 0, 0), (1, 1, 1, 1, 1), (31, 65, 3, 0, 1),
    (40, 40, 2, 1, 1),
]


@pytest.mark.parametrize("h,w,levels,x0,y0", DWT_CASES)
def test_dwt53_native_parity(h, w, levels, x0, y0, rng):
    """Native multilevel 5/3 DWT is bit-exact vs the jnp reference
    (ops/dwt53.py), forward and inverse, across parities and raggedness."""
    import jax.numpy as jnp

    from go_dicom_codec_jax.native import (dwt53_fwd_native,
                                           dwt53_inv_native)
    from go_dicom_codec_jax.ops.dwt53 import (fwd53_multilevel,
                                              inv53_multilevel)

    a = rng.integers(-30000, 30000, (h, w)).astype(np.int32)
    ref = np.asarray(fwd53_multilevel(jnp.asarray(a), levels, x0, y0))
    got = dwt53_fwd_native(a, levels, x0, y0)
    if got is None:
        pytest.skip("native library unavailable")
    np.testing.assert_array_equal(ref, got)
    refi = np.asarray(inv53_multilevel(jnp.asarray(ref), levels, x0, y0))
    goti = dwt53_inv_native(got, levels, x0, y0)
    np.testing.assert_array_equal(refi, goti)
    np.testing.assert_array_equal(goti, a)  # perfect reconstruction


@pytest.mark.parametrize("predictor", [1, 2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("shape", [(64, 64), (17, 3), (1, 9), (9, 1)])
def test_p14_native_parity(predictor, shape, rng):
    """Fused native predict/diff/hist and native reconstruct are exact
    mirrors of ops/lossless_predict (the behavioral reference)."""
    from go_dicom_codec_jax.native import (p14_diffs_hist_native,
                                           p14_reconstruct_native)
    from go_dicom_codec_jax.ops.lossless_predict import (encode_diffs,
                                                         reconstruct)

    h, w = shape
    for precision in (8, 12, 16):
        img = rng.integers(0, 1 << precision, (h, w)).astype(np.int64)
        ref = encode_diffs(img, predictor, precision)
        res = p14_diffs_hist_native(img, predictor, precision)
        if res is None:
            pytest.skip("native library unavailable")
        diffs, hist = res
        np.testing.assert_array_equal(diffs, ref)
        cats = np.where(ref.reshape(-1) == -32768, 16,
                        np.abs(ref.reshape(-1)))
        # histogram parity: recompute categories the reference way
        from go_dicom_codec_jax.entropy.huffman import categories
        want_hist = np.bincount(
            np.where(ref.reshape(-1) == -32768, 16,
                     categories(ref.reshape(-1))), minlength=17)[:17]
        np.testing.assert_array_equal(hist, want_hist)
        rec_ref = reconstruct(ref, predictor, precision)
        rec_nat = p14_reconstruct_native(ref.astype(np.int32), predictor,
                                         precision)
        np.testing.assert_array_equal(rec_nat, rec_ref)
        np.testing.assert_array_equal(rec_ref, img)


def test_t1_ojp_reconstruction_parity_and_midbin(rng):
    """ojp_recon (the codec decode mode): native == Python on truncated
    streams, exact on complete ones, and mid-bin beats plane-floor
    reconstruction on truncated blocks."""
    from go_dicom_codec_jax import native as nat
    from go_dicom_codec_jax.entropy.ebcot import T1Decoder

    data = rng.integers(-2000, 2001, (32, 32)).astype(np.int64)
    r = nat.t1_encode_native(data, style=0, orient=0, roishift=0)
    if r is None:
        pytest.skip("native library unavailable")
    stream, numbps, rates, terms, bps, nmse = r
    full = len(rates)

    # complete stream: ojp recon must stay exact
    out = nat.t1_decode_native(stream, 32, 32, 0, 0, full, numbps, 0,
                               None, ojp_recon=True)
    np.testing.assert_array_equal(out, data)

    # truncated stream: parity native vs Python, and better MSE
    for npass in (1, 4, 7):
        cut = stream[: rates[npass - 1]]
        out_n = nat.t1_decode_native(cut, 32, 32, 0, 0, npass, numbps, 0,
                                     None, ojp_recon=True)
        out_p = T1Decoder(32, 32, 0, 0, openjpeg_reconstruction=True
                          ).decode(cut, npass, numbps)
        np.testing.assert_array_equal(out_n, out_p)
        out_floor = nat.t1_decode_native(cut, 32, 32, 0, 0, npass, numbps,
                                         0, None, ojp_recon=False)
        mse_mid = np.mean((out_n - data) ** 2.0)
        mse_floor = np.mean((out_floor - data) ** 2.0)
        assert mse_mid <= mse_floor


# ---------------------------------------------------------------- JPEG DCT

@pytest.mark.parametrize("shape", [(64, 64), (512, 512), (60, 52), (17, 9)])
@pytest.mark.parametrize("dtype,bits", [(np.uint8, 8), (np.uint16, 12)])
def test_jpg_fdct_native_vs_device(shape, dtype, bits, rng):
    """Native integer islow DCT is BYTE-IDENTICAL to the jit lane and the
    numpy lane (ops/dct_int.py is the one shared algorithm)."""
    import jax.numpy as jnp

    from go_dicom_codec_jax.codecs import jpeg_common as jc
    from go_dicom_codec_jax.native import jpg_fdct_quant_native
    from go_dicom_codec_jax.ops.dct8x8 import (encode_plane_to_zigzag,
                                               encode_plane_to_zigzag_np)

    h, w = shape
    img = rng.integers(0, (1 << bits) - 1, (h, w)).astype(dtype)
    q = jc.scale_quant_table(jc.LUMA_QUANT, 85, 255)
    level = 1 << (bits - 1)
    native = jpg_fdct_quant_native(img, q, level)
    assert native is not None
    dev = np.asarray(encode_plane_to_zigzag(
        jnp.asarray(img.astype(np.int32)), jnp.asarray(q),
        level_shift=level))
    np.testing.assert_array_equal(native.reshape(dev.shape), dev)
    npv = encode_plane_to_zigzag_np(img.astype(np.int32), q,
                                    level_shift=level)
    np.testing.assert_array_equal(npv, dev)


def test_jpg_fdct_native_dtype_agreement(rng):
    """uint8 / uint16 / int32 inputs produce identical coefficients."""
    from go_dicom_codec_jax.codecs import jpeg_common as jc
    from go_dicom_codec_jax.native import jpg_fdct_quant_native

    img = rng.integers(0, 255, (48, 40)).astype(np.uint8)
    q = jc.scale_quant_table(jc.LUMA_QUANT, 90, 255)
    a = jpg_fdct_quant_native(img, q, 128)
    b = jpg_fdct_quant_native(img.astype(np.uint16), q, 128)
    c = jpg_fdct_quant_native(img.astype(np.int32), q, 128)
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)


@pytest.mark.parametrize("bits", [8, 12])
def test_jpg_idct_native_vs_device(bits, rng):
    import jax.numpy as jnp

    from go_dicom_codec_jax.codecs import jpeg_common as jc
    from go_dicom_codec_jax.native import (jpg_fdct_quant_native,
                                           jpg_idct_native)
    from go_dicom_codec_jax.ops.dct8x8 import decode_zigzag_to_plane

    img = rng.integers(0, (1 << bits) - 1, (64, 80)).astype(
        np.uint8 if bits == 8 else np.uint16)
    q = jc.scale_quant_table(jc.LUMA_QUANT, 85, 255)
    level = 1 << (bits - 1)
    zz = jpg_fdct_quant_native(img, q, level)
    native = jpg_idct_native(zz, q, level, (1 << bits) - 1)
    assert native is not None
    dev = np.asarray(decode_zigzag_to_plane(
        jnp.asarray(zz), jnp.asarray(q), level_shift=level,
        max_val=(1 << bits) - 1))
    np.testing.assert_array_equal(native, dev)


def test_jpg_dct_native_roundtrip_quality(rng):
    """Native fdct->idct reconstruction error is bounded by quant steps."""
    from go_dicom_codec_jax.codecs import jpeg_common as jc
    from go_dicom_codec_jax.native import (jpg_fdct_quant_native,
                                           jpg_idct_native)

    y, x = np.mgrid[0:128, 0:128]
    img = np.clip((np.sin(x / 9.0) + np.cos(y / 7.0)) * 60 + 128
                  + rng.normal(0, 2, (128, 128)), 0, 255).astype(np.uint8)
    q = jc.scale_quant_table(jc.LUMA_QUANT, 95, 255)
    zz = jpg_fdct_quant_native(img, q, 128)
    rec = jpg_idct_native(zz, q, 128, 255)
    err = np.abs(rec.astype(int) - img.astype(int))
    assert err.max() <= 16
    assert err.mean() < 3.0


def test_lossy_jpeg_streams_deterministic_across_lanes(rng, monkeypatch):
    """Baseline/extended encode bytes are BYTE-IDENTICAL whether the
    native library is used or the pure-Python lane is forced — the
    integer islow DCT (ops/dct_int.py) is one algorithm on every lane,
    so the round-2/3 float-DCT tie carve-out is gone."""
    from go_dicom_codec_jax import native as nat
    from go_dicom_codec_jax.codecs import jpeg_baseline, jpeg_extended

    img8 = rng.integers(0, 256, (67, 53)).astype(np.uint8)
    rgb = rng.integers(0, 256, (40, 44, 3)).astype(np.uint8)
    img12 = rng.integers(0, 4096, (50, 62)).astype(np.uint16)

    with_native = [
        jpeg_baseline.encode(img8.tobytes(), 53, 67, 1, 85),
        jpeg_baseline.encode(rgb.tobytes(), 44, 40, 3, 75),
        jpeg_extended.encode(img12.tobytes(), 62, 50, 1, 12, 80),
    ]
    assert nat.get_lib() is not None  # the native lane actually ran

    monkeypatch.setattr(nat, "get_lib", lambda: None)
    without_native = [
        jpeg_baseline.encode(img8.tobytes(), 53, 67, 1, 85),
        jpeg_baseline.encode(rgb.tobytes(), 44, 40, 3, 75),
        jpeg_extended.encode(img12.tobytes(), 62, 50, 1, 12, 80),
    ]
    for a, b in zip(with_native, without_native):
        assert a == b


def test_lossy_jpeg_decode_deterministic_across_lanes(rng, monkeypatch):
    """Decoded lossy pixels are byte-identical native vs native-disabled."""
    from go_dicom_codec_jax import native as nat
    from go_dicom_codec_jax.codecs import jpeg_baseline, jpeg_extended

    img8 = rng.integers(0, 256, (67, 53)).astype(np.uint8)
    img12 = rng.integers(0, 4096, (50, 62)).astype(np.uint16)
    s8 = jpeg_baseline.encode(img8.tobytes(), 53, 67, 1, 85)
    s12 = jpeg_extended.encode(img12.tobytes(), 62, 50, 1, 12, 80)

    a8 = jpeg_baseline.decode(s8)[0]
    a12 = jpeg_extended.decode(s12)[0]
    monkeypatch.setattr(nat, "get_lib", lambda: None)
    b8 = jpeg_baseline.decode(s8)[0]
    b12 = jpeg_extended.decode(s12)[0]
    assert a8 == b8
    assert a12 == b12


# ---- batched native entries (one C call per tile) --------------------------

def test_t1_encode_blocks_matches_scalar(rng):
    """t1_encode_blocks = per-block t1_encode on mixed sizes/orients."""
    from go_dicom_codec_jax.native import t1_encode_blocks_native

    if get_lib() is None:
        pytest.skip("native unavailable")
    shapes = [(64, 64), (64, 64), (33, 17), (4, 64), (1, 1), (5, 3)]
    orients = [0, 1, 2, 3, 0, 2]
    blocks = [
        (rng.standard_normal(s) * (300 if i % 2 else 7)).astype(np.int32)
        for i, s in enumerate(shapes)]
    blocks[4][:] = 0  # all-zero block
    for style in (0x00, 0x01, 0x04 | 0x20):
        for need_nmse in (False, True):
            batched = t1_encode_blocks_native(blocks, orients, style,
                                              need_nmse=need_nmse)
            assert batched is not None
            for b, orient, got in zip(blocks, orients, batched):
                want = t1_encode_native(b, style, orient,
                                        need_nmse=need_nmse)
                assert got == want


def test_t1_decode_blocks_matches_scalar(rng):
    """Batched decode reproduces the scalar decoder and flags corrupt
    blocks without touching the good ones."""
    from go_dicom_codec_jax.native import t1_decode_blocks_native

    if get_lib() is None:
        pytest.skip("native unavailable")
    style = STYLE_LAZY
    shapes = [(64, 64), (31, 8), (64, 64)]
    blocks = [(rng.standard_normal(s) * 200).astype(np.int32)
              for s in shapes]
    items = []
    for i, (b, s) in enumerate(zip(blocks, shapes)):
        stream, numbps, rates, terms, bps, _ = t1_encode_native(
            b, style, i % 4)
        seg_ends = [r for r, t in zip(rates, terms) if t]
        items.append((stream, s[1], s[0], i % 4, len(rates), numbps,
                      seg_ends))
    results = t1_decode_blocks_native(items, style, ojp_recon=True)
    assert results is not None
    for it, got in zip(items, results):
        want = t1_decode_native(it[0], it[1], it[2], style, it[3], it[4],
                                it[5], seg_ends=it[6], ojp_recon=True,
                                out_dtype=np.int32)
        np.testing.assert_array_equal(got, want)
    # a corrupt middle block reports a status without poisoning others
    bad = list(items)
    bad[1] = (b"\xff\xff\xff", bad[1][1], bad[1][2], bad[1][3],
              200, 45, [])
    res2 = t1_decode_blocks_native(bad, style, ojp_recon=True)
    assert isinstance(res2[0], np.ndarray) and isinstance(
        res2[2], np.ndarray)
    np.testing.assert_array_equal(res2[0], results[0])
    np.testing.assert_array_equal(res2[2], results[2])


def test_ht_cleanup_blocks_match_scalar(rng):
    """Batched HT cleanup encode/decode = scalar entries per block."""
    from go_dicom_codec_jax.native import (ht_cleanup_decode_blocks_native,
                                           ht_cleanup_decode_native,
                                           ht_cleanup_encode_blocks_native,
                                           ht_cleanup_encode_native)

    if get_lib() is None:
        pytest.skip("native unavailable")
    shapes = [(64, 64), (17, 33), (8, 8), (64, 64)]
    kmaxs = [10, 12, 8, 14]
    blocks = [(rng.standard_normal(s) * 100).astype(np.int32)
              for s in shapes]
    blocks[2][:] = 0  # all-zero
    enc_batched = ht_cleanup_encode_blocks_native(blocks, kmaxs)
    assert enc_batched is not None
    for b, km, got in zip(blocks, kmaxs, enc_batched):
        want = ht_cleanup_encode_native(
            np.ascontiguousarray(b, dtype=np.int64), km)
        assert got == want
    items = [(blob, b.shape[1], b.shape[0], km, km - 1)
             for blob, b, km in zip(enc_batched, blocks, kmaxs)
             if blob]
    dec_batched = ht_cleanup_decode_blocks_native(items)
    assert dec_batched is not None
    for it, got in zip(items, dec_batched):
        want = ht_cleanup_decode_native(it[0], it[1], it[2], it[3], it[4])
        np.testing.assert_array_equal(got, want)


def test_t2_assembly_matches_python(rng, monkeypatch):
    """Native whole-tile packet assembly is byte-identical to the
    Python reference across layers/precincts/progressions/ROI/HT."""
    from go_dicom_codec_jax import native as nat
    from go_dicom_codec_jax.codecs.jpeg2000 import (J2KEncodeParams,
                                                    J2KEncoder)
    from go_dicom_codec_jax.codecs.j2k_roi import ROIRegion

    if get_lib() is None:
        pytest.skip("native unavailable")
    img = rng.integers(0, 4096, size=(96, 80), dtype=np.uint16).tobytes()
    rgb = rng.integers(0, 256, size=(64, 48, 3), dtype=np.uint8).tobytes()
    cases = [
        (J2KEncodeParams(cb_style=0x01), img, (80, 96, 1, 12)),
        (J2KEncodeParams(cb_style=0x00, num_layers=3,
                         progression=2), img, (80, 96, 1, 12)),
        (J2KEncodeParams(lossless=False, quality=40, num_layers=2,
                         layer_rates=[20.0, 0.0]), img, (80, 96, 1, 12)),
        # measured-bytes PCRD trial path (native save/restore vs the
        # Python deepcopy trial): layered lossless + multi-tile global
        (J2KEncodeParams(num_layers=4), img, (80, 96, 1, 12)),
        (J2KEncodeParams(num_layers=3, layer_rates=[8.0, 3.0, 0.0],
                         tile_width=48, tile_height=64),
         img, (80, 96, 1, 12)),
        (J2KEncodeParams(cb_style=0x01, precinct_width=128,
                         precinct_height=128),
         img, (80, 96, 1, 12)),
        (J2KEncodeParams(htj2k=True, progression=2), img,
         (80, 96, 1, 12)),
        (J2KEncodeParams(cb_style=0x01, tile_width=48, tile_height=64),
         img, (80, 96, 1, 12)),
        (J2KEncodeParams(), rgb, (48, 64, 3, 8)),
        (J2KEncodeParams(roi_regions=[ROIRegion(shape="rect",
                                               rect=(8, 8, 40, 40))]),
         img, (80, 96, 1, 12)),
    ]
    for params, pix, (w, h, ncomp, depth) in cases:
        enc = J2KEncoder(params)
        with_native = enc.encode(pix, w, h, ncomp, depth)
        monkeypatch.setattr(nat, "t2_assemble_packets_native",
                            lambda *a, **k: None)
        without = enc.encode(pix, w, h, ncomp, depth)
        monkeypatch.undo()
        assert with_native == without, params


def test_t2_parse_matches_python(rng, monkeypatch):
    """Native whole-tile packet parse decodes to identical pixels as
    the Python reference across layers/progressions/precincts/HT, and
    truncated layered streams keep the clean-stop semantics."""
    from go_dicom_codec_jax import native as nat
    from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder,
                                                    J2KEncodeParams,
                                                    J2KEncoder)

    if get_lib() is None:
        pytest.skip("native unavailable")
    img = rng.integers(0, 4096, size=(96, 80), dtype=np.uint16).tobytes()
    cases = [
        J2KEncodeParams(cb_style=0x01),
        J2KEncodeParams(num_layers=3, progression=2),
        J2KEncodeParams(htj2k=True, progression=2),
        J2KEncodeParams(cb_style=0x01, tile_width=48, tile_height=64),
        J2KEncodeParams(lossless=False, quality=50),
        J2KEncodeParams(precinct_width=128, precinct_height=128),
    ]
    for params in cases:
        cs = J2KEncoder(params).encode(img, 80, 96, 1, 12)
        a = J2KDecoder().decode(cs)
        monkeypatch.setattr(nat, "t2_parse_packets_native",
                            lambda *ar, **k: None)
        b = J2KDecoder().decode(cs)
        monkeypatch.undo()
        np.testing.assert_array_equal(a[0], b[0], err_msg=str(params))

    # truncated layered stream: both lanes decode the shipped prefix
    _check_truncated(rng, monkeypatch)


def test_t2_parse_corrupt_stream_parity(rng, monkeypatch):
    """Corrupt streams must never make the native whole-tile parse
    SILENTLY diverge from the Python reference. The native parser
    returns an error (-> automatic Python fallback) for anything it
    can't parse; the dangerous case is a mutation the native side
    accepts but Python rejects, or one both accept differently. Every
    trial must end in the same (error class | pixels) on both lanes."""
    from go_dicom_codec_jax import native as nat
    from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder,
                                                    J2KEncodeParams,
                                                    J2KEncoder)

    if get_lib() is None:
        pytest.skip("native unavailable")
    img = rng.integers(0, 4096, size=(96, 80), dtype=np.uint16).tobytes()
    for params in [J2KEncodeParams(cb_style=0x01),
                   J2KEncodeParams(num_layers=3)]:
        cs = J2KEncoder(params).encode(img, 80, 96, 1, 12)
        for trial in range(40):
            d2 = bytearray(cs)
            for _ in range(int(rng.integers(1, 4))):
                pos = int(rng.integers(0, len(cs)))
                d2[pos] = int(rng.integers(0, 256))
            outcomes = []
            for lane in ("native", "python"):
                if lane == "python":
                    monkeypatch.setattr(nat, "t2_parse_packets_native",
                                        lambda *a, **k: None)
                try:
                    out = J2KDecoder().decode(bytes(d2))
                    outcomes.append(("ok", out[0].tobytes()))
                except Exception as e:  # noqa: BLE001
                    outcomes.append(("err", type(e).__name__))
                finally:
                    monkeypatch.undo()
            assert outcomes[0] == outcomes[1], \
                f"{params.num_layers} layers trial {trial}"


def test_t2_parse_truncation_sweep_parity(monkeypatch):
    """Every truncation of a tile body must end in the same outcome on
    the native and Python lanes. Truncations ending in 0xFF are swept
    EXHAUSTIVELY: a packet header that completes exactly at end-of-data
    with a trailing 0xFF makes the Python bit reader raise inside
    align_to_byte (the stuffed byte is missing), and the native parse
    used to drop that error and accept the stream (regression: br.bad
    unchecked after br.align())."""
    import struct

    from go_dicom_codec_jax import native as nat
    from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder,
                                                    J2KEncodeParams,
                                                    J2KEncoder)
    from go_dicom_codec_jax.codestream import j2k

    if get_lib() is None:
        pytest.skip("native unavailable")

    def rebuild(s, body):
        # well-formed wrapper around a truncated body: correct Psot, so
        # the failure (if any) happens inside the packet parse
        sot0 = s.index(struct.pack(">HHH", j2k.SOT, 10, 0))
        t = struct.pack(">HHHIBB", j2k.SOT, 10, 0, 12 + 2 + len(body),
                        0, 1)
        return (s[:sot0] + t + struct.pack(">H", j2k.SOD) + body
                + j2k.EOC.to_bytes(2, "big"))

    def outcome(s):
        try:
            out = J2KDecoder().decode(s)
            return ("ok", out[0].tobytes())
        except Exception as e:  # noqa: BLE001
            return ("err", type(e).__name__)

    rng = np.random.default_rng(0)
    img = rng.integers(0, 4096, size=(32, 32), dtype=np.uint16).tobytes()
    for params in [J2KEncodeParams(cb_style=0x01, num_levels=2),
                   J2KEncodeParams(num_layers=2, num_levels=2)]:
        s = J2KEncoder(params).encode(img, 32, 32, 1, 12)
        body = j2k.parse_codestream(s).tiles[0].data
        for ln in range(1, len(body)):
            if body[ln - 1] != 0xFF and ln % 7:
                continue    # all 0xFF-trailing cuts + every 7th other
            t = rebuild(s, body[:ln])
            o_nat = outcome(t)
            monkeypatch.setattr(nat, "t2_parse_packets_native",
                                lambda *a, **k: None)
            o_py = outcome(t)
            monkeypatch.undo()
            assert o_nat == o_py, f"{params.num_layers} layers cut {ln}"


@pytest.mark.parametrize("kind", ["jpegls", "jpegls_near", "baseline",
                                  "baseline_rgb", "extended12",
                                  "p14", "sv1", "htj2k", "htj2k_refined"])
def test_truncation_sweep_lane_parity(kind, tmp_path):
    """Truncation-sweep lane parity for every native scan/block decoder
    (the T2 version of this sweep caught the br.align() regression):
    decoding any sampled prefix of a codestream must end in the same
    (pixels | error class) with the native mirrors and with
    GDCT_DISABLE_NATIVE=1. Native errors auto-fall back to Python, so
    the only way to diverge is a native decoder ACCEPTING a stream the
    Python reference rejects, or producing different pixels."""
    import json
    import os
    import subprocess
    import sys

    from _trunc_sweep import sweep

    if get_lib() is None:
        pytest.skip("native unavailable")

    rng = np.random.default_rng(3)
    img8 = (np.cumsum(rng.integers(-5, 6, (32, 32)), axis=1)
            % 256).astype(np.uint8)
    img12 = rng.integers(0, 4096, (32, 32), dtype=np.uint16)
    if kind in ("jpegls", "jpegls_near"):
        from go_dicom_codec_jax.codecs import jpegls
        stream = jpegls.encode(img12.tobytes(), 32, 32, 1, 12,
                               near=0 if kind == "jpegls" else 2)
        kind = "jpegls"
    elif kind == "baseline":
        from go_dicom_codec_jax.codecs import jpeg_baseline
        stream = jpeg_baseline.encode(img8.tobytes(), 32, 32, 1, 90)
    elif kind == "baseline_rgb":
        from go_dicom_codec_jax.codecs import jpeg_baseline
        rgb = np.stack([img8, img8.T, 255 - img8], axis=-1)
        stream = jpeg_baseline.encode(rgb.tobytes(), 32, 32, 3, 85)
        kind = "baseline"
    elif kind == "extended12":
        from go_dicom_codec_jax.codecs import jpeg_extended
        stream = jpeg_extended.encode(img12.tobytes(), 32, 32, 1, 12,
                                      quality=90)
        kind = "extended"
    elif kind in ("p14", "sv1"):
        from go_dicom_codec_jax.codecs import jpeg_lossless
        stream = jpeg_lossless.encode(img12.tobytes(), 32, 32, 1, 12,
                                      predictor=1 if kind == "sv1" else 4)
        kind = "p14"
    else:
        from go_dicom_codec_jax.codecs.jpeg2000 import (J2KEncodeParams,
                                                        J2KEncoder)
        stream = J2KEncoder(J2KEncodeParams(
            htj2k=True, num_levels=2,
            ht_refinement=kind == "htj2k_refined")
        ).encode(img12.tobytes(), 32, 32, 1, 12)
        kind = "htj2k"

    step = 9
    native_lane = [tuple(r) for r in sweep(kind, stream, step)]

    p = tmp_path / "stream.bin"
    p.write_bytes(stream)
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, GDCT_DISABLE_NATIVE="1", JAX_PLATFORMS="cpu",
               PYTHONPATH=repo_root)
    r = subprocess.run(
        [sys.executable, os.path.join(os.path.dirname(__file__),
                                      "_trunc_sweep.py"),
         kind, str(p), str(step)],
        capture_output=True, text=True, timeout=540, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    python_lane = [tuple(r_) for r_ in json.loads(r.stdout)]
    assert native_lane == python_lane


def _check_truncated(rng, monkeypatch):
    from go_dicom_codec_jax import native as nat
    from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder,
                                                    J2KEncodeParams,
                                                    J2KEncoder)
    img = rng.integers(0, 4096, size=(96, 80), dtype=np.uint16).tobytes()
    cs = J2KEncoder(J2KEncodeParams(num_layers=4)).encode(img, 80, 96,
                                                          1, 12)
    cut = cs[:int(len(cs) * 0.5)] + b"\xff\xd9"
    try:
        a = J2KDecoder().decode(cut)
    except Exception:
        a = None
    monkeypatch.setattr(nat, "t2_parse_packets_native",
                        lambda *ar, **k: None)
    try:
        b = J2KDecoder().decode(cut)
    except Exception:
        b = None
    monkeypatch.undo()
    assert (a is None) == (b is None)
    if a is not None:
        np.testing.assert_array_equal(a[0], b[0])


# ---------------------------------------------------------------------------
# Per-codeblock thread pool (parallel_blocks in ebcot_native.cpp): the
# batched *_blocks entries fan independent code-blocks across
# GDCT_THREADS workers — bytes/pixels must be identical to the serial
# loop for ANY thread count (the reference's Go codecs are
# single-threaded; this is a production multicore surface on top of
# the same bitstreams, jpeg2000/t1/encoder.go:159 semantics).
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("threads", ["3", "8"])
def test_batched_t1_thread_pool_byte_identity(rng, monkeypatch, threads):
    if get_lib() is None:
        pytest.skip("native unavailable")
    from go_dicom_codec_jax.native import (t1_decode_blocks_native,
                                           t1_encode_blocks_native)

    blocks = [rng.integers(-(1 << b), 1 << b, size=(h, w)).astype(np.int64)
              for b, (h, w) in zip(
                  (4, 9, 12, 2, 14, 7, 11, 1),
                  [(64, 64), (64, 64), (32, 64), (17, 5), (64, 33),
                   (1, 64), (13, 13), (64, 64)])]
    blocks.append(np.zeros((64, 64), dtype=np.int64))   # all-zero block
    orients = [i % 4 for i in range(len(blocks))]

    monkeypatch.setenv("GDCT_THREADS", "1")
    serial = t1_encode_blocks_native(blocks, orients, STYLE_LAZY)
    monkeypatch.setenv("GDCT_THREADS", threads)
    pooled = t1_encode_blocks_native(blocks, orients, STYLE_LAZY)
    assert serial is not None and pooled is not None
    assert pooled == serial

    items = [(s, b.shape[1], b.shape[0], o, len(rates), numbps, None)
             for (s, numbps, rates, _t, _b, _n), b, o in
             zip(serial, blocks, orients)]
    monkeypatch.setenv("GDCT_THREADS", "1")
    dec_serial = t1_decode_blocks_native(items, STYLE_LAZY)
    monkeypatch.setenv("GDCT_THREADS", threads)
    dec_pooled = t1_decode_blocks_native(items, STYLE_LAZY)
    assert dec_serial is not None and dec_pooled is not None
    for a, b in zip(dec_serial, dec_pooled):
        np.testing.assert_array_equal(a, b)


def test_batched_ht_thread_pool_byte_identity(rng, monkeypatch):
    if get_lib() is None:
        pytest.skip("native unavailable")
    from go_dicom_codec_jax.native import (
        ht_cleanup_decode_blocks_native, ht_cleanup_encode_blocks_native)

    blocks = [rng.integers(-(1 << b), 1 << b, size=(h, w)).astype(np.int64)
              for b, (h, w) in zip(
                  (5, 12, 9, 3, 13),
                  [(64, 64), (64, 64), (30, 62), (5, 17), (64, 64)])]
    blocks.append(np.zeros((64, 64), dtype=np.int64))
    kmaxs = [max(1, int(np.abs(b).max()).bit_length()) for b in blocks]

    monkeypatch.setenv("GDCT_THREADS", "1")
    serial = ht_cleanup_encode_blocks_native(blocks, kmaxs)
    monkeypatch.setenv("GDCT_THREADS", "5")
    pooled = ht_cleanup_encode_blocks_native(blocks, kmaxs)
    assert serial is not None and pooled is not None
    assert pooled == serial

    items = [(s, b.shape[1], b.shape[0], km, 0)
             for s, b, km in zip(serial, blocks, kmaxs) if s]
    monkeypatch.setenv("GDCT_THREADS", "1")
    dec_serial = ht_cleanup_decode_blocks_native(items)
    monkeypatch.setenv("GDCT_THREADS", "5")
    dec_pooled = ht_cleanup_decode_blocks_native(items)
    for a, b in zip(dec_serial, dec_pooled):
        np.testing.assert_array_equal(a, b)


def test_codec_streams_thread_pool_byte_identity(rng, monkeypatch):
    """Whole-codec J2K + HTJ2K streams and decoded pixels are identical
    under the per-codeblock thread pool (multi-threaded encode of the
    SAME bitstream the serial path makes)."""
    if get_lib() is None:
        pytest.skip("native unavailable")
    import go_dicom_codec_jax as dc

    img = rng.integers(0, 4096, (150, 130), dtype=np.uint16)
    info = dc.FrameInfo(width=130, height=150, bits_allocated=16,
                        bits_stored=12)
    reg = dc.get_global_registry()
    for uid in (dc.uids.JPEG_2000_LOSSLESS, dc.uids.JPEG_2000_LOSSY,
                dc.uids.HTJ2K_LOSSLESS):
        got = {}
        for th in ("1", "4"):
            monkeypatch.setenv("GDCT_THREADS", th)
            src = dc.MemoryPixelData(info=info)
            src.add_frame(img.tobytes())
            enc = dc.MemoryPixelData(info=info, encapsulated=True)
            reg.get_codec(uid).encode(src, enc)
            dec = dc.MemoryPixelData(info=info)
            reg.get_codec(uid).decode(enc, dec)
            got[th] = (enc.get_frame(0), dec.get_frame(0))
        assert got["1"] == got["4"], uid


# --- T1N normalized-flag engine (kept negative experiment) -------------------
# GDCT_T1_ENGINE=1 opts into the store-free normalized engine
# (ebcot_native.cpp struct T1N). It measured SLOWER (BENCHMARKS.md 4i
# experiment #10) and is non-default, but its byte-identity with the
# default engine is pinned here so the in-tree record stays correct.

@pytest.mark.parametrize("style", [0, STYLE_LAZY, STYLE_VSC,
                                   STYLE_LAZY | STYLE_TERMALL | STYLE_RESET
                                   | STYLE_VSC | STYLE_SEGSYM])
def test_t1n_engine_byte_identity(style, rng, monkeypatch):
    for (h, w), mag, roi in [((64, 64), 1 << 12, 0), ((64, 64), 4, 0),
                             ((33, 29), 1 << 8, 0), ((64, 61), 1 << 12, 8),
                             ((5, 7), 1 << 29, 0), ((16, 1), 1 << 12, 0)]:
        data = rng.integers(-mag, mag, (h, w)).astype(np.int64)
        if mag == 4:
            data[rng.random((h, w)) < 0.9] = 0
        for orient in (0, 2):
            monkeypatch.delenv("GDCT_T1_ENGINE", raising=False)
            a = t1_encode_native(data, style, orient, roi, need_nmse=1)
            monkeypatch.setenv("GDCT_T1_ENGINE", "1")
            b = t1_encode_native(data, style, orient, roi, need_nmse=1)
            monkeypatch.delenv("GDCT_T1_ENGINE")
            assert a == b
