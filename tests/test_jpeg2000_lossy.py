"""JPEG 2000 lossy path: 9/7 DWT accuracy, quantization, quality sweep.

Mirrors reference jpeg2000/lossy coverage (distortion_accuracy_test.go,
lossy/codec_test.go quality behavior).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from go_dicom_codec_jax import MemoryPixelData, get_global_registry, uids
from go_dicom_codec_jax.codecs import j2k_quant as jq
from go_dicom_codec_jax.codecs.jpeg2000 import (J2KEncodeParams, J2KEncoder,
                                                decode_to_pixels)
from go_dicom_codec_jax.frames import FrameInfo
from go_dicom_codec_jax.ops.dwt97 import (fwd97_1d, fwd97_2d,
                                          fwd97_multilevel, inv97_1d,
                                          inv97_2d, inv97_multilevel)


def _smooth(rng, h, w, amp, c=1):
    small = rng.random((h // 8 + 2, w // 8 + 2, c))
    ys = np.linspace(0, small.shape[0] - 1.001, h)
    xs = np.linspace(0, small.shape[1] - 1.001, w)
    y0, x0 = ys.astype(int), xs.astype(int)
    fy, fx = (ys - y0)[:, None, None], (xs - x0)[None, :, None]
    out = (small[y0][:, x0] * (1 - fy) * (1 - fx)
           + small[y0][:, x0 + 1] * (1 - fy) * fx
           + small[y0 + 1][:, x0] * fy * (1 - fx)
           + small[y0 + 1][:, x0 + 1] * fy * fx)
    r = np.round(out * amp)
    return r.squeeze(-1) if c == 1 else r


@pytest.mark.parametrize("w", [2, 5, 8, 17, 64])
@pytest.mark.parametrize("even", [True, False])
def test_97_1d_roundtrip(w, even, rng):
    x = rng.normal(0, 1000, size=(3, w)).astype(np.float32)
    f = fwd97_1d(jnp.asarray(x), even)
    back = np.asarray(inv97_1d(f, even))
    np.testing.assert_allclose(back, x, atol=0.02)


@pytest.mark.parametrize("shape", [(8, 8), (17, 31), (64, 64)])
def test_97_2d_multilevel_roundtrip(shape, rng):
    h, w = shape
    x = rng.normal(0, 1000, size=(2, h, w)).astype(np.float32)
    for levels in (1, 3):
        f = fwd97_multilevel(jnp.asarray(x), levels, 3, 5)
        back = np.asarray(inv97_multilevel(f, levels, 3, 5))
        np.testing.assert_allclose(back, x, atol=0.5)


def test_97_energy_compaction(rng):
    """Smooth input → energy concentrates in LL."""
    img = _smooth(rng, 64, 64, 1000).astype(np.float32)
    f = np.asarray(fwd97_2d(jnp.asarray(img)))
    ll = f[:32, :32]
    rest = np.concatenate([f[:32, 32:].ravel(), f[32:, :].ravel()])
    assert np.abs(ll).sum() > 10 * np.abs(rest).sum()


def test_step_encoding_roundtrip():
    # relative steps must stay < 2 (unsigned 5-bit ε bounds Δ ≤ 2·2^Rb)
    for step in (0.001, 0.01, 0.3, 1.0, 1.8):
        for rb in (8, 12, 18):
            e, m = jq.encode_step(step, rb)
            # decode_step returns the absolute Δ = step * 2^rb (approx)
            got = jq.decode_step(e, m, rb)
            want = step * (1 << rb)
            assert abs(got - want) / want < 0.01, (step, rb, got, want)


def test_deadzone_quantizer():
    c = np.array([-5.5, -0.4, 0.0, 0.4, 1.0, 7.9])
    q = jq.deadzone_quantize(c, 1.0)
    np.testing.assert_array_equal(q, [-5, 0, 0, 0, 1, 7])
    dq = jq.dequantize(q, 1.0)
    assert abs(dq[0] - (-5.5)) <= 0.5 + 1e-6


@pytest.mark.parametrize("quality,psnr_min", [(95, 44), (85, 40), (50, 31)])
def test_gray_lossy_quality_sweep(quality, psnr_min, rng):
    h, w = 64, 64
    img = _smooth(rng, h, w, 4000).astype("<u2")
    enc = J2KEncoder(J2KEncodeParams(lossless=False, quality=quality,
                                     num_levels=3))
    data = enc.encode(img.tobytes(), w, h, 1, 12)
    pix, ow, oh, oc, depth, signed = decode_to_pixels(data)
    got = np.frombuffer(pix, dtype="<u2").reshape(h, w).astype(np.float64)
    mse = ((got - img.astype(np.float64)) ** 2).mean()
    psnr = 10 * np.log10((4095.0 ** 2) / max(mse, 1e-9))
    assert psnr > psnr_min, f"q{quality}: PSNR {psnr:.1f} < {psnr_min}"
    # lossy must actually compress smooth content well
    assert len(data) < img.nbytes // 2


def test_lossy_compresses_better_at_lower_quality(rng):
    img = _smooth(rng, 64, 64, 250, c=1).astype(np.uint8)
    sizes = []
    for q in (90, 60, 30):
        enc = J2KEncoder(J2KEncodeParams(lossless=False, quality=q,
                                         num_levels=3))
        sizes.append(len(enc.encode(img.tobytes(), 64, 64, 1, 8)))
    assert sizes[0] > sizes[1] > sizes[2]


def test_rgb_lossy_ict(rng):
    img = _smooth(rng, 32, 32, 250, c=3).astype(np.uint8)
    enc = J2KEncoder(J2KEncodeParams(lossless=False, quality=90,
                                     num_levels=2))
    data = enc.encode(img.tobytes(), 32, 32, 3, 8)
    pix, _, _, oc, _, _ = decode_to_pixels(data)
    got = np.frombuffer(pix, dtype=np.uint8).reshape(32, 32, 3).astype(int)
    assert oc == 3
    assert np.abs(got - img.astype(int)).mean() < 4


def test_registry_lossy(rng):
    info = FrameInfo(width=48, height=48, bits_allocated=16, bits_stored=12)
    codec = get_global_registry().get_codec(uids.JPEG_2000_LOSSY)
    img = _smooth(rng, 48, 48, 4000).astype("<u2")
    src = MemoryPixelData(info=info)
    src.add_frame(img.tobytes())
    enc = MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc, codec.get_default_parameters().with_quality(90))
    assert len(enc.get_frame(0)) < len(src.get_frame(0))
    dec = MemoryPixelData(info=info)
    codec.decode(enc, dec)
    got = np.frombuffer(dec.get_frame(0), dtype="<u2").astype(int)
    err = np.abs(got - img.reshape(-1).astype(int))
    assert err.mean() < 20


def test_lossy_rejects_signed():
    from go_dicom_codec_jax.errors import UnsupportedFormatError
    info = FrameInfo(width=8, height=8, bits_allocated=16,
                     pixel_representation=1)
    codec = get_global_registry().get_codec(uids.JPEG_2000_LOSSY)
    src = MemoryPixelData(info=info)
    src.add_frame(bytes(128))
    with pytest.raises(UnsupportedFormatError):
        codec.encode(src, MemoryPixelData(info=info))
