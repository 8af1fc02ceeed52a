"""Lossy quantization override surface + OpenJPH HTJ2K quantization.

Role of reference encoder.go:46-48 (CustomQuantSteps), lossy/codec.go:
247-272,414-424,485 (SubbandSteps/QuantStepScale/effectiveQuality) and
quantization.go:243-297 (CalculateOpenJPHQuantizationParams).
"""

import math

import numpy as np
import pytest

import go_dicom_codec_jax as dc
from go_dicom_codec_jax.codecs import j2k_quant as jq
from go_dicom_codec_jax.codecs.jpeg2000 import (J2KEncodeParams, J2KEncoder,
                                                decode_to_pixels)
from go_dicom_codec_jax.codestream import j2k

UID_LOSSY = "1.2.840.10008.1.2.4.91"


def _encode_via_adapter(img, bits, params_dict):
    info = dc.FrameInfo(width=img.shape[1], height=img.shape[0],
                        bits_allocated=16, bits_stored=bits)
    src = dc.MemoryPixelData(info=info)
    src.add_frame(img.tobytes())
    codec = dc.get_global_registry().get_codec(UID_LOSSY)
    enc = dc.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc, dc.Parameters(**params_dict))
    return enc.get_frame(0)


def _parse_qcd(stream):
    return j2k.parse_codestream(stream).qcd


def _smooth(rng, bits):
    img = np.cumsum(rng.integers(-5, 6, (64, 64)), axis=1)
    return (img % ((1 << bits) - 64) + 16).astype("<u2")


def test_subband_steps_override_qcd(rng):
    """Explicit subband_steps land in QCD verbatim (via encode_step)."""
    levels = 2
    steps = [0.002 * (i + 1) for i in range(3 * levels + 1)]
    stream = _encode_via_adapter(_smooth(rng, 12), 12,
                                 dict(num_levels=levels,
                                      subband_steps=steps))
    qcd = _parse_qcd(stream)
    from go_dicom_codec_jax.codecs.j2k_geometry import band_gain
    want = [jq.encode_step(s, 12 + band_gain(b))
            for s, (r, b) in zip(steps, jq.band_sequence(levels))]
    assert [tuple(t) for t in qcd.steps] == want


def test_subband_steps_wrong_length_ignored(rng):
    """Mis-sized step lists fall back to the quality curve (reference
    customQuantSteps returns nil on length mismatch)."""
    base = _encode_via_adapter(_smooth(rng, 12), 12, dict(num_levels=2))
    wrong = _encode_via_adapter(_smooth(rng, 12), 12,
                                dict(num_levels=2, subband_steps=[0.5, 0.5]))
    assert _parse_qcd(base).steps == _parse_qcd(wrong).steps


def test_quant_step_scale_adjusts_quality_curve(rng):
    """Scaling steps by S == lowering quality by round(12.5*log2(S))."""
    img = _smooth(rng, 12)
    scaled = _encode_via_adapter(img, 12, dict(quality=80,
                                               quant_step_scale=2.0))
    explicit = _encode_via_adapter(img, 12, dict(quality=80 - 13))
    assert _parse_qcd(scaled).steps == _parse_qcd(explicit).steps


def test_quant_step_scale_multiplies_custom_steps(rng):
    levels = 2
    steps = [0.004] * (3 * levels + 1)
    a = _encode_via_adapter(_smooth(rng, 12), 12,
                            dict(num_levels=levels, subband_steps=steps,
                                 quant_step_scale=2.0))
    b = _encode_via_adapter(_smooth(rng, 12), 12,
                            dict(num_levels=levels,
                                 subband_steps=[s * 2 for s in steps]))
    assert _parse_qcd(a).steps == _parse_qcd(b).steps


def test_custom_steps_roundtrip_quality(rng):
    """Coarser custom steps → worse reconstruction, still decodable."""
    img = _smooth(rng, 12)
    levels = 5
    def roundtrip_err(steps):
        enc = J2KEncoder(J2KEncodeParams(lossless=False,
                                         custom_quant_steps=steps))
        s = enc.encode(img.tobytes(), 64, 64, 1, 12, False)
        pix, *_ = decode_to_pixels(s)
        return np.abs(np.frombuffer(pix, "<u2").astype(int)
                      - img.reshape(-1).astype(int)).max()

    fine = roundtrip_err([0.0005] * (3 * levels + 1))
    coarse = roundtrip_err([0.02] * (3 * levels + 1))
    assert fine <= 16
    assert coarse > fine


# ------------------------------------------------- OpenJPH HTJ2K QCD

def test_openjph_lossless_exponents_match_reference_math():
    """Pin against hand-evaluated reference formula, 5 levels, 12-bit
    (quantization.go:257-274): ε = precision + ceil(log2(BIBO²)) − 1."""
    kind, guard, exps = jq.openjph_qcd_values(5, 12, lossless=True)
    assert kind == "exponents" and guard == 1
    lo = jq.OPENJPH_53_LOW_BIBO
    hi = jq.OPENJPH_53_HIGH_BIBO
    want = [12 + math.ceil(math.log2(lo[5] ** 2)) - 1]
    for d in range(5, 0, -1):
        m = 12 + math.ceil(math.log2(lo[d] * hi[d - 1])) - 1
        want += [m, m, 12 + math.ceil(math.log2(hi[d - 1] ** 2)) - 1]
    assert exps == want
    assert len(exps) == 16
    # RCT reserves one more precision bit
    _, _, exps_rct = jq.openjph_qcd_values(5, 12, lossless=True,
                                           uses_rct=True)
    assert exps_rct == [e + 1 for e in exps]


def test_openjph_lossy_steps_match_reference_math():
    """Lossy: Δ = 2^-min(16,depth) / gain-product, encoded with the
    normalize-mantissa scheme (quantization.go:276-296)."""
    kind, guard, steps = jq.openjph_qcd_values(5, 12, lossless=False)
    assert kind == "steps" and guard == 1
    base = 2.0 ** -12
    lo, hi = jq.OPENJPH_97_LOW_GAIN, jq.OPENJPH_97_HIGH_GAIN

    def enc(delta):
        e = 0
        while delta < 1:
            e += 1
            delta *= 2
        return (e, min(int(round(delta * 2048)) - 2048, 2047))

    want = [enc(base / (lo[5] * lo[5]))]
    for d in range(5, 0, -1):
        m = enc(base / (lo[d] * hi[d - 1]))
        want += [m, m, enc(base / (hi[d - 1] * hi[d - 1]))]
    assert [tuple(t) for t in steps] == want


def test_htj2k_codestream_uses_openjph_qcd(rng):
    """HT encodes now carry OpenJPH-style QCD (guard 1, BIBO exponents)
    and still roundtrip bit-exact."""
    img = _smooth(rng, 12)
    enc = J2KEncoder(J2KEncodeParams(lossless=True, htj2k=True))
    s = enc.encode(img.tobytes(), 64, 64, 1, 12, False)
    qcd = _parse_qcd(s)
    assert qcd.guard_bits == 1
    _, _, want = jq.openjph_qcd_values(5, 12, lossless=True)
    assert qcd.exponents == want
    pix, *_ = decode_to_pixels(s)
    np.testing.assert_array_equal(
        np.frombuffer(pix, "<u2").reshape(64, 64), img)


def test_rate_levels_convenience_mapping(rng):
    """fo-dicom rate/rate_levels → layer_rates translation (reference
    lossless/codec.go:337-376)."""
    from go_dicom_codec_jax.codecs.j2k_adapters import openjpeg_layer_rates

    # leading levels above the rate become intermediate layers; the
    # final layer is rate scaled by stored/allocated bits
    assert openjpeg_layer_rates(10, [80, 40, 20, 5], 12, 16, False) == \
        [80.0, 40.0, 20.0, 10.0 * 12 / 16]
    assert openjpeg_layer_rates(10, None, 16, 16, True) == [10.0, 0.0]
    assert openjpeg_layer_rates(0, [80], 12, 16, False) is None

    # end to end: the encoded stream carries the derived layer count
    img = _smooth(rng, 12)
    stream = _encode_via_adapter(img, 12,
                                 dict(rate=8, rate_levels=[64, 32, 16]))
    cs = j2k.parse_codestream(stream)
    assert cs.cod.num_layers == 4
