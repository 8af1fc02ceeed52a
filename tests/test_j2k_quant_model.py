"""Quantization-model unit behaviors.

Mirrors reference jpeg2000/quantization_test.go: quality monotonicity,
(ε, μ) encode/decode precision, subband gain relationships, boundary
qualities, bit depths, decomposition levels, and special-coefficient
quantize/dequantize cases.
"""

import numpy as np
import pytest

from go_dicom_codec_jax.codecs import j2k_quant as q


def test_quality_monotonicity_ll_step():
    """quantization_test.go TestQualityMonotonicity_LLStep: higher
    quality never yields a larger LL step."""
    prev = None
    for quality in range(1, 101):
        ll = q.step_sizes_97(5, quality)[0]
        if prev is not None:
            assert ll <= prev + 1e-12
        prev = ll


@pytest.mark.parametrize("quality", [1, 2, 50, 99, 100])
def test_boundary_quality_values(quality):
    """quantization_test.go TestBoundaryQualityValues: extremes produce
    finite positive steps for every band."""
    steps = q.step_sizes_97(5, quality)
    assert len(steps) == 16
    assert all(np.isfinite(s) and s > 0 for s in steps)


def test_quality_clamped_outside_range():
    assert q.quality_scale(0) == q.quality_scale(1)
    assert q.quality_scale(101) == q.quality_scale(100)


@pytest.mark.parametrize("rb", [8, 10, 12, 16])
def test_encoded_steps_decode_approx(rb):
    """quantization_test.go TestEncodedSteps_DecodeApprox +
    TestEncodedStepsPrecision: (ε, μ) roundtrip error is bounded by the
    11-bit mantissa quantum (2^-11 relative)."""
    for step_rel in (1e-4, 1e-3, 0.01, 0.05, 0.3, 0.9):
        expn, mant = q.encode_step(step_rel, rb)
        assert 0 <= expn <= 31 and 0 <= mant <= 2047
        got = q.decode_step(expn, mant, rb)
        want = step_rel * (1 << rb)
        assert abs(got - want) / want < 1.0 / 2048.0 + 1e-9


def test_zero_step_size_guard():
    """quantization_test.go TestQuantizationZeroStepSize: Δ≤0 falls back
    to pass-through (rounded) instead of dividing by zero."""
    assert q.encode_step(0.0, 12) == (0, 0)
    c = np.array([-2.6, -0.4, 0.0, 0.4, 2.6])
    np.testing.assert_array_equal(q.deadzone_quantize(c, 0.0),
                                  np.rint(c).astype(np.int32))
    qq = np.array([-3, 0, 3], dtype=np.int32)
    np.testing.assert_array_equal(q.dequantize(qq, 0.0), qq)


def test_subband_gain_relationships():
    """quantization_test.go TestSubbandGainRelationships: HL and LH
    share a step at every resolution (transposed filters, same norm),
    steps grow monotonically from coarse to fine resolutions (finer
    bands tolerate coarser quantization), and LL is smallest overall."""
    steps = q.step_sizes_97(3, 50)
    seq = q.band_sequence(3)
    by_band = dict(zip(seq, steps))
    for r in (1, 2, 3):
        assert by_band[(r, 1)] == pytest.approx(by_band[(r, 2)])
        if r > 1:
            assert min(by_band[(r, b)] for b in (1, 2, 3)) > \
                max(by_band[(r - 1, b)] for b in (1, 2, 3))
    assert min(steps) == pytest.approx(steps[0])


@pytest.mark.parametrize("levels", [0, 1, 3, 6])
def test_band_sequence_lengths(levels):
    """quantization_test.go TestDifferentDecompositionLevels /
    TestCalculateQuantizationParams_StyleAndLengths: QCD carries
    1 + 3·levels subband entries in LL,(HL,LH,HH)* order."""
    seq = q.band_sequence(levels)
    assert len(seq) == 1 + 3 * levels
    assert seq[0] == (0, 0)
    assert len(q.step_sizes_97(levels, 40)) == len(seq)


def test_quantize_dequantize_error_by_quality():
    """quantization_test.go TestQuantizeDequantizeErrorByQuality: the
    per-coefficient error is within Δ (the deadzone's zero bin spans
    (−Δ, Δ) and reconstructs to 0; nonzero bins are within Δ/2) and
    shrinks as quality rises."""
    rng = np.random.default_rng(7)
    c = rng.normal(0, 300, 4096).astype(np.float32)
    prev_err = None
    for quality in (10, 40, 70, 95):
        delta = q.step_sizes_97(3, quality)[0] * (1 << 12)
        qv = q.deadzone_quantize(c, delta)
        rec = q.dequantize(qv, delta)
        err = np.abs(rec - c)
        assert err.max() <= delta + 1e-3
        assert err[qv != 0].max() <= delta / 2 + 1e-3
        if prev_err is not None:
            assert err.mean() <= prev_err + 1e-6
        prev_err = err.mean()


def test_special_coefficients():
    """quantization_test.go TestQuantizationWithSpecialCoefficients:
    zeros stay zero (deadzone), exact-multiple magnitudes and signs
    survive, and the sign of the reconstruction matches the input."""
    delta = 2.0
    c = np.array([0.0, 1.999, 2.0, -2.0, 6.0, -6.0, 1e6])
    qv = q.deadzone_quantize(c, delta)
    np.testing.assert_array_equal(qv[:2], [0, 0])
    assert qv[2] == 1 and qv[3] == -1
    rec = q.dequantize(qv, delta)
    assert (np.sign(rec) == np.sign(qv)).all()
    # zero quantized bins reconstruct to exactly zero
    assert rec[0] == 0 and rec[1] == 0
