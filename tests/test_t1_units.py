"""EBCOT T1 unit tests: pass machinery, NMSEDEC tables, lazy/termination
rules (reference t1/{minimal,test_layout,rl_encoding,termall_bytes,
test_5x5_simple_patterns,test_different_patterns,test_value_range}_test.go,
nmsedec.go).

Whole-block roundtrips and style/geometry sweeps live in test_ebcot.py /
test_t1_sweeps.py / test_termall_layers.py; this file pins the scheduling
and distortion machinery the codec's PCRD depends on.
"""

import numpy as np
import pytest

from go_dicom_codec_jax.entropy.ebcot import (NMSEDEC_REF, NMSEDEC_REF0,
                                              NMSEDEC_SIG, NMSEDEC_SIG0,
                                              STYLE_LAZY, STYLE_TERMALL,
                                              T1Decoder, T1Encoder,
                                              _is_lazy_raw, _is_terminating,
                                              max_bitplanes, nmsedec_ref,
                                              nmsedec_sig)


# ---- bit-plane count --------------------------------------------------------

def test_max_bitplanes_values():
    assert max_bitplanes(np.zeros((4, 4), dtype=np.int64)) == 0
    assert max_bitplanes(np.array([[1]])) == 1
    assert max_bitplanes(np.array([[255]])) == 8
    assert max_bitplanes(np.array([[-256]])) == 9
    assert max_bitplanes(np.array([[3, -400]])) == 9


# ---- pass sequencing (encoder.go:159-282 protocol) --------------------------

def _passes(data, style=0):
    h, w = data.shape
    _, numbps, passes = T1Encoder(w, h, style=style).encode(data)
    return numbps, passes


def test_pass_count_is_3n_minus_2(rng):
    data = rng.integers(-100, 100, size=(8, 8)).astype(np.int64)
    numbps, passes = _passes(data)
    assert numbps == max_bitplanes(data)
    assert len(passes) == 3 * numbps - 2


def test_pass_type_sequence(rng):
    """First pass is cleanup at the top plane, then SPP/MRP/CP triplets."""
    data = rng.integers(-100, 100, size=(8, 8)).astype(np.int64)
    numbps, passes = _passes(data)
    types = [p.pass_type for p in passes]
    assert types[0] == 2
    for i in range(1, len(types), 3):
        assert types[i : i + 3] == [0, 1, 2]


def test_pass_bitplanes_descend(rng):
    data = rng.integers(-500, 500, size=(8, 8)).astype(np.int64)
    numbps, passes = _passes(data)
    assert passes[0].bitplane == numbps - 1
    bps = [p.bitplane for p in passes]
    assert bps == sorted(bps, reverse=True)
    assert passes[-1].bitplane == 0


def test_pass_rates_monotone(rng):
    data = rng.integers(-500, 500, size=(16, 16)).astype(np.int64)
    _, passes = _passes(data)
    rates = [p.rate for p in passes]
    assert rates == sorted(rates)
    assert rates[-1] > 0


def test_default_termination_only_final(rng):
    data = rng.integers(-100, 100, size=(8, 8)).astype(np.int64)
    _, passes = _passes(data, style=0)
    assert [p.terminated for p in passes[:-1]] == [False] * (len(passes) - 1)
    assert passes[-1].terminated


def test_termall_terminates_every_pass(rng):
    data = rng.integers(-100, 100, size=(8, 8)).astype(np.int64)
    _, passes = _passes(data, style=STYLE_TERMALL)
    assert all(p.terminated for p in passes)


def test_all_zero_block_has_no_passes():
    _, numbps, passes = T1Encoder(8, 8).encode(
        np.zeros((8, 8), dtype=np.int64))
    assert numbps == 0 and passes == []


# ---- lazy / termination predicates (encoder.go:51-77) -----------------------

def test_lazy_raw_rule():
    maxbp = 8
    # cleanup passes never go raw
    assert not _is_lazy_raw(0, maxbp, 2, STYLE_LAZY)
    # SPP/MRP go raw strictly below maxbp-3
    assert not _is_lazy_raw(maxbp - 3, maxbp, 0, STYLE_LAZY)
    assert _is_lazy_raw(maxbp - 4, maxbp, 0, STYLE_LAZY)
    assert _is_lazy_raw(0, maxbp, 1, STYLE_LAZY)
    # no lazy style → never raw
    assert not _is_lazy_raw(0, maxbp, 0, 0)


def test_terminating_rule():
    maxbp = 8
    # final cleanup always terminates
    assert _is_terminating(0, maxbp, 2, 0)
    assert not _is_terminating(1, maxbp, 2, 0)
    # TERMALL terminates everything
    assert _is_terminating(5, maxbp, 0, STYLE_TERMALL)
    # lazy: boundary cleanup at maxbp-3, then every SPP→MRP→CP switch
    assert _is_terminating(maxbp - 3, maxbp, 2, STYLE_LAZY)
    assert _is_terminating(maxbp - 4, maxbp, 1, STYLE_LAZY)
    assert not _is_terminating(maxbp - 4, maxbp, 0, STYLE_LAZY)


def test_lazy_pass_terminated_flags_match_predicate(rng):
    data = rng.integers(-2000, 2000, size=(12, 12)).astype(np.int64)
    numbps, passes = _passes(data, style=STYLE_LAZY)
    for p in passes[:-1]:
        # the encoder's maxbp argument is the TOP plane index, numbps−1
        assert p.terminated == _is_terminating(p.bitplane, numbps - 1,
                                               p.pass_type, STYLE_LAZY)


def test_segment_boundaries_match_terminations(rng):
    data = rng.integers(-2000, 2000, size=(12, 12)).astype(np.int64)
    stream, numbps, passes = T1Encoder(12, 12, style=STYLE_TERMALL).encode(
        data)
    dec = T1Decoder(12, 12, style=STYLE_TERMALL)
    bounds = dec.segment_boundaries(numbps, len(passes))
    assert len(bounds) == len(passes)  # TERMALL: one segment per pass


# ---- NMSEDEC tables (t1/nmsedec.go:84-112 / T.800 J.4) ----------------------

def test_nmsedec_sig_table_spot_values():
    # t = 1.0 (index 64): f = 3·1 − 2.25 = 0.75 → 48·128 = 6144
    assert NMSEDEC_SIG[64] == 6144
    # t = 1.5: f = 2.25 → 144·128
    assert NMSEDEC_SIG[96] == 144 * 128
    # below t = 0.75 the significance payoff clamps at 0
    assert NMSEDEC_SIG[0] == 0 and NMSEDEC_SIG[47] == 0


def test_nmsedec_sig0_is_t_squared():
    assert NMSEDEC_SIG0[64] == 64 * 128      # t=1 → 1.0·64·128
    assert NMSEDEC_SIG0[32] == 16 * 128      # t=0.5 → 0.25·64 = 16


def test_nmsedec_ref_vee_shape():
    # f = 0.75−t for t<1 (t=0 → 48), f = t−1.25 for t≥1 (t=1.75 → 32)
    assert NMSEDEC_REF[0] == 48 * 128
    assert NMSEDEC_REF[112] == 32 * 128
    # the trough around t∈[0.75, 1.25] clamps at 0
    assert NMSEDEC_REF[64] == 0


def test_nmsedec_ref0_is_offset_square():
    assert NMSEDEC_REF0[0] == 64 * 128       # (0−1)² = 1
    assert NMSEDEC_REF0[64] == 0             # (1−1)² = 0


def test_nmsedec_indexing_by_bitplane():
    """bp>0 indexes the shifted window; bp=0 uses the 0-plane tables."""
    av = 5
    assert nmsedec_sig(av, 0) == NMSEDEC_SIG0[(av << 6) & 127]
    assert nmsedec_sig(av, 2) == NMSEDEC_SIG[((av << 6) >> 2) & 127]
    assert nmsedec_ref(av, 0) == NMSEDEC_REF0[(av << 6) & 127]
    assert nmsedec_ref(av, 3) == NMSEDEC_REF[((av << 6) >> 3) & 127]


def test_pass_nmsedec_accumulates(rng):
    """A dense block reports positive distortion decreases per pass."""
    data = rng.integers(-1000, 1000, size=(16, 16)).astype(np.int64)
    _, passes = _passes(data)
    assert sum(p.nmsedec for p in passes) > 0
    assert passes[0].nmsedec > 0  # top cleanup codes new significance


# ---- pattern matrix (test_5x5_simple_patterns / different_patterns) ---------

def _roundtrip(data, style=0, num_passes=None):
    h, w = data.shape
    enc = T1Encoder(w, h, style=style)
    stream, numbps, passes = enc.encode(data)
    dec = T1Decoder(w, h, style=style)
    n = num_passes if num_passes is not None else len(passes)
    if style & (STYLE_TERMALL | STYLE_LAZY):
        segs = [p.rate for p in passes if p.terminated]
        return dec.decode(stream, n, numbps, seg_lengths=segs)
    return dec.decode(stream, n, numbps)


@pytest.mark.parametrize("pattern", ["single_center", "single_corner",
                                     "h_stripes", "v_stripes", "diag",
                                     "powers_of_two", "max_neg"])
def test_5x5_simple_patterns(pattern):
    d = np.zeros((5, 5), dtype=np.int64)
    if pattern == "single_center":
        d[2, 2] = 9
    elif pattern == "single_corner":
        d[4, 4] = -17
    elif pattern == "h_stripes":
        d[::2, :] = 21
    elif pattern == "v_stripes":
        d[:, 1::2] = -13
    elif pattern == "diag":
        np.fill_diagonal(d, 127)
    elif pattern == "powers_of_two":
        d[0, :] = [1, 2, 4, 8, 16]
    elif pattern == "max_neg":
        d[:] = -(1 << 20)
    np.testing.assert_array_equal(_roundtrip(d), d)


@pytest.mark.parametrize("mag", [1, 2, 255, 256, 65535, 1 << 24])
def test_value_range_uniform_blocks(mag):
    d = np.full((4, 4), mag, dtype=np.int64)
    d[1, 1] = -mag
    np.testing.assert_array_equal(_roundtrip(d), d)


def test_truncated_passes_reduce_error(rng):
    """Decoding fewer passes yields a coarser but convergent block."""
    data = rng.integers(-1000, 1000, size=(16, 16)).astype(np.int64)
    h, w = data.shape
    stream, numbps, passes = T1Encoder(w, h, style=STYLE_TERMALL).encode(data)
    segs = [p.rate for p in passes]
    errs = []
    for n in (1, len(passes) // 2, len(passes)):
        got = T1Decoder(w, h, style=STYLE_TERMALL).decode(
            stream, n, numbps, seg_lengths=segs[:n])
        errs.append(int(np.abs(got - data).max()))
    assert errs[0] >= errs[1] >= errs[2] == 0


def test_roi_shift_roundtrip(rng):
    """roishift scales low-magnitude samples through the plane-skip path."""
    data = rng.integers(-15, 16, size=(8, 8)).astype(np.int64)
    shift = 5
    h, w = data.shape
    stream, numbps, passes = T1Encoder(w, h).encode(data, roishift=shift)
    got = T1Decoder(w, h).decode(stream, len(passes), numbps, roishift=shift)
    np.testing.assert_array_equal(got, data)
