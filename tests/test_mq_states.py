"""MQ coder state-machine validation.

Role of reference jpeg2000/mqc/{state_validation,verify_tables,
openjpeg_alignment}_test.go: pin the 47-state Qe/NMPS/NLPS/SWITCH
tables against an independently-typed copy of ISO/IEC 15444-1 Table C.2
(the reference parses OpenJPEG's mqc.c for the same purpose), check the
Annex C initialization constants, and exercise the encoder/decoder
state machine over bit-pattern roundtrips in every mode.
"""

import numpy as np
import pytest

from go_dicom_codec_jax.entropy.mq import (NLPS, NMPS, QE, SWITCH,
                                           MQDecoder, MQEncoder)

# Independent transcription of ISO/IEC 15444-1 Table C.2 (also JBIG2
# Table E.1) — typed from the standard, column by column.
ISO_TABLE_C2 = [
    # (Qe, NMPS, NLPS, SWITCH)
    (0x5601, 1, 1, 1), (0x3401, 2, 6, 0), (0x1801, 3, 9, 0),
    (0x0AC1, 4, 12, 0), (0x0521, 5, 29, 0), (0x0221, 38, 33, 0),
    (0x5601, 7, 6, 1), (0x5401, 8, 14, 0), (0x4801, 9, 14, 0),
    (0x3801, 10, 14, 0), (0x3001, 11, 17, 0), (0x2401, 12, 18, 0),
    (0x1C01, 13, 20, 0), (0x1601, 29, 21, 0), (0x5601, 15, 14, 1),
    (0x5401, 16, 14, 0), (0x5101, 17, 15, 0), (0x4801, 18, 16, 0),
    (0x3801, 19, 17, 0), (0x3401, 20, 18, 0), (0x3001, 21, 19, 0),
    (0x2801, 22, 19, 0), (0x2401, 23, 20, 0), (0x2201, 24, 21, 0),
    (0x1C01, 25, 22, 0), (0x1801, 26, 23, 0), (0x1601, 27, 24, 0),
    (0x1401, 28, 25, 0), (0x1201, 29, 26, 0), (0x1101, 30, 27, 0),
    (0x0AC1, 31, 28, 0), (0x09C1, 32, 29, 0), (0x08A1, 33, 30, 0),
    (0x0521, 34, 31, 0), (0x0441, 35, 32, 0), (0x02A1, 36, 33, 0),
    (0x0221, 37, 34, 0), (0x0141, 38, 35, 0), (0x0111, 39, 36, 0),
    (0x0085, 40, 37, 0), (0x0049, 41, 38, 0), (0x0025, 42, 39, 0),
    (0x0015, 43, 40, 0), (0x0009, 44, 41, 0), (0x0005, 45, 42, 0),
    (0x0001, 45, 43, 0), (0x5601, 46, 46, 0),
]


def test_qe_values_match_iso_c2():
    assert list(QE) == [row[0] for row in ISO_TABLE_C2]


def test_nmps_values_match_iso_c2():
    assert list(NMPS) == [row[1] for row in ISO_TABLE_C2]


def test_nlps_values_match_iso_c2():
    assert list(NLPS) == [row[2] for row in ISO_TABLE_C2]


def test_switch_values_match_iso_c2():
    assert list(SWITCH) == [row[3] for row in ISO_TABLE_C2]


def test_state_transitions_in_range():
    for i in range(47):
        assert 0 <= NMPS[i] < 47
        assert 0 <= NLPS[i] < 47


def test_switch_only_on_startup_states():
    """MPS sense flips exactly at the three fast-attack states."""
    assert [i for i in range(47) if SWITCH[i]] == [0, 6, 14]


def test_qe_monotone_within_runs():
    """Qe never increases along the NMPS chain (adaptation converges)."""
    for i in range(47):
        assert QE[NMPS[i]] <= QE[i] or SWITCH[i] == 1 or i in (5, 13)


def test_terminal_state_self_loops():
    assert NMPS[46] == 46 and NLPS[46] == 46


def test_encoder_initialization():
    """Annex C.2.3 INITENC: A=0x8000, C=0, CT=12, contexts zeroed."""
    enc = MQEncoder(19)
    assert enc.a == 0x8000
    assert enc.c == 0
    assert enc.ct == 12
    assert enc.get_contexts() == [0] * 19


def test_decoder_initialization():
    dec = MQDecoder(b"\x00", 19)
    assert dec.a == 0x8000
    assert dec.get_contexts() == [0] * 19


@pytest.mark.parametrize("bits", [
    [0] * 8,
    [1] * 8,
    [0, 1] * 4,
    [1, 0, 1, 1, 0, 0, 1, 0, 1, 1, 1, 0, 0, 0, 1, 1],
    [1] * 64,
    [0] * 64,
])
def test_mq_roundtrip_single_context(bits):
    enc = MQEncoder(1)
    for b in bits:
        enc.encode(b, 0)
    enc.flush()
    dec = MQDecoder(enc.get_buffer(), 1)
    assert [dec.decode(0) for _ in bits] == bits


def test_mq_roundtrip_multi_context(rng):
    bits = rng.integers(0, 2, 500).tolist()
    ctxs = rng.integers(0, 19, 500).tolist()
    enc = MQEncoder(19)
    for b, c in zip(bits, ctxs):
        enc.encode(b, c)
    enc.flush()
    dec = MQDecoder(enc.get_buffer(), 19)
    assert [dec.decode(c) for c in ctxs] == bits


def test_mq_roundtrip_biased_streams(rng):
    """Highly-skewed distributions drive the full NMPS ladder."""
    for p in (0.01, 0.1, 0.5, 0.9, 0.99):
        bits = (rng.random(2000) < p).astype(int).tolist()
        enc = MQEncoder(2)
        for b in bits:
            enc.encode(b, 1)
        enc.flush()
        dec = MQDecoder(enc.get_buffer(), 2)
        assert [dec.decode(1) for _ in bits] == bits, f"p={p}"


def test_mq_context_states_advance(rng):
    """Encoding a long skewed stream walks the context off state 0."""
    enc = MQEncoder(1)
    for _ in range(200):
        enc.encode(0, 0)
    states = enc.get_contexts()
    assert states[0] != 0


def test_mq_encoder_decoder_context_agreement(rng):
    """After coding the same stream, encoder and decoder contexts agree
    (the save/restore contract used across terminated passes)."""
    bits = rng.integers(0, 2, 300).tolist()
    ctxs = rng.integers(0, 5, 300).tolist()
    enc = MQEncoder(5)
    for b, c in zip(bits, ctxs):
        enc.encode(b, c)
    enc.flush()
    dec = MQDecoder(enc.get_buffer(), 5)
    for c in ctxs:
        dec.decode(c)
    assert enc.get_contexts() == dec.get_contexts()


def test_mq_bypass_roundtrip(rng):
    """Lazy (raw) mode: bypass bits survive byte-stuffing."""
    from go_dicom_codec_jax.entropy.mq import RawDecoder

    bits = rng.integers(0, 2, 333).tolist()
    enc = MQEncoder(1)
    enc.encode(1, 0)  # some MQ output first (as in a real LAZY block)
    enc.flush()
    prefix_len = enc.num_bytes()
    enc.bypass_init()
    for b in bits:
        enc.bypass_encode(b)
    enc.bypass_flush(False)
    data = enc.get_buffer()
    dec = RawDecoder(data[prefix_len:])
    assert [dec.decode() for _ in bits] == bits


def test_mq_erterm_stream_decodable(rng):
    """ERTERM (error-resilient termination) streams still decode."""
    bits = rng.integers(0, 2, 100).tolist()
    enc = MQEncoder(1)
    for b in bits:
        enc.encode(b, 0)
    enc.erterm()
    dec = MQDecoder(enc.get_buffer(), 1)
    assert [dec.decode(0) for _ in bits] == bits


def test_mq_restart_reinit_roundtrip(rng):
    """RESTART: terminated pass boundaries re-init coder but keep
    contexts."""
    enc = MQEncoder(3)
    first = rng.integers(0, 2, 60).tolist()
    for b in first:
        enc.encode(b, 2)
    enc.flush()
    n1 = enc.num_bytes()
    ctx_snapshot = enc.get_contexts()
    enc.restart_init()
    second = rng.integers(0, 2, 60).tolist()
    for b in second:
        enc.encode(b, 2)
    enc.flush()
    data = enc.get_buffer()

    d1 = MQDecoder(data[:n1], 3)
    assert [d1.decode(2) for _ in first] == first
    d2 = MQDecoder(data[n1:], 3)
    for cx, st in enumerate(ctx_snapshot):
        d2.set_context_state(cx, st)
    assert [d2.decode(2) for _ in second] == second


def test_mq_flush_produces_no_trailing_ff(rng):
    """OpenJPEG-style flush never ends a segment with a dangling 0xFF
    pair that would alias a marker."""
    for seed in range(10):
        r = np.random.default_rng(seed)
        enc = MQEncoder(2)
        for b in r.integers(0, 2, 120):
            enc.encode(int(b), int(b) % 2)
        enc.flush()
        data = enc.get_buffer()
        for i in range(len(data) - 1):
            if data[i] == 0xFF:
                assert data[i + 1] <= 0x8F, data.hex()


def test_mq_empty_stream_decode_returns_bits():
    """Decoding past the end of data keeps producing (1-fill) bits
    without raising — decoder resilience contract."""
    dec = MQDecoder(b"", 2)
    out = [dec.decode(0) for _ in range(32)]
    assert all(b in (0, 1) for b in out)


def test_mq_single_byte_streams():
    for byte in (0x00, 0x7F, 0x80, 0xFE):
        dec = MQDecoder(bytes([byte]), 1)
        out = [dec.decode(0) for _ in range(16)]
        assert all(b in (0, 1) for b in out)


def test_mq_native_python_byte_parity(rng):
    """The native MQ (inside T1) and Python MQ produce identical bytes —
    via the T1 wrapper, the only public native MQ surface."""
    from go_dicom_codec_jax.entropy.ebcot import T1Encoder
    from go_dicom_codec_jax.native import get_lib, t1_encode_native

    if get_lib() is None:
        pytest.skip("native unavailable")
    data = rng.integers(-200, 200, size=(16, 16)).astype(np.int32)
    py_stream, py_numbps, _ = T1Encoder(16, 16).encode(data)
    native = t1_encode_native(data, 0, 0)
    assert native[0] == py_stream
