"""Part 2 MCT/MCC/MCO marker + matrix-transform unit tests (reference
mct_marker_test.go, mct_matrix_test.go, mct_int32_test.go, mct_order_test.go,
mcc_assoc_order_test.go, mcc_multi_subset_test.go, mco_*_test.go).

Adapter-level Part 2 roundtrips live in test_j2k_features.py /
test_mct_builder.py; this file pins marker byte layouts and the einsum
matrix path in isolation.
"""

import numpy as np
import pytest

from go_dicom_codec_jax.codestream.j2k import (MCT_ARRAY_DECORRELATE,
                                               MCT_ARRAY_OFFSET,
                                               MCT_ELEM_F32, MCT_ELEM_F64,
                                               MCT_ELEM_I16, MCT_ELEM_I32,
                                               parse_mcc_segment,
                                               parse_mco_segment,
                                               parse_mct_segment,
                                               write_mcc_record,
                                               write_mco_record,
                                               write_mct_record)
from go_dicom_codec_jax.errors import CorruptStreamError
from go_dicom_codec_jax.ops.mct import (mct_matrix_forward,
                                        mct_matrix_inverse)


def _payload(seg: bytes) -> bytes:
    """Strip marker (2) + length (2) framing."""
    return seg[4:]


# ---- MCT record layout ------------------------------------------------------

@pytest.mark.parametrize("elem_type,vals", [
    (MCT_ELEM_I16, [1, -2, 300]),
    (MCT_ELEM_I32, [100000, -100000, 0]),
    (MCT_ELEM_F32, [0.5, -0.25, 2.0]),
    (MCT_ELEM_F64, [1.0 / 3.0, -7.125, 9.0]),
])
def test_mct_record_roundtrip(elem_type, vals):
    seg = write_mct_record(5, MCT_ARRAY_DECORRELATE, elem_type, vals)
    idx, atype, etype, got = parse_mct_segment(_payload(seg))
    assert (idx, atype, etype) == (5, MCT_ARRAY_DECORRELATE, elem_type)
    if elem_type == MCT_ELEM_F32:
        np.testing.assert_allclose(got, vals, rtol=1e-6)
    else:
        assert got == pytest.approx(vals)


def test_mct_offset_array_type_roundtrip():
    seg = write_mct_record(2, MCT_ARRAY_OFFSET, MCT_ELEM_I32, [128, 128, 128])
    _, atype, _, vals = parse_mct_segment(_payload(seg))
    assert atype == MCT_ARRAY_OFFSET and vals == [128, 128, 128]


def test_mct_imct_bitfield_packing():
    """Imct = index | array_type<<8 | elem_type<<10 (encoder.go:863-882)."""
    seg = write_mct_record(7, MCT_ARRAY_OFFSET, MCT_ELEM_F64, [1.0])
    imct = int.from_bytes(_payload(seg)[2:4], "big")
    assert imct & 0xFF == 7
    assert (imct >> 8) & 0x3 == MCT_ARRAY_OFFSET
    assert (imct >> 10) & 0x3 == MCT_ELEM_F64


def test_mct_parse_rejects_short_payload():
    with pytest.raises(CorruptStreamError):
        parse_mct_segment(b"\x00\x00\x00")


# ---- MCC record layout ------------------------------------------------------

def test_mcc_roundtrip_narrow_ids():
    seg = write_mcc_record(1, [0, 1, 2], reversible=True, deco_index=4,
                           offset_index=9)
    idx, ids, rev, deco, off = parse_mcc_segment(_payload(seg))
    assert (idx, ids, rev, deco, off) == (1, [0, 1, 2], True, 4, 9)


def test_mcc_roundtrip_wide_ids():
    """Component ids >255 switch the id lists to 16-bit entries."""
    comp = [0, 300, 700]
    seg = write_mcc_record(2, comp, reversible=False, deco_index=1,
                           offset_index=0)
    idx, ids, rev, deco, off = parse_mcc_segment(_payload(seg))
    assert ids == comp and rev is False and (deco, off) == (1, 0)


def test_mcc_irreversible_flag_bit():
    rev = _payload(write_mcc_record(0, [0, 1, 2], True, 0, 0))
    irr = _payload(write_mcc_record(0, [0, 1, 2], False, 0, 0))
    # Tmcc bit 16 (first byte of the trailing 3-byte field) is the flag
    assert rev[-3] & 0x01 == 1
    assert irr[-3] & 0x01 == 0


def test_mcc_subset_preserves_order():
    """Non-contiguous, permuted component subsets survive the roundtrip
    (reference mcc_assoc_order_test.go / mcc_multi_subset_test.go)."""
    comp = [3, 0, 5]
    _, ids, _, _, _ = parse_mcc_segment(
        _payload(write_mcc_record(0, comp, True, 0, 0)))
    assert ids == comp


def test_mcc_parse_rejects_truncation():
    seg = _payload(write_mcc_record(1, [0, 1, 2], True, 0, 0))
    with pytest.raises(CorruptStreamError):
        parse_mcc_segment(seg[:-2])
    with pytest.raises(CorruptStreamError):
        parse_mcc_segment(b"\x00\x00")


# ---- MCO record -------------------------------------------------------------

def test_mco_roundtrip():
    assert parse_mco_segment(_payload(write_mco_record([2, 0, 1]))) == [2, 0, 1]


def test_mco_empty():
    assert parse_mco_segment(_payload(write_mco_record([]))) == []
    assert parse_mco_segment(b"") == []


def test_mco_ignores_trailing_bytes():
    assert parse_mco_segment(b"\x02\x05\x06\xff\xff") == [5, 6]


# ---- custom-matrix transform (einsum path) ----------------------------------

def test_matrix_identity_is_noop(rng):
    x = rng.uniform(-100, 100, size=(3, 4, 5)).astype(np.float32)
    y = np.asarray(mct_matrix_forward(x, np.eye(3, dtype=np.float32)))
    np.testing.assert_allclose(y, x, atol=1e-5)


def test_matrix_forward_inverse_roundtrip(rng):
    m = np.array([[0.5, 0.3, 0.2],
                  [-0.2, 0.9, -0.1],
                  [0.1, -0.4, 1.2]], dtype=np.float32)
    minv = np.linalg.inv(m.astype(np.float64)).astype(np.float32)
    x = rng.uniform(-500, 500, size=(3, 8, 8)).astype(np.float32)
    y = np.asarray(mct_matrix_inverse(mct_matrix_forward(x, m), minv))
    np.testing.assert_allclose(y, x, atol=1e-2)


def test_matrix_offsets_subtracted_before_matrix(rng):
    """Forward: (x − offset) @ M; inverse adds offsets back last
    (reference mct_transform_test.go semantics)."""
    m = 2.0 * np.eye(2, dtype=np.float32)
    off = np.array([10.0, 20.0], dtype=np.float32)
    x = np.stack([np.full((2, 2), 11.0), np.full((2, 2), 22.0)]).astype(
        np.float32)
    y = np.asarray(mct_matrix_forward(x, m, off))
    np.testing.assert_allclose(y[0], 2.0)   # (11-10)*2
    np.testing.assert_allclose(y[1], 4.0)   # (22-20)*2
    back = np.asarray(mct_matrix_inverse(y, np.linalg.inv(m), off))
    np.testing.assert_allclose(back, x, atol=1e-4)


def test_matrix_int32_values_exact_in_float32():
    """Int coefficient data up to 2^20 survives the float32 path exactly
    (reference mct_int32_test.go precision policy)."""
    x = np.array([[[1 << 20, -(1 << 20)]], [[12345, -54321]]],
                 dtype=np.int32)
    y = np.asarray(mct_matrix_forward(x.astype(np.float32),
                                      np.eye(2, dtype=np.float32)))
    np.testing.assert_array_equal(y.astype(np.int64), x)


def test_matrix_rct_equivalent_matrix(rng):
    """The ICT as a custom matrix matches the dedicated ICT constants."""
    from go_dicom_codec_jax.ops.mct import ict_forward
    m = np.array([[0.299, 0.587, 0.114],
                  [-0.168736, -0.331264, 0.5],
                  [0.5, -0.418688, -0.081312]], dtype=np.float32)
    rgb = rng.uniform(0, 255, size=(3, 6, 6)).astype(np.float32)
    via_matrix = np.asarray(mct_matrix_forward(rgb, m))
    y, cb, cr = ict_forward(rgb[0], rgb[1], rgb[2])
    np.testing.assert_allclose(via_matrix[0], np.asarray(y), atol=1e-2)
    np.testing.assert_allclose(via_matrix[1], np.asarray(cb), atol=1e-2)
    np.testing.assert_allclose(via_matrix[2], np.asarray(cr), atol=1e-2)
