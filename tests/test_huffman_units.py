"""JPEG Huffman core unit tests.

Role of reference jpeg/standard/{huffman,optimal_huffman}_test.go:
canonical code construction, the K.2-style optimal builder's
constraints (16-bit cap, no all-ones code), category/extend math, and
DHT payload roundtrips.
"""

import numpy as np
import pytest

from go_dicom_codec_jax.entropy import huffman as hf
from go_dicom_codec_jax.utils.npbits import BitReader


def _codes(tab):
    """[(symbol, code, length)] for defined symbols."""
    return [(s, int(tab.code_of[s]), int(tab.len_of[s]))
            for s in range(256) if tab.len_of[s] > 0]


def test_standard_tables_canonical():
    """K.3 tables are canonical: codes increase with length, no code is
    a prefix of another."""
    for tab in (hf.DC_LUMA, hf.AC_LUMA, hf.DC_CHROMA, hf.AC_CHROMA):
        entries = sorted(_codes(tab), key=lambda e: (e[2], e[1]))
        seen = []
        for (_, code, length) in entries:
            for (c2, l2) in seen:
                assert (code >> (length - l2)) != c2, "prefix violation"
            seen.append((code, length))


def test_dc_luma_known_codes():
    """T.81 Table K.3: category 0 -> 00 (2 bits), category 2 -> 011."""
    assert hf.DC_LUMA.len_of[0] == 2 and hf.DC_LUMA.code_of[0] == 0b00
    assert hf.DC_LUMA.len_of[2] == 3


def test_optimal_table_prefers_frequent_symbols():
    freq = np.zeros(256, dtype=np.int64)
    freq[5] = 1000
    freq[7] = 10
    freq[9] = 1
    tab = hf.build_optimal_table(freq)
    assert tab.len_of[5] <= tab.len_of[7] <= tab.len_of[9]
    assert tab.len_of[5] >= 1


def test_optimal_table_respects_16bit_cap(rng):
    """Highly skewed frequencies would want >16-bit codes; the K.2
    adjust step caps them."""
    freq = np.zeros(256, dtype=np.int64)
    for i in range(40):
        freq[i] = 1 << max(0, 38 - i)  # geometric: ideal lengths explode
    tab = hf.build_optimal_table(freq)
    lens = [int(tab.len_of[s]) for s in range(256) if tab.len_of[s]]
    assert max(lens) <= 16
    # Kraft inequality still satisfied
    assert sum(2.0 ** -l for l in lens) <= 1.0 + 1e-12


def test_optimal_table_single_symbol():
    freq = np.zeros(256, dtype=np.int64)
    freq[42] = 17
    tab = hf.build_optimal_table(freq)
    assert tab.len_of[42] >= 1  # never a zero-length code


def test_optimal_roundtrips_through_decode(rng):
    freq = np.zeros(256, dtype=np.int64)
    syms = rng.integers(0, 16, 500)
    for s in syms:
        freq[s] += 1
    tab = hf.build_optimal_table(freq)
    from go_dicom_codec_jax.utils.npbits import pack_bits_msb

    vals = np.asarray([int(tab.code_of[s]) for s in syms], dtype=np.int64)
    lens = np.asarray([int(tab.len_of[s]) for s in syms], dtype=np.int64)
    data = pack_bits_msb(vals, lens)
    br = BitReader(np.frombuffer(data, dtype=np.uint8))
    got = [tab.decode(br) for _ in syms]
    assert got == list(syms)


def test_categories_and_extend_inverse(rng):
    vals = rng.integers(-32767, 32768, 300)
    cats = hf.categories(vals)
    ebits = hf.extend_bits(vals, cats)
    for v, c, e in zip(vals, cats, ebits):
        assert hf.receive_extend(int(e), int(c)) == v


def test_category_boundaries():
    for v, want in [(0, 0), (1, 1), (-1, 1), (2, 2), (3, 2), (4, 3),
                    (255, 8), (256, 9), (32767, 15), (-32767, 15)]:
        assert int(hf.categories(np.asarray([v]))[0]) == want, v


def test_dht_payload_roundtrip():
    payload = hf.dht_payload([(0, 0, hf.DC_LUMA), (1, 0, hf.AC_LUMA)])
    parsed = hf.parse_dht(payload)
    assert len(parsed) == 2
    (cls0, tid0, t0), (cls1, tid1, t1) = parsed
    assert (cls0, tid0) == (0, 0) and (cls1, tid1) == (1, 0)
    np.testing.assert_array_equal(t0.bits, hf.DC_LUMA.bits)
    np.testing.assert_array_equal(t1.values, hf.AC_LUMA.values)


def test_parse_dht_rejects_truncated():
    from go_dicom_codec_jax.errors import CorruptStreamError

    payload = hf.dht_payload([(0, 0, hf.DC_LUMA)])
    with pytest.raises(CorruptStreamError):
        hf.parse_dht(payload[:10])
