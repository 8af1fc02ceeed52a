"""Lossless JPEG (P14/SV1) predictor and geometry sweeps.

Role of reference jpeg/lossless/*_test.go beyond the basics already in
test_jpeg_lossless.py: every predictor × bit depth, point transforms,
odd geometry, first-row/first-column prediction edges, and SV1's
fixed-predictor contract.
"""

import numpy as np
import pytest

from go_dicom_codec_jax.codecs import jpeg_lossless as jl


def _roundtrip(img, bits, predictor=1):
    h, w = img.shape
    stream = jl.encode(np.ascontiguousarray(img).tobytes(), w, h, 1,
                       bits, predictor=predictor)
    px, rw, rh, rc, rbits = jl.decode(stream)
    dt = np.uint8 if bits <= 8 else "<u2"
    got = np.frombuffer(px, dtype=dt).reshape(h, w)
    np.testing.assert_array_equal(
        got.astype(np.int64), img.astype(np.int64))
    return stream


@pytest.mark.parametrize("predictor", [1, 2, 3, 4, 5, 6, 7])
@pytest.mark.parametrize("bits", [8, 12, 16])
def test_predictor_bitdepth_matrix(predictor, bits, rng):
    img = (np.cumsum(rng.integers(-9, 10, (48, 40)), axis=1)
           % (1 << bits)).astype(np.uint8 if bits <= 8 else "<u2")
    _roundtrip(img, bits, predictor=predictor)


@pytest.mark.parametrize("shape", [(1, 1), (1, 64), (64, 1), (3, 5),
                                   (63, 65), (17, 129)])
def test_odd_geometry(shape, rng):
    img = rng.integers(0, 4096, shape).astype("<u2")
    _roundtrip(img, 12, predictor=4)


def test_first_row_uses_predictor_b_fallback(rng):
    """Row 0 has no 'b' neighbor: T.81 H.1.2 falls back — a constant
    first row plus noisy remainder must stay bit-exact."""
    img = rng.integers(0, 65535, (32, 32)).astype("<u2")
    img[0, :] = 1234
    for p in range(1, 8):
        _roundtrip(img, 16, predictor=p)


def test_extreme_alternating_diffs():
    """Max-amplitude alternation drives category 16 and sign extremes."""
    img = np.zeros((16, 16), dtype="<u2")
    img[:, 1::2] = 65535
    for p in (1, 4, 7):
        _roundtrip(img, 16, predictor=p)


def test_auto_select_predictor_roundtrip(rng):
    """predictor=0 auto-selects by variance (encoder.go:80) and still
    reconstructs bit-exact."""
    img = (np.cumsum(rng.integers(-5, 6, (40, 40)), axis=1)
           % 4096).astype("<u2")
    _roundtrip(img, 12, predictor=0)


def test_sv1_registry_equals_p14_predictor1(rng):
    """SV1 is P14 restricted to predictor 1 (lossless14sv1/encoder.go):
    its registry streams decode through the shared P14 decoder."""
    import go_dicom_codec_jax as dc

    img = (np.cumsum(rng.integers(-5, 6, (40, 40)), axis=1)
           % 4096).astype("<u2")
    info = dc.FrameInfo(width=40, height=40, bits_allocated=16,
                        bits_stored=12)
    src_pd = dc.MemoryPixelData(info=info)
    src_pd.add_frame(img.tobytes())
    codec = dc.get_global_registry().get_codec(dc.uids.JPEG_LOSSLESS_SV1)
    enc = dc.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src_pd, enc)
    px, w, h, c, bits = jl.decode(enc.get_frame(0))
    got = np.frombuffer(px, "<u2").reshape(40, 40)
    np.testing.assert_array_equal(got, img)


def test_predictor_selection_changes_ratio(rng):
    """A horizontal gradient has identical rows, so Rb (predictor 2)
    predicts perfectly; a vertical gradient has identical columns, so
    Ra (predictor 1) does (T.81 H.1.2 predictor table)."""
    y, x = np.mgrid[0:64, 0:64]
    horiz = (x * 64 % 4096).astype("<u2")
    s1 = _roundtrip(horiz, 12, predictor=1)
    s2 = _roundtrip(horiz, 12, predictor=2)
    assert len(s2) < len(s1)
    vert = (y * 64 % 4096).astype("<u2")
    s1v = _roundtrip(vert, 12, predictor=1)
    s2v = _roundtrip(vert, 12, predictor=2)
    assert len(s1v) < len(s2v)


def test_gray8_all_predictors_small(rng):
    img = rng.integers(0, 256, (8, 8)).astype(np.uint8)
    streams = {p: _roundtrip(img, 8, predictor=p) for p in range(1, 8)}
    assert len({s for s in streams.values()}) > 1  # predictors differ
