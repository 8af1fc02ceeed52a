"""TERMALL / layered-encode interaction sweeps.

Role of reference jpeg2000/termall_{hypothesis,e2e,single_layer}_test.go
and t1/termall_*_test.go: the per-pass-terminated code-block style must
stay losslessly decodable in every combination with layering, LAZY
bypass, levels, and geometry (the reference kept a 'hypothesis' test
because this interaction once corrupted streams).
"""

import numpy as np
import pytest

from go_dicom_codec_jax.codecs.jpeg2000 import (J2KEncodeParams,
                                                J2KEncoder,
                                                decode_to_pixels)
from go_dicom_codec_jax.entropy.ebcot import (STYLE_LAZY, STYLE_RESET,
                                              STYLE_SEGSYM, STYLE_TERMALL,
                                              STYLE_VSC)


def _roundtrip(img, bits, params):
    h, w = img.shape
    enc = J2KEncoder(params)
    stream = enc.encode(img.astype("<u2" if bits > 8 else np.uint8),
                        w, h, 1, bits)
    raw, rw, rh, c, depth, signed = decode_to_pixels(stream)
    dt = "<u2" if depth > 8 else np.uint8
    got = np.frombuffer(raw, dtype=dt).reshape(h, w)
    np.testing.assert_array_equal(got.astype(np.int64),
                                  img.astype(np.int64))
    return stream


@pytest.mark.parametrize("layers", [1, 2, 3])
def test_termall_layered_lossless(layers, rng):
    """The reference's TERMALL-hypothesis scenario: layered encodes with
    per-pass termination decode bit-exact (termall_hypothesis_test.go)."""
    img = rng.integers(0, 256, (8, 8)).astype(np.int64)
    _roundtrip(img, 8, J2KEncodeParams(num_levels=2, num_layers=layers,
                                       cb_style=STYLE_TERMALL))


@pytest.mark.parametrize("style", [
    STYLE_TERMALL,
    STYLE_TERMALL | STYLE_LAZY,
    STYLE_TERMALL | STYLE_RESET,
    STYLE_TERMALL | STYLE_SEGSYM,
    STYLE_TERMALL | STYLE_VSC,
    STYLE_TERMALL | STYLE_LAZY | STYLE_RESET,
])
def test_termall_style_combinations(style, rng):
    img = rng.integers(0, 4096, (32, 24)).astype(np.int64)
    _roundtrip(img, 12, J2KEncodeParams(num_levels=2, cb_style=style))


@pytest.mark.parametrize("size", [(8, 8), (16, 16), (33, 17), (64, 64),
                                  (65, 63)])
def test_termall_size_sweep(size, rng):
    h, w = size
    img = rng.integers(0, 4096, (h, w)).astype(np.int64)
    _roundtrip(img, 12, J2KEncodeParams(num_levels=2,
                                        cb_style=STYLE_TERMALL))


@pytest.mark.parametrize("layers", [2, 4])
def test_termall_layered_multilevel(layers, rng):
    img = rng.integers(0, 4096, (64, 64)).astype(np.int64)
    _roundtrip(img, 12, J2KEncodeParams(num_levels=3, num_layers=layers,
                                        cb_style=STYLE_TERMALL))


def test_termall_layered_lazy_dense(rng):
    """Dense noise maximizes pass count — the worst case for per-pass
    termination bookkeeping with bypass segments."""
    img = rng.integers(0, 65536, (40, 40)).astype(np.int64)
    _roundtrip(img, 16, J2KEncodeParams(
        num_levels=2, num_layers=3, cb_style=STYLE_TERMALL | STYLE_LAZY))


def test_termall_small_codeblocks(rng):
    img = rng.integers(0, 4096, (48, 48)).astype(np.int64)
    _roundtrip(img, 12, J2KEncodeParams(num_levels=2, cb_width=16,
                                        cb_height=16,
                                        cb_style=STYLE_TERMALL))


def test_termall_gradient_image():
    """The reference's exact hypothesis input (8×8 ramp, 2 levels,
    NumLayers 1 vs 2) — both must be error-free here."""
    img = (np.arange(64) % 256).reshape(8, 8).astype(np.int64)
    s1 = _roundtrip(img, 8, J2KEncodeParams(num_levels=2, num_layers=1))
    s2 = _roundtrip(img, 8, J2KEncodeParams(num_levels=2, num_layers=2,
                                            cb_style=STYLE_TERMALL))
    assert s1 != s2  # layering + TERMALL genuinely changes the stream


def test_termall_pass_lengths_parse(rng):
    """TERMALL streams decode under the strict parser (exact per-pass
    lengths in packet headers)."""
    from go_dicom_codec_jax.codecs.jpeg2000 import J2KDecoder

    img = rng.integers(0, 4096, (32, 32)).astype(np.int64)
    stream = J2KEncoder(J2KEncodeParams(
        num_levels=2, cb_style=STYLE_TERMALL)).encode(
            img.astype("<u2"), 32, 32, 1, 12)
    arr, siz, cod = J2KDecoder(resilient=False).decode(stream)
    np.testing.assert_array_equal(arr[:, :, 0].astype(np.int64), img)
