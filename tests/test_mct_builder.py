"""MCTBindingBuilder (reference mct_builder.go fluent API)."""

import numpy as np
import pytest

from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder, J2KEncodeParams,
                                                J2KEncoder)
from go_dicom_codec_jax.codecs.mct_builder import MCTBindingBuilder


def test_builder_derives_inverse():
    m = [[2.0, 0.0], [1.0, 1.0]]
    b = MCTBindingBuilder().components([0, 1]).matrix(m).build()
    got = np.asarray(b.inverse) @ np.asarray(m)
    np.testing.assert_allclose(got, np.eye(2), atol=1e-12)


def test_builder_validates():
    with pytest.raises(ValueError):
        MCTBindingBuilder().matrix([[1.0, 2.0]]).build()  # not square
    with pytest.raises(ValueError):
        MCTBindingBuilder().components([0]).matrix(
            [[1.0, 0.0], [0.0, 1.0]]).build()  # comp count mismatch


def test_builder_apply_to_encode_roundtrip(rng):
    rgb = rng.integers(0, 256, size=(64, 64, 3)).astype(np.uint8)
    params = J2KEncodeParams(num_levels=2, lossless=False, quality=85)
    (MCTBindingBuilder()
        .components([0, 1, 2])
        .matrix([[0.5, 0.25, 0.25], [-0.5, 0.5, 0.0], [0.0, -0.5, 0.5]])
        .offsets([0.0, 0.0, 0.0])
        .apply_to(params))
    assert params.mct_inverse is not None
    data = J2KEncoder(params).encode(rgb.tobytes(), 64, 64, 3, 8)
    arr, _, _ = J2KDecoder().decode(data)
    err = np.abs(arr.astype(float) - rgb.astype(float)).mean()
    assert err < 2.0
