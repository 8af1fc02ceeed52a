"""Parameter-object contract tests.

Role of reference */parameters_test.go files (every codec package has
one): string-keyed GetParameter/SetParameter semantics, fluent With*
builders returning copies, Validate errors, and the typed parameter
classes' defaults.
"""

import pytest

from go_dicom_codec_jax.errors import InvalidParameterError
from go_dicom_codec_jax.params import (Parameters, optional_int,
                                       require_range)


def test_get_set_roundtrip():
    p = Parameters(quality=80)
    assert p.get_parameter("quality") == 80
    p.set_parameter("quality", 95)
    assert p.get_parameter("quality") == 95


def test_get_default_for_missing():
    p = Parameters()
    assert p.get_parameter("nope") is None
    assert p.get_parameter("nope", 7) == 7


def test_contains_and_iter():
    p = Parameters(a=1, b=2)
    assert "a" in p and "c" not in p
    assert sorted(p) == ["a", "b"]


def test_with_returns_copy():
    p = Parameters(quality=80)
    q = p.with_("quality", 10)
    assert p.get_parameter("quality") == 80
    assert q.get_parameter("quality") == 10


def test_copy_is_independent():
    p = Parameters(x=1)
    c = p.copy()
    c.set_parameter("x", 2)
    assert p.get_parameter("x") == 1


def test_require_range_accepts_bounds():
    assert require_range("q", 1, 1, 100) == 1
    assert require_range("q", 100, 1, 100) == 100


def test_require_range_rejects_out_of_bounds():
    with pytest.raises(InvalidParameterError):
        require_range("q", 0, 1, 100)
    with pytest.raises(InvalidParameterError):
        require_range("q", 101, 1, 100)


def test_optional_int_coercion():
    p = Parameters(n=5)
    assert optional_int(p, "n", 9) == 5
    assert optional_int(p, "missing", 9) == 9
    assert optional_int(None, "n", 9) == 9


def test_baseline_parameters_validate():
    from go_dicom_codec_jax.codecs.jpeg_baseline import \
        JPEGBaselineParameters

    JPEGBaselineParameters(quality=50).validate()
    with pytest.raises(InvalidParameterError):
        JPEGBaselineParameters(quality=0).validate()
    assert JPEGBaselineParameters().with_quality(33).quality == 33


def test_j2k_params_fluent_and_clamp():
    from go_dicom_codec_jax.codecs.jpeg2000 import J2KEncodeParams

    p = J2KEncodeParams(num_levels=5)
    # small images clamp levels like reference lossy/codec.go:392
    assert p.clamped_levels(8, 8) < 5
    assert p.clamped_levels(512, 512) == 5


def test_jls_near_parameter():
    from go_dicom_codec_jax.codecs.jpegls import JPEGLSParameters

    p = JPEGLSParameters(near=3)
    assert p.get_parameter("near") == 3
    p.validate()


def test_jls_near_parameter_surface():
    """nearlossless/parameters_test.go: WithNEAR fluency, validation
    bounds, type safety through the string-keyed Parameters surface,
    and custom parameter passthrough."""
    import pytest

    from go_dicom_codec_jax.codecs.jpegls import JPEGLSParameters

    p = JPEGLSParameters()
    assert p.near == 0            # default is lossless
    p2 = p.with_near(7)
    assert p2.near == 7 and p.near == 0   # fluent copy, not mutation
    p2.validate()
    with pytest.raises(Exception):
        JPEGLSParameters(near=-1).validate()
    with pytest.raises(Exception):
        JPEGLSParameters(near=256).validate()
    # custom string-keyed parameters ride along untouched
    p3 = p2.with_("myext", "abc")
    assert p3.get_parameter("myext") == "abc" and p3.near == 7


def test_jls_lossless_uid_forces_near_zero(rng=None):
    """nearlossless vs lossless codec split: the lossless UID ignores a
    stray NEAR>0 parameter (reference keeps separate packages; here one
    base class guards it — jpegls.py _JPEGLSBase)."""
    import numpy as np

    import go_dicom_codec_jax as dc
    from go_dicom_codec_jax.codecs.jpegls import JPEGLSParameters

    img = (np.arange(32 * 32, dtype=np.uint8) % 251).reshape(32, 32)
    info = dc.FrameInfo(width=32, height=32, bits_allocated=8,
                        bits_stored=8)
    src = dc.MemoryPixelData(info=info)
    src.add_frame(img.tobytes())
    codec = dc.get_global_registry().get_codec(dc.uids.JPEG_LS_LOSSLESS)
    enc = dc.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc, JPEGLSParameters(near=5))
    dec = dc.MemoryPixelData(info=info)
    codec.decode(enc, dec)
    assert dec.get_frame(0) == src.get_frame(0)  # still bit-exact
