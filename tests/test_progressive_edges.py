"""Progressive (SOF2) decoder edge cases beyond the PIL oracle matrix."""

import io

import numpy as np
import pytest

from go_dicom_codec_jax.codecs import jpeg_progressive as jp
from go_dicom_codec_jax.errors import (CorruptStreamError,
                                       UnsupportedFormatError)

PIL_Image = pytest.importorskip("PIL.Image")


def _prog_stream(img, **kw):
    buf = io.BytesIO()
    kw.setdefault("quality", 90)
    PIL_Image.fromarray(img).save(buf, format="JPEG", progressive=True,
                                  **kw)
    return buf.getvalue()


def test_truncated_progressive_raises(rng):
    img = (rng.integers(0, 255, (32, 32))).astype(np.uint8)
    data = _prog_stream(img)
    with pytest.raises((CorruptStreamError, UnsupportedFormatError)):
        jp.decode(data[: len(data) // 3])


def test_progressive_missing_eoi_still_fails_cleanly(rng):
    img = (rng.integers(0, 255, (32, 32))).astype(np.uint8)
    data = _prog_stream(img)
    # chop the EOI marker: the marker loop must not run off the end
    assert data.endswith(b"\xff\xd9")
    with pytest.raises((CorruptStreamError, UnsupportedFormatError)):
        jp.decode(data[:-2] + b"\x00\x00")


def test_progressive_flat_image(rng):
    """DC-dominated content: AC scans are nearly all EOB runs."""
    img = np.full((40, 40), 128, dtype=np.uint8)
    data = _prog_stream(img)
    px, w, h, c = jp.decode(data)
    got = np.frombuffer(px, np.uint8).reshape(40, 40)
    assert np.abs(got.astype(int) - 128).max() <= 1


def test_progressive_sharp_edges(rng):
    """High-frequency content maximizes AC refinement activity."""
    img = np.zeros((48, 48), dtype=np.uint8)
    img[:, ::2] = 255
    data = _prog_stream(img, quality=95)
    px, w, h, c = jp.decode(data)
    theirs = np.asarray(PIL_Image.open(io.BytesIO(data)))
    got = np.frombuffer(px, np.uint8).reshape(48, 48)
    assert np.abs(got.astype(int) - theirs.astype(int)).max() <= 1


def test_sequential_stream_rejected_by_progressive_decoder(rng):
    img = (rng.integers(0, 255, (16, 16))).astype(np.uint8)
    buf = io.BytesIO()
    PIL_Image.fromarray(img).save(buf, format="JPEG", quality=90)
    with pytest.raises((CorruptStreamError, UnsupportedFormatError)):
        jp.decode(buf.getvalue())


def test_progressive_tiny_image():
    img = np.asarray([[10, 250], [128, 60]], dtype=np.uint8)
    data = _prog_stream(img)
    px, w, h, c = jp.decode(data)
    theirs = np.asarray(PIL_Image.open(io.BytesIO(data)))
    got = np.frombuffer(px, np.uint8).reshape(2, 2)
    assert np.abs(got.astype(int) - theirs.astype(int)).max() <= 1
