"""HTJ2K interop against OpenJPH-generated golden codestreams.

The fixtures under test-data/htj2k_interop/ were generated offline by
fo-dicom.Codecs 5.16.5.1 (OpenJPH native encoder) from raw sample data
(shipped by the reference at test-data/htj2k/interop with
manifest.json). Decoding them bit-exact validates the full HT chain —
codestream parse → CAP → packet headers → MEL/VLC/MagSgn cleanup
decode → DWT inverse — against an independent implementation.
"""

import json
import os

import numpy as np
import pytest

from go_dicom_codec_jax.codecs.jpeg2000 import J2KDecoder

BASE = os.path.join(os.path.dirname(__file__), "..", "test-data",
                    "htj2k_interop")


def _fixtures():
    with open(os.path.join(BASE, "manifest.json")) as f:
        man = json.load(f)
    out = []
    for fx in man["fixtures"]:
        for key in fx["codestreams"]:
            out.append((fx["name"], key))
    return out


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(BASE, "manifest.json")) as f:
        return {fx["name"]: fx for fx in json.load(f)["fixtures"]}


@pytest.mark.parametrize("name,key", _fixtures())
def test_openjph_golden_decode(name, key, manifest):
    fx = manifest[name]
    w, h, nc = fx["width"], fx["height"], fx["components"]
    ba = fx["bitsAllocated"]
    dt = np.uint8 if ba == 8 else (np.dtype("<i2") if fx["signed"]
                                   else np.dtype("<u2"))
    with open(os.path.join(BASE, fx["inputRaw"]), "rb") as f:
        ref = np.frombuffer(f.read(), dtype=dt).reshape(h, w, nc)
    with open(os.path.join(BASE, fx["codestreams"][key]["path"].replace(
            "/", os.sep)), "rb") as f:
        data = f.read()
    arr, siz, cod = J2KDecoder().decode(data)
    assert arr.shape == (h, w, nc)
    np.testing.assert_array_equal(arr.astype(np.int64),
                                  ref.astype(np.int64))
