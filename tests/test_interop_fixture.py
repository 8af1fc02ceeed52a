"""Foreign-encoder interop: decode a real Kakadu clinical codestream.

test-data/ct1_kakadu.j2c is the raw JPEG 2000 codestream extracted from
the reference's CT1_J2KI DICOM fixture (reference test-data/CT1_J2KI),
produced by Kakadu 2.2 (COM marker): 512×512, 16-bit signed, 9/7 lossy,
5 levels, LRCP, single tile, scalar-expounded quantization.

The decode is pinned by checksum — the role of the reference's
byte-parity HTJ2K interop manifest (htj2k/interop_fixture_test.go) for
the classic-J2K path: any regression in codestream parsing, T2, T1/MQ,
dequantization, or the 9/7 inverse changes these pixels.
"""

import hashlib
import os

import numpy as np
import pytest

from go_dicom_codec_jax.codecs.jpeg2000 import J2KDecoder

FIXTURE = os.path.join(os.path.dirname(__file__), "..", "test-data",
                       "ct1_kakadu.j2c")

# Round 3: the 9/7 inverse gained a native host fast path (float32,
# same lifting as XLA but not bit-pinned — a few pixels differ by 1 LSB
# at the int-round boundary). Both reconstructions are pinned; the
# PIL/OpenJPEG crosscheck below bounds either against an independent
# decoder. (Round-2 note: the jit sha itself was re-pinned when the
# 9/7 moved under jit.)
PINNED_SHA256 = {
    # native host 9/7 (default when the toolchain is available)
    "34c23b3228e63944c0a4f041b8447c07f91b94bebc88aea0daa4f137d3bd4db4",
    # XLA jit 9/7 (GDCT_DISABLE_NATIVE / no toolchain)
    "fe204919a6d84ffa01540d5b09c70a3b700dddc24dd14bc1b91339b90f30e85c",
}


@pytest.fixture(scope="module")
def decoded():
    data = open(FIXTURE, "rb").read()
    arr, siz, cod = J2KDecoder().decode(data)
    return arr[:, :, 0], siz, cod


def test_kakadu_header(decoded):
    _, siz, cod = decoded
    assert (siz.xsiz, siz.ysiz) == (512, 512)
    assert siz.components[0] == (16, True, 1, 1)  # 16-bit signed
    assert cod.num_levels == 5 and cod.transform == 0  # 9/7 lossy
    assert cod.progression == 0  # LRCP


def test_kakadu_decode_pinned(decoded):
    a, _, _ = decoded
    assert a.shape == (512, 512)
    # plausible CT (Hounsfield-like) dynamic range
    assert -3000 < a.min() < -1000 and 1000 < a.max() < 4000
    # real anatomy: strong spatial coherence
    af = a.astype(float)
    corr = np.corrcoef(af[:, :-1].ravel(), af[:, 1:].ravel())[0, 1]
    assert corr > 0.97
    # pinned pixel checksum
    sha = hashlib.sha256(a.astype("<i4").tobytes()).hexdigest()
    if sha not in PINNED_SHA256:
        # the native 9/7 is scalar float32 built with -march=native, so
        # FMA contraction can flip last-ulp results on other hosts; an
        # unknown checksum must still agree with the jit reconstruction
        # to 1 LSB on a vanishing fraction of pixels (round-3 review)
        import os
        import subprocess
        import sys

        env = dict(os.environ, GDCT_DISABLE_NATIVE="1",
                   JAX_PLATFORMS="cpu")
        code = (
            "import sys, numpy as np\n"
            "from go_dicom_codec_jax.codecs.jpeg2000 import J2KDecoder\n"
            f"arr, _, _ = J2KDecoder().decode(open({FIXTURE!r},"
            " 'rb').read())\n"
            "sys.stdout.buffer.write(arr[:, :, 0].astype('<i4')"
            ".tobytes())\n")
        out = subprocess.run([sys.executable, "-c", code], env=env,
                             capture_output=True, timeout=600,
                             cwd=os.path.dirname(os.path.dirname(
                                 os.path.abspath(__file__))))
        assert out.returncode == 0, out.stderr[-2000:]
        jit_ref = np.frombuffer(out.stdout, "<i4").reshape(512, 512)
        diff = np.abs(a.astype(np.int64) - jit_ref.astype(np.int64))
        assert diff.max() <= 1
        assert (diff != 0).mean() < 1e-2


def test_kakadu_resilient_truncation(decoded):
    """Truncated foreign stream decodes partially in resilient mode."""
    data = open(FIXTURE, "rb").read()
    arr, _, _ = J2KDecoder(resilient=True).decode(data[: len(data) // 2])
    full = decoded[0].astype(float)
    part = arr[:, :, 0].astype(float)
    # coarse image recovered: still strongly correlated with the full one
    assert np.corrcoef(part.ravel(), full.ravel())[0, 1] > 0.8


def test_kakadu_foreign_crosscheck(decoded):
    """Our decode of the Kakadu stream agrees with PIL's OpenJPEG within
    lossy-decoder rounding — an external anchor, so the pinned checksum
    above can never drift into plausible-but-wrong territory."""
    PIL_Image = pytest.importorskip("PIL.Image")
    import io

    a, _, _ = decoded
    pil = np.asarray(PIL_Image.open(io.BytesIO(open(FIXTURE, "rb").read())))
    # PIL represents signed 16-bit samples offset into uint16
    pil = pil.reshape(a.shape).astype(np.int64) - (1 << 15)
    assert np.abs(pil - a.astype(np.int64)).max() <= 2
