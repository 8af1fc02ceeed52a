"""JP2/JPH container write + file transcoding (round-5 surface).

Beyond the reference (it transports raw codestreams only): wrap
encodes in ISO 15444-1/-15 file containers that PIL/OpenJPEG and
OpenJPH tooling read directly, decode them transparently, and drive
the any-to-any transcoder across a lossless chain.
"""

import io
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder, J2KEncodeParams,
                                                J2KEncoder)
from go_dicom_codec_jax.codestream import j2k
from go_dicom_codec_jax.tools import transcode as tc


def main():
    rng = np.random.default_rng(6)
    img = np.cumsum(rng.integers(-9, 10, (256, 256)), axis=1)
    img = (img % 4000 + 48).astype(np.int32)

    # 1. JP2 container write: the encoder emits a complete .jp2 file
    jp2 = J2KEncoder(J2KEncodeParams(container="jp2")).encode(
        img, 256, 256, 1, 12)
    assert jp2.startswith(j2k._JP2_SIGNATURE)
    # decode unwraps transparently
    out = np.squeeze(J2KDecoder().decode(jp2)[0])
    assert np.array_equal(out, img)
    print(f"JP2 file: {len(jp2)} bytes, decodes bit-exact")

    # 2. JPH (HTJ2K Part-15 file) with SigProp/MagRef refinement
    jph = J2KEncoder(J2KEncodeParams(
        htj2k=True, ht_refinement=True, container="jph")).encode(
        img, 256, 256, 1, 12)
    out = np.squeeze(J2KDecoder().decode(jph)[0])
    assert np.array_equal(out, img)
    print(f"JPH file (refined HT): {len(jph)} bytes, decodes bit-exact")

    # 3. foreign check: PIL/OpenJPEG reads the .jp2 file directly
    try:
        from PIL import Image
        pil = np.array(Image.open(io.BytesIO(jp2))).astype(np.int64) >> 4
        assert np.array_equal(pil, img)
        print("PIL/OpenJPEG decodes the JP2 file bit-exact")
    except ImportError:
        print("PIL unavailable — foreign check skipped")

    # 4. transcode chain: npy -> JPEG-LS -> HTJ2K(.jph) -> P14 -> npy
    with tempfile.TemporaryDirectory() as d:
        def p(name):
            return os.path.join(d, name)
        buf = io.BytesIO()
        np.save(buf, img.astype(np.uint16))
        with open(p("in.npy"), "wb") as f:
            f.write(buf.getvalue())
        tc.main([p("in.npy"), p("a.jls"), "--to", "jls", "--bits", "12"])
        tc.main([p("a.jls"), p("b.jph"), "--to", "htj2k",
                 "--container", "jph"])
        tc.main([p("b.jph"), p("c.jpg"), "--to", "p14"])
        tc.main([p("c.jpg"), p("out.npy"), "--to", "npy"])
        back = np.load(p("out.npy"))
        assert np.array_equal(back, img.astype(np.uint16))
        print("transcode chain npy->JLS->JPH->P14->npy: bit-exact")


if __name__ == "__main__":
    main()
