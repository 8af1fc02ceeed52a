"""Truncation-sweep worker shared by tests/test_native.py.

Decodes every sampled truncation of a codestream and records the
outcome (pixel hash | exception class). Runs in-process for the
native lane and as a GDCT_DISABLE_NATIVE=1 subprocess for the Python
lane — the two outcome lists must be identical (the native mirrors
must fail exactly where the Python reference implementations fail;
see the br.align() regression in native/ebcot_native.cpp).
"""
import hashlib
import json
import sys


def decode_outcome(kind, data):
    try:
        if kind == "jpegls":
            from go_dicom_codec_jax.codecs import jpegls
            payload = jpegls.decode(data)[0]
        elif kind == "baseline":
            from go_dicom_codec_jax.codecs import jpeg_baseline
            payload = jpeg_baseline.decode(data)[0]
        elif kind == "extended":
            from go_dicom_codec_jax.codecs import jpeg_extended
            payload = jpeg_extended.decode(data)[0]
        elif kind == "p14":
            from go_dicom_codec_jax.codecs import jpeg_lossless
            payload = jpeg_lossless.decode(data)[0]
        elif kind == "htj2k":
            from go_dicom_codec_jax.codecs.jpeg2000 import J2KDecoder
            payload = J2KDecoder().decode(data)[0].tobytes()
        else:
            raise ValueError(kind)
        if not isinstance(payload, (bytes, bytearray)):
            payload = bytes(payload)
        return ("ok", hashlib.sha1(payload).hexdigest())
    except Exception as e:  # noqa: BLE001
        return ("err", type(e).__name__)


def sweep(kind, stream, step):
    out = []
    for ln in range(2, len(stream)):
        # all truncations ending in 0xFF (stuffing/align-sensitive)
        # plus every `step`-th other position
        if stream[ln - 1] != 0xFF and ln % step:
            continue
        out.append([ln, *decode_outcome(kind, stream[:ln])])
    return out


def main():
    import jax
    jax.config.update("jax_platforms", "cpu")
    kind, path, step = sys.argv[1], sys.argv[2], int(sys.argv[3])
    with open(path, "rb") as f:
        data = f.read()
    print(json.dumps(sweep(kind, data, step)))


if __name__ == "__main__":
    main()
