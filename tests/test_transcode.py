"""tools/transcode — file-level any-to-any transcoding CLI.

Beyond the reference's cmd/ surface (interop validator + benchmarks
only). Lossless chains must be bit-exact end to end; sniffing must
recognize every family from magic bytes alone.
"""

import io
import json

import numpy as np
import pytest

from go_dicom_codec_jax.tools import transcode as tc


def _img(bits=8, h=40, w=56, comps=1, seed=5):
    rng = np.random.default_rng(seed)
    a = np.cumsum(rng.integers(-5, 6, (h, w, comps)), axis=1)
    a = (a % ((1 << bits) - 8) + 4)
    dt = np.uint8 if bits <= 8 else np.dtype("<u2")
    return np.squeeze(a.astype(dt))


def _npy_bytes(arr):
    buf = io.BytesIO()
    np.save(buf, arr)
    return buf.getvalue()


def test_sniff_all_families():
    img = _img()
    px = img.tobytes()
    from go_dicom_codec_jax.codecs import (jpeg_baseline, jpeg_extended,
                                           jpeg_lossless, jpegls, rle)
    from go_dicom_codec_jax.codecs.jpeg2000 import (J2KEncodeParams,
                                                    J2KEncoder)
    h, w = img.shape
    assert tc.sniff(jpeg_baseline.encode(px, w, h, 1, 90)) == "jpeg-dct"
    assert tc.sniff(jpeg_lossless.encode(px, w, h, 1, 8)) == "jpeg-lossless"
    assert tc.sniff(jpegls.encode(px, w, h, 1, 8)) == "jpeg-ls"
    img12 = _img(12)
    assert tc.sniff(jpeg_extended.encode(img12.tobytes(), w, h, 1, 12)) \
        == "jpeg-extended"
    cs = J2KEncoder(J2KEncodeParams()).encode(img.astype(np.int32), w, h,
                                              1, 8)
    assert tc.sniff(cs) == "j2k"
    from go_dicom_codec_jax.codestream import j2k
    assert tc.sniff(j2k.wrap_jp2(cs)) == "j2k"
    assert tc.sniff(rle.encode_frame(px, tc._frame_info(w, h, 1, 8))) \
        == "rle"
    assert tc.sniff(_npy_bytes(img)) == "npy"
    assert tc.sniff(b"\x00" * 80) == "raw"


@pytest.mark.parametrize("chain", [
    ["jls", "j2k", "p14", "rle", "npy"],
    ["sv1", "htj2k", "jls-near", "npy"],  # near=0 forced below for exactness
])
def test_lossless_chain_bit_exact(tmp_path, chain):
    img = _img(12, seed=9)
    cur = tmp_path / "in.npy"
    cur.write_bytes(_npy_bytes(img))
    for i, target in enumerate(chain):
        nxt = tmp_path / f"step{i}.{target}"
        argv = [str(cur), str(nxt), "--to", target, "--near", "0"]
        if cur.suffix == ".rle":  # RLE carries no geometry of its own
            argv += ["--width", str(img.shape[1]),
                     "--height", str(img.shape[0]), "--bits", "16"]
        assert tc.main(argv) == 0
        cur = nxt
    out = np.load(io.BytesIO(cur.read_bytes()))
    np.testing.assert_array_equal(out, img)


def test_rle_input_needs_geometry(tmp_path):
    img = _img(8)
    from go_dicom_codec_jax.codecs import rle
    h, w = img.shape
    enc = rle.encode_frame(img.tobytes(), tc._frame_info(w, h, 1, 8))
    src = tmp_path / "in.rle"
    src.write_bytes(enc)
    dst = tmp_path / "out.npy"
    with pytest.raises(ValueError):
        tc.main([str(src), str(dst), "--to", "npy"])
    assert tc.main([str(src), str(dst), "--to", "npy", "--width", str(w),
                    "--height", str(h), "--bits", "8"]) == 0
    np.testing.assert_array_equal(np.load(io.BytesIO(dst.read_bytes())), img)


def test_container_output_and_uid_target(tmp_path, capsys):
    img = _img(8)
    src = tmp_path / "in.npy"
    src.write_bytes(_npy_bytes(img))
    dst = tmp_path / "out.jph"
    assert tc.main([str(src), str(dst), "--to", "1.2.840.10008.1.2.4.201",
                    "--container", "jph"]) == 0
    line = [ln for ln in capsys.readouterr().out.splitlines()
            if ln.startswith("TRANSCODE|")][-1]
    meta = json.loads(line.split("|", 1)[1])
    assert meta["from"] == "npy" and meta["bit_depth"] == 8
    data = dst.read_bytes()
    assert data.startswith(tc._jp2_magic())
    # transparent re-decode of the wrapped file back to npy
    back = tmp_path / "back.npy"
    assert tc.main([str(dst), str(back), "--to", "npy"]) == 0
    np.testing.assert_array_equal(np.load(io.BytesIO(back.read_bytes())),
                                  img)


def test_container_rejected_for_non_j2k(tmp_path):
    src = tmp_path / "in.npy"
    src.write_bytes(_npy_bytes(_img(8)))
    with pytest.raises(ValueError):
        tc.main([str(src), str(tmp_path / "o.jls"), "--to", "jls",
                 "--container", "jp2"])


def test_from_override_rescues_rle_lookalike_raw(tmp_path):
    # raw 16-bit samples whose first bytes mimic an RLE header
    img = _img(12, h=16, w=16, seed=1).astype("<u2")
    img.flat[0], img.flat[1] = 5, 0  # u32le 5 => sniffed as "rle"
    src = tmp_path / "in.raw"
    src.write_bytes(img.tobytes())
    assert tc.sniff(img.tobytes()) == "rle"
    dst = tmp_path / "out.npy"
    assert tc.main([str(src), str(dst), "--to", "npy", "--from", "raw",
                    "--width", "16", "--height", "16", "--bits", "12"]) == 0
    got = np.load(io.BytesIO(dst.read_bytes()))
    np.testing.assert_array_equal(got, img.astype(np.uint16))


def test_depth_guards_for_dct_targets(tmp_path):
    src = tmp_path / "in.npy"
    src.write_bytes(_npy_bytes(_img(12)))
    with pytest.raises(ValueError, match="8-bit"):
        tc.main([str(src), str(tmp_path / "o.jpg"), "--to", "baseline",
                 "--bits", "12"])
    src16 = tmp_path / "in16.npy"
    src16.write_bytes(_npy_bytes(_img(16)))
    with pytest.raises(ValueError, match="12-bit"):
        tc.main([str(src16), str(tmp_path / "o.jpg"), "--to", "extended"])


def test_signed_input_rides_container_width(tmp_path):
    # signed samples travel as raw two's-complement container bytes at
    # 16-bit width through the unsigned JPEG-family coders (reference
    # adapters' signed policy) — byte-exact roundtrip
    img = (_img(12, seed=8).astype(np.int64) - 2048).astype("<i2")
    src = tmp_path / "in.raw"
    src.write_bytes(img.tobytes())
    mid = tmp_path / "m.jls"
    assert tc.main([str(src), str(mid), "--to", "jls", "--from", "raw",
                    "--signed", "--width", str(img.shape[1]),
                    "--height", str(img.shape[0]), "--bits", "12"]) == 0
    out = tmp_path / "o.raw"
    assert tc.main([str(mid), str(out), "--to", "raw"]) == 0
    assert out.read_bytes() == img.tobytes()


def test_lossy_roundtrip_close(tmp_path):
    img = _img(8, seed=2)
    src = tmp_path / "in.npy"
    src.write_bytes(_npy_bytes(img))
    mid = tmp_path / "m.jpg"
    assert tc.main([str(src), str(mid), "--to", "baseline",
                    "--quality", "95"]) == 0
    out = tmp_path / "o.npy"
    assert tc.main([str(mid), str(out), "--to", "npy"]) == 0
    got = np.load(io.BytesIO(out.read_bytes()))
    assert np.abs(got.astype(int) - img.astype(int)).max() <= 24
