"""Foreign-decoder oracle: decode THIS repo's encoded streams with PIL.

Role of the reference's external fo-dicom oracle
(/root/reference/cmd/dicom-interop-validation/main.go:568): an encoder
regression that produces non-conformant-but-self-decodable streams must
fail loudly. PIL in this environment wraps libjpeg (JPEG baseline) and
OpenJPEG (J2K + HTJ2K), i.e. genuinely foreign implementations.

PIL quirks pinned here:
  - OpenJPEG-via-PIL left-shifts N-bit precision into 16-bit containers
    (12-bit J2K comes back as value << 4) — undone before comparison.
  - libjpeg is an 8-bit build: 12-bit Extended (SOF1) is not decodable
    by PIL and stays covered by golden fixtures + self-decode.
"""

import io

import numpy as np
import pytest

import go_dicom_codec_jax as dc

PIL_Image = pytest.importorskip("PIL.Image")

UID_BASELINE = "1.2.840.10008.1.2.4.50"
UID_J2K_LL = "1.2.840.10008.1.2.4.90"
UID_J2K_LOSSY = "1.2.840.10008.1.2.4.91"
UID_J2K_MC_LL = "1.2.840.10008.1.2.4.92"
UID_HT_LL = "1.2.840.10008.1.2.4.201"
UID_HT_RPCL = "1.2.840.10008.1.2.4.202"
UID_HT = "1.2.840.10008.1.2.4.203"


def _smooth(rng, h, w, samples, bits):
    """CT-like smooth content so lossy paths meet tight tolerances."""
    img = np.cumsum(rng.integers(-5, 6, (h, w, samples)), axis=1)
    img = img % max((1 << bits) - 64, 64) + 16
    dt = np.uint8 if bits <= 8 else np.dtype("<u2")
    arr = img.astype(dt)
    return arr[..., 0] if samples == 1 else arr


def _encode(uid, img, bits, samples, params=None):
    """Encode img through the public codec registry; return (stream, mine)."""
    h, w = img.shape[:2]
    info = dc.FrameInfo(
        width=w, height=h, bits_allocated=8 if bits <= 8 else 16,
        bits_stored=bits, samples_per_pixel=samples,
        photometric_interpretation="RGB" if samples == 3 else "MONOCHROME2")
    src = dc.MemoryPixelData(info=info)
    src.add_frame(np.ascontiguousarray(img).tobytes())
    codec = dc.get_global_registry().get_codec(uid)
    enc = dc.MemoryPixelData(info=info, encapsulated=True)
    p = dc.Parameters(**(params or {}))
    codec.encode(src, enc, p)
    dec = dc.MemoryPixelData(info=info)
    codec.decode(enc, dec)
    mine = np.frombuffer(dec.get_frame(0), dtype=img.dtype).reshape(img.shape)
    return enc.get_frame(0), mine


def _pil_decode(stream, shape, bits):
    """Foreign decode; undo PIL's N-bit → 16-bit container shift."""
    arr = np.asarray(PIL_Image.open(io.BytesIO(stream)))
    if bits > 8 and arr.dtype == np.uint16 and bits < 16:
        arr = arr >> (16 - bits)
    return arr.reshape(shape)


# ---------------------------------------------------------------- JPEG

def test_baseline_gray_foreign(rng):
    img = _smooth(rng, 64, 96, 1, 8)
    stream, mine = _encode(UID_BASELINE, img, 8, 1)
    pil = _pil_decode(stream, img.shape, 8)
    # different IDCT implementations: allow ±1 vs our decode
    assert np.abs(pil.astype(int) - mine.astype(int)).max() <= 1


def test_baseline_rgb_foreign(rng):
    img = _smooth(rng, 64, 96, 3, 8)
    stream, mine = _encode(UID_BASELINE, img, 8, 3)
    pil = _pil_decode(stream, img.shape, 8)
    # IDCT + YCbCr rounding differences compound across two transforms
    assert np.abs(pil.astype(int) - mine.astype(int)).max() <= 6


# --------------------------------------------------------- J2K lossless

@pytest.mark.parametrize("bits", [8, 12, 16])
def test_j2k_lossless_gray_foreign(rng, bits):
    img = _smooth(rng, 64, 96, 1, bits)
    stream, _ = _encode(UID_J2K_LL, img, bits, 1)
    pil = _pil_decode(stream, img.shape, bits)
    np.testing.assert_array_equal(pil.astype(img.dtype), img)


def test_j2k_lossless_rgb_rct_foreign(rng):
    img = _smooth(rng, 64, 96, 3, 8)
    stream, _ = _encode(UID_J2K_MC_LL, img, 8, 3)
    pil = _pil_decode(stream, img.shape, 8)
    np.testing.assert_array_equal(pil, img)


def test_j2k_multitile_foreign(rng):
    img = _smooth(rng, 96, 96, 1, 12)
    stream, _ = _encode(UID_J2K_LL, img, 12, 1,
                        {"tile_width": 40, "tile_height": 40})
    pil = _pil_decode(stream, img.shape, 12)
    np.testing.assert_array_equal(pil.astype(img.dtype), img)


@pytest.mark.parametrize("pw,order", [(64, 0), (32, 2), (128, 4)])
def test_j2k_precinct_pixel_size_foreign(rng, pw, order):
    """OpenJPEG decodes the pixel-size precinct convention's streams
    (auto-scaled per-resolution PPx/PPy in COD) exactly."""
    img = _smooth(rng, 128, 128, 1, 12)
    stream, _ = _encode(UID_J2K_LL, img, 12, 1,
                        {"precinct_width": pw, "precinct_height": pw,
                         "progression": order})
    pil = _pil_decode(stream, img.shape, 12)
    np.testing.assert_array_equal(pil.astype(img.dtype), img)


def test_j2k_multilayer_foreign(rng):
    img = _smooth(rng, 64, 64, 1, 12)
    stream, _ = _encode(UID_J2K_LL, img, 12, 1, {"num_layers": 3})
    pil = _pil_decode(stream, img.shape, 12)
    np.testing.assert_array_equal(pil.astype(img.dtype), img)


@pytest.mark.parametrize("order", [0, 1, 2, 3, 4])  # LRCP..CPRL
def test_j2k_progressions_foreign(rng, order):
    img = _smooth(rng, 48, 64, 1, 12)
    stream, _ = _encode(UID_J2K_LL, img, 12, 1, {"progression": order})
    pil = _pil_decode(stream, img.shape, 12)
    np.testing.assert_array_equal(pil.astype(img.dtype), img)


def test_j2k_roi_foreign(rng):
    from go_dicom_codec_jax.codecs.j2k_roi import ROIRegion

    img = _smooth(rng, 64, 64, 1, 12)
    stream, _ = _encode(
        UID_J2K_LL, img, 12, 1,
        {"roi_regions": [ROIRegion(shape="rect", rect=(8, 8, 32, 32))]})
    pil = _pil_decode(stream, img.shape, 12)
    np.testing.assert_array_equal(pil.astype(img.dtype), img)


def test_j2k_lossy_foreign(rng):
    img = _smooth(rng, 64, 96, 1, 12)
    stream, mine = _encode(UID_J2K_LOSSY, img, 12, 1)
    pil = _pil_decode(stream, img.shape, 12)
    # foreign decode must agree with ours within dequant rounding
    assert np.abs(pil.astype(int) - mine.astype(int)).max() <= 1
    assert np.abs(pil.astype(int) - img.astype(int)).max() <= 64


# -------------------------------------------------------------- HTJ2K

@pytest.mark.parametrize("uid", [UID_HT_LL, UID_HT_RPCL])
def test_htj2k_lossless_foreign(rng, uid):
    img = _smooth(rng, 64, 96, 1, 12)
    stream, _ = _encode(uid, img, 12, 1)
    pil = _pil_decode(stream, img.shape, 12)
    np.testing.assert_array_equal(pil.astype(img.dtype), img)


def test_htj2k_lossy_foreign(rng):
    img = _smooth(rng, 64, 96, 1, 12)
    stream, mine = _encode(UID_HT, img, 12, 1)
    pil = _pil_decode(stream, img.shape, 12)
    assert np.abs(pil.astype(int) - mine.astype(int)).max() <= 1
    assert np.abs(pil.astype(int) - img.astype(int)).max() <= 64


# ---------------------------------------------------------------------
# reverse direction: FOREIGN-encoded streams decoded by THIS repo
# (live complement to the static Kakadu/OpenJPH golden fixtures)
# ---------------------------------------------------------------------

def test_pil_encoded_jpeg_decodes_here(rng):
    """libjpeg-encoded baseline scan → our decoder, checked against
    PIL's own decode (decoder-vs-decoder, quant loss cancelled)."""
    from go_dicom_codec_jax.codecs import jpeg_baseline as jb

    img = _smooth(rng, 64, 96, 1, 8)
    buf = io.BytesIO()
    PIL_Image.fromarray(img).save(buf, format="JPEG", quality=90)
    pix, w, h, c = jb.decode(buf.getvalue())
    ours = np.frombuffer(pix, np.uint8).reshape(img.shape)
    theirs = np.asarray(PIL_Image.open(io.BytesIO(buf.getvalue())))
    assert np.abs(ours.astype(int) - theirs.astype(int)).max() <= 1


@pytest.mark.parametrize("mode,arr_fn", [
    ("L", lambda rng: _smooth(rng, 64, 96, 1, 8)),
    ("RGB", lambda rng: _smooth(rng, 48, 64, 3, 8)),
])
def test_pil_encoded_j2k_lossless_decodes_here(rng, mode, arr_fn):
    """OpenJPEG-encoded reversible raw codestreams decode bit-exact."""
    from go_dicom_codec_jax.codecs.jpeg2000 import decode_to_pixels

    img = arr_fn(rng)
    buf = io.BytesIO()
    PIL_Image.fromarray(img).save(buf, format="JPEG2000", no_jp2=True,
                                  irreversible=False)
    pix, w, h, c, depth, signed = decode_to_pixels(buf.getvalue())
    got = np.frombuffer(pix, np.uint8).reshape(img.shape)
    np.testing.assert_array_equal(got, img)


def test_pil_encoded_j2k_16bit_decodes_here(rng, tmp_path):
    from go_dicom_codec_jax.codecs.jpeg2000 import decode_to_pixels

    img = _smooth(rng, 64, 64, 1, 16).astype("<u2")
    fn = tmp_path / "x.j2k"  # some PIL encode paths need a real file
    PIL_Image.fromarray(img).save(  # uint16 → I;16

        str(fn), format="JPEG2000", no_jp2=True, irreversible=False)
    pix, w, h, c, depth, signed = decode_to_pixels(fn.read_bytes())
    got = np.frombuffer(pix, "<u2" if not signed else "<i2")
    np.testing.assert_array_equal(
        got.reshape(img.shape).astype(np.int64), img.astype(np.int64))


def test_pil_encoded_j2k_lossy_decodes_here(rng, tmp_path):
    from go_dicom_codec_jax.codecs.jpeg2000 import decode_to_pixels

    img = _smooth(rng, 64, 96, 1, 8)
    fn = tmp_path / "x.j2k"
    PIL_Image.fromarray(img).save(str(fn), format="JPEG2000", no_jp2=True,
                                  irreversible=True,
                                  quality_mode="rates", quality_layers=[10])
    pix, *_ = decode_to_pixels(fn.read_bytes())
    got = np.frombuffer(pix, np.uint8).reshape(img.shape)
    theirs = np.asarray(PIL_Image.open(io.BytesIO(fn.read_bytes())))
    # both decoders reconstruct the same lossy stream
    assert np.abs(got.astype(int)
                  - theirs.reshape(img.shape).astype(int)).max() <= 2


# ------------------------------------------------- progressive (SOF2)

@pytest.mark.parametrize("mode,shape,kw", [
    ("L", (64, 96), {}),
    ("L", (61, 67), {"quality": 50}),
    ("RGB", (64, 96, 3), {}),                    # 4:2:0
    ("RGB", (48, 64, 3), {"subsampling": 0}),    # 4:4:4
    ("RGB", (48, 64, 3), {"subsampling": 1}),    # 4:2:2
])
def test_pil_progressive_jpeg_decodes_here(rng, mode, shape, kw):
    """libjpeg progressive (SOF2) streams decode here (reference parity:
    its Extended path rides Go stdlib image/jpeg, which accepts SOF2 —
    /root/reference/jpeg/extended/encoder_simple.go:35-46)."""
    from go_dicom_codec_jax.codecs import jpeg_extended as je

    n = 1 if mode == "L" else 3
    img = _smooth(rng, shape[0], shape[1], n, 8)
    buf = io.BytesIO()
    kw.setdefault("quality", 90)
    PIL_Image.fromarray(img).save(buf, format="JPEG", progressive=True,
                                  **kw)
    pix, w, h, c, depth = je.decode(buf.getvalue())
    ours = np.frombuffer(pix, np.uint8).reshape(img.shape)
    theirs = np.asarray(PIL_Image.open(buf)).reshape(img.shape)
    # IDCT + fancy-upsample + YCbCr rounding differences only
    assert np.abs(ours.astype(int) - theirs.astype(int)).max() <= 6


def test_pil_progressive_via_baseline_registry(rng):
    """A progressive frame inside the .50 transfer syntax still decodes
    (generous fallback; third-party archives contain such streams)."""
    img = _smooth(rng, 64, 64, 1, 8)
    buf = io.BytesIO()
    PIL_Image.fromarray(img).save(buf, format="JPEG", progressive=True,
                                  quality=90)
    info = dc.FrameInfo(width=64, height=64, bits_allocated=8,
                        bits_stored=8)
    enc = dc.MemoryPixelData(info=info, encapsulated=True)
    enc.add_frame(buf.getvalue())
    dec = dc.MemoryPixelData(info=info)
    dc.get_global_registry().get_codec(UID_BASELINE).decode(enc, dec)
    ours = np.frombuffer(dec.get_frame(0), np.uint8).reshape(img.shape)
    theirs = np.asarray(PIL_Image.open(buf)).reshape(img.shape)
    assert np.abs(ours.astype(int) - theirs.astype(int)).max() <= 2
