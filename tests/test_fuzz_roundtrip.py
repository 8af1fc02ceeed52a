"""Seeded random-parameter roundtrip sweeps (role of the reference's
hypothesis/termall/precinct/size-boundary test batteries).

Each trial draws random geometry + coding options, encodes, decodes,
and requires bit-exactness for lossless syntaxes. Seeds are fixed so
failures reproduce.
"""

import numpy as np
import pytest

from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder, J2KEncodeParams,
                                                J2KEncoder)
from go_dicom_codec_jax.codestream import j2k


@pytest.mark.parametrize("seed", range(12))
def test_j2k_random_config_roundtrip(seed):
    rng = np.random.default_rng(1000 + seed)
    w = int(rng.integers(17, 130))
    h = int(rng.integers(17, 130))
    bits = int(rng.choice([8, 12, 16]))
    levels = int(rng.integers(0, 5))
    cb = int(rng.choice([16, 32, 64]))
    prog = int(rng.integers(0, 5))
    layers = int(rng.choice([1, 1, 2, 3]))
    style = int(rng.choice([0, 0x01, 0x04, 0x08, 0x05]))
    tile = int(rng.choice([0, 0, 64]))
    precincts = None
    if rng.random() < 0.3:
        precincts = [(7, 7)] * (levels + 1)
    # content: mix of smooth + noise + flat regions
    base = np.cumsum(rng.integers(-5, 6, (h, w)), axis=1)
    img = (base - base.min()).astype(np.int64)
    img[: h // 3] = 0
    img += rng.integers(0, 1 << max(bits - 4, 1), (h, w))
    img = np.clip(img, 0, (1 << bits) - 1)
    pixels = (img.astype(np.uint8) if bits <= 8
              else img.astype("<u2")).tobytes()

    params = J2KEncodeParams(
        num_levels=levels, cb_width=cb, cb_height=cb, progression=prog,
        num_layers=layers, cb_style=style, tile_width=tile,
        tile_height=tile, precincts=precincts,
        layer_rates=[8.0, 0] if layers == 2 else None)
    enc = J2KEncoder(params)
    data = enc.encode(pixels, w, h, 1, bits, False)
    arr, _, _ = J2KDecoder().decode(data)
    np.testing.assert_array_equal(
        arr[:, :, 0], img.astype(np.int32),
        err_msg=f"seed={seed} w={w} h={h} bits={bits} lv={levels} cb={cb} "
                f"prog={prog} layers={layers} style={hex(style)} tile={tile}")


@pytest.mark.parametrize("seed", range(6))
def test_htj2k_random_config_roundtrip(seed):
    rng = np.random.default_rng(2000 + seed)
    w = int(rng.integers(9, 140))
    h = int(rng.integers(9, 140))
    bits = int(rng.choice([8, 12, 16]))
    levels = int(rng.integers(0, 4))
    cb = int(rng.choice([32, 64]))
    img = rng.integers(0, 1 << bits, (h, w)).astype(np.int64)
    img[h // 2:] //= 7  # quieter lower half
    pixels = (img.astype(np.uint8) if bits <= 8
              else img.astype("<u2")).tobytes()
    enc = J2KEncoder(J2KEncodeParams(num_levels=levels, cb_width=cb,
                                     cb_height=cb, htj2k=True))
    data = enc.encode(pixels, w, h, 1, bits, False)
    arr, _, _ = J2KDecoder().decode(data)
    np.testing.assert_array_equal(arr[:, :, 0], img.astype(np.int32),
                                  err_msg=f"seed={seed} {w}x{h} b{bits}")


def test_odd_image_origin_decode():
    """Codestream with XOsiz/YOsiz = 1 (odd reference-grid origin):
    parity-aware DWT windows must line up end to end."""
    rng = np.random.default_rng(7)
    # image region is 63x65 at origin (1,1) on a 64x66 grid
    w, h = 63, 65
    img = rng.integers(0, 4096, (h, w)).astype(np.int64)

    from go_dicom_codec_jax.codecs.jpeg2000 import band_mb
    enc = J2KEncoder(J2KEncodeParams(num_levels=2))
    siz = j2k.SizInfo(xsiz=64, ysiz=66, xosiz=1, yosiz=1,
                      xtsiz=64, ytsiz=66,
                      components=[(16, False, 1, 1)])
    cod = j2k.CodInfo(progression=0, num_layers=1, mct=0, num_levels=2,
                      cb_width=64, cb_height=64, transform=1)
    qcd = j2k.QcdInfo(style=0, guard_bits=2)
    from go_dicom_codec_jax.codecs.j2k_quant import band_gain
    for r in range(3):
        for band in ([0] if r == 0 else [1, 2, 3]):
            qcd.exponents.append(16 + band_gain(band))
    enc._eff_rates = None
    # _encode_tile indexes arr on reference-grid coordinates
    grid = np.zeros((66, 64, 1), dtype=np.int64)
    grid[1:66, 1:64, 0] = img
    rect = siz.tile_rect(0, 0)
    assert rect == (1, 1, 64, 66)
    body = enc._encode_tile(grid, rect, cod, qcd, 16, False, False, {})
    out = bytearray(b"\xff\x4f")
    out += j2k.write_siz(siz)
    out += j2k.write_cod(cod)
    out += j2k.write_qcd(qcd)
    out += j2k.write_tile_part(0, body)
    out += j2k.EOC.to_bytes(2, "big")

    arr, _, _ = J2KDecoder().decode(bytes(out))
    assert arr.shape == (h, w, 1)
    np.testing.assert_array_equal(arr[:, :, 0], img.astype(np.int32))


@pytest.mark.parametrize("layers,rates,prog", [
    (2, None, 1), (2, [8.0, 0], 0), (3, None, 3), (2, None, 4)])
def test_htj2k_layered_roundtrip(layers, rates, prog, rng):
    """HT blocks have a single all-or-nothing cleanup pass; layered
    streams must still allocate and decode them (fuzz-found regression:
    missing pass_bitplanes -> PCRD IndexError)."""
    img = rng.integers(0, 4096, (51, 77)).astype("<u2")
    data = J2KEncoder(J2KEncodeParams(num_levels=2, htj2k=True,
                                      num_layers=layers, layer_rates=rates,
                                      progression=prog)).encode(
        img.tobytes(), 77, 51, 1, 12, False)
    arr, _, _ = J2KDecoder().decode(data)
    np.testing.assert_array_equal(arr[:, :, 0], img.astype(np.int32))


def test_header_trailing_ff_alignment():
    """Fuzz-found (seed-3 trial 31): when a packet header's last byte is
    0xFF, the writer flush emits the stuffing byte; the reader's align
    must consume it even with all bits already used (opj_bio_inalign
    checks the byte value regardless of the bit count)."""
    rng = np.random.default_rng(1026784146)  # exact failing draw
    assert str(rng.choice(["j2k", "j2k", "ht", "jls", "p14"])) == "ht"
    w = int(rng.integers(5, 160)); h = int(rng.integers(5, 160))
    cmp_ = int(rng.choice([1, 1, 3]))
    bits = int(rng.choice([8, 10, 12, 16]))
    _ = rng.random()  # the fuzz's signed draw
    img = rng.integers(0, 1 << bits, (h, w, cmp_)).astype(np.int64)
    cfg = dict(num_levels=int(rng.integers(0, 6)),
               num_layers=int(rng.choice([1, 2, 3])),
               cb_width=int(rng.choice([16, 32, 64])),
               cb_height=int(rng.choice([16, 32, 64])),
               progression=int(rng.integers(0, 5)),
               cb_style=0, htj2k=True,
               tile_width=int(rng.choice([0, 0, 48, 64])),
               tile_height=int(rng.choice([0, 0, 48, 64])))
    data = J2KEncoder(J2KEncodeParams(**cfg)).encode(
        img.astype("<u2").tobytes(), w, h, cmp_, bits, False)
    arr, _, _ = J2KDecoder().decode(data)
    np.testing.assert_array_equal(arr.astype(np.int64), img)


def test_ragged_odd_origin_tile_deep_levels():
    """Fuzz-found (seed-3 trial 125): ragged tiles at odd origins with
    levels deeper than the tile supports — Annex B keeps splitting
    1-sample windows (odd parity moves the sample to the high band,
    the ×2 rule), so the DWT cascade and the band rectangles agree."""
    rng = np.random.default_rng(1)
    img = rng.integers(-(1 << 9), 1 << 9, (61, 63, 3)).astype(np.int64)
    from go_dicom_codec_jax.codecs.j2k_roi import ROIRegion
    roi = [ROIRegion(shape="rect", rect=(1, 1, 31, 30), style="maxshift")]
    cfg = dict(num_levels=5, cb_width=64, cb_height=16, progression=2,
               cb_style=1, tile_width=48, tile_height=48, roi_regions=roi)
    data = J2KEncoder(J2KEncodeParams(**cfg)).encode(
        img.astype("<i2").tobytes(), 63, 61, 3, 10, True)
    arr, _, _ = J2KDecoder().decode(data)
    np.testing.assert_array_equal(arr.astype(np.int64), img)
