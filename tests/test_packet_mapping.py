"""Packet→code-block mapping, direct coefficients, quant diagnostics.

Mirrors the reference's packet_mapping_test.go (fingerprint block
encoder proving the encoder's packet body order matches the decoder's
geometry expectation; HTJ2K blocks ship cleanup-only with OpenJPH
missing-MSB counts), direct_coeff_test.go (encoder-path coefficients
equal coefficients re-derived from a full encode/decode), and
quantization_diagnostic_test.go (quality-scale monotonicity and
quantize/dequantize error diagnostics).
"""

import numpy as np
import pytest

from go_dicom_codec_jax.codecs import j2k_quant as jq
from go_dicom_codec_jax.codecs.j2k_geometry import build_tile_geometry
from go_dicom_codec_jax.codecs.jpeg2000 import (J2KEncodeParams, J2KEncoder,
                                                band_mb, decode_to_pixels)
from go_dicom_codec_jax.codestream import j2k
from go_dicom_codec_jax.entropy.ebcot import PassInfo
from go_dicom_codec_jax.ops.dwt53 import fwd53_multilevel
from go_dicom_codec_jax.t2.packets import (BlockState, PrecinctState,
                                           decode_packet, progression_order)


# ---- fingerprint block encoder (reference fingerprintBlockEncoder) ---------

def _fingerprint(blk: np.ndarray) -> bytes:
    a = np.asarray(blk, dtype=np.int64).ravel()
    s = int(((np.arange(a.size, dtype=np.int64) + 1) * a).sum()) & 0xFFFFFFFF
    return s.to_bytes(4, "big")


class _FingerprintEncoder:
    def __init__(self, w, h):
        self.w, self.h = w, h

    def encode(self, blk):
        data = _fingerprint(blk)
        return data, 1, [PassInfo(pass_type=2, bitplane=0, terminated=True,
                                  rate=len(data), nmsedec=0)]


def _block_slice(coeffs, bg, g):
    return coeffs[0,
                  bg.row_off + (g.y0 - bg.y0):bg.row_off + (g.y1 - bg.y0),
                  bg.col_off + (g.x0 - bg.x0):bg.col_off + (g.x1 - bg.x0)]


@pytest.mark.parametrize("progression", [0, 2])
def test_packet_codeblock_order_matches_decoder_geometry(progression):
    # reference TestPacketCodeBlockOrderMatchesDecoderGeometry: encode
    # packets from fingerprinted blocks, decode them with the decoder's
    # T2 machinery over freshly-built geometry, and require every
    # fingerprint to land at its own geometry position.
    w = h = 128
    levels = 2
    enc = J2KEncoder(J2KEncodeParams(
        num_levels=levels, progression=progression, cb_width=32,
        cb_height=32,
        block_encoder_factory=lambda bw, bh: _FingerprintEncoder(bw, bh)))
    cod = j2k.CodInfo(progression=progression, num_levels=levels,
                      cb_width=32, cb_height=32)
    qcd = enc._build_qcd(levels, 8, False, 1)
    coeffs = ((np.arange(h * w, dtype=np.int64) % 113) + 1) \
        .astype(np.int32).reshape(1, h, w)

    comp_res, comp_states = enc._tile_block_states(
        coeffs, (0, 0, w, h), cod, qcd, 8)
    body = enc._assemble_tile_packets(comp_res, comp_states, cod, 1)

    # decoder side: fresh geometry + T2 packet decode
    resolutions = build_tile_geometry(0, 0, w, h, levels, 32, 32,
                                      cod.precinct_exp)
    dec_states = {}
    for res in resolutions:
        for prec in res.precincts:
            dec_states[(res.r, prec.index)] = [
                PrecinctState(ncbw=pb.ncbw, ncbh=pb.ncbh,
                              blocks=[BlockState(cbx=g.cbx, cby=g.cby)
                                      for g in pb.blocks],
                              mb=band_mb(qcd, res.r, pb.band.band, levels))
                for pb in prec.bands]
    pinfo = J2KEncoder._precinct_info_fn([resolutions], cod)
    pos = 0
    for (lay, r, c, pidx) in progression_order(progression, 1, levels + 1,
                                               1, pinfo):
        pos = decode_packet(body, pos, dec_states[(r, pidx)], lay,
                            cod.cb_style)
    assert pos == len(body)          # every body byte consumed

    # each decoded block carries exactly its own fingerprint
    checked = 0
    for res in resolutions:
        for prec in res.precincts:
            for pb, ps in zip(prec.bands, dec_states[(res.r, prec.index)]):
                for g, blk in zip(pb.blocks, ps.blocks):
                    want = _fingerprint(_block_slice(coeffs, pb.band, g))
                    assert bytes(blk.seg_data) == want
                    assert blk.numbps == 1
                    checked += 1
    assert checked > 10              # multi-band, multi-block coverage


def test_htj2k_blocks_are_cleanup_only_with_openjph_missing_msbs():
    # reference TestHTJ2KPacketCodeBlocksUseCleanupPassOnly: every HT
    # block ships exactly one (cleanup) pass with zero-bitplanes =
    # band Mb - 1 (OpenJPH Kmax-1; encoder.go:3374-3383)
    w = h = 128
    levels = 2
    enc = J2KEncoder(J2KEncodeParams(num_levels=levels, htj2k=True,
                                     cb_width=32, cb_height=32))
    cod = j2k.CodInfo(progression=2, num_levels=levels, cb_width=32,
                      cb_height=32, cb_style=0x40)
    qcd = enc._build_qcd(levels, 8, False, 1)
    coeffs = ((np.arange(h * w, dtype=np.int64) % 113) + 1) \
        .astype(np.int32).reshape(1, h, w)
    comp_res, comp_states = enc._tile_block_states(
        coeffs, (0, 0, w, h), cod, qcd, 8)

    nblocks = 0
    for res in comp_res[0]:
        for prec in res.precincts:
            for pb, ps in zip(prec.bands,
                              comp_states[0][(res.r, prec.index)]):
                mb = band_mb(qcd, res.r, pb.band.band, levels)
                for blk in ps.blocks:
                    assert blk.data, "nonzero HT block must carry data"
                    assert blk.numbps == 1                 # cleanup only
                    assert len(blk.pass_rates) == 1
                    assert blk.zero_bitplanes == mb - 1    # OpenJPH Kmax-1
                    nblocks += 1
    assert nblocks > 10


# ---- direct coefficient comparison (reference direct_coeff_test.go) --------

@pytest.mark.parametrize("size,levels", [(192, 1), (64, 2)])
def test_direct_coefficient_comparison(size, levels):
    y, x = np.mgrid[0:size, 0:size]
    img = ((x + y) % 256).astype(np.uint8)

    # encoder path: DC shift + forward 5/3
    shifted = (img.astype(np.int32) - 128)[None]
    enc_coeffs = np.asarray(fwd53_multilevel(shifted, levels))

    # full encode/decode, then re-derive the decoder's coefficients by
    # re-applying the encoder transform to the reconstruction
    enc = J2KEncoder(J2KEncodeParams(num_levels=levels))
    data = enc.encode(img.tobytes(), size, size, 1, 8, False)
    pix, ow, oh, _, _, _ = decode_to_pixels(data)
    rec = np.frombuffer(pix, dtype=np.uint8).reshape(oh, ow)
    dec_coeffs = np.asarray(fwd53_multilevel(
        (rec.astype(np.int32) - 128)[None], levels))

    np.testing.assert_array_equal(enc_coeffs, dec_coeffs)


# ---- quantization diagnostics (reference quantization_diagnostic_test.go) --

def test_quality_scale_monotonically_decreases():
    prev = None
    for q in range(80, 100):
        scale = jq.quality_scale(q)
        if prev is not None:
            assert scale < prev, f"scale increased at Q={q}"
        prev = scale


def test_ll_step_decreases_with_quality():
    prev = None
    for q in (80, 85, 90, 92, 94, 95, 96, 97, 98, 99):
        steps = jq.step_sizes_97(5, q)
        if prev is not None:
            assert steps[0] < prev
        prev = steps[0]


@pytest.mark.parametrize("quality", [80, 90, 95, 99])
def test_quantize_dequantize_error_bounded(quality):
    # reference TestDiagnosticEncodingPipeline 4x4 gradient: |error|
    # after quantize→dequantize is bounded by the step size, and
    # error shrinks as quality rises
    data = np.array([0, 50, 100, 150,
                     50, 100, 150, 200,
                     100, 150, 200, 250,
                     150, 200, 250, 255], dtype=np.int32)
    delta = jq.step_sizes_97(2, quality)[0] * (1 << 8)   # absolute LL step
    q = jq.deadzone_quantize(data.astype(np.float64), delta)
    deq = jq.dequantize(q, delta)
    err = np.abs(data - deq)
    assert err.max() <= delta
