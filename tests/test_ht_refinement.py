"""HT SigProp/MagRef refinement passes (T.814 §7.3-7.5, B.2-B.3).

Beyond the reference (its HT coder is cleanup-pass-only,
htj2k/encoder.go:55-68): both directions of the refinement pair, with
the OpenJPEG foreign oracle pinning the bitstream convention (cleanup
payload = sign·(|v|>>1) signalled at numbps=2 so the §7.6 refinement
plane is plane 0).
"""

import io

import numpy as np
import pytest

from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder,
                                                J2KEncodeParams,
                                                J2KEncoder)
from go_dicom_codec_jax.entropy.htrefine import (MagRefPacker,
                                                 MagRefReader,
                                                 SigPropPacker,
                                                 SigPropReader,
                                                 apply_refinement,
                                                 encode_refinement)
from go_dicom_codec_jax.t2.packets import _segments, _terminates_at


# ---- bit packers / readers (§7.1.5-7.1.6, F.5) -------------------------

def test_sigprop_ff_stuffing():
    """A byte equal to 0xFF is followed by a 7-bit byte (stuff MSB 0)."""
    sp = SigPropPacker()
    for _ in range(16):
        sp.emit(1)
    b = sp.terminate()
    assert b == bytes([0xFF, 0x7F, 0x01])  # 8 ones, 7 ones, 1 one
    r = SigPropReader(b)
    assert [r.read() for _ in range(16)] == [1] * 16


def test_sigprop_reader_rejects_set_stuff_bit():
    r = SigPropReader(bytes([0xFF, 0x80]))
    for _ in range(8):
        r.read()
    with pytest.raises(Exception):
        r.read()


def test_sigprop_zero_tail_reads_beyond_buffer():
    """Standalone termination may drop an all-zero partial byte; the
    reader synthesizes 0 bytes beyond Lref (§7.1.5)."""
    sp = SigPropPacker()
    for bit in [1, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0]:
        sp.emit(bit)
    b = sp.terminate(followed_by_magref=False)
    assert b == bytes([0x05])  # the zero partial second byte is dropped
    r = SigPropReader(b)
    assert [r.read() for _ in range(11)] == [1, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0]


def test_magref_stuffing_roundtrip():
    """MR stuffing: after a byte > 0x8F, 7 accumulated one-bits force a
    0x7F byte (MSB stuff 0); MR_last starts 255 so the rule covers the
    first packed byte too."""
    pattern = [1, 1, 1, 1, 1, 1, 1, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 1]
    mr = MagRefPacker()
    for bit in pattern:
        mr.emit(bit)
    b = mr.terminate()
    rd = MagRefReader(b)
    assert [rd.read() for _ in range(len(pattern))] == pattern
    # wire-last byte (MR_buf[0]) can never be 0xFF
    assert b[-1] != 0xFF


# ---- hand-worked spec vector -------------------------------------------

def test_hand_packed_refinement_vector():
    """2×2 block v=[[2,1],[0,-1]] worked by hand through §7.3-7.5:
    SigProp bits (LSB-first) r(1,0)=0, r(0,1)=1, r(1,1)=1, then signs
    s(0,1)=0, s(1,1)=1 → byte 0x16; MagRef bit for (0,0)=0 → reversed
    byte 0x00."""
    v = np.array([[2, 1], [0, -1]], dtype=np.int64)
    dref, sp_len, exact, n_new, n_ref = encode_refinement(v, causal=False)
    assert exact and dref == bytes([0x16, 0x00]) and sp_len == 1
    assert (n_new, n_ref) == (2, 1)
    w = np.array([[3, 0], [0, 0]], dtype=np.int64)  # cleanup out (2u+1)
    got = apply_refinement(w, dref, 3, causal=False)
    assert np.array_equal(got, v)


# ---- scan roundtrips ----------------------------------------------------

@pytest.mark.parametrize("causal", [False, True])
def test_refinement_roundtrip_sweep(causal, rng):
    for _ in range(60):
        h, w = rng.integers(1, 40, size=2)
        dense = rng.random() < 0.5
        lo, hi = (-40, 41) if dense else (-2, 3)
        v = rng.integers(lo, hi, size=(h, w)).astype(np.int64)
        dref, sp_len, exact, n_new, n_ref = encode_refinement(v, causal)
        u = (np.abs(v) >> 1) * np.sign(v)
        w_cu = 2 * np.abs(u) * np.sign(v) + np.sign(v) * (np.abs(u) > 0)
        got = apply_refinement(w_cu, dref, 3, causal)
        if exact:
            assert np.array_equal(got, v)
        else:
            # only unreachable isolated ±1s may be lost (decode to 0)
            bad = (got != v) & ~((np.abs(v) == 1) & (got == 0))
            assert not bad.any()
        # Z=2 (SigProp only): significant samples keep the midpoint
        got2 = apply_refinement(w_cu, dref[:sp_len], 2, causal)
        sig = u != 0
        assert np.array_equal(got2[sig], np.sign(v[sig]) *
                              (2 * np.abs(u[sig]) + 1))
        assert np.array_equal(np.abs(got2[~sig]) <= 1,
                              np.ones_like(got2[~sig], dtype=bool))


def test_random_dref_never_desyncs_shape(rng):
    """Hostile refinement bytes: bounded work, valid shape or a raised
    stream error (resilient decode zero-fills the block upstream)."""
    w = rng.integers(-8, 9, size=(16, 16)).astype(np.int64) * 2
    w[w != 0] += np.sign(w[w != 0])
    for _ in range(50):
        dref = bytes(rng.integers(0, 256, size=rng.integers(1, 20),
                                  dtype=np.uint8))
        try:
            out = apply_refinement(w, dref, 3, causal=False)
            assert out.shape == (16, 16)
        except Exception:
            pass


# ---- T2 segment walk (T.814 B.2) ---------------------------------------

def test_ht_segment_walk():
    ht = 0x40
    assert _segments(ht, 2, 0, 1) == (1,)
    assert _segments(ht, 2, 0, 2) == (1, 1)
    assert _segments(ht, 2, 0, 3) == (1, 2)
    assert _segments(ht, 2, 1, 2) == (2,)
    assert _segments(ht, 2, 2, 1) == (1,)
    assert _segments(ht, 2, 1, 1) == (1,)
    assert [_terminates_at(ht, 2, i) for i in range(3)] == \
        [True, False, True]


# ---- end-to-end ----------------------------------------------------------

def _img(rng, h=160, w=150, bits=12):
    return rng.integers(0, 1 << bits, size=(h, w)).astype(np.int32)


@pytest.mark.parametrize("kw", [
    dict(),
    dict(num_layers=3, layer_rates=[8.0, 4.0], append_lossless_layer=True),
    dict(cb_style=0x08),                      # causal (VSC) variant
    dict(num_levels=0),
    dict(tile_width=64, tile_height=64),
    dict(progression=4),
], ids=["plain", "layered", "causal", "lv0", "tiled", "cprl"])
def test_ht_refinement_lossless_exact(kw, rng):
    img = _img(rng)
    p = J2KEncodeParams(htj2k=True, ht_refinement=True, **kw)
    s = J2KEncoder(p).encode(img, img.shape[1], img.shape[0], 1, 12)
    got = np.squeeze(J2KDecoder().decode(s)[0])
    assert np.array_equal(got, img)
    # native-vs-python decode lanes agree byte-for-byte on pixels
    got_res = np.squeeze(J2KDecoder(resilient=True).decode(s)[0])
    assert np.array_equal(got_res, img)


def test_batched_refined_decode_matches_scalar(rng, monkeypatch):
    """The batched native cleanup+refine entry (one ctypes round trip +
    thread pool) must reproduce the scalar per-block path bit-exactly —
    multi-block image so the batch really carries several blocks."""
    img = np.asarray(rng.integers(0, 4096, (96, 96)), dtype=np.int32)
    p = J2KEncodeParams(htj2k=True, ht_refinement=True, num_levels=2,
                        cb_width=32, cb_height=32)
    s = J2KEncoder(p).encode(img, 96, 96, 1, 12)
    batched = np.squeeze(J2KDecoder().decode(s)[0])
    # the decoder imports the batched entry at call time, so patching
    # the native module forces every block down the scalar path
    from go_dicom_codec_jax import native as nat
    monkeypatch.setattr(nat, "ht_decode_blocks_refined_native",
                        lambda items: None)
    scalar = np.squeeze(J2KDecoder().decode(s)[0])
    assert np.array_equal(batched, scalar)
    assert np.array_equal(batched, img)


def test_batched_refined_encode_matches_scalar(rng, monkeypatch):
    """The batched native refinement prep (u + segment + distortion
    deltas in one call) must produce byte-identical streams to the
    per-block scalar prep."""
    img = np.asarray(rng.integers(0, 4096, (96, 96)), dtype=np.int32)
    p = J2KEncodeParams(htj2k=True, ht_refinement=True, num_levels=2,
                        cb_width=32, cb_height=32, num_layers=2)
    batched = J2KEncoder(p).encode(img, 96, 96, 1, 12)
    from go_dicom_codec_jax import native as nat
    monkeypatch.setattr(nat, "ht_refine_encode_blocks_native",
                        lambda blks, causal: None)
    scalar = J2KEncoder(p).encode(img, 96, 96, 1, 12)
    assert batched == scalar
    got = np.squeeze(J2KDecoder().decode(batched)[0])
    assert np.array_equal(got, img)


def test_window_decode_composes_with_refinement(rng):
    img = np.asarray(rng.integers(0, 4096, (96, 96)), dtype=np.int32)
    p = J2KEncodeParams(htj2k=True, ht_refinement=True, num_levels=2,
                        cb_width=32, cb_height=32)
    s = J2KEncoder(p).encode(img, 96, 96, 1, 12)
    w = np.squeeze(J2KDecoder(window=(16, 16, 64, 64)).decode(s)[0])
    assert np.array_equal(w, img[16:64, 16:64])


def test_ht_refinement_stream_close_to_cleanup_only(rng):
    img = _img(rng)
    s1 = J2KEncoder(J2KEncodeParams(htj2k=True, ht_refinement=True)).encode(
        img, 150, 160, 1, 12)
    s0 = J2KEncoder(J2KEncodeParams(htj2k=True)).encode(
        img, 150, 160, 1, 12)
    assert len(s1) <= len(s0) * 1.02  # 3 truncation points, ~free


def test_ht_refinement_foreign_oracle(rng):
    """OpenJPEG (via PIL) decodes our multipass streams bit-exactly —
    the independent validation of the SigProp/MagRef conventions
    (bit order, sign polarity, segment layout, S_blk positioning)."""
    Image = pytest.importorskip("PIL.Image")
    img = _img(rng)
    for kw in (dict(), dict(num_layers=3, layer_rates=[8.0, 4.0],
                            append_lossless_layer=True),
               dict(num_levels=0)):
        p = J2KEncodeParams(htj2k=True, ht_refinement=True, **kw)
        s = J2KEncoder(p).encode(img, 150, 160, 1, 12)
        arr = np.array(Image.open(io.BytesIO(s))).astype(np.int64) >> 4
        assert np.array_equal(arr, img), kw


def test_ht_refinement_truncated_layer_decode(rng):
    """Dropping the refinement passes (decode the first layer of a
    rate-limited stream) keeps a bounded-error image — the truncation
    points are real quality steps."""
    img = _img(rng)
    p = J2KEncodeParams(htj2k=True, ht_refinement=True, num_layers=2,
                        layer_rates=[2.0], append_lossless_layer=True,
                        progression=1)  # RLCP: layer-major
    s = J2KEncoder(p).encode(img, 150, 160, 1, 12)
    full = np.squeeze(J2KDecoder().decode(s)[0])
    assert np.array_equal(full, img)
    # resilient decode of a truncated prefix: valid image, small error
    cut = np.squeeze(J2KDecoder(resilient=True).decode(
        s[: int(len(s) * 0.7)])[0])
    assert cut.shape == img.shape
    err = np.abs(cut.astype(np.int64) - img)
    assert np.mean(err) < np.mean(np.abs(img.astype(np.int64) - img.mean()))


def test_ht_refinement_via_adapter(rng):
    import go_dicom_codec_jax as dc
    info = dc.FrameInfo(width=96, height=80, bits_allocated=16,
                        bits_stored=12)
    src = dc.MemoryPixelData(info=info)
    src.add_frame(rng.integers(0, 4096, size=96 * 80,
                               dtype=np.uint16).astype("<u2").tobytes())
    codec = dc.get_global_registry().get_codec(dc.uids.HTJ2K_LOSSLESS)
    params = codec.get_default_parameters()
    params.set_parameter("ht_refinement", True)
    params.set_parameter("num_layers", 2)
    params.set_parameter("append_lossless_layer", True)
    enc = dc.MemoryPixelData(info=info, encapsulated=True)
    codec.encode(src, enc, params)
    dec = dc.MemoryPixelData(info=info)
    codec.decode(enc, dec)
    assert dec.get_frame(0) == src.get_frame(0)


