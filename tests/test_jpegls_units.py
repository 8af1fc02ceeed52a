"""JPEG-LS primitive unit tests (reference jpegls/lossless/{golomb,map,
unmap_direct,run_interrupt,test_wrap}_test.go, nearlossless/edge_cases_test.go,
runmode/runmode.go J-table semantics, context.go counter discipline).

Stream-level roundtrips live in test_jpegls.py / test_jpegls_stress.py;
this file pins the T.87 scalar machinery in isolation.
"""

import numpy as np
import pytest

from go_dicom_codec_jax.codecs.jpegls import (J, Traits, _apply_sign, _Ctx,
                                              _map_error, _RunCtx, _Scan,
                                              _unmap_error)
from go_dicom_codec_jax.entropy.golomb import GolombReader, GolombWriter


# ---- error mapping (map_test.go / unmap_direct_test.go) ----------------------

@pytest.mark.parametrize("e", [0, 1, -1, 2, -2, 100, -100, 2**20, -(2**20)])
def test_map_unmap_roundtrip(e):
    assert _unmap_error(_map_error(e)) == e


def test_map_error_interleaves_signs():
    """0,-1,1,-2,2… maps to 0,1,2,3,4… (T.87 A.5.2 folding)."""
    assert [_map_error(e) for e in [0, -1, 1, -2, 2, -3]] == [0, 1, 2, 3, 4, 5]


def test_map_error_nonnegative():
    for e in range(-300, 300):
        assert _map_error(e) >= 0


def test_apply_sign():
    assert _apply_sign(5, 0) == 5
    assert _apply_sign(5, -1) == -5
    assert _apply_sign(-7, -1) == 7


# ---- traits: quantize / modulo / reconstruct (traits.go tests) ---------------

def test_quantize_identity_when_lossless():
    t = Traits(maxval=255, near=0)
    for e in (-255, -1, 0, 1, 255):
        assert t.quantize(e) == e


@pytest.mark.parametrize("near", [1, 2, 3, 7])
def test_quantize_dequantize_error_bound(near):
    t = Traits(maxval=255, near=near)
    for e in range(-255, 256):
        q = t.quantize(e)
        assert abs(t.dequantize(q) - e) <= near


def test_quantize_symmetric(rng):
    t = Traits(maxval=255, near=3)
    for e in range(0, 256):
        assert t.quantize(-e) == -t.quantize(e)


def test_modulo_range_wraps_into_window():
    t = Traits(maxval=255, near=0)  # range = 256
    assert t.modulo_range(128) == -128
    assert t.modulo_range(127) == 127
    assert t.modulo_range(-129) == 127
    assert t.modulo_range(-128) == -128


def test_reconstruct_wraps_like_encoder(rng):
    """reconstruct(pred, computed_error) recovers x modulo the NEAR bound
    (test_wrap_test.go semantics, including the wrap branches)."""
    for near in (0, 2):
        t = Traits(maxval=255, near=near)
        for x in (0, 1, 254, 255, 128):
            for pred in (0, 5, 250, 255):
                err = t.compute_error(x - pred)
                rec = t.reconstruct(pred, err)
                assert 0 <= rec <= 255
                if near == 0:
                    assert rec == x
                else:
                    assert abs(rec - x) <= near


def test_correct_prediction_clamps():
    t = Traits(maxval=4095, near=0)
    assert t.correct_prediction(-5) == 0
    assert t.correct_prediction(5000) == 4095
    assert t.correct_prediction(77) == 77


def test_default_thresholds_8bit_iso_values():
    """ISO 14495-1 A.1 defaults for 8-bit lossless: T1=3 T2=7 T3=21."""
    t = Traits(maxval=255, near=0)
    assert (t.t1, t.t2, t.t3) == (3, 7, 21)
    assert t.reset == 64


def test_default_thresholds_scale_with_near():
    t0 = Traits(maxval=255, near=0)
    t3 = Traits(maxval=255, near=3)
    assert t3.t1 > t0.t1 and t3.t2 > t0.t2 and t3.t3 > t0.t3


def test_default_thresholds_low_precision():
    """maxval < 128 uses the divisor branch (A.1 second formula)."""
    t = Traits(maxval=31, near=0)
    assert t.t1 >= 2 and t.t1 <= t.t2 <= t.t3 <= 31


def test_limit_and_qbpp():
    t8 = Traits(maxval=255, near=0)
    assert t8.qbpp == 8 and t8.limit == 2 * (8 + 8)
    t12 = Traits(maxval=4095, near=0)
    assert t12.qbpp == 12 and t12.limit == 2 * (12 + 12)


def test_near_reduces_range():
    t = Traits(maxval=255, near=3)
    assert t.range == (255 + 6) // 7 + 1


# ---- gradient quantizer (context.go:152-183) --------------------------------

def test_gradient_quantizer_nine_regions():
    t = Traits(maxval=255, near=0)  # t1=3 t2=7 t3=21
    cases = [(-50, -4), (-21, -4), (-20, -3), (-7, -3), (-6, -2), (-3, -2),
             (-2, -1), (-1, -1), (0, 0), (1, 1), (2, 1), (3, 2), (6, 2),
             (7, 3), (20, 3), (21, 4), (100, 4)]
    for d, q in cases:
        assert t.quantize_gradient(d) == q, d


def test_gradient_quantizer_near_deadzone():
    t = Traits(maxval=255, near=2)
    for d in (-2, -1, 0, 1, 2):
        assert t.quantize_gradient(d) == 0


def test_context_id_range():
    t = Traits(maxval=255, near=0)
    scan = _Scan(t)
    assert scan.context_id(0, 0, 0, 0) == 0
    # extreme gradients reach ±364: all three quantized gradients at ±4
    assert scan.context_id(0, 42, 21, 63) == 364
    assert scan.context_id(63, 21, 42, 0) == -364


# ---- MED predictor (predictor.go:12) ----------------------------------------

def test_med_predictor_cases():
    p = _Scan.predict
    assert p(10, 20, 5) == 20    # c <= min → max(a,b)
    assert p(10, 20, 30) == 10   # c >= max → min(a,b)
    assert p(10, 20, 15) == 15   # else a+b-c
    assert p(7, 7, 7) == 7


def test_med_predictor_symmetric_in_a_b():
    for a, b, c in [(3, 9, 1), (9, 3, 1), (3, 9, 11), (5, 8, 6)]:
        assert _Scan.predict(a, b, c) == _Scan.predict(b, a, c)


# ---- context counters (context.go:30-113) -----------------------------------

def test_ctx_initial_state():
    c = _Ctx(256)
    assert c.a == max(2, (256 + 32) // 64) and c.b == 0 and c.n == 1


def test_ctx_golomb_k_grows_with_a():
    c = _Ctx(256)
    c.a, c.n = 1000, 1
    k_big = c.golomb_k()
    c.a = 2
    assert c.golomb_k() < k_big


def test_ctx_reset_halves_counters():
    c = _Ctx(256)
    c.a, c.b, c.n = 100, -40, 64
    c.update(0, 0, 64)
    # A,B,N halved before N increments (context.go:63-66)
    assert c.n == 33 and c.a == 50


def test_ctx_bias_drifts_c():
    """Persistent negative errors decrement the bias-correction C."""
    c = _Ctx(256)
    c0 = c.c
    for _ in range(10):
        c.update(-3, 0, 64)
    assert c.c < c0
    c2 = _Ctx(256)
    for _ in range(10):
        c2.update(3, 0, 64)
    assert c2.c > c0


def test_runctx_k_and_map_consistency():
    """error_from_mapped inverts compute_map for both run contexts."""
    for rtype in (0, 1):
        rc = _RunCtx(rtype, 256)
        for err in (-3, -1, 1, 2):
            if rtype == 1 and err == 0:
                continue
            k = rc.golomb_k()
            map_bit = rc.compute_map(err, k)
            emapped = 2 * abs(err) - rc.rtype - (1 if map_bit else 0)
            got = rc.error_from_mapped(emapped + rc.rtype, k)
            assert got == err, (rtype, err)


# ---- run mode / J table (runmode.go) ----------------------------------------

def test_j_table_is_t87():
    assert len(J) == 32
    assert J[:4] == (0, 0, 0, 0) if isinstance(J, tuple) else list(J[:4]) == [0, 0, 0, 0]
    assert J[31] == 15


def test_run_index_bounds():
    scan = _Scan(Traits(maxval=255, near=0))
    for _ in range(40):
        scan.inc_run()
    assert scan.run_index == 31
    for _ in range(40):
        scan.dec_run()
    assert scan.run_index == 0


@pytest.mark.parametrize("run,total", [(0, 10), (5, 10), (10, 10), (63, 64),
                                       (64, 64), (200, 256)])
def test_run_length_roundtrip(run, total):
    t = Traits(maxval=255, near=0)
    enc = _Scan(t)
    gw = GolombWriter()
    enc.encode_run_length(gw, run, end_of_line=(run == total))
    data = gw.finish() + b"\xff" * 4
    dec = _Scan(t)
    gr = GolombReader(data)
    assert dec.decode_run_length(gr, total) == run
    assert dec.run_index == enc.run_index  # both sides adapt identically


def test_run_interruption_roundtrip():
    t = Traits(maxval=255, near=0)
    enc, dec = _Scan(t), _Scan(t)
    gw = GolombWriter()
    errs = [1, -2, 3, -1, 5, -4]
    for e in errs:
        enc.encode_run_interruption(gw, enc.rctx[0], e)
    gr = GolombReader(gw.finish() + b"\xff" * 8)
    got = [dec.decode_run_interruption(gr, dec.rctx[0]) for _ in errs]
    assert got == errs


# ---- regular-mode encode/decode state symmetry ------------------------------

def test_regular_mode_scalar_roundtrip(rng):
    """encode_regular/decode_regular agree sample-by-sample with shared
    neighbor state (the 365-context adaptive feedback loop)."""
    t = Traits(maxval=255, near=0)
    enc, dec = _Scan(t), _Scan(t)
    gw = GolombWriter()
    xs = rng.integers(0, 256, size=64).tolist()
    ra = rb = rc = rd = 0
    outs = []
    for x in xs:
        qs = enc.context_id(ra, rb, rc, rd)
        outs.append(enc.encode_regular(gw, int(x), qs, ra, rb, rc))
        ra = outs[-1]
    gr = GolombReader(gw.finish() + b"\xff" * 8)
    ra = rb = rc = rd = 0
    for i, x in enumerate(xs):
        qs = dec.context_id(ra, rb, rc, rd)
        got = dec.decode_regular(gr, qs, ra, rb, rc)
        assert got == outs[i] == x
        ra = got


# ---- interleave modes (T.87 ILV 0/1/2; the reference writes only 2) ----

class TestInterleaveModes:
    """ILV=0 (scan per component) and ILV=1 (line interleaved, shared
    context counters but per-component RUNindex) are decode+encode
    surfaces beyond the reference, which hardcodes ILV=2 for color
    (jpegls/lossless/encoder.go SOS header)."""

    def _rgb(self, seed=0, h=48, w=40):
        import numpy as np
        rng = np.random.default_rng(seed)
        # mix of smooth (run-mode heavy) and noise (regular-mode heavy)
        y, x = np.mgrid[0:h, 0:w]
        img = ((x // 8)[..., None] * 16 + rng.integers(0, 24, (h, w, 3))
               + (y // 6)[..., None]).astype(np.uint8)
        return img

    def test_all_modes_roundtrip_exact(self):
        import numpy as np
        from go_dicom_codec_jax.codecs.jpegls import decode, encode
        img = self._rgb()
        sizes = {}
        for ilv in (0, 1, 2):
            s = encode(img.tobytes(), 40, 48, 3, 8, ilv=ilv)
            pix, w, h, c, d, n = decode(s)
            assert (w, h, c, d, n) == (40, 48, 3, 8, 0)
            assert np.frombuffer(pix, np.uint8).reshape(48, 40, 3
                                                        ).tolist() \
                == img.tolist()
            sizes[ilv] = len(s)
        # three distinct streams (different scan structure)
        assert len(set(sizes.values())) >= 2

    def test_ilv0_emits_three_scans(self):
        from go_dicom_codec_jax.codecs.jpegls import encode
        from go_dicom_codec_jax.codestream import jpeg_markers as mk
        s = encode(self._rgb().tobytes(), 40, 48, 3, 8, ilv=0)
        r = mk.JpegReader(s)
        assert r.read_marker() == mk.SOI
        ns_seen = []
        while True:
            m = r.read_marker()
            if m == mk.EOI:
                break
            if m == mk.SOS:
                p = r.read_segment()
                ns_seen.append((p[0], p[1]))  # (Ns, Cs1)
                r.find_scan_end(ls_mode=True)
            elif mk.has_length(m):
                r.read_segment()
        assert ns_seen == [(1, 1), (1, 2), (1, 3)]

    def test_ilv0_scan_order_by_component_id(self):
        """Scans map to planes by Cs id, not arrival order."""
        import numpy as np
        from go_dicom_codec_jax.codecs.jpegls import decode, encode
        from go_dicom_codec_jax.codestream import jpeg_markers as mk
        img = self._rgb(seed=2)
        s = encode(img.tobytes(), 40, 48, 3, 8, ilv=0)
        # reorder the three scans: move scan 1 (Cs=1) to the end
        r = mk.JpegReader(s)
        assert r.read_marker() == mk.SOI
        pieces, head = [], bytearray(b"\xff\xd8")
        while True:
            m = r.read_marker()
            if m == mk.EOI:
                break
            if m == mk.SOS:
                p = r.read_segment()
                start = r.pos
                r.find_scan_end(ls_mode=True)
                seg = (b"\xff\xda"
                       + (len(p) + 2).to_bytes(2, "big") + p
                       + s[start:r.pos])
                pieces.append(seg)
            elif mk.has_length(m):
                p = r.read_segment()
                head += bytes([0xFF, m & 0xFF])
                head += (len(p) + 2).to_bytes(2, "big") + p
        remuxed = bytes(head) + pieces[1] + pieces[2] + pieces[0] + \
            b"\xff\xd9"
        pix, w, h, c, d, n = decode(remuxed)
        assert np.frombuffer(pix, np.uint8).reshape(48, 40, 3).tolist() \
            == img.tolist()

    def test_near_all_modes_within_bound(self):
        import numpy as np
        from go_dicom_codec_jax.codecs.jpegls import decode, encode
        img = self._rgb(seed=1)
        for ilv in (0, 1, 2):
            s = encode(img.tobytes(), 40, 48, 3, 8, near=3, ilv=ilv)
            pix, w, h, c, d, n = decode(s)
            got = np.frombuffer(pix, np.uint8).reshape(48, 40, 3)
            assert n == 3
            assert np.abs(got.astype(int) - img.astype(int)).max() <= 3

    def test_adapter_ilv_parameter(self):
        import numpy as np

        import go_dicom_codec_jax as dc
        img = self._rgb(seed=4)
        info = dc.FrameInfo(width=40, height=48, bits_allocated=8,
                            bits_stored=8, samples_per_pixel=3)
        src = dc.MemoryPixelData(info=info)
        src.add_frame(img.tobytes())
        codec = dc.get_global_registry().get_codec(dc.uids.JPEG_LS_LOSSLESS)
        for ilv in (0, 1, 2):
            enc = dc.MemoryPixelData(info=info, encapsulated=True)
            codec.encode(src, enc, dc.Parameters(ilv=ilv))
            dec = dc.MemoryPixelData(info=info)
            codec.decode(enc, dec)
            assert dec.get_frame(0) == src.get_frame(0)

    def test_invalid_ilv_rejected(self):
        import pytest

        from go_dicom_codec_jax.codecs.jpegls import encode
        from go_dicom_codec_jax.errors import UnsupportedFormatError
        with pytest.raises(UnsupportedFormatError):
            encode(self._rgb().tobytes(), 40, 48, 3, 8, ilv=3)

    def test_zero_based_component_ids(self):
        """Foreign ILV=0 streams may use 0-based component ids; scans
        map to planes via the SOF55 id list, not raw Cs-1."""
        import numpy as np
        from go_dicom_codec_jax.codecs.jpegls import decode, encode
        img = self._rgb(seed=6)
        s = bytearray(encode(img.tobytes(), 40, 48, 3, 8, ilv=0))
        # rewrite ids 1,2,3 -> 0,1,2 in SOF55 and each SOS
        i = s.find(bytes([0xFF, 0xF7]))  # SOF55
        ln = (s[i + 2] << 8) | s[i + 3]
        for c in range(3):
            assert s[i + 10 + 3 * c] == c + 1
            s[i + 10 + 3 * c] = c
        p = i + 2 + ln
        while p < len(s):
            if s[p] == 0xFF and s[p + 1] == 0xDA:  # SOS
                assert s[p + 5] in (1, 2, 3)
                s[p + 5] -= 1
                p += 2 + ((s[p + 2] << 8) | s[p + 3])
            else:
                p += 1
        pix, w, h, c, d, n = decode(bytes(s))
        assert np.frombuffer(pix, np.uint8).reshape(48, 40, 3).tolist() \
            == img.tolist()

    def test_nonconformant_single_scan_ilv0_lane_parity(self):
        """A single Ns=3 scan declaring ILV=0 (non-conformant) must
        decode IDENTICALLY native vs native-disabled (both planar-
        sequential) — the lanes may not disagree on any input."""
        import subprocess
        import sys
        code = (
            "import os, hashlib, numpy as np\n"
            "os.environ['JAX_PLATFORMS'] = 'cpu'\n"
            "from go_dicom_codec_jax.codecs.jpegls import decode, encode\n"
            "rng = np.random.default_rng(8)\n"
            "img = rng.integers(0, 256, (24, 20, 3)).astype(np.uint8)\n"
            "s = bytearray(encode(img.tobytes(), 20, 24, 3, 8, ilv=2))\n"
            "i = s.find(bytes([0xFF, 0xDA]))\n"
            "ns = s[i + 4]\n"
            "assert s[i + 6 + ns * 2] == 2\n"
            "s[i + 6 + ns * 2] = 0  # declare ILV=0 on the Ns=3 scan\n"
            "pix, *_ = decode(bytes(s))\n"
            "print(hashlib.sha256(pix).hexdigest())\n")
        outs = []
        for disable in ("", "1"):
            env = dict(**__import__("os").environ)
            if disable:
                env["GDCT_DISABLE_NATIVE"] = disable
            else:
                env.pop("GDCT_DISABLE_NATIVE", None)
            r = subprocess.run([sys.executable, "-c", code], env=env,
                               capture_output=True, text=True,
                               timeout=300)
            assert r.returncode == 0, r.stderr
            outs.append(r.stdout.strip())
        assert outs[0] == outs[1]
