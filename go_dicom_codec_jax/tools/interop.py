"""Interop validation matrix across every registered transfer syntax.

Role of reference cmd/dicom-interop-validation/main.go: per-format
encode→decode pipeline checks with per-format pixel tolerances (lossy
JPEG = 64, main.go:74-88), a worker pool (--parallel — the reference's
only concurrency, main.go:385-449), pipe-delimited INTEROP|pass/fail
output, exit code 1 on failure.

The reference's external oracle is the .NET fo-dicom native codec suite
run in a separate process; that toolchain isn't available here, so the
oracle is the codec's own decode path executed in a SEPARATE PROCESS
(state isolation like the reference's --stage re-exec), validating that
streams survive process boundaries and that lossless formats are
bit-exact.

`--oracle pil` additionally decodes each encoded stream with PIL
(libjpeg for JPEG baseline, OpenJPEG for J2K/HTJ2K) — a genuinely
foreign implementation, matching the role of the reference's external
fo-dicom oracle (main.go:568). Formats PIL cannot decode (RLE,
12-bit JPEG, JPEG lossless, JPEG-LS) keep the self-decode oracle here;
their independent validation lives in tests/test_spec_direct_vectors.py
(hand-packed PS3.5 Annex G / T.81 Annex H+F / T.87 streams from naive
spec-direct coders, plus sha-pinned encoder-output goldens).

Usage:
    python -m go_dicom_codec_jax.tools.interop [--parallel N]
        [--formats uid1,uid2] [--size WxH] [--seed N] [--oracle pil]
"""

from __future__ import annotations

import argparse
import sys
from concurrent.futures import ProcessPoolExecutor
from typing import List, Optional

import numpy as np

# format definitions: (label, uid, bits_stored, samples, tolerance[,
# encode params dict]) — the optional 6th element exercises non-default
# encode options through the same matrix
FORMAT_DEFINITIONS = [
    ("rle", "1.2.840.10008.1.2.5", 16, 1, 0),
    ("jpeg-baseline", "1.2.840.10008.1.2.4.50", 8, 1, 64),
    ("jpeg-baseline-rgb", "1.2.840.10008.1.2.4.50", 8, 3, 64),
    ("jpeg-extended", "1.2.840.10008.1.2.4.51", 12, 1, 64),
    ("jpeg-lossless-p14", "1.2.840.10008.1.2.4.57", 16, 1, 0),
    ("jpeg-lossless-sv1", "1.2.840.10008.1.2.4.70", 16, 1, 0),
    ("jpeg-ls-lossless", "1.2.840.10008.1.2.4.80", 12, 1, 0),
    ("jpeg-ls-near", "1.2.840.10008.1.2.4.81", 8, 1, 3),
    ("jpeg2000-lossless", "1.2.840.10008.1.2.4.90", 12, 1, 0),
    ("jpeg2000-lossy", "1.2.840.10008.1.2.4.91", 12, 1, 64),
    ("jpeg2000-mc-lossless", "1.2.840.10008.1.2.4.92", 8, 3, 0),
    ("jpeg2000-mc-lossy", "1.2.840.10008.1.2.4.93", 8, 3, 64),
    ("htj2k-lossless", "1.2.840.10008.1.2.4.201", 12, 1, 0),
    ("htj2k-rpcl", "1.2.840.10008.1.2.4.202", 12, 1, 0),
    ("htj2k", "1.2.840.10008.1.2.4.203", 8, 1, 64),
    # beyond-reference encode options through the same lanes
    ("jpeg2000-packed", "1.2.840.10008.1.2.4.90", 12, 1, 0,
     {"packed_headers": True, "use_sop": True, "use_eph": True,
      "plt_markers": True, "tlm_markers": True}),
    ("jpeg-ls-ilv1", "1.2.840.10008.1.2.4.80", 8, 3, 0, {"ilv": 1}),
    ("jpeg-ls-planar", "1.2.840.10008.1.2.4.80", 8, 3, 0, {"ilv": 0}),
]


_CLINICAL_NPZ = "test-data/clinical_pixels.npz"


def _clinical_fixture(bits, samples):
    """Real anonymized clinical pixels (role of the reference's 5
    embedded .dcm fixtures, cmd/dicom-interop-validation/main.go:89-90):
    XR (8-bit), CT (12-bit), MR (signed 16-bit) from
    test-data/clinical_pixels.npz; RGB formats get a colorized XR.

    Returns (array, signed)."""
    import os

    base = os.path.join(os.path.dirname(__file__), "..", "..")
    z = np.load(os.path.join(base, _CLINICAL_NPZ))
    if samples == 3:
        xr = z["xr_u8"][:512, :512]
        return np.stack([xr, xr >> 1, 255 - xr], axis=-1), False
    if bits <= 8:
        return z["xr_u8"][:512, :512], False
    if bits <= 12:
        return z["ct_u12"].astype("<u2"), False
    return z["mr_s16"].astype("<i2"), True


def _make_fixture(width, height, bits, samples, seed):
    rng = np.random.default_rng(seed)
    # smooth CT-like content so lossy formats meet their tolerance
    small = rng.random((height // 8 + 2, width // 8 + 2, samples))
    ys = np.linspace(0, small.shape[0] - 1.001, height)
    xs = np.linspace(0, small.shape[1] - 1.001, width)
    y0, x0 = ys.astype(int), xs.astype(int)
    fy = (ys - y0)[:, None, None]
    fx = (xs - x0)[None, :, None]
    img = (small[y0][:, x0] * (1 - fy) * (1 - fx)
           + small[y0][:, x0 + 1] * (1 - fy) * fx
           + small[y0 + 1][:, x0] * fy * (1 - fx)
           + small[y0 + 1][:, x0 + 1] * fy * fx)
    maxv = (1 << bits) - 1
    arr = np.round(img * maxv)
    dt = np.uint8 if bits <= 8 else np.dtype("<u2")
    return arr.astype(dt)


# labels PIL can foreign-decode: 8-bit JPEG baseline (libjpeg) and all
# J2K/HTJ2K codestreams (OpenJPEG). PIL returns N-bit precision in a
# 16-bit container shifted left by (16 - N).
PIL_DECODABLE = {
    "jpeg-baseline", "jpeg-baseline-rgb",
    "jpeg2000-lossless", "jpeg2000-lossy",
    "jpeg2000-mc-lossless", "jpeg2000-mc-lossy",
    "htj2k-lossless", "htj2k-rpcl", "htj2k",
    "jpeg2000-packed",
}


def _pil_check(stream: bytes, img, bits: int, tol: int):
    """Foreign-decode stream with PIL; return (ok, maxerr)."""
    import io

    import numpy as np
    from PIL import Image

    arr = np.asarray(Image.open(io.BytesIO(stream)))
    if bits > 8 and arr.dtype == np.uint16 and bits < 16:
        arr = arr >> (16 - bits)
    err = int(np.abs(arr.reshape(img.shape).astype(np.int64)
                     - img.astype(np.int64)).max())
    return err <= tol, err


def run_format(args):
    """One format's encode→decode check. Runs in a worker process."""
    (label, uid, bits, samples, tol, width, height, seed, oracle,
     fixture, enc_params) = args
    import os

    # the workers run on the CPU: several JAX processes must not share
    # one GPU (each reserves most of its memory at first use)
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax

    try:
        jax.config.update("jax_platforms", "cpu")
    except Exception:  # backend already initialized in a forked parent
        pass
    import go_dicom_codec_jax as dc

    try:
        signed = False
        if fixture == "clinical":
            img, signed = _clinical_fixture(bits, samples)
            height, width = img.shape[:2]
        else:
            img = _make_fixture(width, height, bits, samples, seed)
        info = dc.FrameInfo(
            width=width, height=height,
            bits_allocated=8 if bits <= 8 else 16, bits_stored=bits,
            samples_per_pixel=samples,
            pixel_representation=1 if signed else 0,
            photometric_interpretation="RGB" if samples == 3 else
            "MONOCHROME2")
        src = dc.MemoryPixelData(info=info)
        src.add_frame(img.tobytes())
        codec = dc.get_global_registry().get_codec(uid)
        enc = dc.MemoryPixelData(info=info, encapsulated=True)
        codec.encode(src, enc,
                     dc.Parameters(**enc_params) if enc_params else None)
        dec = dc.MemoryPixelData(info=info)
        codec.decode(enc, dec)
        got = np.frombuffer(dec.get_frame(0), dtype=img.dtype)
        err = np.abs(got.astype(np.int64)
                     - img.reshape(-1).astype(np.int64)).max()
        ratio = len(src.get_frame(0)) / max(len(enc.get_frame(0)), 1)
        if err > tol:
            return (label, False, f"maxerr={err} exceeds tol={tol}")
        detail = f"maxerr={err} tol={tol} ratio={ratio:.2f}x"
        if oracle == "pil" and label in PIL_DECODABLE and not signed:
            ok, ferr = _pil_check(enc.get_frame(0), img, bits, tol)
            if not ok:
                return (label, False,
                        f"foreign(PIL) maxerr={ferr} exceeds tol={tol}")
            detail += f" foreign(PIL) maxerr={ferr}"
        if uid in ("1.2.840.10008.1.2.4.90", "1.2.840.10008.1.2.4.92",
                   "1.2.840.10008.1.2.4.201", "1.2.840.10008.1.2.4.202"):
            # multi-frame lane: the batched encode/decode pipelines must
            # produce the same streams as per-frame encodes and decode
            # every frame exactly (lossless J2K/HT adapters batch)
            wrng = np.random.default_rng(seed + 1)
            frames = [img]
            for _ in range(2):
                f2 = np.clip(img.astype(np.int64)
                             + wrng.integers(-3, 4, img.shape),
                             0, (1 << bits) - 1).astype(img.dtype)
                frames.append(f2)
            mf = dc.MemoryPixelData(info=info)
            for f in frames:
                mf.add_frame(f.tobytes())
            menc = dc.MemoryPixelData(info=info, encapsulated=True)
            codec.encode(mf, menc,
                         dc.Parameters(**enc_params) if enc_params
                         else None)
            for i, f in enumerate(frames):
                one = dc.MemoryPixelData(info=info)
                one.add_frame(f.tobytes())
                oenc = dc.MemoryPixelData(info=info, encapsulated=True)
                codec.encode(one, oenc,
                             dc.Parameters(**enc_params) if enc_params
                             else None)
                if menc.get_frame(i) != oenc.get_frame(0):
                    return (label, False,
                            f"multiframe stream {i} != per-frame encode")
            mdec = dc.MemoryPixelData(info=info)
            codec.decode(menc, mdec)
            for i, f in enumerate(frames):
                g = np.frombuffer(mdec.get_frame(i), dtype=img.dtype)
                if np.abs(g.astype(np.int64)
                          - f.reshape(-1).astype(np.int64)).max() > tol:
                    return (label, False,
                            f"multiframe decode {i} exceeds tol={tol}")
            detail += " mf=3frames-ok"
        return (label, True, detail)
    except Exception as e:  # noqa: BLE001
        return (label, False, f"{type(e).__name__}: {e}")


def main(argv: Optional[List[str]] = None) -> int:
    import os

    # inherited by the worker processes: a worker pool must not share
    # one GPU between several JAX processes (one process per card)
    os.environ["JAX_PLATFORMS"] = "cpu"
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--parallel", type=int, default=4,
                    help="worker processes (reference --parallel)")
    ap.add_argument("--formats", type=str, default="",
                    help="comma-separated labels to run (default: all)")
    ap.add_argument("--size", type=str, default="96x80")
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--oracle", type=str, default="self",
                    choices=("self", "pil"),
                    help="'pil': also decode streams with PIL "
                         "(libjpeg/OpenJPEG foreign oracle)")
    ap.add_argument("--fixture", type=str, default="synthetic",
                    choices=("synthetic", "clinical"),
                    help="'clinical': real XR/CT/MR pixels from "
                         "test-data/clinical_pixels.npz")
    opts = ap.parse_args(argv)

    width, height = (int(v) for v in opts.size.split("x"))
    wanted = set(opts.formats.split(",")) if opts.formats else None
    jobs = [(row[0], row[1], row[2], row[3], row[4], width, height,
             opts.seed, opts.oracle, opts.fixture,
             row[5] if len(row) > 5 else None)
            for row in FORMAT_DEFINITIONS
            if wanted is None or row[0] in wanted]

    failures = 0
    # spawn (not fork): workers need a fresh interpreter so the
    # cpu-platform env guards in run_format take effect.
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with ProcessPoolExecutor(max_workers=max(opts.parallel, 1),
                             mp_context=ctx) as pool:
        for label, ok, detail in pool.map(run_format, jobs):
            status = "pass" if ok else "fail"
            print(f"INTEROP|{status}|format={label}|{detail}")
            if not ok:
                failures += 1
    print(f"INTEROP|done|formats={len(jobs)}|failures={failures}")
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
