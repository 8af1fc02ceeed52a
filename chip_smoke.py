#!/usr/bin/env python
"""Smoke run of the codec registry's device paths on a GPU.

Drives the public registry (``get_global_registry().get_codec(uid)``
``.encode``/``.decode`` on ``MemoryPixelData``) at real size: a seeded
synthetic CT series of 64 slices of 512×512, 12 bits stored in 16, and
8-frame series made by seeded perturbation of each real clinical frame in
``test-data/clinical_pixels.npz`` (MR s16 888×459, XR u8 1100×852, CT u12
288×288). One phase per device path; each compares the registry's output
with a reference that does not use the device lane:

  j2k_lossless      UID .90 multi-frame encode + decode (pipelined 5/3)
                    vs the source pixels and the host-lane pipelines
  htj2k_lossless    UID .201 per-frame encode, multi-frame decode
                    vs the source pixels and the host-lane decode
  j2k_lossy_decode  UID .91 encode, multi-frame decode (device 9/7)
                    within ±1 of the host-lane decode
  jpeg_baseline     UIDs .50 (8-bit) and .51 (12-bit) multi-frame encode
                    (device integer DCT) vs the per-frame numpy lane
  rle               UID .5 multi-frame encode + decode (device planes)
                    vs the per-frame host coder and the source pixels
  part2_mct         UID .92 with a custom integer matrix on a 3-component
                    16-bit series vs the same encode on the CPU device

Each phase runs twice; the first (cold) time includes compilation.
Before the phases it prints JAX's devices, nvidia-smi's card name and
power limit, the JAX versions, the native library's build, the transfer
policy's decision and the compile-cache directory.

``--multi-card`` runs only the frame-sharded mesh path on four cards
(``parallel.mesh.encode_frames_sharded`` / ``decode_frames_sharded``) and
compares it with the one-card pipeline.

The last stdout line is one JSON object, ``{"ok": ..., "device": {...}}``.
The exit code is 0 only when the default backend is a GPU, the native
library loaded, the transfer policy chose the device lane and every
comparison held.

Usage: python chip_smoke.py [--multi-card]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback

import numpy as np

import go_dicom_codec_jax as dc
from go_dicom_codec_jax import testdata

HERE = os.path.dirname(os.path.abspath(__file__))
CLINICAL = os.path.join(HERE, "test-data", "clinical_pixels.npz")

SERIES_FRAMES, SERIES_SIZE, SERIES_BITS = 64, 512, 12
CLINICAL_FRAMES = 8
MESH_CARDS = 4
# Part 2: a unimodular integer matrix (integer inverse) over 16-bit
# samples; the DC-shifted samples need all 16 bits, so a float32
# contraction with fewer mantissa bits (TF32) would change the result
MCT_MATRIX = [[1.0, 1.0, 0.0], [0.0, 1.0, 0.0], [0.0, -1.0, 1.0]]
MCT_INVERSE = [[1.0, -1.0, 0.0], [0.0, 1.0, 0.0], [0.0, 1.0, 1.0]]


class Series:
    """One multi-frame input: ``frames`` [F, H, W] or [F, H, W, C]."""

    def __init__(self, name: str, frames: np.ndarray, bits: int,
                 signed: bool = False):
        self.name, self.frames, self.bits, self.signed = (name, frames,
                                                          bits, signed)
        self.info = dc.FrameInfo(
            width=frames.shape[2], height=frames.shape[1],
            bits_allocated=frames.dtype.itemsize * 8, bits_stored=bits,
            samples_per_pixel=frames.shape[3] if frames.ndim == 4 else 1,
            photometric_interpretation=("RGB" if frames.ndim == 4
                                        else "MONOCHROME2"),
            pixel_representation=int(signed))

    def pixel_data(self) -> dc.MemoryPixelData:
        pd = dc.MemoryPixelData(info=self.info)
        for f in self.frames:
            pd.add_frame(np.ascontiguousarray(f).tobytes())
        return pd

    def with_bits(self, bits: int) -> "Series":
        """The same content rescaled to ``bits`` unsigned bits."""
        shift = self.bits - bits
        dt = np.uint8 if bits <= 8 else np.dtype("<u2")
        return Series(f"{self.name}>{bits}b",
                      (self.frames.astype(np.int64) >> shift).astype(dt),
                      bits)


def perturbed(base: np.ndarray, n: int, bits: int, signed: bool,
              seed: int) -> np.ndarray:
    """n frames: ``base`` and n-1 seeded ±2 perturbations of it, clipped
    to the declared range."""
    rng = np.random.default_rng(seed)
    lo, hi = ((-(1 << (bits - 1)), (1 << (bits - 1)) - 1) if signed
              else (0, (1 << bits) - 1))
    out = [base.astype(np.int64)]
    for _ in range(n - 1):
        out.append(np.clip(base + rng.integers(-2, 3, base.shape), lo, hi))
    return np.stack(out).astype(base.dtype)


def ct_series(frames: int = SERIES_FRAMES, size: int = SERIES_SIZE,
              seed: int = 0) -> Series:
    """Seeded synthetic CT series: clinical-like texture, shifted per
    slice, plus noise; 12 bits stored in 16."""
    rng = np.random.default_rng(seed)
    base = testdata.textured_image(size + frames, size, SERIES_BITS)
    hi = (1 << SERIES_BITS) - 1
    out = np.stack([
        np.clip(base[:, k:k + size] + rng.integers(-24, 25, (size, size)),
                0, hi) for k in range(frames)])
    return Series(f"ct{frames}x{size}", out.astype("<u2"), SERIES_BITS)


def clinical_series(frames: int = CLINICAL_FRAMES, seed: int = 1,
                    crop: int = 0) -> list:
    """8-frame series from each real clinical frame (``crop`` > 0 cuts
    every frame to at most crop×crop, for small runs)."""
    data = np.load(CLINICAL)
    out = []
    for key in ("mr_s16", "xr_u8", "ct_u12"):
        bits, signed = (int(v) for v in data[key + "_meta"])
        base = data[key]
        if crop:
            base = base[:crop, :crop - 3]      # odd widths stay odd
        out.append(Series(key, perturbed(base, frames, bits, bool(signed),
                                         seed), bits, bool(signed)))
    return out


def rgb16_series(frames: int = 8, size: int = SERIES_SIZE,
                 seed: int = 2) -> Series:
    """3-component 16-bit series for the Part 2 custom-matrix path."""
    base = testdata.rgb_pattern_image(size, size, 16)
    return Series(f"rgb16_{frames}x{size}",
                  perturbed(base, frames, 16, False, seed).astype("<u2"),
                  16)


# ---------------------------------------------------------------- helpers

def _codec(uid: str):
    return dc.get_global_registry().get_codec(uid)


def _encode(uid: str, series: Series, parameters=None) -> list:
    enc = dc.MemoryPixelData(info=series.info, encapsulated=True)
    _codec(uid).encode(series.pixel_data(), enc, parameters)
    return [enc.get_frame(i) for i in range(enc.frame_count())]


def _decode(uid: str, series: Series, streams: list) -> list:
    src = dc.MemoryPixelData(info=series.info, encapsulated=True)
    for s in streams:
        src.add_frame(s)
    out = dc.MemoryPixelData(info=series.info)
    _codec(uid).decode(src, out)
    return [out.get_frame(i) for i in range(out.frame_count())]


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def _check_pixels(series: Series, frames: list, what: str) -> None:
    _check(len(frames) == len(series.frames), f"{what}: frame count")
    for k, (got, want) in enumerate(zip(frames, series.frames)):
        _check(got == np.ascontiguousarray(want).tobytes(),
               f"{what}: frame {k} differs from the source")


def _check_arrays(a: list, b: list, what: str, tol: int = 0) -> int:
    _check(len(a) == len(b), f"{what}: frame count")
    worst = 0
    for x, y in zip(a, b):
        worst = max(worst, int(np.max(np.abs(
            np.asarray(x, np.int64) - np.asarray(y, np.int64)))))
    _check(worst <= tol, f"{what}: max abs diff {worst} > {tol}")
    return worst


def _as_planes(series: Series, frames: list) -> np.ndarray:
    dt = series.frames.dtype
    return np.stack([np.frombuffer(f, dtype=dt).reshape(
        series.frames.shape[1:]) for f in frames])


def _psnr(series: Series, got: np.ndarray) -> float:
    err = got.astype(np.float64) - series.frames.astype(np.float64)
    mse = float(np.mean(err * err))
    peak = float((1 << series.bits) - 1)
    return float("inf") if mse == 0 else 10 * np.log10(peak * peak / mse)


# ----------------------------------------------------------------- phases

def phase_j2k_lossless(series_list: list) -> list:
    from go_dicom_codec_jax.codecs.j2k_adapters import _params_from
    from go_dicom_codec_jax.pipeline import (decode_frames_pipelined,
                                             encode_frames_pipelined)

    notes = []
    for s in series_list:
        streams = _encode(dc.uids.JPEG_2000_LOSSLESS, s)
        host = encode_frames_pipelined(
            s.frames, bit_depth=s.bits, signed=s.signed,
            params=_params_from(None, lossless=True), device="host")
        _check(streams == host,
               f"{s.name}: .90 streams differ from the host lane")
        _check_pixels(s, _decode(dc.uids.JPEG_2000_LOSSLESS, s, streams),
                      f"{s.name}: .90 decode")
        _check_arrays(decode_frames_pipelined(streams),
                      decode_frames_pipelined(streams, device="host"),
                      f"{s.name}: .90 device vs host decode")
        notes.append(f"{s.name} {sum(map(len, streams))} B")
    return notes


def phase_htj2k_lossless(series_list: list) -> list:
    from go_dicom_codec_jax.pipeline import decode_frames_pipelined

    notes = []
    for s in series_list:
        streams = _encode(dc.uids.HTJ2K_LOSSLESS, s)
        _check_pixels(s, _decode(dc.uids.HTJ2K_LOSSLESS, s, streams),
                      f"{s.name}: .201 decode")
        _check_arrays(decode_frames_pipelined(streams),
                      decode_frames_pipelined(streams, device="host"),
                      f"{s.name}: .201 device vs host decode")
        notes.append(f"{s.name} {sum(map(len, streams))} B")
    return notes


def phase_j2k_lossy_decode(series_list: list) -> list:
    from go_dicom_codec_jax.pipeline import decode_frames_pipelined

    notes = []
    for s in series_list:
        if s.signed:
            continue            # .91 rejects signed pixels by design
        streams = _encode(dc.uids.JPEG_2000_LOSSY, s)
        got = _as_planes(s, _decode(dc.uids.JPEG_2000_LOSSY, s, streams))
        host = [f[..., 0] for f in
                decode_frames_pipelined(streams, device="host")]
        # ±1: the float 9/7 programs of two lanes may round a tie apart
        worst = _check_arrays(list(got), host,
                              f"{s.name}: .91 device vs host decode", tol=1)
        notes.append(f"{s.name} maxdiff {worst} PSNR {_psnr(s, got):.2f}"
                     " dB")
    return notes


def _jpeg_numpy_lane(frames: np.ndarray, quality: int,
                     precision: int) -> list:
    """Per-frame host reference for the batched JPEG encode: the numpy
    integer DCT, then the same Huffman/framing stage."""
    from go_dicom_codec_jax.codecs import jpeg_common as jc
    from go_dicom_codec_jax.codecs.jpeg_baseline import encode_from_zigzag
    from go_dicom_codec_jax.codestream import jpeg_markers as mk
    from go_dicom_codec_jax.ops.dct8x8 import encode_plane_to_zigzag_np

    qtable = jc.scale_quant_table(jc.LUMA_QUANT, quality, 255)
    level = 1 << (precision - 1)
    h, w = frames.shape[1:]
    return [encode_from_zigzag(
        [encode_plane_to_zigzag_np(f, qtable, level).reshape(-1, 64)],
        [qtable], [0], w, h, 1, precision=precision,
        sof_marker=mk.SOF0 if precision <= 8 else mk.SOF1,
        write_jfif=precision > 8) for f in frames]


def phase_jpeg_baseline(series_list: list) -> list:
    from go_dicom_codec_jax.pipeline import encode_frames_pipelined_jpeg

    quality = 90               # the registry codecs' default
    uids = {8: dc.uids.JPEG_BASELINE_8BIT, 12: dc.uids.JPEG_EXTENDED_12BIT}
    notes = []
    for s in series_list:
        if s.signed or s.bits not in uids:
            continue
        ref = _jpeg_numpy_lane(s.frames, quality, s.bits)
        _check(_encode(uids[s.bits], s) == ref,
               f"{s.name}: {uids[s.bits]} streams differ from the numpy "
               "lane")
        _check(encode_frames_pipelined_jpeg(s.frames, quality,
                                            s.bits) == ref,
               f"{s.name}: batched device streams differ from the numpy "
               "lane")
        notes.append(f"{s.name} {sum(map(len, ref))} B")
    return notes


def phase_rle(series_list: list) -> list:
    from go_dicom_codec_jax.codecs import rle

    notes = []
    for s in series_list:
        raw = [np.ascontiguousarray(f).tobytes() for f in s.frames]
        ref = [rle.encode_frame(f, s.info) for f in raw]
        streams = _encode(dc.uids.RLE_LOSSLESS, s)
        _check(streams == ref, f"{s.name}: .5 streams differ from host")
        _check(rle.encode_frames_batched(raw, s.info) == ref,
               f"{s.name}: batched device streams differ from host")
        _check_pixels(s, _decode(dc.uids.RLE_LOSSLESS, s, streams),
                      f"{s.name}: .5 decode")
        _check_pixels(s, rle.decode_frames_batched(streams, s.info),
                      f"{s.name}: batched device decode")
        notes.append(f"{s.name} {sum(map(len, streams))} B")
    return notes


def phase_part2_mct(series_list: list) -> list:
    import jax

    params = dc.Parameters(mct_matrix=MCT_MATRIX, mct_inverse=MCT_INVERSE)
    notes = []
    for s in series_list:
        streams = _encode(dc.uids.JPEG_2000_MC_LOSSLESS, s, params)
        with jax.default_device(jax.devices("cpu")[0]):
            ref = _encode(dc.uids.JPEG_2000_MC_LOSSLESS, s, params)
        _check(streams == ref,
               f"{s.name}: .92 streams differ from the CPU device")
        _check_pixels(s, _decode(dc.uids.JPEG_2000_MC_LOSSLESS, s,
                                 streams), f"{s.name}: .92 decode")
        notes.append(f"{s.name} {sum(map(len, streams))} B")
    return notes


PHASES = {
    "j2k_lossless": phase_j2k_lossless,
    "htj2k_lossless": phase_htj2k_lossless,
    "j2k_lossy_decode": phase_j2k_lossy_decode,
    "jpeg_baseline": phase_jpeg_baseline,
    "rle": phase_rle,
    "part2_mct": phase_part2_mct,
}


def phase_multi_card(series: Series, mesh) -> list:
    """Frame-sharded mesh encode + decode vs the one-card pipeline."""
    from go_dicom_codec_jax.parallel.mesh import (decode_frames_sharded,
                                                  encode_frames_sharded)
    from go_dicom_codec_jax.pipeline import encode_frames_pipelined
    from go_dicom_codec_jax.utils.profiling import EVENTS

    sharded = encode_frames_sharded(series.frames, bit_depth=series.bits,
                                    mesh=mesh)
    enc_devices = EVENTS["mesh.sharded_tile_coeffs"]["shard_devices"]
    one_card = encode_frames_pipelined(series.frames, bit_depth=series.bits,
                                       device="device")
    _check(sharded == one_card,
           "sharded streams differ from the one-card pipeline")
    decoded = decode_frames_sharded(sharded, mesh=mesh)
    dec_devices = EVENTS["mesh.decode_frames_sharded"]["shard_devices"]
    _check_arrays([d[..., 0] for d in decoded], list(series.frames),
                  "sharded decode vs source")
    n = mesh.devices.size
    _check(len(set(enc_devices)) == n and len(set(dec_devices)) == n,
           f"output shards on {sorted(set(enc_devices))} and "
           f"{sorted(set(dec_devices))}, not on {n} distinct devices")
    return [f"encode output shards on {enc_devices}",
            f"decode output shards on {dec_devices}"]


# ------------------------------------------------------------------ checks

def check_backend(want_count: int = 1):
    """Error text when the default backend is not ``want_count`` GPUs."""
    from go_dicom_codec_jax.utils.device_info import device_summary

    d = device_summary()
    if d["platform"] != "gpu":
        return f"default backend is {d['platform']}, not gpu"
    if d["count"] < want_count:
        return f"{d['count']} GPU(s), need {want_count}"
    return None


def check_native():
    """Error text when the native entropy library did not load."""
    from go_dicom_codec_jax import native

    if native.get_lib() is None:
        return ("native library did not load (g++ build failed or "
                "GDCT_DISABLE_NATIVE set); the codecs would run the "
                "pure-Python coders")
    return None


def check_transfer_policy(policy: dict):
    """Error text when the transfer policy keeps the multi-frame paths
    on the host lane."""
    if not policy["prefer_device"]:
        return f"transfer policy chose the host lane: {policy['reason']}"
    return None


def _timed_phase(name: str, fn, failures: list) -> None:
    times = []
    for attempt in ("cold", "warm"):
        t0 = time.perf_counter()
        try:
            notes = fn()
        except Exception as exc:  # noqa: BLE001 — reported, run fails
            traceback.print_exc()
            failures.append(f"{name} ({attempt}): {exc}")
            print(f"phase {name}: FAILED ({attempt}): {exc}", flush=True)
            return
        times.append(time.perf_counter() - t0)
    print(f"phase {name}: ok; cold {times[0]:.3f} s, warm {times[1]:.3f} s;"
          f" {'; '.join(notes)}", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--multi-card", action="store_true",
                    help=f"run only the mesh path on {MESH_CARDS} cards")
    args = ap.parse_args(argv)

    import jax
    import jaxlib

    from go_dicom_codec_jax import native
    from go_dicom_codec_jax.pipeline import transfer_policy
    from go_dicom_codec_jax.utils.compile_cache import enable_compile_cache
    from go_dicom_codec_jax.utils.device_info import (
        device_summary, gpu_name_and_power_limit)

    cache_dir = enable_compile_cache()
    device = device_summary()
    want = MESH_CARDS if args.multi_card else 1

    def finish(error=None) -> int:
        result = {"ok": error is None, "device": device}
        if error is not None:
            result["error"] = error
        print(json.dumps(result))
        return 0 if error is None else 1

    print(f"jax.devices(): {jax.devices()}")
    print(f"platform {device['platform']}, kind {device['kind']}, "
          f"count {device['count']}")
    print("nvidia-smi --query-gpu=name,power.limit:")
    print(gpu_name_and_power_limit() or "(no nvidia-smi output)")
    print(f"jax {jax.__version__}, jaxlib {jaxlib.__version__}")
    error = check_backend(want)
    if error:
        return finish(error)
    print(f"compile cache: {cache_dir}")
    t0 = time.perf_counter()
    error = check_native()
    print(f"native: loaded={error is None} build={native.build_info()} "
          f"({time.perf_counter() - t0:.3f} s incl. load)")
    if error:
        return finish(error)
    policy = transfer_policy()
    print(f"transfer policy: prefer_device={policy['prefer_device']} "
          f"roundtrip_ms={policy['roundtrip_ms']} host_ms={policy['host_ms']}"
          f" ({policy['reason']})", flush=True)
    error = check_transfer_policy(policy)
    if error:
        return finish(error)

    failures = []
    t0 = time.perf_counter()
    series = ct_series()
    if args.multi_card:
        from go_dicom_codec_jax.parallel.mesh import make_mesh

        mesh = make_mesh(MESH_CARDS)
        print(f"set-up: series built in {time.perf_counter() - t0:.3f} s")
        _timed_phase("multi_card", lambda: phase_multi_card(series, mesh),
                     failures)
    else:
        everything = [series] + clinical_series()
        inputs = {name: everything for name in PHASES}
        inputs["jpeg_baseline"] = [series, series.with_bits(8),
                                   *everything[1:]]
        inputs["part2_mct"] = [rgb16_series()]
        print(f"set-up: series built in {time.perf_counter() - t0:.3f} s")
        for name, fn in PHASES.items():
            _timed_phase(name, lambda fn=fn, s=inputs[name]: fn(s),
                         failures)
    return finish("; ".join(failures) if failures else None)


if __name__ == "__main__":
    sys.exit(main())
