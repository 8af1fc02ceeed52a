#!/usr/bin/env python
"""Kernel benchmark: JPEG 2000 lossless DWT transform throughput.

Measures the device-side J2K encode transform (DC shift + multilevel 5/3
DWT + deadzone quant + per-codeblock max-bitplane stats) in Mpixels/s on
one GPU, plus the DECODE direction (dequant + multilevel inverse 5/3 +
inverse DC shift).

Method: iterations are chained device-resident inside ONE jit via
lax.fori_loop, so the number amortizes dispatch latency and reflects the
on-device rate; the same harness re-measures the x+1 memory-bound
ceiling for comparison. Each timing ends in jax.block_until_ready.

Quantization runs BEFORE the codeblock stats so one elementwise pass
feeds both consumers.

Refuses to run without a GPU. Prints the device it ran on (JAX's view
and nvidia-smi's name and power limit), then exactly one JSON line on
stdout (decode direction rides in the same line as decode_* fields).
"""

import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from go_dicom_codec_jax.ops.blockstats import codeblock_max_abs, max_bitplane
from go_dicom_codec_jax.ops.dwt53 import fwd53_multilevel, inv53_multilevel
from go_dicom_codec_jax.ops.mct import dc_level_shift, inv_dc_level_shift
from go_dicom_codec_jax.utils.compile_cache import enable_compile_cache
from go_dicom_codec_jax.utils.device_info import (device_summary,
                                                  gpu_name_and_power_limit)

BATCH, H, W, LEVELS, ITERS = 32, 512, 512, 5, 30


def _chained_encode(x):
    """ITERS encode transform steps chained on device: one dispatch.

    DC shift + multilevel 5/3 + deadzone quant (sign-magnitude with a
    fixed-point reciprocal step, the form the lossy path and PCRD slope
    scaling consume) + per-codeblock max/bitplane stats computed FROM
    the quantized magnitudes (what the entropy stage actually codes).
    """

    def body(_, carry):
        frames, acc = carry
        s = dc_level_shift(frames, 16, False)
        c = fwd53_multilevel(s, LEVELS)
        mag = jnp.abs(c)
        q = jnp.sign(c) * ((mag * 32768) >> 16)
        m = codeblock_max_abs(q, 64, 64)
        bits = max_bitplane(m)
        # feed quantized coefficients back as the next batch (keeps the
        # loop device-resident); accumulate so nothing is dead code
        return q, acc + jnp.sum(bits.astype(jnp.int32)) + q[0, 0, 0]

    return jax.lax.fori_loop(0, ITERS, body, (x, jnp.int32(0)))


def _chained_decode(x):
    """ITERS decode transform steps: dequant + inverse 5/3 + inv shift +
    range clip — exactly the production decode epilogue
    (pack_decoded_pixels clips to the declared range). The clipped
    frame feeds back as the next batch (values stay <= 65535, so the
    dequant doubling never overflows int32); the old extra `>> 1` was
    loop plumbing, not decode work, and cost one full elementwise pass
    per iteration."""

    def body(_, carry):
        q, acc = carry
        c = q * 2                      # dequant multiply (Δ = 2)
        r = inv53_multilevel(c, LEVELS)
        p = inv_dc_level_shift(r, 16, False)
        return jnp.clip(p, 0, 65535), acc + p[0, 0, 0]

    return jax.lax.fori_loop(0, ITERS, body, (x, jnp.int32(0)))


def _chained_copy(x):
    """The x+1 ceiling measured with the identical chained harness."""

    def body(_, carry):
        frames, acc = carry
        y = frames + 1
        return y, acc + y[0, 0, 0]

    return jax.lax.fori_loop(0, ITERS, body, (x, jnp.int32(0)))


def _time_once(jfn, frames):
    t0 = time.perf_counter()
    jax.block_until_ready(jfn(frames))
    return time.perf_counter() - t0


def main() -> int:
    enable_compile_cache()
    device = device_summary()
    if device["platform"] != "gpu":
        print(f"bench.py needs a GPU; JAX reports {device}",
              file=sys.stderr)
        return 1
    print(f"device: {device}; nvidia-smi: {gpu_name_and_power_limit()}",
          file=sys.stderr)
    rng = np.random.default_rng(0)
    frames = jnp.asarray(rng.integers(0, 1 << 12, size=(BATCH, H, W),
                                      dtype=np.int32))

    fn = jax.jit(_chained_encode)
    fn_dec = jax.jit(_chained_decode)
    fn_copy = jax.jit(_chained_copy)
    for f in (fn, fn_dec, fn_copy):
        _time_once(f, frames)  # compile
    # interleaved rounds: ratios are taken within adjacent runs
    px = BATCH * H * W * ITERS
    best = {"enc": None, "dec": None, "ceil": None}
    enc_ratios, dec_ratios = [], []
    for _ in range(3):
        tc = _time_once(fn_copy, frames)
        te = _time_once(fn, frames)
        td = _time_once(fn_dec, frames)
        enc_ratios.append(tc / te)
        dec_ratios.append(tc / td)
        for k, t in (("enc", te), ("dec", td), ("ceil", tc)):
            best[k] = t if best[k] is None else min(best[k], t)
    mpx = px / best["enc"] / 1e6
    dec_mpx = px / best["dec"] / 1e6
    ceiling = px / best["ceil"] / 1e6
    eff = 100 * sorted(enc_ratios)[len(enc_ratios) // 2]
    deff = 100 * sorted(dec_ratios)[len(dec_ratios) // 2]
    print(f"x+1 ceiling (same chained harness): {ceiling:.0f} Mpx/s; "
          f"encode transform reaches {eff:.0f}% of it, decode "
          f"{deff:.0f}% (medians of interleaved triples)",
          file=sys.stderr)

    print(json.dumps({
        "metric": "j2k_dwt53_quant_stats_encode_throughput",
        "value": round(mpx, 1),
        "unit": "Mpx/s/chip",
        "decode_value": round(dec_mpx, 1),
        "decode_pct_of_ceiling": round(deff, 1),
        "encode_pct_of_ceiling": round(eff, 1),
        "device": device,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
