"""Device-side kernel benchmarks beyond the bench.py headline.

Measures the device transform stages with the same device-resident
lax.fori_loop chaining bench.py uses (dispatch latency amortized):

  - 5/3 DWT + codeblock stats (the headline, for reference)
  - 9/7 DWT + per-band deadzone quantization (the lossy device stage —
    the north star says DWT+quant)
  - 8x8 DCT + quant + zigzag grid (JPEG baseline/extended device stage)
  - RCT and ICT color transforms
  - x+1 copy (the memory-bound ceiling for this shape)

Usage:
    python -m go_dicom_codec_jax.tools.device_bench [--batch N]
        [--size WxH] [--iters N]

Prints the device it runs on (JAX's platform, device kind and count,
and nvidia-smi's card name and power limit when there is a GPU), then
one BENCH| JSON line per kernel. Without a GPU it runs on whatever
JAX_PLATFORMS selects, and its lines say so.
"""

from __future__ import annotations

import argparse
import json
import time

import jax
import jax.numpy as jnp
import numpy as np


def _chain(body_fn, iters):
    """Wrap a [B,H,W]→[B,H,W] step into an iters-long on-device loop."""

    def run(x):
        def body(_, carry):
            y, acc = carry
            y2, probe = body_fn(y)
            return y2, acc + probe
        return jax.lax.fori_loop(0, iters, body, (x, jnp.float32(0)))

    return jax.jit(run)


def _measure(jfn, x, px_per_iter, iters, repeats=3):
    jax.block_until_ready(jfn(x))  # compile + warm
    best = None
    for _ in range(repeats):
        t0 = time.perf_counter()
        jax.block_until_ready(jfn(x))
        dt = time.perf_counter() - t0
        best = dt if best is None else min(best, dt)
    return px_per_iter * iters / best / 1e6


def main(argv=None) -> int:
    from ..utils.compile_cache import enable_compile_cache
    from ..utils.device_info import device_summary, gpu_name_and_power_limit

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--size", type=str, default="512x512")
    ap.add_argument("--iters", type=int, default=20)
    opts = ap.parse_args(argv)
    enable_compile_cache()
    device = device_summary()
    print(f"device: {device}; nvidia-smi: {gpu_name_and_power_limit()}")
    w, h = (int(v) for v in opts.size.split("x"))
    b, iters = opts.batch, opts.iters
    px = b * h * w

    from ..ops.blockstats import codeblock_max_abs, max_bitplane
    from ..ops.dct8x8 import decode_zigzag_to_plane, encode_plane_to_zigzag
    from ..ops.dwt53 import fwd53_multilevel, inv53_multilevel
    from ..ops.dwt97 import fwd97_multilevel, inv97_multilevel
    from ..ops.mct import ict_forward, rct_forward
    from ..codecs import jpeg_common as jc
    from ..codecs import j2k_quant as jq

    rng = np.random.default_rng(0)
    xi = jnp.asarray(rng.integers(0, 1 << 12, size=(b, h, w),
                                  dtype=np.int32))
    xf = xi.astype(jnp.float32)
    qtable = jnp.asarray(jc.scale_quant_table(jc.LUMA_QUANT, 90, 255))
    steps = jq.step_sizes_97(5, 85)

    def dwt53_stats(x):
        c = fwd53_multilevel(x, 5)
        m = codeblock_max_abs(c, 64, 64)
        return c, jnp.sum(max_bitplane(m)).astype(jnp.float32)

    def dwt97_quant(x):
        c = fwd97_multilevel(x, 5)
        # single representative deadzone step (per-band slicing is a
        # host-side gather; the arithmetic cost is identical)
        q = jnp.sign(c) * jnp.floor(jnp.abs(c) / np.float32(steps[0] * 4096))
        return q.astype(jnp.float32), jnp.sum(q[:, :1, :1])

    def dct_grid(x):
        zz = jax.vmap(lambda p: encode_plane_to_zigzag(
            p, qtable, level_shift=2048))(x.astype(jnp.int32))
        y = x + 1  # keep the carry shape; zz feeds the probe
        return y, jnp.sum(zz).astype(jnp.float32)

    def rct(x):
        r_, g_, b_ = x, x + 1, x + 2
        y, u, v = rct_forward(r_, g_, b_)
        return y, jnp.sum(v[:, :1, :1]).astype(jnp.float32)

    def ict(x):
        y, cb, cr = ict_forward(x, x + 1.0, x + 2.0)
        return y, jnp.sum(cr[:, :1, :1])

    def idwt53(x):
        r = inv53_multilevel(x, 5)
        return r, jnp.sum(r[:, :1, :1]).astype(jnp.float32)

    def idwt97_dequant(x):
        c = x * np.float32(steps[0] * 4096)   # dequant multiply
        r = inv97_multilevel(c, 5)
        return r, jnp.sum(r[:, :1, :1])

    def idct_grid(x):
        zz = x.reshape(b, h // 8, w // 8, 64).astype(jnp.int32)
        p = jax.vmap(lambda z: decode_zigzag_to_plane(
            z, qtable, level_shift=2048, max_val=4095))(zz)
        return x + 1, jnp.sum(p).astype(jnp.float32)

    def copy(x):
        y = x + 1
        return y, jnp.sum(y[:, :1, :1]).astype(jnp.float32)

    kernels = [
        ("dwt53_stats", dwt53_stats, xi),
        ("idwt53", idwt53, xi),
        ("dwt97_deadzone_quant", dwt97_quant, xf),
        ("idwt97_dequant", idwt97_dequant, xf),
        ("dct8x8_quant_zigzag", dct_grid, xi),
        ("idct8x8_dequant", idct_grid, xi),
        ("rct_forward", rct, xi),
        ("ict_forward", ict, xf),
        ("xplus1_ceiling", copy, xi),
    ]
    for name, fn, x in kernels:
        mpx = _measure(_chain(fn, iters), x, px, iters)
        print("BENCH|" + json.dumps({
            "kernel": name, "mpx_per_s": round(mpx, 1),
            "batch": b, "size": f"{w}x{h}", "iters": iters,
            "device": device}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
