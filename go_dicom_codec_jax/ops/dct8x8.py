"""Batched 8×8 DCT/IDCT + quantization on device.

Role of reference jpeg/standard/{dct.go,dct_ijg.go,dct12.go,idct*.go} and
the per-block quantize loops (jpeg/baseline/encoder.go:440-468), whole
MCU grid per launch.

The codec path (encode_plane_to_zigzag / decode_zigzag_to_plane) runs
the integer IJG islow butterflies (ops/dct_int.py), so lossy JPEG streams
are byte-identical on every lane — jit, numpy, native (the determinism
invariant, CLAUDE.md). There is no float DCT in this module.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

# Zigzag scan order (T.81 Figure A.6): index i → raster position ZIGZAG[i].
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
], dtype=np.int32)
INV_ZIGZAG = np.argsort(ZIGZAG).astype(np.int32)


def to_blocks(plane: jnp.ndarray) -> jnp.ndarray:
    """[..., H, W] (H,W multiples of 8) → [..., H/8, W/8, 8, 8]."""
    h, w = plane.shape[-2], plane.shape[-1]
    lead = plane.shape[:-2]
    x = plane.reshape(lead + (h // 8, 8, w // 8, 8))
    return jnp.swapaxes(x, -3, -2)


def from_blocks(blocks: jnp.ndarray) -> jnp.ndarray:
    """Inverse of to_blocks."""
    lead = blocks.shape[:-4]
    nby, nbx = blocks.shape[-4], blocks.shape[-3]
    x = jnp.swapaxes(blocks, -3, -2)
    return x.reshape(lead + (nby * 8, nbx * 8))


def pad_replicate_to_8(plane: jnp.ndarray) -> jnp.ndarray:
    """Edge-replicate the last two dims up to multiples of 8.

    Matches the reference's edge-clamped block extraction
    (jpeg/baseline/encoder.go:443-449, rgbToYCbCr :351-355).
    """
    h, w = plane.shape[-2], plane.shape[-1]
    ph, pw = (-h) % 8, (-w) % 8
    if ph == 0 and pw == 0:
        return plane
    pad = [(0, 0)] * (plane.ndim - 2) + [(0, ph), (0, pw)]
    return jnp.pad(plane, pad, mode="edge")


def zigzag_scan(blocks: jnp.ndarray) -> jnp.ndarray:
    """[..., 8, 8] → [..., 64] in zigzag order."""
    flat = blocks.reshape(blocks.shape[:-2] + (64,))
    return flat[..., jnp.asarray(ZIGZAG)]


def inv_zigzag_scan(zz: jnp.ndarray) -> jnp.ndarray:
    """[..., 64] zigzag → [..., 8, 8] raster."""
    return zz[..., jnp.asarray(INV_ZIGZAG)].reshape(zz.shape[:-1] + (8, 8))


# ---- RGB ↔ YCbCr (JFIF fixed point, reference baseline/encoder.go:343-373,
#      decoder.go:576-588) ---------------------------------------------------

def rgb_to_ycbcr(rgb: jnp.ndarray) -> jnp.ndarray:
    """[..., H, W, 3] uint8 → [..., H, W, 3] uint8, bit-exact fixed point."""
    r = rgb[..., 0].astype(jnp.int32)
    g = rgb[..., 1].astype(jnp.int32)
    b = rgb[..., 2].astype(jnp.int32)
    y = (19595 * r + 38470 * g + 7471 * b + 32768) >> 16
    cb = (-11056 * r - 21712 * g + 32768 * b + 8421376) >> 16
    cr = (32768 * r - 27440 * g - 5328 * b + 8421376) >> 16
    out = jnp.stack([y, cb, cr], axis=-1)
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


def ycbcr_to_rgb(ycc: jnp.ndarray) -> jnp.ndarray:
    """[..., H, W, 3] uint8 → RGB uint8, bit-exact fixed point."""
    y = ycc[..., 0].astype(jnp.int32)
    cb = ycc[..., 1].astype(jnp.int32) - 128
    cr = ycc[..., 2].astype(jnp.int32) - 128
    r = y + ((91881 * cr) >> 16)
    g = y - ((22554 * cb + 46802 * cr) >> 16)
    b = y + ((116130 * cb) >> 16)
    out = jnp.stack([r, g, b], axis=-1)
    return jnp.clip(out, 0, 255).astype(jnp.uint8)


def rgb_to_ycbcr_np(rgb: np.ndarray) -> np.ndarray:
    """Host numpy mirror of rgb_to_ycbcr (bit-exact: pure integer math)."""
    r = rgb[..., 0].astype(np.int32)
    g = rgb[..., 1].astype(np.int32)
    b = rgb[..., 2].astype(np.int32)
    y = (19595 * r + 38470 * g + 7471 * b + 32768) >> 16
    cb = (-11056 * r - 21712 * g + 32768 * b + 8421376) >> 16
    cr = (32768 * r - 27440 * g - 5328 * b + 8421376) >> 16
    out = np.stack([y, cb, cr], axis=-1)
    return np.clip(out, 0, 255).astype(np.uint8)


def ycbcr_to_rgb_np(ycc: np.ndarray) -> np.ndarray:
    """Host numpy mirror of ycbcr_to_rgb (bit-exact: pure integer math)."""
    y = ycc[..., 0].astype(np.int32)
    cb = ycc[..., 1].astype(np.int32) - 128
    cr = ycc[..., 2].astype(np.int32) - 128
    r = y + ((91881 * cr) >> 16)
    g = y - ((22554 * cb + 46802 * cr) >> 16)
    b = y + ((116130 * cb) >> 16)
    out = np.stack([r, g, b], axis=-1)
    return np.clip(out, 0, 255).astype(np.uint8)


@partial(jax.jit, static_argnames=("level_shift",))
def encode_plane_to_zigzag(plane: jnp.ndarray, qtable: jnp.ndarray,
                           level_shift: int = 128) -> jnp.ndarray:
    """One launch: pad → blocks → integer islow DCT → quant → zigzag.

    plane: [..., H, W] integer samples. Returns [..., nby, nbx, 64] int32.

    Uses the integer IJG DCT (ops/dct_int.py, reference dct_ijg.go) so the
    result is byte-identical to the numpy and native host lanes on every
    backend — lossy JPEG streams are deterministic across lanes.
    """
    from . import dct_int
    p = pad_replicate_to_8(plane).astype(jnp.int32) - level_shift
    blocks = to_blocks(p)
    f = dct_int.fdct8x8_islow(blocks, jnp,
                              p1=dct_int.pass1_bits(level_shift))
    q = dct_int.quantize_islow(f, qtable, jnp)
    return zigzag_scan(q)


@partial(jax.jit, static_argnames=("level_shift", "max_val"))
def decode_zigzag_to_plane(zz: jnp.ndarray, qtable: jnp.ndarray,
                           level_shift: int = 128,
                           max_val: int = 255) -> jnp.ndarray:
    """One launch: inv-zigzag → integer islow dequant+IDCT → shift → clamp.

    zz: [..., nby, nbx, 64] int32. Returns [..., H, W] int32 in [0, max_val].
    Integer IJG inverse (reference idct_ijg.go) — deterministic across
    lanes, see encode_plane_to_zigzag.
    """
    from . import dct_int
    blocks = inv_zigzag_scan(zz).astype(jnp.int32)
    s = dct_int.idct8x8_islow(blocks, jnp.asarray(qtable), jnp,
                              p1=dct_int.pass1_bits(level_shift)
                              ) + level_shift
    plane = from_blocks(s)
    return jnp.clip(plane, 0, max_val)


def encode_plane_to_zigzag_np(plane: np.ndarray, qtable: np.ndarray,
                              level_shift: int = 128) -> np.ndarray:
    """numpy mirror of encode_plane_to_zigzag (bit-identical)."""
    from . import dct_int
    h, w = plane.shape[-2:]
    ph, pw = (-h) % 8, (-w) % 8
    p = plane
    if ph or pw:
        pad = [(0, 0)] * (plane.ndim - 2) + [(0, ph), (0, pw)]
        p = np.pad(plane, pad, mode="edge")
    p = p.astype(np.int32) - level_shift
    hh, ww = p.shape[-2:]
    lead = p.shape[:-2]
    blocks = p.reshape(lead + (hh // 8, 8, ww // 8, 8)).swapaxes(-3, -2)
    f = dct_int.fdct8x8_islow(blocks, np,
                              p1=dct_int.pass1_bits(level_shift))
    q = dct_int.quantize_islow(f, np.asarray(qtable, dtype=np.int32), np)
    flat = q.reshape(q.shape[:-2] + (64,))
    return flat[..., ZIGZAG]


def decode_zigzag_to_plane_np(zz: np.ndarray, qtable: np.ndarray,
                              level_shift: int = 128,
                              max_val: int = 255) -> np.ndarray:
    """numpy mirror of decode_zigzag_to_plane (bit-identical)."""
    from . import dct_int
    blocks = (zz[..., INV_ZIGZAG].reshape(zz.shape[:-1] + (8, 8))
              .astype(np.int32))
    s = dct_int.idct8x8_islow(blocks, np.asarray(qtable, dtype=np.int32),
                              np, p1=dct_int.pass1_bits(level_shift)
                              ) + level_shift
    lead = s.shape[:-4]
    nby, nbx = s.shape[-4], s.shape[-3]
    plane = s.swapaxes(-3, -2).reshape(lead + (nby * 8, nbx * 8))
    return np.clip(plane, 0, max_val)
