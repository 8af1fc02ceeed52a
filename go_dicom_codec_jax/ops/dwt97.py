"""Irreversible 9/7 CDF lifting DWT (ISO/IEC 15444-1 Annex F), as batched jnp.

Forward semantics match the reference's OpenJPEG float32 translation
(reference jpeg2000/wavelet/dwt97.go:47-160: α/β/γ/δ lifting with edge
clamps, K/invK normalization, vertical-first 2D, parity-aware windows),
re-expressed as whole-array float32 tensor algebra like ops/dwt53.py.

The inverse here is the exact mathematical mirror (low×K, high×1/K, then
negated lifting steps) rather than OpenJPEG's internally-compensated
two_invK variant (dwt97.go:192-223) — the codestream payload (quantized
indices + QCD steps) is identical either way, and roundtrip tests pin
reconstruction accuracy.
"""

from __future__ import annotations

from functools import partial
from typing import List, Tuple

import jax
import jax.numpy as jnp

from .dwt53 import _edge_left, _edge_right, _level_windows

ALPHA = -1.586134342
BETA = -0.052980118
GAMMA = 0.882911075
DELTA = 0.443506852
K = 1.230174105
INV_K = 0.812893066


def _predict_update(s, d, sn, dn, even: bool, c_pred: float, c_upd: float):
    """One (predict, update) lifting pair with OpenJPEG edge clamps."""
    if even:
        # d[i] += cp*(s[i] + s[i+1 clamped])
        s_next = _edge_right(s)[..., :dn]
        d = d + c_pred * (s[..., :dn] + s_next)
        # s[i] += cu*(d[i-1 clamped] + d[i clamped])
        d_prev, d_cur = _edge_left(d), d
        if sn == dn + 1:
            d_prev = jnp.concatenate([d_prev, d[..., -1:]], axis=-1)
            d_cur = jnp.concatenate([d_cur, d[..., -1:]], axis=-1)
        s = s + c_upd * (d_prev + d_cur)
    else:
        # d[i] += cp*(s[i-1 cl] + s[i cl])
        if dn == sn:
            s_im1, s_i = _edge_left(s), s
        else:  # dn == sn + 1
            s_im1 = jnp.concatenate([s[..., :1], s], axis=-1)
            s_i = jnp.concatenate([s, s[..., -1:]], axis=-1)
        d = d + c_pred * (s_im1 + s_i)
        # s[i] += cu*(d[i] + d[i+1 cl])
        d_i = d[..., :sn]
        d_ip1 = d[..., 1:sn + 1] if dn >= sn + 1 else _edge_right(d)
        s = s + c_upd * (d_i + d_ip1)
    return s, d


def fwd97_1d(x: jnp.ndarray, even: bool) -> jnp.ndarray:
    """Forward 9/7 along last axis → [L | H] packed, float32."""
    w = x.shape[-1]
    x = x.astype(jnp.float32)
    if w <= 1:
        return x
    if even:
        s, d = x[..., 0::2], x[..., 1::2]
    else:
        d, s = x[..., 0::2], x[..., 1::2]
    sn, dn = s.shape[-1], d.shape[-1]
    s, d = _predict_update(s, d, sn, dn, even, ALPHA, BETA)
    s, d = _predict_update(s, d, sn, dn, even, GAMMA, DELTA)
    return jnp.concatenate([s * INV_K, d * K], axis=-1)


def inv97_1d(x: jnp.ndarray, even: bool) -> jnp.ndarray:
    """Exact inverse of fwd97_1d."""
    w = x.shape[-1]
    x = x.astype(jnp.float32)
    if w <= 1:
        return x
    sn = (w + 1) // 2 if even else w // 2
    dn = w - sn
    s = x[..., :sn] * K
    d = x[..., sn:] * INV_K
    s, d = _predict_update(s, d, sn, dn, even, 0.0, -DELTA)
    s, d = _predict_update(s, d, sn, dn, even, -GAMMA, -BETA)
    s, d = _predict_update(s, d, sn, dn, even, -ALPHA, 0.0)
    out = jnp.zeros(x.shape, dtype=jnp.float32)
    if even:
        out = out.at[..., 0::2].set(s)
        out = out.at[..., 1::2].set(d)
    else:
        out = out.at[..., 0::2].set(d)
        out = out.at[..., 1::2].set(s)
    return out


def _cols(fn, x, even):
    return jnp.swapaxes(fn(jnp.swapaxes(x, -1, -2), even), -1, -2)


def fwd97_2d(x, even_row=True, even_col=True):
    """Vertical pass first, then horizontal (dwt97.go:290-323)."""
    if x.shape[-2] > 1:
        x = _cols(fwd97_1d, x, even_col)
    if x.shape[-1] > 1:
        x = fwd97_1d(x, even_row)
    return x


def inv97_2d(x, even_row=True, even_col=True):
    if x.shape[-1] > 1:
        x = inv97_1d(x, even_row)
    if x.shape[-2] > 1:
        x = _cols(inv97_1d, x, even_col)
    return x


def fwd97_multilevel(x: jnp.ndarray, levels: int, x0: int = 0,
                     y0: int = 0) -> jnp.ndarray:
    """Multilevel packed decomposition (dwt97.go:388-408), batched."""
    x = x.astype(jnp.float32)
    height, width = x.shape[-2], x.shape[-1]
    for (w, h, lx0, ly0) in _level_windows(width, height, levels, x0, y0):
        win = fwd97_2d(x[..., :h, :w], lx0 % 2 == 0, ly0 % 2 == 0)
        x = x.at[..., :h, :w].set(win)
    return x


def inv97_multilevel(x: jnp.ndarray, levels: int, x0: int = 0,
                     y0: int = 0) -> jnp.ndarray:
    x = x.astype(jnp.float32)
    height, width = x.shape[-2], x.shape[-1]
    for (w, h, lx0, ly0) in reversed(_level_windows(width, height, levels,
                                                    x0, y0)):
        win = inv97_2d(x[..., :h, :w], lx0 % 2 == 0, ly0 % 2 == 0)
        x = x.at[..., :h, :w].set(win)
    return x


# OpenJPEG 9/7 per-band L2 norms (reference quantization.go:17-22), used
# for step-size derivation.
DWT97_NORMS = (
    (1.000, 1.965, 4.177, 8.403, 16.90, 33.84, 67.69, 135.3, 270.6, 540.9),
    (2.022, 3.989, 8.355, 17.04, 34.27, 68.63, 137.3, 274.6, 549.0, 0.0),
    (2.022, 3.989, 8.355, 17.04, 34.27, 68.63, 137.3, 274.6, 549.0, 0.0),
    (2.080, 3.865, 8.307, 17.18, 34.71, 69.59, 139.3, 278.6, 557.2, 0.0),
)


def dwt97_norm(level: int, orient: int) -> float:
    level = max(level, 0)
    if orient == 0:
        level = min(level, 9)
    else:
        level = min(level, 8)
    if not (0 <= orient <= 3):
        return 1.0
    return DWT97_NORMS[orient][level]


# OpenJPEG 5/3 per-band L2 norms (opj_dwt_norms; reference
# quantization.go:10-15), used for NMSEDEC distortion weighting.
DWT53_NORMS = (
    (1.000, 1.500, 2.750, 5.375, 10.68, 21.34, 42.67, 85.33, 170.7, 341.3),
    (1.038, 1.592, 2.919, 5.703, 11.33, 22.64, 45.25, 90.48, 180.9, 0.0),
    (1.038, 1.592, 2.919, 5.703, 11.33, 22.64, 45.25, 90.48, 180.9, 0.0),
    (.7186, .9218, 1.586, 3.043, 6.019, 12.01, 24.00, 47.97, 95.93, 0.0),
)


def dwt53_norm(level: int, orient: int) -> float:
    level = max(level, 0)
    if orient == 0:
        level = min(level, 9)
    else:
        level = min(level, 8)
    if not (0 <= orient <= 3):
        return 1.0
    return DWT53_NORMS[orient][level]


@partial(jax.jit, static_argnames=("levels", "x0", "y0"))
def fwd97_multilevel_jit(x, levels: int, x0: int = 0, y0: int = 0):
    return fwd97_multilevel(x, levels, x0, y0)


@partial(jax.jit, static_argnames=("levels", "x0", "y0"))
def inv97_multilevel_jit(x, levels: int, x0: int = 0, y0: int = 0):
    return inv97_multilevel(x, levels, x0, y0)
