"""Multi-component transforms on device: RCT, ICT, DC level shift.

Reference semantics: reversible RCT (jpeg2000/colorspace/rct.go:6-48),
irreversible ICT float (colorspace/ict.go:8-44), DC level shift
(jpeg2000/encoder.go:3698). Batched over [..., H, W] component planes; the
per-pixel loops of the reference are whole-plane tensor ops.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def dc_level_shift(x: jnp.ndarray, bits: int, signed: bool) -> jnp.ndarray:
    """Forward DC shift: unsigned samples centered by -2^(bits-1)."""
    if signed:
        return x
    return x - (1 << (bits - 1))


def inv_dc_level_shift(x: jnp.ndarray, bits: int, signed: bool) -> jnp.ndarray:
    if signed:
        return x
    return x + (1 << (bits - 1))


def rct_forward(r: jnp.ndarray, g: jnp.ndarray, b: jnp.ndarray):
    """Reversible color transform, ISO 15444-1 G.1 (colorspace/rct.go:6-26).

    Y = (R + 2G + B) >> 2 (floor), U = B - G, V = R - G. Integer-exact.
    """
    y = (r + 2 * g + b) >> 2
    u = b - g
    v = r - g
    return y, u, v


def rct_inverse(y: jnp.ndarray, u: jnp.ndarray, v: jnp.ndarray):
    """Inverse RCT: G = Y - ((U + V) >> 2), R = V + G, B = U + G."""
    g = y - ((u + v) >> 2)
    r = v + g
    b = u + g
    return r, g, b


# ICT (irreversible, ISO 15444-1 G.2) coefficients as the reference uses
# them (colorspace/ict.go:9-27: truncated constants, round-to-int results).
_ICT_FWD = ((0.299, 0.587, 0.114),
            (-0.16875, -0.331260, 0.5),
            (0.5, -0.41869, -0.08131))
_ICT_INV_CR = 1.402
_ICT_INV_CB_G = -0.34413
_ICT_INV_CR_G = -0.71414
_ICT_INV_CB = 1.772


def ict_forward(r: jnp.ndarray, g: jnp.ndarray, b: jnp.ndarray):
    """Irreversible color transform → float32 (colorspace/ict.go:9-16).

    The reference computes in float64; float32 is the device's native
    width and the ICT path is lossy — roundtrip tolerance tests bound the
    difference.
    """
    rf = r.astype(jnp.float32)
    gf = g.astype(jnp.float32)
    bf = b.astype(jnp.float32)
    y = _ICT_FWD[0][0] * rf + _ICT_FWD[0][1] * gf + _ICT_FWD[0][2] * bf
    cb = _ICT_FWD[1][0] * rf + _ICT_FWD[1][1] * gf + _ICT_FWD[1][2] * bf
    cr = _ICT_FWD[2][0] * rf + _ICT_FWD[2][1] * gf + _ICT_FWD[2][2] * bf
    return y, cb, cr


def ict_inverse(y: jnp.ndarray, cb: jnp.ndarray, cr: jnp.ndarray):
    """Inverse ICT (colorspace/ict.go:19-24)."""
    r = y + _ICT_INV_CR * cr
    g = y + _ICT_INV_CB_G * cb + _ICT_INV_CR_G * cr
    b = y + _ICT_INV_CB * cb
    return r, g, b


def ict_forward_np(r, g, b):
    """numpy mirror of ict_forward for host fast paths (no device dispatch).

    Same float32 arithmetic/order as the jnp version; used by the native
    9/7 encode/decode paths in codecs/jpeg2000.py where the data already
    lives on the host and a per-tile device round trip would defeat the
    point of the fast path.
    """
    import numpy as _np
    rf = _np.asarray(r, dtype=_np.float32)
    gf = _np.asarray(g, dtype=_np.float32)
    bf = _np.asarray(b, dtype=_np.float32)
    y = _np.float32(_ICT_FWD[0][0]) * rf + _np.float32(_ICT_FWD[0][1]) * gf \
        + _np.float32(_ICT_FWD[0][2]) * bf
    cb = _np.float32(_ICT_FWD[1][0]) * rf + _np.float32(_ICT_FWD[1][1]) * gf \
        + _np.float32(_ICT_FWD[1][2]) * bf
    cr = _np.float32(_ICT_FWD[2][0]) * rf + _np.float32(_ICT_FWD[2][1]) * gf \
        + _np.float32(_ICT_FWD[2][2]) * bf
    return y, cb, cr


def ict_inverse_np(y, cb, cr):
    """numpy mirror of ict_inverse (see ict_forward_np)."""
    import numpy as _np
    yf = _np.asarray(y, dtype=_np.float32)
    cbf = _np.asarray(cb, dtype=_np.float32)
    crf = _np.asarray(cr, dtype=_np.float32)
    r = yf + _np.float32(_ICT_INV_CR) * crf
    g = yf + _np.float32(_ICT_INV_CB_G) * cbf + _np.float32(_ICT_INV_CR_G) * crf
    b = yf + _np.float32(_ICT_INV_CB) * cbf
    return r, g, b


def ict_forward_int(r: jnp.ndarray, g: jnp.ndarray, b: jnp.ndarray):
    """ICT with round-to-nearest int32 results (colorspace/ict.go:9-16)."""
    y, cb, cr = ict_forward(r, g, b)
    rnd = lambda v: jnp.round(v).astype(jnp.int32)
    return rnd(y), rnd(cb), rnd(cr)


def ict_inverse_int(y: jnp.ndarray, cb: jnp.ndarray, cr: jnp.ndarray):
    """Inverse ICT with round-to-nearest int32 (colorspace/ict.go:19-24)."""
    r, g, b = ict_inverse(y.astype(jnp.float32), cb.astype(jnp.float32),
                          cr.astype(jnp.float32))
    rnd = lambda v: jnp.round(v).astype(jnp.int32)
    return rnd(r), rnd(g), rnd(b)


# Full float32 products for every custom-matrix einsum. The default
# precision lets a GPU contract float32 on TF32 tensor cores (10 mantissa
# bits), so a 16-bit sample times a matrix entry can round to another
# integer and lossless Part 2 output would differ from the CPU lane.
MCT_PRECISION = jax.lax.Precision.HIGHEST


def mct_matrix_forward(components: jnp.ndarray, matrix: jnp.ndarray,
                       offsets: jnp.ndarray | None = None) -> jnp.ndarray:
    """Part 2 custom-matrix MCT: [C, ..., H, W] × [C, C] as one einsum.

    Reference applies arbitrary decorrelation matrices from MCT markers
    (jpeg2000/encoder.go:277-289, decoder.go:620-737); here it is one einsum.
    """
    x = components.astype(jnp.float32)
    if offsets is not None:
        x = x - offsets.reshape((-1,) + (1,) * (x.ndim - 1))
    return jnp.einsum("ij,j...->i...", matrix.astype(jnp.float32), x,
                      precision=MCT_PRECISION,
                      preferred_element_type=jnp.float32)


def mct_matrix_inverse(components: jnp.ndarray, inv_matrix: jnp.ndarray,
                       offsets: jnp.ndarray | None = None) -> jnp.ndarray:
    y = jnp.einsum("ij,j...->i...", inv_matrix.astype(jnp.float32),
                   components.astype(jnp.float32),
                   precision=MCT_PRECISION,
                   preferred_element_type=jnp.float32)
    if offsets is not None:
        y = y + offsets.reshape((-1,) + (1,) * (y.ndim - 1))
    return y
