"""Reversible 5/3 lifting DWT (ISO/IEC 15444-1 Annex F), as batched jnp.

Semantics match the reference's OpenJPEG-parity scalar lifting
(reference jpeg2000/wavelet/dwt53.go:27-103 forward, :123-234 inverse,
parity/window math at wavelet/parity.go and wavelet/layout.go), but the
computation is re-expressed as whole-array tensor algebra: the per-sample
predict/update recurrences become shifted-slice adds with edge clamping, so
one jit launch transforms a whole batch of tiles with no data-dependent
control flow. Integer semantics: int32 arithmetic, arithmetic right shifts
(Go's ``>>`` == numpy/jnp signed right shift), bit-exact vs the scalar form
(pinned by tests/test_dwt53.py against a literal scalar model).

Layout: packed "Mallat in-place" layout like the reference — after one 2D
level the window is [[LL, HL], [LH, HH]]; multilevel recurses on the LL
window at the top-left with the original stride.

Every level is plain jnp that XLA compiles and fuses; there is no
hand-written kernel. A fused multilevel kernel (all levels in one launch)
is a candidate only once the GPU benchmark shows this transform's
roofline share low and its part of a cell's time large.
"""

from __future__ import annotations

from functools import partial
from typing import List, Tuple

import jax
import jax.numpy as jnp


def low_len(n: int, even: bool) -> int:
    """Low-pass sample count (reference wavelet/parity.go splitLengths)."""
    return (n + 1) // 2 if even else n // 2


def next_window(w: int, h: int, x0: int, y0: int) -> Tuple[int, int, int, int]:
    """Next-level LL window (reference wavelet/layout.go nextLowpassWindow)."""
    return (low_len(w, x0 % 2 == 0), low_len(h, y0 % 2 == 0),
            (x0 + 1) >> 1, (y0 + 1) >> 1)


def ll_dimensions(width: int, height: int, levels: int,
                  x0: int = 0, y0: int = 0) -> Tuple[int, int]:
    """LL subband dims after `levels` (reference wavelet/layout.go:14-41)."""
    if width <= 0 or height <= 0:
        return 0, 0
    w, h = width, height
    for _ in range(max(levels, 0)):
        if w <= 1 and h <= 1:
            break
        w, h, x0, y0 = next_window(w, h, x0, y0)
    return w, h


def _edge_left(a):
    """a[i-1] with left-edge clamp along last axis."""
    return jnp.concatenate([a[..., :1], a[..., :-1]], axis=-1)


def _edge_right(a):
    """a[i+1] with right-edge clamp along last axis."""
    return jnp.concatenate([a[..., 1:], a[..., -1:]], axis=-1)


def fwd53_1d(x: jnp.ndarray, even: bool) -> jnp.ndarray:
    """Forward 5/3 lifting along the last axis → [L | H] packed.

    even=True is OpenJPEG cas=0 (low-pass at even indices); semantics of
    reference wavelet/dwt53.go:27-103 vectorized with edge-clamped shifts.
    """
    w = x.shape[-1]
    if w <= 1:
        return x if even else x * 2  # dwt53.go:34-36, :70-73
    if even:
        s = x[..., 0::2]
        d = x[..., 1::2]
        sn, dn = s.shape[-1], d.shape[-1]
        # predict: h[i] = d[i] - ((s[i] + s[i+1 clamped]) >> 1)
        s_next = _edge_right(s)[..., :dn]
        h = d - ((s[..., :dn] + s_next) >> 1)
        # update: l[i] = s[i] + ((h[i-1 clamped] + h[i clamped] + 2) >> 2)
        h_prev = _edge_left(h)
        h_cur = h
        if sn == dn + 1:  # odd width: clamp at the right edge
            h_prev = jnp.concatenate([h_prev, h[..., -1:]], axis=-1)
            h_cur = jnp.concatenate([h_cur, h[..., -1:]], axis=-1)
        l = s + ((h_prev + h_cur + 2) >> 2)
    else:
        d = x[..., 0::2]
        s = x[..., 1::2]
        sn, dn = s.shape[-1], d.shape[-1]
        # predict: h[i] = d[i] - ((s[i-1 clamped] + s[i clamped]) >> 1)
        if dn == sn:
            s_im1, s_i = _edge_left(s), s
        else:  # dn == sn + 1 (odd width)
            s_im1 = jnp.concatenate([s[..., :1], s], axis=-1)
            s_i = jnp.concatenate([s, s[..., -1:]], axis=-1)
        h = d - ((s_im1 + s_i) >> 1)
        # update: l[i] = s[i] + ((h[i] + h[i+1 clamped] + 2) >> 2)
        h_i = h[..., :sn]
        h_ip1 = h[..., 1:sn + 1] if dn >= sn + 1 else _edge_right(h)
        l = s + ((h_i + h_ip1 + 2) >> 2)
    return jnp.concatenate([l, h], axis=-1)


def inv53_1d(x: jnp.ndarray, even: bool) -> jnp.ndarray:
    """Inverse 5/3 lifting along last axis from [L | H] packed.

    Mirrors reference wavelet/dwt53.go:123-234 (OpenJPEG idwt53 cas0/cas1),
    vectorized; the cas1 width-2 special case falls out of the clamped
    general form.
    """
    w = x.shape[-1]
    if w <= 1:
        # forward cas1 width-1 doubled; Go halves with truncating division
        # (dwt53.go:176) — values are always even so >>1 is exact.
        return x if even else (x >> 1)
    if even:
        sn = (w + 1) // 2
        l, h = x[..., :sn], x[..., sn:]
        dn = w - sn
        # s[i] = l[i] - ((h[i-1 cl] + h[i cl] + 2) >> 2)
        h_prev, h_cur = _edge_left(h), h
        if sn == dn + 1:
            h_prev = jnp.concatenate([h_prev, h[..., -1:]], axis=-1)
            h_cur = jnp.concatenate([h_cur, h[..., -1:]], axis=-1)
        s = l - ((h_prev + h_cur + 2) >> 2)
        # x_odd[i] = h[i] + ((s[i] + s[i+1 cl]) >> 1)
        s_ip1 = s[..., 1:sn] if sn == dn + 1 else _edge_right(s)
        x_odd = h + ((s[..., :dn] + s_ip1[..., :dn]) >> 1)
        out = jnp.zeros_like(x)
        out = out.at[..., 0::2].set(s)
        out = out.at[..., 1::2].set(x_odd)
    else:
        sn = w // 2
        l, h = x[..., :sn], x[..., sn:]
        dn = w - sn
        # s[i] = l[i] - ((h[i cl] + h[i+1 cl] + 2) >> 2)
        if dn == sn:
            h_i, h_ip1 = h, _edge_right(h)
        else:  # dn == sn + 1
            h_i, h_ip1 = h[..., :sn], h[..., 1:sn + 1]
        s = l - ((h_i + h_ip1 + 2) >> 2)
        # x_even[i] = h[i] + ((s[i-1 cl] + s[i cl]) >> 1)
        if dn == sn:
            s_im1, s_i = _edge_left(s), s
        else:
            s_im1 = jnp.concatenate([s[..., :1], s], axis=-1)
            s_i = jnp.concatenate([s, s[..., -1:]], axis=-1)
        x_even = h + ((s_im1 + s_i) >> 1)
        out = jnp.zeros_like(x)
        out = out.at[..., 0::2].set(x_even)
        out = out.at[..., 1::2].set(s)
    return out


def _along_rows(fn, x, even):
    return fn(x, even)


def _along_cols(fn, x, even):
    return jnp.swapaxes(fn(jnp.swapaxes(x, -1, -2), even), -1, -2)


def fwd53_2d(x: jnp.ndarray, even_row: bool = True,
             even_col: bool = True) -> jnp.ndarray:
    """One 2D level: vertical pass first, then horizontal (dwt53.go:259-301).

    x: [..., H, W] int32. Output packed [[LL, HL], [LH, HH]].
    Dimensions of size 1 are skipped like the reference 2D path.
    """
    h, w = x.shape[-2], x.shape[-1]
    # size-1 dims still pass through the 1D op: at odd parity the single
    # sample is a HIGH coefficient (×2 rule, dwt53.go:70-73 / Annex F);
    # at even parity it is the identity and is skipped
    if h > 1 or (h == 1 and not even_col):
        x = _along_cols(fwd53_1d, x, even_col)
    if w > 1 or (w == 1 and not even_row):
        x = _along_rows(fwd53_1d, x, even_row)
    return x


def inv53_2d(x: jnp.ndarray, even_row: bool = True,
             even_col: bool = True) -> jnp.ndarray:
    """Inverse 2D level: horizontal first, then vertical (dwt53.go:313-355)."""
    h, w = x.shape[-2], x.shape[-1]
    if w > 1 or (w == 1 and not even_row):
        x = _along_rows(inv53_1d, x, even_row)
    if h > 1 or (h == 1 and not even_col):
        x = _along_cols(inv53_1d, x, even_col)
    return x


def _level_windows(width: int, height: int, levels: int, x0: int, y0: int):
    """Per-level (w, h, x0, y0) windows, finest first."""
    wins: List[Tuple[int, int, int, int]] = []
    w, h = width, height
    for _ in range(levels):
        if w == 0 or h == 0:
            break
        # NOTE: 1-sample windows still run — at odd origins Annex B puts
        # the sample in the HIGH band of this level (fwd53_1d's ×2 rule),
        # so stopping at 1×1 would desync the packed layout from the
        # Annex-B band rectangles on ragged odd-origin tiles.
        wins.append((w, h, x0, y0))
        w, h, x0, y0 = next_window(w, h, x0, y0)
    return wins


def _fwd53_1d_even(x: jnp.ndarray) -> jnp.ndarray:
    """fwd53_1d for even width at even parity via a [W/2, 2] reshape.

    Bit-exact with fwd53_1d (same lifting arithmetic); the even/odd split
    is a reshape instead of stride-2 slicing. Its speed against the
    generic lifting has not been measured on a GPU.
    """
    w = x.shape[-1]
    p = x.reshape(x.shape[:-1] + (w // 2, 2))
    s, d = p[..., 0], p[..., 1]
    s_next = jnp.concatenate([s[..., 1:], s[..., -1:]], axis=-1)
    h = d - ((s + s_next) >> 1)
    h_prev = jnp.concatenate([h[..., :1], h[..., :-1]], axis=-1)
    l = s + ((h_prev + h + 2) >> 2)
    return jnp.concatenate([l, h], axis=-1)


def _fwd53_2d_dispatch(x: jnp.ndarray, even_row: bool,
                       even_col: bool) -> jnp.ndarray:
    """One 2D level, picking the reshape kernel for even/even windows."""
    h, w = x.shape[-2], x.shape[-1]
    if h > 1 and w > 1 and even_row and even_col and h % 2 == 0 \
            and w % 2 == 0:
        x = jnp.swapaxes(_fwd53_1d_even(jnp.swapaxes(x, -1, -2)), -1, -2)
        return _fwd53_1d_even(x)
    return fwd53_2d(x, even_row=even_row, even_col=even_col)


def _inv53_1d_even(x: jnp.ndarray) -> jnp.ndarray:
    """inv53_1d for even width at even parity, interleaving via a
    [W/2, 2] stack+reshape instead of two stride-2 scatter updates.

    Bit-exact with inv53_1d (same lifting arithmetic); the reshape
    interleave is the decode-direction mirror of _fwd53_1d_even, in place
    of stride-2 .at[::2].set updates.
    """
    w = x.shape[-1]
    sn = w // 2
    l, h = x[..., :sn], x[..., sn:]
    h_prev = jnp.concatenate([h[..., :1], h[..., :-1]], axis=-1)
    s = l - ((h_prev + h + 2) >> 2)
    s_next = jnp.concatenate([s[..., 1:], s[..., -1:]], axis=-1)
    x_odd = h + ((s + s_next) >> 1)
    return jnp.stack([s, x_odd], axis=-1).reshape(x.shape)


def _inv53_2d_dispatch(x: jnp.ndarray, even_row: bool,
                       even_col: bool) -> jnp.ndarray:
    """One inverse 2D level, picking the reshape kernel for even/even
    windows (horizontal first, then vertical — inv53_2d order)."""
    h, w = x.shape[-2], x.shape[-1]
    if h > 1 and w > 1 and even_row and even_col and h % 2 == 0 \
            and w % 2 == 0:
        x = _inv53_1d_even(x)
        return jnp.swapaxes(_inv53_1d_even(jnp.swapaxes(x, -1, -2)),
                            -1, -2)
    return inv53_2d(x, even_row=even_row, even_col=even_col)


def fwd53_multilevel(x: jnp.ndarray, levels: int,
                     x0: int = 0, y0: int = 0) -> jnp.ndarray:
    """Multilevel packed decomposition (dwt53.go:365-394), batched.

    x: [..., H, W] int32; each level transforms the current LL window at
    the top-left in the packed layout. Assembly is a concat recursion
    (no full-array dynamic-update-slice per level — XLA materializes
    those as whole-buffer copies).
    """
    height, width = x.shape[-2], x.shape[-1]
    wins = _level_windows(width, height, levels, x0, y0)

    def rec(win, i):
        if i >= len(wins):
            return win
        w, h, lx0, ly0 = wins[i]
        t = _fwd53_2d_dispatch(win, even_row=lx0 % 2 == 0,
                               even_col=ly0 % 2 == 0)
        if i + 1 >= len(wins):
            return t
        lw, lh, _, _ = wins[i + 1]
        ll = rec(t[..., :lh, :lw], i + 1)
        if lw < w:
            top = jnp.concatenate([ll, t[..., :lh, lw:]], axis=-1)
        else:
            top = ll
        if lh < h:
            return jnp.concatenate([top, t[..., lh:, :]], axis=-2)
        return top

    if not wins:
        return x
    # the finest window always spans the whole array (_level_windows
    # starts from (width, height)), so rec consumes x in full
    assert wins[0][:2] == (width, height)
    return rec(x, 0)


def inv53_multilevel(x: jnp.ndarray, levels: int,
                     x0: int = 0, y0: int = 0) -> jnp.ndarray:
    """Multilevel packed reconstruction (dwt53.go:404-434), batched.

    Coarsest-first concat recursion: each level's window is rebuilt as
    [reconstructed-LL | bands-from-x] instead of a full-array
    .at[:h,:w].set per level (the decode mirror of fwd53_multilevel's
    note — XLA materializes those dynamic-update-slices as whole-buffer
    copies).
    """
    height, width = x.shape[-2], x.shape[-1]
    wins = _level_windows(width, height, levels, x0, y0)
    if not wins:
        return x
    cur = None  # reconstructed LL of the previous (coarser) level
    lw = lh = 0
    for (w, h, lx0, ly0) in reversed(wins):
        if cur is None:
            win = x[..., :h, :w]
        else:
            win = cur
            if lw < w:
                win = jnp.concatenate([win, x[..., :lh, lw:w]], axis=-1)
            if lh < h:
                win = jnp.concatenate([win, x[..., lh:h, :w]], axis=-2)
        cur = _inv53_2d_dispatch(win, even_row=lx0 % 2 == 0,
                                 even_col=ly0 % 2 == 0)
        lw, lh = w, h
    # the finest window always spans the whole array
    return cur


@partial(jax.jit, static_argnames=("levels", "x0", "y0"))
def fwd53_multilevel_jit(x, levels: int, x0: int = 0, y0: int = 0):
    return fwd53_multilevel(x, levels, x0, y0)


@partial(jax.jit, static_argnames=("levels", "x0", "y0"))
def inv53_multilevel_jit(x, levels: int, x0: int = 0, y0: int = 0):
    return inv53_multilevel(x, levels, x0, y0)
