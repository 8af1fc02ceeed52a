"""Byte-plane split/interleave for DICOM RLE (device-friendly transpose).

The reference walks pixels byte-by-byte per segment (rle/rle.go:100-123):
segment s covers sample s//ba, byte index ba-1-(s%ba) — i.e. per sample,
MSB-first byte planes. Here that walk is a single reshape/flip/transpose,
which XLA lowers to one relayout on the device; the batched form handles a
whole multi-frame stack per launch (SURVEY.md §2.2).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

from ..frames import FrameInfo


def split_byte_planes_np(frame: bytes, info: FrameInfo) -> np.ndarray:
    """Raw frame buffer → ``[num_segments, pixel_count]`` uint8 planes."""
    ba = info.bytes_allocated
    spp = info.samples_per_pixel
    p = info.pixel_count
    a = np.frombuffer(frame, dtype=np.uint8, count=p * spp * ba)
    if info.planar_configuration == 0 or spp == 1:
        a = a.reshape(p, spp, ba)            # [pixel][sample][byte LSB-first]
        a = a.transpose(1, 2, 0)             # [sample][byte][pixel]
    else:
        a = a.reshape(spp, p, ba)            # [sample][pixel][byte]
        a = a.transpose(0, 2, 1)             # [sample][byte][pixel]
    a = a[:, ::-1, :]                        # byte planes MSB-first
    return np.ascontiguousarray(a.reshape(spp * ba, p))


def merge_byte_planes_np(planes: np.ndarray, info: FrameInfo) -> bytes:
    """Inverse of split_byte_planes_np, honoring planar_configuration.

    Written as per-plane strided column stores instead of one
    transposed-array copy: numpy's elementwise copy of a [p, spp, ba]
    transpose with tiny inner dims is ~5x slower than spp*ba
    vectorized strided assignments (this is most of RLE decode's
    wall-clock)."""
    ba = info.bytes_allocated
    spp = info.samples_per_pixel
    p = info.pixel_count
    a = planes.reshape(spp, ba, p)               # [sample][byte MSB-first]
    if info.planar_configuration == 0 or spp == 1:
        out = np.empty((p, spp, ba), dtype=np.uint8)   # interleaved
        for s in range(spp):
            for b in range(ba):
                out[:, s, ba - 1 - b] = a[s, b]        # LSB-first bytes
    else:
        out = np.empty((spp, p, ba), dtype=np.uint8)   # planar
        for s in range(spp):
            for b in range(ba):
                out[s, :, ba - 1 - b] = a[s, b]
    return out.tobytes()


def split_byte_planes(batch_u8: jnp.ndarray, bytes_allocated: int,
                      samples_per_pixel: int) -> jnp.ndarray:
    """Device version: ``[F, P*S*B]`` uint8 → ``[F, S*B, P]`` planes.

    Interleaved layout assumed (the batched device path normalizes planar
    input on host first). jit-safe: all shapes static.
    """
    f = batch_u8.shape[0]
    p = batch_u8.shape[1] // (bytes_allocated * samples_per_pixel)
    a = batch_u8.reshape(f, p, samples_per_pixel, bytes_allocated)
    a = jnp.flip(a, axis=3)                  # MSB-first
    a = jnp.transpose(a, (0, 2, 3, 1))       # [F, S, B, P]
    return a.reshape(f, samples_per_pixel * bytes_allocated, p)


def merge_byte_planes(planes: jnp.ndarray, bytes_allocated: int,
                      samples_per_pixel: int) -> jnp.ndarray:
    """Device inverse: ``[F, S*B, P]`` → ``[F, P*S*B]`` interleaved bytes."""
    f, sb, p = planes.shape
    a = planes.reshape(f, samples_per_pixel, bytes_allocated, p)
    a = jnp.flip(a, axis=2)                  # back to LSB-first
    a = jnp.transpose(a, (0, 3, 1, 2))       # [F, P, S, B]
    return a.reshape(f, p * samples_per_pixel * bytes_allocated)
