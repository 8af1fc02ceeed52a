"""Multi-tile grid assembly behaviors.

Mirrors reference jpeg2000/tile_assembler_test.go and
testdata/multitile_test.go: grid shapes, non-aligned ragged edges,
per-tile content placement, multi-component tiles, and tile grids
combined with decomposition levels.
"""

import numpy as np
import pytest

from go_dicom_codec_jax.codecs.jpeg2000 import (J2KDecoder, J2KEncodeParams,
                                                J2KEncoder)


@pytest.fixture
def rng():
    return np.random.default_rng(15444)


def _roundtrip(img, tw, th, **kw):
    if img.ndim == 2:
        img = img[:, :, None]
    h, w, c = img.shape
    stream = J2KEncoder(J2KEncodeParams(
        tile_width=tw, tile_height=th, **kw)).encode(
        img.astype("<u1").tobytes(), w, h, c, 8)
    arr, siz, _ = J2KDecoder().decode(stream)
    assert (siz.xtsiz, siz.ytsiz) == (tw, th)
    np.testing.assert_array_equal(arr, img)
    return siz


@pytest.mark.parametrize("grid", [(2, 2), (3, 2), (1, 4)])
def test_aligned_tile_grids(rng, grid):
    """multitile_test.go TestGenerate{2x2,3x2}TileJ2K: exact grids."""
    gx, gy = grid
    img = rng.integers(0, 256, (16 * gy, 16 * gx))
    _roundtrip(img, 16, 16)


@pytest.mark.parametrize("size", [(33, 49), (17, 16), (40, 23)])
def test_non_aligned_tile_bounds(rng, size):
    """tile_assembler_test.go TestTileBoundsNonAligned: ragged last
    row/column tiles are clipped to the image grid."""
    h, w = size
    img = rng.integers(0, 256, (h, w))
    _roundtrip(img, 16, 16)


def test_tile_indexing_content_placement():
    """tile_assembler_test.go TestTileIndexing: each tile carries a
    distinct constant; the mosaic must place every tile at its raster
    position (catches transposed or reordered tile loops)."""
    img = np.zeros((32, 48), dtype=np.int64)
    for ty in range(2):
        for tx in range(3):
            img[ty * 16:(ty + 1) * 16, tx * 16:(tx + 1) * 16] = \
                10 + ty * 3 + tx
    _roundtrip(img, 16, 16)


def test_multitile_multicomponent(rng):
    """tile_assembler_test.go TestTileAssemblerMultiComponent: RGB data
    across a 2x2 grid, per-plane patterns preserved."""
    img = rng.integers(0, 256, (32, 32, 3))
    _roundtrip(img, 16, 16)


@pytest.mark.parametrize("levels", [0, 2, 4])
def test_multitile_with_levels(rng, levels):
    """multitile_test.go TestMultiTileWithLevels: decomposition depth is
    per-tile; deep levels on small ragged tiles stay lossless."""
    img = rng.integers(0, 256, (40, 56))
    _roundtrip(img, 16, 16, num_levels=levels)


def test_single_tile_degenerate(rng):
    """tile_assembler_test.go TestTileAssemblerSingleTile: a tile grid
    larger than the image is one clipped tile."""
    img = rng.integers(0, 256, (24, 24))
    siz = _roundtrip(img, 64, 64)
    assert (siz.xsiz, siz.ysiz) == (24, 24)
