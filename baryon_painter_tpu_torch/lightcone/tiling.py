"""Overlap-tiling geometry for painting large planes tile by tile.

A copy of ``baryon_painter_tpu/lightcone/tiling.py``; ``get_tile`` takes
numpy arrays and torch tensors. Same contracts as the reference
(process_SLICS.py:68-126): a minimum-overlap tiling solver, periodic-wrap
tile extraction, and Gaussian-falloff weight maps for blending. The solver
is re-derived (not transcribed): with tile relative size r and minimum
relative overlap v, consecutive tile origins may be at most r*(1-v) apart,
origins span [0, 1-r], so the origin count is
m = max(2, ceil(1 + (1-r)/(r*(1-v))))  (m=1 when the tile covers the plane).
This reproduces the reference's counts on its own test cases
(tests/test_SLICS_tiling.py:72-83).
"""
from __future__ import annotations

import math
from typing import Tuple

import numpy as np

from baryon_painter_tpu_torch.utils.platform import to_device

__all__ = ["generate_tiling", "get_tile", "make_weight_map",
           "tile_origin_pixels"]


def _origin_px(shift: float, n_pixel_plane: int, n_pixel_tile: int) -> int:
    """Pixel origin of a relative tile origin.

    Rounds (NOT truncates) and clamps so the last tile always reaches the
    plane edge: int(origin * n) drops the final origin by one pixel for
    ~13% of plane sizes (float representation of (1 - T/n) * n lands just
    below n - T), leaving a 1-px strip covered by no tile — a NaN strip
    after blend normalization. Extraction (get_tile) and blend placement
    (tile_origin_pixels) MUST share this function or they misalign.
    """
    x0 = int(round(shift * n_pixel_plane))
    return min(x0, max(0, n_pixel_plane - n_pixel_tile))


def generate_tiling(n_pixel_plane: int, n_pixel_tile: int,
                    min_tile_overlap: float = 0.5):
    """Tile origins (relative) + pixel slices covering a square plane.

    Returns (tile_origins, tile_slices) with the reference's structure:
    origins as fractions of the plane, slices[i][j] a 2-D numpy slice pair.
    """
    if not 0.0 <= min_tile_overlap < 1.0:
        raise ValueError(
            f"min_tile_overlap must be in [0, 1), got {min_tile_overlap} "
            "(1.0 would mean zero advance per tile)")
    r = n_pixel_tile / n_pixel_plane
    if r >= 1.0:
        m = 1
    else:
        step = r * (1.0 - min_tile_overlap)
        m = max(2, math.ceil(1.0 + (1.0 - r) / step - 1e-12))
    tile_origins = np.linspace(0.0, max(0.0, 1.0 - r), m, endpoint=True)

    tile_slices = []
    for x_shift in tile_origins:
        row = []
        x0 = _origin_px(x_shift, n_pixel_plane, n_pixel_tile)
        for y_shift in tile_origins:
            y0 = _origin_px(y_shift, n_pixel_plane, n_pixel_tile)
            row.append(np.s_[x0:x0 + n_pixel_tile, y0:y0 + n_pixel_tile])
        tile_slices.append(row)
    return tile_origins, tile_slices


def tile_origin_pixels(tile_origins, n_pixel_plane: int,
                       n_pixel_tile: int) -> np.ndarray:
    """Pixel origins for blend placement; same round+clamp as
    generate_tiling (see _origin_px)."""
    return np.asarray([_origin_px(float(s), n_pixel_plane, n_pixel_tile)
                       for s in np.atleast_1d(np.asarray(tile_origins))],
                      dtype=np.int32)


def get_tile(m, shift: Tuple[float, float], tile_relative_size: float,
             expansion_factor: float = 1.0):
    """Extract a (possibly expanded) tile with periodic wrapping.

    Mirrors process_SLICS.py:68-83: origin given as a fraction of the plane,
    expansion grows the tile symmetrically around it. Works on numpy arrays
    and torch tensors (gathered on the tensor's device); wrapping uses
    mode='wrap' index arithmetic.
    """
    if expansion_factor < 1:
        raise ValueError("Expansion factors < 1 not supported.")
    n = m.shape[0]
    # round, matching generate_tiling/_origin_px: truncation would misalign
    # extraction vs blend placement by one pixel on affected plane sizes
    origin = (int(round(n * shift[0])), int(round(n * shift[1])))
    n_pix = int(n * tile_relative_size * expansion_factor)
    offset = int(n * tile_relative_size * (expansion_factor - 1) / 2)
    rows = (np.arange(origin[0] - offset, origin[0] - offset + n_pix)) % n
    cols = (np.arange(origin[1] - offset, origin[1] - offset + n_pix)) % n
    if isinstance(m, np.ndarray):
        return m[np.ix_(rows, cols)]
    rows, cols = to_device(rows, m.device), to_device(cols, m.device)
    return m[rows[:, None], cols[None, :]]


def make_weight_map(tile_shape, falloff: float = 0.05, sigma: float = 1.0):
    """Gaussian-falloff blending weights (process_SLICS.py:85-99).

    Border pixels within ``falloff`` of an edge are down-weighted by
    exp(-d^2 / (2 (falloff_pixel*sigma)^2)); row and column factors multiply
    (so corners get both). Vectorized (the reference loops per border row).
    """
    h, w = tile_shape

    def profile(n):
        # falloff width from THIS axis's length (a (h, w) tile gets the
        # advertised fractional falloff on both axes, not h's on both)
        fp = int(n * falloff)
        p = np.ones(n)
        if fp > 0:
            i = np.arange(fp)
            d = fp - i
            s = fp * sigma
            f = np.exp(-0.5 * d ** 2 / s ** 2)
            p[:fp] *= f
            p[n - 1 - i] *= f
        return p

    return profile(h)[:, None] * profile(w)[None, :]
