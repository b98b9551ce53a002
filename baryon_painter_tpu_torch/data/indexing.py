"""Sample-index arithmetic for the paired-stack tile dataset.

The reference dataset forms each training sample as the SUM of a tile from a
100 Mpc/h stack and a tile from a 150 Mpc/h stack (250 Mpc/h equivalent,
datasets.py:157-163,344), squaring the sample count, with optional dihedral
tile permutations and a redshift axis.

The reference's decode has a bug (datasets.py:327 collapses the stack/tile
radix onto the permutation radix so only a handful of distinct tiles are ever
addressed — SURVEY §2 quirk 1). This module implements the documented *intent*
(datasets.py:37-46, trained_models/README.md:7-9) as a clean, bijective
mixed-radix scheme:

    idx <-> (z, p100, p150, s100, tx100, ty100, s150, tx150, ty150)

with z the most significant digit so that ``idx % n_sample`` strips redshift
exactly like the reference API expects.

All functions are pure numpy on int64 and vectorized (also jnp-compatible).

A copy of ``baryon_painter_tpu/data/indexing.py`` (pure Python and
numpy): the port imports nothing of the JAX package, whose ``__init__``
imports jax.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["SampleIndex", "IndexScheme", "dihedral_transform",
           "dihedral_transform_batch"]


@dataclasses.dataclass(frozen=True)
class IndexScheme:
    n_z: int
    n_perm: int   # 8 if tile_permutations else 1
    n_stack: int
    n_tile: int   # tiles per side

    @property
    def n_sample(self) -> int:
        """Samples per redshift: n_stack^2 * n_tile^4 * n_perm^2."""
        return (self.n_stack ** 2) * (self.n_tile ** 4) * (self.n_perm ** 2)

    @property
    def n_total(self) -> int:
        return self.n_sample * self.n_z

    @property
    def _radix(self):
        P, S, T = self.n_perm, self.n_stack, self.n_tile
        return (self.n_z, P, P, S, T, T, S, T, T)

    def decode(self, idx):
        """idx -> SampleIndex (vectorized over arrays)."""
        idx = np.asarray(idx, dtype=np.int64)
        if np.any((idx < 0) | (idx >= self.n_total)):
            raise IndexError(f"index out of range [0, {self.n_total})")
        parts = np.unravel_index(idx, self._radix)
        return SampleIndex(*parts)

    def encode(self, s: "SampleIndex"):
        return np.ravel_multi_index(
            (s.z, s.p100, s.p150, s.s100, s.tx100, s.ty100,
             s.s150, s.tx150, s.ty150), self._radix).astype(np.int64)

    def z_index(self, idx):
        """Redshift digit of ``idx`` (reference sample_idx_to_redshift)."""
        return np.asarray(idx, dtype=np.int64) // self.n_sample


@dataclasses.dataclass(frozen=True)
class SampleIndex:
    z: np.ndarray
    p100: np.ndarray
    p150: np.ndarray
    s100: np.ndarray
    tx100: np.ndarray
    ty100: np.ndarray
    s150: np.ndarray
    tx150: np.ndarray
    ty150: np.ndarray


def dihedral_transform(tile: np.ndarray, perm: int) -> np.ndarray:
    """Apply element ``perm`` in [0, 8) of the dihedral group D4.

    perm = rot * 2 + flip: rotate by 90deg*rot, then flip the last axis.
    This generates all 8 distinct symmetries (the reference's version has an
    unreachable branch, datasets.py:356-358 — SURVEY §2 quirk 2).
    Operates on the last two axes.
    """
    rot, flip = divmod(int(perm), 2)
    out = np.rot90(tile, k=rot, axes=(-2, -1)) if rot else tile
    if flip:
        out = out[..., ::-1]
    return out


def dihedral_transform_batch(tiles: np.ndarray, perms: np.ndarray) -> np.ndarray:
    """Per-sample dihedral transform for a batch (N, ..., H, W)."""
    return np.stack([dihedral_transform(t, p) for t, p in zip(tiles, perms)])
