"""A synthetic SLICS line of sight, written in the SLICS file layout.

``write_synthetic_los`` writes what ``process_slics`` and the lightcone CLI
read: a delta plane per shell (``delta/``), a massplane for each low-z shell
(delta plane smaller than the 100 Mpc/h tile, ``massplanes/``), the random
shifts (``random_shifts/``) and a convergence map (``kappa/``). The values
are drawn as ``scripts/bench_lightcone.py`` draws them, gamma(2, 48) (minus
96 for the delta planes), so that the prepared planes, (raw + 96) *
SLICS_NORM and raw * SLICS_NORM, have mean about 1; they are made on
``device`` from ``seed`` (a gamma(2) variate is the sum of two exponential
ones), the convergence map as Gaussian noise of standard deviation 0.02.
"""
from __future__ import annotations

import os

import numpy as np
import torch

from baryon_painter_tpu_torch.cosmology import SLICS_COSMOLOGY
from baryon_painter_tpu_torch.lightcone import io as slics_io
from baryon_painter_tpu_torch.utils.platform import resolve_device

__all__ = ["write_synthetic_los", "shell_sizes"]

TILE_SIZE = 100.0  # Mpc/h, the lightcone CLI's tile


def shell_sizes(z_shells) -> np.ndarray:
    """Each shell's delta-plane size in Mpc/h over the CLI's 10 degrees."""
    cosmo = SLICS_COSMOLOGY()
    return (cosmo.comoving_angular_distance(np.asarray(z_shells)) * cosmo.h
            * 10 / 180 * np.pi)


def _gamma2(n: int, scale: float, generator, device) -> torch.Tensor:
    x = torch.empty(n, dtype=torch.float32, device=device)
    x.exponential_(generator=generator)
    y = torch.empty_like(x).exponential_(generator=generator)
    return (x + y) * scale


def _write(values: torch.Tensor, path: str, header=None):
    with open(path, "wb") as f:
        if header is not None:
            np.float32(header).tofile(f)
        values.cpu().numpy().tofile(f)


def write_synthetic_los(base: str, z_shells, los: int = 74,
                        n_pixel_delta: int = slics_io.N_PIXEL_DELTA,
                        n_pixel_massplane: int = slics_io.N_PIXEL_MASSPLANE,
                        seed: int = 0, device=None) -> dict:
    """Write one synthetic line of sight under ``base``; returns the kinds
    of its shells ("massplane" or "delta") and its paths."""
    device = resolve_device(device)
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    paths = {k: os.path.join(base, k)
             for k in ("delta", "massplanes", "random_shifts", "kappa")}
    for p in paths.values():
        os.makedirs(p, exist_ok=True)
    rng = np.random.default_rng(seed)
    np.savetxt(os.path.join(paths["random_shifts"], f"random_shift_LOS{los}"),
               rng.uniform(0, 1, size=(len(z_shells), 2)))
    kinds = []
    for i, (z, size) in enumerate(zip(z_shells, shell_sizes(z_shells))):
        if size < TILE_SIZE:
            _write(_gamma2(n_pixel_massplane ** 2, 48.0, g, device),
                   slics_io.massplane_filename(paths["massplanes"], z, los, i),
                   header=n_pixel_massplane ** 2)
        kinds.append("massplane" if size < TILE_SIZE else "delta")
        _write(_gamma2(n_pixel_delta ** 2, 48.0, g, device) - 96.0,
               slics_io.delta_filename(paths["delta"], z, los))
    kappa = torch.randn(n_pixel_delta ** 2, generator=g, device=device)
    _write(kappa * (0.02 / 64.0), slics_io.kappa_filename(paths["kappa"], los))
    return {"kinds": kinds, **paths}
