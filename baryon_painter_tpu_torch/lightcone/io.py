"""SLICS file readers.

A copy of ``baryon_painter_tpu/lightcone/io.py`` (numpy only; astropy is
imported only by ``load_density_fits``).

File formats per the reference pipeline (process_SLICS.py:150-189):

  * delta planes: raw little-endian float32 stream, 7745^2 values,
    transposed on read; +96 mean shift; x 1/(3072^3/2/12288^2).
  * mass planes:  raw float32 stream with one leading count value,
    reshaped (4096*3, -1) then transposed; x 1/(3072^3/2/12288^2).
  * density FITS planes (SLICS_density variant): astropy optional.
  * random shifts: text file, rows of (x, y) fractions, reversed order.
"""
from __future__ import annotations

import os

import numpy as np

# SLICS particle-count normalisation (process_SLICS.py:159,189)
SLICS_NORM = 1.0 / (3072 ** 3 / 2 / 12288 ** 2)
N_PIXEL_DELTA = 7745
N_PIXEL_MASSPLANE = 4096 * 3
MASSPLANE_SIZE = 505.0  # Mpc/h


def load_delta_plane_raw(path: str, n_pixel: int = N_PIXEL_DELTA) -> np.ndarray:
    """Raw file contents, untransposed/unscaled (scale on device)."""
    return np.fromfile(path, dtype=np.float32).reshape(n_pixel, -1)


def load_delta_plane(path: str, n_pixel: int = N_PIXEL_DELTA) -> np.ndarray:
    d = load_delta_plane_raw(path, n_pixel).T
    d = d + 96.0  # mean of massplane
    return d * SLICS_NORM


def load_massplane_raw(path: str,
                       n_pixel: int = N_PIXEL_MASSPLANE) -> np.ndarray:
    return np.fromfile(path, dtype=np.float32)[1:].reshape(n_pixel, -1)


def load_massplane(path: str, n_pixel: int = N_PIXEL_MASSPLANE) -> np.ndarray:
    return load_massplane_raw(path, n_pixel).T * SLICS_NORM


def load_density_fits(path: str) -> np.ndarray:
    from astropy.io import fits  # optional dependency, gated
    with fits.open(path) as hdu:
        delta = np.asarray(hdu[0].data, dtype=np.float32).T
    return delta * SLICS_NORM / 64.0


def load_random_shifts(shifts_path: str, los: int) -> np.ndarray:
    return np.loadtxt(os.path.join(shifts_path, f"random_shift_LOS{los}"))[::-1]


def delta_filename(delta_path: str, z: float, los: int) -> str:
    return os.path.join(delta_path, f"{z:.3f}delta.dat_bicubic_LOS{los}")


def density_filename(delta_path: str, z: float, los: int) -> str:
    return os.path.join(delta_path, f"{z:.3f}density_LOS{los}.fits")


def massplane_filename(massplane_path: str, z: float, los: int,
                       shell_index: int) -> str:
    projection = ["xy", "xz", "yz"][shell_index % 3]
    return os.path.join(massplane_path,
                        f"{z:.3f}proj_half_finer_{projection}.dat_LOS{los}")


def load_kappa_map(path: str, n_pixel: int = N_PIXEL_DELTA,
                   decimate: int = 1) -> np.ndarray:
    """SLICS weak-lensing convergence map (precomputed data product).

    Format per the reference's create_lightcones.ipynb: raw float32
    stream, 7745^2 values in FORTRAN order, scaled x64; optionally
    decimated (the notebook uses [::5, ::5]). Used to cross-correlate a
    painted Compton-y map with kappa via ``angular_power.pseudo_cl_2d(y,
    kappa, ...)`` — the y x kappa cross-spectrum is the headline statistic
    of the reference paper (arXiv:1903.12173).
    """
    k = np.fromfile(path, dtype=np.float32).reshape(n_pixel, -1, order="F")
    if decimate > 1:
        k = k[::decimate, ::decimate]
    return k * 64.0


def kappa_filename(kappa_path: str, los: int, survey: str = "KiDS450",
                   tomo: int = 0) -> str:
    """create_lightcones.ipynb: kappa_<survey>_tomo<i>.dat_LOS<los>."""
    return os.path.join(kappa_path, f"kappa_{survey}_tomo{tomo}.dat_LOS{los}")
