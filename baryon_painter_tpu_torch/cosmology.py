"""Minimal flat-LambdaCDM background cosmology (replaces the pyccl subset).

A copy of ``baryon_painter_tpu/cosmology.py`` (numpy only).

The reference uses pyccl only for comoving (angular) distances and
``scale_factor_of_chi`` (process_SLICS.py:12-32, create_lightcone.py:92-98).
This module provides those for a flat LCDM background with optional radiation,
good to <<0.1% against direct quadrature — far inside the 5% P(k) gate.

All distances are in Mpc (no h) to match pyccl's convention; multiply by h for
Mpc/h as the reference scripts do (create_lightcone.py:95).
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Cosmology", "SLICS_COSMOLOGY"]

C_KM_S = 299792.458  # speed of light [km/s]


@dataclasses.dataclass(frozen=True)
class Cosmology:
    """Flat LCDM background; distances via cumulative trapezoid quadrature
    (n_grid=16384 keeps it well inside the <<0.1%-vs-pyccl tolerance)."""

    Omega_m: float
    h: float
    Omega_k: float = 0.0
    # Radiation density (photons+massless nu). pyccl includes it; its effect
    # on z<3 distances is ~0.01%. Default 0 for SLICS parity tests.
    Omega_r: float = 0.0
    z_grid_max: float = 20.0
    n_grid: int = 16384

    def __post_init__(self):
        z = np.linspace(0.0, self.z_grid_max, self.n_grid)
        Ez = self.E(z)
        integrand = 1.0 / Ez
        dz = z[1] - z[0]
        # cumulative trapezoid (dense grid -> plenty accurate)
        cum = np.concatenate(
            [[0.0], np.cumsum(0.5 * (integrand[1:] + integrand[:-1]) * dz)])
        chi = C_KM_S / (100.0 * self.h) * cum  # [Mpc]
        object.__setattr__(self, "_z_grid", z)
        object.__setattr__(self, "_chi_grid", chi)

    @property
    def Omega_L(self):
        return 1.0 - self.Omega_m - self.Omega_k - self.Omega_r

    def E(self, z):
        zp1 = 1.0 + np.asarray(z, dtype=np.float64)
        return np.sqrt(self.Omega_r * zp1 ** 4 + self.Omega_m * zp1 ** 3
                       + self.Omega_k * zp1 ** 2 + self.Omega_L)

    def comoving_distance(self, z):
        """chi(z) in Mpc (line-of-sight comoving distance)."""
        return np.interp(np.asarray(z, dtype=np.float64),
                         self._z_grid, self._chi_grid)

    def comoving_angular_distance(self, z):
        """Transverse comoving distance; equals chi for a flat universe."""
        chi = self.comoving_distance(z)
        if self.Omega_k == 0.0:
            return chi
        K = -self.Omega_k * (100.0 * self.h / C_KM_S) ** 2
        sqrtK = np.sqrt(abs(K))
        if K > 0:
            return np.sin(sqrtK * chi) / sqrtK
        return np.sinh(sqrtK * chi) / sqrtK

    def scale_factor_of_chi(self, chi):
        """a(chi): inverse of the distance-redshift relation."""
        z = np.interp(np.asarray(chi, dtype=np.float64),
                      self._chi_grid, self._z_grid)
        return 1.0 / (1.0 + z)

    def redshift_of_chi(self, chi):
        return np.interp(np.asarray(chi, dtype=np.float64),
                         self._chi_grid, self._z_grid)


def SLICS_COSMOLOGY() -> Cosmology:
    """The SLICS WMAP9 cosmology used by the lightcone CLI
    (scripts/create_lightcone.py:87-93)."""
    return Cosmology(Omega_m=0.2905, h=0.6898)
