"""Compton-y sky-map assembly from painted comoving-pressure planes.

Port of ``baryon_painter_tpu/lightcone/ymap.py``: the reference's
create_y_map (process_SLICS.py:12-66) with the embedded cosmology module
instead of pyccl and the port's B-spline resampler instead of scipy zoom,
accumulated in f32 on the device:

  y(theta) = sum_shells  P_e(plane) * V_cell * (Xe+Xi)/Xe * sigma_T/(m_e c^2)
             / A_pix_eff(shell) / zoom^2,  resampled to the output grid.

A_pix_eff is the shell-averaged physical pixel area
< (chi * a(chi) * theta_pix)^2 > over the shell's comoving depth
(process_SLICS.py:13-20), computed by trapezoidal quadrature on a dense
grid (the reference integrates the same function with scipy quad;
tests/test_lightcone.py cross-checks against it).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from baryon_painter_tpu_torch.cosmology import Cosmology
from baryon_painter_tpu_torch.ops.resample import resize_spline
from baryon_painter_tpu_torch.utils import constants as const
from baryon_painter_tpu_torch.utils.platform import device_of, to_device

__all__ = ["create_y_map", "effective_pixel_areas"]

SLICS_SLAB_DEPTH = 252.5  # Mpc/h (SLICS slab thickness)


def effective_pixel_areas(cosmo: Cosmology, z: Sequence[float],
                          theta_pix: float, n_quad: int = 129) -> np.ndarray:
    """Mean physical pixel area per shell [Mpc^2]."""
    h = cosmo.h
    d_A = cosmo.comoving_angular_distance(np.asarray(z))  # [Mpc]
    d_A = d_A - SLICS_SLAB_DEPTH / h / 2
    if d_A[0] < 0:
        d_A[0] = 0.0
    d_A = np.append(d_A, d_A[-1] + SLICS_SLAB_DEPTH / h)

    areas = np.empty(len(z))
    for i in range(len(z)):
        chi = np.linspace(d_A[i], d_A[i + 1], n_quad)
        a = cosmo.scale_factor_of_chi(chi)
        f = (chi * a * theta_pix) ** 2
        # trapezoidal integration on a dense grid, then divide by the
        # interval (np.trapezoid is numpy>=2; trapz covers 1.x)
        trap = getattr(np, "trapezoid", None) or np.trapz
        areas[i] = trap(f, chi) / (d_A[i + 1] - d_A[i])
    return areas


def create_y_map(painted_planes: Sequence, z: Sequence[float],
                 resolution: int, map_size: float, cosmo: Cosmology,
                 order: int = 3, verbose: bool = False,
                 L_box: float = 400.0, n_mesh: int = 2048,
                 device=None) -> np.ndarray:
    """Accumulate painted pressure planes into a Compton-y map (numpy).

    map_size in degrees; resolution in pixels. L_box/n_mesh give the comoving
    cell volume of the training simulation (400 Mpc/h / 2048 mesh for
    BAHAMAS; process_SLICS.py:49). The planes are arrays or tensors; the map
    is accumulated on ``device`` (default: the planes' device when they are
    tensors, else the card).
    """
    if len(painted_planes) != len(z):
        raise ValueError("painted_planes and z must have the same length.")
    h = cosmo.h
    theta_pix = map_size / resolution * np.pi / 180.0
    A_pix_eff = effective_pixel_areas(cosmo, z, theta_pix)

    # sigma_T/m_e c^2 in Mpc^2/eV (process_SLICS.py:41-50)
    y_fac = const.Y_FAC_SI * const.EV * const.MPC ** -2
    V_c = (L_box / h / n_mesh * const.MPC / const.CM) ** 3  # cell volume cm^3

    device = device_of(painted_planes[0] if len(painted_planes) else None,
                       device)
    y_map = torch.zeros((resolution, resolution), dtype=torch.float32,
                        device=device)
    for i, d in enumerate(painted_planes):
        zoom_factor = resolution / d.shape[0]
        plane = torch.nan_to_num(to_device(d, device, torch.float32))
        plane = plane * float(V_c * (const.XE + const.XI) / const.XE * y_fac
                              / A_pix_eff[i] / zoom_factor ** 2)
        if verbose:
            print(f"z : {z[i]:0.3f}, plane shape: {d.shape}, "
                  f"zoom_factor: {zoom_factor:0.3f}")
        y_map = y_map + resize_spline(plane, (resolution, resolution),
                                      order=order, mode="mirror")
    return y_map.cpu().numpy()
