"""Flat-sky angular (pseudo-Cl) power spectrum estimator, in PyTorch.

Port of ``baryon_painter_tpu/angular_power.py``, the subset of
``cosmotools.pseudo_Cls`` the reference uses to validate assembled Compton-y
maps (notebooks/validation_plots.ipynb's y-map panels): tiles are gated with
P(k) (power_spectrum.py); the assembled lightcone product (periodic tile
gather -> zoom -> paint -> weighted blend -> y integration) is gated here.

Convention
----------
A map sampled on an (N, N) grid spanning an angle ``theta`` (radians per
side), with unnormalized DFT ``a_l = sum_x m(x) exp(-i l.x)``:

    C_l = (theta^2 / N^4) * Re[ a_l * conj(b_l) ]

so white noise of pixel variance sigma^2 has flat C_l = sigma^2 (theta/N)^2
(the pixel solid angle), and l = 2*pi*m/theta for integer mode vectors m:
``pseudo_pofk_2d`` with the box size L replaced by the angular extent. The
default multipole range runs from the fundamental mode 2*pi/theta to the
Nyquist pi*N/theta, log-binned, as the tile P(k) gate bins k.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from baryon_painter_tpu_torch.power_spectrum import pseudo_pofk_2d

__all__ = ["pseudo_cl_2d", "cl_fractional_error"]


def pseudo_cl_2d(a, b=None, theta: float = None, theta_deg: float = None,
                 l_min: Optional[float] = None, l_max: Optional[float] = None,
                 n_l_bin: int = 12, logspaced_l_bins: bool = True,
                 device=None):
    """Binned flat-sky auto/cross angular power spectrum of 2-D maps.

    Arguments
    ---------
    a, b : (..., N, N) maps (e.g. Compton-y), tensors or arrays; ``b=None``
        -> auto spectrum. Computed on ``device`` (``pseudo_pofk_2d``).
    theta / theta_deg : angular size of the map per side, in radians /
        degrees (exactly one must be given).
    l_min, l_max : multipole bin range; defaults to the fundamental mode
        2*pi/theta and the Nyquist pi*N/theta.
    n_l_bin, logspaced_l_bins : binning config.

    Returns
    -------
    (Cl, l, Cl_var, n_mode): Cl has shape (..., n_l_bin); l and n_mode are
    shared across the batch (the contract of pseudo_pofk_2d).
    """
    if (theta is None) == (theta_deg is None):
        raise ValueError("Pass exactly one of theta (radians) or theta_deg.")
    if theta is None:
        theta = np.deg2rad(theta_deg)
    return pseudo_pofk_2d(a, b, L=float(theta), k_min=l_min, k_max=l_max,
                          n_k_bin=n_l_bin, logspaced_k_bins=logspaced_l_bins,
                          device=device)


def cl_fractional_error(map_pred, map_truth, theta_deg: float,
                        n_l_bin: int = 12, cross_with=None, device=None):
    """Per-bin |Cl_pred/Cl_truth - 1| of two maps (the y-map gate metric).

    With ``cross_with`` (e.g. the unpainted density-derived map), the ratio
    is of cross-spectra Cl(pred, cross) / Cl(truth, cross) instead, as the
    tile-level cross-P(k) gate does.

    Returns (frac_err[n_l_bin], l[n_l_bin]) as numpy arrays; bins with no
    modes carry NaN.
    """
    kw = dict(theta_deg=theta_deg, n_l_bin=n_l_bin, device=device)
    cl_p, ell, _, nm = pseudo_cl_2d(map_pred, cross_with, **kw)
    cl_t, *_ = pseudo_cl_2d(map_truth, cross_with, **kw)
    cl_p, cl_t = cl_p.cpu().numpy(), cl_t.cpu().numpy()
    nm = nm.cpu().numpy()
    frac = np.where(nm > 0, np.abs(cl_p / np.where(cl_t != 0, cl_t, np.nan)
                                   - 1.0), np.nan)
    return frac, ell.cpu().numpy()
