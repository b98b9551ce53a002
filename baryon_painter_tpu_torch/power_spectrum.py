"""2-D pseudo power spectrum estimator (auto and cross), in PyTorch.

Port of ``baryon_painter_tpu/power_spectrum.py``, the replacement for
``cosmotools.power_spectrum_tools.pseudo_Pofk`` that the reference's
validation metrics use (baryon_painter/utils/validation_plotting.py:120-121).

Convention
----------
For a field delta sampled on an (N, N) grid of physical size L (Mpc/h per
side), with unnormalized DFT ``d_k = sum_x delta(x) exp(-i k.x)``:

    P(k) = (L^2 / N^4) * Re[ a_k * conj(b_k) ]

so white noise of pixel variance sigma^2 has flat P(k) = sigma^2 (L/N)^2,
and k = 2*pi*m/L for integer mode vectors m. Modes are binned in |k| with
log- or linearly-spaced bins; the DC mode is excluded.

Returns mirror the reference call signature: (Pk, k, Pk_var, n_mode), as
f32 tensors on the device the spectrum was computed on.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from baryon_painter_tpu_torch.utils.platform import device_of, to_device

__all__ = ["pseudo_pofk_2d", "k_grid", "bin_edges"]


def k_grid(n: int, L: float) -> np.ndarray:
    """|k| for every 2-D FFT mode of an (n, n) grid of size L (host-side)."""
    f = np.fft.fftfreq(n) * n  # integer mode numbers
    kx = 2 * np.pi / L * f
    return np.sqrt(kx[:, None] ** 2 + kx[None, :] ** 2)


def bin_edges(k_min: float, k_max: float, n_k_bin: int,
              logspaced: bool) -> np.ndarray:
    if logspaced:
        return np.logspace(np.log10(k_min), np.log10(k_max), n_k_bin + 1)
    return np.linspace(k_min, k_max, n_k_bin + 1)


@functools.lru_cache(maxsize=8)
def _binning(n: int, L: float, k_min: float, k_max: float, n_k_bin: int,
             logspaced: bool):
    """Host-side mode binning: the flat indices of the binned modes sorted
    by bin, each bin's mode count and mean |k| (cached: read only).

    Edge comparisons use a relative tolerance, and the last bin is closed:
    fftfreq(n)*n and logspace(log10(k_min), ...) each carry ~1-ulp
    roundoff, so with the default k_min = 2*pi/L the four fundamental modes
    would land just below edges[0] and leave the first bin silently EMPTY
    (and exact-Nyquist modes would fall off the right-open last bin). 1e-9
    relative is ~1e6 ulps yet far smaller than any bin width, so the
    assignment is deterministic.
    """
    kk = k_grid(n, L).ravel()
    edges = bin_edges(k_min, k_max, n_k_bin, logspaced)
    rel = 1e-9
    bin_id = np.digitize(kk, edges * (1.0 - rel)) - 1
    bin_id = np.where((bin_id == n_k_bin) & (kk <= edges[-1] * (1.0 + rel)),
                      n_k_bin - 1, bin_id)
    valid = (kk > 0) & (bin_id >= 0) & (bin_id < n_k_bin)
    modes = np.nonzero(valid)[0]
    order = modes[np.argsort(bin_id[modes], kind="stable")]
    counts = np.bincount(bin_id[modes], minlength=n_k_bin)
    k_sum = np.bincount(bin_id[modes], weights=kk[modes], minlength=n_k_bin)
    return order, counts, k_sum / np.maximum(counts, 1)


def pseudo_pofk_2d(a, b=None, L: float = 100.0,
                   k_min: Optional[float] = None,
                   k_max: Optional[float] = None,
                   n_k_bin: int = 20,
                   logspaced_k_bins: bool = True,
                   device=None):
    """Binned auto/cross power spectrum of 2-D fields, in f32.

    Arguments
    ---------
    a, b : (..., N, N) tensors or arrays. ``b=None`` gives the auto spectrum
        of ``a``. Computed on ``device`` (default: ``a``'s device when it is
        a tensor, else the card).
    L : physical size of the field (Mpc/h).
    k_min, k_max : bin range; defaults to the fundamental mode 2*pi/L and the
        Nyquist frequency pi*N/L (validation_plotting.py:93-94).
    n_k_bin, logspaced_k_bins : binning config.

    Returns
    -------
    (Pk, k, Pk_var, n_mode): Pk has shape (..., n_k_bin); k and n_mode are
    shared across the batch. Each bin is summed as one reduction over its
    modes (gathered in bin order): the same bits on every run, which a
    scatter-add (atomics on CUDA) would not give.
    """
    device = device_of(a, device)
    a = to_device(a, device).float()
    b = a if b is None else to_device(b, device).float()
    if a.shape != b.shape:
        raise ValueError(f"Field shapes must match: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}.")
    if a.shape[-1] != a.shape[-2]:
        raise ValueError(f"Fields must be square, got {tuple(a.shape)}.")
    n = a.shape[-1]
    if k_min is None:
        k_min = 2 * np.pi / L
    if k_max is None:
        k_max = 2 * np.pi / L * (n / 2)
    order, counts, k_mean = _binning(n, float(L), float(k_min), float(k_max),
                                     int(n_k_bin), bool(logspaced_k_bins))
    batch_shape = a.shape[:-2]
    a_k = torch.fft.fft2(a.reshape(-1, n, n))
    b_k = a_k if b is a else torch.fft.fft2(b.reshape(-1, n, n))
    power = (a_k * b_k.conj()).real * (L * L / float(n) ** 4)

    flat = power.reshape(power.shape[0], -1)[:, to_device(order, device)]
    parts = torch.split(flat, counts.tolist(), dim=1)
    s1 = torch.stack([p.sum(dim=1) for p in parts], dim=1)
    s2 = torch.stack([(p * p).sum(dim=1) for p in parts], dim=1)
    n_mode = to_device(counts, device, torch.float32)
    n1 = n_mode.clamp(min=1)
    mean = s1 / n1
    # clamp: the one-pass form can go ~1e-7*s2/n negative in f32 through
    # cancellation, and sqrt(Pk_var) must not be NaN
    var = (s2 / n1 - mean ** 2).clamp(min=0.0)
    # variance of the binned estimate. NOTE: n_mode counts +k and -k of a
    # real field separately (their power is identical), so this
    # underestimates the variance of the mean by ~2x; scale by
    # sqrt(2/n_mode) for error bars on real fields.
    out_shape = batch_shape + (n_k_bin,)
    return (mean.reshape(out_shape),
            to_device(k_mean, device, torch.float32),
            (var / n1).reshape(out_shape), n_mode)
