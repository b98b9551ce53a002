"""Synthetic BAHAMAS-like stack fixtures for hermetic tests and benchmarks.

Generates the same on-disk layout the real preprocessing produces
(.npy stacks of shape (n_stack, n_grid, n_grid) per field/redshift/depth plus
a *_files_info pickle — see reference datasets.py:137-163), filled with
positive lognormal-ish random fields with mild spatial correlation so that the
shift-log transforms and P(k) metrics behave like they do on real data.

A copy of ``baryon_painter_tpu/data/synthetic.py`` (pure Python and
numpy): the port imports nothing of the JAX package, whose ``__init__``
imports jax.
"""
from __future__ import annotations

import os
import pickle
from typing import List, Sequence

import numpy as np


def _correlated_lognormal(rng, shape, corr_scale=4.0, sigma=1.0, mean=1.0):
    """Positive random field with a red-ish spectrum via FFT filtering."""
    white = rng.standard_normal(shape).astype(np.float32)
    n = shape[-1]
    f = np.fft.fftfreq(n) * n
    k = np.sqrt(f[:, None] ** 2 + f[None, :] ** 2)
    filt = np.exp(-0.5 * (k / (n / corr_scale / 2)) ** 2) + 1e-3
    g = np.fft.ifft2(np.fft.fft2(white) * filt).real
    g = g / g.std() * sigma
    out = np.exp(g.astype(np.float32))
    return out * (mean / out.mean())


def _powerlaw_lognormal(rng, shape, slope=-2.2, sigma=1.0, mean=1.0,
                        k_cut=2.0):
    """Lognormal field whose Gaussian precursor has P(k) ∝ k^slope.

    Projected BAHAMAS density slices have a steeply falling power-law
    spectrum over the tile's dynamic range (the validation band of
    reference validation_plotting.py:148 sits on such spectra), unlike the
    Gaussian-bump spectrum of :func:`_correlated_lognormal`. ``k_cut``
    suppresses the largest modes (|k| < k_cut in grid units) so single
    tiles are not dominated by one super-tile mode.
    """
    white = rng.standard_normal(shape).astype(np.float32)
    n = shape[-1]
    f = np.fft.fftfreq(n) * n
    k = np.sqrt(f[:, None] ** 2 + f[None, :] ** 2)
    amp = np.zeros_like(k)
    nz = k > 0
    amp[nz] = k[nz] ** (slope / 2.0)
    amp[k < k_cut] = 0.0  # also zeroes DC
    g = np.fft.ifft2(np.fft.fft2(white) * amp).real
    g = (g / g.std() * sigma).astype(np.float32)
    # exp(g - sigma^2/2) has unit mean for Gaussian g
    out = np.exp(g - 0.5 * sigma * sigma)
    return (out * (mean / out.mean())).astype(np.float32)


def _smooth(x, sigma=1.5):
    n = x.shape[-1]
    f = np.fft.fftfreq(n) * n
    k2 = f[:, None] ** 2 + f[None, :] ** 2
    filt = np.exp(-0.5 * k2 * (2 * np.pi * sigma / n) ** 2)
    return np.fft.ifft2(np.fft.fft2(x) * filt).real.astype(np.float32)


def make_synthetic_stacks(root: str,
                          fields: Sequence[str] = ("dm", "pressure"),
                          redshifts: Sequence[float] = (0.0, 0.5, 1.0),
                          n_stack: int = 3,
                          n_grid: int = 64,
                          seed: int = 0,
                          name: str = "test",
                          pressure_gamma: float = 1.5,
                          pressure_noise: float = 0.1,
                          spectrum: str = "gaussian",
                          spectrum_slope: float = -2.2,
                          sigma0: float = 1.0,
                          pressure_smooth: float = 1.5,
                          pressure_noise_corr: float = 0.0) -> str:
    """Write synthetic stacks + file_info pickle under ``root``.

    The 'pressure' field is physically coupled to 'dm' of the same stack
    (a smoothed polytropic P ~ rho^gamma with multiplicative noise), so that
    models trained on the fixture genuinely learn a dm->pressure mapping and
    P(k) fidelity metrics are meaningful. Other fields are independent
    lognormal draws. Returns the path of the files-info pickle.

    ``spectrum="powerlaw"`` selects the more BAHAMAS-like statistics:
    density is lognormal over a Gaussian precursor with P(k) ∝ k^slope
    (falling power law instead of the default Gaussian bump), fluctuation
    amplitude grows toward low redshift like a growth factor
    (sigma(z) = sigma0 / (1 + z)), pressure is smoothed over
    ``pressure_smooth`` pixels (gas is puffier than DM), and
    ``pressure_noise_corr`` > 0 makes the multiplicative scatter spatially
    correlated over that many pixels (scale-dependent conditional variance —
    the structure a conditional generative painter must actually capture).
    The default arguments reproduce the historical fixture exactly.
    """
    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)

    def draw_density(z, mean):
        if spectrum == "powerlaw":
            return _powerlaw_lognormal(rng, (n_grid, n_grid),
                                       slope=spectrum_slope,
                                       sigma=sigma0 / (1.0 + z), mean=mean)
        return _correlated_lognormal(rng, (n_grid, n_grid), sigma=sigma0,
                                     mean=mean)

    def pressure_scatter(shape):
        # float64 until the final cast — keeps the default path bit-identical
        # to the historical fixture (committed artifacts re-evaluate on it)
        eps = rng.standard_normal(shape)
        if pressure_noise_corr > 0:
            eps = _smooth(eps.astype(np.float32),
                          sigma=pressure_noise_corr).astype(np.float64)
            eps /= max(eps.std(), 1e-12)
        return np.exp(pressure_noise * eps).astype(np.float32)

    data = {f: {z: {} for z in redshifts} for f in fields}
    for z in redshifts:
        for depth in ("100", "150"):
            dms, extras = [], {f: [] for f in fields if f not in ("dm", "pressure")}
            pressures = []
            for _ in range(n_stack):
                dm = draw_density(z, mean=1.0 * (1 + z))
                dms.append(dm)
                if "pressure" in fields:
                    p = _smooth(dm, sigma=pressure_smooth) ** pressure_gamma
                    p = np.abs(p) * pressure_scatter(dm.shape)
                    p *= 0.3 * (1 + z) / p.mean()
                    pressures.append(p.astype(np.float32))
                for f in extras:
                    extras[f].append(draw_density(z, mean=0.5 * (1 + z)))
            if "dm" in fields:
                data["dm"][z][depth] = np.stack(dms)
            if "pressure" in fields:
                data["pressure"][z][depth] = np.stack(pressures)
            for f in extras:
                data[f][z][depth] = np.stack(extras[f])

    files: List[dict] = []
    for field in fields:
        for z in redshifts:
            entry = {"field": field, "z": z}
            for depth in ("100", "150"):
                stacks = data[field][z][depth]
                fn = f"{field}_z{z:.3f}_{depth}.npy"
                np.save(os.path.join(root, fn), stacks)
                entry[f"file_{depth}"] = fn
                entry[f"mean_{depth}"] = float(stacks.mean())
                entry[f"var_{depth}"] = float(stacks.var())
            files.append(entry)
    info_path = os.path.join(root, f"{name}_files_info.pickle")
    with open(info_path, "wb") as f:
        pickle.dump(files, f)
    return info_path
