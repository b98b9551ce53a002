"""Invertible field transforms on tensors.

Port of ``baryon_painter_tpu/transforms.py``: the range-compression family,
the density contrast, the identity, the split-scale (Gaussian pyramid)
split and the chain of transforms, each a declarative spec with
``forward``/``inverse`` on tensors of any device, plus per-field redshift
statistics. The formulas are the JAX package's term for term, including
the shift-log NaN floor; ``to_dict`` writes the spec a checkpoint's
metadata holds, the JAX package's dict unchanged.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from baryon_painter_tpu_torch.utils.platform import f32_convolutions

__all__ = ["FieldStats", "RangeCompress", "ToDelta", "SplitScale",
           "ChainTransform", "Identity", "transform_from_dict",
           "gaussian_filter_2d"]


@dataclasses.dataclass(frozen=True)
class FieldStats:
    """Mean/variance tables over a redshift grid for one field."""

    z_grid: torch.Tensor  # (n_z,) strictly increasing
    mean: torch.Tensor    # (n_z,)
    var: torch.Tensor     # (n_z,)

    def at_z(self, z):
        """Linear interpolation of (mean, var) to redshift ``z``, clamped
        outside the grid. Same cumulative form as the JAX package:
        v(z) = v[0] + sum_i clip((z - t_i)/(t_{i+1} - t_i), 0, 1) * dv_i."""
        z = torch.as_tensor(z, dtype=self.z_grid.dtype,
                            device=self.z_grid.device)
        t = self.z_grid
        frac = torch.clamp((z[..., None] - t[:-1]) / (t[1:] - t[:-1]),
                           0.0, 1.0)
        mean = self.mean[0] + (frac * torch.diff(self.mean)).sum(-1)
        var = self.var[0] + (frac * torch.diff(self.var)).sum(-1)
        return mean, var

    def to_dict(self):
        as_list = lambda t: t.detach().cpu().numpy().tolist()
        return {"z_grid": as_list(self.z_grid), "mean": as_list(self.mean),
                "var": as_list(self.var)}

    @classmethod
    def from_dict(cls, d, device=None):
        as_t = lambda v: torch.tensor(v, dtype=torch.float32, device=device)
        return cls(z_grid=as_t(d["z_grid"]), mean=as_t(d["mean"]),
                   var=as_t(d["var"]))


def _broadcast_stat(s, x):
    """Broadcast a per-sample scalar stat against trailing image dims of x."""
    if s.ndim == 0:
        return s
    return s.reshape(s.shape + (1,) * (x.ndim - s.ndim))


_MODES = ("log", "shift-log", "shift-log-2p", "log-tanh", "x/(1+x)", "1/x")


@dataclasses.dataclass(frozen=True)
class RangeCompress:
    """Invertible range compression; all 6 modes of the JAX package
    (the fiducial config is ``mode='shift-log', k=4``: log(x/sigma + 1)/k)."""

    mode: str
    k: Any  # float or 2-sequence, mode-dependent
    eps: float = 1e-3
    sqrt_of_mean: bool = False

    def __post_init__(self):
        if self.mode not in _MODES:
            raise ValueError(
                f"Mode '{self.mode}' not supported; use one of {_MODES}.")

    def _mean_std(self, stats: FieldStats, z, x):
        mean, var = stats.at_z(z)
        if self.sqrt_of_mean:
            mean = torch.sqrt(mean)
        std = torch.sqrt(var)
        return _broadcast_stat(mean, x), _broadcast_stat(std, x)

    def forward(self, x, stats: FieldStats, z):
        k, eps, mode = self.k, self.eps, self.mode
        mean, std = self._mean_std(stats, z, x)
        if mode == "log":
            pos = x > 0
            return torch.where(
                pos, torch.log(torch.where(pos, x, 1.0) / std + eps) / k,
                math.log(eps) / k)
        if mode == "shift-log":
            # Floor the log argument at eps (a spline zoom can overshoot
            # below zero, and x/std + 1 <= 0 would paint NaN through the
            # convs). clamp keeps NaN inputs NaN, as jnp.maximum does.
            return torch.log(torch.clamp(x / std + 1, min=eps)) / k
        if mode == "shift-log-2p":
            # the same floor, capped at the mode's own shift k[0]
            return (torch.log(torch.clamp(x / std + k[0], min=min(eps, k[0])))
                    / k[1])
        if mode == "log-tanh":
            pos = x > 0
            return torch.where(
                pos,
                torch.tanh(torch.log(torch.where(pos, x, 1.0) / std + eps)
                           / k),
                -1.0)
        if mode == "x/(1+x)":
            return x / (x + std) * k[0] - k[1]
        if mode == "1/x":
            u = x / (std * mean * k)
            return torch.where(u > -1, 2 / (u + 1) - 1.001, -1.0)
        raise AssertionError(mode)

    def inverse(self, x, stats: FieldStats, z):
        k, eps, mode = self.k, self.eps, self.mode
        mean, std = self._mean_std(stats, z, x)
        if mode == "log":
            return torch.where(x > math.log(eps) / k,
                               (torch.exp(x * k) - eps) * std, 0.0)
        if mode == "shift-log":
            return (torch.exp(x * k) - 1) * std
        if mode == "shift-log-2p":
            return (torch.exp(x * k[1]) - k[0]) * std
        if mode == "log-tanh":
            xc = torch.clamp(x, -1 + 1e-7, 1 - 1e-7)
            return torch.where(
                x > -1, (torch.exp(torch.atanh(xc) * k) - eps) * std, 0.0)
        if mode == "x/(1+x)":
            return std / (k[0] / (x + k[1]) - 1)
        if mode == "1/x":
            # the forward map's range reaches down to -1.001
            return torch.where(x > -1.001,
                               (2 / (x + 1.001) - 1) * std * mean * k, 0.0)
        raise AssertionError(mode)

    def to_dict(self):
        k = list(self.k) if isinstance(self.k, (tuple, list)) else self.k
        return {"type": "range_compress", "mode": self.mode, "k": k,
                "eps": self.eps, "sqrt_of_mean": self.sqrt_of_mean}

    @classmethod
    def from_dict(cls, d):
        k = tuple(d["k"]) if isinstance(d["k"], list) else d["k"]
        return cls(mode=d["mode"], k=k, eps=d.get("eps", 1e-3),
                   sqrt_of_mean=d.get("sqrt_of_mean", False))


@dataclasses.dataclass(frozen=True)
class ToDelta:
    """x -> x/mean - 1 (density contrast)."""

    def forward(self, x, stats: FieldStats, z):
        mean, _ = stats.at_z(z)
        return x / _broadcast_stat(mean, x) - 1

    def inverse(self, x, stats: FieldStats, z):
        mean, _ = stats.at_z(z)
        return (x + 1) * _broadcast_stat(mean, x)

    def to_dict(self):
        return {"type": "to_delta"}

    @classmethod
    def from_dict(cls, d):
        return cls()


def _gaussian_kernel_1d(sigma: float, truncate: float = 3.0) -> np.ndarray:
    """scipy.ndimage.gaussian_filter1d's kernel construction."""
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    phi = np.exp(-0.5 * x * x / (sigma * sigma))
    return (phi / phi.sum()).astype(np.float32)


def _symmetric_index(n: int, r: int) -> np.ndarray:
    """The source index of each of the n + 2r positions of numpy's
    ``pad(mode="symmetric")`` (scipy.ndimage's 'reflect'): the edge sample
    repeated, then mirrored, with period 2n for pads wider than n."""
    j = np.arange(-r, n + r) % (2 * n)
    return np.where(j >= n, 2 * n - 1 - j, j)


def gaussian_filter_2d(x, sigma: float, truncate: float = 3.0):
    """Separable Gaussian blur over the last two axes of (..., H, W).

    The boundary is scipy.ndimage's default mode='reflect' (numpy's
    'symmetric' pad); each axis is one f32 ``conv1d`` over the padded
    rows (TF32 off), as the JAX package convolves at precision 'highest'.
    Differentiable; on ``x``'s device."""
    kernel = torch.as_tensor(_gaussian_kernel_1d(sigma, truncate),
                             device=x.device).to(x.dtype)
    r = kernel.shape[0] // 2

    def blur_last(y):
        shape = y.shape
        idx = torch.as_tensor(_symmetric_index(shape[-1], r),
                              device=y.device)
        flat = y.index_select(-1, idx).reshape(-1, 1, shape[-1] + 2 * r)
        return F.conv1d(flat, kernel.view(1, 1, -1)).reshape(shape)

    with f32_convolutions():
        y = blur_last(x.transpose(-1, -2)).transpose(-1, -2)
        return blur_last(y)


@dataclasses.dataclass(frozen=True)
class SplitScale:
    """Gaussian-pyramid split of a tile into frequency bands: channel 0
    optionally carries the original; the other channels sum back to it.
    Input (..., H, W) -> output (..., n_out, H, W)."""

    n_scale: int = 3
    step_size: int = 4
    include_original: bool = True
    truncate: float = 3.0

    @property
    def n_out(self):
        return self.n_scale + 1 if self.include_original else self.n_scale

    def forward(self, x, stats=None, z=None):
        bands = []
        d_in = x
        for i in range(self.n_scale - 1, 0, -1):
            smooth = gaussian_filter_2d(d_in, sigma=self.step_size ** i / 2,
                                        truncate=self.truncate)
            bands.append(smooth)
            d_in = d_in - smooth
        bands.append(d_in)
        bands = bands[::-1]  # finest first, the reference's layout
        if self.include_original:
            bands = [x] + bands
        return torch.stack(bands, dim=-3)

    def inverse(self, x, stats=None, z=None):
        if x.shape[-3] != self.n_out:
            raise ValueError(f"Invalid shape: expected {self.n_out} scales, "
                             f"got {x.shape[-3]}.")
        if self.include_original:
            return x[..., 0, :, :]
        return x.sum(dim=-3)

    def to_dict(self):
        return {"type": "split_scale", "n_scale": self.n_scale,
                "step_size": self.step_size,
                "include_original": self.include_original,
                "truncate": self.truncate}

    @classmethod
    def from_dict(cls, d):
        return cls(n_scale=d["n_scale"], step_size=d["step_size"],
                   include_original=d["include_original"],
                   truncate=d.get("truncate", 3.0))


@dataclasses.dataclass(frozen=True)
class ChainTransform:
    """Sequential composition; ``inverse`` applies the inverses in reverse
    order."""

    steps: tuple

    def forward(self, x, stats: FieldStats, z):
        for t in self.steps:
            x = t.forward(x, stats, z)
        return x

    def inverse(self, x, stats: FieldStats, z):
        for t in reversed(self.steps):
            x = t.inverse(x, stats, z)
        return x

    def to_dict(self):
        return {"type": "chain", "steps": [t.to_dict() for t in self.steps]}

    @classmethod
    def from_dict(cls, d):
        return cls(steps=tuple(transform_from_dict(s) for s in d["steps"]))


@dataclasses.dataclass(frozen=True)
class Identity:
    def forward(self, x, stats=None, z=None):
        return x

    def inverse(self, x, stats=None, z=None):
        return x

    def to_dict(self):
        return {"type": "identity"}

    @classmethod
    def from_dict(cls, d):
        return cls()


_REGISTRY = {
    "range_compress": RangeCompress,
    "to_delta": ToDelta,
    "split_scale": SplitScale,
    "chain": ChainTransform,
    "identity": Identity,
}


def transform_from_dict(d: dict):
    """Rebuild a transform from its declarative JSON dict."""
    kind = d.get("type")
    try:
        cls = _REGISTRY[kind]
    except KeyError:
        raise ValueError(f"Unknown transform type '{kind}'.") from None
    return cls.from_dict(d)
