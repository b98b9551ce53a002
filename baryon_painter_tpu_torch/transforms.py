"""Invertible field transforms on tensors.

Port of ``baryon_painter_tpu/transforms.py``: the range-compression family,
the density contrast and the identity, each a declarative spec with
``forward``/``inverse`` on tensors, plus per-field redshift statistics.
The formulas are the JAX package's term for term, including the shift-log
NaN floor. ``SplitScale``, ``ChainTransform`` and ``gaussian_filter_2d``
are not ported yet: no committed CVAE checkpoint uses them.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

__all__ = ["FieldStats", "RangeCompress", "ToDelta", "Identity",
           "transform_from_dict"]


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

    @classmethod
    def from_dict(cls, d):
        return cls()


@dataclasses.dataclass(frozen=True)
class Identity:
    def forward(self, x, stats=None, z=None):
        return x

    def inverse(self, x, stats=None, z=None):
        return x

    @classmethod
    def from_dict(cls, d):
        return cls()


_REGISTRY = {
    "range_compress": RangeCompress,
    "to_delta": ToDelta,
    "identity": Identity,
}


def transform_from_dict(d: dict):
    """Rebuild a transform from its declarative JSON dict."""
    kind = d.get("type")
    if kind in ("split_scale", "chain"):
        raise NotImplementedError(
            f"Transform type '{kind}' is not ported yet.")
    try:
        cls = _REGISTRY[kind]
    except KeyError:
        raise ValueError(f"Unknown transform type '{kind}'.") from None
    return cls.from_dict(d)
