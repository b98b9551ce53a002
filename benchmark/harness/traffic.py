"""The benchmark's general generator of inputs, driven by a traffic file.

Every random number comes from the run's ``--seed`` (or, for the training
stacks, from the traffic file's fixed ``data_seed``), drawn on the device
in a few large calls. The fields are the benchmark's device copy of
``data/synthetic.py``'s default fields, the kind the committed painters
were trained on: a lognormal of white noise under a Gaussian filter
exp(-k^2 / 2 k0^2) + 1e-3, k0 = n / (2 corr_scale), of log-std ``sigma``.
Two kinds of traffic exist:

``paint_sheets``: a pool of ``pool`` dark-matter sheets of ``sheet``^2
pixels, each the mean of two such fields (the 100 and 150 Mpc/h depths a
training sample sums), cut into (sheet / tile)^2 tiles that one call
paints together, and scaled at each redshift of the checkpoint's grid to
the checkpoint's own mean of its input field there. Call i takes sheet
``sheet[i]`` at redshift ``z[i]`` and prior noise ``eps_pool[eps[i]]``,
drawn from the seed; every seed gives the same sizes, so the work a call
does is the same whatever the seed.

``train_stacks``: synthetic BAHAMAS-like stacks: per (redshift, depth) a
dark-matter field of mean 1 + z and a pressure field coupled to it,
|smooth(dm)|^gamma times a lognormal scatter, of mean 0.3 (1 + z);
``n_stack`` stacks of ``n_grid``^2 per field, redshift and depth, with
their means and variances.
"""
from __future__ import annotations

import math

import numpy as np
import torch

__all__ = ["seed_rng", "cuda_generator", "correlated_lognormal",
           "paint_pool", "paint_schedule", "round_to", "train_stacks",
           "sample_batches"]


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """A numpy generator of one stream of the run's seed."""
    return np.random.default_rng(np.random.SeedSequence([int(seed), stream]))


def cuda_generator(seed: int, stream: int, device) -> torch.Generator:
    """A torch generator on ``device`` seeded from (seed, stream)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.SeedSequence([int(seed), stream])
                      .generate_state(1, np.uint64)[0]) & (2 ** 63 - 1))
    return g


def _kgrid(n: int, device):
    f = torch.fft.fftfreq(n, d=1.0 / n, device=device)
    return torch.sqrt(f[:, None] ** 2 + f[None, :] ** 2)


def correlated_lognormal(gen, count: int, n: int, corr_scale: float,
                         sigma: float, device) -> torch.Tensor:
    """(count, n, n) f32 lognormal fields of mean 1 (module docstring)."""
    k = _kgrid(n, device)
    filt = torch.exp(-0.5 * (k / (n / corr_scale / 2)) ** 2) + 1e-3
    white = torch.randn((count, n, n), generator=gen, device=device)
    g = torch.fft.ifft2(torch.fft.fft2(white) * filt).real
    out = torch.exp(g / g.std(dim=(1, 2), keepdim=True) * sigma)
    return (out / out.mean(dim=(1, 2), keepdim=True)).float()


def paint_pool(traffic: dict, seed: int, means, device) -> torch.Tensor:
    """The sheets' tiles at each redshift: (len(means), pool,
    (sheet/tile)^2, tile, tile), sheet j at redshift z scaled to
    ``means[z]``."""
    gen = cuda_generator(seed, 1, device)
    n, t, p = traffic["sheet"], traffic["tile"], traffic["pool"]
    sheets = correlated_lognormal(gen, 2 * p, n, traffic["corr_scale"],
                                  traffic["sigma"], device)
    sheets = sheets.reshape(p, 2, n, n).mean(dim=1)
    m = n // t
    tiles = sheets.reshape(p, m, t, m, t).permute(0, 1, 3, 2, 4).reshape(
        p, m * m, t, t)
    means = torch.as_tensor(means, dtype=torch.float32, device=device)
    return (tiles[None] * means[:, None, None, None, None]).contiguous()


def paint_schedule(traffic: dict, seed: int, n_z: int, calls: int) -> dict:
    """The first ``calls`` calls' sheet, redshift index and noise index,
    and the reservoir's draws (``check`` in [0, i] for call i)."""
    rng = seed_rng(seed, 2)
    return {"sheet": rng.integers(0, traffic["pool"], calls),
            "z": rng.integers(0, n_z, calls),
            "eps": rng.integers(0, traffic["eps_pool"], calls),
            "check": np.floor(rng.random(calls)
                              * (np.arange(calls) + 1)).astype(np.int64)}


def round_to(x: torch.Tensor, dtype: str) -> torch.Tensor:
    """x (f32) rounded to ``dtype`` and back: values both sides read
    exactly."""
    if dtype == "bfloat16":
        return x.to(torch.bfloat16).float()
    return x.float()


def _smooth(x, sigma: float):
    n = x.shape[-1]
    f = torch.fft.fftfreq(n, d=1.0 / n, device=x.device)
    k2 = f[:, None] ** 2 + f[None, :] ** 2
    filt = torch.exp(-0.5 * k2 * (2 * math.pi * sigma / n) ** 2)
    return torch.fft.ifft2(torch.fft.fft2(x) * filt).real


def train_stacks(traffic: dict, device) -> dict:
    """The training stacks as a dataset's ``data`` dict: data[field][z] =
    {"100": (S, G, G) f32 numpy, "150": ..., "mean_100": float, ...}, made
    on ``device`` from the traffic's ``data_seed`` and copied to the host
    once."""
    gen = cuda_generator(traffic["data_seed"], 0, device)
    n, s = traffic["n_grid"], traffic["n_stack"]
    data = {"dm": {}, "pressure": {}}
    for z in traffic["redshifts"]:
        for f in data:
            data[f][z] = {}
        for depth in ("100", "150"):
            dm = (1 + z) * correlated_lognormal(
                gen, s, n, traffic["corr_scale"], traffic["sigma"], device)
            scatter = torch.exp(traffic["pressure_noise"] * torch.randn(
                (s, n, n), generator=gen, device=device))
            p = (_smooth(dm, traffic["pressure_smooth"]).abs()
                 ** traffic["pressure_gamma"]) * scatter
            p = p * (0.3 * (1 + z) / p.mean(dim=(1, 2), keepdim=True))
            for f, arr in (("dm", dm), ("pressure", p)):
                arr = arr.float()
                a64 = arr.double()
                data[f][z][depth] = arr.cpu().numpy()
                data[f][z][f"mean_{depth}"] = float(a64.mean())
                data[f][z][f"var_{depth}"] = float(a64.var(unbiased=False))
    return data


def sample_batches(n_total: int, batch: int, seed: int, distinct: int,
                   steps: int) -> np.ndarray:
    """(steps, batch) sample indices drawn from the seed: the first
    ``distinct`` steps' rows all differ, the rest uniform."""
    rng = seed_rng(seed, 3)
    first = rng.choice(n_total, size=distinct * batch, replace=False)
    rest = rng.integers(0, n_total, (steps - distinct) * batch)
    return np.concatenate([first, rest]).reshape(steps, batch)
