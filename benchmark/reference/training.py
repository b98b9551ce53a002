"""The reference training steps: batches assembled from the raw stacks,
the CVAE's negative ELBO, autograd and Adam, in plain PyTorch.

``batch`` decodes a sample index into its digits (redshift, the two
tiles' dihedral permutations, stacks and positions: the mixed radix
(n_z, 8, 8, S, T, T, S, T, T), most significant first), cuts the tiles of
the 100 and 150 Mpc/h stacks, applies the permutations (rot90 rot times,
then a flip of the last axis; perm = 2 rot + flip), sums them and scales
the dark matter to SLICS. ``steps`` runs the first steps from the initial
state and returns the readings the benchmark compares: each step's loss,
each parameter's first gradient norm and its change after the steps.
"""
from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import models, nets
from benchmark.reference.painting import tf32_off

__all__ = ["slics_scale", "batch", "field_stats", "steps"]


def slics_scale(n_grid: int) -> float:
    """The dark matter's rescaling to SLICS' delta planes."""
    return 1.0 / (n_grid / 8 * 5) * 0.2793 / (0.2793 - 0.0463)


def _dihedral(tile: np.ndarray, perm: int) -> np.ndarray:
    rot, flip = divmod(int(perm), 2)
    out = np.rot90(tile, k=rot, axes=(-2, -1))
    return out[..., ::-1] if flip else out


def batch(data: dict, redshifts, n_tile: int, n_stack: int, idx):
    """(dm, pressure, z) numpy batches of the sample indices ``idx``."""
    n_z = len(redshifts)
    g = data["dm"][redshifts[0]]["100"].shape[-1]
    t = g // n_tile
    digits = np.unravel_index(np.asarray(idx, np.int64),
                              (n_z, 8, 8, n_stack, n_tile, n_tile, n_stack,
                               n_tile, n_tile))
    out = {"dm": [], "pressure": []}
    for z, p1, p2, s1, x1, y1, s2, x2, y2 in zip(*digits):
        zv = redshifts[z]
        for f in out:
            a = _dihedral(data[f][zv]["100"][s1, x1 * t:(x1 + 1) * t,
                                             y1 * t:(y1 + 1) * t], p1)
            b = _dihedral(data[f][zv]["150"][s2, x2 * t:(x2 + 1) * t,
                                             y2 * t:(y2 + 1) * t], p2)
            out[f].append(a.astype(np.float32) + b.astype(np.float32))
    dm = np.stack(out["dm"]) * np.float32(slics_scale(g))
    z = np.asarray(redshifts, np.float32)[digits[0]]
    return dm.astype(np.float32), np.stack(out["pressure"]), z


def field_stats(data: dict, redshifts, field: str, scale: float = 1.0):
    """{"z_grid", "var"} of a field: the two depths' variances summed (the
    dark matter's times the SLICS scale squared)."""
    var = [(data[field][z]["var_100"] + data[field][z]["var_150"])
           * scale * scale for z in redshifts]
    return {"z_grid": list(redshifts), "var": var}


def steps(config: dict, data: dict, traffic: dict, init: dict, idx, eps,
          device, numerics: str = "f32") -> dict:
    """Run ``len(idx)`` training steps from ``init`` (name -> tensor, the
    parameters and buffers) on the batches ``idx`` with the noise ``eps``
    ((N, Cz, h, w) a step). Returns {"loss": [...], "grad": {name: norm of
    the first step's gradient}, "change": {name: norm of the parameter's
    change over the steps}} as floats."""
    nm = nets.Numerics(numerics)
    arch = config["architecture"]
    zs_grid = traffic["redshifts"]
    g = data["dm"][zs_grid[0]]["100"].shape[-1]
    fin = models.FieldTransform(config["transforms"]["dm"],
                                field_stats(data, zs_grid, "dm",
                                            slics_scale(g)))
    fout = models.FieldTransform(config["transforms"]["pressure"],
                                 field_stats(data, zs_grid, "pressure"))
    names = [n for n, _, _ in models.cvae_param_specs(arch)
             if not n.endswith(("running_mean", "running_var"))]
    params = {n: init[n].detach().to(device, nm.dtype).clone()
              .requires_grad_(True) for n in names}
    start = {n: p.detach().clone() for n, p in params.items()}
    adam = models.Adam({n: p.detach() for n, p in params.items()})
    out = {"loss": [], "grad": None, "change": None}
    with tf32_off():
        for k, rows in enumerate(idx):
            dm, pressure, z = batch(data, zs_grid, traffic["n_tile"],
                                    traffic["n_stack"], rows)
            t = lambda a: torch.as_tensor(a, device=device).to(nm.dtype)
            z = t(z)
            y = fin.forward(t(dm), z)[:, None]
            x = fout.forward(t(pressure), z)[:, None]
            loss = models.cvae_loss(arch, params, x, y, z,
                                    t(eps[k].float().cpu()), nm)
            grads = torch.autograd.grad(loss, list(params.values()))
            grads = dict(zip(params, grads))
            out["loss"].append(float(loss.detach()))
            if k == 0:
                out["grad"] = {n: float(gr.norm()) for n, gr in grads.items()}
            with torch.no_grad():
                adam.step({n: p.data for n, p in params.items()}, grads,
                          traffic["lr"])
    out["change"] = {n: float((p.detach() - start[n]).norm())
                     for n, p in params.items()}
    return out
