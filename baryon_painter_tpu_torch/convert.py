"""Weights carried across: the JAX package's variables into the port's modules.

``from_jax_variables(variables, architecture)`` takes ``{"params",
"batch_stats"}`` as nested dicts of numpy arrays (what
``train.checkpoint.load_checkpoint`` yields, or ``jax.tree.map(np.asarray,
...)`` of live flax variables) and returns an eval-mode ``CVAE`` carrying
them. Layer names match flax's per-class auto-names, so the mapping is one
to one:

  * conv kernels HWIO -> OIHW;
  * transposed-conv kernels: spatial flip plus HWIO -> IOHW, because the JAX
    package computes a transposed conv as an lhs-dilated correlation and
    PyTorch applies its weight as the gradient of a conv;
  * batch norm scale/bias and running mean/var;
  * PReLU slopes;
  * fused residual blocks keep their HWIO kernels (K1 takes HWIO).
"""
from __future__ import annotations

import numpy as np
import torch

from baryon_painter_tpu_torch.models.cvae import CVAE
from baryon_painter_tpu_torch.models.layers import (BatchNorm, Conv2d,
                                                    ConvTranspose2d,
                                                    FusedResBlock, PReLU,
                                                    ResidualBlock,
                                                    SpecSequential)

__all__ = ["from_jax_variables", "load_spec_sequential"]

# CVAE subnets the eval model holds (the recognition net Q is not ported)
_CVAE_SUBNETS = ("p_y_in", "p_z_in", "p_y_z_in", "p_mu_out", "p_var_out",
                 "prior_network")


def _copy(dst: torch.Tensor, a):
    a = np.asarray(a, dtype=np.float32)
    if tuple(a.shape) != tuple(dst.shape):
        raise ValueError(f"shape mismatch: checkpoint {a.shape} vs module "
                         f"{tuple(dst.shape)}")
    # copy: flips give negative strides, and decoded leaves are read-only
    dst.copy_(torch.from_numpy(np.array(a, copy=True)))


@torch.no_grad()
def load_spec_sequential(seq: SpecSequential, params: dict, stats: dict):
    """Copy one flax SpecSequential scope into its torch twin."""
    params = params or {}
    stats = stats or {}
    for name, m in seq.layers.items():
        p, s = params[name], stats.get(name, {})
        if isinstance(m, Conv2d):
            _copy(m.weight, np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
            if m.bias is not None:
                _copy(m.bias, p["bias"])
        elif isinstance(m, ConvTranspose2d):
            k = np.asarray(p["kernel"])
            _copy(m.weight, k[::-1, ::-1].transpose(2, 3, 0, 1))
            if m.bias is not None:
                _copy(m.bias, p["bias"])
        elif isinstance(m, BatchNorm):
            _copy(m.weight, p["scale"])
            _copy(m.bias, p["bias"])
            _copy(m.running_mean, s["mean"])
            _copy(m.running_var, s["var"])
        elif isinstance(m, PReLU):
            _copy(m.weight, p["negative_slope"])
        elif isinstance(m, ResidualBlock):
            load_spec_sequential(m.SpecSequential_0, p["SpecSequential_0"],
                                 s.get("SpecSequential_0", {}))
        elif isinstance(m, FusedResBlock):
            for key in ("conv1_kernel", "conv2_kernel", "bn1_scale",
                        "bn1_bias", "bn2_scale", "bn2_bias"):
                _copy(getattr(m, key), p[key])
            for key in ("bn1_mean", "bn1_var", "bn2_mean", "bn2_var"):
                _copy(getattr(m, key), s[key])
        else:
            raise NotImplementedError(f"no weight mapping for {name}")


def from_jax_variables(variables: dict, architecture: dict) -> CVAE:
    """An eval-mode CVAE (on the CPU) carrying the JAX variables."""
    model = CVAE(architecture)
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    for attr in _CVAE_SUBNETS:
        seq = getattr(model, attr)
        if seq is None:
            continue
        load_spec_sequential(seq, params.get(attr), stats.get(attr))
    return model.eval()
