"""Conditional VAE, eval methods, NCHW.

Port of ``baryon_painter_tpu/models/cvae.py`` for painting: the prior net
p(z|y), the latent draw z = mu + eps*(exp(logvar/2) + min_z_var), and the
generator P(x|y,z) with its optional predicted variance, with the redshift
merged as a constant feature map. Subnets carry the JAX module's attribute
names (``prior_network``, ``p_z_in``, ``p_y_z_in``, ``p_mu_out``, ...) so
checkpoints map onto them one to one. The recognition net Q and the training
ELBO are not ported yet.
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from baryon_painter_tpu_torch.models import dsl
from baryon_painter_tpu_torch.models.layers import (SpecSequential,
                                                    merge_aux_label)

__all__ = ["CVAE", "fiducial_cvae_architecture"]


def _strip_unflatten(spec):
    if spec is None:
        return None
    return [l for l in spec if str(l[0]).lower() != "unflatten"]


class CVAE(nn.Module):
    """Eval-mode CVAE built from the architecture dict of a checkpoint."""

    def __init__(self, architecture: dict):
        super().__init__()
        arch = architecture
        if arch.get("type", "Type-1") != "Type-1":
            raise NotImplementedError(
                f"Architecture {arch.get('type')} not supported yet!")
        self.architecture = arch
        self.dim_z = tuple(arch["dim_z"])  # channel-first (C,H,W)
        self.use_aux_label = arch.get("aux_label", False)
        self.min_z_var = arch.get("min_z_var", 1e-7)

        fused = arch.get("fused_res_blocks", False)
        mk = lambda key: SpecSequential(_strip_unflatten(arch.get(key)),
                                        fused_res_blocks=fused)
        self.p_y_in = SpecSequential(_strip_unflatten(arch.get("p_y_in")))
        self.p_z_in = mk("p_z_in")
        self.p_y_z_in = mk("p_y_z_in")
        self.p_mu_out = SpecSequential(_strip_unflatten(arch["p_y_z_out"][0]))
        self.predict_var = len(arch["p_y_z_out"]) > 1
        self.p_var_out = (
            SpecSequential(_strip_unflatten(arch["p_y_z_out"][1]))
            if self.predict_var else None)
        self.prior_network = (
            SpecSequential(_strip_unflatten(arch["prior_z_y"]))
            if arch.get("prior_z_y") is not None else None)

    def _merge_aux(self, y, aux_label):
        if aux_label is not None and self.use_aux_label:
            return merge_aux_label(y, aux_label)
        return y

    def _split_heads(self, h):
        """(N,2*Cz,H,W) -> z_mu, z_log_var each (N,Cz,H,W)."""
        cz = self.dim_z[0]
        if h.shape[1] != 2 * cz:
            raise ValueError(
                f"Head produced {h.shape[1]} channels, expected {2 * cz} "
                f"for dim_z={self.dim_z}.")
        return h[:, :cz], h[:, cz:]

    def prior(self, y, aux_label=None):
        """(z_mu, z_log_var) of p(z|y); zeros without a prior net."""
        if self.prior_network is None:
            cz, hz, wz = self.dim_z
            z = torch.zeros((y.shape[0], cz, hz, wz), dtype=y.dtype,
                            device=y.device)
            return z, z
        y = self._merge_aux(y, aux_label)
        return self._split_heads(self.prior_network(y))

    def sample_z(self, z_mu, z_log_var, eps):
        """Reparameterized sample z = mu + eps*(exp(logvar/2) + min_z_var);
        ``eps`` is standard normal noise of z_mu's shape."""
        return z_mu + eps * (torch.exp(z_log_var / 2) + self.min_z_var)

    def P(self, z, y, aux_label=None):
        """Decoder: (x_mu, x_log_var) or (x_mu,), each (N,C_x,H,W)."""
        y = self._merge_aux(y, aux_label)
        h = torch.cat([self.p_z_in(z), self.p_y_in(y)], dim=1)
        h = self.p_y_z_in(h)
        x_mu = self.p_mu_out(h)
        if self.predict_var:
            return x_mu, self.p_var_out(h)
        return (x_mu,)

    def sample_P(self, y, aux_label=None, z=None, eps=None,
                 generator: Optional[torch.Generator] = None,
                 return_var: bool = False):
        """Paint: draw z from the prior (noise ``eps``, else drawn from
        ``generator``) unless ``z`` is given, and decode."""
        if z is None:
            z_mu, z_log_var = self.prior(y, aux_label)
            if eps is None:
                eps = torch.randn(z_mu.shape, generator=generator,
                                  dtype=z_mu.dtype, device=z_mu.device)
            z = self.sample_z(z_mu, z_log_var, eps)
        p = self.P(z, y, aux_label)
        if return_var and self.predict_var:
            return p[0], torch.exp(p[1])
        return p[0]


def fiducial_cvae_architecture(tile_size: int = 512, n_scale: int = 1,
                               n_aux_label: int = 1, n_label_fields: int = 1,
                               n_res_blocks: int = 4,
                               predict_var: bool = True,
                               fused_res_blocks: bool = False,
                               upsample: str = "transpose") -> dict:
    """The fiducial architecture, parameterized by tile size (fully
    convolutional: dim_z scales with it); the JAX package's function."""
    n_x = n_label_fields * n_scale
    dim_x = (n_x, tile_size, tile_size)
    dim_y = (n_scale, tile_size, tile_size)
    dim_z = (1, tile_size // 32, tile_size // 32)

    p_y_z_out_mu = (
        dsl.conv_block(16, 8, kernel=7, bias=False, batchnorm=False,
                       activation="PReLU")
        + dsl.conv_block(8, n_x, kernel=5, bias=False, batchnorm=False,
                         activation="PReLU")
        + dsl.conv_block(n_x, n_x, kernel=3, bias=False, batchnorm=False,
                         activation="softplus"))
    p_y_z_out = [p_y_z_out_mu]
    if predict_var:
        p_y_z_out.append(
            dsl.conv_block(16, 8, kernel=7, bias=False, batchnorm=False,
                           activation="PReLU")
            + dsl.conv_block(8, n_x, kernel=5, bias=False, batchnorm=False,
                             activation="PReLU")
            + dsl.conv_block(n_x, n_x, kernel=3, bias=False, batchnorm=False,
                             activation=None))

    return {
        "type": "Type-1",
        "dim_x": dim_x,
        "dim_y": dim_y,
        "dim_z": dim_z,
        "n_x_features": n_x,
        "aux_label": True,
        "prior_z_y": (dsl.conv_down(in_channel=n_scale + n_aux_label,
                                    channels=[8, 16, 32], scales=[2, 4, 4])
                      + dsl.conv_block(32, 2 * dim_z[0], kernel=5)),
        "q_x_in": dsl.conv_down(in_channel=n_x, channels=[8, 16, 32],
                                scales=[2, 4, 4]),
        "q_y_in": dsl.conv_down(in_channel=n_scale + n_aux_label,
                                channels=[8, 16, 32], scales=[2, 4, 4]),
        "q_x_y_out": dsl.conv_block(64, 2 * dim_z[0], kernel=5),
        "p_y_in": None,
        "p_z_in": dsl.conv_up(1, channels=[1, 1, 1], scales=[2, 4, 4],
                              bias=False, batchnorm=True, mode=upsample),
        "p_y_z_in": (dsl.conv_block(n_aux_label + n_scale + 1, 16, kernel=5)
                     + dsl.conv_down(in_channel=16, channels=[32, 64, 128],
                                     scales=[2, 2, 2])
                     + [("residual block", dsl.res_block(128))
                        for _ in range(n_res_blocks)]
                     + dsl.conv_up(128, channels=[64, 32, 16],
                                   scales=[2, 2, 2], bias=False,
                                   batchnorm=True, activation="ReLU",
                                   mode=upsample)),
        "p_y_z_out": tuple(p_y_z_out),
        "min_x_var": 1e-7,
        "min_z_var": 1e-7,
        "L": 1,
        "fused_res_blocks": fused_res_blocks,
    }
