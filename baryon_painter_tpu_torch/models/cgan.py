"""Conditional GAN, NCHW: the generator that paints and the patch
discriminator that trains it.

Port of ``baryon_painter_tpu/models/cgan.py`` (the architecture of the
reference's trained_models/README.md:95-139): the dark matter tile and a
constant map of the redshift feature f(z) = z - 1 go through a
Johnson-style translator,

  Conv 9x9 (2->32) -> two stride-2 convs (->64->128) -> n res blocks
  (LeakyReLU 0.2) -> two stride-2 transposed convs (or nearest resize +
  3x3 conv) -> Conv 9x9 (32->1), tanh,

with batch norm throughout. The body and the head are two
``SpecSequential``s, named ``SpecSequential_0`` and ``SpecSequential_1`` as
flax names them, so a checkpoint's variables map onto them one to one
(``convert.py``).

The JAX package wraps every parametric layer of both networks in flax's
``SpectralNorm``. ``spectral_norm=True`` does the same here
(``models/layers.py``: one power iteration a call, u and sigma stored in
train mode); training builds both networks so. The painter builds the
generator without it (the default): at eval flax's spectral norm is a fixed
division of each kernel by a sigma computed from the stored state, which
``models/fuse.fold_spectral_norm`` applies to the weights once at load.
With ``fused_res_blocks=True`` (no spectral norm) the canonical residual
blocks run as K1 launches (``FusedResBlock``) at slope 0.2.

The discriminator (``CGANDiscriminator``) reads the dark matter, the
redshift map and a pressure tile (real or painted) through four 4x4 convs,
3->64->128->256->512 (strides 2, 2, 2, 1, padding 1, LeakyReLU 0.2), and a
4x4 head to one channel with a sigmoid: a probability per patch, (N, 1, 62,
62) at 512^2.
"""
from __future__ import annotations

import torch
from torch import nn

from baryon_painter_tpu_torch.models.layers import (SpecSequential,
                                                    merge_aux_label)

__all__ = ["CGANGenerator", "CGANDiscriminator", "cgan_generator_spec",
           "cgan_discriminator_spec", "z_feature"]


def z_feature(z):
    """Redshift feature map value: f(z) = z - 1 (balances [0, 2] around 0)."""
    return torch.as_tensor(z) - 1.0


def _conv(cin, cout, k, s, bias, bn, act, output_padding=None, transp=False):
    cfg = {"in_channels": cin, "out_channels": cout, "kernel_size": k,
           "stride": s, "padding": (k - 1) // 2, "bias": bias}
    if output_padding is not None:
        cfg["output_padding"] = output_padding
    layers = [("transp conv" if transp else "conv", cfg)]
    if bn:
        layers.append(("batchnorm", {"num_features": cout}))
    if act == "lrelu":
        layers.append(("Leaky ReLU", 0.2))
    elif act == "tanh":
        layers.append(("tanh",))
    elif act == "sigmoid":
        layers.append(("sigmoid",))
    return layers


def _res_block_lrelu(c):
    inner = (_conv(c, c, 3, 1, False, True, "lrelu")
             + _conv(c, c, 3, 1, False, True, None))
    return [("residual block", (inner, ("Leaky ReLU", 0.2)))]


def cgan_generator_spec(in_channels: int = 2, n_res_blocks: int = 9,
                        upsample: str = "transpose"):
    """``(body, head)`` layer specs of the generator, as the JAX package's
    ``cgan_generator_spec``: ``upsample='transpose'`` is the reference's
    strided transposed convs, ``'resize'`` nearest resize + 3x3 conv."""
    body = _conv(in_channels, 32, 9, 1, False, True, "lrelu")
    body += _conv(32, 64, 3, 2, True, True, "lrelu")
    body += _conv(64, 128, 3, 2, True, True, "lrelu")
    for _ in range(n_res_blocks):
        body += _res_block_lrelu(128)
    if upsample == "transpose":
        body += _conv(128, 64, 3, 2, True, True, "lrelu", output_padding=1,
                      transp=True)
        body += _conv(64, 32, 3, 2, True, True, "lrelu", output_padding=1,
                      transp=True)
    elif upsample == "resize":
        body += [("upsample nearest", {"scale": 2})]
        body += _conv(128, 64, 3, 1, True, True, "lrelu")
        body += [("upsample nearest", {"scale": 2})]
        body += _conv(64, 32, 3, 1, True, True, "lrelu")
    else:
        raise ValueError(f"Unknown generator upsample mode '{upsample}'.")
    head = _conv(32, 1, 9, 1, True, True, "tanh")
    return tuple(map(tuple, body)), tuple(map(tuple, head))


def cgan_discriminator_spec(in_channels: int = 3):
    """``(body, head)`` layer specs of the discriminator, as the JAX
    package's ``cgan_discriminator_spec``."""
    body = _conv(in_channels, 64, 4, 2, True, False, "lrelu")
    body += _conv(64, 128, 4, 2, False, False, "lrelu")
    body += _conv(128, 256, 4, 2, False, False, "lrelu")
    body += _conv(256, 512, 4, 1, False, False, "lrelu")
    head = _conv(512, 1, 4, 1, True, False, "sigmoid")
    return tuple(map(tuple, body)), tuple(map(tuple, head))


class CGANGenerator(nn.Module):
    """The generator, built in eval mode (module docstring).

    ``forward(y, z)``: y (N, 1, H, W) the transformed dark matter tile, z
    (N,) the redshifts; returns (N, 1, H, W) in ``dtype`` (None: y's), the
    compute dtype of every layer (``models/layers.py``)."""

    # the flax scopes of its variables, in order
    jax_scopes = ("SpecSequential_0", "SpecSequential_1")

    def __init__(self, in_channels: int = 2, n_res_blocks: int = 9,
                 upsample: str = "transpose", fused_res_blocks: bool = False,
                 dtype=None, spectral_norm: bool = False):
        super().__init__()
        self.in_channels, self.n_res_blocks = in_channels, n_res_blocks
        self.upsample, self.fused_res_blocks = upsample, fused_res_blocks
        self.dtype, self.spectral_norm = dtype, spectral_norm
        body, head = cgan_generator_spec(in_channels, n_res_blocks, upsample)
        self.SpecSequential_0 = SpecSequential(
            body, fused_res_blocks=fused_res_blocks, dtype=dtype,
            spectral_norm=spectral_norm)
        self.SpecSequential_1 = SpecSequential(head, dtype=dtype,
                                               spectral_norm=spectral_norm)
        self.eval()

    @property
    def architecture(self) -> dict:
        """The checkpoint meta's ``model_architecture`` of this generator."""
        return {"n_res_blocks": self.n_res_blocks,
                "in_channels": self.in_channels, "upsample": self.upsample}

    def forward(self, y, z):
        h = merge_aux_label(y, z_feature(z))
        return self.SpecSequential_1(self.SpecSequential_0(h))


class CGANDiscriminator(nn.Module):
    """The patch discriminator, spectrally normalised, built in eval mode
    (module docstring).

    ``forward(y, z, x, return_features=False)``: y (N, 1, H, W) the
    transformed dark matter, z (N,) the redshifts, x (N, 1, H, W) a
    transformed pressure tile; returns the per-patch probabilities (N, 1,
    h, w) and, with ``return_features``, the body's output before the
    head as well (the feature layer of feature matching)."""

    jax_scopes = ("SpecSequential_0", "SpecSequential_1")

    def __init__(self, in_channels: int = 3):
        super().__init__()
        self.in_channels = in_channels
        body, head = cgan_discriminator_spec(in_channels)
        self.SpecSequential_0 = SpecSequential(body, spectral_norm=True)
        self.SpecSequential_1 = SpecSequential(head, spectral_norm=True)
        self.eval()

    def forward(self, y, z, x, return_features: bool = False):
        h = torch.cat([merge_aux_label(y, z_feature(z)), x.to(y.dtype)],
                      dim=1)
        feat = self.SpecSequential_0(h)
        p = self.SpecSequential_1(feat)
        return (p, feat) if return_features else p
