"""Painter API: the user-facing painting surface, in PyTorch.

Port of ``CVAEPainter`` from ``baryon_painter_tpu/painter.py``:

    painter = CVAEPainter("trained_models/CVAE/fiducial-512/model",
                          fused_inference=True)     # on the card
    pressure = painter.paint_batch(tiles, zs)       # (N,512,512) tensor
    tile = painter.paint(dm_tile, z=0.5)            # one tile, numpy

Transform -> prior sample -> decode -> inverse transform, on ``device``
(``cuda`` unless the caller passes ``device="cpu"``; asking for CUDA where
there is none raises). ``fused_inference=True`` renames the canonical residual
blocks into the fused layout, so each runs as one K1 launch;
``fused_heads=True`` runs the two output heads as one K3 launch (the JAX
package's ``BPT_FUSED_HEADS=1``). A call paints in f32 whatever the
caller's TF32 setting (``utils/platform.f32_convolutions``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from baryon_painter_tpu_torch.convert import from_jax_variables
from baryon_painter_tpu_torch.models.fuse import fuse_cvae_variables
from baryon_painter_tpu_torch.train import checkpoint as ckpt
from baryon_painter_tpu_torch.utils.platform import (f32_convolutions,
                                                     resolve_device)

__all__ = ["CVAEPainter"]

_Z_MODES = ("sample", "mean", "zero")


class CVAEPainter:
    def __init__(self, filename: Optional[str] = None,
                 variables: Optional[dict] = None,
                 meta: Optional[dict] = None,
                 seed: int = 0,
                 fused_inference: bool = False,
                 fused_heads: bool = False,
                 device=None):
        """Construct from a checkpoint base path (``filename``), or from
        ``variables`` (``{"params", "batch_stats"}`` as nested numpy dicts)
        plus ``meta`` (the checkpoint's metadata dict).

        ``seed`` seeds the painter's own ``torch.Generator`` on ``device``,
        which draws the prior noise when a call passes neither
        ``generator`` nor ``eps``."""
        self.device = resolve_device(device)
        self._fused_inference = fused_inference
        self._fused_heads = fused_heads
        if filename is not None:
            self.load_state_from_file(filename)
        elif variables is not None and meta is not None:
            self._setup(variables, meta)
        else:
            raise ValueError("Provide filename or (variables, meta).")
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)

    def _setup(self, variables, meta):
        arch = meta["model_architecture"]
        if self._fused_inference and not arch.get("fused_res_blocks"):
            variables, arch = fuse_cvae_variables(variables, arch)
            meta = {**meta, "model_architecture": arch}
        self.model = from_jax_variables(
            variables, arch, fused_heads=self._fused_heads).to(self.device)
        self.meta = meta
        self.architecture = arch
        self.input_field = meta["input_field"]
        self.label_fields = list(meta["label_fields"])
        self.tile_L = meta["tile_L"]
        self.tile_size = meta["tile_size"]
        self.transforms, self.stats = ckpt.transforms_from_meta(
            meta, device=self.device)

    def load_state_from_file(self, filename: str):
        """Load a (state.msgpack, meta.json) checkpoint pair by base path."""
        state, meta = ckpt.load_checkpoint(filename)
        self._setup(state, meta)

    def paint(self, input, z: float = 0.0, transform: bool = True,
              inverse_transform: bool = True, return_var: bool = False,
              generator: Optional[torch.Generator] = None, eps=None):
        """Paint a single (H, W) tile; returns numpy."""
        tile = torch.as_tensor(np.asarray(input, np.float32))
        if tile.ndim != 2:
            raise ValueError(f"paint expects a 2-D tile, got "
                             f"{tuple(tile.shape)}.")
        expected = tuple(self.architecture["dim_y"][1:])
        if tuple(tile.shape) != expected:
            raise ValueError(
                f"Shape mismatch between input and model: "
                f"{tuple(tile.shape)} vs {expected}")
        if eps is not None:
            eps = torch.as_tensor(np.asarray(eps, np.float32))[None]
        out = self.paint_batch(tile[None], torch.full((1,), float(z)),
                               transform=transform,
                               inverse_transform=inverse_transform,
                               return_var=return_var, generator=generator,
                               eps=eps)
        if return_var:
            return out[0][0].cpu().numpy(), out[1][0].cpu().numpy()
        return out[0].cpu().numpy()

    def _latent_noise(self, eps, shape):
        """``eps`` as a tensor of the latent's (N, Cz, h, w) shape; (N, h, w)
        is accepted for a one-channel latent."""
        eps = torch.as_tensor(eps, dtype=torch.float32, device=self.device)
        if tuple(eps.shape) == tuple(shape):
            return eps
        if shape[1] == 1 and tuple(eps.shape) == (shape[0],) + tuple(
                shape[2:]):
            return eps[:, None]
        raise ValueError(f"eps has shape {tuple(eps.shape)}, the latent "
                         f"{tuple(shape)}")

    @torch.inference_mode()
    def paint_batch(self, tiles, zs, transform: bool = True,
                    inverse_transform: bool = True, return_var: bool = False,
                    generator: Optional[torch.Generator] = None,
                    z_mode: str = "sample", eps=None):
        """Paint a batch of tiles (N, H, W) with per-tile redshifts (N,).

        z_mode: 'sample' draws the latent from the prior (noise ``eps``
        when given, else from ``generator`` or the painter's own); 'mean'
        decodes at the prior mean; 'zero' at z=0. Returns a tensor on the
        painter's device (and the predicted variance with ``return_var``).
        """
        with f32_convolutions():
            return self._paint_batch(tiles, zs, transform, inverse_transform,
                                     return_var, generator, z_mode, eps)

    def _paint_batch(self, tiles, zs, transform, inverse_transform,
                     return_var, generator, z_mode, eps):
        if z_mode not in _Z_MODES:
            raise ValueError(f"z_mode must be one of {_Z_MODES}, got "
                             f"'{z_mode}'")
        tiles = torch.as_tensor(tiles, dtype=torch.float32,
                                device=self.device)
        zs = torch.as_tensor(zs, dtype=torch.float32, device=self.device)
        in_field, out_field = self.input_field, self.label_fields[0]
        y = tiles
        if transform:
            y = self.transforms[in_field].forward(y, self.stats[in_field], zs)
        y = y[:, None].contiguous(memory_format=torch.channels_last)

        z_mu, z_log_var = self.model.prior(y, zs)
        if z_mode == "sample":
            if eps is None:
                if generator is None:
                    generator = self._generator
                eps = torch.randn(z_mu.shape, dtype=z_mu.dtype,
                                  device=self.device, generator=generator)
            z = self.model.sample_z(z_mu, z_log_var,
                                    self._latent_noise(eps, z_mu.shape))
        else:
            z = z_mu if z_mode == "mean" else torch.zeros_like(z_mu)
        res = self.model.sample_P(y, zs, z=z, return_var=return_var)
        pred, var = res if return_var else (res, None)
        pred = pred[:, 0] if pred.shape[1] == 1 else pred
        if inverse_transform:
            pred = self.transforms[out_field].inverse(
                pred, self.stats[out_field], zs)
        pred = pred.contiguous()
        return (pred, var[:, 0].contiguous()) if return_var else pred
