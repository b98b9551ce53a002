"""Painter API: the user-facing painting surface, in PyTorch.

Port of ``CVAEPainter``, ``CGANPainter`` and ``load_painter`` from
``baryon_painter_tpu/painter.py``:

    painter = CVAEPainter("trained_models/CVAE/fiducial-512/model",
                          fused_inference=True)     # on the card
    pressure = painter.paint_batch(tiles, zs)       # (N,512,512) tensor
    tile = painter.paint(dm_tile, z=0.5)            # one tile, numpy

Transform -> prior sample -> decode -> inverse transform, on ``device``
(``cuda`` unless the caller passes ``device="cpu"``; asking for CUDA where
there is none raises). ``fused_inference=True`` renames the canonical residual
blocks into the fused layout, so each runs as one K1 launch;
``fused_heads=True`` runs the two output heads as one K3 launch (the JAX
package's ``BPT_FUSED_HEADS=1``). ``dtype=torch.bfloat16`` is the JAX
package's ``dtype=jnp.bfloat16``, the compute dtype its fidelity gates were
scored in: the model computes in it (K1 and K3 in bf16), the prior noise is
drawn in the latent's dtype, and the painted output is f32, as the JAX
painter's is. An f32 call paints in f32 whatever the caller's TF32 setting
(``utils/platform.f32_convolutions``).

``CGANPainter`` paints with the CGAN generator: transform -> generator ->
inverse transform, no noise; ``fused_inference=True`` runs its canonical
LeakyReLU(0.2) residual blocks as K1 launches; ``from_trainer`` paints a
``CGANTrainer``'s live generator. ``load_painter(filename,
**kwargs)`` opens a checkpoint with the painter its ``model_kind`` names.

A ``CVAEPainter`` also trains, as the JAX painter does: built from an
architecture and datasets, ``train(...)`` runs ``CVAETrainer.train`` and
then paints with what it trained; ``from_trainer`` paints a trainer's live
state; ``save_state_to_file`` writes the painter's weights as a checkpoint
the JAX package reads (``CGANPainter`` too).
"""
from __future__ import annotations

import copy
import json
from typing import Optional

import numpy as np
import torch

from baryon_painter_tpu_torch.convert import (from_jax_variables,
                                              generator_from_jax_variables,
                                              to_jax_variables)
from baryon_painter_tpu_torch.models.cvae import CVAE
from baryon_painter_tpu_torch.models.fuse import (
    fuse_cgan_generator_variables, fuse_cvae_variables)
from baryon_painter_tpu_torch.train import checkpoint as ckpt
from baryon_painter_tpu_torch.utils import profiling
from baryon_painter_tpu_torch.utils.platform import (f32_convolutions,
                                                     resolve_device)

__all__ = ["CVAEPainter", "CGANPainter", "load_painter"]

_Z_MODES = ("sample", "mean", "zero")


class CVAEPainter:
    def __init__(self, filename: Optional[str] = None,
                 variables: Optional[dict] = None,
                 meta: Optional[dict] = None,
                 training_data_set=None, test_data_set=None,
                 architecture: Optional[dict] = None,
                 seed: int = 0,
                 fused_inference: bool = False,
                 fused_heads: bool = False,
                 dtype=None,
                 device=None):
        """Construct from a checkpoint base path (``filename``), from
        ``variables`` (``{"params", "batch_stats"}`` as nested numpy dicts)
        plus ``meta`` (the checkpoint's metadata dict), or from an
        ``architecture`` dict and ``training_data_set`` (and
        ``test_data_set`` for the validation loss), in which case
        ``train()`` trains the model and the painter paints after it.

        ``seed`` seeds the painter's own ``torch.Generator`` on ``device``,
        which draws the prior noise when a call passes neither
        ``generator`` nor ``eps``. ``dtype`` is the model's compute dtype
        (None: f32), kept when ``fused_inference`` rebuilds the model and
        the dtype ``train()`` trains in."""
        self.device = resolve_device(device)
        self.dtype = dtype
        self._fused_inference = fused_inference
        self._fused_heads = fused_heads
        self.training_data = training_data_set
        self.test_data = test_data_set
        self.trainer = None
        if filename is not None:
            self.load_state_from_file(filename)
        elif variables is not None and meta is not None:
            self._setup(variables, meta)
        elif architecture is not None and training_data_set is not None:
            self.architecture = architecture
            self.model = CVAE(architecture, fused_heads=fused_heads,
                              dtype=dtype)
        else:
            raise ValueError("Provide filename, (variables, meta), or "
                             "(architecture, training_data_set).")
        self._generator = torch.Generator(device=self.device)
        self._generator.manual_seed(seed)

    def train(self, n_pepoch: int = 5, learning_rate: float = 1e-4,
              batch_size: int = 1, adaptive_learning_rate=None,
              adaptive_batch_size=None, validation_pepochs=(),
              pepoch_size: int = 3136, var_anneal_fn=None, KL_anneal_fn=None,
              output_path: Optional[str] = None, device_data: bool = False,
              seed: int = 0, verbose: bool = False, **config_kw):
        """Train on the constructor's datasets (``CVAETrainer.train``; the
        other ``TrainConfig`` fields as ``config_kw``), then paint with the
        trained weights. Returns ``(training_stats, validation_stats)``."""
        from baryon_painter_tpu_torch.train.trainer import (CVAETrainer,
                                                            TrainConfig)
        if self.training_data is None:
            raise RuntimeError("Trying to train but no training data "
                               "specified.")
        cfg = TrainConfig(learning_rate=learning_rate, batch_size=batch_size,
                          n_pepoch=n_pepoch, pepoch_size=pepoch_size,
                          adaptive_learning_rate=adaptive_learning_rate,
                          adaptive_batch_size=adaptive_batch_size,
                          var_anneal_fn=var_anneal_fn,
                          KL_anneal_fn=KL_anneal_fn,
                          output_path=output_path, seed=seed,
                          verbose=verbose, **config_kw)
        self.trainer = CVAETrainer(self.model, self.training_data,
                                   test_data=self.test_data, config=cfg,
                                   device_data=device_data,
                                   device=self.device)
        stats = self.trainer.train(validation_pepochs=validation_pepochs)
        meta = ckpt.meta_from_dataset(self.training_data,
                                      self.trainer.model.architecture)
        self._setup(to_jax_variables(self.trainer.model), meta)
        return stats

    def validate(self, **kw):
        """The attached trainer's ``validate`` (after ``train()``)."""
        if self.trainer is None:
            raise RuntimeError("validate() requires train() first.")
        return self.trainer.validate(**kw)

    @classmethod
    def from_trainer(cls, trainer, seed: int = 0,
                     fused_inference: bool = False, dtype="keep"):
        """A painter over the trainer's current weights, on its device,
        with its model's ``fused_heads``. ``dtype="keep"`` paints in the
        trainer's model dtype, any other value (None: f32) in that one."""
        model = trainer.model
        meta = ckpt.meta_from_dataset(trainer.training_data,
                                      model.architecture)
        return cls(variables=to_jax_variables(model), meta=meta, seed=seed,
                   fused_inference=fused_inference,
                   fused_heads=model.fused_heads,
                   dtype=model.dtype if dtype == "keep" else dtype,
                   device=trainer.device)

    def save_state_to_file(self, filename: str):
        """Write the painter's weights and metadata as a checkpoint pair
        (step 0, no optimizer state), as the JAX painter does."""
        ckpt.save_checkpoint(filename,
                             {"params": self.variables["params"],
                              "batch_stats": self.variables["batch_stats"],
                              "step": np.zeros((), np.int32)},
                             self.meta)

    def _setup(self, variables, meta):
        with profiling.setup_span("setup.model"):
            arch = meta["model_architecture"]
            if self._fused_inference and not arch.get("fused_res_blocks"):
                variables, arch = fuse_cvae_variables(variables, arch)
                meta = {**meta, "model_architecture": arch}
            self.model = from_jax_variables(
                variables, arch, fused_heads=self._fused_heads,
                dtype=self.dtype).to(self.device)
            self.variables = {"params": variables["params"],
                              "batch_stats": variables.get("batch_stats", {})}
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
        with profiling.setup_span("setup.checkpoint"):
            state, meta = ckpt.load_checkpoint(filename)
        self._setup(state, meta)

    def replica(self, device) -> "CVAEPainter":
        """This painter on ``device`` (``parallel.mesh.replicate``): the
        model deep-copied there, the transforms' statistics rebuilt there,
        a generator of its own there (a sharded paint draws its noise with
        this painter's)."""
        new = copy.copy(self)
        new.device = resolve_device(device)
        new.model = copy.deepcopy(self.model).to(new.device)
        new.transforms, new.stats = ckpt.transforms_from_meta(
            self.meta, device=new.device)
        new._generator = torch.Generator(device=new.device)
        return new

    def latent_noise(self, n: int, tile_shape):
        """The prior noise a paint of ``n`` tiles of ``tile_shape`` (H, W)
        draws from the painter's own generator: (n, Cz, H/f, W/f) in the
        latent's dtype on this painter's device, the draw ``paint_batch``
        makes for that batch."""
        from baryon_painter_tpu_torch.parallel.spatial import \
            latent_downsample
        f = latent_downsample(self.architecture)
        shape = (n, int(self.architecture["dim_z"][0]),
                 tile_shape[0] // f, tile_shape[1] // f)
        return torch.randn(shape, dtype=self.model.dtype or torch.float32,
                           device=self.device, generator=self._generator)

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

    def _latent_noise(self, eps, like):
        """``eps`` as a tensor of the latent ``like``'s (N, Cz, h, w) shape
        and dtype; (N, h, w) is accepted for a one-channel latent."""
        shape = like.shape
        eps = torch.as_tensor(eps, dtype=like.dtype, device=self.device)
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
        with profiling.span("paint", device=self.device,
                            tiles=len(tiles)), f32_convolutions():
            return self._paint_batch(tiles, zs, transform, inverse_transform,
                                     return_var, generator, z_mode, eps)

    def _paint_batch(self, tiles, zs, transform, inverse_transform,
                     return_var, generator, z_mode, eps):
        if z_mode not in _Z_MODES:
            raise ValueError(f"z_mode must be one of {_Z_MODES}, got "
                             f"'{z_mode}'")
        in_field, out_field = self.input_field, self.label_fields[0]
        with profiling.span("paint.transform"):
            tiles = torch.as_tensor(tiles, dtype=torch.float32,
                                    device=self.device)
            zs = torch.as_tensor(zs, dtype=torch.float32, device=self.device)
            y = tiles
            if transform:
                y = self.transforms[in_field].forward(
                    y, self.stats[in_field], zs)
            # one field (N, H, W) gains its channel axis; a transform that
            # emits channels (N, C, H, W) keeps them, as in the JAX painter
            y = y[:, None] if y.ndim == 3 else y
            y = y.contiguous(memory_format=torch.channels_last)

        with profiling.span("paint.prior"):
            z_mu, z_log_var = self.model.prior(y, zs)
            if z_mode == "sample":
                if eps is None:
                    if generator is None:
                        generator = self._generator
                    eps = torch.randn(z_mu.shape, dtype=z_mu.dtype,
                                      device=self.device, generator=generator)
                z = self.model.sample_z(z_mu, z_log_var,
                                        self._latent_noise(eps, z_mu))
            else:
                z = z_mu if z_mode == "mean" else torch.zeros_like(z_mu)
        with profiling.span("paint.decode"):
            res = self.model.sample_P(y, zs, z=z, return_var=return_var)
        pred, var = res if return_var else (res, None)
        with profiling.span("paint.inverse"):
            pred = pred[:, 0] if pred.shape[1] == 1 else pred
            if inverse_transform:
                pred = self.transforms[out_field].inverse(
                    pred, self.stats[out_field], zs)
            pred = pred.contiguous()
            if return_var:
                var = var[:, 0].contiguous()
        return (pred, var) if return_var else pred


class CGANPainter:
    """Generator-only painting with the CGAN family (the JAX package's
    ``CGANPainter``)::

        painter = CGANPainter("trained_models/CGAN/fiducial/model",
                              fused_inference=True)      # on the card
        pressure = painter.paint_batch(tiles, zs)        # (N,256,256)

    The generator's spectral norm is folded into its kernels at load
    (``models/fuse.py``), in both layouts: the port only paints, and at
    eval flax's spectral norm is that fixed division. ``fused_inference``
    also renames the residual blocks into the fused layout (K1, slope
    0.2). ``dtype=torch.bfloat16`` computes the generator in bf16 at the
    JAX package's rounding points (the folded kernels are f32 and cast by
    each conv, as flax's SpectralNorm returns f32). An f32 call paints in
    f32 whatever the caller's TF32 setting.

    ``save_state_to_file`` writes the painter's generator variables (in
    the fused layout after ``fused_inference``, with the architecture
    marked so) as the JAX painter does. ``from_trainer`` paints a
    ``CGANTrainer``'s live generator: its spectral norm folded from the
    trainer's current u, and with ``fused_inference`` its residual blocks
    through K1.
    """

    def __init__(self, filename: Optional[str] = None,
                 variables: Optional[dict] = None,
                 meta: Optional[dict] = None,
                 fused_inference: bool = False,
                 dtype=None,
                 device=None):
        """Construct from a checkpoint base path (``filename``), or from the
        generator's ``variables`` (``{"params", "batch_stats"}`` as nested
        numpy dicts, the JAX generator's layout) plus ``meta`` (the
        checkpoint's metadata dict, whose ``model_architecture`` builds the
        generator: the port's modules carry their weights, so these two
        take the place of the JAX painter's generator, variables and
        meta)."""
        self.device = resolve_device(device)
        self.dtype = dtype
        self._fused_inference = fused_inference
        if filename is not None:
            self.load_state_from_file(filename)
        elif variables is not None and meta is not None:
            self._setup(variables, meta)
        else:
            raise ValueError("Provide filename or (variables, meta).")

    def replica(self, device) -> "CGANPainter":
        """This painter on ``device`` (``parallel.mesh.replicate``): the
        generator deep-copied there, the transforms' statistics rebuilt
        there."""
        new = copy.copy(self)
        new.device = resolve_device(device)
        new.generator = copy.deepcopy(self.generator).to(new.device)
        new.transforms, new.stats = ckpt.transforms_from_meta(
            self.meta, device=new.device)
        return new

    def _setup(self, variables, meta):
        with profiling.setup_span("setup.model"):
            arch = dict(meta["model_architecture"])
            if self._fused_inference and not arch.get("fused_res_blocks"):
                variables, kwargs = fuse_cgan_generator_variables(variables,
                                                                  arch)
                arch = {**arch, **kwargs, "spectral_norm": False}
                meta = {**meta, "model_architecture": arch}
            self.generator = generator_from_jax_variables(
                variables, arch, dtype=self.dtype).to(self.device)
            self.variables = variables
            self.meta = meta
            self.architecture = arch
            self.input_field = meta["input_field"]
            self.label_fields = list(meta["label_fields"])
            self.tile_L = meta["tile_L"]
            self.tile_size = meta["tile_size"]
            self.transforms, self.stats = ckpt.transforms_from_meta(
                meta, device=self.device)

    @classmethod
    def from_trainer(cls, trainer, dtype="keep",
                     fused_inference: bool = False):
        """A painter over a ``CGANTrainer``'s current generator (its
        parameters, batch statistics and spectral-norm state, exported to
        the JAX layout and folded), on the trainer's device.
        ``dtype="keep"`` paints in the trainer generator's compute dtype,
        any other value (None: f32) in that one; ``fused_inference`` runs
        the residual blocks through K1 (9 launches a call)."""
        gen = trainer.generator
        meta = ckpt.meta_from_dataset(trainer.training_data,
                                      gen.architecture, model_kind="cgan")
        return cls(variables=to_jax_variables(gen), meta=meta,
                   fused_inference=fused_inference,
                   dtype=gen.dtype if dtype == "keep" else dtype,
                   device=trainer.device)

    def load_state_from_file(self, filename: str):
        """Load a (state.msgpack, meta.json) checkpoint pair by base path:
        the generator's ``g_params`` and ``g_stats``."""
        with profiling.setup_span("setup.checkpoint"):
            state, meta = ckpt.load_checkpoint(filename)
        self._setup({"params": state["g_params"],
                     "batch_stats": state.get("g_stats", {})}, meta)

    def save_state_to_file(self, filename: str):
        """Write the generator's variables and metadata as a checkpoint pair
        (``g_params``, ``g_stats``, step 0), as the JAX painter does."""
        ckpt.save_checkpoint(filename,
                             {"g_params": self.variables["params"],
                              "g_stats": self.variables["batch_stats"],
                              "step": np.zeros((), np.int32)},
                             self.meta)

    def paint(self, input, z: float = 0.0, transform: bool = True,
              inverse_transform: bool = True):
        """Paint a single (H, W) tile; returns numpy."""
        tile = torch.as_tensor(np.asarray(input, np.float32))
        if tile.ndim != 2:
            raise ValueError(f"paint expects a 2-D tile, got "
                             f"{tuple(tile.shape)}.")
        out = self.paint_batch(tile[None], torch.full((1,), float(z)),
                               transform=transform,
                               inverse_transform=inverse_transform)
        return out[0].float().cpu().numpy()

    @torch.inference_mode()
    def paint_batch(self, tiles, zs, transform: bool = True,
                    inverse_transform: bool = True, **_ignored):
        """Paint a batch of tiles (N, H, W) with per-tile redshifts (N,);
        returns a tensor on the painter's device. Other keyword arguments
        (a CVAE painter's ``z_mode``, ``eps``) are accepted and ignored, as
        the JAX painter ignores them: the generator draws no noise."""
        with profiling.span("paint", device=self.device,
                            tiles=len(tiles)), f32_convolutions():
            return self._paint_batch(tiles, zs, transform, inverse_transform)

    def _paint_batch(self, tiles, zs, transform, inverse_transform):
        in_field, out_field = self.input_field, self.label_fields[0]
        with profiling.span("paint.transform"):
            tiles = torch.as_tensor(tiles, dtype=torch.float32,
                                    device=self.device)
            zs = torch.as_tensor(zs, dtype=torch.float32, device=self.device)
            y = tiles
            if transform:
                y = self.transforms[in_field].forward(
                    y, self.stats[in_field], zs)
            y = y[:, None].contiguous(memory_format=torch.channels_last)
        with profiling.span("paint.decode"):
            pred = self.generator(y, zs)
        with profiling.span("paint.inverse"):
            pred = pred[:, 0]
            if inverse_transform:
                pred = self.transforms[out_field].inverse(
                    pred, self.stats[out_field], zs)
            return pred.contiguous()


def load_painter(filename: str, **kwargs):
    """Open a checkpoint pair and return the painter its ``model_kind``
    names (``"cgan"``: ``CGANPainter``, else ``CVAEPainter``); ``kwargs``
    (``fused_inference``, ``dtype``, ``device``, ...) go to that class."""
    with open(filename + "_meta.json") as f:
        kind = json.load(f).get("model_kind", "cvae")
    cls = CGANPainter if kind == "cgan" else CVAEPainter
    return cls(filename, **kwargs)
