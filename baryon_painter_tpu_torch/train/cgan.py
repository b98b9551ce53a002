"""CGAN adversarial training, in PyTorch: the step and the training run.

Port of ``baryon_painter_tpu/train/cgan.py``, with the reference's
hyperparameters (trained_models/README.md:130-139: lr 5e-5, Adam (0.5,
0.999), lambda_perceptual 2.5, lr decay 0.85 per 1568-sample pepoch, batch
6). One step, on one device:

    raw tiles -> transforms -> G forward (train mode: batch statistics; G's
    batch-norm running statistics and spectral-norm u/sigma move once)
    -> D update: BCE on D(real) and D(fake, no gradient to G), D's
       real pass from D's stored spectral-norm state, its fake pass from the
       u the real pass just updated; the state kept is the real pass's
    -> G update against the updated D in eval mode: the adversarial term
       (-log D(fake), or with ``feature_matching`` the squared difference of
       the batch-mean body features of fake and real, real detached)
       + lambda_perceptual * L1 (or L2) [+ the spectral term]
    -> both Adam updates (``optax.chain(scale_by_adam, scale(-1))``, the
       learning rate multiplied outside), each after an optional
       global-norm clip; the gradient norms are read before the clip.

``adversarial_weight == 0`` is the calibration mode: no D update (zeros for
the D metrics), G run in eval mode for every term, nothing of G's state
moves. ``freeze_bn_stats`` keeps all of G's state (batch norm and spectral
norm) where it was; D's keeps moving. The spectral term (``pk_loss_weight``
> 0, ``train/spectral.py``) paints through the eval-mode G with the
step's starting statistics and u (its forward runs first, before the
train-mode forward moves them), clamps to the truth's transformed range
+- 1 and inverts the transform in f32, per redshift or pooled.

The batch comes from the host (``step``) or is assembled on the device
from the stack cache (``step_indices``, ``step_scan``; ``device_data=True``),
the tile gather through K2, one launch a step. The step draws no noise, so
a resumed run equals the uninterrupted one bit for bit under cuDNN's
deterministic algorithms. The step computes in the networks' parameter
dtype (f32, as the JAX trainer trains the CGAN, or f64 for a reference
step) whatever the caller's TF32 setting (``utils/platform.f32_convolutions``).

    trainer = CGANTrainer(dataset, test_data=held_out, device_data=True,
                          config=CGANTrainConfig(n_pepoch=2, pepoch_size=48,
                                                 output_path="run"))
    trainer.restore("trained_models/CGAN/fiducial-adv/model")
    training_stats, validation_stats = trainer.train()

``train`` is the JAX trainer's loop, draw for draw: pepoch lr decay, the
power-of-two steps of each ``step_scan`` up to the next pepoch, checkpoint,
validation or report point, the validation loss on batches drawn from the
same data RNG, ``training_stats.txt`` and ``validation_stats.txt``,
checkpoints keyed by sample count with rotation, and the final ``model``.
``save`` and ``restore`` write and read the JAX trainer's checkpoint tree
(``convert.gan_state_to_jax``), so either package resumes the other's run.

``validate`` draws the JAX trainer's figures (matplotlib) from a test
batch painted by the eval-mode generator.

Data parallelism (``mesh=``, a ``parallel.mesh.ProcessMesh``) follows the
CVAE trainer's scheme (``train/trainer.py``) for G and D: each rank steps
on its rows of the global batch, the batch norms take global statistics,
each loss term is the rank's share of the global mean (the spectral term
and feature matching's batch-mean features are formed over the global
batch), both networks' gradients and the metrics are summed over the
ranks, and both Adams run identically everywhere; spectral norm's u stays
the same on every rank because the weights do. With the stack cache
z-sharded over the ranks, the cache's per-sample importance weights
reweigh the D and G losses when the layout samples redshifts unevenly
(the JAX trainer's ``_wmean``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import warnings
from typing import Optional

import numpy as np
import torch

from baryon_painter_tpu_torch.convert import (gan_state_from_jax,
                                              gan_state_to_jax, init_cgan,
                                              init_discriminator, trainable)
from baryon_painter_tpu_torch.data.dataset import BahamasTileDataset
from baryon_painter_tpu_torch.data.device_cache import DeviceStackCache
from baryon_painter_tpu_torch.models.cgan import (CGANDiscriminator,
                                                  CGANGenerator)
from baryon_painter_tpu_torch.models.layers import (BatchNorm, Conv2d,
                                                    ConvTranspose2d,
                                                    ResidualBlock)
from baryon_painter_tpu_torch.train import checkpoint as ckpt
from baryon_painter_tpu_torch.train.spectral import pk_fidelity_loss
from baryon_painter_tpu_torch.train.trainer import (_GAN_PROGRESS_KEYS, Adam,
                                                    _decode_data_rng,
                                                    _encode_data_rng,
                                                    check_process_mesh,
                                                    clip_grads_by_global_norm,
                                                    draw_test_batch,
                                                    grad_norm, local_rows,
                                                    run_stats)
from baryon_painter_tpu_torch.transforms import FieldStats
from baryon_painter_tpu_torch.utils.platform import (f32_convolutions,
                                                     to_device)

__all__ = ["CGANTrainConfig", "CGANTrainer", "zero_gradient_leaves"]

_EPS = 1e-7
# the statistics row of a step, in order (stats_tuple)
_STATS_TERMS = ("loss_D", "loss_G_adv", "loss_G_perceptual", "D_real",
                "D_fake")


@dataclasses.dataclass
class CGANTrainConfig:
    """The JAX package's ``CGANTrainConfig``, field for field. Sample counts
    (``pepoch_size``, the ``*_frequency`` fields) are in samples.

    ``adversarial_weight`` 0 is the calibration mode (module docstring);
    ``feature_matching`` replaces G's adversarial BCE by feature matching
    (D still trains with BCE); ``freeze_bn_stats`` keeps G's running
    statistics and spectral-norm state; ``clip_grad_norm`` > 0 clips both
    networks' gradients to that global norm; ``pk_loss_weight`` > 0 adds
    the spectral term over ``pk_loss_n_bins`` bins, per redshift with
    ``pk_loss_per_z``."""

    learning_rate: float = 5e-5
    adam_b1: float = 0.5
    adam_b2: float = 0.999
    lambda_perceptual: float = 2.5
    perceptual_loss: str = "l1"
    batch_size: int = 6
    n_pepoch: int = 5
    pepoch_size: int = 1568
    lr_decay: float = 0.85                     # per pepoch
    statistics_report_frequency: int = 50
    checkpoint_frequency: int = 20000
    keep_last_checkpoints: int = 0             # 0 keeps every checkpoint
    validation_loss_frequency: int = 0         # in samples; 0 = off
    validation_loss_batch_size: int = 16
    stats_sync_every: int = 16                 # steps between host copies
    mavg_window_size: int = 20
    output_path: Optional[str] = None
    seed: int = 0
    device_cache_budget_bytes: int = 8 * 1024 ** 3
    verbose: bool = False
    pk_loss_weight: float = 0.0
    pk_loss_n_bins: int = 12
    feature_matching: bool = False
    pk_loss_per_z: bool = False
    adversarial_weight: float = 1.0
    freeze_bn_stats: bool = False
    clip_grad_norm: float = 0.0


def _wmean(v, sample_weight=None, n_ranks: int = 1):
    """This rank's share of the global batch's mean of per-sample means,
    optionally importance-weighted along the batch axis (the JAX trainer's
    ``_wmean``): the local mean over the ranks' count; the plain mean on
    one rank."""
    if sample_weight is None:
        return v.mean() / n_ranks
    per_sample = v.mean(dim=tuple(range(1, v.ndim)))
    return (sample_weight.to(per_sample.dtype) * per_sample).mean() / n_ranks


def zero_gradient_leaves(model) -> list:
    """The flax paths (``"SpecSequential_0/Conv2d_1/bias"``) of the
    parameters whose gradient is 0 analytically in a train-mode step: the
    bias of a convolution followed by a batch norm, which removes any
    shift. A computed gradient there is rounding noise of either sign (an
    eval-mode term, such as the spectral term's paint, gives them a real
    one)."""
    out = []

    def walk(seq, prefix):
        steps = seq._steps
        for i, name in enumerate(steps):
            if not isinstance(name, str):
                continue
            m = seq.layers[name]
            if isinstance(m, ResidualBlock):
                walk(m.SpecSequential_0, f"{prefix}{name}/SpecSequential_0/")
            elif (isinstance(m, (Conv2d, ConvTranspose2d))
                  and m.bias is not None and i + 1 < len(steps)
                  and isinstance(steps[i + 1], str)
                  and isinstance(seq.layers[steps[i + 1]], BatchNorm)):
                out.append(f"{prefix}{name}/bias")

    for scope in model.jax_scopes:
        walk(getattr(model, scope), f"{scope}/")
    return out


def _state_buffers(model) -> list:
    """A network's running state: batch-norm statistics and spectral-norm
    u and sigma (the JAX package's ``batch_stats`` collection)."""
    return list(model.buffers())


def _clone(buffers) -> list:
    return [b.detach().clone() for b in buffers]


@torch.no_grad()
def _put(buffers, values):
    for b, v in zip(buffers, values):
        b.copy_(v)


class CGANTrainer:
    def __init__(self, training_data: BahamasTileDataset,
                 test_data: Optional[BahamasTileDataset] = None,
                 config: CGANTrainConfig = CGANTrainConfig(),
                 generator: Optional[CGANGenerator] = None,
                 discriminator: Optional[CGANDiscriminator] = None,
                 mesh=None, device_data: bool = False, device=None,
                 use_kernel="auto", state: Optional[dict] = None):
        """Set up adversarial training on ``device`` (``cuda`` unless the
        caller passes ``device="cpu"``); ``test_data`` is what the
        validation loss is computed on.

        ``generator`` defaults to ``CGANGenerator(spectral_norm=True)``,
        ``discriminator`` to ``CGANDiscriminator()``; their weights are
        drawn by ``convert.init_cgan`` from ``config.seed``, or loaded from
        ``state`` (a CGAN checkpoint tree in the JAX layout: ``g_params``,
        ``g_stats``, ``d_params``, ``d_stats`` and, optionally, ``g_opt``,
        ``d_opt`` and ``step``, e.g. the JAX trainer's initial state).
        ``device_data=True`` uploads the stacks to the device once
        (``DeviceStackCache``, the gather through K2 unless
        ``use_kernel=False``) for ``step_indices`` and ``step_scan``,
        which ``train`` then uses. The networks compute in their parameter
        dtype (f32; ``.double()`` them first for an f64 step). ``mesh``: a
        ``ProcessMesh`` for data-parallel training (module docstring); the
        networks start from rank 0's weights and the cache is z-sharded."""
        ds = training_data
        if len(ds.label_fields) != 1:
            raise ValueError("CGAN supports exactly one label field.")
        self.device = check_process_mesh(mesh, device)
        self.mesh = mesh
        self.config = config
        self.training_data = training_data
        self.test_data = test_data
        self.generator = (generator if generator is not None
                          else CGANGenerator(spectral_norm=True))
        self.discriminator = (discriminator if discriminator is not None
                              else CGANDiscriminator())
        if state is None:
            init_cgan(self.generator, self.discriminator, config.seed)
        self.generator.to(self.device)
        self.discriminator.to(self.device)
        if mesh is not None and state is None:
            mesh.broadcast_module_(self.generator)
            mesh.broadcast_module_(self.discriminator)
        self.g_params = trainable(self.generator)
        self.d_params = trainable(self.discriminator)
        self.g_opt = Adam(self.g_params, config.adam_b1, config.adam_b2)
        self.d_opt = Adam(self.d_params, config.adam_b1, config.adam_b2)
        self._g_state = _state_buffers(self.generator)
        self._d_state = _state_buffers(self.discriminator)
        self._dtype = self.g_params[0].dtype
        self._host_step = 0
        if state is not None:
            self._load_state(state)
        self._input_field = ds.input_field
        self._label_field = ds.label_fields[0]
        self._transforms = {f: ds.transforms[f] for f in ds.fields}
        self._stats = {f: FieldStats(*(t.to(self.device) for t in (
            ds.stats[f].z_grid, ds.stats[f].mean, ds.stats[f].var)))
            for f in ds.fields}
        self.device_cache = None
        if device_data:
            self.device_cache = DeviceStackCache.create_if_fits(
                ds, config.device_cache_budget_bytes, device=self.device,
                use_kernel=use_kernel, mesh=mesh)
            if (self.device_cache is not None and config.pk_loss_weight > 0
                    and not config.pk_loss_per_z
                    and not self.device_cache.uniform_z):
                warnings.warn(
                    "pooled spectral loss (pk_loss_per_z=False) on a "
                    "z-skewed mesh: batch-mean spectra over-represent the "
                    "over-sampled redshifts and per-sample importance "
                    "weights cannot correct a pooled loss; use "
                    "pk_loss_per_z=True.",
                    stacklevel=2)
        # the loop's progress and data RNG, set by train() and restore()
        self._progress = None
        self._data_rng = None

    @property
    def steps(self) -> int:
        """The training steps taken (restored with a checkpoint)."""
        return self._host_step

    @property
    def is_writer(self) -> bool:
        """Whether this process writes the run's files (rank 0)."""
        return self.mesh is None or self.mesh.rank == 0

    @property
    def _n_ranks(self) -> int:
        return 1 if self.mesh is None else self.mesh.size

    def _active(self):
        return (self.mesh.active() if self.mesh is not None
                else contextlib.nullcontext())

    def _batch_mean(self, t):
        """The mean over the global batch of this rank's batch mean ``t``
        (equal shares), differentiable."""
        return t if self.mesh is None else self.mesh.mean(t)

    # ------------------------------------------------------------------ #

    def _prepare(self, raw_input, raw_label, z):
        """Raw tiles (N, H, W) -> transformed (x, y) as (N, 1, H, W), in
        f32 (the JAX trainer's), then in the networks' dtype."""
        y = self._transforms[self._input_field].forward(
            raw_input, self._stats[self._input_field], z)[:, None]
        x = self._transforms[self._label_field].forward(
            raw_label, self._stats[self._label_field], z)[:, None]
        return x.float().to(self._dtype), y.float().to(self._dtype)

    def _perc(self, fake, real, sample_weight=None):
        """This rank's share of the perceptual term (``_wmean``)."""
        n = self._n_ranks
        if self.config.perceptual_loss == "l1":
            return _wmean((fake - real).abs(), sample_weight, n)
        if self.config.perceptual_loss == "l2":
            return _wmean((fake - real) ** 2, sample_weight, n)
        raise ValueError(
            f"Unknown perceptual loss '{self.config.perceptual_loss}'.")

    def _pk_loss(self, fake_e, x, raw_input, raw_label, z):
        """The spectral term on an eval-mode paint ``fake_e``: clamped to
        the truth's transformed range +- 1, inverted in f32."""
        cfg = self.config
        pred_t = fake_e[:, 0].float()
        x0 = x[:, 0].float().detach()
        low, high = x0.min(), x0.max()
        if self.mesh is not None:
            low = self.mesh.all_reduce(low, "min")
            high = self.mesh.all_reduce(high, "max")
        pred_t = torch.clamp(pred_t, low - 1.0, high + 1.0)
        f = self._label_field
        pred = self._transforms[f].inverse(pred_t, self._stats[f], z)
        return pk_fidelity_loss(
            pred, raw_label.float(), raw_input.float(),
            L=float(self.training_data.tile_L), n_bins=cfg.pk_loss_n_bins,
            z=z, redshifts=(list(self.training_data.redshifts)
                            if cfg.pk_loss_per_z else None), mesh=self.mesh)

    def _update(self, params, opt, loss, lr, clip, metrics=()):
        """Gradients of ``loss`` in ``params`` (kept as their ``.grad``),
        their global norm before the clip, the clip, Adam and the update
        ``p + lr * direction``; returns the norm. Under a mesh the
        gradients, and the metric tensors ``metrics`` with them, are summed
        over the ranks in place first."""
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        grads = [g if g is not None else torch.zeros_like(p)
                 for p, g in zip(params, grads)]
        if self.mesh is not None:
            self.mesh.all_reduce_flat_(grads + list(metrics))
        for p, g in zip(params, grads):
            p.grad = g
        norm = grad_norm(grads)
        if clip > 0:
            clip_grads_by_global_norm(grads, clip)
        with torch.no_grad():
            for p, d in zip(params, opt.update(grads)):
                p.add_(lr * d)
        return norm.detach()

    def _step(self, raw_input, raw_label, z, lr, sample_weight=None):
        with f32_convolutions(), self._active():
            return self._step_f(raw_input, raw_label, z, lr, sample_weight)

    def _step_f(self, raw_input, raw_label, z, lr, sample_weight=None):
        cfg = self.config
        G, D = self.generator, self.discriminator
        sw, n = sample_weight, self._n_ranks
        x, y = self._prepare(raw_input, raw_label, z)
        adv_on = cfg.adversarial_weight > 0
        g_state0 = _clone(self._g_state) if cfg.freeze_bn_stats else None
        self._host_step += 1
        zero = torch.zeros((), device=self.device, dtype=self._dtype)

        fake_e = None
        if cfg.pk_loss_weight > 0 and adv_on:
            # the eval-mode paint with the step's starting statistics and
            # u, before the train-mode forward moves them
            G.eval()
            fake_e = G(y, z)
        if adv_on:
            G.train()
            fake = G(y, z)          # moves G's running state, once
        else:
            # calibration: every term through the eval-mode paint path
            G.eval()
            fake = G(y, z)
            fake_e = fake if cfg.pk_loss_weight > 0 else None

        # ---- discriminator update ------------------------------------ #
        if adv_on:
            D.train()
            p_real = D(y, z, x)
            kept = _clone(self._d_state)       # the real pass's u, sigma
            p_fake = D(y, z, fake.detach())
            _put(self._d_state, kept)
            loss_d = -(_wmean(torch.log(p_real + _EPS), sw, n)
                       + _wmean(torch.log(1 - p_fake + _EPS), sw, n))
            d_real = p_real.detach().mean() / n
            d_fake = p_fake.detach().mean() / n
            loss_d_value = loss_d.detach().clone()
            d_norm = self._update(self.d_params, self.d_opt, loss_d, lr,
                                  cfg.clip_grad_norm,
                                  (loss_d_value, d_real, d_fake))
            loss_d = loss_d_value
        else:
            loss_d = d_real = d_fake = d_norm = zero

        # ---- generator update, against the updated D in eval mode ---- #
        D.eval()
        if not adv_on:
            adv = adv_share = zero
        elif cfg.feature_matching:
            _, f_fake = D(y, z, fake, return_features=True)
            _, f_real = D(y, z, x, return_features=True)
            adv = ((self._feature_mean(f_real.detach(), sw)
                    - self._feature_mean(f_fake, sw)) ** 2).mean()
            # every rank holds the whole term: its share is 1/n of it
            adv_share = adv / n
        else:
            adv = adv_share = -_wmean(torch.log(D(y, z, fake) + _EPS), sw, n)
        perc = self._perc(fake, x, sw)
        loss_g = (cfg.adversarial_weight * adv_share
                  + cfg.lambda_perceptual * perc)
        pk = zero
        if fake_e is not None:
            pk = self._pk_loss(fake_e, x, raw_input, raw_label, z)
            loss_g = loss_g + cfg.pk_loss_weight * pk / n
        # adv's share is summed with the gradients (feature matching's adv
        # is whole on every rank already)
        shares = [perc.detach().clone()]
        if adv is adv_share:
            shares.append(adv.detach().clone())
        g_norm = self._update(self.g_params, self.g_opt, loss_g, lr,
                              cfg.clip_grad_norm, shares)
        adv = shares[1] if adv is adv_share else adv.detach()
        G.eval()
        if g_state0 is not None:
            _put(self._g_state, g_state0)
        return {"loss_D": loss_d, "loss_G_adv": adv,
                "pk_loss": pk.detach(), "loss_G_perceptual": shares[0],
                "D_real": d_real, "D_fake": d_fake, "grad_norm": g_norm,
                "d_grad_norm": d_norm}

    def _feature_mean(self, f, sample_weight=None):
        """The global batch's mean of D's body features (N, C, H, W) -> (C,),
        importance-weighted along the batch with ``sample_weight``."""
        per = f.float().mean(dim=(2, 3))                       # (N, C)
        if sample_weight is None:
            return self._batch_mean(per.mean(0))
        w = sample_weight.to(per.dtype)[:, None]
        num, den = (per * w).sum(0), w.sum()
        if self.mesh is not None:
            num, den = self.mesh.sum(num), self.mesh.all_reduce(den)
        return num / den

    def _to_device(self, batch):
        as_t = lambda a: to_device(np.asarray(a, np.float32), self.device)
        return (as_t(batch["input"]), as_t(batch["labels"][0]),
                as_t(batch["z"]))

    def step(self, batch: dict, lr: float) -> dict:
        """One training step on a raw host batch
        (``BahamasTileDataset.get_raw_batch``; under a mesh the global
        batch, of which each rank steps on its rows); returns its metrics
        as 0-d device tensors."""
        return self._step(*self._to_device(local_rows(self.mesh, batch)[0]),
                          lr)

    def step_indices(self, idx: np.ndarray, lr: float) -> dict:
        """One training step by sample index, the batch assembled on the
        device from the stack cache (``device_data=True``). Under a mesh
        ``idx`` is the global batch (device-grouped with a z-sharded
        cache: ``sample_mesh_indices``), its rows weighted by the cache's
        importance weights where the layout samples redshifts unevenly."""
        cache = self.device_cache
        if cache is None:
            raise RuntimeError("Construct the trainer with device_data=True "
                               "to use step_indices.")
        digits = cache.digits(idx)
        weights = None
        if self.mesh is not None:
            lo, hi = self.mesh.rows(len(digits))
            weights = cache.sample_weights(digits[lo:hi])
        raw_input, raw_labels, z = cache.gather(cache.local_digits(digits))
        return self._step(raw_input, raw_labels[0], z, lr, weights)

    def _sample_indices(self, rng, n: int) -> np.ndarray:
        """A global batch's indices: device-grouped when the stack cache is
        z-sharded, else the dataset's own draw."""
        if self.device_cache is not None and self.device_cache.mesh is not None:
            return self.device_cache.sample_mesh_indices(rng, n)
        return self.training_data.sample_indices(rng, n)

    def step_scan(self, idx_matrix: np.ndarray, lr) -> dict:
        """K steps of ``step_indices``: ``idx_matrix`` (K, B) sample
        indices, ``lr`` a scalar or a (K,) schedule. Returns the per-step
        metrics stacked along a leading K axis (the JAX package runs the
        same steps in one ``lax.scan``)."""
        if self.device_cache is None:
            raise RuntimeError("Construct the trainer with device_data=True "
                               "to use step_scan.")
        k = len(idx_matrix)
        lrs = np.broadcast_to(np.asarray(lr, np.float64), (k,))
        steps = [self.step_indices(idx_matrix[i], float(lrs[i]))
                 for i in range(k)]
        return {key: torch.stack([m[key] for m in steps])
                for key in steps[0]}

    @torch.no_grad()
    def eval_loss(self, batch: dict) -> dict:
        """The step's D and G loss terms on a host batch with both networks
        in eval mode; nothing of the state changes (the JAX trainer's
        ``eval_loss``). Under a mesh the global batch, shared over the
        ranks as in ``step``."""
        raw_input, raw_label, z = self._to_device(
            local_rows(self.mesh, batch)[0])
        x, y = self._prepare(raw_input, raw_label, z)
        G, D = self.generator.eval(), self.discriminator.eval()
        with f32_convolutions():
            fake = G(y, z)
            p_real = D(y, z, x)
            p_fake = D(y, z, fake)
        n = self._n_ranks
        out = {"loss_D": -(_wmean(torch.log(p_real + _EPS), None, n)
                           + _wmean(torch.log(1 - p_fake + _EPS), None, n)),
               "loss_G_adv": -_wmean(torch.log(p_fake + _EPS), None, n),
               "loss_G_perceptual": self._perc(fake, x),
               "D_real": p_real.mean() / n, "D_fake": p_fake.mean() / n}
        if self.mesh is not None:
            self.mesh.all_reduce_flat_(list(out.values()))
        out["pk_loss"] = torch.zeros((), device=self.device)
        return out

    # ------------------------------------------------------------------ #

    @staticmethod
    def _host_rows(metrics_list) -> list:
        """The statistics rows of several steps as host floats, in one
        device-to-host copy."""
        flat = torch.stack([torch.stack([m[k].float() for k in _STATS_TERMS])
                            for m in metrics_list]).cpu().numpy()
        return [tuple(float(v) for v in row) for row in flat]

    def stats_tuple(self, metrics) -> tuple:
        """One step's (or evaluation's) statistics row: loss_D, loss_G_adv,
        loss_G_perceptual, D_real, D_fake, as host floats."""
        return self._host_rows([metrics])[0]

    def stats_labels(self) -> list:
        return [*_STATS_TERMS, "lr", "batch_size"]

    def _flush_stats(self, pending, stats):
        """Push the buffered steps' metrics to ``stats`` after one copy to
        the host."""
        if not pending:
            return
        rows = self._host_rows([m for _, m, _ in pending])
        for (n_samples, _, lr), row in zip(pending, rows):
            stats.push_loss(n_samples, *row, lr, self.config.batch_size)
        pending.clear()

    def train(self):
        """The adversarial training run with pepoch lr decay; returns
        ``(training_stats, validation_stats)``. The JAX trainer's loop: the
        same draws from the data RNG (seeded ``config.seed``, or restored),
        the same pepoch, validation, checkpoint and report points, the same
        statistics files. With the stack cache the steps up to the next of
        those points run as one ``step_scan`` of at most
        ``stats_sync_every`` steps, rounded down to a power of two; without
        it, one ``step`` on a host batch at a time."""
        cfg = self.config
        ds = self.training_data
        out = cfg.output_path
        train_fn = val_fn = None
        if out is not None:
            if self.is_writer:
                os.makedirs(out, exist_ok=True)
            train_fn = os.path.join(out, "training_stats.txt")
            val_fn = os.path.join(out, "validation_stats.txt")

        progress = dict(self._progress or {})
        resuming = bool(progress)
        n_samples = progress.get("n_samples", 0)
        i_pepoch = progress.get("i_pepoch", 0)
        last_pepoch = progress.get("last_pepoch_samples", 0)
        last_val_loss = progress.get("last_val_loss", 0)
        last_ckpt = progress.get("last_ckpt", 0)
        data_rng = (self._data_rng if resuming and self._data_rng is not None
                    else np.random.default_rng(cfg.seed))

        up_to = n_samples if resuming else None
        stats, validation_stats = run_stats(
            self, self.stats_labels(), train_fn, val_fn, resuming, up_to)
        t0 = time.time()
        lr = cfg.learning_rate * cfg.lr_decay ** i_pepoch
        pending = []
        last_report = n_samples  # console cadence only; not checkpointed

        def snapshot_progress():
            self._progress = {"n_samples": n_samples, "i_pepoch": i_pepoch,
                              "last_pepoch_samples": last_pepoch,
                              "last_val_loss": last_val_loss,
                              "last_ckpt": last_ckpt}
            self._data_rng = data_rng

        while i_pepoch < cfg.n_pepoch:
            if n_samples - cfg.pepoch_size >= last_pepoch and n_samples:
                i_pepoch += 1
                last_pepoch = n_samples
                lr = cfg.learning_rate * cfg.lr_decay ** i_pepoch
                if i_pepoch >= cfg.n_pepoch:
                    break
            if self.device_cache is not None:
                # the steps up to the next pepoch / checkpoint / validation
                # / report point as one step_scan (a power of two)
                horizons = [last_pepoch + cfg.pepoch_size]
                if out is not None:
                    horizons.append(last_ckpt + cfg.checkpoint_frequency)
                if (self.test_data is not None
                        and cfg.validation_loss_frequency > 0):
                    horizons.append(last_val_loss
                                    + cfg.validation_loss_frequency)
                if cfg.verbose and cfg.statistics_report_frequency > 0:
                    horizons.append(last_report
                                    + cfg.statistics_report_frequency)
                until = max(min(horizons) - n_samples, 1)
                k = min(max(1, cfg.stats_sync_every),
                        -(-until // cfg.batch_size))
                k = 1 << (k.bit_length() - 1)
                idx = np.stack([self._sample_indices(data_rng,
                                                     cfg.batch_size)
                                for _ in range(k)])
                metrics_k = self.step_scan(idx, lr=lr)
                for i in range(k):
                    n_samples += cfg.batch_size
                    pending.append(
                        (n_samples, {key: v[i] for key, v in
                                     metrics_k.items()}, lr))
            else:
                idx = ds.sample_indices(data_rng, cfg.batch_size)
                m = self.step(ds.get_raw_batch(idx), lr=lr)
                n_samples += cfg.batch_size
                pending.append((n_samples, m, lr))
            if len(pending) >= max(1, cfg.stats_sync_every):
                self._flush_stats(pending, stats)
            if (self.test_data is not None
                    and cfg.validation_loss_frequency > 0
                    and n_samples - cfg.validation_loss_frequency
                    >= last_val_loss):
                self._flush_stats(pending, stats)
                last_val_loss = n_samples
                vidx = self.test_data.sample_indices(
                    data_rng, cfg.validation_loss_batch_size)
                vm = self.eval_loss(self.test_data.get_raw_batch(vidx))
                validation_stats.push_loss(n_samples, *self.stats_tuple(vm),
                                           lr, cfg.batch_size)
            if (out is not None
                    and n_samples - cfg.checkpoint_frequency >= last_ckpt):
                last_ckpt = n_samples
                self._flush_stats(pending, stats)
                stats.flush_to_file()
                validation_stats.flush_to_file()
                snapshot_progress()
                self.save(os.path.join(out,
                                       f"checkpoint_sample{n_samples:0>10}"))
                if self.is_writer:
                    ckpt.rotate_checkpoints(out, cfg.keep_last_checkpoints)
            if (cfg.verbose and pending
                    and cfg.statistics_report_frequency > 0
                    and n_samples - cfg.statistics_report_frequency
                    >= last_report):
                last_report = n_samples
                self._flush_stats(pending, stats)
                rate = n_samples / (time.time() - t0)
                d = stats.loss_terms["loss_D"]["mavg"][-1]
                g = stats.loss_terms["loss_G_adv"]["mavg"][-1]
                if self.is_writer:
                    print(f"pepoch [{i_pepoch}/{cfg.n_pepoch}] samples "
                          f"{n_samples} D {d:.3f} G_adv {g:.3f} "
                          f"({rate:.1f} samples/s)")
        self._flush_stats(pending, stats)
        stats.flush_to_file()
        validation_stats.flush_to_file()
        snapshot_progress()
        if out is not None:
            self.save(os.path.join(out, "model"))
        return stats, validation_stats

    @torch.no_grad()
    def validation_sample(self, validation_batch_size: int = 8,
                          validation_redshift: Optional[float] = None,
                          seed: int = 0) -> dict:
        """``validate``'s painted test batch: ``validation_batch_size``
        samples of the test data (of redshift ``validation_redshift`` if
        given) drawn from a generator seeded ``seed``, painted by the
        eval-mode generator. Returns the truth ``x``, the input ``y`` and
        ``pred`` (N, 1, H, W), f32 on the trainer's device, and the
        redshifts ``z`` (numpy)."""
        batch = draw_test_batch(self.test_data, validation_batch_size,
                                validation_redshift, seed)
        raw_input, raw_label, z = self._to_device(batch)
        x, y = self._prepare(raw_input, raw_label, z)
        G = self.generator
        was_training = G.training
        G.eval()
        try:
            with f32_convolutions():
                fake = G(y, z)
        finally:
            G.train(was_training)
        return {"x": x.float(), "y": y.float(), "pred": fake.float(),
                "z": batch["z"]}

    def validate(self, validation_batch_size: int = 8,
                 validation_redshift: Optional[float] = None,
                 plot_power_spectra=("auto",), plot_histogram=("log",),
                 save_plots: bool = False,
                 filename_template: str = "{plot_type}.png", seed: int = 0):
        """Sample / P(k) / histogram diagnostics on a test batch
        (``validation_sample``), the same surface as
        ``CVAETrainer.validate`` (reference painter.py:295-367): the
        figures as a dict, saved when ``save_plots``. They need
        matplotlib: without it this raises an ImportError before any
        work."""
        from baryon_painter_tpu_torch.utils import validation_plotting as vp
        vp.require_matplotlib()
        s = self.validation_sample(validation_batch_size, validation_redshift,
                                   seed=seed)
        figs = vp.validation_figures(
            s["x"], s["pred"], s["y"], self.test_data, s["z"],
            spectra=plot_power_spectra, histograms=plot_histogram,
            device=self.device)
        if save_plots:
            vp.save_figures(figs, filename_template)
        return figs

    # ------------------------------------------------------------------ #

    def state_tree(self, include_opt_state: bool = True) -> dict:
        """The trainer's state as the JAX trainer's checkpoint tree (numpy,
        the JAX layout): both networks' params and stats, their Adam
        states, the step, and what the loop needs to resume (progress,
        data_rng)."""
        state = gan_state_to_jax(
            self.generator, self.discriminator,
            (self.g_opt.mu, self.g_opt.nu, self.g_opt.count),
            (self.d_opt.mu, self.d_opt.nu, self.d_opt.count),
            self._host_step)
        if not include_opt_state:
            del state["g_opt"], state["d_opt"]
        if self._progress is not None:
            state["progress"] = np.array(
                [self._progress[k] for k in _GAN_PROGRESS_KEYS],
                dtype=np.int64)
        if self._data_rng is not None:
            state["data_rng"] = _encode_data_rng(self._data_rng)
        return state

    def save(self, base_path: str, include_opt_state: bool = True) -> int:
        """Write the checkpoint pair at ``base_path`` (meta
        ``model_kind="cgan"``); returns the state's bytes. Under a mesh
        rank 0 writes (the others return 0) and every rank waits for it."""
        nbytes = 0
        if self.is_writer:
            meta = ckpt.meta_from_dataset(self.training_data,
                                          self.generator.architecture,
                                          model_kind="cgan")
            nbytes = ckpt.save_checkpoint(
                base_path, self.state_tree(include_opt_state), meta)
        if self.mesh is not None:
            self.mesh.barrier()
        return nbytes

    @torch.no_grad()
    def _load_state(self, state: dict):
        loaded = gan_state_from_jax(self.generator, self.discriminator,
                                    state)
        for net, opt in (("g", self.g_opt), ("d", self.d_opt)):
            if net in loaded:
                for dst, src in zip(opt.mu + opt.nu,
                                    loaded[net]["mu"] + loaded[net]["nu"]):
                    dst.copy_(src)
                opt.count = loaded[net]["count"]
        self._host_step = loaded["step"]

    def restore(self, base_path: str) -> dict:
        """Load a checkpoint written by this trainer or the JAX one: both
        networks, their states and Adams and the step exactly, and the
        loop's progress and data RNG for ``train`` to resume from.
        Returns the meta."""
        raw, meta = ckpt.load_checkpoint(base_path, keep_optimizer=True)
        self._load_state(raw)
        if "progress" in raw:
            vals = np.asarray(raw["progress"], dtype=np.int64)
            self._progress = {k: int(v)
                              for k, v in zip(_GAN_PROGRESS_KEYS, vals)}
            if "data_rng" in raw:
                self._data_rng = _decode_data_rng(raw["data_rng"])
        return meta

    def reinit_discriminator(self, seed: int = 0):
        """Replace D's parameters, its spectral-norm state and its Adam
        with a fresh initialisation (``convert.init_discriminator`` from
        ``seed``), keeping G untouched: the "fresh D" recipe for an
        adversarial fine-tune from a calibrated generator
        (trained_models/CGAN/fiducial-adv/README.md). Call after
        ``restore``."""
        init_discriminator(self.discriminator, seed)
        cfg = self.config
        self.d_opt = Adam(self.d_params, cfg.adam_b1, cfg.adam_b2)
