"""CVAE training, in PyTorch: the step and the training run.

Port of ``baryon_painter_tpu/train/trainer.py``. The step: raw tiles ->
transforms on the device -> CVAE forward -> ELBO [+ spectral term] ->
gradients -> global-norm clip -> Adam, with the learning rate, alpha_var
and beta_KL given per step. The batch comes from the host (``step``) or is
assembled on the device from the stack cache (``step_indices``,
``step_scan``; ``device_data=True``), the tile gather through K2. With
``CVAE(..., fused_heads=True)`` the output heads run through K3, forward
and backward; with ``CVAE(...,
fused_train_conv=True)`` the gated train-mode conv + batch norm + ReLU
triples run through K4, in f32 or bf16. The step computes in the model's
dtype (``CVAE(..., dtype=torch.bfloat16)`` is the JAX package's bf16
training): the batch is prepared in f32 and the parameters, their
gradients, the Adam state and the batch statistics stay f32, as in the JAX
trainer. An f32
step trains in f32 whatever the caller's TF32 setting
(``utils/platform.f32_convolutions``).

    trainer = CVAETrainer(CVAE(arch, fused_heads=True), dataset,
                          test_data=held_out, device_data=True,
                          config=TrainConfig(n_pepoch=3, pepoch_size=96,
                                             batch_size=24,
                                             output_path="run"))
    training_stats, validation_stats = trainer.train()
    trainer.restore("run/checkpoint_sample0000000096")  # resume from there

The run (``train``) is the JAX trainer's loop, draw for draw: the pepoch
schedules of batch size, learning rate, alpha_var and beta_KL (the reactive
``ReduceLROnPlateau`` fed the training ELBO's moving average), the
validation loss on the test data, ``training_stats.txt`` and
``validation_stats.txt``, periodic checkpoints with rotation and the final
``model`` checkpoint in the JAX package's format, with the Adam state, the
loop's progress, the data RNG and the schedule's state, so that either
package resumes a run the other wrote. The metrics stay on the device
between flushes, one copy to the host every ``stats_sync_every`` steps.

Adam is the JAX package's ``optax.chain(scale_by_adam(b1, b2), scale(-1))``
with the learning rate multiplied outside, written out here (``Adam``). The
latent noise of step s comes from a ``torch.Generator`` seeded from
``(config.seed, s)``, as the JAX trainer folds s into its key, so a run
resumed from a checkpoint draws what the uninterrupted run drew; tests
inject it with ``eps=``.

The spectral term (``pk_loss_weight`` > 0, ``train/spectral.py``) paints
the batch from the prior through the eval-mode decoder (batch norm on the
running statistics, which it does not update; K3 forward and backward with
``fused_heads``), clamps the paint to the truth's transformed range +- 1,
inverts the transform in f32 and adds ``pk_loss_weight`` times the P(k)
loss in physical space to the negative ELBO, one backward for both. Its
prior noise comes from a second generator seeded from ``(config.seed, s,
1)``, as the JAX trainer folds 1 into step s's key (tests inject it with
``pk_eps=``).

``validate`` draws the JAX trainer's figures (matplotlib) from a test
batch painted by the eval-mode ``sample_P``.

Data parallelism (``mesh=``, a ``parallel.mesh.ProcessMesh``: one process a
device, as under ``torchrun``) is the JAX trainer's ``P("data")`` mesh:
every rank draws the same global indices from the same data RNG and takes
rows ``[r B/n, (r+1) B/n)`` (with the stack cache z-sharded over the ranks,
its device-grouped rows: ``DeviceStackCache``, where the cache's
importance weights reweigh each row when the layout samples redshifts
unevenly); the batch norms and K4 take their statistics over the global
batch (``models/layers.BatchNorm``, ``ops/conv_bn.conv_bn_relu``); each
rank's ELBO terms are its rows' sums over the global B, and their
gradients and metrics are summed over the ranks in one all-reduce before
the global-norm clip and Adam, which then run identically everywhere. The
latent noise of a rank's rows is those rows of the global draw, so the
step equals the one-process step on the whole batch up to summation
order. Rank 0 writes the statistics files and checkpoints; every rank
restores from the same file. The initial weights are rank 0's.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
import warnings
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from baryon_painter_tpu_torch.convert import (init_cvae, load_jax_variables,
                                              train_state_from_jax,
                                              train_state_to_jax, trainable)
from baryon_painter_tpu_torch.data.dataset import BahamasTileDataset
from baryon_painter_tpu_torch.data.device_cache import DeviceStackCache
from baryon_painter_tpu_torch.models.cvae import CVAE
from baryon_painter_tpu_torch.models.layers import BatchNorm
from baryon_painter_tpu_torch.parallel.mesh import ProcessMesh
from baryon_painter_tpu_torch.train import checkpoint as ckpt
from baryon_painter_tpu_torch.train.spectral import pk_fidelity_loss
from baryon_painter_tpu_torch.train.stats import TrainingStats
from baryon_painter_tpu_torch.transforms import FieldStats
from baryon_painter_tpu_torch.utils.platform import (f32_convolutions,
                                                     resolve_device,
                                                     to_device)

__all__ = ["TrainConfig", "CVAETrainer", "Adam", "grad_norm",
           "clip_grads_by_global_norm"]


def _encode_data_rng(rng: np.random.Generator) -> np.ndarray:
    """PCG64 generator state -> uint64[6] (128-bit state/inc split hi/lo)."""
    st = rng.bit_generator.state
    s, inc = st["state"]["state"], st["state"]["inc"]
    mask = (1 << 64) - 1
    return np.array([s >> 64, s & mask, inc >> 64, inc & mask,
                     st["has_uint32"], st["uinteger"]], dtype=np.uint64)


def _decode_data_rng(arr) -> np.random.Generator:
    a = [int(v) for v in np.asarray(arr, dtype=np.uint64)]
    rng = np.random.default_rng(0)
    rng.bit_generator.state = {
        "bit_generator": "PCG64",
        "state": {"state": (a[0] << 64) | a[1], "inc": (a[2] << 64) | a[3]},
        "has_uint32": a[4], "uinteger": a[5]}
    return rng


_PROGRESS_KEYS = ("n_samples", "i_pepoch", "last_pepoch_samples",
                  "last_val_loss", "last_ckpt", "last_report")
# the CGAN loop checkpoints no report counter (the JAX package's
# _GAN_PROGRESS_KEYS)
_GAN_PROGRESS_KEYS = ("n_samples", "i_pepoch", "last_pepoch_samples",
                      "last_val_loss", "last_ckpt")


def _step_seed(seed: int, step: int, stream: int = 0) -> int:
    """The seed of step ``step``'s latent-noise generator: stream 0 draws
    the ELBO's noise, stream 1 the spectral term's prior noise."""
    entropy = [seed & (2 ** 64 - 1), step] + ([stream] if stream else [])
    return int(np.random.SeedSequence(entropy).generate_state(1, np.uint64)[0])


@dataclasses.dataclass
class TrainConfig:
    """The JAX package's ``TrainConfig``, field for field. Sample counts
    (``pepoch_size``, the ``*_frequency`` fields) are in samples; the
    ``adaptive_*`` and ``*_anneal_fn`` schedules map a pepoch to a value
    (``train/schedules.py``, ``train/run_config.py``).

    ``freeze_bn_stats`` keeps the batch-norm running statistics at their
    values (fine-tunes: the painted field goes through them);
    ``clip_grad_norm`` > 0 clips the gradients to that global norm.
    ``pk_loss_weight`` > 0 adds the spectral term over ``pk_loss_n_bins``
    log-spaced k bins, per redshift with ``pk_loss_per_z`` (masked
    batch-mean spectra, one term per training redshift) or pooled over the
    batch."""

    learning_rate: float = 1e-4
    batch_size: int = 1
    n_pepoch: int = 5
    pepoch_size: int = 3136
    adaptive_learning_rate: Optional[Callable[[int], float]] = None
    adaptive_batch_size: Optional[Callable[[int], int]] = None
    var_anneal_fn: Optional[Callable[[int], float]] = None
    KL_anneal_fn: Optional[Callable[[int], float]] = None
    validation_loss_frequency: int = 100
    validation_loss_batch_size: int = 16
    checkpoint_frequency: int = 1000
    keep_last_checkpoints: int = 0             # 0 keeps every checkpoint
    statistics_report_frequency: int = 50      # 0 = off
    stats_sync_every: int = 16                 # steps between host copies
    mavg_window_size: int = 20
    output_path: Optional[str] = None
    seed: int = 0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    device_cache_budget_bytes: int = 8 * 1024 ** 3
    pk_loss_weight: float = 0.0
    pk_loss_n_bins: int = 12
    pk_loss_per_z: bool = False
    freeze_bn_stats: bool = False
    clip_grad_norm: float = 0.0
    verbose: bool = False


def draw_test_batch(test_data, batch_size: int,
                    redshift: Optional[float], seed: int) -> dict:
    """The raw batch a trainer validates on: ``batch_size`` samples of
    ``test_data`` (of redshift ``redshift`` if given) drawn from a generator
    seeded ``seed``."""
    if test_data is None:
        raise RuntimeError("Trying to validate but no test data specified.")
    idx = test_data.sample_indices(np.random.default_rng(seed), batch_size,
                                   z=redshift)
    return test_data.get_raw_batch(idx)


def check_process_mesh(mesh, device):
    """The device a trainer computes on under ``mesh``: a ``ProcessMesh``'s
    own device (a ``device`` that differs raises), else ``device``
    resolved. Any other kind of mesh raises."""
    if mesh is None:
        return resolve_device(device)
    if not isinstance(mesh, ProcessMesh):
        raise TypeError(f"training takes a ProcessMesh (one process a "
                        f"device), got {type(mesh).__name__}; a DeviceMesh "
                        f"is for painting")
    if device is not None and resolve_device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's "
                         f"{mesh.device}")
    return mesh.device


def local_rows(mesh, batch: dict):
    """(this rank's rows of a raw host batch, (lo, B)); the whole batch and
    None without a mesh."""
    if mesh is None:
        return batch, None
    n = len(batch["input"])
    lo, hi = mesh.rows(n)
    out = dict(batch, input=np.asarray(batch["input"])[lo:hi],
               z=np.asarray(batch["z"])[lo:hi],
               labels=np.asarray(batch["labels"])[:, lo:hi])
    return out, (lo, n)


def local_noise(mesh, eps):
    """This rank's rows of a global batch's noise ``eps``: (L, B, ...)
    5-d latent noise along its second axis, else along its first (``eps``
    unchanged without a mesh, or when None)."""
    if eps is None or mesh is None:
        return eps
    eps = torch.as_tensor(eps)
    axis = 1 if eps.ndim == 5 else 0
    lo, hi = mesh.rows(eps.shape[axis])
    return eps.narrow(axis, lo, hi - lo)


def run_stats(trainer, labels, train_fn, val_fn, resuming: bool, up_to):
    """A run's (training, validation) ``TrainingStats``: the writer (rank 0,
    or the only process) writes the files, re-loading them on a resume; the
    other ranks of a mesh re-load the same history after it, without
    writing, so that every rank's moving averages agree."""
    writer = trainer.is_writer
    make = lambda fn, **kw: TrainingStats(
        labels, trainer.config.mavg_window_size,
        stats_filename=fn if writer else None,
        resume=resuming, resume_up_to=up_to, **kw)
    stats = (make(train_fn), make(val_fn, dump_to_file_frequency=1))
    if trainer.mesh is not None:
        trainer.mesh.barrier()
        if not writer and resuming:
            for st, fn in zip(stats, (train_fn, val_fn)):
                if fn is not None and os.path.exists(fn):
                    st._resume_from_file(fn, up_to)
    return stats


def grad_norm(grads) -> torch.Tensor:
    """Global L2 norm of a list of tensors (``optax.global_norm``)."""
    return torch.sqrt(sum(torch.sum(g * g) for g in grads))


def clip_grads_by_global_norm(grads, max_norm: float):
    """Scale ``grads`` in place so their global norm is at most
    ``max_norm``, as the JAX package does."""
    scale = torch.clamp(max_norm / torch.clamp(grad_norm(grads), min=1e-12),
                        max=1.0)
    for g in grads:
        g.mul_(scale)
    return grads


class Adam:
    """``optax.chain(scale_by_adam(b1, b2, eps=1e-8), scale(-1))``: the
    direction of each step, in f32, term for term as optax computes it; the
    caller adds ``lr * direction`` to the parameters."""

    def __init__(self, params, b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = 0

    @torch.no_grad()
    def update(self, grads):
        self.count += 1
        b1, b2 = self.b1, self.b2
        # 1 - decay**count in f32, as optax's bias correction
        bc1 = float(np.float32(1) - np.float32(b1) ** self.count)
        bc2 = float(np.float32(1) - np.float32(b2) ** self.count)
        out = []
        for g, mu, nu in zip(grads, self.mu, self.nu):
            mu.copy_((1 - b1) * g + b1 * mu)
            nu.copy_((1 - b2) * (g * g) + b2 * nu)
            out.append(-((mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)))
        return out


class CVAETrainer:
    def __init__(self, model: CVAE, training_data: BahamasTileDataset,
                 test_data: Optional[BahamasTileDataset] = None,
                 config: TrainConfig = TrainConfig(),
                 device_data: bool = False, device=None,
                 use_kernel="auto", variables: Optional[dict] = None,
                 mesh: Optional[ProcessMesh] = None):
        """Set up training of ``model`` on ``device`` (``cuda`` unless the
        caller passes ``device="cpu"``); ``test_data`` is what the
        validation loss is computed on. ``mesh``: a ``ProcessMesh`` for
        data-parallel training on its device (module docstring); the stack
        cache is then z-sharded over its ranks.

        The weights are drawn by ``convert.init_cvae`` from
        ``config.seed``, or loaded from ``variables`` (JAX-layout
        ``{"params", "batch_stats"}`` as numpy, e.g. the JAX trainer's
        initial state). ``device_data=True`` uploads the stacks to the
        device once (``DeviceStackCache``, the gather through K2 unless
        ``use_kernel=False``) for ``step_indices``/``step_scan``, which
        ``train`` then uses."""
        if (config.pk_loss_weight > 0
                and model.architecture.get("fused_res_blocks")):
            raise ValueError(
                "pk_loss_weight requires fused_res_blocks=False: the loss "
                "differentiates through the eval-mode paint path, and the "
                "fused residual block (K1) has no backward.")
        self.device = check_process_mesh(mesh, device)
        self.mesh = mesh
        self.config = config
        self.training_data = training_data
        self.test_data = test_data
        if variables is not None:
            load_jax_variables(model, variables)
        else:
            init_cvae(model, config.seed)
        self.model = model.to(self.device).train()
        if mesh is not None:
            mesh.broadcast_module_(self.model)
        self.params = trainable(self.model)
        self.optimizer = Adam(self.params, config.adam_b1, config.adam_b2)
        self._bn = [m for m in self.model.modules()
                    if isinstance(m, BatchNorm)]
        # steps taken: step s draws its latent noise from (seed, s)
        self._host_step = 0
        ds = training_data
        self._input_field = ds.input_field
        self._label_fields = list(ds.label_fields)
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
                    "pk_loss_per_z=True.", stacklevel=2)
        # the loop's progress and data RNG, set by train() and restore()
        self._progress = None
        self._data_rng = None
        # optional declarative RunConfig (train/run_config.py), stored in
        # every checkpoint's meta
        self.run_config = None

    @property
    def steps(self) -> int:
        """The training steps taken (restored with a checkpoint)."""
        return self._host_step

    def _channels(self, field, arr, z):
        """A raw (N,H,W) field transformed, as NCHW: one channel, or the
        (N,C,H,W) a transform emits (the JAX trainer's ``_to_channels``)."""
        out = self._transforms[field].forward(arr, self._stats[field], z)
        return out[:, None] if out.ndim == 3 else out

    def _prepare(self, raw_input, raw_labels, z):
        """Raw tiles (N,H,W) and labels (n_label,N,H,W) -> transformed
        (x, y) in NCHW, f32 whatever the model's dtype."""
        y = self._channels(self._input_field, raw_input, z)
        x = torch.cat([self._channels(f, raw_labels[j], z)
                       for j, f in enumerate(self._label_fields)], dim=1)
        return x.float(), y.float()

    def _bn_state(self):
        return [(m.running_mean.clone(), m.running_var.clone())
                for m in self._bn]

    @torch.no_grad()
    def _restore_bn(self, state):
        for m, (mean, var) in zip(self._bn, state):
            m.running_mean.copy_(mean)
            m.running_var.copy_(var)

    @property
    def is_writer(self) -> bool:
        """Whether this process writes the run's files (rank 0)."""
        return self.mesh is None or self.mesh.rank == 0

    def _active(self):
        return (self.mesh.active() if self.mesh is not None
                else contextlib.nullcontext())

    def _step(self, raw_input, raw_labels, z, lr, alpha_var, beta_KL, eps,
              pk_eps=None, batch_rows=None, sample_weight=None):
        with f32_convolutions():
            return self._step_f(raw_input, raw_labels, z, lr, alpha_var,
                                beta_KL, eps, pk_eps, batch_rows,
                                sample_weight)

    def _noise(self, step: int, stream: int = 0) -> torch.Generator:
        """The generator of step ``step``'s latent noise (stream 0) or of
        its spectral term's prior noise (stream 1)."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(_step_seed(self.config.seed, step, stream))
        return gen

    def _pk_loss(self, raw_input, raw_labels, z, x, y, pk_eps, generator,
                 batch_rows=None):
        """The spectral term: a prior sample painted through the eval-mode
        decoder, clamped to the truth's transformed range +- 1 (so the
        inverse transform's exp cannot overflow on early outliers; the
        global batch's range under a mesh), inverted to physical space in
        f32, against the truth's auto- and cross-P(k)
        (``train/spectral.py``, over the global batch)."""
        self.model.eval()
        try:
            pred_t = self.model.sample_P(y, z, eps=pk_eps,
                                         generator=generator,
                                         batch_rows=batch_rows)
        finally:
            self.model.train()
        pred_t = pred_t[:, 0].float()
        x0 = x[:, 0].float().detach()
        low, high = x0.min(), x0.max()
        if self.mesh is not None:
            low = self.mesh.all_reduce(low, "min")
            high = self.mesh.all_reduce(high, "max")
        pred_t = torch.clamp(pred_t, low - 1.0, high + 1.0)
        field = self._label_fields[0]
        pred = self._transforms[field].inverse(pred_t, self._stats[field], z)
        cfg = self.config
        return pk_fidelity_loss(
            pred, raw_labels[0].float(), raw_input.float(),
            L=float(self.training_data.tile_L), n_bins=cfg.pk_loss_n_bins,
            z=z, redshifts=(list(self.training_data.redshifts)
                            if cfg.pk_loss_per_z else None), mesh=self.mesh)

    def _reduce(self, grads, metrics: dict):
        """Sum this rank's gradients (in place) and metrics over the ranks,
        in one all-reduce; the metrics of ``metrics`` hold each rank's
        share, apart from ``pk_loss``, which every rank holds whole."""
        keys = [k for k in metrics if k != "pk_loss"]
        self.mesh.all_reduce_flat_(list(grads) + [metrics[k] for k in keys])

    def _step_f(self, raw_input, raw_labels, z, lr, alpha_var, beta_KL,
                eps, pk_eps, batch_rows=None, sample_weight=None):
        x, y = self._prepare(raw_input, raw_labels, z)
        frozen = self._bn_state() if self.config.freeze_bn_stats else None
        for p in self.params:
            p.grad = None
        step = self._host_step
        self._host_step += 1
        n_ranks = 1 if self.mesh is None else self.mesh.size
        with self._active():
            pk = None
            if self.config.pk_loss_weight > 0:
                # before the ELBO's forward, which moves the running
                # statistics this term paints through
                pk = self._pk_loss(raw_input, raw_labels, z, x, y, pk_eps,
                                   self._noise(step, stream=1), batch_rows)
            out = self.model(x, y, z, alpha_var=alpha_var, beta_KL=beta_KL,
                             eps=eps, generator=self._noise(step),
                             sample_weight=sample_weight,
                             batch_rows=batch_rows)
            loss = -out["elbo"]
            if pk is not None:
                out["pk_loss"] = pk
                # every rank holds the whole term: its share of the sum of
                # the ranks' losses
                loss = loss + self.config.pk_loss_weight * pk / n_ranks
            loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        metrics = {k: v.detach() for k, v in out.items()
                   if k not in ("x_mu", "x_var")}
        if self.mesh is not None:
            metrics = {k: v.clone() for k, v in metrics.items()}
            self._reduce(grads, metrics)
        norm = grad_norm(grads)
        if self.config.clip_grad_norm > 0:
            clip_grads_by_global_norm(grads, self.config.clip_grad_norm)
        with torch.no_grad():
            for p, d in zip(self.params, self.optimizer.update(grads)):
                p.add_(lr * d)
        if frozen is not None:
            self._restore_bn(frozen)
        metrics["grad_norm"] = norm.detach()
        return metrics

    def _to_device(self, batch):
        as_t = lambda a: to_device(np.asarray(a, np.float32), self.device)
        return as_t(batch["input"]), as_t(batch["labels"]), as_t(batch["z"])

    def step(self, batch: dict, lr: float, alpha_var: float = 1.0,
             beta_KL: float = 1.0, eps=None, pk_eps=None) -> dict:
        """One training step on a raw host batch
        (``BahamasTileDataset.get_raw_batch``); ``eps`` and ``pk_eps``
        replace the ELBO's and the spectral term's drawn noise. Under a
        mesh ``batch`` and the noise are the global batch's, and each rank
        steps on its rows."""
        batch, rows = local_rows(self.mesh, batch)
        return self._step(*self._to_device(batch), lr, alpha_var, beta_KL,
                          local_noise(self.mesh, eps),
                          local_noise(self.mesh, pk_eps), rows)

    def step_indices(self, idx: np.ndarray, lr: float,
                     alpha_var: float = 1.0, beta_KL: float = 1.0,
                     eps=None, pk_eps=None) -> dict:
        """One training step by sample index, the batch assembled on the
        device from the stack cache (``device_data=True``). Under a mesh
        ``idx`` and the noise are the global batch's (device-grouped with a
        z-sharded cache: ``sample_mesh_indices``)."""
        cache = self.device_cache
        if cache is None:
            raise RuntimeError("Construct the trainer with device_data=True "
                               "to use step_indices.")
        digits = cache.digits(idx)
        rows = weights = None
        if self.mesh is not None:
            lo, hi = self.mesh.rows(len(digits))
            rows = (lo, len(digits))
            weights = cache.sample_weights(digits[lo:hi])
        raw = cache.gather(cache.local_digits(digits))
        return self._step(*raw, lr, alpha_var, beta_KL,
                          local_noise(self.mesh, eps),
                          local_noise(self.mesh, pk_eps), rows, weights)

    def step_scan(self, idx_matrix: np.ndarray, lr, alpha_var=1.0,
                  beta_KL=1.0) -> dict:
        """K steps of ``step_indices``: ``idx_matrix`` (K, B) sample
        indices; lr/alpha_var/beta_KL scalars or (K,) schedules. Returns
        the per-step metrics stacked along a leading K axis (the JAX
        package runs the same steps in one ``lax.scan``)."""
        k = len(idx_matrix)
        sched = lambda v: np.broadcast_to(np.asarray(v, np.float64), (k,))
        lrs, alphas, betas = sched(lr), sched(alpha_var), sched(beta_KL)
        steps = [self.step_indices(idx_matrix[i], float(lrs[i]),
                                   float(alphas[i]), float(betas[i]))
                 for i in range(k)]
        return {key: torch.stack([m[key] for m in steps])
                for key in steps[0]}

    @torch.no_grad()
    def eval_loss(self, batch: dict, alpha_var: float = 1.0,
                  beta_KL: float = 1.0, seed: int = 0, eps=None) -> dict:
        """The ELBO terms of a host batch with batch statistics, as in
        training, but nothing of the state changes (the JAX package's
        ``eval_loss``); the latent noise ``eps``, else from a generator
        seeded ``seed``. Under a mesh the batch is the global one, shared
        over the ranks as in ``step``."""
        batch, rows = local_rows(self.mesh, batch)
        raw_input, raw_labels, z = self._to_device(batch)
        x, y = self._prepare(raw_input, raw_labels, z)
        state = self._bn_state()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        with f32_convolutions(), self._active():
            out = self.model(x, y, z, alpha_var=alpha_var, beta_KL=beta_KL,
                             eps=local_noise(self.mesh, eps),
                             generator=gen, batch_rows=rows)
        self._restore_bn(state)
        out = {k: v for k, v in out.items() if k not in ("x_mu", "x_var")}
        if self.mesh is not None:
            self._reduce([], out)
        return out

    # ------------------------------------------------------------------ #

    @staticmethod
    def _stats_parts(metrics) -> list:
        """The tensors of one step's statistics row, flattened, on the
        device: ELBO, KL term (negated) and the likelihood terms."""
        parts = [metrics["elbo"], -metrics["kl"], metrics["log_likelihood"]]
        if "log_likelihood_fixed_var" in metrics:
            parts += [metrics["log_likelihood_fixed_var"],
                      metrics["log_likelihood_free_var"]]
        return [t.detach().float().reshape(-1) for t in parts]

    def _host_rows(self, metrics_list) -> list:
        """The statistics rows of several steps as host floats, in one
        device-to-host copy."""
        parts = [self._stats_parts(m) for m in metrics_list]
        flat = torch.cat([t for row in parts for t in row]).cpu().numpy()
        rows, pos = [], 0
        for row in parts:
            n = sum(t.numel() for t in row)
            rows.append(tuple(float(v) for v in flat[pos:pos + n]))
            pos += n
        return rows

    def stats_tuple(self, metrics) -> tuple:
        """One step's (or evaluation's) statistics row: ELBO, KL term and
        the likelihood terms, as host floats (the JAX trainer's)."""
        return self._host_rows([metrics])[0]

    def _flush_stats(self, pending, training_stats):
        """Push the buffered steps' metrics to ``training_stats`` after one
        copy to the host."""
        if not pending:
            return
        rows = self._host_rows([m for _, m, _, _ in pending])
        for (n_samples, _, lr, bs), row in zip(pending, rows):
            training_stats.push_loss(n_samples, *row, lr, bs)
        pending.clear()

    def _sample_indices(self, rng, n: int) -> np.ndarray:
        """A global batch's indices: device-grouped when the stack cache is
        z-sharded, else the dataset's own draw."""
        if self.device_cache is not None and self.device_cache.mesh is not None:
            return self.device_cache.sample_mesh_indices(rng, n)
        return self.training_data.sample_indices(rng, n)

    def train(self, validation_pepochs: Sequence[int] = (),
              on_validation: Optional[Callable] = None):
        """The training run with pepoch schedules; returns
        ``(training_stats, validation_stats)``. The JAX trainer's loop: the
        same draws from the data RNG (seeded ``config.seed``, or restored),
        the same schedule, validation, checkpoint and report points, the
        same statistics files. With the stack cache, the steps up to the
        next of those points run as one ``step_scan`` of at most
        ``stats_sync_every`` steps, rounded down to a power of two, as the
        JAX loop's scans are cut; without it, one ``step`` on a host batch
        at a time. ``on_validation(trainer, pepoch)`` is called at the
        pepochs of ``validation_pepochs``. Under a mesh every rank runs
        this loop on the same draws; rank 0 writes the files."""
        cfg = self.config
        ds = self.training_data

        # the numeric channel suffix renamed to the label field's name
        stats_labels = list(self.model.get_stats_labels())
        for j, f in enumerate(self._label_fields):
            suffix = f"_{j}"
            stats_labels = [
                l[:-len(suffix)] + f"_{f}_0" if l.endswith(suffix) else l
                for l in stats_labels]
        stats_labels += ["lr", "batch_size"]

        out_path = cfg.output_path
        train_fn = val_fn = ckpt_template = None
        if out_path is not None:
            if self.is_writer:
                os.makedirs(out_path, exist_ok=True)
            train_fn = os.path.join(out_path, "training_stats.txt")
            val_fn = os.path.join(out_path, "validation_stats.txt")
            ckpt_template = os.path.join(
                out_path, "checkpoint_sample{sample:0>10}")

        # resume: restore() stashed the loop's progress and the data RNG;
        # the schedules fast-forward and the stats files are re-loaded
        progress = dict(self._progress or {})
        resuming = bool(progress)
        n_samples = progress.get("n_samples", 0)
        i_pepoch = progress.get("i_pepoch", 0)
        last_pepoch_samples = progress.get("last_pepoch_samples", 0)
        last_val_loss = progress.get("last_val_loss", 0)
        last_ckpt = progress.get("last_ckpt", 0)
        last_report = progress.get("last_report", 0)
        data_rng = (self._data_rng if resuming and self._data_rng is not None
                    else np.random.default_rng(cfg.seed))

        up_to = n_samples if resuming else None
        training_stats, validation_stats = run_stats(
            self, stats_labels, train_fn, val_fn, resuming, up_to)

        batch_size = (cfg.adaptive_batch_size(i_pepoch)
                      if cfg.adaptive_batch_size else cfg.batch_size)
        lr_mult = (cfg.adaptive_learning_rate(i_pepoch)
                   if cfg.adaptive_learning_rate else 1.0)
        alpha_var = cfg.var_anneal_fn(i_pepoch) if cfg.var_anneal_fn else 1.0
        beta_KL = cfg.KL_anneal_fn(i_pepoch) if cfg.KL_anneal_fn else 1.0

        if not resuming and 0 in validation_pepochs and on_validation:
            on_validation(self, 0)

        t0 = time.time()
        pending = []

        def snapshot_progress():
            self._progress = {"n_samples": n_samples, "i_pepoch": i_pepoch,
                              "last_pepoch_samples": last_pepoch_samples,
                              "last_val_loss": last_val_loss,
                              "last_ckpt": last_ckpt,
                              "last_report": last_report}
            self._data_rng = data_rng

        while i_pepoch < cfg.n_pepoch:
            # ---- pepoch boundary -------------------------------------- #
            if n_samples - cfg.pepoch_size >= last_pepoch_samples and n_samples:
                i_pepoch += 1
                last_pepoch_samples = n_samples
                if i_pepoch >= cfg.n_pepoch:
                    break
                if cfg.adaptive_learning_rate:
                    sched = cfg.adaptive_learning_rate
                    if hasattr(sched, "observe"):
                        # the reactive schedule sees the training ELBO's
                        # moving average
                        self._flush_stats(pending, training_stats)
                        mavg = training_stats.loss_terms["ELBO"]["mavg"]
                        lr_mult = (sched.observe(mavg[-1]) if mavg
                                   else sched())
                    else:
                        lr_mult = sched(i_pepoch)
                if cfg.var_anneal_fn:
                    alpha_var = cfg.var_anneal_fn(i_pepoch)
                if cfg.KL_anneal_fn:
                    beta_KL = cfg.KL_anneal_fn(i_pepoch)
                if cfg.adaptive_batch_size:
                    batch_size = cfg.adaptive_batch_size(i_pepoch)
                if i_pepoch in validation_pepochs and on_validation:
                    on_validation(self, i_pepoch)

            lr = cfg.learning_rate * lr_mult
            if self.device_cache is not None:
                # the steps up to the next pepoch / validation / checkpoint
                # / report point, as one step_scan
                horizons = [last_pepoch_samples + cfg.pepoch_size]
                if (self.test_data is not None
                        and cfg.validation_loss_frequency > 0):
                    horizons.append(last_val_loss
                                    + cfg.validation_loss_frequency)
                if ckpt_template is not None:
                    horizons.append(last_ckpt + cfg.checkpoint_frequency)
                if cfg.statistics_report_frequency > 0:
                    horizons.append(last_report
                                    + cfg.statistics_report_frequency)
                until = max(min(horizons) - n_samples, 1)
                k = min(max(1, cfg.stats_sync_every),
                        -(-until // batch_size))
                k = 1 << (k.bit_length() - 1)
                idx_matrix = np.stack(
                    [self._sample_indices(data_rng, batch_size)
                     for _ in range(k)])
                metrics_k = self.step_scan(idx_matrix, lr=lr,
                                           alpha_var=alpha_var,
                                           beta_KL=beta_KL)
                for i in range(k):
                    n_samples += batch_size
                    pending.append(
                        (n_samples, {key: v[i] for key, v in
                                     metrics_k.items()}, lr, batch_size))
            else:
                idx = ds.sample_indices(data_rng, batch_size)
                metrics = self.step(ds.get_raw_batch(idx), lr=lr,
                                    alpha_var=alpha_var, beta_KL=beta_KL)
                n_samples += batch_size
                pending.append((n_samples, metrics, lr, batch_size))

            # metrics stay on the device until stats_sync_every steps wait
            if len(pending) >= max(1, cfg.stats_sync_every):
                self._flush_stats(pending, training_stats)

            if (self.test_data is not None
                    and cfg.validation_loss_frequency > 0
                    and n_samples - cfg.validation_loss_frequency
                    >= last_val_loss):
                self._flush_stats(pending, training_stats)
                last_val_loss = n_samples
                vidx = self.test_data.sample_indices(
                    data_rng, cfg.validation_loss_batch_size)
                vmetrics = self.eval_loss(self.test_data.get_raw_batch(vidx),
                                          alpha_var, beta_KL)
                validation_stats.push_loss(
                    n_samples, *self.stats_tuple(vmetrics),
                    cfg.learning_rate * lr_mult, batch_size)

            if (ckpt_template is not None
                    and n_samples - cfg.checkpoint_frequency >= last_ckpt):
                last_ckpt = n_samples
                # the stats files first, consistent with the checkpoint
                self._flush_stats(pending, training_stats)
                training_stats.flush_to_file()
                validation_stats.flush_to_file()
                snapshot_progress()
                self.save(ckpt_template.format(sample=n_samples))
                if self.is_writer:
                    ckpt.rotate_checkpoints(out_path,
                                            cfg.keep_last_checkpoints)

            if (cfg.statistics_report_frequency > 0
                    and n_samples - cfg.statistics_report_frequency
                    >= last_report):
                last_report = n_samples
                self._flush_stats(pending, training_stats)
                if cfg.verbose and self.is_writer:
                    elbo = training_stats.loss_terms["ELBO"]["mavg"][-1]
                    rate = n_samples / (time.time() - t0)
                    print(f"P-Epoch [{i_pepoch}/{cfg.n_pepoch}] "
                          f"samples {n_samples} ELBO(mavg) {elbo:.3e} "
                          f"({rate:.1f} samples/s)")

        self._flush_stats(pending, training_stats)
        training_stats.flush_to_file()
        validation_stats.flush_to_file()
        snapshot_progress()
        if out_path is not None:
            self.save(os.path.join(out_path, "model"))
        return training_stats, validation_stats

    @torch.no_grad()
    def validation_sample(self, validation_batch_size: int = 8,
                          validation_redshift: Optional[float] = None,
                          return_var: bool = False, seed: int = 0,
                          eps=None) -> dict:
        """``validate``'s painted test batch: ``validation_batch_size``
        samples of the test data (of redshift ``validation_redshift`` if
        given) drawn from a generator seeded ``seed``, painted by the
        eval-mode ``sample_P`` (through K3-fwd with ``fused_heads``) with
        the latent noise ``eps``, else drawn from a generator seeded
        ``seed``. Returns the truth ``x``, the input ``y``, ``pred`` and
        with ``return_var`` the predicted variance ``var`` (N, C, H, W), f32
        on the trainer's device, and the redshifts ``z`` (numpy)."""
        batch = draw_test_batch(self.test_data, validation_batch_size,
                                validation_redshift, seed)
        raw_input, raw_labels, z = self._to_device(batch)
        x, y = self._prepare(raw_input, raw_labels, z)
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        was_training = self.model.training
        self.model.eval()
        try:
            with f32_convolutions():
                pred = self.model.sample_P(y, z, eps=eps, generator=gen,
                                           return_var=return_var)
        finally:
            self.model.train(was_training)
        var = None
        if return_var and isinstance(pred, tuple):
            pred, var = pred
        return {"x": x, "y": y, "pred": pred.float(),
                "var": None if var is None else var.float(),
                "z": batch["z"]}

    def validate(self, validation_batch_size: int = 8,
                 validation_redshift: Optional[float] = None,
                 compute_loss: bool = False,
                 plot_sample_var: bool = False,
                 plot_power_spectra: Sequence[str] = ("auto",),
                 plot_histogram: Sequence[str] = ("log",),
                 save_plots: bool = False,
                 filename_template: str = "{plot_type}.png",
                 seed: int = 0, eps=None):
        """Diagnostics on a test batch (painter.py:295-367), the JAX
        trainer's. With ``compute_loss=True`` the statistics row of
        ``stats_tuple`` for ``validation_batch_size`` samples of the test
        data (of redshift ``validation_redshift`` if given), drawn from a
        generator seeded ``seed``. Otherwise the batch painted with the
        prior (``validation_sample``; noise ``eps`` or seeded ``seed``) and
        the sample / P(k) / histogram figures, returned as a dict (saved
        when ``save_plots``, as ``filename_template.format(plot_type=...)``;
        the spectra on the trainer's device). The figures need matplotlib:
        without it this raises an ImportError before any work."""
        if compute_loss:
            batch = draw_test_batch(self.test_data,
                                    validation_batch_size,
                                    validation_redshift, seed)
            return self.stats_tuple(self.eval_loss(batch, seed=seed))
        from baryon_painter_tpu_torch.utils import validation_plotting as vp
        vp.require_matplotlib()
        s = self.validation_sample(validation_batch_size, validation_redshift,
                                   return_var=plot_sample_var, seed=seed,
                                   eps=eps)
        figs = vp.validation_figures(
            s["x"], s["pred"], s["y"], self.test_data, s["z"],
            pred_var=s["var"], spectra=plot_power_spectra,
            histograms=plot_histogram, device=self.device)
        if save_plots:
            vp.save_figures(figs, filename_template)
        return figs

    # ------------------------------------------------------------------ #

    def state_tree(self, include_opt_state: bool = True) -> dict:
        """The trainer's state as the JAX trainer's checkpoint tree
        (numpy, the JAX layout): params, batch_stats, step, opt_state and
        what the loop needs to resume (progress, data_rng, lr_sched)."""
        opt = self.optimizer
        state = train_state_to_jax(self.model, opt.mu, opt.nu, opt.count,
                                   self._host_step)
        if not include_opt_state:
            del state["opt_state"]
        if self._progress is not None:
            state["progress"] = np.array(
                [self._progress[k] for k in _PROGRESS_KEYS], dtype=np.int64)
        if self._data_rng is not None:
            state["data_rng"] = _encode_data_rng(self._data_rng)
        sched = self.config.adaptive_learning_rate
        if hasattr(sched, "state_array"):
            # a reactive schedule's state survives a resume mid-plateau
            state["lr_sched"] = np.asarray(sched.state_array(), np.float64)
        return state

    def save(self, base_path: str, include_opt_state: bool = True) -> int:
        """Write the checkpoint pair at ``base_path``; returns the state's
        bytes. Under a mesh rank 0 writes (the state is the same on every
        rank; the others return 0) and every rank waits for the write."""
        nbytes = 0
        if self.is_writer:
            meta = ckpt.meta_from_dataset(self.training_data,
                                          self.model.architecture)
            if self.run_config is not None:
                meta["run_config"] = self.run_config.to_dict()
            nbytes = ckpt.save_checkpoint(
                base_path, self.state_tree(include_opt_state), meta)
        if self.mesh is not None:
            self.mesh.barrier()
        return nbytes

    @torch.no_grad()
    def restore(self, base_path: str) -> dict:
        """Load a checkpoint written by this trainer or the JAX one: the
        parameters, running statistics, Adam state and step exactly, and
        the loop's progress, data RNG and reactive schedule state for
        ``train`` to resume from. Returns the meta."""
        raw, meta = ckpt.load_checkpoint(base_path, keep_optimizer=True)
        loaded = train_state_from_jax(self.model, raw)
        if "mu" in loaded:
            for dst, src in zip(self.optimizer.mu, loaded["mu"]):
                dst.copy_(src)
            for dst, src in zip(self.optimizer.nu, loaded["nu"]):
                dst.copy_(src)
            self.optimizer.count = loaded["count"]
        self._host_step = loaded["step"]
        if "progress" in raw:
            vals = np.asarray(raw["progress"], dtype=np.int64)
            self._progress = {k: int(v)
                              for k, v in zip(_PROGRESS_KEYS, vals)}
        if "data_rng" in raw:
            self._data_rng = _decode_data_rng(raw["data_rng"])
        if "lr_sched" in raw and hasattr(self.config.adaptive_learning_rate,
                                         "load_state_array"):
            self.config.adaptive_learning_rate.load_state_array(
                np.asarray(raw["lr_sched"], np.float64))
        return meta
