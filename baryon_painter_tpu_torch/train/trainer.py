"""CVAE training step, in PyTorch.

Port of the step of ``baryon_painter_tpu/train/trainer.py``: raw tiles ->
transforms on the device -> CVAE forward -> ELBO -> gradients -> global-norm
clip -> Adam, with the learning rate, alpha_var and beta_KL given per step.
The batch comes from the host (``step``) or is assembled on the device from
the stack cache (``step_indices``, ``step_scan``; ``device_data=True``), the
tile gather through K2. With ``CVAE(..., fused_heads=True)`` the output heads
run through K3, forward and backward; with ``CVAE(...,
fused_train_conv=True)`` the gated train-mode conv + batch norm + ReLU
triples run through K4, in f32 or bf16. The step computes in the model's
dtype (``CVAE(..., dtype=torch.bfloat16)`` is the JAX package's bf16
training): the batch is prepared in f32 and the parameters, their
gradients, the Adam state and the batch statistics stay f32, as in the JAX
trainer. An f32
step trains in f32 whatever the caller's TF32 setting
(``utils/platform.f32_convolutions``).

    trainer = CVAETrainer(CVAE(arch, fused_heads=True), dataset,
                          config=TrainConfig(seed=0), device_data=True)
    metrics = trainer.step_indices(dataset.sample_indices(rng, 24), lr=1e-4)

Adam is the JAX package's ``optax.chain(scale_by_adam(b1, b2), scale(-1))``
with the learning rate multiplied outside, written out here (``Adam``). The
latent noise comes from the trainer's ``torch.Generator`` (seeded with
``config.seed``), or from ``eps=`` where a test injects it.

Not ported yet: the ``train()`` loop with its schedules and statistics
files, validation, checkpoint writing and resume, the spectral loss
(``pk_loss_weight``) and the mesh (multi-device) mode.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from baryon_painter_tpu_torch.convert import init_cvae, load_jax_variables
from baryon_painter_tpu_torch.data.dataset import BahamasTileDataset
from baryon_painter_tpu_torch.data.device_cache import DeviceStackCache
from baryon_painter_tpu_torch.models.cvae import CVAE
from baryon_painter_tpu_torch.models.layers import BatchNorm
from baryon_painter_tpu_torch.transforms import FieldStats
from baryon_painter_tpu_torch.utils.platform import (f32_convolutions,
                                                     resolve_device)

__all__ = ["TrainConfig", "CVAETrainer", "Adam", "grad_norm",
           "clip_grads_by_global_norm"]


@dataclasses.dataclass
class TrainConfig:
    """The fields of the JAX package's ``TrainConfig`` that the step reads.

    ``freeze_bn_stats`` keeps the batch-norm running statistics at their
    values (fine-tunes: the painted field goes through them);
    ``clip_grad_norm`` > 0 clips the gradients to that global norm."""

    seed: int = 0
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    device_cache_budget_bytes: int = 8 * 1024 ** 3
    pk_loss_weight: float = 0.0
    freeze_bn_stats: bool = False
    clip_grad_norm: float = 0.0


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
                 config: TrainConfig = TrainConfig(),
                 device_data: bool = False, device=None,
                 use_kernel="auto", variables: Optional[dict] = None):
        """Set up training of ``model`` on ``device`` (``cuda`` unless the
        caller passes ``device="cpu"``).

        The weights are drawn by ``convert.init_cvae`` from
        ``config.seed``, or loaded from ``variables`` (JAX-layout
        ``{"params", "batch_stats"}`` as numpy, e.g. the JAX trainer's
        initial state). ``device_data=True`` uploads the stacks to the
        device once (``DeviceStackCache``, the gather through K2 unless
        ``use_kernel=False``) for ``step_indices``/``step_scan``."""
        if config.pk_loss_weight > 0:
            raise NotImplementedError(
                "pk_loss_weight > 0: the spectral loss is not ported yet "
                "(ROADMAP.md, section 1: the spectral loss).")
        self.device = resolve_device(device)
        self.config = config
        self.training_data = training_data
        if variables is not None:
            load_jax_variables(model, variables)
        else:
            init_cvae(model, config.seed)
        self.model = model.to(self.device).train()
        self.params = [p for p in self.model.parameters() if p.requires_grad]
        self.optimizer = Adam(self.params, config.adam_b1, config.adam_b2)
        self._bn = [m for m in self.model.modules()
                    if isinstance(m, BatchNorm)]
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(config.seed)
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
                use_kernel=use_kernel)

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

    def _step(self, raw_input, raw_labels, z, lr, alpha_var, beta_KL, eps):
        with f32_convolutions():
            return self._step_f(raw_input, raw_labels, z, lr, alpha_var,
                                beta_KL, eps)

    def _step_f(self, raw_input, raw_labels, z, lr, alpha_var, beta_KL,
                eps):
        x, y = self._prepare(raw_input, raw_labels, z)
        frozen = self._bn_state() if self.config.freeze_bn_stats else None
        for p in self.params:
            p.grad = None
        out = self.model(x, y, z, alpha_var=alpha_var, beta_KL=beta_KL,
                         eps=eps, generator=self.generator)
        (-out["elbo"]).backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        norm = grad_norm(grads)
        if self.config.clip_grad_norm > 0:
            clip_grads_by_global_norm(grads, self.config.clip_grad_norm)
        with torch.no_grad():
            for p, d in zip(self.params, self.optimizer.update(grads)):
                p.add_(lr * d)
        if frozen is not None:
            self._restore_bn(frozen)
        metrics = {k: v.detach() for k, v in out.items()
                   if k not in ("x_mu", "x_var")}
        metrics["grad_norm"] = norm.detach()
        return metrics

    def _to_device(self, batch):
        as_t = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                         device=self.device)
        return as_t(batch["input"]), as_t(batch["labels"]), as_t(batch["z"])

    def step(self, batch: dict, lr: float, alpha_var: float = 1.0,
             beta_KL: float = 1.0, eps=None) -> dict:
        """One training step on a raw host batch
        (``BahamasTileDataset.get_raw_batch``)."""
        return self._step(*self._to_device(batch), lr, alpha_var, beta_KL,
                          eps)

    def step_indices(self, idx: np.ndarray, lr: float,
                     alpha_var: float = 1.0, beta_KL: float = 1.0,
                     eps=None) -> dict:
        """One training step by sample index, the batch assembled on the
        device from the stack cache (``device_data=True``)."""
        if self.device_cache is None:
            raise RuntimeError("Construct the trainer with device_data=True "
                               "to use step_indices.")
        raw = self.device_cache.gather(self.device_cache.digits(idx))
        return self._step(*raw, lr, alpha_var, beta_KL, eps)

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
                  beta_KL: float = 1.0, seed: int = 0) -> dict:
        """The ELBO terms of a host batch with batch statistics, as in
        training, but nothing of the state changes (the JAX package's
        ``eval_loss``); the latent noise from a generator seeded ``seed``."""
        raw_input, raw_labels, z = self._to_device(batch)
        x, y = self._prepare(raw_input, raw_labels, z)
        state = self._bn_state()
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        with f32_convolutions():
            out = self.model(x, y, z, alpha_var=alpha_var, beta_KL=beta_KL,
                             generator=gen)
        self._restore_bn(state)
        return {k: v for k, v in out.items() if k not in ("x_mu", "x_var")}
