"""Pepoch-driven training schedules.

The reference drives training in 'pseudo-epochs' (pepoch = fixed number of
samples, painter.py:74-77) with callables mapping pepoch -> lr multiplier /
batch size (scripts/CVAE_single_scale.py:151-172). Same here, as plain
functions; the trainer injects the lr through optax so changing it does NOT
trigger a recompile.

A copy of ``baryon_painter_tpu/train/schedules.py`` (pure Python and
numpy): the port imports nothing of the JAX package, whose ``__init__``
imports jax.
"""
from __future__ import annotations

import math

__all__ = ["fiducial_adaptive_batch_size", "fiducial_adaptive_lr",
           "step_lr", "linear_anneal", "ReduceLROnPlateau"]


def fiducial_adaptive_batch_size(pepoch: int, min_batch_size: int = 1,
                                 max_batch_size: int = 24) -> int:
    """Batch ramp 4 -> 8 -> 16 -> 24 at pepochs 0/8/16/32
    (CVAE_single_scale.py:151-158)."""
    steps = [(0, 4), (8, 8), (16, 16), (32, 24)]
    for start, size in reversed(steps):
        if pepoch >= start:
            return min(size, max_batch_size)
    return min_batch_size


def fiducial_adaptive_lr(pepoch: int, step: int = 32, min_pepoch: int = 32,
                         gamma: float = 0.5, min_gamma: float = 1e-6) -> float:
    """LR multiplier: 1 until min_pepoch, then gamma^((pepoch-min_pepoch)//step)
    floored at min_gamma (CVAE_single_scale.py:160-172, 'slow' variant)."""
    if pepoch < min_pepoch:
        return 1.0
    return max(min_gamma, gamma ** ((pepoch - min_pepoch) // step))


def step_lr(step_size: int, gamma: float):
    """StepLR-equivalent multiplier (painter.py:97-100)."""
    def fn(pepoch: int) -> float:
        return gamma ** (pepoch // step_size)
    return fn


class ReduceLROnPlateau:
    """Metric-reactive lr multiplier — the reference's
    ``adaptive_learning_rate="avoid_plateau"`` (painter.py:101-110:
    torch ReduceLROnPlateau(mode="max", factor=0.1, patience=10,
    threshold=1e-4, threshold_mode="rel", cooldown=0, min_lr=0), stepped
    once per pepoch with the current ELBO, painter.py:186-190).

    Usable anywhere a pepoch -> multiplier schedule is accepted: calling
    the object returns the *current* multiplier (reactive schedules have
    no closed form in the pepoch). The trainer detects the ``observe``
    method and feeds it the latest training-ELBO moving average at every
    pepoch boundary (the reference samples a single batch's ELBO there —
    a noisy lottery; the mavg is the same signal de-noised).

    Improvement tests replicate torch's `is_better` exactly (mode max /
    min x threshold_mode rel / abs); a plateau of ``patience`` pepochs
    multiplies by ``factor`` (floored at ``min_mult``) and starts a
    ``cooldown``. State is 4 floats (best, bad count, cooldown count,
    multiplier) exposed via state_array()/load_state_array() so trainer
    checkpoints can resume the schedule mid-plateau.
    """

    def __init__(self, mode: str = "max", factor: float = 0.1,
                 patience: int = 10, threshold: float = 1e-4,
                 threshold_mode: str = "rel", cooldown: int = 0,
                 min_mult: float = 0.0):
        if mode not in ("min", "max"):
            raise ValueError(f"mode {mode!r} not in ('min', 'max')")
        if threshold_mode not in ("rel", "abs"):
            raise ValueError(
                f"threshold_mode {threshold_mode!r} not in ('rel', 'abs')")
        if not 0.0 < factor < 1.0:
            raise ValueError("factor must be in (0, 1)")
        self.mode, self.factor = mode, factor
        self.patience, self.threshold = patience, threshold
        self.threshold_mode, self.cooldown = threshold_mode, cooldown
        self.min_mult = min_mult
        self.best = -math.inf if mode == "max" else math.inf
        self.num_bad = 0
        self.cooldown_counter = 0
        self.multiplier = 1.0

    def _is_better(self, a: float) -> bool:
        t, best = self.threshold, self.best
        if self.mode == "max":
            return a > (best * (1.0 + t) if self.threshold_mode == "rel"
                        else best + t)
        return a < (best * (1.0 - t) if self.threshold_mode == "rel"
                    else best - t)

    def observe(self, metric: float) -> float:
        """Record one pepoch's metric; returns the (maybe reduced)
        multiplier."""
        metric = float(metric)
        if self._is_better(metric):
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
        if self.cooldown_counter > 0:
            # torch ticks the cooldown on EVERY epoch (improving ones too)
            # and masks bad counts while it runs
            self.cooldown_counter -= 1
            self.num_bad = 0
        if self.num_bad > self.patience:
            self.multiplier = max(self.min_mult,
                                  self.multiplier * self.factor)
            self.cooldown_counter = self.cooldown
            self.num_bad = 0
        return self.multiplier

    def __call__(self, pepoch: int = 0) -> float:
        return self.multiplier

    # -- checkpoint resume ------------------------------------------------ #

    def state_array(self):
        return [self.best, float(self.num_bad),
                float(self.cooldown_counter), self.multiplier]

    def load_state_array(self, vals):
        self.best = float(vals[0])
        self.num_bad = int(vals[1])
        self.cooldown_counter = int(vals[2])
        self.multiplier = float(vals[3])


def linear_anneal(start_pepoch: int, end_pepoch: int,
                  start_value: float = 0.0, end_value: float = 1.0):
    """Linear ramp for alpha_var / beta_KL annealing (painter.py:192-195)."""
    def fn(pepoch: int) -> float:
        if pepoch <= start_pepoch:
            return start_value
        if pepoch >= end_pepoch:
            return end_value
        w = (pepoch - start_pepoch) / (end_pepoch - start_pepoch)
        return start_value + w * (end_value - start_value)
    return fn
