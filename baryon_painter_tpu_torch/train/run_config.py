"""Single declarative run configuration.

The reference spreads configuration over three mechanisms - the architecture
dict DSL, argparse flags, and Python callables for schedules hardcoded in
scripts (scripts/CVAE_single_scale.py:151-172, painter.py:60-110). Here ONE
JSON-able object covers architecture + transforms + schedules + trainer
scalars; schedules are declarative specs resolved to callables at build
time, so a run is fully reproducible from its config file (and from the
copy stored inside every checkpoint's meta).

A copy of ``baryon_painter_tpu/train/run_config.py`` (pure Python): a config
file of either package builds the same run in the other. The schedules
resolve through the port's ``train/schedules.py``; ``build_model`` and
``build_train_config`` build the port's ``CVAE`` and ``TrainConfig``.

Schedule spec grammar ({"kind": ..., **params}):
    constant        {value}
    fiducial_batch  {min_batch_size?, max_batch_size?}
    fiducial_lr     {step?, min_pepoch?, gamma?, min_gamma?}
    step            {step_size, gamma}              (painter.py:97-100)
    linear_anneal   {start_pepoch, end_pepoch, start_value?, end_value?}
    piecewise       {boundaries: [...], values: [...]}  (len(values) =
                    len(boundaries)+1; value i applies before boundaries[i])
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, Optional

from baryon_painter_tpu_torch.train import schedules as _sched

__all__ = ["RunConfig", "schedule_from_spec"]


def schedule_from_spec(spec) -> Optional[Callable]:
    """Resolve a declarative schedule spec to a pepoch -> value callable."""
    if spec is None:
        return None
    if callable(spec):  # permit pre-built callables for interactive use
        return spec
    kind = spec["kind"]
    kw = {k: v for k, v in spec.items() if k != "kind"}
    if kind == "constant":
        return lambda pepoch, v=kw["value"]: v
    if kind == "fiducial_batch":
        return lambda pepoch: _sched.fiducial_adaptive_batch_size(pepoch, **kw)
    if kind == "fiducial_lr":
        return lambda pepoch: _sched.fiducial_adaptive_lr(pepoch, **kw)
    if kind == "step":
        return _sched.step_lr(kw["step_size"], kw["gamma"])
    if kind == "linear_anneal":
        return _sched.linear_anneal(**kw)
    if kind == "avoid_plateau":
        # the reference's validation-reactive mode (painter.py:101-110);
        # stateful — the trainer feeds it the ELBO at pepoch boundaries and
        # checkpoints its 4-float state (trainer.save/restore "lr_sched")
        return _sched.ReduceLROnPlateau(**kw)
    if kind == "piecewise":
        bounds, values = list(kw["boundaries"]), list(kw["values"])
        if len(values) != len(bounds) + 1:
            raise ValueError("piecewise needs len(values) == len(boundaries)+1")

        def fn(pepoch):
            for b, v in zip(bounds, values):
                if pepoch < b:
                    return v
            return values[-1]
        return fn
    raise ValueError(f"Unknown schedule kind '{kind}'.")


_SCHEDULE_FIELDS = {"adaptive_batch_size": "batch_size_schedule",
                    "adaptive_learning_rate": "lr_schedule",
                    "var_anneal_fn": "var_anneal",
                    "KL_anneal_fn": "KL_anneal"}


@dataclasses.dataclass
class RunConfig:
    """architecture + transforms + data geometry + schedules + train scalars.

    ``transforms`` is {field: transform-spec-dict} (transforms.to_dict
    format); ``schedules`` holds the declarative specs named by
    _SCHEDULE_FIELDS values; ``train`` holds TrainConfig scalar fields.
    """

    architecture: Dict[str, Any]
    transforms: Dict[str, dict]
    schedules: Dict[str, Any] = dataclasses.field(default_factory=dict)
    train: Dict[str, Any] = dataclasses.field(default_factory=dict)
    data: Dict[str, Any] = dataclasses.field(default_factory=dict)

    # ---------------- serialization ---------------- #

    def to_dict(self) -> dict:
        from baryon_painter_tpu_torch.train.checkpoint import _jsonify
        return _jsonify(dataclasses.asdict(self))

    @classmethod
    def from_dict(cls, d: dict) -> "RunConfig":
        return cls(**{f.name: d.get(f.name, {})
                      for f in dataclasses.fields(cls)})

    def save(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=1)

    @classmethod
    def load(cls, path: str) -> "RunConfig":
        with open(path) as f:
            return cls.from_dict(json.load(f))

    # ---------------- builders ---------------- #

    def build_transforms(self):
        from baryon_painter_tpu_torch.transforms import transform_from_dict
        return {f: transform_from_dict(d) for f, d in self.transforms.items()}

    def build_model(self, dtype=None, **kwargs):
        """The port's ``CVAE``; ``kwargs`` (``fused_heads``,
        ``fused_train_conv``) go to it."""
        from baryon_painter_tpu_torch.models.cvae import CVAE
        return CVAE(self.architecture, dtype=dtype, **kwargs)

    def build_train_config(self, **overrides):
        from baryon_painter_tpu_torch.train.trainer import TrainConfig
        kw = dict(self.train)
        for cfg_field, spec_name in _SCHEDULE_FIELDS.items():
            if spec_name in self.schedules:
                kw[cfg_field] = schedule_from_spec(self.schedules[spec_name])
        kw.update(overrides)
        return TrainConfig(**kw)
