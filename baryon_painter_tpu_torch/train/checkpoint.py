"""Checkpoints: the (``<base>_state.msgpack``, ``<base>_meta.json``) pair the
JAX package reads and writes (``baryon_painter_tpu/train/checkpoint.py``).

  * ``<base>_state.msgpack``: the state tree (params, batch_stats, step and,
    from a trainer, the optimizer state, loop progress, data-RNG state and
    the reactive schedule's state) in flax's msgpack format, read and
    written by this package's own codec (``train/msgpack_reader.py``,
    ``train/msgpack_writer.py``), so neither ``msgpack`` nor ``flax`` is
    needed;
  * ``<base>_meta.json``: the dataset geometry, the architecture dict and
    each field's transform spec and statistics tables.

A checkpoint the port writes is one the JAX package reads, and the other
way round.
"""
from __future__ import annotations

import json
import os

import numpy as np

from baryon_painter_tpu_torch.train.msgpack_reader import msgpack_restore
from baryon_painter_tpu_torch.train.msgpack_writer import msgpack_serialize
from baryon_painter_tpu_torch.transforms import FieldStats, transform_from_dict

__all__ = ["save_checkpoint", "load_checkpoint", "meta_from_dataset",
           "rotate_checkpoints", "transforms_from_meta"]

# optimizer-state trees of the CVAE and CGAN trainers
_OPTIMIZER_KEYS = ("opt_state", "g_opt", "d_opt")


def _jsonify(obj):
    if isinstance(obj, dict):
        return {k: _jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonify(v) for v in obj]
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if isinstance(obj, np.ndarray):
        return obj.tolist()
    return obj


def meta_from_dataset(dataset, architecture: dict,
                      model_kind: str = "cvae") -> dict:
    """Checkpoint metadata of a dataset and an architecture, key for key the
    JAX package's."""
    return {
        "model_kind": model_kind,
        "L": dataset.L,
        "n_grid": dataset.n_grid,
        "tile_L": dataset.tile_L,
        "n_tile": dataset.n_tile,
        "tile_size": dataset.tile_size,
        "input_field": dataset.input_field,
        "label_fields": list(dataset.label_fields),
        "scale_to_SLICS": dataset.scale_to_SLICS,
        "transforms": {f: dataset.transforms[f].to_dict()
                       for f in dataset.fields},
        "stats": {f: dataset.stats[f].to_dict() for f in dataset.fields},
        "model_architecture": _jsonify(architecture),
    }


def save_checkpoint(base_path: str, state: dict, meta: dict) -> int:
    """Write the (state, meta) pair; ``state`` is nested dicts of numpy
    arrays (the JAX layout, ``convert.py``). Returns the state's bytes."""
    os.makedirs(os.path.dirname(os.path.abspath(base_path)), exist_ok=True)
    blob = msgpack_serialize(state)
    with open(base_path + "_state.msgpack", "wb") as f:
        f.write(blob)
    with open(base_path + "_meta.json", "w") as f:
        json.dump(_jsonify(meta), f, indent=1)
    return len(blob)


def rotate_checkpoints(directory: str, keep: int,
                       prefix: str = "checkpoint_sample") -> list:
    """Delete all but the ``keep`` newest periodic checkpoints in
    ``directory`` (the zero-padded sample count in their names sorts them);
    returns the deleted base names. ``keep <= 0`` keeps everything."""
    if keep <= 0:
        return []
    bases = sorted(
        f[:-len("_state.msgpack")] for f in os.listdir(directory)
        if f.startswith(prefix) and f.endswith("_state.msgpack"))
    deleted = []
    for base in bases[:-keep] if len(bases) > keep else []:
        for suffix in ("_state.msgpack", "_meta.json"):
            path = os.path.join(directory, base + suffix)
            if os.path.exists(path):
                os.remove(path)
        deleted.append(base)
    return deleted


def load_checkpoint(base_path: str, keep_optimizer: bool = False) -> tuple:
    """Load ``(state, meta)``: ``state`` is nested dicts of numpy arrays
    (``params``, ``batch_stats``, ``step``, a trainer's ``progress``,
    ``data_rng`` and ``lr_sched`` and, for the CGAN, the ``g_``/``d_``
    trees). The optimizer states are dropped unless ``keep_optimizer``
    (``CVAETrainer.restore`` keeps them; the painters do not)."""
    with open(base_path + "_state.msgpack", "rb") as f:
        state = msgpack_restore(f.read())
    if not keep_optimizer:
        for key in _OPTIMIZER_KEYS:
            state.pop(key, None)
    with open(base_path + "_meta.json") as f:
        meta = json.load(f)
    return state, meta


def transforms_from_meta(meta: dict, device=None):
    """Rebuild ``{field: transform}`` and ``{field: FieldStats}`` from
    metadata; the statistics tables go to ``device``."""
    transforms = {f: transform_from_dict(d)
                  for f, d in meta["transforms"].items()}
    stats = {f: FieldStats.from_dict(d, device=device)
             for f, d in meta["stats"].items()}
    return transforms, stats
