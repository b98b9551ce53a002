"""Checkpoint reading: the (``<base>_state.msgpack``, ``<base>_meta.json``)
pair the JAX package writes (``baryon_painter_tpu/train/checkpoint.py``).

Read side only. The state is decoded by this package's own msgpack reader
(``train/msgpack_reader.py``), so neither ``msgpack`` nor ``flax`` is needed.
"""
from __future__ import annotations

import json

from baryon_painter_tpu_torch.train.msgpack_reader import msgpack_restore
from baryon_painter_tpu_torch.transforms import FieldStats, transform_from_dict

__all__ = ["load_checkpoint", "transforms_from_meta"]

# optimizer-state trees of the CVAE and CGAN trainers
_OPTIMIZER_KEYS = ("opt_state", "g_opt", "d_opt")


def load_checkpoint(base_path: str) -> tuple:
    """Load ``(state, meta)``: ``state`` is nested dicts of numpy arrays
    (``params``, ``batch_stats``, ``step`` and, for the CGAN, the ``g_``/``d_``
    trees); the optimizer states are dropped, since nothing here trains."""
    with open(base_path + "_state.msgpack", "rb") as f:
        state = msgpack_restore(f.read())
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
