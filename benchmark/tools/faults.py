"""Faults planted in the program under test, for the tests that see the
benchmark's comparison refuse them and for the readings of the faults on
the card (``readings.py --fault``). Each is a context manager that patches
one method of the port while it is active.

Painting: ``half_batch`` paints the first half of a call's tiles and
returns them twice (the second half left out); ``answer`` gives every
call's first tile the second tile's painting where the painter produces
it.

Training: ``frozen`` leaves the parameters as they were (every step's
update is zero); ``half_batch`` steps on the first half of each batch
alone, the loss a mean over it; ``answer`` reports every step's loss 1e-3
off where the step produces it.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["PAINT_FAULTS", "TRAIN_FAULTS", "planted"]

PAINT_FAULTS = ("half_batch", "answer")
TRAIN_FAULTS = ("frozen", "half_batch", "answer")


@contextlib.contextmanager
def _patched(owner, name, make):
    original = getattr(owner, name)
    setattr(owner, name, make(original))
    try:
        yield
    finally:
        setattr(owner, name, original)


def _paint_half(original):
    def paint_batch(self, tiles, zs, *args, **kw):
        h = len(tiles) // 2
        if kw.get("eps") is not None:
            kw["eps"] = kw["eps"][:h]
        out = original(self, tiles[:h], zs[:h], *args, **kw)
        return torch.cat([out, out])
    return paint_batch


def _paint_answer(original):
    def paint_batch(self, *args, **kw):
        out = original(self, *args, **kw)
        return torch.cat([out[1:2], out[1:]])
    return paint_batch


def _train_half(original):
    def step_indices(self, idx, lr, *args, eps=None, **kw):
        h = len(idx) // 2
        return original(self, idx[:h], lr, *args,
                        eps=None if eps is None else eps[:h], **kw)
    return step_indices


def _train_answer(original):
    def step_indices(self, *args, **kw):
        out = dict(original(self, *args, **kw))
        out["elbo"] = out["elbo"] * (1 + 1e-3)
        return out
    return step_indices


def _frozen(original):
    def update(self, grads):
        return [torch.zeros_like(d) for d in original(self, grads)]
    return update


def planted(entry: str, fault: str, painter_class: str = "CVAEPainter"):
    """The context manager that plants ``fault`` in the program of a cell
    whose entry is ``entry`` (``paint`` with ``painter_class``, or
    ``train``)."""
    if entry == "paint":
        from baryon_painter_tpu_torch import painter
        owner = getattr(painter, painter_class)
        make = {"half_batch": _paint_half, "answer": _paint_answer}[fault]
        return _patched(owner, "paint_batch", make)
    from baryon_painter_tpu_torch.train import trainer
    if fault == "frozen":
        return _patched(trainer.Adam, "update", _frozen)
    make = {"half_batch": _train_half, "answer": _train_answer}[fault]
    return _patched(trainer.CVAETrainer, "step_indices", make)
