"""The numbers that decide ``correct``.

Painting: each checked tile's relative L2 distance from the reference,
||paint - ref|| / ||ref|| over its pixels, and the worst of them
(``tile_rel_l2``): one altered tile fails it as surely as a wrong batch.

Training, over the first steps: ``first_loss_gap``, the first step's
|loss - ref| / |ref| (the later steps' losses drift apart by round-off
alone: Adam's first steps move each parameter by about lr whatever the
size of its gradient, so an entry whose gradient is near 0 moves one way
on one side and the other way on the other); ``grad_gap``, the worst
parameter's | ||g|| - ||g_ref|| | / max(||g_ref||, the median parameter's
||g_ref||), g the first step's gradient as the optimizer received it;
``change_gap``, the same of each parameter's change over the steps,
leaving out the parameters whose reference gradient is under a thousandth
of the median's (their moves are round-off: a batch-normed scale or bias
with no effect on the loss).
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["tile_errors", "norm_gap", "train_gaps", "ZERO_GRAD"]

ZERO_GRAD = 1e-3


def tile_errors(paint: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """(N,) relative L2 distances of (N, H, W) paints from the reference."""
    d = (paint.double() - ref.double()).flatten(1).norm(dim=1)
    return d / ref.double().flatten(1).norm(dim=1)


def norm_gap(got: dict, ref: dict, names) -> float:
    names = list(names)
    floor = float(np.median([ref[n] for n in names]))
    return max(abs(got[n] - ref[n]) / max(ref[n], floor) for n in names)


def train_gaps(got: dict, ref: dict) -> dict:
    """The three training numbers of readings ``got`` against ``ref``
    (``reference.training.steps``' form)."""
    if set(got["grad"]) != set(ref["grad"]):
        raise ValueError("the two sides' parameters differ")
    med = float(np.median(list(ref["grad"].values())))
    moving = [n for n, g in ref["grad"].items() if g >= ZERO_GRAD * med]
    loss = abs(got["loss"][0] - ref["loss"][0]) / abs(ref["loss"][0])
    return {"first_loss_gap": loss,
            "grad_gap": norm_gap(got["grad"], ref["grad"], ref["grad"]),
            "change_gap": norm_gap(got["change"], ref["change"], moving)}
