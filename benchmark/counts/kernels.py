"""Least times of the port's hand-written kernels, from their shapes.

A kernel's bound is max(operations / peak, bytes / bandwidth) with the
peaks of ``peaks.json`` for the card and the dtype: the dtype's
tensor-core rate whatever unit runs the work (bf16 989 TFLOP/s; f32
495 / 3 TFLOP/s, 3xTF32, the fastest f32-accurate path), so that moving
work onto the tensor cores can never read above 100 %. Operations are
counted from the layer's math at its shapes, once each (no recomputed
work); bytes count each input read once and each output written once, and
a tensor that a design keeps between its passes (K3's u1, K4's u) is not
counted. Copied from the smoke's ``k1_bound``, ``k3_bounds`` and
``k4_bounds`` and re-based as said.
"""
from __future__ import annotations

import json
from pathlib import Path

__all__ = ["peaks", "bound_s", "k1", "k3_fwd", "k3_bwd", "k4_site",
           "ELT"]

ELT = {"float32": 4, "bfloat16": 2}
_PEAKS = Path(__file__).resolve().parent / "peaks.json"

# multiply-adds a pixel of one output head: conv 7x7 16 -> 8, conv 5x5
# 8 -> 1, conv 3x3 1 -> 1 (no bias), and the head's parameters
_HEAD_MACS = 7 * 7 * 16 * 8 + 5 * 5 * 8 + 3 * 3
_HEAD_PARAMS = _HEAD_MACS + 2        # and two PReLU slopes


def peaks(kind: str):
    """{"float32", "bfloat16", "hbm_bytes_per_s"} of a card by its
    ``torch.cuda.get_device_name()``, or None for a card not in the
    table."""
    with open(_PEAKS) as f:
        return json.load(f)["cards"].get(kind)


def bound_s(flops: float, nbytes: float, peak: dict, dtype: str) -> float:
    return max(flops / peak[dtype], nbytes / peak["hbm_bytes_per_s"])


def k1(n: int, h: int, w: int, c: int, dtype: str) -> tuple:
    """(operations, bytes) of one K1 launch: a residual block's two 3x3
    convolutions C -> C; x read and the output written in the dtype, both
    weights read in it, the folded batch norm (4 C f32)."""
    e = ELT[dtype]
    return (2.0 * 2 * n * h * w * c * c * 9,
            2.0 * n * h * w * c * e + 2 * 9 * c * c * e + 4 * c * 4)


def k3_fwd(n: int, h: int, w: int, dtype: str) -> tuple:
    """(operations, bytes) of a K3-fwd call, both heads: x (16 channels)
    read and y (2) written in the dtype, the f32 weights read."""
    pix = n * h * w
    return (2.0 * 2 * pix * _HEAD_MACS,
            pix * (16 + 2) * ELT[dtype] + 2 * _HEAD_PARAMS * 4)


def k3_bwd(n: int, h: int, w: int, dtype: str) -> tuple:
    """(operations, bytes) of a K3-bwd call, both heads: each conv's input
    and weight gradients (twice the forward's multiply-adds); x and dy read
    and dx written in the dtype, the f32 weights read and their gradients
    written."""
    pix = n * h * w
    return (2.0 * 2 * 2 * pix * _HEAD_MACS,
            pix * (16 + 2 + 16) * ELT[dtype] + 2 * 2 * _HEAD_PARAMS * 4)


def k4_site(site: dict, n: int, dtype: str) -> tuple:
    """((forward operations, bytes), (backward operations, bytes)) of the
    train-mode conv + batch norm + ReLU at one site (a ``shapes.walk``
    record). One pass is 2 N H_out W_out C_out C_in taps operations, taps
    = k^2 (a transposed conv: (k / s)^2 a output pixel); the forward is a
    pass and 3 operations an output, reading x and w and writing y; the
    backward two passes (dx, dW) and 8 an output, reading x, w, y and dy
    and writing dx and dW, each at the dtype's size."""
    e = ELT[dtype]
    taps = ((site["k"] // site["s"]) ** 2 if site["kind"] == "transp"
            else site["k"] ** 2)
    out = n * site["ho"] * site["wo"] * site["cout"]
    conv = 2.0 * out * site["cin"] * taps
    xb = e * n * site["cin"] * site["h"] * site["w"]
    wb = e * site["cin"] * site["cout"] * site["k"] ** 2
    yb = e * out
    return ((conv + 3 * out, xb + wb + yb),
            (2 * conv + 8 * out, 2 * xb + 2 * wb + 2 * yb))
