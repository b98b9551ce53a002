"""Device selection for the port's entry points.

Entry points take an explicit ``device``. ``None`` means the card: the port
is written for an H100, and a run that silently fell back to the CPU would
measure the wrong machine. The tests pass ``device="cpu"``.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "f32_convolutions"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if CUDA is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA was requested (the default device of this package) but "
            "torch.cuda.is_available() is False; pass device='cpu' to run "
            "on the CPU.")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"Unsupported device {dev}; use 'cuda' or 'cpu'.")
    return dev


@contextlib.contextmanager
def f32_convolutions():
    """Run the block with cuDNN's TF32 switch off, and restore the caller's
    setting after.

    PyTorch lets cuDNN run "f32" convolutions in TF32 by default (about
    three decimal digits); the painter and the trainer run their calls in
    this block, so their f32 is the arithmetic the goldens and the JAX
    package's CPU reference pin."""
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32 = prev
