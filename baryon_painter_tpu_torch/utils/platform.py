"""Device selection for the port's entry points.

Entry points take an explicit ``device``. ``None`` means the card: the port
is written for an H100, and a run that silently fell back to the CPU would
measure the wrong machine. The tests pass ``device="cpu"``.
"""
from __future__ import annotations

import contextlib

import torch

__all__ = ["resolve_device", "device_of", "to_device", "f32_convolutions"]


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


def device_of(x, device=None) -> torch.device:
    """The device a function without a painter computes on: ``device`` when
    given, else the device of ``x`` when it is a tensor, else the card
    (``resolve_device``)."""
    if device is None and isinstance(x, torch.Tensor):
        return x.device
    return resolve_device(device)


def to_device(a, device, dtype=None) -> torch.Tensor:
    """``a`` (an array or a tensor) as a tensor on ``device``. A host array
    goes to the card without waiting for the stream: the copy of pageable
    memory is staged before the call returns and runs in stream order,
    where ``torch.as_tensor(a, device=...)`` would wait for all queued
    work first."""
    return torch.as_tensor(a, dtype=dtype).to(device, non_blocking=True)


@contextlib.contextmanager
def f32_convolutions():
    """Run the block with cuDNN's and matmul's TF32 switches off, and restore
    the caller's settings after.

    PyTorch lets cuDNN run "f32" convolutions in TF32 by default (about
    three decimal digits), and matmuls (``einsum`` too) where the caller
    allows it; the painter, the trainer and the resampler run their calls
    in this block, so their f32 is the arithmetic the goldens and the JAX
    package's CPU reference pin."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
