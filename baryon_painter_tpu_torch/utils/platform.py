"""Device selection for the port's entry points.

Entry points take an explicit ``device``. ``None`` means the card: the port
is written for an H100, and a run that silently fell back to the CPU would
measure the wrong machine. The tests pass ``device="cpu"``.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


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
