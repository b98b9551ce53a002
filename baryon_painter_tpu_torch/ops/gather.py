"""K2, the tile gather of the device stack cache: its CUDA kernel's wrapper,
its plain PyTorch version, and the per-sample dihedral transform.

Port of ``baryon_painter_tpu/ops/pallas_gather.py`` (``gather_tiles_pallas``,
``dihedral_batch``). The stacks are (F, Z, S, G, G) f32; ``digits`` (B, 9)
holds (z, p100, p150, s100, tx100, ty100, s150, tx150, ty150) per sample,
with the stack offset already added to s100/s150 and tx indexing the first
spatial axis. The gather returns the raw tiles (B, 2, F, T, T), depth 100
first, without the dihedral; ``dihedral_batch`` applies it afterwards, as
the JAX package does.

``gather_tiles`` launches the hand-written kernel (``csrc/gather_tiles.cu``)
when the stacks are on a CUDA device and raises if it cannot; on CPU stacks
it computes the plain version. ``gather_tiles_ref`` is the plain version:
the CPU path, the tests' oracle and ``chip_smoke.py``'s comparison.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["check_digits", "gather_tiles", "gather_tiles_ref",
           "dihedral_batch"]


def check_digits(digits, data100, data150, tile_size: int) -> np.ndarray:
    """``digits`` as a (B, 9) int32 numpy array, after checking every digit
    against the stacks' extents: a tile that would reach outside its stack
    raises (the kernel does not clamp, as XLA's dynamic_slice would)."""
    if isinstance(digits, torch.Tensor):
        digits = digits.detach().cpu().numpy()
    d = np.asarray(digits)
    if d.ndim != 2 or d.shape[1] != 9 or d.shape[0] == 0:
        raise ValueError(f"digits must be (B, 9) with B > 0, got {d.shape}")
    if not np.issubdtype(d.dtype, np.integer):
        raise TypeError(f"digits must be integers, got {d.dtype}")
    _, n_z, s100, g, _ = data100.shape
    s150 = data150.shape[2]
    t = tile_size
    limits = (("z", 0, n_z), ("p100", 1, 8), ("p150", 2, 8),
              ("s100", 3, s100), ("tx100", 4, g // t), ("ty100", 5, g // t),
              ("s150", 6, s150), ("tx150", 7, g // t), ("ty150", 8, g // t))
    for name, col, hi in limits:
        bad = (d[:, col] < 0) | (d[:, col] >= hi)
        if bad.any():
            row = int(np.nonzero(bad)[0][0])
            raise IndexError(f"digits[{row}] {name}={int(d[row, col])} is "
                             f"outside [0, {hi})")
    return d.astype(np.int32)


def _check_stacks(data100, data150, tile_size: int):
    for name, t in (("data100", data100), ("data150", data150)):
        if t.ndim != 5 or t.shape[-1] != t.shape[-2]:
            raise ValueError(f"{name} must be (F, Z, S, G, G), got "
                             f"{tuple(t.shape)}")
    if (data100.shape[:2] != data150.shape[:2]
            or data100.shape[3:] != data150.shape[3:]):
        raise ValueError(f"data100 {tuple(data100.shape)} and data150 "
                         f"{tuple(data150.shape)} differ outside the stack "
                         f"axis")
    if not 0 < tile_size <= data100.shape[-1]:
        raise ValueError(f"tile_size {tile_size} does not fit the "
                         f"{data100.shape[-1]}-pixel stacks")


def gather_tiles_ref(data100, data150, digits, tile_size: int):
    """Plain PyTorch version of K2: one slice per sample, depth and all
    fields. Returns (B, 2, F, T, T) on the stacks' device."""
    _check_stacks(data100, data150, tile_size)
    d = check_digits(digits, data100, data150, tile_size)
    t = tile_size
    out = []
    for z, _, _, s1, x1, y1, s2, x2, y2 in d.tolist():
        out.append(torch.stack([
            data100[:, z, s1, x1 * t:(x1 + 1) * t, y1 * t:(y1 + 1) * t],
            data150[:, z, s2, x2 * t:(x2 + 1) * t, y2 * t:(y2 + 1) * t]]))
    return torch.stack(out)


def gather_tiles(data100, data150, digits, tile_size: int):
    """K2: the raw tiles (B, 2, F, T, T) of a batch, one kernel launch.

    ``data100``/``data150``: (F, Z, S, G, G) float32, contiguous, on one
    device; ``digits``: (B, 9) integers on the host (numpy or a CPU tensor),
    range-checked here. On CPU stacks this is ``gather_tiles_ref``. On CUDA
    stacks the digits are copied to the card, K2 is launched on the current
    stream without synchronising, and ``gather_tiles.launches`` grows by
    one; anything the kernel does not take raises.
    """
    if data100.device.type == "cpu":
        return gather_tiles_ref(data100, data150, digits, tile_size)
    if data100.device.type != "cuda":
        raise ValueError(f"gather_tiles: unsupported device "
                         f"{data100.device}")
    _check_stacks(data100, data150, tile_size)
    d = check_digits(digits, data100, data150, tile_size)
    for name, t in (("data100", data100), ("data150", data150)):
        if t.dtype != torch.float32:
            raise TypeError(f"gather_tiles: {name} must be float32, got "
                            f"{t.dtype}")
        if t.device != data100.device:
            raise ValueError(f"gather_tiles: {name} is on {t.device}, "
                             f"data100 on {data100.device}")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"gather_tiles: {name} must be contiguous and "
                             f"16-byte aligned")
    f, n_z, s100, g, _ = data100.shape
    t = tile_size
    if t % 4 or g % 4:
        raise ValueError(f"gather_tiles: tile {t} and grid {g} must be "
                         f"multiples of 4 (16-byte rows)")
    b = d.shape[0]
    dig = torch.from_numpy(d).to(data100.device)
    out = torch.empty((b, 2, f, t, t), dtype=torch.float32,
                      device=data100.device)

    from baryon_painter_tpu_torch.ops._build import load_library
    lib = load_library()
    with torch.cuda.device(data100.device):
        stream = torch.cuda.current_stream(data100.device).cuda_stream
        err = lib.bpt_gather_tiles(
            data100.data_ptr(), data150.data_ptr(), dig.data_ptr(),
            out.data_ptr(), b, f, n_z, s100, data150.shape[2], g, t, stream)
    if err != 0:
        raise RuntimeError(f"gather_tiles: kernel launch failed: "
                           f"{lib.bpt_error_string(err).decode()} ({err})")
    gather_tiles.launches += 1
    return out


gather_tiles.launches = 0


def dihedral_batch(x, perm):
    """Per-sample dihedral transform of (B, ..., T, T) by ``perm`` (B,) in
    [0, 8), perm = rot * 2 + flip (``data/indexing.dihedral_transform``).

    rot90^rot then a flip of the last axis is at most one transpose and two
    axis reversals, each selected per sample, as in the JAX package."""
    perm = torch.as_tensor(perm, device=x.device).long()
    rot, flip = perm // 2, perm % 2
    bshape = (-1,) + (1,) * (x.ndim - 1)
    tr = ((rot % 2) == 1).reshape(bshape)
    s = ((rot == 1) | (rot == 2)).reshape(bshape)
    r = ((flip == 1) ^ (rot >= 2)).reshape(bshape)
    x = torch.where(tr, x.transpose(-1, -2), x)
    x = torch.where(s, x.flip(-2), x)
    return torch.where(r, x.flip(-1), x)
