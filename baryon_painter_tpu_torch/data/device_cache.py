"""Device-resident stack cache: training batches assembled on the card.

Port of the single-device mode of ``baryon_painter_tpu/data/device_cache.py``.
The raw stacks are uploaded to device memory once; a batch is then

    K2 tile gather -> per-sample dihedral -> 100 + 150 sum -> SLICS scaling
    [-> per-sample minimum subtracted from the input]

on the device, and the only per-step transfer is the (B, 9) int32 array of
sample-index digits. Memory: n_field * n_z * (n_100 + n_150) * n_grid^2 * 4
bytes; ``fits`` checks that against a budget and ``create_if_fits`` returns
None (with a warning) when the stacks do not fit, so the trainer uses the
host batch path.

The stacks and the batches stay f32 whatever the model's compute dtype,
bf16 included: the JAX trainer builds its cache in f32 too
(``baryon_painter_tpu/train/trainer.py:225-226``,
``baryon_painter_tpu/data/device_cache.py:70``) and the model casts the
transformed batch where its first convolution does.

The mesh (z-sharded) mode waits for multi-GPU training.
"""
from __future__ import annotations

import warnings
from typing import Optional

import numpy as np
import torch

from baryon_painter_tpu_torch.data.dataset import (BahamasTileDataset,
                                                   slics_scale_factor)
from baryon_painter_tpu_torch.ops.gather import (dihedral_batch,
                                                 gather_tiles,
                                                 gather_tiles_ref)
from baryon_painter_tpu_torch.utils.platform import resolve_device

__all__ = ["DeviceStackCache"]


class DeviceStackCache:
    def __init__(self, dataset: BahamasTileDataset, device=None,
                 use_kernel="auto"):
        """Upload the dataset's stacks to ``device`` (``cuda`` unless the
        caller passes ``device="cpu"``).

        ``use_kernel``: ``"auto"`` or True gathers through K2
        (``ops.gather.gather_tiles``: the kernel on a CUDA device, its plain
        version on the CPU); False always uses the plain version
        (``gather_tiles_ref``), which is what a kernel-free comparison
        run asks for."""
        if use_kernel not in ("auto", True, False):
            raise ValueError(f"use_kernel must be 'auto', True or False, "
                             f"got {use_kernel!r}")
        self.device = resolve_device(device)
        self.use_kernel = use_kernel is not False
        self.dataset = dataset
        self.tile_size = dataset.tile_size
        self.n_label = len(dataset.label_fields)
        # one device holds every redshift, so the batches sample them
        # uniformly (the JAX cache's z-sharded mesh may not)
        self.uniform_z = True

        def stack_all(depth):
            arr = np.stack([np.stack([
                np.asarray(dataset.data[f][z][depth], dtype=np.float32)
                for z in dataset.redshifts]) for f in dataset.fields])
            return torch.from_numpy(arr).to(self.device)   # (F, Z, S, G, G)

        self.data100 = stack_all("100")
        self.data150 = stack_all("150")
        self.z_values = torch.tensor(dataset.redshifts, dtype=torch.float32,
                                     device=self.device)
        self.input_scale = (slics_scale_factor(dataset.n_grid)
                            if dataset.scale_to_SLICS else 1.0)

    @staticmethod
    def nbytes(dataset: BahamasTileDataset) -> int:
        """Device bytes the stacks take."""
        f = len(dataset.fields)
        z = len(dataset.redshifts)
        s = dataset.n_stack_100 + dataset.n_stack_150
        return f * z * s * dataset.n_grid ** 2 * 4

    @classmethod
    def fits(cls, dataset: BahamasTileDataset,
             budget_bytes: int = 8 * 1024 ** 3) -> bool:
        return cls.nbytes(dataset) <= budget_bytes

    @classmethod
    def create_if_fits(cls, dataset: BahamasTileDataset,
                       budget_bytes: int = 8 * 1024 ** 3, device=None,
                       use_kernel="auto") -> Optional["DeviceStackCache"]:
        """The cache, or None (with a warning) when the stacks exceed
        ``budget_bytes`` and the caller should use the host batch path."""
        if not cls.fits(dataset, budget_bytes):
            warnings.warn(
                f"device_data=True but the stacks need "
                f"{cls.nbytes(dataset) / 2**30:.1f} GiB (> budget "
                f"{budget_bytes / 2**30:.1f} GiB); using the host batch "
                f"path.", stacklevel=3)
            return None
        return cls(dataset, device=device, use_kernel=use_kernel)

    def digits(self, idx: np.ndarray) -> np.ndarray:
        """Host-side decode of sample indices into (B, 9) int32 digits:
        (z, p100, p150, s100 + offset, tx100, ty100, s150 + offset, tx150,
        ty150)."""
        s = self.dataset.scheme.decode(np.asarray(idx, dtype=np.int64))
        off = self.dataset.stack_offset
        return np.stack([s.z, s.p100, s.p150, s.s100 + off, s.tx100,
                         s.ty100, s.s150 + off, s.tx150, s.ty150],
                        axis=-1).astype(np.int32)

    def gather(self, digits):
        """(B, 9) host digits -> (input (B, T, T), labels (n_label, B, T, T),
        z (B,)), all float32 on the cache's device."""
        gather = gather_tiles if self.use_kernel else gather_tiles_ref
        tiles = gather(self.data100, self.data150, digits, self.tile_size)
        d = torch.as_tensor(np.asarray(digits), device=self.device).long()
        tiles = (dihedral_batch(tiles[:, 0], d[:, 1])
                 + dihedral_batch(tiles[:, 1], d[:, 2]))        # (B, F, T, T)
        zs = self.z_values[d[:, 0]]
        inputs = tiles[:, 0] * self.input_scale
        if self.dataset.subtract_minimum:
            # the host path's (dataset.get_raw_batch) per-sample minimum
            inputs = inputs - inputs.amin(dim=(1, 2), keepdim=True)
        labels = tiles[:, 1:].transpose(0, 1)                  # (n_label, B..)
        return inputs, labels, zs
