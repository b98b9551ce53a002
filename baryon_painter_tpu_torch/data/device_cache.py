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

With a ``ProcessMesh`` (``parallel/mesh.py``, one process a device) the
stacks are z-sharded as in the JAX package's mesh mode: redshift slots are
assigned round-robin to the ranks (``_slot_assignment``: every rank holds
at least one real redshift, redshifts are replicated when ranks outnumber
them), each rank uploads only its own slab of ``slab = ceil(n_z / n)``
redshifts (the memory the mode saves), and batches are drawn
device-grouped (``sample_mesh_indices``, the same numpy generator on every
rank): row block r of a global batch references only redshifts resident
on rank r. Rank r gathers its rows from its slab through K2, the slot
digit rebased to the slab (``local_digits``); a slot outside the slab is
caught by K2's host check. When n_z % n != 0 the redshifts are not
sampled uniformly; ``z_slot_weights`` are the per-slot importance weights
that restore the uniform-z expectation, and ``uniform_z`` says whether
any are needed.
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
from baryon_painter_tpu_torch.utils import profiling
from baryon_painter_tpu_torch.utils.platform import resolve_device

__all__ = ["DeviceStackCache"]


def _slot_assignment(n_z: int, n_dev: int):
    """Round-robin redshift -> slot layout for z-sharding over n_dev ranks
    (the JAX package's, ``data/device_cache.py:45-66``).

    Returns (slot_to_z, slab): slot_to_z has n_dev * slab entries, slab =
    ceil(n_z / n_dev); rank d owns slots [d * slab, (d + 1) * slab). Slot
    (d, j) holds redshift d + j * n_dev when that exists; a rank beyond
    n_z replicates redshift d % n_z in its first slot; other slots are
    padding (-1)."""
    slab = max(1, -(-n_z // n_dev))
    slot_to_z = []
    for d in range(n_dev):
        for j in range(slab):
            z = d + j * n_dev
            if z < n_z:
                slot_to_z.append(z)
            elif j == 0:
                slot_to_z.append(d % n_z)
            else:
                slot_to_z.append(-1)
    return slot_to_z, slab


def _local_redshifts(slot_to_z, slab: int, d: int) -> list:
    """The redshift indices resident on rank d, sorted."""
    return sorted({z for z in slot_to_z[d * slab:(d + 1) * slab] if z >= 0})


def _slot_weights(slot_to_z, slab: int, n_dev: int, n_z: int):
    """(per-slot weights, uniform): equal per-rank quotas sampled uniformly
    over each rank's redshifts give redshift z the marginal p(z) = sum over
    the ranks holding it of 1 / (n_dev * n_local); w_z = (1 / n_z) / p(z)
    restores the uniform-z expected gradient as the ELBO's sample weight.
    Padding slots weigh 0."""
    p_z = np.zeros(n_z)
    for d in range(n_dev):
        local = _local_redshifts(slot_to_z, slab, d)
        for zi in local:
            p_z[zi] += 1.0 / (n_dev * len(local))
    w_z = (1.0 / n_z) / np.maximum(p_z, 1e-12)
    slots = np.asarray(slot_to_z, np.int64)
    weights = np.where(slots >= 0, w_z[np.maximum(slots, 0)],
                       0.0).astype(np.float32)
    return weights, bool(np.allclose(w_z, 1.0))


def sample_mesh_indices(dataset: BahamasTileDataset, n_dev: int, rng,
                        batch_size: int) -> np.ndarray:
    """A device-grouped global batch of the z-sharded layout over n_dev
    ranks: row block d references only redshifts resident on rank d,
    uniform over them, drawn from ``rng`` as the JAX package draws it."""
    if batch_size % n_dev:
        raise ValueError(f"batch {batch_size} not divisible by the "
                         f"{n_dev}-device mesh")
    slot_to_z, slab = _slot_assignment(len(dataset.redshifts), n_dev)
    per = batch_size // n_dev
    zs = dataset.redshifts
    out = []
    for d in range(n_dev):
        local = _local_redshifts(slot_to_z, slab, d)
        for zi in rng.choice(len(local), size=per):
            out.append(dataset.sample_indices(rng, 1, z=zs[local[zi]]))
    return np.concatenate(out)


class DeviceStackCache:
    def __init__(self, dataset: BahamasTileDataset, device=None,
                 use_kernel="auto", mesh=None):
        """Upload the dataset's stacks to ``device`` (``cuda`` unless the
        caller passes ``device="cpu"``).

        ``use_kernel``: ``"auto"`` or True gathers through K2
        (``ops.gather.gather_tiles``: the kernel on a CUDA device, its plain
        version on the CPU); False always uses the plain version
        (``gather_tiles_ref``), which is what a kernel-free comparison
        run asks for. ``mesh``: a ``ProcessMesh``; this rank uploads only
        its z-slab (module docstring), on the mesh's device."""
        if use_kernel not in ("auto", True, False):
            raise ValueError(f"use_kernel must be 'auto', True or False, "
                             f"got {use_kernel!r}")
        if mesh is not None and not hasattr(mesh, "rows"):
            raise TypeError(f"the z-sharded cache takes a ProcessMesh, got "
                            f"{type(mesh).__name__}")
        self.device = resolve_device(device if mesh is None else mesh.device)
        self.use_kernel = use_kernel is not False
        self.dataset = dataset
        self.tile_size = dataset.tile_size
        self.n_label = len(dataset.label_fields)
        self.mesh = mesh
        self._n_dev = 1 if mesh is None else mesh.size
        self._rank = 0 if mesh is None else mesh.rank
        n_z = len(dataset.redshifts)
        slot_to_z, self._slab = _slot_assignment(n_z, self._n_dev)
        self._slot_to_z = np.asarray(slot_to_z, np.int64)
        self.z_slot_weights, self.uniform_z = _slot_weights(
            slot_to_z, self._slab, self._n_dev, n_z)
        # slot_of[d, z]: the global slot holding z in rank d's slab, or -1
        # (the earlier slot wins)
        slot_of = np.full((self._n_dev, n_z), -1, np.int64)
        for s in range(len(slot_to_z) - 1, -1, -1):
            if slot_to_z[s] >= 0:
                slot_of[s // self._slab, slot_to_z[s]] = s
        self._slot_of = slot_of
        lo = self._rank * self._slab
        local = self._slot_to_z[lo:lo + self._slab]

        def stack_all(depth):
            one_z = lambda zi: np.stack([np.asarray(
                dataset.data[f][dataset.redshifts[zi]][depth],
                dtype=np.float32) for f in dataset.fields])  # (F, S, G, G)
            zero = np.zeros_like(one_z(0))
            arr = np.stack([one_z(zi) if zi >= 0 else zero for zi in local],
                           axis=1)                             # (F, slab, ..)
            return torch.from_numpy(arr).to(self.device)

        with profiling.setup_span("setup.stacks"):
            self.data100 = stack_all("100")
            self.data150 = stack_all("150")
        # the z value of each of this rank's slots (padding: 0)
        z_arr = np.asarray(dataset.redshifts, np.float32)
        self.z_values = torch.from_numpy(np.where(
            local >= 0, z_arr[np.maximum(local, 0)], 0.0).astype(
                np.float32)).to(self.device)
        self.input_scale = (slics_scale_factor(dataset.n_grid)
                            if dataset.scale_to_SLICS else 1.0)

    @staticmethod
    def nbytes(dataset: BahamasTileDataset, n_shards: int = 1) -> int:
        """Device bytes the stacks take on each rank: with n_shards > 1
        the z axis is slab-sharded (ceil(n_z / n_shards) redshifts a
        rank)."""
        f = len(dataset.fields)
        z = max(1, -(-len(dataset.redshifts) // n_shards))
        s = dataset.n_stack_100 + dataset.n_stack_150
        return f * z * s * dataset.n_grid ** 2 * 4

    @classmethod
    def fits(cls, dataset: BahamasTileDataset,
             budget_bytes: int = 8 * 1024 ** 3, n_shards: int = 1) -> bool:
        return cls.nbytes(dataset, n_shards) <= budget_bytes

    @classmethod
    def create_if_fits(cls, dataset: BahamasTileDataset,
                       budget_bytes: int = 8 * 1024 ** 3, device=None,
                       use_kernel="auto",
                       mesh=None) -> Optional["DeviceStackCache"]:
        """The cache, or None (with a warning) when the stacks exceed
        ``budget_bytes`` on a rank and the caller should use the host batch
        path."""
        n = 1 if mesh is None else mesh.size
        if not cls.fits(dataset, budget_bytes, n_shards=n):
            warnings.warn(
                f"device_data=True but the stacks need "
                f"{cls.nbytes(dataset, n) / 2**30:.1f} GiB a device (> "
                f"budget {budget_bytes / 2**30:.1f} GiB); using the host "
                f"batch path.", stacklevel=3)
            return None
        return cls(dataset, device=device, use_kernel=use_kernel, mesh=mesh)

    def sample_mesh_indices(self, rng, batch_size: int) -> np.ndarray:
        """A device-grouped global batch for this cache's layout (row block
        d holds only redshifts resident on rank d)."""
        return sample_mesh_indices(self.dataset, self._n_dev, rng,
                                   batch_size)

    def digits(self, idx: np.ndarray) -> np.ndarray:
        """Host-side decode of a global batch's sample indices into (B, 9)
        int32 digits: (z slot, p100, p150, s100 + offset, tx100, ty100,
        s150 + offset, tx150, ty150). The slot is the redshift index on one
        device; z-sharded, the global slot in the row's rank's slab (rows
        device-grouped: ``sample_mesh_indices``), and a row whose redshift
        is not resident on its rank raises."""
        s = self.dataset.scheme.decode(np.asarray(idx, dtype=np.int64))
        off = self.dataset.stack_offset
        if self._n_dev == 1:
            z_slot = s.z
        else:
            b = len(s.z)
            if b % self._n_dev:
                raise ValueError(f"batch {b} not divisible by the "
                                 f"{self._n_dev}-device mesh")
            dev = np.arange(b) // (b // self._n_dev)
            z_slot = self._slot_of[dev, s.z]
            if (z_slot < 0).any():
                bad = int(np.nonzero(z_slot < 0)[0][0])
                raise ValueError(
                    f"row {bad}: z index {s.z[bad]} is not resident on "
                    f"rank {dev[bad]}; draw batches with "
                    f"sample_mesh_indices")
        return np.stack([z_slot, s.p100, s.p150, s.s100 + off, s.tx100,
                         s.ty100, s.s150 + off, s.tx150, s.ty150],
                        axis=-1).astype(np.int32)

    def local_digits(self, digits: np.ndarray) -> np.ndarray:
        """This rank's rows of a global batch's digits, the slot rebased
        to its slab (the identity on one device)."""
        d = np.asarray(digits)
        if self.mesh is None:
            return d
        lo, hi = self.mesh.rows(len(d))
        d = d[lo:hi].copy()
        d[:, 0] -= self._rank * self._slab
        return d

    def sample_weights(self, digits: np.ndarray):
        """The importance weights of a global batch's rows (``digits``),
        on the device, or None where the layout samples redshifts
        uniformly."""
        if self.uniform_z:
            return None
        return torch.from_numpy(
            self.z_slot_weights[np.asarray(digits)[:, 0]]).to(self.device)

    def gather(self, digits):
        """(B, 9) host digits of this rank's rows, the slot indexing its
        own slab (``local_digits``) -> (input (B, T, T), labels (n_label,
        B, T, T), z (B,)), all float32 on the cache's device."""
        gather = gather_tiles if self.use_kernel else gather_tiles_ref
        tiles = gather(self.data100, self.data150, digits, self.tile_size)
        d = np.asarray(digits)
        with profiling.span("train.upload", bytes=d.nbytes):
            d = torch.as_tensor(d, device=self.device).long()
        tiles = (dihedral_batch(tiles[:, 0], d[:, 1])
                 + dihedral_batch(tiles[:, 1], d[:, 2]))        # (B, F, T, T)
        zs = self.z_values[d[:, 0]]
        inputs = tiles[:, 0] * self.input_scale
        if self.dataset.subtract_minimum:
            # the host path's (dataset.get_raw_batch) per-sample minimum
            inputs = inputs - inputs.amin(dim=(1, 2), keepdim=True)
        labels = tiles[:, 1:].transpose(0, 1)                  # (n_label, B..)
        return inputs, labels, zs
