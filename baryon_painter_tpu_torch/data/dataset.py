"""Memmap-backed BAHAMAS tile dataset: the host side of the training data.

Port of ``baryon_painter_tpu/data/dataset.py`` as far as training needs it:
the on-disk schema (per-(field, z) pairs of .npy stacks at the 100 and 150
Mpc/h depths plus a ``*_files_info`` pickle), samples as the sum of one tile
of each depth, the SLICS rescaling of the input field, per-field redshift
statistics, the bijective sample index of ``data/indexing.py``, and the
numpy batch assembly. ``sample_indices`` and ``get_raw_batch`` draw from the
caller's ``numpy.random.Generator`` exactly as the JAX package does, so the
same seed gives the same batches in both. ``BatchLoader`` prefetches raw
batches, or with ``raw=False`` transformed ones (``get_batch``), on a
background thread.

The reference-parity surface (``get_batch``, ``__getitem__``, single
samples, stacks and the per-(field, z) transform callables) transforms on
the host, through the port's transforms on CPU tensors, and returns numpy
as the JAX package's does; the trainers transform raw batches on the card.
The transform callables take tensors (or arrays, as CPU tensors) and
compute on the tensor's device.
"""
from __future__ import annotations

import os
import pickle
import queue
import threading
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from baryon_painter_tpu_torch.data.indexing import (IndexScheme,
                                                    dihedral_transform)
from baryon_painter_tpu_torch.transforms import FieldStats, Identity

__all__ = ["BahamasTileDataset", "BatchLoader", "slics_scale_factor",
           "load_file_info"]


def slics_scale_factor(n_grid: int) -> float:
    """DM rescaling to match SLICS delta planes (datasets.py:301)."""
    return 1.0 / (n_grid / 8 * 5) * 0.2793 / (0.2793 - 0.0463)


class BahamasTileDataset:
    """Tile dataset over paired 100+150 Mpc/h stacks.

    ``transforms`` maps field name -> a transform of
    ``baryon_painter_tpu_torch.transforms`` (identity by default); the
    statistics are ``FieldStats`` on the CPU.
    """

    def __init__(self, files: Optional[List[dict]] = None,
                 root_path: Optional[str] = None,
                 data: Optional[dict] = None,
                 redshifts: Sequence[float] = (),
                 input_field: str = "dm",
                 label_fields: Sequence[str] = (),
                 n_tile: int = 4,
                 L: float = 400.0,
                 n_stack: Optional[int] = None,
                 stack_offset: int = 0,
                 transforms: Optional[Dict[str, object]] = None,
                 tile_permutations: bool = False,
                 scale_to_SLICS: bool = True,
                 subtract_minimum: bool = False,
                 mmap_mode: str = "r"):
        if data is None and files is None:
            raise ValueError("Either data or files need to be provided.")

        if data is not None:
            self.data = data
            fields = list(data.keys())
            zs = list(data[fields[0]].keys())
        else:
            self.data = {}
            fields = [f["field"] for f in files]
            zs = [f["z"] for f in files]
        fields = list(dict.fromkeys(fields))
        zs = list(dict.fromkeys(zs))

        self.input_field = input_field
        if label_fields:
            missing = set([input_field, *label_fields]) - set(fields)
            if missing:
                raise ValueError(f"Requested fields missing from files: "
                                 f"{missing}.")
            self.label_fields = list(label_fields)
        else:
            self.label_fields = [f for f in fields if f != input_field]
        self.fields = [input_field] + self.label_fields

        if redshifts:
            missing = set(redshifts) - set(zs)
            if missing:
                raise ValueError(f"Requested redshifts missing from files: "
                                 f"{missing}.")
            self.redshifts = list(redshifts)
        else:
            self.redshifts = sorted(zs)

        if files is not None:
            for f in files:
                field, z = f["field"], f["z"]
                if field not in self.fields or z not in self.redshifts:
                    continue
                entry = self.data.setdefault(field, {}).setdefault(z, {})
                for depth in ("100", "150"):
                    fn = f[f"file_{depth}"]
                    if root_path is not None:
                        fn = os.path.join(root_path, fn)
                    entry[depth] = np.load(fn, mmap_mode=mmap_mode)
                    entry[f"mean_{depth}"] = f[f"mean_{depth}"]
                    entry[f"var_{depth}"] = f[f"var_{depth}"]

        first = self.data[self.fields[0]][self.redshifts[0]]
        self.n_stack_100, self.n_grid, _ = first["100"].shape
        self.n_stack_150 = first["150"].shape[0]

        self.n_stack = (min(self.n_stack_100, self.n_stack_150)
                        if n_stack is None else n_stack)
        self.stack_offset = stack_offset
        if (min(self.n_stack_100, self.n_stack_150)
                < stack_offset + self.n_stack):
            raise ValueError("Highest stack exceeds number of available "
                             "stacks.")

        self.n_tile = n_tile
        self.tile_size = self.n_grid // n_tile
        self.L = L
        self.tile_L = L / n_tile
        self.scale_to_SLICS = scale_to_SLICS
        self.subtract_minimum = subtract_minimum

        self.scheme = IndexScheme(
            n_z=len(self.redshifts),
            n_perm=8 if tile_permutations else 1,
            n_stack=self.n_stack,
            n_tile=n_tile,
        )

        # per-field statistics on the redshift grid, the input field's
        # SLICS-scaled (datasets.py:195-199, 300-303)
        self.stats: Dict[str, FieldStats] = {}
        z_grid = np.asarray(self.redshifts, dtype=np.float32)
        order = np.argsort(z_grid)
        for field in self.fields:
            mean = np.array([self.data[field][z]["mean_100"]
                             + self.data[field][z]["mean_150"]
                             for z in self.redshifts], dtype=np.float32)
            var = np.array([self.data[field][z]["var_100"]
                            + self.data[field][z]["var_150"]
                            for z in self.redshifts], dtype=np.float32)
            if field == input_field and scale_to_SLICS:
                s = slics_scale_factor(self.n_grid)
                mean, var = mean * s, var * s * s
            self.stats[field] = FieldStats(
                *(torch.from_numpy(np.ascontiguousarray(a[order]))
                  for a in (z_grid, mean, var)))

        self.transforms = {f: Identity() for f in self.fields}
        if transforms:
            self.transforms.update(transforms)

    @property
    def n_sample(self):
        return self.scheme.n_sample

    def __len__(self):
        return self.scheme.n_total

    def sample_idx_to_redshift(self, idx):
        zi = self.scheme.z_index(idx)
        if np.ndim(zi) == 0:
            return self.redshifts[int(zi)]
        return np.asarray(self.redshifts, dtype=np.float32)[zi]

    def _read_tile(self, field, z, depth, stack, tx, ty, perm):
        arr = self.data[field][z][depth]
        t = self.tile_size
        tile = np.asarray(arr[stack + self.stack_offset,
                              tx * t:(tx + 1) * t,
                              ty * t:(ty + 1) * t], dtype=np.float32)
        return dihedral_transform(tile, perm)

    def get_stack(self, field, z, flat_idx):
        """Raw 250 Mpc/h-equivalent tile for (field, z-agnostic index)
        (datasets.py:305-344, with the corrected index decode)."""
        s = self.scheme.decode(int(flat_idx))
        d100 = self._read_tile(field, z, "100", int(s.s100), int(s.tx100),
                               int(s.ty100), int(s.p100))
        d150 = self._read_tile(field, z, "150", int(s.s150), int(s.tx150),
                               int(s.ty150), int(s.p150))
        return d100 + d150

    def get_input_sample(self, idx, transform=True):
        z = self.sample_idx_to_redshift(idx)
        d = self.get_stack(self.input_field, z, idx)
        if self.scale_to_SLICS:
            d = d * slics_scale_factor(self.n_grid)
        if self.subtract_minimum:
            d = d - d.min()
        if transform:
            d = _numpy(self.transform(d, self.input_field, z))
        return d

    def get_label_sample(self, idx, transform=True):
        z = self.sample_idx_to_redshift(idx)
        out = []
        for field in self.label_fields:
            d = self.get_stack(field, z, idx)
            if transform:
                d = _numpy(self.transform(d, field, z))
            out.append(d)
        return out

    def __getitem__(self, idx):
        """([input] + labels, idx, z) — reference parity (datasets.py:483)."""
        return ([self.get_input_sample(idx)] + self.get_label_sample(idx),
                int(idx), self.sample_idx_to_redshift(idx))

    # ------------------------------------------------------------------ #
    # Transforms: on a tensor's device (arrays as CPU tensors)

    def _stats_on(self, field, device) -> FieldStats:
        st = self.stats[field]
        if st.z_grid.device == device:
            return st
        return FieldStats(*(t.to(device) for t in (st.z_grid, st.mean,
                                                   st.var)))

    def _apply(self, x, field, z, inverse: bool):
        x = torch.as_tensor(x)
        z = torch.as_tensor(z, dtype=torch.float32, device=x.device)
        t = self.transforms[field]
        fn = t.inverse if inverse else t.forward
        return fn(x, self._stats_on(field, x.device), z)

    def transform(self, x, field, z):
        return self._apply(x, field, z, inverse=False)

    def inverse_transform(self, x, field, z):
        return self._apply(x, field, z, inverse=True)

    def create_transform(self, field, z):
        """Callable f(x) bound to (field, z) (datasets.py:206-209)."""
        return lambda x: self.transform(x, field, z)

    def create_inverse_transform(self, field, z):
        return lambda x: self.inverse_transform(x, field, z)

    def get_transforms(self, idx=None, z=None):
        """Per-field transform callables for a sample (datasets.py:216-243),
        the input field's first."""
        if idx is None and z is None:
            raise ValueError("Either idx or z have to be specified.")
        if z is None:
            z = self.sample_idx_to_redshift(idx)
        return [self.create_transform(f, z) for f in self.fields]

    def get_inverse_transforms(self, idx=None, z=None):
        if idx is None and z is None:
            raise ValueError("Either idx or z have to be specified.")
        if z is None:
            z = self.sample_idx_to_redshift(idx)
        return [self.create_inverse_transform(f, z) for f in self.fields]

    # ------------------------------------------------------------------ #

    def sample_indices(self, rng: np.random.Generator, size: int,
                       z: Optional[float] = None) -> np.ndarray:
        """Uniform sampling over (z, sample), or over the samples of one
        redshift ``z``."""
        if z is None:
            return rng.choice(len(self), size=size, replace=size > len(self))
        zi = self.redshifts.index(z)
        base = rng.choice(self.n_sample, size=size,
                          replace=size > self.n_sample)
        return zi * self.n_sample + base

    def get_raw_batch(self, idx: np.ndarray) -> dict:
        """Assemble a raw batch: untransformed tiles + per-sample redshift.

        Returns dict with 'input' (N, H, W) float32 (SLICS-scaled),
        'labels' (n_label, N, H, W), 'z' (N,) float32, 'idx'.
        """
        idx = np.asarray(idx, dtype=np.int64)
        s = self.scheme.decode(idx)
        zs = np.asarray(self.redshifts, dtype=np.float32)[s.z]
        n = len(idx)
        t = self.tile_size
        out_in = np.empty((n, t, t), dtype=np.float32)
        out_lab = np.empty((len(self.label_fields), n, t, t),
                           dtype=np.float32)
        scale = slics_scale_factor(self.n_grid) if self.scale_to_SLICS \
            else 1.0
        for i in range(n):
            z = self.redshifts[int(s.z[i])]
            args100 = (int(s.s100[i]), int(s.tx100[i]), int(s.ty100[i]),
                       int(s.p100[i]))
            args150 = (int(s.s150[i]), int(s.tx150[i]), int(s.ty150[i]),
                       int(s.p150[i]))
            d = (self._read_tile(self.input_field, z, "100", *args100)
                 + self._read_tile(self.input_field, z, "150", *args150))
            d *= scale
            if self.subtract_minimum:
                d -= d.min()
            out_in[i] = d
            for j, field in enumerate(self.label_fields):
                out_lab[j, i] = (self._read_tile(field, z, "100", *args100)
                                 + self._read_tile(field, z, "150",
                                                   *args150))
        return {"input": out_in, "labels": out_lab, "z": zs, "idx": idx}

    def get_batch(self, size=1, z=None, idx=None,
                  rng: Optional[np.random.Generator] = None, transform=True):
        """Reference-parity batch: ((1+n_label, N, C, H, W), idx, z) as
        numpy (datasets.py:434-473), with explicit rng; transformed on the
        host."""
        if idx is None:
            rng = rng or np.random.default_rng()
            idx = self.sample_indices(rng, size, z)
        raw = self.get_raw_batch(np.asarray(idx))
        zs = raw["z"]
        fields = [raw["input"]] + [raw["labels"][j]
                                   for j in range(len(self.label_fields))]
        if transform:
            fields = [_numpy(self.transform(arr, name, zs))
                      for name, arr in zip(self.fields, fields)]
        # (F, N, C, H, W); single-channel transforms get C=1, split-scale
        # transforms already emit a channel axis
        fields = [f[:, None, :, :] if f.ndim == 3 else f for f in fields]
        return np.stack(fields), np.asarray(idx), zs


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy() if torch.is_tensor(t) else np.asarray(t)


class BatchLoader:
    """Background-thread prefetcher over a ``BahamasTileDataset``: raw
    batches (``get_raw_batch``), or with ``raw=False`` the transformed
    reference-parity batches of ``get_batch(idx=...)`` for the same index
    draws, from a generator seeded ``seed`` (of redshift ``z`` if given);
    ``close()`` stops the thread."""

    def __init__(self, dataset: BahamasTileDataset, batch_size: int,
                 seed: int = 0, z: Optional[float] = None, prefetch: int = 2,
                 raw: bool = True):
        self.dataset = dataset
        self.raw = raw
        self.batch_size = batch_size
        self.z = z
        self._rng = np.random.default_rng(seed)
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _make(self):
        idx = self.dataset.sample_indices(self._rng, self.batch_size, self.z)
        if self.raw:
            return self.dataset.get_raw_batch(idx)
        return self.dataset.get_batch(idx=idx)

    def _worker(self):
        while not self._stop.is_set():
            batch = self._make()
            while not self._stop.is_set():
                try:
                    self._queue.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self):
        return self

    def __next__(self):
        return self._queue.get()

    def close(self):
        self._stop.set()
        try:
            while True:
                self._queue.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=1.0)


def load_file_info(path: str) -> List[dict]:
    """Load a *_files_info pickle (same schema as the reference)."""
    with open(path, "rb") as f:
        return pickle.load(f)
