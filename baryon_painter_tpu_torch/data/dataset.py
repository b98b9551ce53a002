"""Memmap-backed BAHAMAS tile dataset: the host side of the training data.

Port of ``baryon_painter_tpu/data/dataset.py`` as far as training needs it:
the on-disk schema (per-(field, z) pairs of .npy stacks at the 100 and 150
Mpc/h depths plus a ``*_files_info`` pickle), samples as the sum of one tile
of each depth, the SLICS rescaling of the input field, per-field redshift
statistics, the bijective sample index of ``data/indexing.py``, and the
numpy batch assembly. ``sample_indices`` and ``get_raw_batch`` draw from the
caller's ``numpy.random.Generator`` exactly as the JAX package does, so the
same seed gives the same batches in both. ``BatchLoader`` prefetches raw
batches on a background thread.

Not ported: the reference-parity accessors (``get_batch``, single samples,
and the transformed batches ``BatchLoader(raw=False)`` would give).
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

    def _read_tile(self, field, z, depth, stack, tx, ty, perm):
        arr = self.data[field][z][depth]
        t = self.tile_size
        tile = np.asarray(arr[stack + self.stack_offset,
                              tx * t:(tx + 1) * t,
                              ty * t:(ty + 1) * t], dtype=np.float32)
        return dihedral_transform(tile, perm)

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


class BatchLoader:
    """Background-thread prefetcher of raw batches (``get_raw_batch``) over
    a ``BahamasTileDataset``, drawing indices from a generator seeded
    ``seed`` (of redshift ``z`` if given); ``close()`` stops the thread."""

    def __init__(self, dataset: BahamasTileDataset, batch_size: int,
                 seed: int = 0, z: Optional[float] = None, prefetch: int = 2,
                 raw: bool = True):
        if not raw:
            raise NotImplementedError(
                "BatchLoader(raw=False): transformed reference-parity "
                "batches (get_batch) are not ported; the trainer "
                "transforms raw batches on the device.")
        self.dataset = dataset
        self.batch_size = batch_size
        self.z = z
        self._rng = np.random.default_rng(seed)
        self._queue: queue.Queue = queue.Queue(maxsize=prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _make(self):
        idx = self.dataset.sample_indices(self._rng, self.batch_size, self.z)
        return self.dataset.get_raw_batch(idx)

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
