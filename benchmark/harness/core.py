"""The harness's frame: the manifest, a cell's files found by name, the
per-layer readers, the run's result line and its checks.

A cell named in ``BENCHMARK.json`` brings ``workloads/<cell>.json`` (its
entry, the system's options and the limits of its checks), its
configuration's file (as the manifest names it) and
``traffic/<traffic>.json``. Its entry is ``entries/<entry>.py`` with
``run(cell)``, which returns the end-to-end metrics (``--trace 0``) or the
per-layer readers' run record (``--trace 1``). A per-layer metric is
``metrics/<name>.py``, whose ``read(run)`` returns a number or None.
Nothing here is specific to one cell, configuration or metric.
"""
from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path

__all__ = ["BENCH_DIR", "ROOT", "Cell", "load_cell", "load_module",
           "read_per_layer", "forbidden_modules", "Checks", "port_dtype",
           "device_kind"]

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
# top-level module names a run may not hold once its window has closed:
# the reference package and its framework
FORBIDDEN = ("jax", "jaxlib", "flax", "baryon_painter_tpu")


@dataclass
class Cell:
    name: str
    manifest: dict
    entry: dict            # the manifest's workloads entry
    workload: dict         # workloads/<cell>.json
    config: dict           # the configuration's file
    config_entry: dict     # the manifest's configs entry
    traffic: dict          # traffic/<traffic>.json
    seed: int = 0
    seconds: float = 10.0
    trace: bool = False
    device: str = "cuda"
    t_start: float = 0.0   # the process's start, on the perf_counter clock
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_cell(name: str, bench_dir: Path = BENCH_DIR,
              manifest_path: Path = None) -> Cell:
    """The cell ``name`` of the manifest with its files. Raises KeyError for
    a cell the manifest does not name."""
    manifest = _json(manifest_path or bench_dir.parent / "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == name),
                 None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in the manifest")
    conf = next(c for c in manifest["configs"]
                if c["name"] == entry["config"])
    cell = Cell(name=name, manifest=manifest, entry=entry,
                workload=_json(bench_dir / "workloads" / f"{name}.json"),
                config=_json(bench_dir.parent / conf["file"]),
                config_entry=conf,
                traffic=_json(bench_dir / "traffic"
                              / f"{entry['traffic']}.json"))
    cell.end_to_end = [m for m in manifest["end_to_end"]
                       if name in m.get("workloads", [name])]
    reported = {m["name"] for m in cell.end_to_end}
    cell.per_layer = [m for m in manifest["per_layer"]
                      if (name in m["workloads"] if "workloads" in m
                          else m["moves"] in reported)]
    return cell


def load_module(path: Path, name: str):
    """A Python file loaded as a module under ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_per_layer(cell: Cell, run, bench_dir: Path = BENCH_DIR) -> dict:
    """Each per-layer metric of the cell read from ``run`` by
    ``metrics/<name>.py``; a reader that finds nothing returns None and
    the metric is left out."""
    out = {}
    for m in cell.per_layer:
        reader = load_module(bench_dir / "metrics" / f"{m['name']}.py",
                             "bench_metric_" + m["name"].replace(".", "_"))
        value = reader.read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def port_dtype(name: str):
    """A workload's dtype name as the port's ``dtype`` argument (None for
    float32, the port's default)."""
    import torch
    return None if name == "float32" else getattr(torch, name)


def device_kind(device) -> str:
    """``torch.cuda.get_device_name`` of a CUDA device, else its type."""
    import torch
    return (torch.cuda.get_device_name(device) if device.type == "cuda"
            else device.type)


def forbidden_modules() -> list:
    """The top-level names of ``sys.modules`` among ``FORBIDDEN``, each
    compared whole (the port's name begins with the JAX package's)."""
    top = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(top.intersection(FORBIDDEN))


class Checks:
    """The numbers a run compares, each with its limit (a reading passes
    when it is at most the limit and finite)."""

    def __init__(self, limits: dict):
        self.limits = limits
        self.values: dict = {}

    def add(self, name: str, value: float):
        if name not in self.limits:
            raise KeyError(f"no limit for check {name!r}")
        self.values[name] = float(value)

    @property
    def correct(self) -> bool:
        return (set(self.values) == set(self.limits) and all(
            v == v and v <= self.limits[k] for k, v in self.values.items()))

    def record(self) -> dict:
        return {k: {"value": self.values.get(k), "limit": lim}
                for k, lim in self.limits.items()}
