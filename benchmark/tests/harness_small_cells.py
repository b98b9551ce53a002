"""Cells of the benchmark cut small enough for the CPU tests: the manifest,
workload, traffic and configuration files copied into a temporary tree,
the traffic's sizes shrunk. The configurations keep their widths; the
painters are fully convolutional, so only the tiles shrink."""
from __future__ import annotations

import json
import shutil
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness.core import load_cell  # noqa: E402

SMALL = {"sheets_n16": dict(sheet=128, tile=64, pool=2, eps_pool=3,
                            check_calls=2, warmup_calls=1,
                            traced_seconds=0.5),
         "stacks_b24": dict(n_grid=128, tile=64, n_tile=2, batch=2,
                            redshifts=[0.0, 0.5, 1.0], traced_seconds=0.5)}


def small_tree(tmp: Path, changes: dict = None) -> Path:
    """A copy of the manifest and the benchmark's data files under ``tmp``
    with the small traffic (and ``changes``: {relative file: {key:
    value}}); returns the copy's benchmark directory."""
    bench = tmp / "benchmark"
    bench.mkdir(parents=True)
    shutil.copy(ROOT / "BENCHMARK.json", tmp / "BENCHMARK.json")
    for sub in ("configs", "workloads", "traffic"):
        shutil.copytree(ROOT / "benchmark" / sub, bench / sub)
    edits = {f"traffic/{k}.json": v for k, v in SMALL.items()}
    for rel, change in (changes or {}).items():
        edits.setdefault(rel, {}).update(change)
    for rel, change in edits.items():
        path = bench / rel
        data = json.loads(path.read_text())
        data.update(change)
        path.write_text(json.dumps(data))
    return bench


def small_cell(name: str, tmp: Path, seconds: float = 1.0,
               trace: bool = False, seed: int = 2 ** 31 + 7,
               changes: dict = None):
    """The cell ``name`` of a small tree, set to run on the CPU."""
    bench = small_tree(tmp, changes)
    cell = load_cell(name, bench_dir=bench,
                     manifest_path=bench.parent / "BENCHMARK.json")
    cell.seed, cell.seconds, cell.trace = seed, seconds, trace
    cell.device, cell.t_start = "cpu", time.perf_counter()
    return cell
