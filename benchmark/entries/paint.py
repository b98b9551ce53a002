"""Painting cells: a painter of the port's ``painter`` module paints a
closed loop of sheet-sized calls.

The workload file names the painter class (``CVAEPainter``,
``CGANPainter``), its keyword arguments and its dtype; the configuration
file the checkpoint, which the painter reads through its own loader. The
traffic (``paint_sheets``, ``harness/traffic.py``) gives each call one
sheet's tiles, one redshift of the checkpoint's grid and, for the CVAE,
prior noise the benchmark drew (rounded to the painter's dtype, so both
sides read the same numbers). Set-up ends with ``warmup_calls`` calls of
the window's own shape.

A reservoir of ``check_calls`` calls, drawn from the seed among all the
window's calls, is copied aside as the calls complete; once the window
has closed, the painter is freed and the reference paints the same
inputs (``reference/painting.py``), and each checked tile's relative L2
distance is held to the workload's limit.
"""
from __future__ import annotations

import gc
import json
import time

import torch
from torch.profiler import record_function

from benchmark.harness import compare, measure, traffic
from benchmark.harness.core import (Cell, Checks, device_kind,
                                    port_dtype)
from benchmark.harness.record import Run
from benchmark.reference.painting import ReferencePainter

__all__ = ["PaintSystem", "run"]

MAX_CALLS = 200_000


class PaintSystem:
    """The painter under test with its inputs, made from the seed."""

    def __init__(self, cell: Cell, seed: int, device, program=True):
        """``program=False`` makes the inputs alone."""
        wl, tr, cfg = cell.workload, cell.traffic, cell.config
        self.device = device
        self.dtype = wl["dtype"]
        self.painter = None
        if program:
            from baryon_painter_tpu_torch import painter as painter_module
            cls = getattr(painter_module, wl["painter"])
            self.painter = cls(cfg["checkpoint"],
                               dtype=port_dtype(self.dtype), device=device,
                               **wl.get("kwargs", {}))
        with open(cfg["checkpoint"] + "_meta.json") as f:
            meta = json.load(f)
        stats = meta["stats"][meta["input_field"]]
        z_grid = stats["z_grid"]
        self.tiles = traffic.paint_pool(tr, seed, stats["mean"], device)
        self.n = self.tiles.shape[2]
        self.zrows = torch.tensor(z_grid, dtype=torch.float32,
                                  device=device)[:, None].expand(
                                      -1, self.n).contiguous()
        self.eps = None
        if cfg["model"] == "cvae":
            arch = cfg["architecture"]
            f = arch["dim_y"][1] // arch["dim_z"][1]
            h = tr["tile"] // f
            gen = traffic.cuda_generator(seed, 3, device)
            self.eps = traffic.round_to(torch.randn(
                (tr["eps_pool"], self.n, arch["dim_z"][0], h, h),
                generator=gen, device=device), self.dtype)
        self.schedule = traffic.paint_schedule(tr, seed, len(z_grid),
                                               MAX_CALLS)
        k = tr["check_calls"]
        self.kept = torch.empty((k, self.n, tr["tile"], tr["tile"]),
                                dtype=torch.float32, device=device)
        self.kept_calls = [None] * k

    def inputs(self, i: int):
        s = self.schedule
        zi = int(s["z"][i])
        tiles = self.tiles[zi, int(s["sheet"][i])]
        zs = self.zrows[zi]
        eps = None if self.eps is None else self.eps[int(s["eps"][i])]
        return tiles, zs, eps

    def call(self, i: int):
        tiles, zs, eps = self.inputs(i)
        if eps is None:
            return self.painter.paint_batch(tiles, zs)
        return self.painter.paint_batch(tiles, zs, eps=eps)

    def issue(self, i: int) -> int:
        """Call i, and its output copied aside when the reservoir takes
        it."""
        out = self.call(i)
        k = len(self.kept_calls)
        slot = i if i < k else int(self.schedule["check"][i])
        if slot < k:
            with record_function("bench.check"):
                self.kept[slot].copy_(out)
            self.kept_calls[slot] = i
        return self.n

    def free_program(self):
        self.painter = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, config: dict, numerics: str = "f32") -> list:
        """Each kept call's tiles' distances from the reference
        (``numerics``: the reference's precision), a tensor a call."""
        ref = ReferencePainter(config, self.device, numerics)
        errs = []
        for slot, i in enumerate(self.kept_calls):
            if i is None:
                continue
            tiles, zs, eps = self.inputs(i)
            errs.append(compare.tile_errors(self.kept[slot],
                                            ref.paint(tiles, zs, eps)))
        return errs


def run(cell: Cell) -> dict:
    device = torch.device(cell.device)
    tr = cell.traffic
    system = PaintSystem(cell, cell.seed, device)
    warm = tr["warmup_calls"]
    for i in range(warm):
        system.call(MAX_CALLS - 1 - i)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - cell.t_start
    traced_s = tr["traced_seconds"] if cell.trace else 0.0
    loop = lambda first, seconds: measure.closed_loop(
        system.issue, first, seconds, tr["in_flight"], device)
    window = loop(0, max(cell.seconds - traced_s, 1e-3))
    trace = None
    if cell.trace:
        trace = measure.traced(lambda: loop(window.calls, traced_s))
    calls = window.calls + (trace.calls if trace else 0)
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    system.free_program()
    errs = system.check(cell.config)
    checks = Checks(cell.workload["checks"])
    checks.add("tile_rel_l2", max(float(e.max()) for e in errs))
    limit = checks.limits["tile_rel_l2"]
    failed = sum(1 for e in errs if not float(e.max()) <= limit)
    return {"end_to_end": {
                "paint_tiles_per_s": window.units / window.seconds,
                "paint_call_p95_ms": measure.percentile(window.call_ms, 95),
                "setup_s": setup_s},
            "run": (Run(cell, device_kind(device), system.dtype, window, trace,
                        system.n) if trace else None),
            "attempted": calls, "failed": failed, "checks": checks,
            "memory_peak_bytes": peak}
