"""Profiling and tracing hooks of the port.

A step timer with summary statistics, a context manager around
``torch.profiler`` so that any training or painting region can write a
Chrome trace of the host and the card, and the card's peak rates.

The counterpart of ``baryon_painter_tpu/utils/profiling.py``. Its
``xla_cost`` is not ported: it parses an XLA executable's
``cost_analysis``, and its only callers are ``bench.py`` and
``scripts/roofline.py``, the JAX package's benchmark. The port counts
FLOPs and bytes analytically from shapes (``kernel_report.py``,
``smoke.k1_bound`` and its siblings); ``torch.utils.flop_counter`` would
not see the kernels, which are launched through ctypes.
"""
from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import numpy as np

__all__ = ["StepTimer", "device_trace", "device_peak_flops",
           "device_peak_bandwidth", "trace_kernel_counts"]

# Peak dense bf16 FLOP/s and HBM bandwidth (B/s) by
# ``torch.cuda.get_device_name()``. Spec-sheet numbers (NVIDIA's data
# sheets, dense, without sparsity, at the full power limit), not
# measurements; a card set below its maximum power runs slower under load.
# BPT_PEAK_FLOPS / BPT_PEAK_BW override them. The lookup and its overrides
# are the JAX module's API and have no caller in the port: the smoke's
# bounds read the H100 SXM's constants below directly.
H100_SXM = "NVIDIA H100 80GB HBM3"
PEAK_FLOPS = {H100_SXM: 989e12}
PEAK_BW = {H100_SXM: 3.35e12}
# the H100 SXM's f32 rate on the CUDA cores (outside the tensor cores),
# the same data sheet
H100_F32_FLOPS = 67e12


def _lookup(table: Dict[str, float], kind: str, env: str) -> float:
    if os.environ.get(env):
        return float(os.environ[env])
    if kind in table:
        return table[kind]
    # prefix match; prefer the LONGEST key, so that a short key cannot
    # shadow a longer one it is a prefix of
    best = max((k for k in table if kind.startswith(k)),
               key=len, default=None)
    if best is not None:
        return table[best]
    return float("nan")


def _device_name(device) -> str:
    if isinstance(device, str) and not device.startswith(("cuda", "cpu")):
        return device
    import torch
    device = torch.device(device if device is not None else "cuda")
    if device.type != "cuda":
        return device.type
    return torch.cuda.get_device_name(device)


def device_peak_flops(device=None) -> float:
    """Dense bf16 peak FLOP/s of a CUDA device (a ``torch.device``, an index
    string such as ``"cuda:0"``, or a device name as
    ``torch.cuda.get_device_name`` gives it); NaN if unknown. Override with
    BPT_PEAK_FLOPS."""
    return _lookup(PEAK_FLOPS, _device_name(device), "BPT_PEAK_FLOPS")


def device_peak_bandwidth(device=None) -> float:
    """HBM bandwidth in B/s of a CUDA device (as ``device_peak_flops``);
    override with BPT_PEAK_BW."""
    return _lookup(PEAK_BW, _device_name(device), "BPT_PEAK_BW")


class StepTimer:
    """Wall-clock per-step timing with percentile summaries.

    The host clock stops when the block ends: a caller that times work on
    the card synchronises inside the block (``torch.cuda.synchronize()``),
    as the JAX package's callers block on their results inside it."""

    def __init__(self, skip_first: int = 1):
        self.times: List[float] = []
        self.skip_first = skip_first
        self._t0: Optional[float] = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.times.append(time.perf_counter() - self._t0)
        return False

    def summary(self) -> Dict[str, float]:
        t = np.asarray(self.times[self.skip_first:] or self.times)
        if len(t) == 0:
            return {"n": 0, "mean_ms": 0.0, "p50_ms": 0.0, "p95_ms": 0.0,
                    "max_ms": 0.0}
        return {"n": len(t),
                "mean_ms": float(t.mean() * 1e3),
                "p50_ms": float(np.percentile(t, 50) * 1e3),
                "p95_ms": float(np.percentile(t, 95) * 1e3),
                "max_ms": float(t.max() * 1e3)}


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """Wrap a region in a ``torch.profiler`` trace of the host and, where
    there is a card, its CUDA activity (no-op when ``log_dir`` is None).
    Writes a Chrome trace, ``log_dir/trace.json``, which chrome://tracing
    or Perfetto opens. CUPTI records the kernels launched through ctypes
    too, under their symbol names (``head_chain_fwd_kernel``, ...)."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    try:
        with profile(activities=activities) as prof:
            try:
                yield prof
            finally:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
    finally:
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def trace_kernel_counts(path: str, names) -> Dict[str, int]:
    """The device kernels of a Chrome trace (``device_trace``'s file) whose
    name contains each of ``names``: {name: launches}."""
    import json
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    counts = {n: 0 for n in names}
    for ev in events:
        if ev.get("cat") != "kernel" or ev.get("ph") != "X":
            continue
        for n in names:
            if n in ev.get("name", ""):
                counts[n] += 1
    return counts


def trace_kernels_in_ranges(path: str, prefix: str = "") -> Dict[str, list]:
    """The device kernels launched inside each host range of a Chrome trace
    (``device_trace``'s file) whose name starts with ``prefix`` (a
    ``torch.profiler.record_function`` label): {range name: [kernel names
    in launch order]}. A kernel belongs to a range when the runtime or
    driver call that launched it (matched by correlation id) lies inside
    the range on the range's thread."""
    import json
    with open(path) as f:
        events = [ev for ev in json.load(f).get("traceEvents", [])
                  if ev.get("ph") == "X"]
    kernels = {ev["args"]["correlation"]: ev["name"] for ev in events
               if ev.get("cat") == "kernel"
               and "correlation" in ev.get("args", {})}
    launches = sorted(
        (ev for ev in events
         if ev.get("cat") in ("cuda_runtime", "cuda_driver")
         and ev.get("args", {}).get("correlation") in kernels),
        key=lambda ev: ev["ts"])
    out = {}
    for r in events:
        if (r.get("cat") != "user_annotation"
                or not r.get("name", "").startswith(prefix)):
            continue
        lo, hi = r["ts"], r["ts"] + r.get("dur", 0)
        out.setdefault(r["name"], []).extend(
            kernels[ev["args"]["correlation"]] for ev in launches
            if ev.get("tid") == r.get("tid") and lo <= ev["ts"] <= hi)
    return out
