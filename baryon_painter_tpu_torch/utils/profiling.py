"""Profiling and tracing hooks of the port.

Spans: named intervals of the painter's and the trainer's work, timed on
the card by two CUDA events at their bounds and on the host's clock::

    with profiling.span("paint", tiles=n):
        ...
    records = profiling.spans()     # after the caller's synchronise

A span records only while a ``torch.profiler`` is recording (any
profiler: the benchmark's CUDA-only window and ``device_trace`` alike);
otherwise ``span`` returns one shared object that does nothing, after one
check of the profiler's state. Its events go on the current stream of the
device it is given (``span(name, device=...)``), else of its parent's,
else of the current CUDA device; a CPU device times nothing on a card.
``per_call`` sums the spans of each paint call or training step.
Set-up spans (``setup_span``) run once a process and record always, on
the host's clock alone. Under ``device_trace`` every span is also opened
as a ``record_function`` range, so that the operator's Chrome trace
shows it.

Besides: ``device_trace``, a context manager around ``torch.profiler``
that writes a Chrome trace of the host and the card; readers of that
trace (``trace_kernel_counts``, ``trace_kernels_in_ranges``,
``trace_idle_by_range``); and the card's spec-sheet peaks, which
``smoke.py``'s bounds read.

The counterpart of ``baryon_painter_tpu/utils/profiling.py``. Its
``xla_cost`` is not ported: it parses an XLA executable's
``cost_analysis``, and its only callers are ``bench.py`` and
``scripts/roofline.py``, the JAX package's benchmark. The port counts
FLOPs and bytes analytically from shapes (``kernel_report.py``,
``smoke.k1_bound`` and its siblings); ``torch.utils.flop_counter`` would
not see the kernels, which are launched through ctypes.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import Dict, List, Optional

import torch

__all__ = ["span", "setup_span", "spans", "clear", "per_call",
           "SpanRecord",
           "SpanRecorder", "RECORDER", "device_trace", "trace_kernel_counts",
           "trace_kernels_in_ranges", "innermost_range",
           "trace_idle_by_range"]

# Peak dense bf16 FLOP/s and HBM bandwidth (B/s) of the H100 SXM, as
# ``torch.cuda.get_device_name()`` names it. Spec-sheet numbers (NVIDIA's
# data sheet, dense, without sparsity, at the full power limit), not
# measurements; a card set below its maximum power runs slower under load.
H100_SXM = "NVIDIA H100 80GB HBM3"
PEAK_FLOPS = {H100_SXM: 989e12}
PEAK_BW = {H100_SXM: 3.35e12}
# the H100 SXM's f32 rate on the CUDA cores (outside the tensor cores),
# the same data sheet
H100_F32_FLOPS = 67e12

# whether any profiler is recording on this thread
_profiler_on = torch._C._autograd._profiler_enabled


class SpanRecord:
    """One span: its ``name``, ``id``, its parent's id (``parent``, None at
    the top), the id of the top-level span it belongs to (``call``: every
    span of one paint call or training step shares it), ``attrs``, the
    host's Unix nanoseconds at its start and end (the clock the profiler
    stamps its events with), and, once ``spans()`` resolved it, its
    device milliseconds between its two CUDA events (``device_ms``; None
    for a span without events: on the CPU, or a set-up span)."""

    __slots__ = ("name", "id", "parent", "call", "attrs", "host_start_ns",
                 "host_end_ns", "device_ms", "_events", "_recorder",
                 "_range", "_device")

    def __init__(self, recorder, name, attrs, timed, device=None):
        self._recorder = recorder
        self.name = name
        self.attrs = attrs
        self.id = self.parent = self.call = None
        self.host_start_ns = self.host_end_ns = None
        self.device_ms = None
        # whether to time on the card; on entering, the (start, end) CUDA
        # events and the device index they time on; () once they went
        # back to the pool
        self._events = timed
        # the device given, else its parent's (None: none given)
        self._device = device
        self._range = None

    @property
    def host_ms(self) -> Optional[float]:
        if self.host_end_ns is None:
            return None
        return (self.host_end_ns - self.host_start_ns) / 1e6

    def __enter__(self):
        self._recorder._enter(self)
        return self

    def __exit__(self, *exc):
        self._recorder._exit(self)
        return False


class _NoSpan:
    """What ``span`` returns while no profiler records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_OFF = _NoSpan()


class SpanRecorder:
    """Keeps the last ``limit`` spans in memory and counts those it dropped
    (``dropped``). ``ranges``: also open each span as a profiler range."""

    def __init__(self, limit: int = 65_536):
        self._records = collections.deque(maxlen=limit)
        self.dropped = 0
        self.ranges = False
        self._ids = itertools.count(1)
        self._local = threading.local()
        self._lock = threading.Lock()
        # reusable CUDA events by device index
        self._pool: Dict[int, list] = collections.defaultdict(list)

    def open(self, name: str, attrs: dict, timed: bool = True,
             device=None) -> SpanRecord:
        """A span to enter; ``timed``: time it with CUDA events too, where
        this process uses CUDA, on ``device`` (module docstring)."""
        return SpanRecord(self, name, attrs,
                          timed and torch.cuda.is_initialized(), device)

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def _event(self, index: int):
        with self._lock:
            if self._pool[index]:
                return self._pool[index].pop()
        return torch.cuda.Event(enable_timing=True)

    @staticmethod
    def _cuda_index(device) -> Optional[int]:
        """The index of the CUDA device a span given ``device`` times on
        (the current one where none was given), or None."""
        if device is None:
            return torch.cuda.current_device()
        device = torch.device(device)
        if device.type != "cuda":
            return None
        return (device.index if device.index is not None
                else torch.cuda.current_device())

    def _enter(self, rec: SpanRecord):
        stack = self._stack()
        parent = stack[-1] if stack else None
        rec.id = next(self._ids)
        rec.parent = parent.id if parent is not None else None
        rec.call = parent.call if parent is not None else rec.id
        with self._lock:
            if len(self._records) == self._records.maxlen:
                self.dropped += 1
            self._records.append(rec)
        stack.append(rec)
        if self.ranges:
            rec._range = torch.autograd.profiler.record_function(rec.name)
            rec._range.__enter__()
        if rec._device is None and parent is not None:
            rec._device = parent._device
        index = self._cuda_index(rec._device) if rec._events else None
        rec.host_start_ns = time.time_ns()
        if index is None:
            rec._events = False
        else:
            rec._events = (self._event(index), self._event(index), index)
            rec._events[0].record(torch.cuda.current_stream(index))

    def _exit(self, rec: SpanRecord):
        if rec._events:
            rec._events[1].record(torch.cuda.current_stream(rec._events[2]))
        rec.host_end_ns = time.time_ns()
        if rec._range is not None:
            rec._range.__exit__(None, None, None)
            rec._range = None
        self._stack().remove(rec)

    def records(self) -> List[SpanRecord]:
        """The kept spans in the order they started, each ended one's
        device times resolved (which waits for its end event); the events
        of resolved spans go back to the pool."""
        with self._lock:
            recs = list(self._records)
        for rec in recs:
            if not rec._events or rec.host_end_ns is None:
                continue
            start, end, index = rec._events
            end.synchronize()
            rec.device_ms = start.elapsed_time(end)
            rec._events = ()
            with self._lock:
                self._pool[index].extend((start, end))
        return recs

    def clear(self):
        with self._lock:
            self._records.clear()
            self.dropped = 0


RECORDER = SpanRecorder()


def span(name: str, device=None, **attrs):
    """A span of the hot path (module docstring): recorded, with CUDA
    events on ``device``'s current stream where the process uses CUDA,
    only while a profiler records."""
    if not _profiler_on():
        return _OFF
    return RECORDER.open(name, attrs, device=device)


def setup_span(name: str, **attrs) -> SpanRecord:
    """A set-up span: recorded always, on the host's clock alone."""
    return RECORDER.open(name, attrs, timed=False)


def spans() -> List[SpanRecord]:
    """The recorded spans, resolved (``SpanRecorder.records``)."""
    return RECORDER.records()


def clear():
    """Forget the recorded spans and the count of those dropped."""
    RECORDER.clear()


def per_call(root: str, names, calls: int, clock: str = "device",
             less=()) -> Optional[float]:
    """The milliseconds each top-level ``root`` span (a paint call, a
    training step) spends in its spans ``names`` less its spans ``less``,
    on the card's clock (``clock="device"``, between the CUDA events) or
    the host's (``"host"``), averaged over the recorded ``root`` spans.
    None where they are not ``calls`` in number, where none of ``names``
    was recorded in them, or where one of the spans has no such time."""
    recs = spans()
    roots = {r.id for r in recs if r.name == root and r.parent is None}
    if not roots or len(roots) != calls:
        return None
    ms = "device_ms" if clock == "device" else "host_ms"
    got = [getattr(r, ms) for r in recs if r.call in roots
           and r.name in names]
    sub = [getattr(r, ms) for r in recs if r.call in roots
           and r.name in less]
    if not got or None in got + sub:
        return None
    return (sum(got) - sum(sub)) / len(roots)


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(log_dir: Optional[str]):
    """Wrap a region in a ``torch.profiler`` trace of the host and, where
    there is a card, its CUDA activity (no-op when ``log_dir`` is None).
    Writes a Chrome trace, ``log_dir/trace.json``, which chrome://tracing
    or Perfetto opens. CUPTI records the kernels launched through ctypes
    too, under their symbol names (``head_chain_fwd_kernel``, ...). Spans
    entered inside are ranges of the trace as well."""
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    ranges, RECORDER.ranges = RECORDER.ranges, True
    try:
        with profile(activities=activities) as prof:
            try:
                yield prof
            finally:
                if torch.cuda.is_available():
                    torch.cuda.synchronize()
    finally:
        RECORDER.ranges = ranges
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def _trace_events(path: str) -> list:
    with open(path) as f:
        return [ev for ev in json.load(f).get("traceEvents", [])
                if ev.get("ph") == "X"]


def trace_kernel_counts(path: str, names) -> Dict[str, int]:
    """The device kernels of a Chrome trace (``device_trace``'s file) whose
    name contains each of ``names``: {name: launches}."""
    counts = {n: 0 for n in names}
    for ev in _trace_events(path):
        if ev.get("cat") != "kernel":
            continue
        for n in names:
            if n in ev.get("name", ""):
                counts[n] += 1
    return counts


def _launches(events, correlated) -> list:
    """The runtime and driver calls of ``events`` whose correlation id is
    among ``correlated``, by start."""
    return sorted(
        (ev for ev in events
         if ev.get("cat") in ("cuda_runtime", "cuda_driver")
         and ev.get("args", {}).get("correlation") in correlated),
        key=lambda ev: ev["ts"])


def trace_kernels_in_ranges(path: str, prefix: str = "") -> Dict[str, list]:
    """The device kernels launched inside each host range of a Chrome trace
    (``device_trace``'s file) whose name starts with ``prefix`` (a
    ``torch.profiler.record_function`` label): {range name: [kernel names
    in launch order]}. A kernel belongs to a range when the runtime or
    driver call that launched it (matched by correlation id) lies inside
    the range on the range's thread."""
    events = _trace_events(path)
    kernels = {ev["args"]["correlation"]: ev["name"] for ev in events
               if ev.get("cat") == "kernel"
               and "correlation" in ev.get("args", {})}
    launches = _launches(events, kernels)
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


_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def innermost_range(events, prefix: str = ""):
    """``at(tid, ts)``: the name of the innermost range among the Chrome
    trace ``events`` whose name starts with ``prefix`` open on thread
    ``tid`` at ``ts``; where that thread has none open (autograd's device
    threads launch a backward's work while the caller waits inside its
    span), the innermost open on any thread; ``""`` where none is."""
    ranges = collections.defaultdict(list)
    for r in events:
        if (r.get("cat") == "user_annotation"
                and r.get("name", "").startswith(prefix)):
            ranges[r.get("tid")].append((r["ts"], r["ts"] + r.get("dur", 0),
                                         r["name"]))
    for rs in ranges.values():
        rs.sort()
    starts = {tid: [r[0] for r in rs] for tid, rs in ranges.items()}

    def on(tid, t):
        rs = ranges.get(tid, ())
        for k in range(bisect.bisect_right(starts.get(tid, ()), t) - 1,
                       -1, -1):
            if rs[k][1] > t:
                return rs[k]
        return None

    def at(tid, t):
        r = on(tid, t)
        if r is None:
            # the latest to start is the innermost
            r = max(filter(None, (on(other, t) for other in ranges)),
                    default=None)
        return "" if r is None else r[2]

    return at


def trace_idle_by_range(path: str, prefix: str = "") -> Dict[str, dict]:
    """The device's idle gaps of a Chrome trace (``device_trace``'s file),
    each named by the innermost host range whose name starts with
    ``prefix`` open on the launching thread when the gap began
    (``innermost_range``): {range name: {"gaps": count, "idle_s":
    seconds}}, the most idle first; ``""`` names the gaps that began
    outside every such range. A gap lies between two busy spans of the
    device (the union of its kernels, copies and sets); its launching
    thread is the one whose runtime call launched the operation that ends
    it."""
    events = _trace_events(path)
    ops = sorted((ev for ev in events if ev.get("cat") in _DEVICE_CATS),
                 key=lambda ev: ev["ts"])
    thread = {ev["args"]["correlation"]: ev.get("tid")
              for ev in _launches(events, {
                  op.get("args", {}).get("correlation") for op in ops})}
    innermost = innermost_range(events, prefix)

    out: Dict[str, dict] = {}
    busy_end = None
    for op in ops:
        s, e = op["ts"], op["ts"] + op.get("dur", 0)
        if busy_end is not None and s > busy_end:
            tid = thread.get(op.get("args", {}).get("correlation"))
            name = innermost(tid, busy_end)
            row = out.setdefault(name, {"gaps": 0, "idle_s": 0.0})
            row["gaps"] += 1
            row["idle_s"] += (s - busy_end) / 1e6
        busy_end = e if busy_end is None else max(busy_end, e)
    return dict(sorted(out.items(), key=lambda kv: -kv[1]["idle_s"]))
