"""The measured window and its trace.

``closed_loop`` offers one client's calls back to back, dispatched ahead
with at most ``in_flight`` calls queued on the device: it enqueues call i,
records a CUDA event behind it and then waits for call i - in_flight + 1's
event, so a slow call delays the next. A call's time is its completion
event minus the previous call's (the first call's is from the window's
start event): a stall counts in the call it delays. The window's length is
the host clock from its start to the synchronise that ends it, and it
holds all the calls issued in it.

``traced`` runs part of a window under ``torch.profiler`` with CUDA
activity alone (recording every host op as well slowed the host enough
to starve the device in the CVAE's paint calls) and digests the trace:
the device's busy time (the union of its kernels, copies and sets) within
the window's host-clock length, each device operation's time, and the
idle gaps between busy spans, each named after the CUDA runtime call the
host was in when the gap began (``host`` where it was in none: in
Python between calls).
"""
from __future__ import annotations

import bisect
import re
import time
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.profiler import record_function

__all__ = ["Window", "closed_loop", "Trace", "traced", "percentile"]


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))


@dataclass
class Window:
    calls: int = 0
    units: int = 0            # tiles or samples the calls completed
    seconds: float = 0.0      # host clock, start to the closing synchronise
    host_s: float = 0.0       # host time inside the calls (enqueueing)
    call_ms: list = field(default_factory=list)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def closed_loop(issue, first: int, seconds: float, in_flight: int,
                device) -> Window:
    """Calls ``issue(first)``, ``issue(first + 1)``, ... for ``seconds``;
    ``issue(i)`` enqueues call i and returns the units it computes."""
    cuda = device.type == "cuda"
    win = Window()
    _sync(device)
    stamp = (lambda: _event(device)) if cuda else time.perf_counter
    marks = [stamp()]
    pending = []
    t0 = time.perf_counter()
    i = first
    while time.perf_counter() - t0 < seconds:
        h0 = time.perf_counter()
        with record_function("bench.call"):
            win.units += issue(i)
        win.host_s += time.perf_counter() - h0
        marks.append(stamp())
        pending.append(marks[-1])
        if len(pending) >= in_flight:
            with record_function("bench.sync"):
                done = pending.pop(0)
                if cuda:
                    done.synchronize()
        i += 1
    with record_function("bench.sync"):
        _sync(device)
    win.seconds = time.perf_counter() - t0
    win.calls = i - first
    if cuda:
        win.call_ms = [a.elapsed_time(b) for a, b in zip(marks, marks[1:])]
    else:
        win.call_ms = [(b - a) * 1e3 for a, b in zip(marks, marks[1:])]
    return win


def _event(device):
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def _short(name: str) -> str:
    """A device operation's name without ``void``, an anonymous namespace
    and its argument list."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::",
                                                  "")
    return name.split("(")[0].strip()


def _kernel_id(name: str) -> str:
    """A device operation's function name: ``void f<T, 1>(args)`` -> f."""
    return _short(name).split("<")[0].strip()


@dataclass
class Trace:
    window_s: float
    busy_s: float
    ops: list        # (name, start_us, end_us) of device operations
    gaps: list       # (host span, seconds) of idle gaps, longest first
    calls: int       # calls issued inside the traced window

    def kernel_s(self, names) -> float:
        """Device seconds of the kernels whose function name is one of
        ``names``."""
        names = set(names)
        return sum(e - s for n, s, e in self.ops
                   if _kernel_id(n) in names) / 1e6

    def kernels_outside_s(self, names) -> float:
        """Device seconds of the kernels whose name is none of ``names``
        (copies and sets not counted)."""
        names = set(names)
        return sum(e - s for n, s, e in self.ops
                   if not n.startswith(("Memcpy", "Memset"))
                   and _kernel_id(n) not in names) / 1e6

    def top_ops(self, k: int = 10) -> list:
        by = {}
        for n, s, e in self.ops:
            key = _short(n)[:160]
            by[key] = by.get(key, 0.0) + (e - s) / 1e6
        return sorted(([n, t] for n, t in by.items()),
                      key=lambda r: -r[1])[:k]


def _union(spans):
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def traced(run_window) -> Trace:
    """``run_window()`` (a ``closed_loop`` call returning its ``Window``)
    under the profiler, digested."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    # the CPU's activity only where there is no card (the CPU tests)
    activity = (ProfilerActivity.CUDA if torch.cuda.is_available()
                else ProfilerActivity.CPU)
    with profile(activities=[activity]) as prof:
        win = run_window()
    ops, calls = [], []
    for ev in prof.events():
        s, e = ev.time_range.start, ev.time_range.end
        if ev.device_type == DeviceType.CUDA:
            ops.append((ev.name, s, e))
        elif ev.name.startswith("cuda"):
            calls.append((s, e, ev.name))
    busy = _union([(s, e) for _, s, e in ops])
    calls.sort()
    starts = [c[0] for c in calls]
    named = []
    for (_, s), (e, _) in zip(busy, busy[1:]):
        # the runtime call in progress when the device went idle
        k = bisect.bisect_right(starts, s) - 1
        inside = k >= 0 and calls[k][1] > s
        named.append([calls[k][2] if inside else "host", (e - s) / 1e6])
    named.sort(key=lambda g: -g[1])
    busy_s = sum(e - s for s, e in busy) / 1e6
    return Trace(window_s=win.seconds, busy_s=busy_s, ops=ops,
                 gaps=named[:10], calls=win.calls)
