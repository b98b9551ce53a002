"""``utils/profiling.trace_kernels_in_ranges`` and the layer marks of
``scripts/cudnn_engines_torch.py``, on the CPU: which device kernels a
Chrome trace puts inside each marked host range, and the ranges a marked
module's forward and backward leave in a real ``torch.profiler`` trace."""
import importlib.util
import json
import os

import pytest
import torch

from baryon_painter_tpu_torch.utils.profiling import (TRACE_FILE,
                                                      device_trace,
                                                      trace_kernels_in_ranges)
from golden_utils import REPO


def _script():
    path = os.path.join(REPO, "scripts", "cudnn_engines_torch.py")
    spec = importlib.util.spec_from_file_location("cudnn_engines_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ev(cat, name, ts, dur=1, tid=1, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
          "tid": tid, "pid": 1}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


@pytest.fixture
def trace(tmp_path):
    events = [
        _ev("user_annotation", "layer fwd a", 10, 20),
        _ev("user_annotation", "layer bwd a", 50, 20, tid=2),
        _ev("user_annotation", "other", 10, 100),
        # inside fwd a, on its thread: two launches, runtime and driver
        _ev("cuda_runtime", "cudaLaunchKernel", 12, corr=1),
        _ev("cuda_driver", "cuLaunchKernelEx", 15, corr=2),
        # inside fwd a's time but on another thread: not fwd a's
        _ev("cuda_runtime", "cudaLaunchKernel", 16, tid=3, corr=3),
        # bwd a's, on its thread
        _ev("cuda_runtime", "cudaLaunchKernel", 60, tid=2, corr=4),
        # after every range
        _ev("cuda_runtime", "cudaLaunchKernel", 200, corr=5),
        # a runtime call that launched no kernel
        _ev("cuda_runtime", "cudaMemcpyAsync", 13, corr=6),
        _ev("kernel", "k_fwd1", 100, corr=1),
        _ev("kernel", "k_fwd2", 101, corr=2),
        _ev("kernel", "k_other_thread", 102, corr=3),
        _ev("kernel", "dgrad_engine", 103, corr=4),
        _ev("kernel", "k_late", 300, corr=5),
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    return str(path)


def test_kernels_in_ranges_by_thread_and_time(trace):
    assert trace_kernels_in_ranges(trace, "layer ") == {
        "layer fwd a": ["k_fwd1", "k_fwd2"],
        "layer bwd a": ["dgrad_engine"]}


def test_kernels_in_ranges_without_prefix(trace):
    got = trace_kernels_in_ranges(trace)
    assert got["other"] == ["k_fwd1", "k_fwd2"]
    assert set(got) == {"layer fwd a", "layer bwd a", "other"}


def test_marks_leave_forward_and_backward_ranges(tmp_path):
    """A marked conv's forward and backward ranges appear in a real trace
    (the CPU's: no device kernels, so each range lists none), and the
    hooks come off."""
    eng = _script()
    conv = torch.nn.Conv2d(2, 3, 3, padding=1)
    handles = eng.mark(conv, "c")
    x = torch.randn(1, 2, 8, 8, requires_grad=True)
    with device_trace(str(tmp_path)):
        conv(x).sum().backward()
    for h in handles:
        h.remove()
    got = trace_kernels_in_ranges(str(tmp_path / TRACE_FILE), eng.MARK)
    assert got == {"layer fwd c": [], "layer bwd c": []}
    assert not conv._forward_hooks and not conv._forward_pre_hooks
    assert not conv._backward_hooks and not conv._backward_pre_hooks
