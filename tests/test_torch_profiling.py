"""The port's ``utils/profiling.py`` against the JAX package's.

``StepTimer.summary`` gives the JAX package's summary on the same times,
exactly; the peak lookup keeps the JAX package's precedence (the
environment's override first, then the exact name, then the longest
prefix) on the card's names; ``device_trace`` writes a Chrome trace on the
CPU, and ``trace_kernel_counts`` counts a trace's device kernels by name.
"""
import json
import math

import numpy as np
import pytest
import torch

from baryon_painter_tpu.utils import profiling as jprof
from baryon_painter_tpu_torch.utils import profiling as tprof


@pytest.mark.parametrize("skip_first", [0, 1, 3])
@pytest.mark.parametrize("n", [0, 1, 5])
def test_step_timer_summary_matches_jax(skip_first, n):
    times = list(np.random.default_rng(n).uniform(1e-3, 5e-2, n))
    got, want = tprof.StepTimer(skip_first), jprof.StepTimer(skip_first)
    got.times, want.times = list(times), list(times)
    assert got.summary() == want.summary()


def test_step_timer_times_its_block():
    t = tprof.StepTimer(skip_first=1)
    for _ in range(3):
        with t:
            pass
    s = t.summary()
    assert s["n"] == 2 and s["max_ms"] >= s["p50_ms"] >= 0


@pytest.mark.parametrize("name, flops, bw", [
    ("NVIDIA H100 80GB HBM3", 989e12, 3.35e12),
    # a longer name of the same part takes the longest prefix
    ("NVIDIA H100 80GB HBM3 MIG 7g.80gb", 989e12, 3.35e12),
    ("cpu", math.nan, math.nan)])
def test_peak_lookup(name, flops, bw):
    got = (tprof.device_peak_flops(name), tprof.device_peak_bandwidth(name))
    for g, w in zip(got, (flops, bw)):
        assert (math.isnan(g) and math.isnan(w)) or g == w


def test_peak_lookup_on_the_cpu_device():
    assert math.isnan(tprof.device_peak_flops(torch.device("cpu")))


def test_peak_env_overrides_take_precedence(monkeypatch):
    monkeypatch.setenv("BPT_PEAK_FLOPS", "1e15")
    monkeypatch.setenv("BPT_PEAK_BW", "2e12")
    assert tprof.device_peak_flops("NVIDIA H100 80GB HBM3") == 1e15
    assert tprof.device_peak_bandwidth("unknown") == 2e12
    # the JAX package's precedence is the same
    assert jprof._lookup({"x": 1.0}, "x", "BPT_PEAK_FLOPS") == 1e15


def test_device_trace_writes_a_trace_on_the_cpu(tmp_path):
    with tprof.device_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    path = tmp_path / "trace" / tprof.TRACE_FILE
    events = json.loads(path.read_text())["traceEvents"]
    assert any("matmul" in ev.get("name", "") or "mm" in ev.get("name", "")
               for ev in events)
    with tprof.device_trace(None):
        pass


def test_trace_kernel_counts(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": [
        {"ph": "X", "cat": "kernel", "name": "void head_fwd_kernel<float>"},
        {"ph": "X", "cat": "kernel", "name": "void head_fwd_kernel<bf16>"},
        {"ph": "X", "cat": "kernel", "name": "gather_tiles_kernel"},
        {"ph": "X", "cat": "cpu_op", "name": "head_fwd_kernel"}]}))
    assert tprof.trace_kernel_counts(str(path), [
        "head_fwd_kernel", "gather_tiles_kernel", "head_bwd_kernel"]) == {
        "head_fwd_kernel": 2, "gather_tiles_kernel": 1, "head_bwd_kernel": 0}
