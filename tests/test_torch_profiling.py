"""The port's ``utils/profiling.py``: spans, the Chrome trace and its
readers, and the benchmark's readers of the spans.

Off a profiler a span is one shared object that records nothing, at under
a microsecond; under a CPU ``torch.profiler`` the painters' and the
trainer's spans form their trees (names, parents, one call id a call, no
device times on the CPU); set-up spans record always; the recorder keeps
its bound and counts what it dropped; ``device_trace`` shows the spans as
ranges, stamped on the profiler's clock; ``trace_idle_by_range`` names a
synthetic trace's idle gaps; and each ``benchmark/metrics`` reader of the
spans reads synthetic records, and None where the calls do not match or
the program records no spans.
"""
import importlib.util
import json
import timeit
from pathlib import Path
from types import SimpleNamespace
from unittest import mock

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from baryon_painter_tpu_torch.data.dataset import (BahamasTileDataset,
                                                   load_file_info)
from baryon_painter_tpu_torch.data.synthetic import make_synthetic_stacks
from baryon_painter_tpu_torch.models.cgan import CGANGenerator
from baryon_painter_tpu_torch.models.cvae import (CVAE,
                                                  fiducial_cvae_architecture)
from baryon_painter_tpu_torch.ops import _build
from baryon_painter_tpu_torch.painter import CGANPainter, CVAEPainter
from baryon_painter_tpu_torch.train.cgan import CGANTrainConfig, CGANTrainer
from baryon_painter_tpu_torch.train.trainer import CVAETrainer, TrainConfig
from baryon_painter_tpu_torch.transforms import RangeCompress
from baryon_painter_tpu_torch.utils import profiling as tprof

ROOT = Path(__file__).resolve().parent.parent
TILE = 32
BATCH = 2


@pytest.fixture(autouse=True)
def fresh_recorder():
    tprof.clear()
    yield
    tprof.clear()


def _tree(recs):
    """(name, parent's name) of each span, in start order."""
    by_id = {r.id: r.name for r in recs}
    return [(r.name, by_id.get(r.parent)) for r in recs]


# --------------------------------------------------------------------- #
# the off path

@pytest.mark.parametrize("name, attrs", [
    ("paint", {"tiles": 16}), ("paint.decode", {}),
    ("train.upload", {"bytes": 216})])
def test_off_path_records_nothing_under_a_microsecond(name, attrs):
    assert not torch._C._autograd._profiler_enabled()
    assert tprof.span(name, **attrs) is tprof.span("other")

    def one():
        with tprof.span(name, **attrs):
            pass

    # the least of many samples, each far shorter than a scheduler's time
    # slice: the other processes of a loaded host lengthen some, not all
    n = 200
    per_span_s = min(timeit.repeat(one, number=n, repeat=200)) / n
    assert per_span_s <= 1e-6, per_span_s
    assert tprof.spans() == [] and tprof.RECORDER.dropped == 0


# --------------------------------------------------------------------- #
# the spans of a paint call and of a training step, under a CPU profiler

@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stacks"))
    info = make_synthetic_stacks(root, n_stack=2, n_grid=2 * TILE,
                                 redshifts=(0.0, 1.0), seed=0)
    return BahamasTileDataset(
        files=load_file_info(info), root_path=root, n_tile=2,
        tile_permutations=True,
        transforms={f: RangeCompress("shift-log", 4.0)
                    for f in ("dm", "pressure")})


@pytest.fixture(scope="module")
def trainer(dataset):
    model = CVAE(fiducial_cvae_architecture(TILE, n_res_blocks=1),
                 fused_heads=True)
    return CVAETrainer(model, dataset, config=TrainConfig(batch_size=BATCH),
                       device_data=True, device="cpu")


@pytest.fixture(scope="module")
def painters(trainer, dataset):
    cgan = CGANTrainer(dataset, generator=CGANGenerator(n_res_blocks=1,
                                                        spectral_norm=True),
                       config=CGANTrainConfig(batch_size=BATCH),
                       device="cpu")
    return {"cvae": CVAEPainter.from_trainer(trainer),
            "cgan": CGANPainter.from_trainer(cgan)}


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]):
        assert torch._C._autograd._profiler_enabled()
        fn()
    return tprof.spans()


PAINT_TREES = {
    "cvae": [("paint", None), ("paint.transform", "paint"),
             ("paint.prior", "paint"), ("paint.decode", "paint"),
             ("decode.heads", "paint.decode"), ("paint.inverse", "paint")],
    "cgan": [("paint", None), ("paint.transform", "paint"),
             ("paint.decode", "paint"), ("paint.inverse", "paint")]}


@pytest.mark.parametrize("kind", ["cvae", "cgan"])
def test_paint_call_span_tree(painters, kind):
    tiles = np.random.default_rng(0).uniform(0, 2, (3, TILE, TILE))
    zs = np.zeros(3, np.float32)
    painter = painters[kind]
    recs = _profiled(lambda: [painter.paint_batch(tiles, zs)
                              for _ in range(2)])
    tree = PAINT_TREES[kind]
    assert _tree(recs) == tree + tree
    calls = [r.call for r in recs]
    first = recs[0].id
    second = recs[len(tree)].id
    assert calls == [first] * len(tree) + [second] * len(tree)
    assert recs[0].attrs == {"tiles": 3}
    for r in recs:
        assert r.device_ms is None
        assert 0 <= r.host_ms and r.host_start_ns >= recs[0].host_start_ns
    # a call's children lie inside it on the host's clock
    for r in recs[1:len(tree)]:
        assert recs[0].host_start_ns <= r.host_start_ns
        assert r.host_end_ns <= recs[0].host_end_ns


TRAIN_TREES = {
    # the CPU cache gathers with K2's plain version: one upload, the
    # dihedral's digits; the second ``train.batch`` is ``_prepare``'s
    "step_indices": [("train.step", None), ("train.batch", "train.step"),
                     ("train.upload", "train.batch"),
                     ("train.batch", "train.step"),
                     ("train.forward", "train.step"),
                     ("decode.heads", "train.forward"),
                     ("train.backward", "train.step"),
                     ("train.optimizer", "train.step")],
    "step": [("train.step", None), ("train.batch", "train.step"),
             ("train.batch", "train.step"),
             ("train.forward", "train.step"),
             ("decode.heads", "train.forward"),
             ("train.backward", "train.step"),
             ("train.optimizer", "train.step")]}


@pytest.mark.parametrize("path", ["step_indices", "step"])
def test_training_step_span_tree(trainer, dataset, path):
    idx = dataset.sample_indices(np.random.default_rng(1), BATCH)
    if path == "step_indices":
        step = lambda: trainer.step_indices(idx, 1e-4)
    else:
        step = lambda: trainer.step(dataset.get_raw_batch(idx), 1e-4)
    recs = _profiled(step)
    assert _tree(recs) == TRAIN_TREES[path]
    assert {r.call for r in recs} == {recs[0].id}
    assert recs[0].attrs == {"samples": BATCH}
    if path == "step_indices":
        upload = recs[2]
        assert upload.attrs == {"bytes": BATCH * 9 * 4}
    assert all(r.device_ms is None for r in recs)


# --------------------------------------------------------------------- #
# set-up spans

def test_setup_spans_of_a_painter_from_its_checkpoint(painters, tmp_path):
    base = str(tmp_path / "model")
    painters["cvae"].save_state_to_file(base)
    CVAEPainter(base, device="cpu")
    recs = tprof.spans()
    assert _tree(recs) == [("setup.checkpoint", None), ("setup.model", None)]
    assert all(r.host_ms > 0 and r.device_ms is None for r in recs)


def test_setup_spans_of_a_trainer(dataset):
    model = CVAE(fiducial_cvae_architecture(TILE, n_res_blocks=1))
    CVAETrainer(model, dataset, device_data=True, device="cpu")
    assert _tree(tprof.spans()) == [("setup.trainer", None),
                                    ("setup.stacks", None)]


@pytest.mark.parametrize("seconds, built", [(0.0, 0), (12.5, 1)])
def test_setup_span_of_the_library_says_whether_it_was_built(
        monkeypatch, seconds, built):
    lib = mock.MagicMock()
    monkeypatch.setattr(_build, "build_library",
                        lambda: {"path": "libbpt.so", "seconds": seconds})
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: lib)
    assert _build.load_library.__wrapped__() is lib
    (rec,) = tprof.spans()
    assert rec.name == "setup.library" and rec.attrs == {"built": built}


# --------------------------------------------------------------------- #
# the bound

@pytest.mark.parametrize("limit, n", [(1, 3), (4, 10), (7, 7)])
def test_recorder_keeps_its_bound_and_counts_what_it_dropped(limit, n):
    rec = tprof.SpanRecorder(limit=limit)
    for i in range(n):
        with rec.open(f"s{i}", {"i": i}, timed=False):
            pass
    kept = rec.records()
    assert len(kept) == min(n, limit) and rec.dropped == n - len(kept)
    assert [r.attrs["i"] for r in kept] == list(range(n - len(kept), n))
    rec.clear()
    assert rec.records() == [] and rec.dropped == 0


# --------------------------------------------------------------------- #
# the device a span times on, with a stand-in for CUDA

class _Event:
    def __init__(self, enable_timing):
        assert enable_timing
        self.streams = []

    def record(self, stream):
        self.streams.append(stream)

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return 1.5


@pytest.fixture
def fake_cuda(monkeypatch):
    """CUDA in use, current device 3; a stream is ("stream", index)."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 3)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda index: ("stream", index))
    monkeypatch.setattr(torch.cuda, "Event", _Event)


@pytest.mark.parametrize("device, index", [
    (None, 3), ("cuda", 3), ("cuda:1", 1), (torch.device("cuda", 2), 2),
    ("cpu", None), (torch.device("cpu"), None)])
def test_span_and_its_children_time_on_the_stream_of_its_device(
        fake_cuda, device, index):
    rec = tprof.SpanRecorder()
    with rec.open("paint", {}, device=device) as outer:
        with rec.open("paint.decode", {}) as inner:
            events = [e for r in (outer, inner)
                      for e in (r._events or ())[:2]]
    want = None if index is None else ("stream", index)
    if index is None:
        assert events == []
    else:
        assert [e.streams for e in events] == [[want]] * 4
    assert [r.device_ms for r in rec.records()] == (
        [None, None] if index is None else [1.5, 1.5])
    if index is not None:
        assert rec._pool[index] and all(not rec._pool[k] for k in rec._pool
                                        if k != index)


def test_pooled_events_stay_with_their_device(fake_cuda):
    rec = tprof.SpanRecorder()
    with rec.open("paint", {}, device="cuda:1") as first:
        events = set(first._events[:2])
    rec.records()
    with rec.open("paint", {}, device="cuda:2") as other:
        assert not events & set(other._events[:2])
    with rec.open("paint", {}, device="cuda:1") as again:
        assert set(again._events[:2]) == events


# --------------------------------------------------------------------- #
# the operator's trace

def test_spans_are_ranges_of_a_cpu_device_trace(painters, tmp_path):
    tiles = np.ones((2, TILE, TILE), np.float32)
    with tprof.device_trace(str(tmp_path)):
        for _ in range(2):
            painters["cvae"].paint_batch(tiles, np.zeros(2, np.float32))
    assert not tprof.RECORDER.ranges
    with open(tmp_path / tprof.TRACE_FILE) as f:
        trace = json.load(f)
    base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
    ranges = {}
    for ev in sorted((ev for ev in trace["traceEvents"]
                      if ev.get("cat") == "user_annotation"),
                     key=lambda ev: ev["ts"]):
        ranges.setdefault(ev["name"], []).append(ev)
    recs = tprof.spans()
    assert {k: len(v) for k, v in ranges.items()} == {
        name: 2 for name, _ in PAINT_TREES["cvae"]}
    # the recorder's stamps and the profiler's ranges share one clock: in
    # the second call (the first pays the profiler's set-up of its first
    # range), a span's stamps lie within a millisecond of its range's
    second = [r for r in recs if r.call == recs[-1].call]
    assert len(second) == len(PAINT_TREES["cvae"])
    for r in second:
        ev = ranges[r.name][1]
        assert abs(r.host_start_ns / 1e3 - (ev["ts"] + base_us)) < 1e3
        assert abs(r.host_end_ns / 1e3 - (ev["ts"] + ev["dur"] + base_us)
                   ) < 1e3


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


def _x(cat, name, ts, dur, tid=1, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
          "tid": tid, "pid": 1}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _launched(name, ts, dur, corr, tid=1, cat="kernel"):
    """A device operation and the runtime call on ``tid`` that launched
    it."""
    return [_x("cuda_runtime", "cudaLaunchKernel", ts - 5, 2, tid, corr),
            _x(cat, name, ts, dur, tid=7, corr=corr)]


# the host: a step (0-1000) holding an upload (100-300) and a forward
# (300-900) holding the heads (600-700), on thread 1; thread 2 has its
# own range (0-1000). The device: busy 0-100, 150-250, 320-400, 650-660
# (a copy) and 950-990, launched by thread 1 but the fourth (thread 2).
SYNTHETIC = (
    [_x("user_annotation", "train.step", 0, 1000),
     _x("user_annotation", "train.upload", 100, 200),
     _x("user_annotation", "train.forward", 300, 600),
     _x("user_annotation", "decode.heads", 600, 100),
     _x("user_annotation", "other", 0, 1000, tid=2)]
    + _launched("k0", 0, 100, 1) + _launched("k1", 150, 100, 2)
    + _launched("k2", 320, 80, 3) + _launched("k2b", 330, 20, 4)
    + _launched("Memcpy HtoD", 650, 10, 5, tid=2, cat="gpu_memcpy")
    + _launched("k3", 950, 40, 6))


@pytest.mark.parametrize("prefix, want", [
    # gaps 100-150 (upload), 250-320 (upload), 400-650 (forward, but the
    # copy after it was launched from thread 2: "other"), 660-950 (heads
    # at 660, on thread 1)
    ("", {"other": (1, 250e-6), "decode.heads": (1, 290e-6),
          "train.upload": (2, 120e-6)}),
    # thread 2 has no "train." range: its copy's gap takes thread 1's
    ("train.", {"train.step": (0, 0.0), "train.forward": (2, 540e-6),
                "train.upload": (2, 120e-6)}),
    ("decode.", {"decode.heads": (1, 290e-6), "": (3, 370e-6)}),
    ("none.", {"": (4, 660e-6)})])
def test_trace_idle_by_range_names_each_gap(tmp_path, prefix, want):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": SYNTHETIC}))
    got = tprof.trace_idle_by_range(str(path), prefix)
    want = {k: v for k, v in want.items() if v[0]}
    assert set(got) == set(want)
    for name, (gaps, idle_s) in want.items():
        assert got[name]["gaps"] == gaps
        assert got[name]["idle_s"] == pytest.approx(idle_s)
    idle = [row["idle_s"] for row in got.values()]
    assert idle == sorted(idle, reverse=True)


# --------------------------------------------------------------------- #
# the benchmark's readers of the spans

def _reader(name):
    path = ROOT / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "span_metric_" + name.replace(".", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _record(name, id_, parent, call, host_ms, device_ms):
    r = tprof.SpanRecord(None, name, {}, False)
    r.id, r.parent, r.call = id_, parent, call
    r.host_start_ns, r.host_end_ns = 0, int(host_ms * 1e6)
    r.device_ms = device_ms
    return r


def _calls(root, children, n):
    """n calls: the root span, then ``children`` = [(name, parent index or
    None for the root, host ms, device ms)], the numbers scaled by the
    call's index (1, 2, ...)."""
    recs, next_id = [], 1
    for k in range(1, n + 1):
        call = next_id
        ids = [call]
        recs.append(_record(root, call, None, call, 50.0 * k, 60.0 * k))
        next_id += 1
        for name, parent, host, dev in children:
            pid = call if parent is None else ids[parent]
            recs.append(_record(name, next_id, pid, call, host * k,
                                dev and dev * k))
            ids.append(next_id)
            next_id += 1
    return recs


PAINT = [("paint.transform", None, 0.5, 1.0), ("paint.prior", None, 1.0, 2.0),
         ("paint.decode", None, 4.0, 10.0), ("decode.heads", 3, 0.2, 3.0),
         ("paint.inverse", None, 0.1, 0.5), ("setup.library", 3, 900.0, None)]
STEP = [("train.batch", None, 1.0, 2.0), ("train.upload", 1, 3.0, 0.1),
        ("train.upload", None, 2.0, 0.1), ("train.forward", None, 5.0, 40.0),
        ("decode.heads", 4, 0.5, 4.0), ("train.backward", None, 3.0, 50.0),
        ("train.optimizer", None, 6.0, 8.0)]
SETUP = [_record("setup.checkpoint", 101, None, 101, 2000.0, None),
         _record("setup.model", 102, None, 102, 500.0, None),
         _record("setup.library", 103, 102, 102, 250.0, None)]
# over calls 1 and 2: the sums' factor is 1 + 2 = 3, over 2 calls
READERS = {
    "transform_ms_per_call.paint": ("paint", (1.0 + 0.5) * 3 / 2),
    "prior_ms_per_call.paint": ("paint", 2.0 * 3 / 2),
    "decoder_ms_per_call.paint": ("paint", (10.0 - 3.0) * 3 / 2),
    "heads_ms_per_call.paint": ("paint", 3.0 * 3 / 2),
    "model_host_ms_per_call.paint": ("paint", (1.0 + 4.0) * 3 / 2),
    "upload_wait_ms_per_step.train": ("train.step", (3.0 + 2.0) * 3 / 2),
    "optimizer_ms_per_step.train": ("train.step", 8.0 * 3 / 2),
    "forward_ms_per_step.train": ("train.step", 40.0 * 3 / 2),
    "backward_ms_per_step.train": ("train.step", 50.0 * 3 / 2),
    # the top-level set-up spans, and the library's inside a paint call
    "program_setup_s": ("paint", (2000.0 + 500.0 + 900.0 * 3) / 1e3)}


def _spans_of(root):
    calls = (_calls("paint", PAINT, 2) if root == "paint"
             else _calls("train.step", STEP, 2))
    return SETUP + calls


@pytest.mark.parametrize("name", sorted(READERS))
def test_span_reader_reads_synthetic_spans(monkeypatch, name):
    root, want = READERS[name]
    monkeypatch.setattr(tprof, "spans", lambda: _spans_of(root))
    run = SimpleNamespace(trace=SimpleNamespace(calls=2))
    assert _reader(name).read(run) == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(set(READERS) - {"program_setup_s"}))
def test_span_reader_refuses_calls_other_than_the_traced(monkeypatch,
                                                         name):
    root, _ = READERS[name]
    monkeypatch.setattr(tprof, "spans", lambda: _spans_of(root))
    for traced in (1, 3):
        run = SimpleNamespace(trace=SimpleNamespace(calls=traced))
        assert _reader(name).read(run) is None
    # the other kind of call is no call of this reader's
    other = "train.step" if root == "paint" else "paint"
    monkeypatch.setattr(tprof, "spans", lambda: _spans_of(other))
    assert _reader(name).read(SimpleNamespace(
        trace=SimpleNamespace(calls=2))) is None


@pytest.mark.parametrize("name", sorted(READERS))
def test_span_reader_finds_nothing_in_a_program_without_spans(monkeypatch,
                                                              name):
    monkeypatch.delattr(tprof, "spans")
    monkeypatch.delattr(tprof, "per_call")
    run = SimpleNamespace(trace=SimpleNamespace(calls=2))
    assert _reader(name).read(run) is None
