"""A cell, a configuration and a per-layer metric dropped into a tree are
found by name, with no edit to any file of the harness."""
import json
import sys
import time
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import core  # noqa: E402
from benchmark.harness.measure import Trace, Window  # noqa: E402
from benchmark.harness.record import Run  # noqa: E402
from harness_small_cells import small_tree  # noqa: E402


def _add_cell(tmp: Path):
    """A new configuration, traffic mix, cell and metric, as files only."""
    bench = small_tree(tmp)
    manifest = json.loads((tmp / "BENCHMARK.json").read_text())
    cvae = json.loads((bench / "configs/cvae_fiducial_512.json").read_text())
    (bench / "configs/cvae_copy.json").write_text(json.dumps(cvae))
    traffic = json.loads((bench / "traffic/sheets_n16.json").read_text())
    traffic["pool"] = 3
    (bench / "traffic/sheets_pool3.json").write_text(json.dumps(traffic))
    wl = json.loads((bench / "workloads/cvae_paint_bf16_n16.json")
                    .read_text())
    wl["dtype"] = "float32"
    (bench / "workloads/cvae_paint_f32_new.json").write_text(json.dumps(wl))
    (bench / "metrics").mkdir()
    (bench / "metrics/calls_traced.paint.py").write_text(
        "def read(run):\n    return run.trace.calls or None\n")
    manifest["configs"].append(
        {"name": "cvae_copy", "source": "https://arxiv.org/abs/1903.12173",
         "file": "benchmark/configs/cvae_copy.json", "reduced": [],
         "why": "a copy"})
    manifest["workloads"].append(
        {"name": "cvae_paint_f32_new", "config": "cvae_copy",
         "traffic": "sheets_pool3", "chips": 1, "why": "a new cell"})
    for m in manifest["end_to_end"]:
        if m["name"].startswith("paint_"):
            m["workloads"].append("cvae_paint_f32_new")
    manifest["per_layer"].append(
        {"name": "calls_traced.paint", "unit": "calls", "better": "higher",
         "source": "program_counter", "layer": "painter",
         "moves": "paint_tiles_per_s", "workloads": ["cvae_paint_f32_new"]})
    (tmp / "BENCHMARK.json").write_text(json.dumps(manifest))
    return bench


def test_a_new_cell_is_found_by_name(tmp_path):
    bench = _add_cell(tmp_path)
    cell = core.load_cell("cvae_paint_f32_new", bench_dir=bench,
                          manifest_path=tmp_path / "BENCHMARK.json")
    assert cell.workload["dtype"] == "float32"
    assert cell.traffic["pool"] == 3
    assert cell.config_entry["name"] == "cvae_copy"
    assert [m["name"] for m in cell.end_to_end] == [
        "paint_tiles_per_s", "paint_call_p95_ms", "setup_s"]
    assert [m["name"] for m in cell.per_layer] == ["calls_traced.paint"]


def test_a_new_metric_is_read_by_its_own_file(tmp_path):
    bench = _add_cell(tmp_path)
    cell = core.load_cell("cvae_paint_f32_new", bench_dir=bench,
                          manifest_path=tmp_path / "BENCHMARK.json")
    trace = Trace(window_s=1.0, busy_s=0.5, ops=[], gaps=[], calls=7)
    run = Run(cell, "cpu", "float32", Window(calls=9, units=144,
                                             seconds=1.0), trace, 16)
    assert core.read_per_layer(cell, run, bench_dir=bench) == {
        "calls_traced.paint": {"value": 7.0, "unit": "calls"}}


def test_a_reader_that_finds_nothing_leaves_its_metric_out(tmp_path):
    """The shipped readers return nothing from a trace with no device
    operation (the CPU's), so the metrics are left out, never read 0."""
    cell = core.load_cell("cvae_paint_bf16_n16")
    trace = Trace(window_s=1.0, busy_s=0.0, ops=[], gaps=[], calls=7)
    run = Run(cell, "cpu", "bfloat16", Window(calls=9, units=144,
                                              seconds=1.0, host_s=0.09),
              trace, 16)
    assert set(core.read_per_layer(cell, run)) == {"host_ms_per_call.paint"}


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        core.load_cell("no_such_cell")


def test_the_run_refuses_without_a_card(capsys):
    """``run.py`` exits 2 and prints no result where the cell's devices
    are missing (this machine has no CUDA device)."""
    import torch
    if torch.cuda.is_available():
        return
    run = core.load_module(ROOT / "benchmark" / "run.py", "bench_run_main")
    t0 = time.perf_counter()
    assert run.main(["--workload", "cvae_paint_bf16_n16", "--seed",
                     str(2 ** 31 + 5), "--seconds", "1"]) == 2
    out = capsys.readouterr()
    assert out.out == "" and "needs 1 CUDA device" in out.err
    assert time.perf_counter() - t0 < 60
