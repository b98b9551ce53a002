"""The manifest keeps to the benchmark's contract: its keys, names, units
and limits, each metric's ``moves`` reported by its cells, and every file
a cell or a metric is found by."""
import json
import re
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n\r]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]


def _e2e_of(cell):
    return {m["name"] for m in MANIFEST["end_to_end"]
            if cell in m.get("workloads", [cell])}


def test_top_level_keys_and_command():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert MANIFEST["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= len(MANIFEST["paths"]) <= 16
    for p in MANIFEST["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert isinstance(MANIFEST["run_seconds"], int)
    assert 1 <= MANIFEST["run_seconds"] <= 51
    # a full check of 24 cells fits the driver's 43200 s
    s = MANIFEST["run_seconds"]
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len(json.dumps(MANIFEST)) <= 64 * 1024


@pytest.mark.parametrize("section,keys", [
    ("configs", {"name", "source", "file", "reduced", "why"}),
    ("workloads", {"name", "config", "traffic", "chips", "why"}),
    ("end_to_end", {"name", "unit", "better", "bound", "source"}),
    ("per_layer", {"name", "unit", "better", "source", "layer", "moves"})])
def test_entry_keys(section, keys):
    for entry in MANIFEST[section]:
        assert set(entry) - {"workloads"} == keys, entry["name"]


def test_names_units_and_lines():
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in MANIFEST[section]]
        assert len(set(names)) == len(names)
        assert all(NAME.match(n) for n in names), names
    metrics = [m["name"] for m in MANIFEST["end_to_end"] + MANIFEST[
        "per_layer"]]
    assert len(set(metrics)) == len(metrics)
    for m in MANIFEST["end_to_end"] + MANIFEST["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in MANIFEST["configs"]:
        assert LINE.match(c["why"]) and LINE.match(c["source"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in MANIFEST["workloads"]:
        assert LINE.match(w["why"]) and w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in MANIFEST["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for m in MANIFEST["per_layer"]:
        assert LINE.match(m["layer"])


def test_end_to_end_bounds_and_sources():
    names = {m["name"] for m in MANIFEST["end_to_end"]}
    assert "setup_s" in names
    for m in MANIFEST["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for cell in CELLS:
        e2e = _e2e_of(cell)
        assert "setup_s" in e2e and len(e2e) >= 2, cell


def test_per_layer_metrics_move_what_their_cells_report():
    layers = {}
    for m in MANIFEST["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        cells = m.get("workloads", CELLS)
        assert set(cells) <= set(CELLS)
        for cell in cells:
            assert m["moves"] in _e2e_of(cell), (m["name"], cell)
        layers.setdefault(m["layer"].split(":")[0], set()).add(m["layer"])
        if m["name"].split(".")[0].endswith("_roofline") or "mfu" in m[
                "name"]:
            assert m["unit"] == "%"
    # a layer is named the same, letter for letter, by all its metrics
    assert all(len(v) == 1 for v in layers.values())
    for cell in CELLS:
        assert any(cell in m.get("workloads", CELLS)
                   for m in MANIFEST["per_layer"]), cell


def test_every_cell_and_metric_has_its_files():
    bench = ROOT / "benchmark"
    configs = {c["name"]: c for c in MANIFEST["configs"]}
    used = set()
    for w in MANIFEST["workloads"]:
        wl = json.loads((bench / "workloads" / f"{w['name']}.json")
                        .read_text())
        assert (bench / "entries" / f"{wl['entry']}.py").is_file()
        assert (bench / "traffic" / f"{w['traffic']}.json").is_file()
        assert set(wl["checks"]) and all(v > 0 for v in
                                          wl["checks"].values())
        cfg = configs[w["config"]]
        assert cfg["file"].startswith("benchmark/")
        assert (ROOT / cfg["file"]).is_file()
        used.add(w["config"])
    assert used == set(configs)
    files = [c["file"] for c in MANIFEST["configs"]]
    assert len(set(files)) == len(files)
    for m in MANIFEST["per_layer"]:
        assert (bench / "metrics" / f"{m['name']}.py").is_file()


def test_configs_keep_their_widths():
    """The configurations are uncut but for the training stacks' count,
    which ``reduced`` lists; the CVAE's architecture is the committed
    checkpoint's own."""
    cvae = json.loads((ROOT / "benchmark/configs/cvae_fiducial_512.json")
                      .read_text())
    meta = json.loads((ROOT / (cvae["checkpoint"] + "_meta.json"))
                      .read_text())
    assert cvae["architecture"] == meta["model_architecture"]
    assert cvae["n_training_stack"] != cvae["published"]["n_training_stack"]
    reduced = {c["name"]: c["reduced"] for c in MANIFEST["configs"]}
    assert reduced == {"cvae_fiducial_512": ["n_training_stack"],
                       "cgan_fiducial_512": []}


def test_cgan_config_is_the_generator_of_its_checkpoint():
    from baryon_painter_tpu_torch.models.cgan import cgan_generator_spec
    cgan = json.loads((ROOT / "benchmark/configs/cgan_fiducial_512.json")
                      .read_text())
    meta = json.loads((ROOT / (cgan["checkpoint"] + "_meta.json"))
                      .read_text())
    arch = meta["model_architecture"]
    gen = cgan["generator"]
    assert (gen["in_channels"], gen["n_res_blocks"], gen["upsample"]) == (
        arch["in_channels"], arch["n_res_blocks"], arch["upsample"])
    body, head = cgan_generator_spec(arch["in_channels"],
                                     arch["n_res_blocks"], arch["upsample"])
    as_json = lambda spec: json.loads(json.dumps(spec))
    assert gen["body"] == as_json(body) and gen["head"] == as_json(head)
