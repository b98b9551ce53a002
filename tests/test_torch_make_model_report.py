"""``scripts/make_model_report_torch.py`` against
``scripts/make_model_report.py``.

* Every committed model directory (its files linked into a temporary
  directory, so nothing under ``trained_models/`` is written): the twin's
  ``report.md`` byte for byte the JAX script's, written in the same
  directory one after the other.
* The cases of ``tests/test_model_report.py``, run on both scripts.
* Without matplotlib the twin writes the report without the loss-curves
  panel and says so on stderr, where the JAX script cannot run.
"""
import importlib.util
import json
import os
import sys

import numpy as np
import pytest

from golden_utils import REPO

SCRIPTS = ("make_model_report", "make_model_report_torch")
MODELS = sorted(
    os.path.join(fam, run)
    for fam in os.listdir(os.path.join(REPO, "trained_models"))
    if os.path.isdir(os.path.join(REPO, "trained_models", fam))
    for run in os.listdir(os.path.join(REPO, "trained_models", fam))
    if os.path.exists(os.path.join(REPO, "trained_models", fam, run,
                                   "model_meta.json")))
GENERATED = ("report.md", "loss_curves.png")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def scripts():
    return {name: _load(name) for name in SCRIPTS}


@pytest.fixture(params=SCRIPTS)
def mod(request, scripts):
    return scripts[request.param]


def _linked(model: str, root) -> str:
    """The committed model directory's inputs linked into ``root`` (the
    generated files left out: the scripts write them)."""
    src = os.path.join(REPO, "trained_models", model)
    dst = root / model
    dst.mkdir(parents=True)
    for f in os.listdir(src):
        if f not in GENERATED:
            os.symlink(os.path.join(src, f), dst / f)
    return str(dst)


def test_committed_models_are_found():
    assert len(MODELS) == 8
    assert "CVAE/fiducial-512" in MODELS and "CGAN/fiducial-adv" in MODELS


@pytest.mark.parametrize("model", MODELS)
def test_report_byte_equal_to_jax(scripts, model, tmp_path, capsys):
    d = _linked(model, tmp_path)
    out = {}
    for name in SCRIPTS:
        for f in GENERATED:
            if os.path.exists(os.path.join(d, f)):
                os.remove(os.path.join(d, f))
        scripts[name].make_report(d)
        with open(os.path.join(d, "report.md"), "rb") as f:
            out[name] = f.read()
    assert out["make_model_report_torch"] == out["make_model_report"]
    assert capsys.readouterr().out.count("wrote") == 2


# the cases of tests/test_model_report.py, on both scripts

def _meta(d):
    (d / "model_meta.json").write_text(json.dumps({
        "model_kind": "cvae", "tile_size": 64, "tile_L": 100.0,
        "input_field": "dm", "label_fields": ["pressure"],
        "model_architecture": {"dim_z": [1, 4, 4]}}))


def test_report_from_synthetic_artifacts(mod, tmp_path):
    d = tmp_path / "CVAE" / "toy"
    d.mkdir(parents=True)
    _meta(d)
    (d / "fidelity_report.json").write_text(json.dumps({
        "pass_5pct": True,
        "per_z": {"0": {"auto": 0.01, "cross": 0.02},
                  "1": {"auto": 0.06, "cross": 0.03}}}))
    rows = "\n".join(f"{i} {24 * (i + 1)} {-100.0 + i} {-1.0}"
                     for i in range(50))
    (d / "training_stats.txt").write_text(
        "# Batch nr, sample nr, ELBO, KL_term\n" + rows + "\n")
    mod.make_report(str(d))
    report = (d / "report.md").read_text()
    assert "P(k) fidelity gate" in report
    assert "| 0 | 0.010 | 0.020 | yes |" in report
    assert "| 1 | 0.060 | 0.030 | NO |" in report
    assert "PASS" in report
    assert (d / "loss_curves.png").exists()


def test_report_renders_dual_dtype_gate(mod, tmp_path):
    d = tmp_path / "CVAE" / "dual"
    d.mkdir(parents=True)
    _meta(d)
    (d / "fidelity_report.json").write_text(json.dumps({
        "pass_5pct": False, "gate_dtype": "both",
        "per_z": {"0": {"auto": 0.01, "cross": 0.02}},
        "per_z_by_dtype": {
            "f32": {"0": {"auto": 0.01, "cross": 0.02}},
            "model": {"0": {"auto": 0.08, "cross": 0.02}}}}))
    mod.make_report(str(d))
    report = (d / "report.md").read_text()
    assert "| z | auto f32 | cross f32 | auto model | cross model | pass |" \
        in report
    assert "| 0 | 0.010 | 0.020 | 0.080 | 0.020 | NO |" in report
    assert "worst per-z value 0.080 across paint dtypes f32/model" in report


def test_report_tolerates_header_only_stats(mod, tmp_path):
    d = tmp_path / "CVAE" / "crashed"
    d.mkdir(parents=True)
    _meta(d)
    (d / "training_stats.txt").write_text(
        "# Batch nr, sample nr, ELBO, KL_term\n")
    mod.make_report(str(d))
    assert (d / "report.md").exists()
    assert not (d / "loss_curves.png").exists()


def test_report_skips_dir_without_meta(mod, tmp_path, capsys):
    mod.make_report(str(tmp_path))
    assert "skip" in capsys.readouterr().out
    assert not (tmp_path / "report.md").exists()


def test_mavg_window(mod):
    x = np.arange(10, dtype=float)
    m = mod._mavg(x, w=3)
    assert m[0] == 0.0
    np.testing.assert_allclose(m[-1], np.mean(x[-3:]))


def test_param_count_reads_numpy_scalar_leaves(scripts, tmp_path):
    """A tree with a numpy-scalar leaf (flax's ext 3), as the JAX tests'
    checkpoints carry their step, is counted as the JAX script counts it."""
    import flax.serialization
    path = str(tmp_path / "s.msgpack")
    with open(path, "wb") as f:
        f.write(flax.serialization.msgpack_serialize(
            {"params": {"w": np.ones((2, 3), np.float32)},
             "step": np.int64(7)}))
    counts = {n: m._param_count(path) for n, m in scripts.items()}
    assert counts["make_model_report_torch"] == counts["make_model_report"]


def test_without_matplotlib_the_loss_panel_is_left_out(scripts, tmp_path,
                                                       monkeypatch, capsys):
    d = _linked("CVAE/fiducial-resize", tmp_path)
    scripts["make_model_report_torch"].make_report(d)
    with open(os.path.join(d, "report.md")) as f:
        full = f.read()
    os.remove(os.path.join(d, "report.md"))
    os.remove(os.path.join(d, "loss_curves.png"))
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    capsys.readouterr()
    scripts["make_model_report_torch"].make_report(d)
    err = capsys.readouterr().err
    assert "matplotlib is not installed" in err
    assert len(err.strip().splitlines()) == 1
    with open(os.path.join(d, "report.md")) as f:
        bare = f.read()
    assert not os.path.exists(os.path.join(d, "loss_curves.png"))
    assert "## Loss trajectories" in full
    assert "## Loss trajectories" not in bare
    # everything else is the same text
    start = full.index("## Loss trajectories")
    end = full.index("## Validation figures")
    assert bare == full[:start] + full[end:]
