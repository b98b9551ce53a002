"""``scripts/promote_checkpoint_torch.py`` against
``scripts/promote_checkpoint.py``.

* The cases of ``tests/test_promote_checkpoint.py`` (inference-state
  stripping, best-checkpoint choice, clobber guard, metadata cross-checks,
  manifest), run on both scripts.
* The stripped ``model_state.msgpack`` is byte for byte the JAX script's
  (flax's bytes), the numpy-scalar step of those cases included.
* With ``subprocess.run`` stubbed: the twin's re-evaluation runs
  ``scripts/fidelity_check_torch.py --eval-only`` with the flags derived
  from the checkpoint's ``fidelity_dataset`` (and ``--device``), its
  report runs ``scripts/make_model_report_torch.py``, and when
  ``scripts/make_paint_goldens.py`` fails (it needs JAX) the JAX script's
  warning is printed.
"""
import importlib.util
import json
import os
import subprocess
import time

import flax.serialization
import numpy as np
import pytest

from golden_utils import REPO

SCRIPTS = ("promote_checkpoint", "promote_checkpoint_torch")


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


def _write_ckpt(base, extra_keys=(), tile=64, model_kind="cvae", geom=None):
    state = {"params": {"w": np.ones((2, 2), np.float32)},
             "batch_stats": {"m": np.zeros(2, np.float32)},
             "step": np.int64(7)}
    for k in extra_keys:
        state[k] = {"nu": np.ones(3, np.float32)}
    with open(base + "_state.msgpack", "wb") as f:
        f.write(flax.serialization.msgpack_serialize(state))
    meta = {"model_kind": model_kind, "tile_size": tile, "tile_L": 100.0,
            "input_field": "dm", "label_fields": ["pressure"],
            "model_architecture": {"dim_z": [1, 4, 4]}}
    if geom is not None:
        meta["fidelity_dataset"] = geom
    with open(base + "_meta.json", "w") as f:
        json.dump(meta, f)


def _restore(path):
    with open(path, "rb") as f:
        return flax.serialization.msgpack_restore(f.read())


def _stats(wd):
    (wd / "training_stats_cvae.txt").write_text(
        "# Batch nr, sample nr, ELBO, KL_term\n"
        + "\n".join(f"{i} {24 * (i + 1)} {-100.0 + i} {-1.0}"
                    for i in range(30)) + "\n")


def test_promote_strips_training_state_and_reports_manifest(mod, tmp_path,
                                                            capsys):
    wd, dest = tmp_path / "wd", tmp_path / "dest"
    wd.mkdir()
    _write_ckpt(str(wd / "fidelity_model_cvae"),
                extra_keys=("opt_state", "progress", "data_rng"))
    _stats(wd)
    mod.main(["--workdir", str(wd), "--model", "cvae",
              "--dest", str(dest), "--skip-eval"])
    raw = _restore(str(dest / "model_state.msgpack"))
    assert set(raw) == {"params", "batch_stats", "step"}
    manifest = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for name in manifest["files"]:
        assert (dest / name).exists(), name
    assert "report.md" in manifest["files"]
    assert "loss_curves.png" in manifest["files"]


def _no_report(monkeypatch):
    """Stubs the report subprocess where a case does not read the report
    (each script's report run imports its package afresh)."""
    monkeypatch.setattr(subprocess, "run",
                        lambda cmd, **kw: subprocess.CompletedProcess(cmd, 0))


def test_promote_prefers_newer_best_checkpoint(mod, tmp_path, monkeypatch):
    _no_report(monkeypatch)
    wd, dest = tmp_path / "wd", tmp_path / "dest"
    wd.mkdir()
    base = str(wd / "fidelity_model_cvae")
    _write_ckpt(base, tile=32)
    _write_ckpt(base + "_best", tile=48)
    later = time.time() + 60
    os.utime(base + "_best_state.msgpack", (later, later))
    mod.main(["--workdir", str(wd), "--model", "cvae",
              "--dest", str(dest), "--skip-eval"])
    assert json.loads((dest / "model_meta.json").read_text())[
        "tile_size"] == 48
    mod.main(["--workdir", str(wd), "--model", "cvae", "--dest", str(dest),
              "--skip-eval", "--checkpoint", "base", "--force"])
    assert json.loads((dest / "model_meta.json").read_text())[
        "tile_size"] == 32


def test_promote_refuses_to_clobber_without_force(mod, tmp_path,
                                                 monkeypatch):
    _no_report(monkeypatch)
    wd, dest = tmp_path / "wd", tmp_path / "dest"
    wd.mkdir()
    _write_ckpt(str(wd / "fidelity_model_cvae"))
    mod.main(["--workdir", str(wd), "--model", "cvae",
              "--dest", str(dest), "--skip-eval"])
    with pytest.raises(SystemExit, match="--force"):
        mod.main(["--workdir", str(wd), "--model", "cvae",
                  "--dest", str(dest), "--skip-eval"])


def test_promote_cross_checks_meta(mod, tmp_path):
    wd = tmp_path / "wd"
    wd.mkdir()
    _write_ckpt(str(wd / "fidelity_model_cvae"), tile=64)
    with pytest.raises(SystemExit, match="tile"):
        mod.main(["--workdir", str(wd), "--model", "cvae",
                  "--dest", str(tmp_path / "d1"), "--skip-eval",
                  "--eval-args", "--tile 128"])
    _write_ckpt(str(wd / "fidelity_model_cgan"), model_kind="cvae")
    with pytest.raises(SystemExit, match="metadata"):
        mod.main(["--workdir", str(wd), "--model", "cgan",
                  "--dest", str(tmp_path / "d2"), "--skip-eval"])


def test_promote_missing_checkpoint_errors(mod, tmp_path):
    (tmp_path / "wd").mkdir()
    with pytest.raises(SystemExit, match="no checkpoint"):
        mod.main(["--workdir", str(tmp_path / "wd"), "--model", "cvae",
                  "--dest", str(tmp_path / "dest"), "--skip-eval"])


@pytest.mark.parametrize("extra", [("opt_state", "progress", "data_rng"),
                                   ()], ids=["trainer", "inference"])
def test_stripped_state_byte_equal_to_jax(scripts, tmp_path, extra,
                                          monkeypatch):
    _no_report(monkeypatch)
    wd = tmp_path / "wd"
    wd.mkdir()
    _write_ckpt(str(wd / "fidelity_model_cvae"), extra_keys=extra)
    out = {}
    for name, m in scripts.items():
        dest = tmp_path / name
        m.main(["--workdir", str(wd), "--model", "cvae", "--dest",
                str(dest), "--skip-eval"])
        out[name] = (dest / "model_state.msgpack").read_bytes()
    assert out["promote_checkpoint_torch"] == out["promote_checkpoint"]


GEOM = {"tile": 64, "redshifts": "0,1", "n_stack": 2,
        "pressure_noise": 0.1, "seed": 0, "physical": True}


class _Runs:
    """``subprocess.run`` stubbed: records each command; the gate twin
    answers with a report, the goldens script fails as it does without
    JAX."""

    def __init__(self):
        self.cmds = []

    def __call__(self, cmd, check=False, stdout=None, text=False, env=None):
        self.cmds.append(list(cmd))
        script = os.path.basename(cmd[1])
        if script == "fidelity_check_torch.py":
            out = json.dumps({"pass_5pct": True, "auto": 0.01,
                              "cross": 0.02, "per_z": {}})
            return subprocess.CompletedProcess(cmd, 0, out + "\n", None)
        return subprocess.CompletedProcess(
            cmd, 1 if script == "make_paint_goldens.py" else 0)


def test_eval_report_and_goldens_commands(scripts, tmp_path, monkeypatch,
                                          capsys):
    twin = scripts["promote_checkpoint_torch"]
    wd = tmp_path / "wd"
    wd.mkdir()
    _write_ckpt(str(wd / "fidelity_model_cvae"), geom=GEOM)
    # a checkout whose trained_models/ holds the destination
    fake_scripts = tmp_path / "repo" / "scripts"
    fake_scripts.mkdir(parents=True)
    dest = tmp_path / "repo" / "trained_models" / "CVAE" / "new"
    runs = _Runs()
    monkeypatch.setattr(twin, "SCRIPTS", str(fake_scripts))
    monkeypatch.setattr(twin.subprocess, "run", runs)
    capsys.readouterr()
    twin.main(["--workdir", str(wd), "--model", "cvae", "--dest",
               str(dest), "--eval-args", "--n-stack 2", "--device", "cpu"])
    names = [os.path.basename(c[1]) for c in runs.cmds]
    assert names == ["fidelity_check_torch.py", "make_model_report_torch.py",
                     "make_paint_goldens.py"]
    ev = runs.cmds[0]
    assert ev[2:8] == ["--model", "cvae", "--eval-only", "--checkpoint",
                       str(dest / "model"), "--workdir"]
    flags = ev[9:]
    for flag, value in (("--tile", "64"), ("--redshifts", "0,1"),
                        ("--n-stack", "2"), ("--pressure-noise", "0.1"),
                        ("--seed", "0"), ("--device", "cpu")):
        assert flags[flags.index(flag) + 1] == value, flag
    assert flags.count("--n-stack") == 1 and "--physical" in flags
    assert runs.cmds[1][2:] == [str(dest)]
    captured = capsys.readouterr()
    assert ("warning: golden regeneration failed — run "
            "scripts/make_paint_goldens.py manually") in captured.err
    manifest = json.loads(captured.out.strip().splitlines()[-1])
    assert "fidelity_report.json" in manifest["files"]
    assert not any("goldens" in f for f in manifest["files"])
    assert json.loads((dest / "fidelity_report.json").read_text())[
        "pass_5pct"] is True
    # a contradicting geometry flag is refused before any command
    runs.cmds.clear()
    with pytest.raises(SystemExit, match="fidelity_dataset"):
        twin.main(["--workdir", str(wd), "--model", "cvae", "--dest",
                   str(tmp_path / "d3"), "--eval-args", "--n-stack 3"])
    assert runs.cmds == []
