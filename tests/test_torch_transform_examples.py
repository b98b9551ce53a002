"""``scripts/transform_examples_torch.py`` against
``scripts/transform_examples.py`` at ``--n 64``: the same modes, each
mode's forward range within rtol 1e-5 of the JAX script's, the limits of
``tests/test_transform_examples.py`` (round trip under 1e-3, split-scale
recomposition under 1e-5), the figures and ``report.json``; without
matplotlib the twin writes the numbers and no figure."""
import contextlib
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest

from golden_utils import REPO

MODES = {"log", "shift-log", "shift-log-2p", "log-tanh", "x/(1+x)", "1/x",
         "split-scale"}


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def twin():
    return _load("transform_examples_torch")


def _check_limits(report, out):
    assert set(report["modes"]) == MODES
    for mode, r in report["modes"].items():
        if mode == "split-scale":
            assert r["recompose_max_rel_err"] < 1e-5
        else:
            assert r["roundtrip_max_rel_err"] < 1e-3, mode
    for fig in report["figures"]:
        assert (out / fig).exists()
    with open(out / "report.json") as f:
        assert json.load(f) == report


def test_twin_matches_jax_script(twin, tmp_path, monkeypatch):
    jax_script = _load("transform_examples")
    monkeypatch.setattr(sys, "argv", ["transform_examples.py", "--out",
                                      str(tmp_path / "jax"), "--n", "64"])
    with contextlib.redirect_stdout(io.StringIO()) as out:
        jax_script.main()
    want = json.loads(out.getvalue().strip().splitlines()[-1])
    with contextlib.redirect_stdout(io.StringIO()) as out:
        got = twin.main(["--out", str(tmp_path / "torch"), "--n", "64",
                         "--device", "cpu"])
    assert json.loads(out.getvalue().strip().splitlines()[-1]) == got
    _check_limits(got, tmp_path / "torch")
    assert got["figures"] == want["figures"]
    assert got["metric"] == want["metric"]
    for mode in MODES - {"split-scale"}:
        np.testing.assert_allclose(got["modes"][mode]["fwd_range"],
                                   want["modes"][mode]["fwd_range"],
                                   rtol=1e-5, err_msg=mode)


def test_without_matplotlib_no_figure(twin, tmp_path, monkeypatch, capsys):
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    report = twin.main(["--out", str(tmp_path), "--n", "64", "--device",
                        "cpu"])
    assert report["figures"] == []
    assert "matplotlib is not installed" in capsys.readouterr().err
    _check_limits(report, tmp_path)
    assert not list(tmp_path.glob("*.png"))
