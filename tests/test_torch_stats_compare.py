"""The port's trajectory comparison and its CLI twin against the JAX
package's.

``baryon_painter_tpu_torch/train/stats_compare.py`` is a copy of
``baryon_painter_tpu/train/stats_compare.py`` on the port's stats parser:
on the committed ``training_stats.txt`` against a synthetic log, in every
mode, both give the same report to 1e-12. ``scripts/
compare_reference_stats_torch.py`` prints the same JSON report and exits
as ``scripts/compare_reference_stats.py`` does: 0, or 1 when ``--band``
is exceeded.
"""
import importlib.util
import json
import os

import numpy as np
import pytest

from baryon_painter_tpu.train import stats_compare as jsc
from baryon_painter_tpu_torch.train import stats_compare as tsc
from golden_utils import REPO

COMMITTED = os.path.join(REPO, "trained_models", "CVAE", "fiducial-512",
                         "training_stats.txt")


def _cli(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def synthetic(tmp_path_factory):
    """A log in the committed file's format over part of its sample range,
    with its columns and a batch_size column, converging another way."""
    terms, samples, values = tsc.load_stats_file(COMMITTED)
    rng = np.random.default_rng(0)
    n = 400
    s = np.linspace(samples[0], samples[len(samples) // 3], n).astype(int)
    t = np.linspace(0, 1, n)
    path = tmp_path_factory.mktemp("stats") / "ours.txt"
    cols = terms + (["batch_size"] if "batch_size" not in terms else [])
    with open(path, "w") as f:
        f.write("# Batch nr, sample nr, {}\n".format(", ".join(cols)))
        for i in range(n):
            row = [-5e4 + 4.9e4 * (1 - np.exp(-3 * t[i]))
                   + rng.normal(0, 50)] + list(rng.normal(0, 1, len(cols) - 1))
            if "batch_size" not in terms:
                row[-1] = 24.0
            f.write(" ".join([str(i), str(s[i])] + [repr(float(v))
                                                    for v in row]) + " \n")
    return str(path)


@pytest.mark.parametrize("mode", ["shape", "absolute"])
@pytest.mark.parametrize("per_sample", [False, True],
                         ids=["total", "per_sample"])
@pytest.mark.parametrize("smooth", [1, 100])
def test_compare_trajectories_matches_jax(synthetic, mode, per_sample,
                                          smooth):
    kw = dict(mode=mode, per_sample=per_sample, smooth_window=smooth,
              n_checkpoints=25)
    try:
        want = jsc.compare_trajectories(COMMITTED, synthetic, **kw)
    except ValueError as e:
        with pytest.raises(ValueError, match=str(e)[:30]):
            tsc.compare_trajectories(COMMITTED, synthetic, **kw)
        return
    got = tsc.compare_trajectories(COMMITTED, synthetic, **kw)
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], list):
            np.testing.assert_allclose(got[k], want[k], rtol=1e-12,
                                       atol=1e-12)
        else:
            assert got[k] == pytest.approx(want[k], rel=1e-12, abs=1e-12)


def test_load_stats_file_matches_jax():
    got, want = tsc.load_stats_file(COMMITTED), jsc.load_stats_file(COMMITTED)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("band, status", [(10.0, 0), (1e-6, 1)],
                         ids=["pass", "fail"])
def test_cli_exit_status_and_report_match_jax(synthetic, tmp_path, capsys,
                                              band, status):
    argv = ["--reference", COMMITTED, "--ours", synthetic, "--mode",
            "shape", "--band", str(band)]
    reports = {}
    for name in ("compare_reference_stats", "compare_reference_stats_torch"):
        out = tmp_path / f"{name}.json"
        rc = _cli(name).main(argv + ["--out", str(out)])
        assert rc == status, name
        stdout = capsys.readouterr().out.strip().splitlines()[-1]
        reports[name] = json.loads(stdout)
        assert json.loads(out.read_text()) == reports[name]
    got, want = (reports["compare_reference_stats_torch"],
                 reports["compare_reference_stats"])
    assert got["pass"] is want["pass"] is (status == 0)
    assert got["max_deviation"] == pytest.approx(want["max_deviation"],
                                                 rel=1e-12)
