"""The port's fidelity gate (``scripts/fidelity_check_torch.py``) against the
JAX package's (``scripts/fidelity_check.py``), on the CPU at 32^2.

* ``pk_errors`` of both scripts on the same tiny checkpoint (the committed
  fiducial CVAE's weights, fully convolutional, written with a 32^2
  architecture and a synthetic dataset's meta; the committed CGAN the
  same way) with the same prior noise (the JAX ``CVAE.sample_prior``
  patched to use the port's ``eps``): the medians and diagnostics within
  2e-4 absolute (f32 through the whole model and the spectra: the
  painted fields agree to ~1e-5 relative, and the errors are ratios of
  their spectra), pooled and per redshift.
* ``allocate_batch_shares`` and ``validate_fine_tune_args`` give the JAX
  script's results and refusals.
* ``main``: ``--eval-only`` prints the JAX report's keys with
  ``per_z_by_dtype`` for ``f32`` and ``model``, imports no ``jax``,
  ``flax`` or ``msgpack``; the training leg writes
  ``training_stats_cvae_pkft.txt`` with a ``pk_loss`` column and a
  checkpoint with its dataset geometry; CGAN training and the figures
  raise.
"""
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from golden_utils import REPO

TILE, N_EVAL = 32, 8


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread a process: the suite's other workers load every
    core, and a thread pool per process then runs this file's many small
    CPU ops many times slower than it does alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name):
    path = os.path.join(REPO, "scripts", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def twin():
    return _load("fidelity_check_torch")


@pytest.fixture(scope="module")
def jax_gate():
    return _load("fidelity_check")


def _args(twin, workdir, *extra):
    return twin.parse_args(["--tile", str(TILE), "--redshifts", "0,1",
                            "--n-stack", "2", "--eval-tiles", str(N_EVAL),
                            "--device", "cpu", "--workdir", str(workdir),
                            *extra])


def _write_checkpoint(train_ds, path, kind):
    """A committed checkpoint's weights under a 32^2 architecture and the
    synthetic training set's meta."""
    from baryon_painter_tpu_torch.train import checkpoint as ckpt
    src = {"cvae": "trained_models/CVAE/fiducial-512/model",
           "cgan": "trained_models/CGAN/fiducial/model"}[kind]
    state, meta = ckpt.load_checkpoint(os.path.join(REPO, src))
    arch = dict(meta["model_architecture"])
    if kind == "cvae":
        arch.update(dim_x=(1, TILE, TILE), dim_y=(1, TILE, TILE),
                    dim_z=(1, TILE // 32, TILE // 32))
    base = str(path / f"tiny_{kind}")
    ckpt.save_checkpoint(base, state, ckpt.meta_from_dataset(
        train_ds, arch, model_kind=kind))
    return base


@pytest.fixture(scope="module")
def gate(twin, tmp_path_factory):
    """The twin's datasets (the synthetic stacks of the flags) and the tiny
    checkpoints written against them."""
    workdir = tmp_path_factory.mktemp("gate")
    args = _args(twin, workdir)
    train_ds, val_ds = twin.datasets(args, {
        "dm": twin.parse_transform("shift-log:4"),
        "pressure": twin.parse_transform("shift-log:4")})
    return dict(workdir=workdir, train=train_ds, val=val_ds,
                cvae=_write_checkpoint(train_ds, workdir, "cvae"),
                cgan=_write_checkpoint(train_ds, workdir, "cgan"))


def _jax_val_ds(gate):
    from baryon_painter_tpu.data.dataset import BahamasTileDataset
    from baryon_painter_tpu.transforms import RangeCompress
    tf = {f: RangeCompress("shift-log", 4.0, eps=1e-4)
          for f in ("dm", "pressure")}
    return BahamasTileDataset(data=gate["train"].data, n_stack=1,
                              stack_offset=0, n_tile=2,
                              tile_permutations=True, transforms=tf)


def _close(got, want):
    (ga, gc, gd), (wa, wc, wd) = got, want
    np.testing.assert_allclose([ga, gc], [wa, wc], rtol=0, atol=2e-4)
    for k in ("mean_ratio", "std_ratio", "auto_clipped"):
        np.testing.assert_allclose(gd[k], wd[k], rtol=0, atol=2e-4,
                                   err_msg=k)


@pytest.mark.parametrize("z", [None, 0.0, 1.0], ids=["pooled", "z0", "z1"])
def test_cvae_pk_errors_match_jax_at_the_same_noise(twin, jax_gate, gate, z):
    import jax.numpy as jnp

    from baryon_painter_tpu.models import cvae as jcvae
    from baryon_painter_tpu.painter import CVAEPainter as JaxPainter
    from baryon_painter_tpu_torch.painter import CVAEPainter
    eps = np.random.default_rng(3).standard_normal(
        (N_EVAL, 1, 1, 1)).astype(np.float32)

    def sample_prior(self, y, aux_label=None, train=False):
        z_mu, z_log_var = self.prior(y, aux_label, train=train)
        e = jnp.asarray(eps).transpose(0, 2, 3, 1)[:z_mu.shape[0]]
        return z_mu + e * (jnp.exp(z_log_var / 2) + self.min_z_var)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcvae.CVAE, "sample_prior", sample_prior)
        want = jax_gate.pk_errors(JaxPainter(gate["cvae"]), _jax_val_ds(gate),
                                  n_sample=N_EVAL, z=z)
    got = twin.pk_errors(CVAEPainter(gate["cvae"], device="cpu"),
                         gate["val"], n_sample=N_EVAL, z=z, eps=eps)
    assert np.isfinite(want[0]) and want[0] > 0
    _close(got, want)


def test_cgan_pk_errors_match_jax(twin, jax_gate, gate):
    from baryon_painter_tpu.painter import CGANPainter as JaxPainter
    from baryon_painter_tpu_torch.painter import CGANPainter
    want = jax_gate.pk_errors(JaxPainter(gate["cgan"]), _jax_val_ds(gate),
                              n_sample=N_EVAL, z=1.0)
    got = twin.pk_errors(CGANPainter(gate["cgan"], device="cpu"),
                         gate["val"], n_sample=N_EVAL, z=1.0)
    _close(got, want)


@pytest.mark.parametrize("batch, shares", [
    (12, {0.0: 1, 0.5: 1, 1.0: 1}), (12, {0.0: 2, 0.5: 1, 1.0: 1}),
    (7, {0.0: 5, 0.5: 1, 1.0: 1}), (3, {0.0: 9, 0.5: 1, 1.0: 1}),
    (2, {0.0: 1, 0.5: 1, 1.0: 1})])
def test_allocate_batch_shares_matches_jax(twin, jax_gate, batch, shares):
    zs = [0.0, 0.5, 1.0]
    try:
        want = jax_gate.allocate_batch_shares(batch, shares, zs)
    except ValueError:
        with pytest.raises(ValueError):
            twin.allocate_batch_shares(batch, shares, zs)
        return
    assert twin.allocate_batch_shares(batch, shares, zs) == want


@pytest.mark.parametrize("extra", [
    [], ["--pk-loss-weight", "2e4"], ["--pk-loss-weight", "2e4",
                                      "--z-boost", "0:2"],
    ["--pk-loss-weight", "2e4", "--z-boost", "0:3"],
    ["--pk-loss-weight", "2e4", "--z-boost", "auto:3", "--eval-every", "5"],
    ["--pk-loss-weight", "2e4", "--z-boost", "auto"],
    ["--pk-loss-weight", "2e4", "--z-boost", "auto:1", "--eval-every", "5"],
    ["--z-boost", "0:2"], ["--pk-loss-weight", "2e4", "--batch", "1"]],
    ids=["plain", "pk", "boost", "boost_indivisible", "auto", "auto_no_eval",
         "auto_k1", "boost_without_pk", "batch_below_n_z"])
def test_validate_fine_tune_args_matches_jax(twin, jax_gate, tmp_path,
                                             extra):
    args = _args(twin, tmp_path, "--batch", "24", *extra)
    zs = [0.0, 1.0]
    try:
        want = jax_gate.validate_fine_tune_args(args, zs)
    except SystemExit as e:
        with pytest.raises(SystemExit) as got:
            twin.validate_fine_tune_args(args, zs)
        assert str(got.value) == str(e)
        return
    assert twin.validate_fine_tune_args(args, zs) == want


def test_eval_only_report_has_the_jax_report_keys(twin, gate, capsys):
    report = twin.main(["--tile", str(TILE), "--redshifts", "0,1",
                        "--n-stack", "2", "--eval-tiles", str(N_EVAL),
                        "--device", "cpu", "--workdir", str(gate["workdir"]),
                        "--eval-only", "--checkpoint", gate["cvae"]])
    out = capsys.readouterr().out.strip().splitlines()
    assert len(out) == 1 and json.loads(out[0]) == report
    with open(os.path.join(REPO, "trained_models/CVAE/fiducial-512/"
                                 "fidelity_report.json")) as f:
        committed = json.load(f)
    assert set(report) == set(committed)
    assert set(report["per_z_by_dtype"]) == {"f32", "model"}
    assert set(report["per_z"]) == {"0", "1"}
    assert report["per_z"] == report["per_z_by_dtype"]["f32"]


def test_training_leg_writes_pkft_stats_and_geometry(twin, tmp_path, capsys):
    common = ["--tile", str(TILE), "--redshifts", "0,1", "--n-stack", "2",
              "--batch", "4", "--scan", "2", "--eval-tiles", "4",
              "--train-dtype", "f32", "--device", "cpu", "--workdir",
              str(tmp_path)]
    twin.main(common + ["--n-samples", "8"])
    report = twin.main(common + ["--n-samples", "8", "--resume",
                                 "--pk-loss-weight", "2e4",
                                 "--eval-every", "2"])
    assert report["n_samples"] == 8 and "per_z_by_dtype" not in report
    header = (tmp_path / "training_stats_cvae_pkft.txt").read_text(
    ).splitlines()[0]
    assert header.endswith(", pk_loss")
    rows = (tmp_path / "training_stats_cvae_pkft.txt").read_text(
    ).splitlines()[1:]
    assert len(rows) == 2 and all(float(r.split()[-1]) > 0 for r in rows)
    assert (tmp_path / "training_stats_cvae.txt").exists()
    with open(tmp_path / "fidelity_model_cvae_meta.json") as f:
        geometry = json.load(f)["fidelity_dataset"]
    assert geometry == {"tile": TILE, "redshifts": "0,1", "n_stack": 2,
                        "physical": False, "pressure_noise": 0.1, "seed": 0}
    capsys.readouterr()


def test_cgan_training_leg(twin, tmp_path, capsys):
    """The CGAN training leg: a fresh run, then a resumed spectral
    fine-tune with a fresh discriminator; the statistics files carry the
    trainer's columns (and pk_loss), the checkpoint the dataset geometry,
    and the gate paints the trainer's live generator."""
    common = ["--model", "cgan", "--tile", str(TILE), "--redshifts", "0,1",
              "--n-stack", "2", "--batch", "2", "--scan", "2",
              "--eval-tiles", "2", "--device", "cpu", "--workdir",
              str(tmp_path)]
    first = twin.main(common + ["--n-samples", "4"])
    assert first["model"] == "cgan" and first["n_samples"] == 4
    assert set(first["per_z_by_dtype"]) == {"f32", "model"}
    header = (tmp_path / "training_stats_cgan.txt").read_text().splitlines()
    assert header[0] == ("# Batch nr, sample nr, loss_D, loss_G_adv, "
                         "loss_G_perceptual, D_real, D_fake")
    assert len(header) == 3
    report = twin.main(common + [
        "--n-samples", "4", "--resume", "--reinit-d", "7",
        "--pk-loss-weight", "1e4", "--eval-every", "2", "--freeze-bn",
        "--feature-matching", "--adv-weight", "0.5", "--perc-weight", "2",
        "--clip-grad", "10", "--select-within-run"])
    rows = (tmp_path / "training_stats_cgan_pkft.txt").read_text(
    ).splitlines()
    assert rows[0].endswith(", D_fake, pk_loss") and len(rows) == 3
    assert all(float(r.split()[-1]) > 0 for r in rows[1:])
    assert all(np.isfinite(v["auto"]) for d in
               report["per_z_by_dtype"].values() for v in d.values())
    with open(tmp_path / "fidelity_model_cgan_meta.json") as f:
        meta = json.load(f)
    assert meta["model_kind"] == "cgan"
    assert meta["fidelity_dataset"]["tile"] == TILE
    g = twin.setup(twin.parse_args(common + [
        "--resume", "--pk-loss-weight", "1e4", "--freeze-bn",
        "--feature-matching", "--adv-weight", "0.5", "--perc-weight", "2",
        "--clip-grad", "10"]))
    cfg = g.trainer.config
    assert (cfg.adversarial_weight, cfg.lambda_perceptual,
            cfg.feature_matching, cfg.freeze_bn_stats, cfg.clip_grad_norm,
            cfg.pk_loss_weight, cfg.pk_loss_per_z, cfg.batch_size) == (
        0.5, 2.0, True, True, 10.0, 1e4, True, 2)
    assert g.trainer.steps == 4 and g.trainer.device_cache is not None
    capsys.readouterr()


def test_what_the_gate_refuses(twin, tmp_path, monkeypatch):
    base = ["--tile", str(TILE), "--device", "cpu", "--workdir",
            str(tmp_path)]
    cgan = os.path.join(REPO, "trained_models/CGAN/fiducial/model")
    with pytest.raises(SystemExit, match="--reinit-d needs"):
        twin.main(base + ["--model", "cgan", "--eval-only", "--checkpoint",
                          cgan, "--reinit-d", "7"])
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        twin.main(base + ["--save-figures"])
    monkeypatch.undo()
    with pytest.raises(SystemExit, match="no checkpoint"):
        twin.main(base + ["--eval-only", "--checkpoint",
                          str(tmp_path / "missing")])


_BLOCKED = """
import importlib.abc, runpy, sys
BLOCKED = ("jax", "jaxlib", "flax", "msgpack", "optax", "baryon_painter_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None

sys.meta_path.insert(0, Block())
sys.argv = ["fidelity_check_torch.py"] + sys.argv[1:]
runpy.run_path("scripts/fidelity_check_torch.py", run_name="__main__")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not loaded, loaded
"""


def test_eval_only_cli_imports_no_jax(gate):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-c", _BLOCKED, "--model", "cgan", "--tile",
         str(TILE), "--redshifts", "0,1", "--n-stack", "2", "--eval-tiles",
         "4", "--gate-dtype", "f32", "--device", "cpu", "--workdir",
         str(gate["workdir"]), "--eval-only", "--checkpoint", gate["cgan"]],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()
    assert len(lines) == 1
    assert json.loads(lines[0])["model"] == "cgan"


def test_spread_repeats_the_gate_over_noise_seeds(twin, gate):
    """``scripts/fidelity_spread_torch.py`` at 32^2: per leg, z and kind,
    the readings over the noise seeds (the first is the twin's own score
    at its default seed), their mean and spread, and the committed value
    held to max(3 sigma, 5e-4) of the mean."""
    sys.path.insert(0, os.path.join(REPO, "scripts"))
    spread = _load("fidelity_spread_torch")
    base = gate["cvae"]
    committed = {"f32": {"0": {"auto": 0.0, "cross": 0.0}}}
    with open(os.path.join(os.path.dirname(base),
                           "fidelity_report.json"), "w") as f:
        json.dump({"per_z_by_dtype": committed}, f)
    out = spread.spread(base, 3, device="cpu", n_tiles=4,
                        fallback={"tile": TILE, "redshifts": "0,1",
                                  "n_stack": 2})
    assert out["dataset"]["tile"] == TILE and out["eps_seeds"] == 3
    assert set(out["legs"]) == {"f32", "model"}
    f32 = out["legs"]["f32"]["0"]["auto"]
    assert len(f32["values"]) == 3 and f32["std"] > 0
    assert f32["mean"] == pytest.approx(np.mean(f32["values"]))
    assert f32["limit"] == max(3 * f32["std"], 5e-4)
    assert f32["within"] is (abs(f32["mean"]) <= f32["limit"])
    assert out["legs"]["model"]["1"]["cross"]["within"] is None
    # the twin's own score is the first reading
    from baryon_painter_tpu_torch.painter import CVAEPainter
    g = spread.gate
    args = g.parse_args(spread.dataset_flags(base, {
        "tile": TILE, "redshifts": "0,1", "n_stack": 2}) + [
        "--eval-only", "--checkpoint", base, "--device", "cpu",
        "--workdir", str(gate["workdir"])])
    painter = g.setup(args).make_painter(None)
    want = g.pk_errors(painter, gate["val"], n_sample=4, z=0.0)[0]
    assert f32["values"][0] == pytest.approx(want, abs=1e-6)
    assert isinstance(painter, CVAEPainter)
