"""The port's training run (``CVAETrainer.train``) against the JAX trainer's,
its resume, its CLI twin and the painter's training surface.

The loop's bookkeeping: the step (``step_scan`` with the stack cache,
``step`` without) and the validation loss (``eval_loss``) are replaced in
both trainers by the same recorder, which returns fixed metrics, so that no
difference of arithmetic can hide or fake a difference of control flow.
Across pepoch boundaries with the fiducial batch schedule and, in turn, the
fiducial lr schedule and ReduceLROnPlateau, with validation, checkpoints
with rotation and reports, the two loops must draw the same sample indices
and pass the same lr, alpha_var, beta_KL and batch sizes, write the same
statistics files byte for byte, and leave the same checkpoint files with
the same progress, data-RNG and schedule arrays.

Resume: a run restored from its periodic checkpoint must end where the
uninterrupted run ends, bit for bit (parameters, Adam state, running
statistics, both statistics files), as the JAX package's own resume test
asks (tests/test_trainer.py). The JAX loop restored at a checkpoint taken
before a report point leaves that point's ``last_report`` unset in its
final progress; the port's loop is the same, so the progress arrays are
compared with the JAX loop's, not across a resume.
"""
import importlib.util
import json
import os
import re
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baryon_painter_tpu import transforms as jtransforms
from baryon_painter_tpu.data.dataset import BahamasTileDataset as JaxDataset
from baryon_painter_tpu.data.dataset import load_file_info
from baryon_painter_tpu.models import cvae as jcvae
from baryon_painter_tpu.train import checkpoint as jckpt
from baryon_painter_tpu.train import schedules as jsched
from baryon_painter_tpu.train import trainer as jtrainer
from baryon_painter_tpu_torch import transforms as ttransforms
from baryon_painter_tpu_torch.convert import to_jax_variables
from baryon_painter_tpu_torch.data.dataset import (BahamasTileDataset,
                                                   BatchLoader)
from baryon_painter_tpu_torch.data.synthetic import make_synthetic_stacks
from baryon_painter_tpu_torch.models.cvae import (CVAE,
                                                  fiducial_cvae_architecture)
from baryon_painter_tpu_torch.painter import CVAEPainter
from baryon_painter_tpu_torch.train import checkpoint as ckpt
from baryon_painter_tpu_torch.train import schedules as tsched
from baryon_painter_tpu_torch.train import trainer as ttrainer
from baryon_painter_tpu_torch.train.run_config import RunConfig
from golden_utils import REPO

TILE = 32


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The loops here run many small CPU ops, which PyTorch's thread pool
    turns slow when the suite's other workers load every core; one thread
    a process keeps this file's time what it is alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stacks"))
    info = make_synthetic_stacks(root, n_stack=3, n_grid=2 * TILE,
                                 redshifts=(0.0, 1.0), seed=0)
    kw = dict(files=load_file_info(info), root_path=root, n_tile=2,
              tile_permutations=True)
    jtf = {f: jtransforms.RangeCompress("shift-log", 4.0)
           for f in ("dm", "pressure")}
    ttf = {f: ttransforms.RangeCompress("shift-log", 4.0)
           for f in ("dm", "pressure")}
    jd = JaxDataset(**kw, n_stack=2, stack_offset=1, transforms=jtf)
    td = BahamasTileDataset(**kw, n_stack=2, stack_offset=1, transforms=ttf)
    jtest = JaxDataset(data=jd.data, n_stack=1, n_tile=2,
                       tile_permutations=True, transforms=jtf)
    ttest = BahamasTileDataset(data=td.data, n_stack=1, n_tile=2,
                               tile_permutations=True, transforms=ttf)
    return jd, td, jtest, ttest


def _arch():
    return fiducial_cvae_architecture(TILE, n_res_blocks=1)


# --------------------------------------------------------------------- #
# the loop's bookkeeping, with the same recorder in both trainers

class Recorder:
    """Stands in for a trainer's step_scan, step and eval_loss: records
    what the loop passes and returns fixed metrics, made in numpy and
    wrapped for the trainer's framework (``wrap``)."""

    def __init__(self, wrap):
        self.wrap = wrap
        self.calls = []

    def _metrics(self, shape=()):
        c = len(self.calls)
        n = int(np.prod(shape))
        base = np.arange(n, dtype=np.float32).reshape(shape) + 2 * c
        m = {"elbo": -100.0 - 0.25 * base, "kl": 0.5 + 0.125 * base,
             "log_likelihood": (-99.5 - 0.25 * base)[..., None],
             "log_likelihood_fixed_var": (-99.0 - 0.375 * base)[..., None],
             "log_likelihood_free_var": (-99.25 - 0.25 * base)[..., None],
             "grad_norm": 1.0 + base}
        return {k: self.wrap(np.asarray(v, np.float32)) for k, v in m.items()}

    def step_scan(self, idx_matrix, lr, alpha_var=1.0, beta_KL=1.0):
        self.calls.append(("scan", np.asarray(idx_matrix).tolist(),
                           float(lr), float(alpha_var), float(beta_KL)))
        return self._metrics((len(idx_matrix),))

    def step(self, batch, lr, alpha_var=1.0, beta_KL=1.0):
        self.calls.append(("step", np.asarray(batch["idx"]).tolist(),
                           float(lr), float(alpha_var), float(beta_KL)))
        return self._metrics()

    def eval_loss(self, batch, alpha_var=1.0, beta_KL=1.0):
        self.calls.append(("eval", np.asarray(batch["idx"]).tolist(),
                           float(alpha_var), float(beta_KL)))
        return self._metrics()


def _loop_config(out, fiducial_batch, linear_anneal):
    # the fiducial batch ramp (4, 8, 16, 24 at pepochs 0, 8, 16, 32) over
    # 70 pepochs of 12 samples, past the fiducial lr decay's pepoch 64
    return dict(
        learning_rate=1e-3, batch_size=4, n_pepoch=70, pepoch_size=12,
        adaptive_batch_size=fiducial_batch,
        var_anneal_fn=linear_anneal(2, 10),
        KL_anneal_fn=linear_anneal(0, 5, 0.5, 1.0),
        validation_loss_frequency=40, validation_loss_batch_size=3,
        checkpoint_frequency=150, keep_last_checkpoints=2,
        statistics_report_frequency=30, stats_sync_every=4,
        seed=5, verbose=True, output_path=str(out))


@pytest.mark.parametrize("lr_schedule", ["fiducial", "plateau"])
@pytest.mark.parametrize("device_data", [True, False],
                         ids=["device_data", "host_data"])
def test_loop_bookkeeping_matches_jax(data, tmp_path, device_data,
                                      lr_schedule, capsys):
    jd, td, jtest, ttest = data
    runs = {}
    for name, pkg, ds, test, wrap in (
            ("jax", jtrainer, jd, jtest, jnp.asarray),
            ("port", ttrainer, td, ttest, torch.from_numpy)):
        sched = jsched if name == "jax" else tsched
        cfg = _loop_config(tmp_path / name,
                           sched.fiducial_adaptive_batch_size,
                           sched.linear_anneal)
        cfg["adaptive_learning_rate"] = (
            sched.ReduceLROnPlateau(patience=1) if lr_schedule == "plateau"
            else (lambda p, s=sched: s.fiducial_adaptive_lr(p)))
        if name == "jax":
            tr = pkg.CVAETrainer(jcvae.CVAE(_arch()), ds, test_data=test,
                                 config=pkg.TrainConfig(**cfg),
                                 device_data=device_data)
        else:
            tr = pkg.CVAETrainer(CVAE(_arch()), ds, test_data=test,
                                 config=pkg.TrainConfig(**cfg),
                                 device_data=device_data, device="cpu")
        rec = Recorder(wrap)
        tr.step_scan, tr.step, tr.eval_loss = (rec.step_scan, rec.step,
                                               rec.eval_loss)
        capsys.readouterr()
        tr.train()
        runs[name] = (rec.calls, capsys.readouterr().out,
                      cfg["adaptive_learning_rate"])
    (jcalls, jout, jsch), (tcalls, tout, tsch) = runs["jax"], runs["port"]
    assert tcalls == jcalls
    kinds = {c[0] for c in jcalls}
    assert kinds == ({"scan", "eval"} if device_data else {"step", "eval"})
    lrs = {c[2] for c in jcalls if c[0] != "eval"}
    sizes = {len(c[1][0]) if c[0] == "scan" else len(c[1])
             for c in jcalls if c[0] != "eval"}
    assert sizes == {4, 8, 16, 24} and len(lrs) >= 2
    rate = re.compile(r"\([0-9.]+ samples/s\)")
    assert rate.sub("", tout) == rate.sub("", jout) and "P-Epoch" in jout
    if lr_schedule == "plateau":
        assert tsch.state_array() == jsch.state_array()
        assert tsch.multiplier < 1.0

    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))
    assert len([f for f in os.listdir(jdir)
                if f.startswith("checkpoint")]) == 4
    for fn in ("training_stats.txt", "validation_stats.txt"):
        assert (tdir / fn).read_bytes() == (jdir / fn).read_bytes(), fn
    for f in os.listdir(jdir):
        if f.endswith("_state.msgpack"):
            base = f[:-len("_state.msgpack")]
            jraw, _ = jckpt.load_checkpoint(str(jdir / base))
            traw, _ = ckpt.load_checkpoint(str(tdir / base))
            for key in ("progress", "data_rng", "lr_sched", "step"):
                assert (key in traw) == (key in jraw), key
                if key in jraw:
                    np.testing.assert_array_equal(traw[key], jraw[key])
                    assert traw[key].dtype == jraw[key].dtype


# --------------------------------------------------------------------- #
# resume, bit for bit

def _resume_config(out):
    return ttrainer.TrainConfig(
        learning_rate=1e-3, batch_size=2, n_pepoch=3, pepoch_size=8,
        adaptive_batch_size=lambda p: 2 if p < 1 else 4,
        adaptive_learning_rate=tsched.ReduceLROnPlateau(patience=0),
        var_anneal_fn=lambda p: min(1.0, 0.5 * (p + 1)),
        validation_loss_frequency=8, validation_loss_batch_size=2,
        checkpoint_frequency=8, statistics_report_frequency=4,
        stats_sync_every=4, seed=7, output_path=str(out))


@pytest.mark.parametrize("device_data", [True, False],
                         ids=["device_data", "host_data"])
def test_resume_equals_the_uninterrupted_run_bit_for_bit(data, tmp_path,
                                                         device_data):
    _, td, _, ttest = data

    def build(out):
        return ttrainer.CVAETrainer(CVAE(_arch()), td, test_data=ttest,
                                    config=_resume_config(out),
                                    device_data=device_data, device="cpu")

    full, resumed = tmp_path / "full", tmp_path / "resumed"
    a = build(full)
    a.train()
    resumed.mkdir()
    first = "checkpoint_sample0000000008"
    for f in os.listdir(full):
        if f.startswith(first) or f.endswith(".txt"):
            shutil.copy(full / f, resumed / f)
    b = build(resumed)
    b.restore(str(resumed / first))
    assert b._progress["n_samples"] == 8 and b.steps == 4
    b.train()

    for fn in ("training_stats.txt", "validation_stats.txt"):
        assert (resumed / fn).read_bytes() == (full / fn).read_bytes(), fn
    sa, sb = a.state_tree(), b.state_tree()
    for key in ("params", "batch_stats", "opt_state", "step", "data_rng",
                "lr_sched"):
        jax.tree.map(np.testing.assert_array_equal, sb[key], sa[key])
    for p, q in zip(a.params, b.params):
        assert torch.equal(p, q)


# --------------------------------------------------------------------- #
# the CLI twin

def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def twin():
    return _load(os.path.join(REPO, "scripts", "train_cvae_torch.py"),
                 "train_cvae_torch")


class _Parsed(Exception):
    pass


def test_cli_defaults_equal_the_jax_clis(twin, monkeypatch):
    import argparse

    def capture(self, args=None, namespace=None):
        raise _Parsed(self)

    def flags(parse):
        with pytest.raises(_Parsed) as parsed:
            parse()
        return {a.dest: (a.default, a.option_strings, a.required,
                         a.choices, a.type, type(a).__name__)
                for a in parsed.value.args[0]._actions}

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", capture)
    want = flags(_load(os.path.join(REPO, "scripts", "train_cvae.py"),
                       "train_cvae").main)
    got = flags(lambda: twin.parse_args([]))
    assert set(got) - set(want) == {"device"}
    for dest in want:
        assert got[dest] == want[dest], dest


def _cli_args(out, *extra):
    return ["--synthetic", "--synthetic-grid", "64", "--n-tile", "2",
            "--n-training-stack", "2", "--n-validation-stack", "1",
            "--n-pepoch", "2", "--pepoch-size", "8", "--n-res-blocks", "1",
            "--output-path", str(out), "--device", "cpu", "--device-data",
            *extra]


@pytest.mark.parametrize("dtype, env", [
    ("float32", {}),
    ("bfloat16", {"BPT_FUSED_HEADS": "1", "BPT_FUSED_TRAIN_CONV": "1"})],
    ids=["f32", "bf16_k3_k4"])
def test_cli_trains_checkpoints_and_resumes_on_the_cpu(twin, tmp_path,
                                                       monkeypatch, dtype,
                                                       env):
    """The twin trains, checkpoints and resumes bit for bit, in f32 and in
    bf16 with K3's and K4's switches set (their plain versions here)."""
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    cfg = RunConfig(
        architecture=_arch(),
        transforms={f: {"type": "range_compress", "mode": "shift-log",
                        "k": 4.0, "eps": 1e-4} for f in ("dm", "pressure")},
        schedules={"batch_size_schedule": {"kind": "constant", "value": 2},
                   "lr_schedule": {"kind": "avoid_plateau"}},
        train=dict(validation_loss_frequency=4,
                   validation_loss_batch_size=2, checkpoint_frequency=8,
                   statistics_report_frequency=4))
    cfg.save(str(tmp_path / "cfg.json"))
    out = tmp_path / "run"
    res = twin.run(_cli_args(out, "--config", str(tmp_path / "cfg.json"),
                             "--dtype", dtype))
    tr = res["trainer"]
    assert tr.steps == 8 and res["seconds"] > 0
    assert tr.model.dtype == (torch.bfloat16 if env else None)
    assert tr.model.fused_heads == tr.model.p_y_z_in.fused_train_conv \
        == bool(env)
    assert sorted(f for f in os.listdir(out) if f.endswith(".msgpack")) == [
        "checkpoint_sample0000000008_state.msgpack",
        "checkpoint_sample0000000016_state.msgpack", "model_state.msgpack"]
    _, meta = ckpt.load_checkpoint(str(out / "model"))
    assert RunConfig.from_dict(meta["run_config"]).schedules == cfg.schedules
    assert RunConfig.load(str(out / "run_config.json")).train[
        "validation_loss_frequency"] == 4
    # resume from the first checkpoint into a copy of the run
    again = tmp_path / "again"
    shutil.copytree(out, again)
    res2 = twin.run(_cli_args(again, "--config", str(tmp_path / "cfg.json"),
                              "--dtype", dtype, "--resume-from",
                              str(again / "checkpoint_sample0000000008")))
    for fn in ("training_stats.txt", "validation_stats.txt"):
        assert (again / fn).read_bytes() == (out / fn).read_bytes()
    sa, sb = tr.state_tree(), res2["trainer"].state_tree()
    for key in ("params", "batch_stats", "opt_state", "step", "data_rng",
                "lr_sched"):
        jax.tree.map(np.testing.assert_array_equal, sb[key], sa[key])
    for p, q in zip(tr.params, res2["trainer"].params):
        assert torch.equal(p, q)


@pytest.mark.parametrize("flag", ["--profile"], ids=["profile"])
def test_cli_refuses_what_is_not_ported(twin, tmp_path, flag):
    """What the twin refused before the run tooling was ported runs now:
    ``--profile LOG_DIR`` writes a torch.profiler Chrome trace of the run,
    and the run saves the JAX CLI's figures at its validation pepochs."""
    res = twin.run(_cli_args(tmp_path / "run", flag,
                             str(tmp_path / "trace")))
    assert res["trace"] == str(tmp_path / "trace" / "trace.json")
    with open(res["trace"]) as f:
        assert json.load(f)["traceEvents"]
    for name in ("sample", "auto_power_spectrum", "cross_power_spectrum",
                 "log_histogram"):
        for pepoch in (0, 1):
            assert (tmp_path / "run" / f"{name}_pepoch{pepoch}.png").stat(
            ).st_size > 0


def test_cli_trains_with_the_spectral_loss(twin, tmp_path):
    """--pk-loss-weight and --pk-loss-per-z reach the trainer's config and
    the run config in run_config.json and the checkpoint's meta, and the
    run's steps carry a finite pk_loss."""
    res = twin.run(_cli_args(tmp_path, "--pk-loss-weight", "2e4",
                             "--pk-loss-per-z"))
    cfg = res["trainer"].config
    assert cfg.pk_loss_weight == 2e4 and cfg.pk_loss_per_z
    for train in (RunConfig.load(str(tmp_path / "run_config.json")).train,
                  ckpt.load_checkpoint(str(tmp_path / "model"))[1][
                      "run_config"]["train"]):
        assert train["pk_loss_weight"] == 2e4 and train["pk_loss_per_z"]
    m = res["trainer"].step_indices(np.arange(2), 1e-4)
    assert np.isfinite(m["pk_loss"].item()) and m["pk_loss"].item() > 0


def test_what_the_loop_refuses(data, monkeypatch):
    _, td, _, ttest = data
    tr = ttrainer.CVAETrainer(CVAE(_arch()), td, test_data=ttest,
                              device="cpu")
    loader = BatchLoader(td, 2, raw=False)
    try:
        assert next(loader)[0].shape == (2, 2, 1, TILE, TILE)
    finally:
        loader.close()
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        tr.validate()
    with pytest.raises(RuntimeError, match="no test data"):
        ttrainer.CVAETrainer(CVAE(_arch()), td, device="cpu").validate(
            compute_loss=True)
    with pytest.raises(RuntimeError, match="train"):
        CVAEPainter(architecture=_arch(), training_data_set=td,
                    device="cpu").validate(compute_loss=True)


# --------------------------------------------------------------------- #
# the rest of the surface

def test_stats_labels_match_jax():
    arch = _arch()
    assert CVAE(arch).get_stats_labels() == jcvae.CVAE(
        arch).get_stats_labels()
    arch = dict(arch, p_y_z_out=arch["p_y_z_out"][:1])
    assert CVAE(arch).get_stats_labels() == jcvae.CVAE(
        arch).get_stats_labels() == ["ELBO", "KL_term", "log_likelihood_0"]


def test_validation_loss_matches_jax(data):
    jd, td, jtest, ttest = data
    eps = np.random.default_rng(3).standard_normal(
        (8, 1, 1, 1)).astype(np.float32)

    def sample_z(self, rng, z_mu, z_log_var, L=1):
        e = jnp.asarray(eps)[None].transpose(0, 1, 3, 4, 2)[
            :, :z_mu.shape[0]]
        z = z_mu[None] + e * (jnp.exp(z_log_var[None] / 2) + self.min_z_var)
        return z.reshape(-1, *z_mu.shape[1:])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcvae.CVAE, "sample_z", sample_z)
        jt = jtrainer.CVAETrainer(jcvae.CVAE(_arch()), jd, test_data=jtest)
        want = jt.validate(validation_batch_size=8, compute_loss=True,
                           seed=4)
        init = jax.tree.map(np.asarray, {"params": jt.state.params,
                                         "batch_stats": jt.state.batch_stats})
    tr = ttrainer.CVAETrainer(CVAE(_arch()), td, test_data=ttest,
                              device="cpu", variables=init)
    eval_loss = tr.eval_loss
    tr.eval_loss = lambda batch, **kw: eval_loss(batch, eps=eps, **kw)
    got = tr.validate(validation_batch_size=8, compute_loss=True, seed=4)
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-4)


def test_painter_trains_and_paints(data, tmp_path):
    _, td, _, ttest = data
    painter = CVAEPainter(architecture=_arch(), training_data_set=td,
                          test_data_set=ttest, device="cpu")
    tstats, vstats = painter.train(
        n_pepoch=1, batch_size=2, pepoch_size=4, device_data=True,
        output_path=str(tmp_path), validation_loss_frequency=2,
        validation_loss_batch_size=2)
    assert tstats.n_batches == 2 and vstats.n_batches == 2
    tiles = td.get_raw_batch(np.arange(2))["input"]
    zs = np.zeros(2, np.float32)
    got = painter.paint_batch(tiles, zs, z_mode="mean")
    assert bool(torch.isfinite(got).all())
    on_disk = CVAEPainter(str(tmp_path / "model"), device="cpu")
    assert torch.equal(on_disk.paint_batch(tiles, zs, z_mode="mean"), got)
    row = painter.validate(validation_batch_size=2, compute_loss=True)
    assert len(row) == 5 and np.isfinite(row).all()
    jax.tree.map(np.testing.assert_array_equal,
                 to_jax_variables(painter.trainer.model)["params"],
                 painter.variables["params"])


def test_batch_loader_prefetches_raw_batches(data):
    _, td, _, _ = data
    loader = BatchLoader(td, 3, seed=9, z=1.0)
    try:
        batches = [next(loader) for _ in range(3)]
    finally:
        loader.close()
    assert not loader._thread.is_alive()
    rng = np.random.default_rng(9)
    for b in batches:
        want = td.get_raw_batch(td.sample_indices(rng, 3, z=1.0))
        for k in want:
            np.testing.assert_array_equal(b[k], want[k])
