"""The port's CGAN training run (``CGANTrainer.train``), its resume and its
CLI twin (scripts/train_cgan_torch.py), on the CPU.

``train()`` against the JAX package's ``CGANTrainer.train()`` from the same
initial state (the JAX trainer's, carried across) on the same data (64^2
stacks, 32^2 tiles, ``n_res_blocks=1``, batch 2): 2 pepochs of 8 samples,
the stack cache (so 4-step scans), validation and a checkpoint every 8
samples. Both loops draw the same indices from the same data RNG, so the
statistics files are compared row for row, rtol 1e-5 (the JAX test's own
tolerance for its resume, tests/test_cgan.py), at lr 1e-7: Adam's first
steps move every parameter by about lr whatever the size of its gradient,
so an entry whose gradient is at rounding level (the biases ahead of a
batch norm have gradient 0) moves by +-lr in either package, and at the
reference's 5e-5 the two runs' statistics drift 4.3e-4 apart in 7 steps
(measured on this test's data) while each step alone agrees to 1e-5
(tests/test_torch_cgan_train.py). The loop's bookkeeping (which indices
each scan and validation takes, at which lr) is compared exactly, with
both trainers' steps replaced by one recorder. A run resumed from its
first checkpoint equals the uninterrupted one bit for bit (the step draws
no noise, and the CPU sums in a fixed order).
"""
import os
import shutil
import sys

import jax
import numpy as np
import pytest
import torch

from baryon_painter_tpu.data.dataset import BahamasTileDataset as JaxDataset
from baryon_painter_tpu.data.dataset import load_file_info
from baryon_painter_tpu.models.cgan import CGANDiscriminator as JaxD
from baryon_painter_tpu.models.cgan import CGANGenerator as JaxG
from baryon_painter_tpu.train import cgan as jcgan
from baryon_painter_tpu.transforms import RangeCompress as JaxRC
from baryon_painter_tpu_torch.data.dataset import BahamasTileDataset
from baryon_painter_tpu_torch.data.synthetic import make_synthetic_stacks
from baryon_painter_tpu_torch.models.cgan import CGANGenerator
from baryon_painter_tpu_torch.train.cgan import (CGANTrainConfig,
                                                 CGANTrainer)
from baryon_painter_tpu_torch.transforms import RangeCompress
from golden_utils import REPO

TILE, BATCH = 32, 2
RUN = dict(seed=7, batch_size=BATCH, n_pepoch=2, pepoch_size=8,
           stats_sync_every=4, checkpoint_frequency=8,
           validation_loss_frequency=8, validation_loss_batch_size=2,
           statistics_report_frequency=0, learning_rate=1e-7)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread a process: the suite's other workers load every
    core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stacks"))
    info = make_synthetic_stacks(root, n_stack=2, n_grid=2 * TILE,
                                 redshifts=(0.0, 1.0), seed=0)
    kw = dict(files=load_file_info(info), root_path=root, n_tile=2,
              tile_permutations=True)
    jd = JaxDataset(**kw, transforms={"dm": JaxRC("shift-log", 4.0),
                                      "pressure": JaxRC("shift-log", 4.0)})
    td = BahamasTileDataset(
        **kw, transforms={"dm": RangeCompress("shift-log", 4.0),
                          "pressure": RangeCompress("shift-log", 4.0)})
    return jd, td


def _read_stats(path):
    with open(path) as f:
        lines = f.read().splitlines()
    return lines[0], np.array([[float(v) for v in l.split()]
                               for l in lines[1:]])


def _port(td, out, state, **cfg):
    return CGANTrainer(td, test_data=td,
                       generator=CGANGenerator(n_res_blocks=1,
                                               spectral_norm=True),
                       config=CGANTrainConfig(output_path=str(out),
                                              **{**RUN, **cfg}),
                       device_data=True, device="cpu", state=state)


@pytest.fixture(scope="module")
def runs(data, tmp_path_factory):
    """The JAX run and the port's from the JAX initial state."""
    jd, td = data
    root = tmp_path_factory.mktemp("runs")
    jt = jcgan.CGANTrainer(jd, test_data=jd,
                           generator=JaxG(n_res_blocks=1),
                           discriminator=JaxD(),
                           config=jcgan.CGANTrainConfig(
                               output_path=str(root / "jax"), **RUN),
                           device_data=True)
    init = {k: jax.tree.map(np.asarray, getattr(jt.state, k))
            for k in ("g_params", "g_stats", "d_params", "d_stats")}
    jt.train()
    tr = _port(td, root / "port", init)
    tr.train()
    return root, init, tr


def test_train_statistics_against_jax(runs):
    root, _, _ = runs
    for fn in ("training_stats.txt", "validation_stats.txt"):
        header_j, rows_j = _read_stats(root / "jax" / fn)
        header_p, rows_p = _read_stats(root / "port" / fn)
        assert header_p == header_j
        assert rows_p.shape == rows_j.shape and len(rows_p) > 0, fn
        np.testing.assert_allclose(rows_p, rows_j, rtol=1e-5, atol=1e-7,
                                   err_msg=fn)
    assert sorted(os.listdir(root / "port")) == sorted(
        os.listdir(root / "jax"))


class _Recorder:
    """Stands in for a trainer's steps and validation loss: records what
    the loop hands them and returns fixed metrics."""

    def __init__(self, backend):
        self.calls, self.backend = [], backend

    def metrics(self, k=None):
        shape = () if k is None else (k,)
        vals = {"loss_D": 1.0, "loss_G_adv": 2.0, "loss_G_perceptual": 3.0,
                "D_real": 0.5, "D_fake": 0.25, "pk_loss": 0.0,
                "grad_norm": 1.0, "d_grad_norm": 1.0}
        if self.backend == "jax":
            return {k: np.full(shape, v, np.float32)
                    for k, v in vals.items()}
        return {k: torch.full(shape, v) for k, v in vals.items()}

    def step_scan(self, idx, lr):
        self.calls.append(("scan", np.asarray(idx).tolist(), float(lr)))
        return self.metrics(len(idx))

    def eval_loss(self, batch):
        self.calls.append(("eval", np.asarray(batch["input"]).sum().item()))
        return self.metrics()


def test_train_loop_bookkeeping_against_jax(data, tmp_path):
    """Both loops with their steps and validation losses recorded: the same
    calls (indices, lr), the same statistics files, checkpoints and
    progress, over 3 pepochs of 12 samples at batch 2 with validation
    every 6 (so scans of 2 and then 1 step up to each validation point)."""
    jd, td = data
    run = {**RUN, "n_pepoch": 3, "pepoch_size": 12, "checkpoint_frequency":
           12, "validation_loss_frequency": 6, "lr_decay": 0.5}
    jt = jcgan.CGANTrainer(jd, test_data=jd, generator=JaxG(n_res_blocks=1),
                           discriminator=JaxD(),
                           config=jcgan.CGANTrainConfig(
                               output_path=str(tmp_path / "jax"), **run),
                           device_data=True)
    tr = CGANTrainer(td, test_data=td,
                     generator=CGANGenerator(n_res_blocks=1,
                                             spectral_norm=True),
                     config=CGANTrainConfig(
                         output_path=str(tmp_path / "port"), **run),
                     device_data=True, device="cpu")
    jrec, prec = _Recorder("jax"), _Recorder("port")
    jt.step_scan, jt.eval_loss = jrec.step_scan, jrec.eval_loss
    tr.step_scan, tr.eval_loss = prec.step_scan, prec.eval_loss
    jt.save = tr.save = lambda base, include_opt_state=True: open(
        base + "_state.msgpack", "w").close()
    jt.train()
    tr.train()
    assert prec.calls == jrec.calls
    assert [len(c[1]) for c in prec.calls if c[0] == "scan"][:3] == [2, 1, 2]
    assert {c[2] for c in prec.calls if c[0] == "scan"} == {
        1e-7 * 0.5 ** i for i in range(3)}
    for fn in ("training_stats.txt", "validation_stats.txt"):
        assert (tmp_path / "port" / fn).read_text() == (
            tmp_path / "jax" / fn).read_text()
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))
    assert tr._progress == jt._progress


def test_train_writes_the_jax_checkpoint_layout(runs):
    from baryon_painter_tpu_torch.train import checkpoint as ckpt
    root, _, tr = runs
    port, meta = ckpt.load_checkpoint(str(root / "port" / "model"),
                                      keep_optimizer=True)
    jax_state, jax_meta = ckpt.load_checkpoint(str(root / "jax" / "model"),
                                               keep_optimizer=True)
    assert meta == jax_meta and meta["model_kind"] == "cgan"

    def keys(tree, prefix=""):
        out = set()
        for k, v in tree.items():
            out |= (keys(v, f"{prefix}{k}/") if isinstance(v, dict)
                    else {prefix + k})
        return out
    assert keys(port) == keys(jax_state)
    np.testing.assert_array_equal(port["progress"], jax_state["progress"])
    np.testing.assert_array_equal(port["data_rng"], jax_state["data_rng"])
    assert int(port["step"]) == int(jax_state["step"]) == 8
    assert tr.steps == 8


def test_resume_equals_the_uninterrupted_run(runs, data, tmp_path):
    root, init, tr = runs
    _, td = data
    first = "checkpoint_sample0000000008"
    for f in os.listdir(root / "port"):
        if f.startswith(first) or f.endswith(".txt"):
            shutil.copy(root / "port" / f, tmp_path / f)
    resumed = _port(td, tmp_path, init)
    resumed.restore(str(tmp_path / first))
    assert resumed._progress["n_samples"] == 8 and resumed.steps == 4
    resumed.train()
    for fn in ("training_stats.txt", "validation_stats.txt",
               "model_state.msgpack"):
        assert (tmp_path / fn).read_bytes() == (root / "port" / fn
                                                ).read_bytes(), fn


def test_train_on_host_batches_without_the_cache(data, tmp_path):
    """Without the stack cache the loop steps on host batches, one at a
    time, with the same draws: the same statistics as with it."""
    _, td = data
    cached = _port(td, tmp_path / "cached", None, n_pepoch=1)
    cached.train()
    host = CGANTrainer(td, test_data=td,
                       generator=CGANGenerator(n_res_blocks=1,
                                               spectral_norm=True),
                       config=CGANTrainConfig(
                           output_path=str(tmp_path / "host"),
                           **{**RUN, "n_pepoch": 1}), device="cpu")
    host.train()
    for fn in ("training_stats.txt", "validation_stats.txt"):
        _, a = _read_stats(tmp_path / "cached" / fn)
        _, b = _read_stats(tmp_path / "host" / fn)
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-8, err_msg=fn)


# --------------------------------------------------------------------- #
# the CLI twin

sys.path.insert(0, os.path.join(REPO, "scripts"))


def _cli(tmp_path, *extra):
    import train_cgan_torch
    return train_cgan_torch.run([
        "--synthetic", "--synthetic-grid", str(2 * TILE), "--n-tile", "2",
        "--n-res-blocks", "1", "--batch-size", str(BATCH), "--n-pepoch",
        "2", "--pepoch-size", "4", "--checkpoint-frequency", "4",
        "--output-path", str(tmp_path), "--device", "cpu", "--device-data",
        *extra])


def test_train_cgan_cli_synthetic_and_resume(tmp_path):
    res = _cli(tmp_path / "run")
    trainer = res["trainer"]
    assert trainer.steps == 4 and trainer.config.lambda_perceptual == 2.5
    assert trainer.config.learning_rate == 5e-5 and trainer.device_cache
    files = set(os.listdir(tmp_path / "run"))
    assert {"model_state.msgpack", "model_meta.json", "training_stats.txt",
            "checkpoint_sample0000000004_state.msgpack"} <= files
    assert res["validation_stats"].n_batches == 0   # no test data
    # the JAX package restores the twin's checkpoint
    from baryon_painter_tpu.data.synthetic import \
        make_synthetic_stacks as jax_stacks
    root = str(tmp_path / "jaxdata")
    info = jax_stacks(root, n_stack=2, n_grid=2 * TILE,
                      redshifts=(0.0, 1.0))
    jd = JaxDataset(files=load_file_info(info), root_path=root, n_tile=2,
                    transforms={"dm": JaxRC("shift-log", 4.0),
                                "pressure": JaxRC("shift-log", 4.0)})
    jt = jcgan.CGANTrainer(jd, generator=JaxG(n_res_blocks=1),
                           discriminator=JaxD(),
                           config=jcgan.CGANTrainConfig(batch_size=BATCH))
    meta = jt.restore(str(tmp_path / "run" / "model"))
    assert meta["model_kind"] == "cgan" and int(jt.state.step) == 4
    assert jt._progress["n_samples"] == 8
    # the twin resumes its own checkpoint: 3 pepochs in all
    more = _cli(tmp_path / "run", "--n-pepoch", "3", "--resume-from",
                str(tmp_path / "run" / "model"))
    assert more["trainer"].steps == 6
    assert more["training_stats"].n_batches == 6


def test_train_cgan_cli_flags_reach_the_config(tmp_path):
    import train_cgan_torch
    args = train_cgan_torch.parse_args([
        "--output-path", str(tmp_path), "--synthetic", "--clip-grad", "2",
        "--keep-last-checkpoints", "3", "--lambda-perceptual", "1.5",
        "--validation-loss-frequency", "12", "--n-res-blocks", "2"])
    assert args.device is None and args.batch_size == 6
    assert args.n_pepoch == 96 and args.pepoch_size == 1568
    args.device = "cpu"
    args.synthetic_grid, args.n_tile = 64, 2
    tr = train_cgan_torch.build(args)
    cfg = tr.config
    assert (cfg.clip_grad_norm, cfg.keep_last_checkpoints,
            cfg.lambda_perceptual, cfg.validation_loss_frequency) == (
        2.0, 3, 1.5, 12)
    assert tr.generator.n_res_blocks == 2 and tr.generator.spectral_norm
    assert tr.device_cache is None and tr.test_data is None
