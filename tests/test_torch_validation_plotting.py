"""``utils/validation_plotting.py`` and the trainers' ``validate`` figures in
the port against the JAX package's.

``power_spectrum_fractional_error`` (one batched spectrum of the port's
estimator) gives the JAX package's per-tile values on the same fields and
inverse transforms, auto and cross, to 1e-5 relative. ``validate`` on the
CVAE trainer (with the JAX painter's prior noise, drawn with
``jax.random``) and on the CGAN trainer, at 32^2 from the same weights,
gives the JAX trainers' figure keys and saves the same files; its painted
batch equals the JAX trainer's. Without matplotlib a call that asks for
figures raises an ImportError naming it, before any work.
"""
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
from baryon_painter_tpu.models.cgan import CGANDiscriminator as JaxD
from baryon_painter_tpu.models.cgan import CGANGenerator as JaxG
from baryon_painter_tpu.train import cgan as jcgan
from baryon_painter_tpu.train import trainer as jtrainer
from baryon_painter_tpu.utils import validation_plotting as jvp
from baryon_painter_tpu_torch import transforms as ttransforms
from baryon_painter_tpu_torch.data.dataset import BahamasTileDataset
from baryon_painter_tpu_torch.data.synthetic import make_synthetic_stacks
from baryon_painter_tpu_torch.models.cgan import CGANGenerator
from baryon_painter_tpu_torch.models.cvae import (CVAE,
                                                  fiducial_cvae_architecture)
from baryon_painter_tpu_torch.train.cgan import CGANTrainer
from baryon_painter_tpu_torch.train.trainer import CVAETrainer
from baryon_painter_tpu_torch.utils import validation_plotting as tvp

TILE = 32
BATCH = 4
SPECTRA = ["auto", "cross"]


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stacks"))
    info = make_synthetic_stacks(root, n_stack=2, n_grid=2 * TILE,
                                 redshifts=(0.0, 1.0), seed=0)
    kw = dict(files=load_file_info(info), root_path=root, n_tile=2,
              tile_permutations=True)
    jtf = {f: jtransforms.RangeCompress("shift-log", 4.0)
           for f in ("dm", "pressure")}
    ttf = {f: ttransforms.RangeCompress("shift-log", 4.0)
           for f in ("dm", "pressure")}
    return (JaxDataset(**kw, transforms=jtf),
            BahamasTileDataset(**kw, transforms=ttf))


@pytest.mark.parametrize("mode", SPECTRA)
def test_power_spectrum_fractional_error_matches_jax(data, mode):
    jd, td = data
    rng = np.random.default_rng(1)
    shape = (3, 1, TILE, TILE)
    true, pred, inp = (rng.uniform(-1, 1, shape).astype(np.float32)
                       for _ in range(3))
    zs = (0.0, 1.0, 0.5)
    jinv = [jd.get_inverse_transforms(z=z) for z in zs]
    tinv = [td.get_inverse_transforms(z=z) for z in zs]
    k_j, want = jvp.power_spectrum_fractional_error(
        true, pred, inp, L=td.tile_L, mode=mode,
        output_inverse_transforms=[t[1:] for t in jinv],
        input_inverse_transforms=[t[0] for t in jinv])
    k_t, got = tvp.power_spectrum_fractional_error(
        torch.from_numpy(true), torch.from_numpy(pred),
        torch.from_numpy(inp), L=td.tile_L, mode=mode,
        output_inverse_transforms=[t[1:] for t in tinv],
        input_inverse_transforms=[t[0] for t in tinv], device="cpu")
    np.testing.assert_allclose(k_t, k_j, rtol=1e-6)
    assert got.shape == want.shape == (3, 1, 20)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError, match="Invalid mode"):
        tvp.power_spectrum_fractional_error(true, pred, inp, L=1.0,
                                            mode="bogus")


@pytest.mark.parametrize("kind", ["tensor", "numpy"])
def test_fractional_error_default_device(kind):
    """Without ``device``, a tensor is scored on its own device and a host
    array on the card, which this CPU-only host lacks."""
    rng = np.random.default_rng(2)
    true, pred, inp = (rng.uniform(-1, 1, (2, 1, 8, 8)).astype(np.float32)
                       for _ in range(3))
    if kind == "numpy":
        if torch.cuda.is_available():
            pytest.skip("a card is present: numpy input would run there")
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tvp.power_spectrum_fractional_error(true, pred, inp, L=1.0,
                                                n_k_bin=4)
        return
    k, got = tvp.power_spectrum_fractional_error(
        *map(torch.from_numpy, (true, pred, inp)), L=1.0, n_k_bin=4)
    _, want = tvp.power_spectrum_fractional_error(true, pred, inp, L=1.0,
                                                  n_k_bin=4, device="cpu")
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def cvae_pair(data):
    jd, td = data
    arch = fiducial_cvae_architecture(TILE, n_res_blocks=1)
    jt = jtrainer.CVAETrainer(jcvae.CVAE(arch), jd, test_data=jd)
    variables = {"params": _np(jt.state.params),
                 "batch_stats": _np(jt.state.batch_stats)}
    pt = CVAETrainer(CVAE(arch), td, test_data=td, variables=variables,
                     device="cpu")
    # the JAX validate's prior noise: PRNGKey(seed)'s first "sample" key
    key = jt.model.apply(variables, method=lambda m: m.make_rng("sample"),
                         rngs={"sample": jax.random.PRNGKey(0)})
    h = TILE // 32
    eps = np.asarray(jax.random.normal(key, (1, BATCH, h, h, 1)))
    return jt, pt, torch.from_numpy(eps[0].transpose(0, 3, 1, 2).copy())


@pytest.fixture(scope="module")
def cgan_pair(data):
    jd, td = data
    jt = jcgan.CGANTrainer(jd, test_data=jd,
                           generator=JaxG(n_res_blocks=1),
                           discriminator=JaxD(),
                           config=jcgan.CGANTrainConfig(seed=0,
                                                        batch_size=2))
    state = {k: _np(getattr(jt.state, k))
             for k in ("g_params", "g_stats", "d_params", "d_stats")}
    pt = CGANTrainer(td, test_data=td,
                     generator=CGANGenerator(n_res_blocks=1,
                                             spectral_norm=True),
                     device="cpu", state=state)
    return jt, pt


def _saved(figs, template):
    import matplotlib.pyplot as plt
    sizes = {}
    for k, fig in figs.items():
        with open(template.format(plot_type=k), "rb") as f:
            sizes[k] = len(f.read())
        plt.close(fig)
    return sizes


@pytest.mark.parametrize("model", ["cvae", "cgan"])
def test_validate_figures_match_jax(cvae_pair, cgan_pair, tmp_path, model):
    if model == "cvae":
        jt, pt, eps = cvae_pair
        kw = dict(plot_sample_var=True, plot_power_spectra=SPECTRA,
                  plot_histogram=["log"])
        extra = {"eps": eps}
    else:
        (jt, pt), eps = cgan_pair, None
        kw = dict(plot_power_spectra=SPECTRA, plot_histogram=["log"])
        extra = {}
    figs = {}
    for name, tr, more in (("jax", jt, {}), ("port", pt, extra)):
        template = str(tmp_path / f"{name}_{model}_{{plot_type}}.png")
        figs[name] = _saved(tr.validate(validation_batch_size=BATCH,
                                        save_plots=True,
                                        filename_template=template, **kw,
                                        **more), template)
    assert sorted(figs["port"]) == sorted(figs["jax"]) == sorted(
        ["sample", "auto_power_spectrum", "cross_power_spectrum",
         "log_histogram"])
    assert all(figs["port"].values())
    # the painted batch: the JAX trainer's
    sample = pt.validation_sample(BATCH, **(
        {"eps": eps, "return_var": True} if model == "cvae" else {}))
    batch = jt.test_data.get_raw_batch(jt.test_data.sample_indices(
        np.random.default_rng(0), BATCH))
    zs = jnp.asarray(batch["z"])
    if model == "cvae":
        x, y = jt._prepare(jnp.asarray(batch["input"]),
                           jnp.asarray(batch["labels"]), zs)
        want = jt.model.apply(
            {"params": jt.state.params, "batch_stats": jt.state.batch_stats},
            y, zs, return_var=False, train=False,
            rngs={"sample": jax.random.PRNGKey(0)},
            method=jt.model.sample_P)
    else:
        x, y = jt._prepare(jnp.asarray(batch["input"]),
                           jnp.asarray(batch["labels"][0]), zs)
        want = jt.generator.apply({"params": jt.state.g_params,
                                   "batch_stats": jt.state.g_stats},
                                  y, zs, train=False)
    want = np.moveaxis(np.asarray(want, np.float32), -1, 1)
    np.testing.assert_array_equal(sample["z"], batch["z"])
    np.testing.assert_allclose(sample["x"].numpy(),
                               np.moveaxis(np.asarray(x), -1, 1),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(sample["pred"].numpy(), want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def test_figures_without_matplotlib_raise_first(cvae_pair, monkeypatch):
    """An ImportError that names matplotlib, before the batch is drawn."""
    _, pt, _ = cvae_pair
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)

    def no_work(*a, **k):
        raise AssertionError("validate worked before it raised")
    monkeypatch.setattr(pt, "validation_sample", no_work)
    with pytest.raises(ImportError, match="matplotlib"):
        pt.validate()
    with pytest.raises(ImportError, match="matplotlib"):
        tvp.plot_histogram(np.zeros((1, 1, 4, 4)), np.zeros((1, 1, 4, 4)))
    # the numbers need no matplotlib
    k, frac = tvp.power_spectrum_fractional_error(
        np.ones((1, 1, 8, 8)), np.ones((1, 1, 8, 8)), np.ones((1, 1, 8, 8)),
        L=1.0, n_k_bin=4, device="cpu")
    assert frac.shape == (1, 1, 4)
