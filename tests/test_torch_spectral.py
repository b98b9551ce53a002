"""The port's spectral training loss against the JAX package's.

* ``pk_fidelity_loss`` (``train/spectral.py``): value and gradient in the
  painted field against ``jax.value_and_grad`` of the JAX function, on the
  same seeded lognormal fields, pooled and per redshift with one training
  redshift absent from the batch (its masked mean is empty and adds no
  term). rtol 1e-4: f32 FFTs of two libraries (pocketfft in both, summed
  in another order) under a log-ratio.
* One training step with the spectral term (``pk_loss_weight`` 2e4, the
  committed pkft runs' weight, ``pk_loss_per_z``) at 32^2, batch 4 (where
  a step is well conditioned), against the JAX trainer's, from the
  committed fiducial CVAE's weights and running statistics (fully
  convolutional, so they paint 32^2 tiles; an untrained decoder paints a
  near-constant field whose spectrum is the FFT's f32 round-off, 0.34 %
  apart between the two libraries), with the same batch, ELBO noise and
  spectral prior noise (the JAX ``CVAE.sample_z`` and ``sample_prior``
  patched to use them):
  f32 with the heads unfused and fused (the JAX Pallas heads in interpret
  mode, the port's K3 plain versions): the loss and ``pk_loss`` rtol 1e-4,
  every gradient within rtol 1e-3 and 1e-4 of the largest entry (the ELBO
  step's rule, ``tests/test_torch_trainer.py``); bf16 under the bf16 step's
  rule (``tests/test_torch_bf16_trainer.py``): d(port bf16, JAX bf16) <=
  0.5 d(JAX f32, JAX bf16) over the concatenated gradient. The JAX eval-mode
  batch norm's input passes an optimization barrier here, as its train-mode
  one does in the JAX source: without it ``jax.jit`` on the CPU folds the
  conv output's bf16 rounding into the norm's f32 cast, and the jitted
  gradient then lies 0.72 of d(JAX f32, JAX bf16) from JAX's own op-by-op
  one (the port: 0.12 from op by op, 0.10 from the pinned jit).
* The trainer's rules: the fused residual blocks are refused, the pooled
  loss on a z-skewed cache warns, the spectral term paints through the
  eval-mode decoder without moving the running statistics, its noise is a
  second stream of (seed, step), and with fused heads a step calls K3
  twice (the ELBO and the spectral term).
"""
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baryon_painter_tpu.data.dataset import BahamasTileDataset as JaxDataset
from baryon_painter_tpu.data.dataset import load_file_info
from baryon_painter_tpu.models import cvae as jcvae
from baryon_painter_tpu.models import layers as jlayers
from baryon_painter_tpu.train import spectral as jspectral
from baryon_painter_tpu.train import trainer as jtrainer
from baryon_painter_tpu.transforms import RangeCompress as JaxRC
from baryon_painter_tpu_torch.convert import to_jax_variables
from baryon_painter_tpu_torch.data.dataset import BahamasTileDataset
from baryon_painter_tpu_torch.data.synthetic import make_synthetic_stacks
from baryon_painter_tpu_torch.models import cvae as tcvae
from baryon_painter_tpu_torch.models.cvae import (CVAE,
                                                  fiducial_cvae_architecture)
from baryon_painter_tpu_torch.train import checkpoint as tckpt
from baryon_painter_tpu_torch.train import trainer as ttrainer
from baryon_painter_tpu_torch.train.spectral import pk_fidelity_loss
from baryon_painter_tpu_torch.transforms import RangeCompress
from golden_utils import REPO

TILE, BATCH, LR, WEIGHT = 32, 4, 1e-3, 2e4
N_BINS = 12


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread a process: the suite's other workers load every
    core, and a thread pool per process then runs this file's many small
    CPU ops many times slower than it does alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fields(seed=0, n=6, size=32):
    rng = np.random.default_rng(seed)
    ln = lambda: np.exp(rng.standard_normal((n, size, size))
                        - 0.5).astype(np.float32)
    return ln(), ln(), ln()


@pytest.mark.parametrize("per_z", [False, True], ids=["pooled", "per_z"])
def test_pk_fidelity_loss_value_and_gradient_match_jax(per_z):
    pred, truth, dm = _fields()
    z = np.array([0.0, 0.0, 1.0, 1.0, 1.0, 0.0], np.float32)
    # 0.5 is a training redshift with no sample in this batch
    redshifts = [0.0, 0.5, 1.0] if per_z else None

    def jloss(p):
        return jspectral.pk_fidelity_loss(p, jnp.asarray(truth),
                                          jnp.asarray(dm), L=100.0,
                                          n_bins=N_BINS, z=jnp.asarray(z),
                                          redshifts=redshifts)

    want, want_grad = jax.value_and_grad(jloss)(jnp.asarray(pred))
    p = torch.from_numpy(pred).requires_grad_(True)
    got = pk_fidelity_loss(p, torch.from_numpy(truth), torch.from_numpy(dm),
                           L=100.0, n_bins=N_BINS, z=torch.from_numpy(z),
                           redshifts=redshifts)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-4)
    g, wg = p.grad.numpy(), np.asarray(want_grad)
    np.testing.assert_allclose(g, wg, rtol=1e-3,
                               atol=1e-4 * np.abs(wg).max())


def test_empty_redshift_adds_no_term():
    pred, truth, dm = _fields(1)
    z = torch.zeros(6)
    args = (torch.from_numpy(pred), torch.from_numpy(truth),
            torch.from_numpy(dm))
    one = pk_fidelity_loss(*args, L=100.0, n_bins=N_BINS, z=z,
                           redshifts=[0.0])
    two = pk_fidelity_loss(*args, L=100.0, n_bins=N_BINS, z=z,
                           redshifts=[0.0, 2.0])
    assert one.item() == two.item()
    with pytest.raises(ValueError):
        pk_fidelity_loss(*args, L=100.0, n_bins=N_BINS, redshifts=[0.0])


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


def _arch():
    return fiducial_cvae_architecture(TILE, n_res_blocks=1)


@pytest.fixture(scope="module")
def trained():
    """The committed fiducial CVAE at 32^2: its architecture with the
    tile's shapes, and its variables (JAX layout, numpy)."""
    state, meta = tckpt.load_checkpoint(
        os.path.join(REPO, "trained_models/CVAE/fiducial-512/model"))
    arch = dict(meta["model_architecture"], dim_x=(1, TILE, TILE),
                dim_y=(1, TILE, TILE), dim_z=(1, TILE // 32, TILE // 32))
    return arch, {"params": state["params"],
                  "batch_stats": state["batch_stats"]}


def _config(cls, **kw):
    return cls(seed=0, pk_loss_weight=WEIGHT, pk_loss_per_z=True, **kw)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float64)
    return out


def _vec(flat):
    return np.concatenate([flat[k].ravel() for k in sorted(flat)])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def jax_pk_step(jd, trained, fused, jdt, eps, pk_eps, idx):
    """The JAX trainer's loss, ``pk_loss`` and gradients of one step with
    the spectral term (``jax.jit`` of its step's loss), from the
    ``trained`` weights, with the ELBO noise ``eps`` and the spectral
    prior noise ``pk_eps`` (N, Cz, h, w)."""
    def sample_z(self, rng, z_mu, z_log_var, L=1):
        # model.init traces the step at batch 1: take the first rows
        e = jnp.asarray(eps).transpose(0, 2, 3, 1)[None, :z_mu.shape[0]]
        z = z_mu[None] + e * (jnp.exp(z_log_var[None] / 2) + self.min_z_var)
        return z.reshape(-1, *z_mu.shape[1:])

    def sample_prior(self, y, aux_label=None, train=False):
        z_mu, z_log_var = self.prior(y, aux_label, train=train)
        e = jnp.asarray(pk_eps).transpose(0, 2, 3, 1)[:z_mu.shape[0]]
        return z_mu + e * (jnp.exp(z_log_var / 2) + self.min_z_var)

    batch_norm = jlayers.BatchNorm.__call__

    def pinned_batch_norm(self, x, fused_stats=None, params_only=False,
                          n_features=None):
        # the eval-mode norm's input at its storage dtype, as the source
        # rounds it (the train-mode norm has this barrier itself)
        if (self.use_running_average and x is not None and not params_only
                and fused_stats is None):
            x = jax.lax.optimization_barrier(x.astype(self.dtype or x.dtype))
        return batch_norm(self, x, fused_stats, params_only, n_features)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcvae.CVAE, "sample_z", sample_z)
        mp.setattr(jcvae.CVAE, "sample_prior", sample_prior)
        mp.setattr(jlayers.BatchNorm, "__call__", pinned_batch_norm)
        mp.setenv("BPT_FUSED_HEADS", "1" if fused else "0")
        mp.setenv("BPT_FUSED_TRAIN_CONV", "0")
        arch, init = trained
        jt = jtrainer.CVAETrainer(jcvae.CVAE(arch, dtype=jdt), jd,
                                  config=_config(jtrainer.TrainConfig),
                                  device_data=True)
        jt.state = jt.state.replace(
            params=jax.tree.map(jnp.asarray, init["params"]),
            batch_stats=jax.tree.map(jnp.asarray, init["batch_stats"]))
        to_np = lambda t: jax.tree.map(np.asarray, t)
        raw = jt.device_cache.gather(jnp.asarray(jt.device_cache.digits(idx)))

        def loss(params):
            out, _ = jt._forward(params, jt.state.batch_stats, *raw,
                                 jax.random.PRNGKey(0), 1.0, 1.0, True)
            pk = jt._pk_loss(params, jt.state.batch_stats, *raw,
                             jax.random.PRNGKey(1))
            return -out["elbo"] + WEIGHT * pk, pk

        (value, pk), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(
            jt.state.params)
    return float(value), float(pk), _flat(to_np(grads))


def port_pk_step(td, trained, fused, tdt, eps, pk_eps, idx):
    arch, init = trained
    model = CVAE(arch, fused_heads=fused, dtype=tdt)
    tr = ttrainer.CVAETrainer(model, td, device_data=True, device="cpu",
                              config=_config(ttrainer.TrainConfig),
                              variables=init)
    m = tr.step_indices(idx, LR, eps=eps, pk_eps=pk_eps)
    loss = -m["elbo"].item() + WEIGHT * m["pk_loss"].item()
    grads = _flat(to_jax_variables(tr.model, grads=True)["params"])
    return loss, m["pk_loss"].item(), grads


def _noise(seed):
    return np.random.default_rng(seed).standard_normal(
        (BATCH, 1, TILE // 32, TILE // 32)).astype(np.float32)


@pytest.fixture(scope="module", params=[False, True],
                ids=["heads_unfused", "heads_fused"])
def f32_steps(request, data, trained):
    jd, td = data
    fused = request.param
    idx = jd.sample_indices(np.random.default_rng(1), BATCH)
    eps, pk_eps = _noise(5), _noise(6)
    jloss, jpk, jgrads = jax_pk_step(jd, trained, fused, None, eps, pk_eps,
                                     idx)
    tloss, tpk, tgrads = port_pk_step(td, trained, fused, None, eps, pk_eps,
                                      idx)
    return dict(jax=(jloss, jpk, jgrads), port=(tloss, tpk, tgrads))


def test_pk_step_loss_matches_jax(f32_steps):
    (jloss, jpk, _), (tloss, tpk, _) = f32_steps["jax"], f32_steps["port"]
    assert jpk > 0
    np.testing.assert_allclose(tpk, jpk, rtol=1e-4)
    np.testing.assert_allclose(tloss, jloss, rtol=1e-4)


def test_pk_step_gradients_match_jax(f32_steps):
    want, got = f32_steps["jax"][2], f32_steps["port"][2]
    assert set(got) == set(want)
    top = max(np.abs(g).max() for g in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3,
                                   atol=1e-4 * top, err_msg=k)


def test_bf16_pk_step_gradient_matches_the_jax_bf16_step(data, trained):
    jd, td = data
    idx = jd.sample_indices(np.random.default_rng(1), BATCH)
    eps, pk_eps = _noise(5), _noise(6)
    _, jpk32, jg32 = jax_pk_step(jd, trained, False, None, eps, pk_eps, idx)
    _, jpk16, jg16 = jax_pk_step(jd, trained, False, jnp.bfloat16, eps,
                                 pk_eps, idx)
    _, tpk16, tg16 = port_pk_step(td, trained, False, torch.bfloat16, eps,
                                  pk_eps, idx)
    _, _, tg32 = port_pk_step(td, trained, False, None, eps, pk_eps, idx)
    gap = _rel(_vec(jg16), _vec(jg32))
    assert gap > 0
    assert _rel(_vec(tg16), _vec(jg16)) <= 0.5 * gap
    assert _rel(_vec(tg16), _vec(tg32)) >= 0.5 * gap
    pk_gap = abs(jpk16 - jpk32) / abs(jpk32)
    assert abs(tpk16 - jpk16) / abs(jpk16) <= max(0.5 * pk_gap, 1e-5)


def _trainer(td, **kw):
    cfg = dict(pk_loss_weight=WEIGHT, pk_loss_per_z=True)
    cfg.update(kw.pop("config", {}))
    return ttrainer.CVAETrainer(
        CVAE(kw.pop("arch", _arch()), **kw), td,
        config=ttrainer.TrainConfig(**cfg), device_data=True, device="cpu")


def test_pk_loss_refuses_fused_res_blocks(data):
    _, td = data
    arch = fiducial_cvae_architecture(TILE, n_res_blocks=1,
                                      fused_res_blocks=True)
    with pytest.raises(ValueError, match="fused_res_blocks"):
        _trainer(td, arch=arch)


def test_pooled_pk_loss_on_a_skewed_cache_warns(data, monkeypatch):
    _, td = data
    from baryon_painter_tpu_torch.data import device_cache
    orig = device_cache.DeviceStackCache.__init__

    def skewed(self, *a, **kw):
        orig(self, *a, **kw)
        self.uniform_z = False

    monkeypatch.setattr(device_cache.DeviceStackCache, "__init__", skewed)
    with pytest.warns(UserWarning, match="pk_loss_per_z=True"):
        _trainer(td, config=dict(pk_loss_per_z=False))
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        _trainer(td)  # per-z: no warning


def test_pk_step_keeps_its_running_statistics_out_and_calls_k3_twice(
        data, monkeypatch):
    """From the same weights and noise, a step with the spectral term ends
    with the running statistics of the step without it (its forward is
    eval mode) but other parameters, and with fused heads it goes through
    the heads twice, both times under autograd (K3-fwd keeps u1 for
    K3-bwd)."""
    _, td = data
    idx = np.arange(BATCH)
    calls = []
    counted = tcvae.head_stack
    monkeypatch.setattr(tcvae, "head_stack", lambda *a: (
        calls.append(torch.is_grad_enabled()), counted(*a))[1])
    a = _trainer(td, fused_heads=True)
    b = _trainer(td, fused_heads=True, config=dict(pk_loss_weight=0.0))
    m = a.step_indices(idx, LR, eps=_noise(5), pk_eps=_noise(6))
    assert calls == [True, True]
    assert "pk_loss" not in b.step_indices(idx, LR, eps=_noise(5))
    assert "pk_loss" in m and len(calls) == 3
    tree = lambda tr, k: _vec(_flat(to_jax_variables(tr.model)[k]))
    np.testing.assert_array_equal(tree(a, "batch_stats"),
                                  tree(b, "batch_stats"))
    assert not np.array_equal(tree(a, "params"), tree(b, "params"))


def test_pk_noise_is_a_second_stream_of_seed_and_step(data):
    """Drawn noise: a trainer restored to step s draws step s's spectral
    noise again (the step alone fixes it); that noise differs from the
    ELBO's."""
    _, td = data
    idx = np.arange(BATCH)
    a, b = _trainer(td), _trainer(td)
    a.step_indices(idx, LR)
    first = a.step_indices(idx, LR)["pk_loss"].item()
    b.step_indices(idx, LR)
    b._host_step = 1
    assert b.step_indices(idx, LR)["pk_loss"].item() == first
    assert (ttrainer._step_seed(0, 3, 1) != ttrainer._step_seed(0, 3)
            and ttrainer._step_seed(0, 3, 0) == ttrainer._step_seed(0, 3))
