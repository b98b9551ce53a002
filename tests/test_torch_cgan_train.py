"""The port's CGAN training step (train/cgan.py, spectral norm in
models/layers.py, the discriminator in models/cgan.py) against the JAX
package's ``CGANTrainer`` on the CPU.

The JAX test's size (tests/test_cgan.py): 64^2 stacks, 32^2 tiles,
``n_res_blocks=1``, batch 2. The JAX trainer's initial state (G, D, their
batch-norm and spectral-norm state) is carried across to the port's trainer
and one step is taken by both on the same sample indices, gathered on the
device from the stack cache. The JAX step returns no gradients: its
optimizer is wrapped so that each ``update`` records the gradients it is
given (after the clip, as the port's ``.grad`` holds them). One JAX trainer
serves every mode: its step is re-traced with each mode's config.

Held: the step's metrics to 1e-5 relative; each gradient leaf of G and D to
1e-4 of its own largest entry, except a bias ahead of a train-mode batch
norm, whose gradient is 0 analytically (the batch norm removes any shift;
``zero_gradient_leaves``): both sides return rounding noise there, held to
1e-4 of the network's largest gradient entry; the new ``g_stats`` and
``d_stats`` (batch norm and spectral norm) to 1e-5 of each leaf's largest
entry.
"""
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baryon_painter_tpu.data.dataset import BahamasTileDataset as JaxDataset
from baryon_painter_tpu.data.dataset import load_file_info
from baryon_painter_tpu.models import layers as jlayers
from baryon_painter_tpu.models.cgan import CGANDiscriminator as JaxD
from baryon_painter_tpu.models.cgan import CGANGenerator as JaxG
from baryon_painter_tpu.painter import CGANPainter as JaxPainter
from baryon_painter_tpu.train import cgan as jcgan
from baryon_painter_tpu.transforms import RangeCompress as JaxRC
from baryon_painter_tpu_torch.convert import (load_spec_sequential,
                                              to_jax_variables)
from baryon_painter_tpu_torch.data.dataset import BahamasTileDataset
from baryon_painter_tpu_torch.data.synthetic import make_synthetic_stacks
from baryon_painter_tpu_torch.models.cgan import (CGANDiscriminator,
                                                  CGANGenerator)
from baryon_painter_tpu_torch.models.layers import SpecSequential
from baryon_painter_tpu_torch.painter import CGANPainter
from baryon_painter_tpu_torch.train import checkpoint as tckpt
from baryon_painter_tpu_torch.train.cgan import (CGANTrainConfig,
                                                 CGANTrainer,
                                                 zero_gradient_leaves)
from baryon_painter_tpu_torch.train.msgpack_writer import msgpack_serialize
from baryon_painter_tpu_torch.transforms import RangeCompress
from golden_utils import REPO

TILE, BATCH, LR = 32, 2, 5e-5
METRIC_RTOL, GRAD_TOL, STATS_TOL = 1e-5, 1e-4, 1e-5
# the golden test's own tolerance (tests/test_paint_goldens.py)
GOLDEN_RTOL = 5e-3

MODES = {
    "default": {},
    "feature_matching": {"feature_matching": True},
    "calibration": {"adversarial_weight": 0.0},
    "freeze_bn_stats": {"freeze_bn_stats": True},
    "clip_grad_norm": {"clip_grad_norm": 0.5},
    "perceptual_l2": {"perceptual_loss": "l2"},
    "pk_per_z": {"pk_loss_weight": 1.0, "pk_loss_per_z": True},
    "pk_pooled": {"pk_loss_weight": 1.0},
}


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


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


class _Recorder:
    """The JAX trainer's optimizer, recording the gradients of each
    ``update`` (D's first, then G's) from inside the jitted step."""

    def __init__(self, opt):
        self.opt, self.grads = opt, []

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        jax.debug.callback(lambda g: self.grads.append(_np(g)), grads)
        return self.opt.update(grads, state, params)


@pytest.fixture(scope="module")
def jax_trainer(data):
    jd, _ = data
    jt = jcgan.CGANTrainer(jd, generator=JaxG(n_res_blocks=1),
                           discriminator=JaxD(),
                           config=jcgan.CGANTrainConfig(seed=0,
                                                        batch_size=BATCH),
                           device_data=True)
    jt.optimizer = _Recorder(jt.optimizer)
    init = {k: _np(getattr(jt.state, k))
            for k in ("g_params", "g_stats", "d_params", "d_stats")}
    return jt, init


def _reset(jt, init):
    """The JAX trainer back at ``init``, with fresh Adam states."""
    tree = jax.tree.map(jnp.asarray, init)
    jt.state = jcgan.GANTrainState(
        g_params=tree["g_params"], g_stats=tree["g_stats"],
        g_opt=jt.optimizer.init(tree["g_params"]),
        d_params=tree["d_params"], d_stats=tree["d_stats"],
        d_opt=jt.optimizer.init(tree["d_params"]),
        step=jnp.zeros((), jnp.int32))


def _port(td, init, **cfg):
    return CGANTrainer(td, generator=CGANGenerator(n_res_blocks=1,
                                                   spectral_norm=True),
                       config=CGANTrainConfig(seed=0, batch_size=BATCH,
                                              **cfg),
                       device_data=True, device="cpu", state=init)


@pytest.fixture(scope="module", params=list(MODES))
def step_pair(request, data, jax_trainer):
    """One step of each package in one mode, from the JAX initial state."""
    jd, td = data
    jt, init = jax_trainer
    cfg = MODES[request.param]
    jt.config = jcgan.CGANTrainConfig(seed=0, batch_size=BATCH, **cfg)
    jt._train_step_digits = jax.jit(jt._train_step_digits_impl,
                                    donate_argnums=(0,))
    _reset(jt, init)
    jt.optimizer.grads = []
    idx = jd.sample_indices(np.random.default_rng(1), BATCH)
    jm = _np(jt.step_indices(idx, lr=LR))
    grads = jt.optimizer.grads
    jax_grads = ({"d": grads[0], "g": grads[1]} if len(grads) == 2
                 else {"g": grads[0]})
    after = {net: _np(getattr(jt.state, f"{net}_stats")) for net in "gd"}
    tr = _port(td, init, **cfg)
    pm = tr.step_indices(idx, LR)
    return request.param, jm, jax_grads, after, tr, pm


def test_step_metrics_against_jax(step_pair):
    mode, jm, _, _, _, pm = step_pair
    for key, want in jm.items():
        got = float(pm[key])
        assert abs(got - float(want)) <= METRIC_RTOL * abs(float(want)), (
            mode, key, got, float(want))
    if mode == "calibration":
        assert all(float(pm[k]) == 0.0 for k in ("loss_D", "loss_G_adv",
                                                 "D_real", "D_fake",
                                                 "d_grad_norm"))


def test_step_gradients_against_jax(step_pair):
    mode, _, jax_grads, _, tr, _ = step_pair
    zero = set(zero_gradient_leaves(tr.generator)) if (
        mode not in ("calibration", "pk_per_z", "pk_pooled")) else set()
    for net, model in (("g", tr.generator), ("d", tr.discriminator)):
        got = _flat(to_jax_variables(model, grads=True)["params"])
        if net not in jax_grads:
            # calibration: D takes no step, and has no gradient
            assert all(np.all(v == 0) for v in got.values()), mode
            continue
        want = _flat(jax_grads[net])
        assert set(got) == set(want)
        top = max(np.abs(w).max() for w in want.values())
        for key, w in want.items():
            scale = top if key in zero else np.abs(w).max()
            err = np.abs(got[key] - w).max()
            assert err <= GRAD_TOL * scale, (mode, net, key, err / scale)


def test_step_state_against_jax(step_pair):
    mode, _, _, after, tr, _ = step_pair
    for net, model in (("g", tr.generator), ("d", tr.discriminator)):
        got = _flat(to_jax_variables(model)["batch_stats"])
        want = _flat(after[net])
        assert set(got) == set(want), (mode, net)
        for key, w in want.items():
            err = np.abs(got[key] - w).max()
            assert err <= STATS_TOL * max(np.abs(w).max(), 1e-30), (
                mode, net, key, err)


def test_zero_gradient_leaves_are_the_biases_ahead_of_batch_norm():
    g = CGANGenerator(n_res_blocks=1, spectral_norm=True)
    assert zero_gradient_leaves(g) == [
        "SpecSequential_0/Conv2d_1/bias", "SpecSequential_0/Conv2d_2/bias",
        "SpecSequential_0/ConvTranspose2d_0/bias",
        "SpecSequential_0/ConvTranspose2d_1/bias",
        "SpecSequential_1/Conv2d_0/bias"]
    assert zero_gradient_leaves(CGANDiscriminator()) == []


# --------------------------------------------------------------------- #
# the spectral-norm layer alone, against flax's SpectralNorm

SN_LAYERS = {
    "conv3x3": ("conv", {"in_channels": 5, "out_channels": 7,
                         "kernel_size": 3, "stride": 1, "padding": 1,
                         "bias": True}),
    "conv4x4_s2": ("conv", {"in_channels": 6, "out_channels": 9,
                            "kernel_size": 4, "stride": 2, "padding": 1,
                            "bias": False}),
    "transp3x3_s2": ("transp conv", {"in_channels": 8, "out_channels": 4,
                                     "kernel_size": 3, "stride": 2,
                                     "padding": 1, "output_padding": 1,
                                     "bias": True}),
}


def _to_flax_kernel(w, transposed):
    w = w.detach().numpy()
    return (w.transpose(2, 3, 0, 1)[::-1, ::-1] if transposed
            else w.transpose(2, 3, 1, 0))


@pytest.mark.parametrize("layer", list(SN_LAYERS))
def test_spectral_norm_layer_against_flax(layer):
    kind, cfg = SN_LAYERS[layer]
    spec = ((kind, cfg),)
    name = "ConvTranspose2d_0" if kind == "transp conv" else "Conv2d_0"
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 12, 12, cfg["in_channels"])).astype(
        np.float32)
    jseq = jlayers.SpecSequential(spec, spectral_norm=True)
    variables = _np(jseq.init(jax.random.PRNGKey(0), jnp.asarray(x),
                              train=False))
    params, stats = variables["params"], variables["batch_stats"]

    def jax_apply(p):
        return jseq.apply({"params": p, "batch_stats": stats},
                          jnp.asarray(x), train=True,
                          mutable=["batch_stats"])

    jy, mut = jax_apply(params)
    r = rng.standard_normal(jy.shape).astype(np.float32)
    jgrad = _np(jax.grad(lambda p: jnp.sum(jax_apply(p)[0] * r))(params))
    new = _np(mut["batch_stats"])["SpectralNorm_0"]

    seq = SpecSequential(spec, spectral_norm=True)
    load_spec_sequential(seq, params, stats)
    m = seq.layers[name]
    transposed = kind == "transp conv"
    # eval mode: the iteration from the stored u, nothing stored
    seq.eval()
    with torch.no_grad():
        seq(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_array_equal(m.sn_u.numpy(),
                                  stats["SpectralNorm_0"][f"{name}/kernel/u"])
    seq.train()
    y = seq(torch.from_numpy(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(),
                               np.asarray(jy), rtol=1e-5,
                               atol=1e-5 * np.abs(np.asarray(jy)).max())
    u, sigma = new[f"{name}/kernel/u"], new[f"{name}/kernel/sigma"]
    np.testing.assert_allclose(m.sn_u.numpy(), u, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(float(m.sn_sigma), float(sigma), rtol=1e-6)
    (y * torch.from_numpy(r).permute(0, 3, 1, 2)).sum().backward()
    kernel = params[name]["kernel"]
    with torch.no_grad():
        load_spec_sequential(seq, params, stats)
    wbar = _to_flax_kernel(m.normalized_weight(), transposed)
    np.testing.assert_allclose(wbar, kernel / sigma, rtol=1e-6,
                               atol=1e-7 * np.abs(kernel / sigma).max())
    gw = _to_flax_kernel(m.weight.grad, transposed)
    want = jgrad[name]["kernel"]
    assert np.abs(gw - want).max() <= 1e-5 * np.abs(want).max()
    if cfg["bias"]:
        np.testing.assert_allclose(m.bias.grad.numpy(), jgrad[name]["bias"],
                                   rtol=1e-5,
                                   atol=1e-5 * np.abs(jgrad[name]["bias"]
                                                      ).max())


def test_discriminator_patch_shape_and_features():
    d = CGANDiscriminator()
    with torch.no_grad():
        p, feat = d(torch.zeros(1, 1, 512, 512), torch.zeros(1),
                    torch.zeros(1, 1, 512, 512), return_features=True)
    assert tuple(p.shape) == (1, 1, 62, 62)
    assert tuple(feat.shape) == (1, 512, 63, 63)


# --------------------------------------------------------------------- #


def test_eval_loss_against_jax(data, jax_trainer):
    jd, td = data
    jt, init = jax_trainer
    jt.config = jcgan.CGANTrainConfig(seed=0, batch_size=BATCH)
    _reset(jt, init)
    batch = jd.get_raw_batch(jd.sample_indices(np.random.default_rng(2), 3))
    want = _np(jt.eval_loss(batch))
    tr = _port(td, init)
    before = {k: v.clone() for k, v in tr.discriminator.state_dict().items()}
    got = tr.eval_loss(batch)
    for key, w in want.items():
        assert abs(float(got[key]) - float(w)) <= METRIC_RTOL * max(
            abs(float(w)), 1e-30), key
    after = tr.discriminator.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)


def test_from_trainer_paint_against_jax(data, jax_trainer):
    jd, td = data
    jt, init = jax_trainer
    jt.config = jcgan.CGANTrainConfig(seed=0, batch_size=BATCH)
    jt._train_step_digits = jax.jit(jt._train_step_digits_impl,
                                    donate_argnums=(0,))
    _reset(jt, init)
    idx = jd.sample_indices(np.random.default_rng(1), BATCH)
    jt.step_indices(idx, lr=LR)
    state = {k: _np(getattr(jt.state, k))
             for k in ("g_params", "g_stats", "d_params", "d_stats")}
    tr = _port(td, state)
    batch = jd.get_raw_batch(jd.sample_indices(np.random.default_rng(4), 3))
    want = np.asarray(JaxPainter.from_trainer(jt).paint_batch(
        batch["input"], batch["z"]))
    tol = GOLDEN_RTOL * (np.abs(want).mean() + np.abs(want))
    for fused in (False, True):
        p = CGANPainter.from_trainer(tr, fused_inference=fused)
        got = p.paint_batch(batch["input"], batch["z"]).numpy()
        assert np.all(np.abs(got - want) <= tol), fused
        assert p.architecture.get("fused_res_blocks", False) == fused


def test_checkpoints_cross_both_ways(data, jax_trainer, tmp_path):
    jd, td = data
    jt, init = jax_trainer
    jt.config = jcgan.CGANTrainConfig(seed=0, batch_size=BATCH)
    jt._train_step_digits = jax.jit(jt._train_step_digits_impl,
                                    donate_argnums=(0,))
    _reset(jt, init)
    jt.step_indices(jd.sample_indices(np.random.default_rng(1), BATCH),
                    lr=LR)
    # the port restores the JAX package's save
    jt.save(str(tmp_path / "jax"))
    tr = _port(td, init)
    meta = tr.restore(str(tmp_path / "jax"))
    assert meta["model_kind"] == "cgan" and tr.steps == 1
    want, _ = tckpt.load_checkpoint(str(tmp_path / "jax"),
                                    keep_optimizer=True)
    got = tr.state_tree()
    assert _flat(got).keys() == _flat(want).keys()
    for key, w in _flat(want).items():
        np.testing.assert_array_equal(_flat(got)[key], w, err_msg=key)
    # the JAX package restores the port's save (after a port step)
    tr.step_indices(td.sample_indices(np.random.default_rng(3), BATCH), LR)
    tr.save(str(tmp_path / "port"))
    jt.restore(str(tmp_path / "port"))
    assert int(jt.state.step) == 2
    port = _flat(tr.state_tree())
    for key in ("g_params", "g_stats", "d_params", "d_stats"):
        for k, w in _flat(_np(getattr(jt.state, key)), f"{key}/").items():
            np.testing.assert_array_equal(w, port[k], err_msg=k)
    for net in ("g_opt", "d_opt"):
        adam = _np(getattr(jt.state, net)[0])
        assert int(adam.count) == int(port[f"{net}/0/count"])
        for k, w in _flat(adam.mu, f"{net}/0/mu/").items():
            np.testing.assert_array_equal(w, port[k], err_msg=k)
        for k, w in _flat(adam.nu, f"{net}/0/nu/").items():
            np.testing.assert_array_equal(w, port[k], err_msg=k)


def test_fiducial_adv_reserialises_to_its_own_bytes(data):
    _, td = data
    base = f"{REPO}/trained_models/CGAN/fiducial-adv/model"
    tr = CGANTrainer(td, device="cpu")
    tr.restore(base)
    with open(base + "_state.msgpack", "rb") as f:
        committed = f.read()
    assert msgpack_serialize(tr.state_tree()) == committed


def test_reinit_discriminator(data):
    _, td = data
    tr = _port(td, None)
    tr.step_indices(td.sample_indices(np.random.default_rng(1), BATCH), LR)
    g_before = {k: v.clone() for k, v in tr.generator.state_dict().items()}
    g_adam = [t.clone() for t in tr.g_opt.mu + tr.g_opt.nu]
    d_before = {k: v.clone()
                for k, v in tr.discriminator.state_dict().items()}
    tr.reinit_discriminator(7)
    g_after = tr.generator.state_dict()
    assert all(torch.equal(g_before[k], g_after[k]) for k in g_before)
    assert all(torch.equal(a, b) for a, b in zip(
        g_adam, tr.g_opt.mu + tr.g_opt.nu))
    assert tr.g_opt.count == 1 and tr.d_opt.count == 0
    assert all(float(t.abs().max()) == 0 for t in tr.d_opt.mu + tr.d_opt.nu)
    d = tr.discriminator
    d_after = d.state_dict()
    assert all(not torch.equal(d_before[k], d_after[k]) for k in d_before
               if not k.endswith("sn_sigma"))
    # the init's distributions: Kaiming-normal body, Xavier(0.25) head,
    # biases U(+-1/sqrt(fan_in)), u ~ N(0, 1), sigma 1
    body = d.SpecSequential_0.layers
    for name in ("Conv2d_1", "Conv2d_2", "Conv2d_3"):
        w = body[name].weight
        fan_in = w.shape[1] * w.shape[2] * w.shape[3]
        assert abs(float(w.detach().std()) / np.sqrt(2.0 / fan_in) - 1) < 0.02, name
    b = body["Conv2d_0"].bias
    assert float(b.abs().max()) <= 1 / np.sqrt(3 * 16)
    head = d.SpecSequential_1.layers["Conv2d_0"]
    bound = 0.25 * np.sqrt(6.0 / (16 * (512 + 1)))
    assert float(head.weight.abs().max()) <= bound
    assert float(head.weight.abs().max()) > 0.9 * bound
    u = body["Conv2d_3"].sn_u
    assert abs(float(u.mean())) < 0.2 and abs(float(u.std()) - 1) < 0.15
    assert all(float(m.sn_sigma) == 1.0 for m in body.values()
               if hasattr(m, "sn_sigma"))
    # a fresh D against the trained G still steps
    m = tr.step_indices(td.sample_indices(np.random.default_rng(2), BATCH),
                        LR)
    assert all(np.isfinite(float(v)) for v in m.values())


def test_mesh_and_figures_refuse(data, monkeypatch):
    """The mesh is item 10's; the figures need matplotlib, and without it
    ``validate`` says so."""
    _, td = data
    with pytest.raises(NotImplementedError, match="item 10"):
        CGANTrainer(td, device="cpu", mesh=object())
    tr = _port(td, None)
    for name in [m for m in sys.modules if m.split(".")[0] == "matplotlib"]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="matplotlib"):
        tr.validate()
