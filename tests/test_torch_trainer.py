"""The port's training step against the JAX package's ``CVAETrainer``, and the
trainer's own rules.

One step from the same initial weights (the JAX trainer's, carried across
by the converter), the same batch (the same sample indices, gathered on the
device from the stack cache) and the same latent noise (the JAX
``CVAE.sample_z`` patched in the test to use it) is compared with
``CVAETrainer.step_indices``: the metrics and gradients (rtol 1e-3, atol
1e-4 of the largest gradient entry: f32 sums in another order through the
whole model, forward and backward) and the updated running statistics
(rtol/atol 2e-4), with the output heads unfused and fused (JAX
``BPT_FUSED_HEADS=1`` in interpret mode; the port's K3 plain versions), and
with the heads and the train-mode conv + batch norm + ReLU triples fused
(JAX ``BPT_FUSED_TRAIN_CONV=1`` too, its K4 in interpret mode, which at 32^2
fuses the decoder's three up-convs; the port's
``CVAE(fused_train_conv=True)`` on K4's plain versions).
Adam's first step is about lr * sign(g), so a gradient entry near 0 flips
it; the optimizer is therefore compared on identical gradients: the port's
``Adam`` and the JAX trainer's optax chain on the JAX gradients (rtol
1e-6), and the port's against optax over several steps.
"""
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from baryon_painter_tpu.data.dataset import BahamasTileDataset as JaxDataset
from baryon_painter_tpu.data.dataset import load_file_info
from baryon_painter_tpu.models import cvae as jcvae
from baryon_painter_tpu.train import trainer as jtrainer
from baryon_painter_tpu.transforms import RangeCompress as JaxRC
from baryon_painter_tpu_torch.convert import to_jax_variables
from baryon_painter_tpu_torch.data.dataset import BahamasTileDataset
from baryon_painter_tpu_torch.data.synthetic import make_synthetic_stacks
from baryon_painter_tpu_torch.models.cvae import (CVAE,
                                                  fiducial_cvae_architecture)
from baryon_painter_tpu_torch.train import trainer as ttrainer
from baryon_painter_tpu_torch.transforms import RangeCompress
from golden_utils import REPO

TILE, BATCH, LR = 32, 2, 1e-3


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


@pytest.fixture(scope="module",
                params=[(False, False), (True, False), (True, True)],
                ids=["heads_unfused", "heads_fused",
                     "heads_and_train_conv_fused"])
def jax_step(request, data):
    """The JAX trainer's step: initial variables, gradients (from a separate
    jit of the step's loss: the step does not return its own), the
    parameters its optimizer makes of those gradients, and the metrics and
    state after the step; its latent noise fixed to ``eps``."""
    fused, train_conv = request.param
    jd, _ = data
    eps = np.random.default_rng(5).standard_normal(
        (1, BATCH, 1, TILE // 32, TILE // 32)).astype(np.float32)

    def sample_z(self, rng, z_mu, z_log_var, L=1):
        e = jnp.asarray(eps).transpose(0, 1, 3, 4, 2)[:, :z_mu.shape[0]]
        z = z_mu[None] + e * (jnp.exp(z_log_var[None] / 2) + self.min_z_var)
        return z.reshape(-1, *z_mu.shape[1:])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcvae.CVAE, "sample_z", sample_z)
        mp.setenv("BPT_FUSED_HEADS", "1" if fused else "0")
        mp.setenv("BPT_FUSED_TRAIN_CONV", "1" if train_conv else "0")
        jt = jtrainer.CVAETrainer(jcvae.CVAE(_arch()), jd,
                                  config=jtrainer.TrainConfig(seed=0),
                                  device_data=True)
        to_np = lambda t: jax.tree.map(np.asarray, t)
        init = {"params": to_np(jt.state.params),
                "batch_stats": to_np(jt.state.batch_stats)}
        idx = jd.sample_indices(np.random.default_rng(1), BATCH)
        raw = jt.device_cache.gather(jnp.asarray(jt.device_cache.digits(idx)))

        def loss(params):
            out, _ = jt._forward(params, jt.state.batch_stats, *raw,
                                 jax.random.PRNGKey(0), 1.0, 1.0, True)
            return -out["elbo"]

        grads = jax.jit(jax.grad(loss))(jt.state.params)
        # the JAX trainer's own optimizer on exactly these gradients, as
        # its step applies it
        direction, _ = jt.optimizer.update(
            grads, jt.optimizer.init(jt.state.params), jt.state.params)
        adam_params = to_np(optax.apply_updates(
            jt.state.params, jax.tree.map(lambda u: LR * u, direction)))
        grads = to_np(grads)
        metrics = to_np(jt.step_indices(idx, lr=LR))
        after = {"params": to_np(jt.state.params),
                 "batch_stats": to_np(jt.state.batch_stats)}
    return dict(fused=fused, train_conv=train_conv, eps=eps, init=init, idx=idx, grads=grads,
                metrics=metrics, after=after, adam_params=adam_params)


@pytest.fixture(scope="module")
def port_step(jax_step, data):
    _, td = data
    model = CVAE(_arch(), fused_heads=jax_step["fused"],
                 fused_train_conv=jax_step["train_conv"])
    tr = ttrainer.CVAETrainer(model, td, device_data=True, device="cpu",
                              variables=jax_step["init"])
    metrics = tr.step_indices(jax_step["idx"], LR, eps=jax_step["eps"])
    return tr, metrics


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def test_step_metrics_match_jax(jax_step, port_step):
    _, got = port_step
    want = jax_step["metrics"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-3,
                                   atol=1e-4, err_msg=k)


def test_step_gradients_match_jax(jax_step, port_step):
    tr, _ = port_step
    got = _flat(to_jax_variables(tr.model, grads=True)["params"])
    want = _flat(jax_step["grads"])
    assert set(got) == set(want)
    top = max(np.abs(g).max() for g in want.values())
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-3,
                                   atol=1e-4 * top, err_msg=k)


def test_step_running_statistics_match_jax(jax_step, port_step):
    tr, _ = port_step
    got = _flat(to_jax_variables(tr.model)["batch_stats"])
    want = _flat(jax_step["after"]["batch_stats"])
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-4,
                                   err_msg=k)


def test_adam_on_the_jax_gradients_gives_the_jax_parameters(jax_step):
    init = _flat(jax_step["init"]["params"])
    grads = _flat(jax_step["grads"])
    want = _flat(jax_step["adam_params"])
    names = sorted(init)
    params = [torch.from_numpy(init[n].copy()) for n in names]
    adam = ttrainer.Adam(params)
    for p, d in zip(params, adam.update(
            [torch.from_numpy(grads[n].copy()) for n in names])):
        p.add_(LR * d)
    for n, p in zip(names, params):
        np.testing.assert_allclose(p.numpy(), want[n], rtol=1e-6, atol=1e-9,
                                   err_msg=n)


def test_adam_matches_optax_over_steps():
    rng = np.random.default_rng(0)
    shapes = [(3, 4), (5,), ()]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    opt = optax.chain(optax.scale_by_adam(b1=0.8, b2=0.99),
                      optax.scale(-1.0))
    state = opt.init([jnp.asarray(p) for p in params])
    adam = ttrainer.Adam([torch.from_numpy(p) for p in params], 0.8, 0.99)
    for _ in range(4):
        g = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        want, state = opt.update([jnp.asarray(a) for a in g], state)
        got = adam.update([torch.from_numpy(a) for a in g])
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-7)


def _trainer(data, **config):
    _, td = data
    return ttrainer.CVAETrainer(CVAE(_arch()), td,
                                config=ttrainer.TrainConfig(**config),
                                device_data=True, device="cpu")


def _params(tr):
    return [p.detach().clone() for p in tr.params]


def test_step_scan_is_sequential_step_indices(data):
    _, td = data
    rng = np.random.default_rng(4)
    idx = np.stack([td.sample_indices(rng, BATCH) for _ in range(3)])
    a, b = _trainer(data), _trainer(data)
    lrs = [1e-3, 5e-4, 2e-4]
    scanned = a.step_scan(idx, lrs, alpha_var=[1.0, 0.5, 0.0], beta_KL=0.5)
    seq = [b.step_indices(i, lr, alpha_var=av, beta_KL=0.5)
           for i, lr, av in zip(idx, lrs, [1.0, 0.5, 0.0])]
    for k in scanned:
        assert scanned[k].shape[0] == 3
        for i in range(3):
            assert torch.equal(scanned[k][i], seq[i][k]), k
    for p, q in zip(_params(a), _params(b)):
        assert torch.equal(p, q)


def test_host_batch_step_is_the_device_batch_step(data):
    _, td = data
    idx = td.sample_indices(np.random.default_rng(6), BATCH)
    a, b = _trainer(data), _trainer(data)
    ma = a.step(td.get_raw_batch(idx), LR)
    mb = b.step_indices(idx, LR)
    for k in ma:
        torch.testing.assert_close(ma[k], mb[k], rtol=1e-6, atol=1e-6)


def test_clipping_scales_the_gradients_to_the_norm(data):
    _, td = data
    idx = td.sample_indices(np.random.default_rng(7), BATCH)
    tr = _trainer(data, clip_grad_norm=0.5)
    m = tr.step_indices(idx, LR)
    assert m["grad_norm"] > 0.5                 # reported before clipping
    clipped = ttrainer.grad_norm([p.grad for p in tr.params])
    assert clipped.item() == pytest.approx(0.5, rel=1e-5)
    g = [torch.randn(3, 2), torch.randn(4)]
    want = jtrainer.clip_grads_by_global_norm([jnp.asarray(a.numpy())
                                               for a in g], 0.1)
    got = ttrainer.clip_grads_by_global_norm([a.clone() for a in g], 0.1)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_freeze_bn_stats_keeps_the_running_statistics(data):
    _, td = data
    idx = td.sample_indices(np.random.default_rng(8), BATCH)
    tr = _trainer(data, freeze_bn_stats=True)
    stats = to_jax_variables(tr.model)["batch_stats"]
    before = _params(tr)
    tr.step_indices(idx, LR)
    jax.tree.map(np.testing.assert_array_equal,
                 to_jax_variables(tr.model)["batch_stats"], stats)
    assert any(not torch.equal(p, q) for p, q in zip(before, tr.params))
    moving = _trainer(data)
    moving.step_indices(idx, LR)
    assert not np.array_equal(
        to_jax_variables(moving.model)["batch_stats"]["p_y_z_in"][
            "BatchNorm_0"]["mean"],
        stats["p_y_z_in"]["BatchNorm_0"]["mean"])


def test_eval_loss_changes_nothing(data):
    _, td = data
    tr = _trainer(data)
    batch = td.get_raw_batch(td.sample_indices(np.random.default_rng(9),
                                               BATCH))
    state = to_jax_variables(tr.model)
    first = tr.eval_loss(batch, seed=3)
    again = tr.eval_loss(batch, seed=3)
    for k in first:
        assert torch.equal(first[k], again[k])
    jax.tree.map(np.testing.assert_array_equal, to_jax_variables(tr.model),
                 state)


def test_what_the_trainer_refuses(data):
    _, td = data
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _trainer(data, pk_loss_weight=0.1)
    tr = ttrainer.CVAETrainer(CVAE(_arch()), td, device="cpu")
    with pytest.raises(RuntimeError, match="device_data"):
        tr.step_indices(np.arange(BATCH), LR)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            ttrainer.CVAETrainer(CVAE(_arch()), td)


_BLOCKED_TRAIN = textwrap.dedent("""
    import importlib, importlib.abc, importlib.util, pkgutil, sys
    BLOCKED = ("jax", "jaxlib", "flax", "msgpack", "optax",
               "baryon_painter_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, Block())
    import numpy as np
    import baryon_painter_tpu_torch as pkg
    for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
        importlib.import_module(m.name)
    from baryon_painter_tpu_torch import smoke
    ds = smoke.training_data(tile=32)
    tr = smoke.make_trainer("cpu", ds, True, n_res_blocks=1)
    m = tr.step_indices(ds.sample_indices(np.random.default_rng(0), 2), 1e-3)
    assert all(bool(v.isfinite().all()) for v in m.values())
    # the training CLI twin: a run with a checkpoint, then a resume from it
    import tempfile
    spec = importlib.util.spec_from_file_location(
        "twin", "scripts/train_cvae_torch.py")
    twin = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(twin)
    with tempfile.TemporaryDirectory() as out:
        args = ["--synthetic", "--synthetic-grid", "64", "--n-tile", "2",
                "--n-training-stack", "1", "--n-validation-stack", "1",
                "--n-pepoch", "1", "--pepoch-size", "8", "--n-res-blocks",
                "1", "--output-path", out, "--device", "cpu"]
        run = twin.run(args)
        res = twin.run(args + ["--resume-from", out + "/model"])
        assert run["trainer"].steps == res["trainer"].steps == 2
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("TRAINED", float(m["elbo"]) < 0)
""")


def test_every_port_module_imports_and_trains_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_TRAIN], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "TRAINED True" in proc.stdout
