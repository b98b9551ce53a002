"""One bf16 training step of the port against the JAX trainer's bf16 step.

The JAX package's ``CVAETrainer`` with ``CVAE(arch, dtype=jnp.bfloat16)``
and the port's with ``CVAE(arch, dtype=torch.bfloat16)`` take one step from
the same initial weights (the JAX trainer's, carried across), the same
batch and the same latent noise, at ``tests/test_torch_trainer.py``'s size
(32^2, batch 2, one residual block), with the output heads unfused and
fused (JAX ``BPT_FUSED_HEADS=1`` in interpret mode; the port's K3 plain
bf16 versions). Parameters, gradients, Adam and the batch statistics stay
f32 in both. With d the relative L2 distance, and the JAX step's f32
counterpart as the scale:

* the concatenated gradient: d(port bf16, JAX bf16) <= 0.5 d(JAX f32,
  JAX bf16) (JAX's gradient under ``jax.jit``, as its step computes it),
  and d(port bf16, port f32) >= 0.5 of that distance: the step really is
  bf16;
* the loss: |port - JAX| / |JAX| <= max(0.5 of the JAX bf16-f32 relative
  difference, 1e-5);
* the running statistics after the step: the same rule as the gradient.
"""
import jax
import jax.numpy as jnp
import numpy as np
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
from baryon_painter_tpu_torch.models import layers as tlayers
from baryon_painter_tpu_torch.models.cvae import (CVAE,
                                                  fiducial_cvae_architecture)
from baryon_painter_tpu_torch.train import trainer as ttrainer
from baryon_painter_tpu_torch.transforms import RangeCompress

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


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float64)
    return out


def _vec(tree):
    flat = _flat(tree)
    return np.concatenate([flat[k].ravel() for k in sorted(flat)])


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module", params=[False, True],
                ids=["heads_unfused", "heads_fused"])
def steps(request, data):
    return run_steps(data, request.param)


def run_steps(data, fused, fused_train_conv=False):
    """For f32 and bf16: the JAX trainer's gradients (``jax.jit`` of its
    step's loss), loss and running statistics after its step, and the
    port's, from the JAX trainer's initial weights, batch and noise; the
    heads ``fused`` or not, the train-mode conv + batch norm + ReLU triples
    through K4 with ``fused_train_conv`` (JAX ``BPT_FUSED_TRAIN_CONV=1``),
    the port's K4 calls counted in ``k4_calls``."""
    jd, td = data
    arch = fiducial_cvae_architecture(TILE, n_res_blocks=1)
    eps = np.random.default_rng(5).standard_normal(
        (1, BATCH, 1, TILE // 32, TILE // 32)).astype(np.float32)

    def sample_z(self, rng, z_mu, z_log_var, L=1):
        e = jnp.asarray(eps).transpose(0, 1, 3, 4, 2)[:, :z_mu.shape[0]]
        z = z_mu[None] + e * (jnp.exp(z_log_var[None] / 2) + self.min_z_var)
        return z.reshape(-1, *z_mu.shape[1:])

    out = {}
    k4_calls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcvae.CVAE, "sample_z", sample_z)
        mp.setenv("BPT_FUSED_HEADS", "1" if fused else "0")
        mp.setenv("BPT_FUSED_TRAIN_CONV", "1" if fused_train_conv else "0")
        counted = tlayers.conv_bn_relu
        mp.setattr(tlayers, "conv_bn_relu", lambda *a, **kw: (
            k4_calls.append(a[0].dtype), counted(*a, **kw))[1])
        for jdt, tdt in ((None, None), (jnp.bfloat16, torch.bfloat16)):
            jt = jtrainer.CVAETrainer(jcvae.CVAE(arch, dtype=jdt), jd,
                                      config=jtrainer.TrainConfig(seed=0),
                                      device_data=True)
            to_np = lambda t: jax.tree.map(np.asarray, t)
            init = {"params": to_np(jt.state.params),
                    "batch_stats": to_np(jt.state.batch_stats)}
            idx = jd.sample_indices(np.random.default_rng(1), BATCH)
            raw = jt.device_cache.gather(
                jnp.asarray(jt.device_cache.digits(idx)))

            def loss(params):
                o, _ = jt._forward(params, jt.state.batch_stats, *raw,
                                   jax.random.PRNGKey(0), 1.0, 1.0, True)
                return -o["elbo"]

            grads = to_np(jax.jit(jax.grad(loss))(jt.state.params))
            metrics = to_np(jt.step_indices(idx, lr=LR))
            model = CVAE(arch, fused_heads=fused,
                         fused_train_conv=fused_train_conv, dtype=tdt)
            tr = ttrainer.CVAETrainer(model, td, device_data=True,
                                      device="cpu", variables=init)
            tm = tr.step_indices(idx, LR, eps=eps)
            out[jdt is not None] = dict(
                jax_grads=_vec(grads), jax_loss=float(metrics["elbo"]),
                jax_stats=_vec(to_np(jt.state.batch_stats)),
                port_grads=_vec(to_jax_variables(tr.model,
                                                 grads=True)["params"]),
                port_loss=float(tm["elbo"]),
                port_stats=_vec(to_jax_variables(tr.model)["batch_stats"]),
                port_param_dtypes={p.dtype for p in tr.model.parameters()},
                adam_dtypes={m.dtype for m in tr.optimizer.mu},
                k4_calls=list(k4_calls))
            k4_calls.clear()
    return out


def test_bf16_step_gradient_matches_the_jax_bf16_step(steps):
    b, f = steps[True], steps[False]
    gap = _rel(f["jax_grads"], b["jax_grads"])
    assert gap > 1e-3                      # bf16 is another step than f32
    d = _rel(b["port_grads"], b["jax_grads"])
    assert d <= 0.5 * gap, (d, gap)
    assert _rel(b["port_grads"], f["port_grads"]) >= 0.5 * gap
    assert _rel(f["port_grads"], f["jax_grads"]) < 1e-4


def test_bf16_step_loss_matches_the_jax_bf16_step(steps):
    b, f = steps[True], steps[False]
    gap = abs(f["jax_loss"] - b["jax_loss"]) / abs(b["jax_loss"])
    d = abs(b["port_loss"] - b["jax_loss"]) / abs(b["jax_loss"])
    assert d <= max(0.5 * gap, 1e-5), (d, gap)


def test_bf16_step_running_statistics_match_the_jax_bf16_step(steps):
    b, f = steps[True], steps[False]
    gap = _rel(f["jax_stats"], b["jax_stats"])
    d = _rel(b["port_stats"], b["jax_stats"])
    assert d <= max(0.5 * gap, 1e-5), (d, gap)


def test_bf16_step_keeps_parameters_and_adam_state_f32(steps):
    assert steps[True]["port_param_dtypes"] == {torch.float32}
    assert steps[True]["adam_dtypes"] == {torch.float32}
