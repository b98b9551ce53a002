"""The port's data-parallel CVAE step on a z-skewed mesh: three redshifts
over two gloo ranks, on the CPU.

The z-sharded stack cache puts z = 0 and 1 on rank 0 and z = 0.5 on rank
1, so its device-grouped draw (``sample_mesh_indices``) takes z = 0.5 at
twice the others' rate; ``CVAETrainer.step_indices`` hands the cache's
importance weights (2/3 for z = 0.5, 4/3 for the others) to the CVAE's
KL and likelihood terms, each rank its rows'. The fiducial data has 11
redshifts, so every 2- or 4-rank run steps this way.

Held, at tests/test_torch_mesh_trainer.py's size and tolerances: the
two-rank step through the cache equals the one-process step given the
same rows and weights (metrics, gradients, running statistics,
parameters), that one-process step equals the JAX trainer's step through
its cache z-sharded over a 2-device mesh (which applies the same
weights), and the two-rank step on the same rows as a host batch, which
applies no weights, differs.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from baryon_painter_tpu.data.dataset import BahamasTileDataset as JaxDataset
from baryon_painter_tpu.data.dataset import load_file_info
from baryon_painter_tpu.models import cvae as jcvae
from baryon_painter_tpu.train import trainer as jtrainer
from baryon_painter_tpu.transforms import RangeCompress as JaxRC
from baryon_painter_tpu_torch.data.device_cache import (DeviceStackCache,
                                                        sample_mesh_indices)
from baryon_painter_tpu_torch.data.synthetic import make_synthetic_stacks
from baryon_painter_tpu_torch.models.cvae import CVAE
from baryon_painter_tpu_torch.train.trainer import CVAETrainer, TrainConfig
from test_torch_mesh_trainer import (BATCH, ELBO_RTOL, _flat, _grads_close,
                                     _jax_layout, _params_close)
from torch_mesh_workers import (LR, TILE, Layout, cvae_arch, make_dataset,
                                module_state, run_ranks)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def skewed(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stacks3"))
    info = make_synthetic_stacks(root, n_stack=2, n_grid=2 * TILE,
                                 redshifts=(0.0, 0.5, 1.0), seed=0)
    jd = JaxDataset(files=load_file_info(info), root_path=root, n_tile=2,
                    tile_permutations=True,
                    transforms={"dm": JaxRC("shift-log", 4.0),
                                "pressure": JaxRC("shift-log", 4.0)})
    td = make_dataset(root, info)
    idx = sample_mesh_indices(td, 2, np.random.default_rng(4), BATCH)
    eps = np.random.default_rng(5).standard_normal(
        (1, BATCH, 1, TILE // 32, TILE // 32)).astype(np.float32)
    return dict(root=root, info=info, jd=jd, td=td, idx=idx, eps=eps)


def _jax_mesh_step(jd, idx, eps):
    """The JAX trainer's step through its cache z-sharded over 2 devices,
    the latent noise fixed: (initial variables, metrics, variables)."""
    def sample_z(self, rng, z_mu, z_log_var, L=1):
        e = jnp.asarray(eps).transpose(0, 1, 3, 4, 2)[:, :z_mu.shape[0]]
        z = z_mu[None] + e * (jnp.exp(z_log_var[None] / 2) + self.min_z_var)
        return z.reshape(-1, *z_mu.shape[1:])

    to_np = lambda t: jax.tree.map(np.asarray, t)
    mesh = Mesh(np.array(jax.devices()[:2]), axis_names=("data",))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcvae.CVAE, "sample_z", sample_z)
        jt = jtrainer.CVAETrainer(jcvae.CVAE(cvae_arch()), jd,
                                  config=jtrainer.TrainConfig(seed=0),
                                  mesh=mesh, device_data=True)
        assert not jt.device_cache.uniform_z
        init = {"params": to_np(jt.state.params),
                "batch_stats": to_np(jt.state.batch_stats)}
        m = to_np(jt.step_indices(idx, lr=LR))
    return init, m, {"params": to_np(jt.state.params),
                     "batch_stats": to_np(jt.state.batch_stats)}


def test_skewed_mesh_applies_the_cache_weights(skewed, tmp_path):
    td, idx, eps = skewed["td"], skewed["idx"], skewed["eps"]
    layout = DeviceStackCache(td, mesh=Layout(2))
    assert not layout.uniform_z
    sw = layout.z_slot_weights[layout.digits(idx)[:, 0]]
    np.testing.assert_allclose(sorted(set(sw.tolist())), [2 / 3, 4 / 3],
                               rtol=1e-6)
    init, jm, jvars = _jax_mesh_step(skewed["jd"], idx, eps)

    r0, r1 = run_ranks("cvae", 2, tmp_path, dict(
        root=skewed["root"], info=skewed["info"], variables=init, eps=eps,
        idx=idx, idx_cache=idx))
    got = r0[True]
    for n, p in r1[True]["params"].items():
        np.testing.assert_array_equal(p, got["params"][n])

    # the same rows and weights in one process
    tr = CVAETrainer(CVAE(cvae_arch()), td, config=TrainConfig(seed=0),
                     device="cpu", variables=init, device_data=True)
    raw = tr.device_cache.gather(tr.device_cache.digits(idx))
    want = module_state(tr.model, tr._step(
        *raw, LR, 1.0, 1.0, eps, sample_weight=torch.from_numpy(sw)))
    for k in ("elbo", "kl"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                   rtol=ELBO_RTOL, atol=1e-6, err_msg=k)
    _grads_close(got["grads"], want["grads"])
    for n, b in want["buffers"].items():
        np.testing.assert_allclose(got["buffers"][n], b, rtol=1e-5,
                                   atol=1e-5, err_msg=n)
    _params_close(got["params"], want["params"])

    # the unweighted step on the same rows differs
    unweighted = float(r0[False]["metrics"]["elbo"])
    assert abs(unweighted - float(got["metrics"]["elbo"])) > 1e-4 * abs(
        unweighted)

    # the one-process weighted step equals the JAX trainer's mesh step
    for k in ("elbo", "kl"):
        np.testing.assert_allclose(float(want["metrics"][k]), float(jm[k]),
                                   rtol=ELBO_RTOL, atol=1e-6, err_msg=k)
    port = _jax_layout(want)
    _params_close(_flat(port["params"]), _flat(jvars["params"]))
    want_bs = _flat(jvars["batch_stats"])
    for k, v in _flat(port["batch_stats"]).items():
        np.testing.assert_allclose(v, want_bs[k], rtol=2e-4, atol=1e-6,
                                   err_msg=k)
