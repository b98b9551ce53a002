"""The port's data-parallel CVAE step (``CVAETrainer(mesh=ProcessMesh)``) on
2 and 4 gloo ranks, against the port's one-process step and the JAX
package's 8-device mesh step, on the CPU.

The JAX test's size (tests/test_trainer.py): 32^2 tiles, one residual
block, a global batch of 8, lr 1e-3, from the JAX trainer's initial
variables, with the latent noise fixed (the JAX ``CVAE.sample_z`` patched
to use it; the port takes it as ``eps``, each rank its rows). Each case
steps once on a host batch and once through the stack cache, which the
mesh z-shards over the ranks (its batch drawn device-grouped,
``sample_mesh_indices``; two redshifts over 2 or 4 ranks are sampled
uniformly, so no importance weights).

Held, as tests/test_trainer.py:143 holds JAX's 8-device step to its
one-device step: the ELBO to rtol 2e-4, the KL to rtol 2e-4 (atol 1e-6);
the parameters after Adam's first step (about lr * sign(g), so an entry
with g near 0 may flip under another summation order) within 2 lr + eps,
and under 2 % of them more than 1e-5 apart. Against the port's one-process
step also every gradient leaf (rtol 1e-3, atol 1e-4 of the largest
gradient entry, as tests/test_torch_trainer.py holds the port to JAX) and the running statistics (1e-5), and against JAX's the new
batch statistics (rtol 2e-4, atol 1e-6). Every rank ends with the same
parameters, bit for bit, and a one-rank mesh step is the step without a
mesh, bit for bit (a one-rank all-reduce is the identity). The fused
variant (K4's plain versions at the decoder's up-convs) and the spectral
term (per redshift and pooled: its batch means and clamp range over the
global batch, its prior noise the global draw's rows) are held to the
port's own one-process step the same way, the spectral loss to rtol 1e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from baryon_painter_tpu.data.dataset import BahamasTileDataset as JaxDataset
from baryon_painter_tpu.data.dataset import load_file_info
from baryon_painter_tpu.models import cvae as jcvae
from baryon_painter_tpu.train import trainer as jtrainer
from baryon_painter_tpu.transforms import RangeCompress as JaxRC
from baryon_painter_tpu_torch.convert import to_jax_variables
from baryon_painter_tpu_torch.data.device_cache import sample_mesh_indices
from baryon_painter_tpu_torch.data.synthetic import make_synthetic_stacks
from baryon_painter_tpu_torch.models.cvae import CVAE
from torch_mesh_workers import (LR, TILE, cvae_arch, cvae_step, make_dataset,
                                run_ranks)

BATCH = 8
ELBO_RTOL = 2e-4
PARAM_ABS = 2.5e-3          # 2 lr + eps
PARAM_FLIP, PARAM_FLIP_SHARE = 1e-5, 0.02


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stacks"))
    info = make_synthetic_stacks(root, n_stack=2, n_grid=2 * TILE,
                                 redshifts=(0.0, 1.0), seed=0)
    jd = JaxDataset(files=load_file_info(info), root_path=root, n_tile=2,
                    tile_permutations=True,
                    transforms={"dm": JaxRC("shift-log", 4.0),
                                "pressure": JaxRC("shift-log", 4.0)})
    td = make_dataset(root, info)
    eps = np.random.default_rng(5).standard_normal(
        (1, BATCH, 1, TILE // 32, TILE // 32)).astype(np.float32)
    idx = {"host": td.sample_indices(np.random.default_rng(1), BATCH)}
    for n in (2, 4):
        idx[n] = sample_mesh_indices(td, n, np.random.default_rng(1), BATCH)
    return dict(root=root, info=info, jd=jd, td=td, eps=eps, idx=idx)


@pytest.fixture(scope="module")
def jax_steps(data):
    """The JAX trainer on an 8-device mesh, one step from its initial
    variables on each batch (a host batch sharded over the devices)."""
    eps = data["eps"]

    def sample_z(self, rng, z_mu, z_log_var, L=1):
        e = jnp.asarray(eps).transpose(0, 1, 3, 4, 2)[:, :z_mu.shape[0]]
        z = z_mu[None] + e * (jnp.exp(z_log_var[None] / 2) + self.min_z_var)
        return z.reshape(-1, *z_mu.shape[1:])

    mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("data",))
    to_np = lambda t: jax.tree.map(np.asarray, t)
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcvae.CVAE, "sample_z", sample_z)
        jt = jtrainer.CVAETrainer(jcvae.CVAE(cvae_arch()), data["jd"],
                                  config=jtrainer.TrainConfig(seed=0),
                                  mesh=mesh)
        init = {"params": to_np(jt.state.params),
                "batch_stats": to_np(jt.state.batch_stats)}
        for key, idx in data["idx"].items():
            tree = jax.tree.map(jnp.asarray, init)
            jt.state = jax.device_put(jtrainer.TrainState(
                params=tree["params"], batch_stats=tree["batch_stats"],
                opt_state=jt.optimizer.init(tree["params"]),
                step=jnp.zeros((), jnp.int32)), NamedSharding(mesh, P()))
            m = to_np(jt.step(data["jd"].get_raw_batch(idx), lr=LR))
            out[key] = {"metrics": m, "params": to_np(jt.state.params),
                        "batch_stats": to_np(jt.state.batch_stats)}
    return init, out


def _args(data, init, world, **kw):
    return dict(root=data["root"], info=data["info"], variables=init,
                eps=data["eps"], idx=data["idx"]["host"],
                idx_cache=data["idx"][world], **kw)


@pytest.fixture(scope="module")
def dp(data, jax_steps, tmp_path_factory):
    """Each world's ranks: a host-batch step and a cache step each."""
    init, _ = jax_steps
    tmp = tmp_path_factory.mktemp("dp")
    return {world: run_ranks("cvae", world, tmp, _args(data, init, world))
            for world in (2, 4)}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _jax_layout(state: dict, fused_train_conv=False) -> dict:
    """A rank's parameters and running statistics in the JAX layout."""
    model = CVAE(cvae_arch(), fused_train_conv=fused_train_conv)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in
                           {**state["params"], **state["buffers"]}.items()})
    return to_jax_variables(model)


def _params_close(got: dict, want: dict):
    a = np.concatenate([got[k].ravel() for k in sorted(want)])
    b = np.concatenate([np.asarray(want[k]).ravel() for k in sorted(want)])
    d = np.abs(a - b)
    assert d.max() < PARAM_ABS, d.max()
    assert np.mean(d > PARAM_FLIP) < PARAM_FLIP_SHARE, np.mean(d > PARAM_FLIP)


def _grads_close(got: dict, want: dict):
    """rtol 1e-3, atol 1e-4 of the largest gradient entry of all (some
    gradients are 0 analytically and both sides return rounding noise)."""
    top = max(np.abs(g).max() for g in want.values())
    for n, g in want.items():
        np.testing.assert_allclose(got[n], g, rtol=1e-3, atol=1e-4 * top,
                                   err_msg=n)


CASES = [(w, c) for w in (2, 4) for c in (False, True)]
IDS = [f"{w}ranks-{'z_sharded_cache' if c else 'host_batch'}"
       for w, c in CASES]


@pytest.mark.parametrize("world,cache", CASES, ids=IDS)
def test_dp_step_matches_the_one_process_step(data, jax_steps, dp, world,
                                              cache):
    init, _ = jax_steps
    idx = data["idx"][world] if cache else data["idx"]["host"]
    want = cvae_step(data["td"], init, idx, data["eps"], None, cache)
    ranks = [r[cache] for r in dp[world]]
    got = ranks[0]
    for r in ranks[1:]:
        for n, p in r["params"].items():
            np.testing.assert_array_equal(p, got["params"][n])
    for k in ("elbo", "kl"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                   rtol=ELBO_RTOL, atol=1e-6, err_msg=k)
    _grads_close(got["grads"], want["grads"])
    for n, b in want["buffers"].items():
        np.testing.assert_allclose(got["buffers"][n], b, rtol=1e-5,
                                   atol=1e-5, err_msg=n)
    _params_close(got["params"], want["params"])


@pytest.mark.parametrize("world,cache", CASES, ids=IDS)
def test_dp_step_matches_the_jax_mesh_step(data, jax_steps, dp, world,
                                           cache):
    _, jsteps = jax_steps
    js = jsteps[world if cache else "host"]
    got = dp[world][0][cache]
    np.testing.assert_allclose(float(got["metrics"]["elbo"]),
                               float(js["metrics"]["elbo"]), rtol=ELBO_RTOL)
    np.testing.assert_allclose(float(got["metrics"]["kl"]),
                               float(js["metrics"]["kl"]), rtol=ELBO_RTOL,
                               atol=1e-6)
    port = _jax_layout(got)
    _params_close(_flat(port["params"]), _flat(js["params"]))
    want_bs = _flat(js["batch_stats"])
    for k, v in _flat(port["batch_stats"]).items():
        np.testing.assert_allclose(v, want_bs[k], rtol=2e-4, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("cache", [False, True],
                         ids=["host_batch", "cache"])
def test_one_rank_mesh_step_is_the_plain_step(data, jax_steps, tmp_path,
                                              cache):
    init, _ = jax_steps
    a = _args(data, init, 2)
    a["idx_cache"] = data["idx"]["host"]
    (res,) = run_ranks("cvae", 1, tmp_path, a)
    got, want = res[cache], res[("plain", cache)]
    for part in ("metrics", "params", "grads", "buffers"):
        for n, v in want[part].items():
            np.testing.assert_array_equal(got[part][n], v,
                                          err_msg=f"{part} {n}")


def test_dp_step_with_fused_train_conv(data, jax_steps, tmp_path):
    """K4's sites (their plain versions here) under 2 ranks: the global
    batch's statistics between its launches."""
    init, _ = jax_steps
    res = run_ranks("cvae", 2, tmp_path,
                    _args(data, init, 2, fused_train_conv=True))
    for cache in (False, True):
        idx = data["idx"][2] if cache else data["idx"]["host"]
        want = cvae_step(data["td"], init, idx, data["eps"], None, cache,
                         fused_train_conv=True)
        got = res[0][cache]
        np.testing.assert_allclose(got["metrics"]["elbo"],
                                   want["metrics"]["elbo"], rtol=ELBO_RTOL)
        _grads_close(got["grads"], want["grads"])
        _params_close(got["params"], want["params"])


@pytest.mark.parametrize("per_z", [True, False], ids=["per_z", "pooled"])
def test_dp_step_with_the_spectral_term(data, jax_steps, tmp_path, per_z):
    init, _ = jax_steps
    config = {"pk_loss_weight": 2e4, "pk_loss_per_z": per_z}
    res = run_ranks("cvae", 2, tmp_path, _args(data, init, 2,
                                               config=config))
    for cache in (False, True):
        idx = data["idx"][2] if cache else data["idx"]["host"]
        want = cvae_step(data["td"], init, idx, data["eps"], None, cache,
                         config=config)
        got = res[0][cache]
        for k in ("elbo", "pk_loss"):
            np.testing.assert_allclose(got["metrics"][k],
                                       want["metrics"][k], rtol=1e-5,
                                       err_msg=k)
        _grads_close(got["grads"], want["grads"])
        _params_close(got["params"], want["params"])
