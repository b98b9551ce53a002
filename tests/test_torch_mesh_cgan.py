"""The port's data-parallel CGAN step (``CGANTrainer(mesh=ProcessMesh)``) on
2 and 4 gloo ranks, against the port's one-process step and the JAX
package's 8-device mesh step, and its per-sample importance weights, on
the CPU.

The JAX test's size (tests/test_cgan.py): 64^2 stacks, 32^2 tiles, one
residual block, here a global batch of 8 at lr 5e-5, from the JAX trainer's
initial state (G, D, batch-norm and spectral-norm state). Each case steps
once on a host batch and once through the stack cache z-sharded over the
ranks (a device-grouped batch).

Held: the metrics to rtol 2e-4 of JAX's and of the one-process port's;
every gradient leaf of G and D to the one-process port's (rtol 1e-3, atol
1e-4 of the network's largest gradient entry); the parameters after both
Adams within 2 lr + eps of JAX's, under 2 % of them more than 1e-6 apart;
every rank's parameters and spectral-norm state the same bit for bit.

With three redshifts over two ranks (n_z % n != 0) the z-sharded layout
samples redshifts unevenly (tests/test_cgan.py:436): the step applies the
cache's importance weights, and equals the one-process step given those
weights explicitly, which itself equals the JAX step given them (metrics
rtol 2e-4), and differs from the unweighted step. Feature matching with
the spectral term (batch-mean features and spectra over the global batch,
each a term every rank holds whole) on 2 ranks equals the one-process
step the same way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from baryon_painter_tpu.data.dataset import BahamasTileDataset as JaxDataset
from baryon_painter_tpu.data.dataset import load_file_info
from baryon_painter_tpu.models.cgan import CGANDiscriminator as JaxD
from baryon_painter_tpu.models.cgan import CGANGenerator as JaxG
from baryon_painter_tpu.train import cgan as jcgan
from baryon_painter_tpu.transforms import RangeCompress as JaxRC
from baryon_painter_tpu_torch.convert import to_jax_variables
from baryon_painter_tpu_torch.data.device_cache import (DeviceStackCache,
                                                        sample_mesh_indices)
from baryon_painter_tpu_torch.data.synthetic import make_synthetic_stacks
from baryon_painter_tpu_torch.models.cgan import (CGANDiscriminator,
                                                  CGANGenerator)
from torch_mesh_workers import (TILE, Layout, cgan_result, cgan_trainer,
                                make_dataset, run_ranks)

BATCH, LR = 8, 5e-5
RTOL = 2e-4
PARAM_ABS = 2.5 * LR
PARAM_FLIP, PARAM_FLIP_SHARE = 1e-6, 0.02


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(tmp_path_factory, redshifts):
    root = str(tmp_path_factory.mktemp("stacks"))
    info = make_synthetic_stacks(root, n_stack=2, n_grid=2 * TILE,
                                 redshifts=redshifts, seed=0)
    jd = JaxDataset(files=load_file_info(info), root_path=root, n_tile=2,
                    tile_permutations=True,
                    transforms={"dm": JaxRC("shift-log", 4.0),
                                "pressure": JaxRC("shift-log", 4.0)})
    return dict(root=root, info=info, jd=jd, td=make_dataset(root, info))


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    d = _data(tmp_path_factory, (0.0, 1.0))
    d["idx"] = {"host": d["td"].sample_indices(np.random.default_rng(1),
                                               BATCH)}
    for n in (2, 4):
        d["idx"][n] = sample_mesh_indices(d["td"], n,
                                          np.random.default_rng(1), BATCH)
    return d


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


class JaxMesh:
    """The JAX CGAN trainer on an 8-device mesh, stepped from its initial
    state on a host batch (sharded over the devices)."""

    def __init__(self, jd):
        self.mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("data",))
        self.jt = jcgan.CGANTrainer(
            jd, generator=JaxG(n_res_blocks=1), discriminator=JaxD(),
            config=jcgan.CGANTrainConfig(seed=0, batch_size=BATCH),
            mesh=self.mesh)
        self.init = {k: _np(getattr(self.jt.state, k))
                     for k in ("g_params", "g_stats", "d_params", "d_stats")}
        self._step = jax.jit(self.jt._train_step_impl)
        self.jd = jd

    def step(self, idx):
        jt, tree = self.jt, jax.tree.map(jnp.asarray, self.init)
        state = jcgan.GANTrainState(
            g_params=tree["g_params"], g_stats=tree["g_stats"],
            g_opt=jt.optimizer.init(tree["g_params"]),
            d_params=tree["d_params"], d_stats=tree["d_stats"],
            d_opt=jt.optimizer.init(tree["d_params"]),
            step=jnp.zeros((), jnp.int32))
        sh = NamedSharding(self.mesh, P("data"))
        b = self.jd.get_raw_batch(idx)
        put = lambda a: jax.device_put(jnp.asarray(a), sh)
        state, m = self._step(jax.device_put(state, NamedSharding(
            self.mesh, P())), put(b["input"]), put(b["labels"][0]),
            put(b["z"]), jax.random.PRNGKey(0), jnp.float32(LR))
        return {"metrics": _np(m), "g": _np(state.g_params),
                "d": _np(state.d_params)}


@pytest.fixture(scope="module")
def jax_mesh(data):
    return JaxMesh(data["jd"])


@pytest.fixture(scope="module")
def dp(data, jax_mesh, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    return {world: run_ranks("cgan", world, tmp, dict(
        root=data["root"], info=data["info"], state=jax_mesh.init,
        idx=data["idx"]["host"], idx_cache=data["idx"][world], lr=LR))
        for world in (2, 4)}


def _params_jax_layout(res: dict) -> dict:
    out = {}
    for net, cls in (("g", lambda: CGANGenerator(n_res_blocks=1,
                                                 spectral_norm=True)),
                     ("d", CGANDiscriminator)):
        model = cls()
        model.load_state_dict({k: torch.from_numpy(v) for k, v in {
            **res[net]["params"], **res[net]["buffers"]}.items()})
        out[net] = _flat(to_jax_variables(model)["params"])
    return out


def _params_close(got: dict, want: dict):
    a = np.concatenate([got[k].ravel() for k in sorted(want)])
    b = np.concatenate([np.asarray(want[k]).ravel() for k in sorted(want)])
    d = np.abs(a - b)
    assert d.max() < PARAM_ABS, d.max()
    assert np.mean(d > PARAM_FLIP) < PARAM_FLIP_SHARE, np.mean(d > PARAM_FLIP)


def _metrics_close(got: dict, want: dict):
    for k in ("loss_D", "loss_G_adv", "loss_G_perceptual", "D_real",
              "D_fake"):
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=RTOL,
                                   err_msg=k)


def _grads_close(got: dict, want: dict):
    for net in "gd":
        top = max(np.abs(g).max() for g in want[net]["grads"].values())
        for n, g in want[net]["grads"].items():
            np.testing.assert_allclose(got[net]["grads"][n], g, rtol=1e-3,
                                       atol=1e-4 * top, err_msg=f"{net} {n}")


CASES = [(w, c) for w in (2, 4) for c in (False, True)]
IDS = [f"{w}ranks-{'z_sharded_cache' if c else 'host_batch'}"
       for w, c in CASES]


@pytest.mark.parametrize("world,cache", CASES, ids=IDS)
def test_dp_step_matches_the_one_process_step(data, jax_mesh, dp, world,
                                              cache):
    idx = data["idx"][world] if cache else data["idx"]["host"]
    tr = cgan_trainer(data["td"], jax_mesh.init, None, cache,
                      batch_size=BATCH)
    m = (tr.step_indices(idx, LR) if cache
         else tr.step(data["td"].get_raw_batch(idx), LR))
    want = cgan_result(tr, m)
    ranks = [r[cache] for r in dp[world]]
    for r in ranks[1:]:
        for net in "gd":
            for part in ("params", "buffers"):
                for n, v in r[net][part].items():
                    np.testing.assert_array_equal(v, ranks[0][net][part][n])
    _metrics_close(ranks[0]["metrics"], want["metrics"])
    _grads_close(ranks[0], want)
    for net in "gd":
        _params_close(ranks[0][net]["params"], want[net]["params"])


@pytest.mark.parametrize("world,cache", CASES, ids=IDS)
def test_dp_step_matches_the_jax_mesh_step(data, jax_mesh, dp, world,
                                           cache):
    js = jax_mesh.step(data["idx"][world] if cache else data["idx"]["host"])
    got = dp[world][0][cache]
    _metrics_close(got["metrics"], js["metrics"])
    port = _params_jax_layout(got)
    for net in "gd":
        _params_close(port[net], _flat(js[net]))


@pytest.fixture(scope="module")
def three_z(tmp_path_factory):
    return _data(tmp_path_factory, (0.0, 0.5, 1.0))


def test_skewed_mesh_applies_the_cache_weights(three_z, tmp_path):
    """Three redshifts over two ranks: rank 0 holds z = 0 and 1, rank 1
    z = 0.5, so z = 0.5 is drawn at twice the others' rate; its rows weigh
    2/3 and the others' 4/3 (rtol 2e-4 on the metrics, gradients as
    above)."""
    td, jd = three_z["td"], three_z["jd"]
    idx = sample_mesh_indices(td, 2, np.random.default_rng(4), BATCH)
    layout = DeviceStackCache(td, mesh=Layout(2))
    assert not layout.uniform_z
    r0, _ = run_ranks("cgan", 2, tmp_path, dict(
        root=three_z["root"], info=three_z["info"],
        state=_init_state(jd), idx=idx, idx_cache=idx, lr=LR))
    got = r0[True]
    assert got["uniform_z"] is False
    # the same rows and weights in one process
    sw = layout.z_slot_weights[layout.digits(idx)[:, 0]]
    np.testing.assert_allclose(sorted(set(sw.tolist())), [2 / 3, 4 / 3],
                               rtol=1e-6)
    tr = cgan_trainer(td, _init_state(jd), None, True, batch_size=BATCH)
    raw = tr.device_cache.gather(tr.device_cache.digits(idx))
    m = tr._step(raw[0], raw[1][0], raw[2], LR,
                 sample_weight=torch.from_numpy(sw))
    want = cgan_result(tr, m)
    _metrics_close(got["metrics"], want["metrics"])
    _grads_close(got, want)
    # the unweighted step (the host batch) differs
    assert abs(r0[False]["metrics"]["loss_G_perceptual"]
               - got["metrics"]["loss_G_perceptual"]) > 1e-6
    # the one-process weighted step equals the JAX step given the weights
    _metrics_close(want["metrics"], _jax_weighted(jd, idx, sw))


_INIT = {}


def _init_state(jd):
    """The JAX CGAN trainer's initial state on ``jd`` (seed 0)."""
    if id(jd) not in _INIT:
        jt = jcgan.CGANTrainer(jd, generator=JaxG(n_res_blocks=1),
                               discriminator=JaxD(),
                               config=jcgan.CGANTrainConfig(
                                   seed=0, batch_size=BATCH))
        _INIT[id(jd)] = (jt, {k: _np(getattr(jt.state, k)) for k in
                              ("g_params", "g_stats", "d_params",
                               "d_stats")})
    return _INIT[id(jd)][1]


def _jax_weighted(jd, idx, sw):
    jt, _ = _INIT[id(jd)]
    b = jd.get_raw_batch(idx)
    _, m = jax.jit(jt._train_step_impl)(
        jt.state, jnp.asarray(b["input"]), jnp.asarray(b["labels"][0]),
        jnp.asarray(b["z"]), jax.random.PRNGKey(0), jnp.float32(LR),
        sample_weight=jnp.asarray(sw))
    return _np(m)


def test_dp_feature_matching_with_the_spectral_term(data, jax_mesh,
                                                    tmp_path):
    config = {"feature_matching": True, "pk_loss_weight": 1.0,
              "pk_loss_per_z": True}
    res = run_ranks("cgan", 2, tmp_path, dict(
        root=data["root"], info=data["info"], state=jax_mesh.init,
        idx=data["idx"]["host"], idx_cache=data["idx"][2], lr=LR,
        config=config))
    for cache in (False, True):
        idx = data["idx"][2] if cache else data["idx"]["host"]
        tr = cgan_trainer(data["td"], jax_mesh.init, None, cache,
                          batch_size=BATCH, **config)
        m = (tr.step_indices(idx, LR) if cache
             else tr.step(data["td"].get_raw_batch(idx), LR))
        want = cgan_result(tr, m)
        got = res[0][cache]
        _metrics_close(got["metrics"], want["metrics"])
        np.testing.assert_allclose(got["metrics"]["pk_loss"],
                                   want["metrics"]["pk_loss"], rtol=1e-5)
        _grads_close(got, want)
