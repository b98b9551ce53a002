"""The port's meshes (parallel/mesh.py), its sync batch norm, K4's sums
across ranks and the z-sharded stack cache's layout, on the CPU.

Ranks are processes of their own over gloo (``tests/torch_mesh_workers.py``:
a ``file://`` rendezvous in the test's directory, one thread each, a
timeout on the group and on the launch, so that a hung collective fails
its test).

* The collectives of ``ProcessMesh`` on 2 and 3 ranks: sum, min, max,
  broadcast, the differentiable sum's gradient, the flat all-reduce.
* ``BatchNorm`` in train mode inside ``mesh.active()`` on 2 and 4 ranks
  equals the one-process ``BatchNorm`` on the concatenated batch: output,
  input and parameter gradients, running statistics, to 1e-6; on one rank
  it equals the module without a mesh bit for bit.
* K4's autograd function (``conv_bn_relu``, its plain versions here) on 2
  ranks equals the one-process call on the concatenated batch: y, mean,
  var, dx, dW, dgamma, dbeta (rtol 1e-5 of each one's largest entry).
* The z-sharded cache's slot layout (``_slot_assignment``) equals the JAX
  package's for n_z in 1..11 and n in 1..8, its device-grouped draw
  (``sample_mesh_indices``) equals JAX's row for row from the same numpy
  seed, and its importance weights (``z_slot_weights``, ``uniform_z``)
  equal JAX's.
* What a mesh refuses: ``data_parallel_mesh`` asked for more cards than
  there are; ``initialize_multihost`` with coordinates but no coordinator,
  or with no device and no card (a rank is on the CPU only when asked);
  the wrong kind of mesh for a trainer or a paint.
"""
import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from baryon_painter_tpu_torch.data import device_cache as tcache
from baryon_painter_tpu_torch.models.layers import BatchNorm
from baryon_painter_tpu_torch.ops.conv_bn import conv_bn_relu
from baryon_painter_tpu_torch.parallel import mesh as tmesh
from torch_mesh_workers import Layout, run_ranks

BN_TOL = 1e-6


@pytest.mark.parametrize("world", [2, 3])
def test_collectives(tmp_path, world):
    res = run_ranks("collectives", world, tmp_path, {})
    base = np.arange(3.0)
    for r, out in enumerate(res):
        assert (out["rank"], out["size"]) == (r, world)
        np.testing.assert_array_equal(
            out["sum"], world * base + sum(range(world)))
        np.testing.assert_array_equal(out["min"], base)
        np.testing.assert_array_equal(out["max"], base + world - 1)
        np.testing.assert_array_equal(out["broadcast"], [0.0, 0.0])
        # d/dt_r of sum_r' <w, sum_r t_r> = world * w
        np.testing.assert_array_equal(out["sum_grad"],
                                      world * np.array([1.0, 2.0, 3.0]))
        total = sum(range(world))
        np.testing.assert_array_equal(out["flat"][0], [total] * 2)
        np.testing.assert_array_equal(out["flat"][1], [2 * total] * 3)


def _bn_inputs(n=8, c=3, h=5, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"x": f(n, c, h, h) * 2 + 1, "dy": f(n, c, h, h),
            "weight": f(c) + 1.5, "bias": f(c)}


def _bn_reference(a):
    bn = BatchNorm(a["x"].shape[1]).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(a["weight"]))
        bn.bias.copy_(torch.from_numpy(a["bias"]))
    x = torch.from_numpy(a["x"]).requires_grad_()
    y = bn(x)
    (y * torch.from_numpy(a["dy"])).sum().backward()
    return {"y": y.detach().numpy(), "dx": x.grad.numpy(),
            "dweight": bn.weight.grad.numpy(),
            "dbias": bn.bias.grad.numpy(),
            "running_mean": bn.running_mean.numpy(),
            "running_var": bn.running_var.numpy()}


@pytest.mark.parametrize("world", [2, 4])
def test_sync_batchnorm_equals_the_concatenated_batch(tmp_path, world):
    a = _bn_inputs()
    want = _bn_reference(a)
    res = run_ranks("batchnorm", world, tmp_path, a)
    for key in ("y", "dx"):
        got = np.concatenate([r[key] for r in res])
        np.testing.assert_allclose(got, want[key], rtol=BN_TOL,
                                   atol=BN_TOL * np.abs(want[key]).max())
    for r in res:
        for key in ("dweight", "dbias", "running_mean", "running_var"):
            np.testing.assert_allclose(r[key], want[key], rtol=BN_TOL,
                                       atol=BN_TOL, err_msg=key)
        # the running statistics are the same on every rank
        np.testing.assert_array_equal(r["running_mean"],
                                      res[0]["running_mean"])


def test_sync_batchnorm_on_one_rank_is_the_plain_module(tmp_path):
    (res,) = run_ranks("batchnorm", 1, tmp_path, _bn_inputs(seed=1))
    for key, want in res["plain"].items():
        np.testing.assert_array_equal(res[key], want, err_msg=key)


K4_CASES = {
    "same_conv": dict(transposed=False, stride=1, padding=2, k=5, cin=3,
                      cout=4, h=8),
    "up_conv": dict(transposed=True, stride=2, padding=1, k=4, cin=4,
                    cout=3, h=4),
}


def _k4_inputs(case, n=4, seed=0):
    c = K4_CASES[case]
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    wshape = ((c["cin"], c["cout"]) if c["transposed"]
              else (c["cout"], c["cin"])) + (c["k"], c["k"])
    kw = dict(transposed=c["transposed"], stride=c["stride"],
              padding=c["padding"])
    x = f(n, c["cin"], c["h"], c["h"])
    w = f(*wshape) * 0.3
    ho = c["h"] * c["stride"] if c["transposed"] else c["h"]
    return {"x": x, "w": w, "gamma": f(c["cout"]) + 1.0,
            "beta": f(c["cout"]), "dy": f(n, c["cout"], ho, ho), "kw": kw}


@pytest.mark.parametrize("case", list(K4_CASES))
def test_k4_sums_across_ranks_equal_the_concatenated_batch(tmp_path, case):
    a = _k4_inputs(case)
    x = torch.from_numpy(a["x"]).requires_grad_()
    w, g, b = (torch.from_numpy(a[k]).requires_grad_()
               for k in ("w", "gamma", "beta"))
    y, mean, var = conv_bn_relu(x, w, g, b, **a["kw"])
    (y * torch.from_numpy(a["dy"])).sum().backward()
    want = {"y": y.detach().numpy(), "mean": mean.numpy(),
            "var": var.numpy(), "dx": x.grad.numpy(), "dw": w.grad.numpy(),
            "dgamma": g.grad.numpy(), "dbeta": b.grad.numpy()}
    res = run_ranks("k4", 2, tmp_path, a)
    got = {k: (np.concatenate([r[k] for r in res]) if k in ("y", "dx")
               else res[0][k]) for k in want}
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5,
                                   atol=1e-5 * np.abs(v).max(), err_msg=k)
    for k in ("mean", "var", "dw", "dgamma", "dbeta"):
        np.testing.assert_array_equal(res[1][k], res[0][k])


# --------------------------------------------------------------------- #
# the z-sharded cache's layout against the JAX package's

@pytest.mark.parametrize("n_dev", range(1, 9))
def test_slot_assignment_matches_jax(n_dev):
    from baryon_painter_tpu.data.device_cache import \
        _slot_assignment as jax_slots
    for n_z in range(1, 12):
        assert tcache._slot_assignment(n_z, n_dev) == jax_slots(n_z, n_dev)


@pytest.fixture(scope="module")
def three_z(tmp_path_factory):
    """Synthetic stacks at three redshifts, in both packages."""
    from baryon_painter_tpu.data.dataset import \
        BahamasTileDataset as JaxDataset
    from baryon_painter_tpu.data.dataset import load_file_info
    from baryon_painter_tpu.transforms import RangeCompress as JaxRC
    from baryon_painter_tpu_torch.data.synthetic import make_synthetic_stacks
    from torch_mesh_workers import make_dataset
    root = str(tmp_path_factory.mktemp("stacks3"))
    info = make_synthetic_stacks(root, n_stack=2, n_grid=64,
                                 redshifts=(0.0, 0.5, 1.0), seed=0)
    jd = JaxDataset(files=load_file_info(info), root_path=root, n_tile=2,
                    tile_permutations=True,
                    transforms={"dm": JaxRC("shift-log", 4.0),
                                "pressure": JaxRC("shift-log", 4.0)})
    return jd, make_dataset(root, info)


def _jax_cache(jd, n_dev):
    import jax
    from jax.sharding import Mesh
    from baryon_painter_tpu.data.device_cache import DeviceStackCache
    mesh = Mesh(np.array(jax.devices()[:n_dev]), axis_names=("data",))
    return DeviceStackCache(jd, mesh=mesh)


@pytest.mark.parametrize("n_dev", [2, 3, 4, 8])
def test_mesh_draw_and_weights_match_jax(three_z, n_dev):
    jd, td = three_z
    jc = _jax_cache(jd, n_dev)
    batch = 2 * n_dev
    want = jc.sample_mesh_indices(np.random.default_rng(5), batch)
    got = tcache.sample_mesh_indices(td, n_dev, np.random.default_rng(5),
                                     batch)
    np.testing.assert_array_equal(got, want)
    for rank in range(n_dev):
        tc = tcache.DeviceStackCache(td, mesh=Layout(n_dev, rank))
        np.testing.assert_array_equal(tc.z_slot_weights, jc.z_slot_weights)
        assert tc.uniform_z == jc.uniform_z
        assert tc.sample_mesh_indices(np.random.default_rng(5),
                                      batch).tolist() == want.tolist()
        np.testing.assert_array_equal(tc.digits(want),
                                      np.asarray(jc.digits(want)))
        # this rank holds only its slab of redshifts
        assert tc.data100.shape[1] == jc._slab
        assert tcache.DeviceStackCache.nbytes(td, n_dev) == \
            jc.nbytes(jd, n_dev)
    # 3 redshifts over 2 or 4 ranks are not sampled uniformly
    assert jc.uniform_z == (3 % n_dev == 0 or n_dev % 3 == 0)


def test_z_sharded_gather_equals_the_whole_cache(three_z):
    """Each rank's rows gathered from its own slab equal the one-device
    cache's gather of the same rows."""
    _, td = three_z
    whole = tcache.DeviceStackCache(td, device="cpu")
    idx = tcache.sample_mesh_indices(td, 2, np.random.default_rng(3), 8)
    digits_whole = whole.digits(idx)
    for rank in range(2):
        tc = tcache.DeviceStackCache(td, mesh=Layout(2, rank))
        got = tc.gather(tc.local_digits(tc.digits(idx)))
        want = whole.gather(digits_whole[4 * rank:4 * (rank + 1)])
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
    with pytest.raises(ValueError, match="sample_mesh_indices"):
        tc.digits(td.sample_indices(np.random.default_rng(0), 64))


# --------------------------------------------------------------------- #
# what a mesh refuses

def test_data_parallel_mesh_never_reuses_a_card():
    n = torch.cuda.device_count()
    with pytest.raises(RuntimeError, match=f"needs {n + 1} CUDA devices"):
        tmesh.data_parallel_mesh(n + 1)
    mesh = tmesh.data_parallel_mesh(devices=["cpu"] * 3)
    assert mesh.size == 3 and mesh.distinct == [torch.device("cpu")]
    assert mesh.split(7) == [(0, 3), (3, 5), (5, 7)]
    with pytest.raises(ValueError):
        tmesh.data_parallel_mesh(4, devices=["cpu"] * 3)


def test_initialize_multihost_refuses_half_coordinates(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    assert tmesh.initialize_multihost("gloo") is None
    with pytest.raises(ValueError, match="coordinator"):
        tmesh.initialize_multihost("gloo", num_processes=2, process_id=0)
    with pytest.raises(ValueError, match="num_processes"):
        tmesh.initialize_multihost("gloo", "localhost:1")
    with pytest.raises(RuntimeError, match="initialised"):
        tmesh.ProcessMesh("gloo", "cpu")


def test_initialize_multihost_defaults_to_the_card(monkeypatch, tmp_path):
    """With no device a rank computes on ``cuda:LOCAL_RANK`` whatever the
    backend; without a card that raises before the rank joins a group,
    and the CPU is taken only when the caller names it."""
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tmesh._default_device() == torch.device("cuda", 1)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tmesh.initialize_multihost("gloo", f"file://{tmp_path / 'a'}", 1, 0)
    assert not dist.is_initialized()
    mesh = tmesh.initialize_multihost("gloo", f"file://{tmp_path / 'b'}", 1,
                                      0, device="cpu")
    try:
        assert mesh.device == torch.device("cpu") and mesh.backend == "gloo"
    finally:
        dist.destroy_process_group()


@pytest.mark.cuda
def test_a_gloo_mesh_without_a_device_is_on_the_card(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the default device is the card")
    mesh = tmesh.initialize_multihost("gloo", f"file://{tmp_path / 'rdv'}",
                                      1, 0)
    try:
        want = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        assert mesh.device == want
        assert mesh.all_reduce(torch.ones(3, device=want)).device == want
    finally:
        dist.destroy_process_group()


def test_wrong_kind_of_mesh_raises(three_z):
    from baryon_painter_tpu_torch.models.cvae import CVAE
    from baryon_painter_tpu_torch.train.trainer import CVAETrainer
    from torch_mesh_workers import cvae_arch
    _, td = three_z
    with pytest.raises(TypeError, match="ProcessMesh"):
        CVAETrainer(CVAE(cvae_arch()), td, device="cpu",
                    mesh=tmesh.DeviceMesh(["cpu", "cpu"]))
    with pytest.raises(TypeError, match="ProcessMesh"):
        tcache.DeviceStackCache(td, mesh=tmesh.DeviceMesh(["cpu"]))
