"""The port's training data layer against the JAX package: the synthetic
stacks, the tile dataset's sampling and batch assembly, the dihedral
transform, K2's plain version and the device stack cache.

Everything here is data movement or the same numpy code on the same seeds,
so every comparison is exact (bit for bit). The JAX side runs on the CPU as
its own tests run it: K2 in interpret mode (``gather_tiles_pallas(...,
interpret=True)``). The CUDA kernel itself is held against the plain version
on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import dataclasses
import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baryon_painter_tpu.data import dataset as jds
from baryon_painter_tpu.data.device_cache import \
    DeviceStackCache as JaxDeviceStackCache
from baryon_painter_tpu.data.indexing import dihedral_transform
from baryon_painter_tpu.data.synthetic import \
    make_synthetic_stacks as jax_make_synthetic_stacks
from baryon_painter_tpu.ops.pallas_gather import \
    dihedral_batch as jax_dihedral_batch
from baryon_painter_tpu.ops.pallas_gather import gather_tiles_pallas
from baryon_painter_tpu.transforms import RangeCompress as JaxRC
from baryon_painter_tpu_torch.data import dataset as tds
from baryon_painter_tpu_torch.data.device_cache import DeviceStackCache
from baryon_painter_tpu_torch.data.synthetic import make_synthetic_stacks
from baryon_painter_tpu_torch.ops import gather as k2
from baryon_painter_tpu_torch.transforms import RangeCompress


def _digest(root):
    h = hashlib.sha256()
    for fn in sorted(os.listdir(root)):
        h.update(fn.encode())
        with open(os.path.join(root, fn), "rb") as f:
            h.update(f.read())
    return h.hexdigest()


@pytest.mark.parametrize("kwargs", [
    dict(n_stack=2, n_grid=64, redshifts=(0.0, 0.5, 1.0), seed=7),
    dict(n_stack=2, n_grid=32, redshifts=(0.0, 1.0), seed=0,
         spectrum="powerlaw", pressure_noise_corr=2.0)],
    ids=["default", "powerlaw"])
def test_synthetic_stacks_are_byte_identical(tmp_path, kwargs):
    """The copy writes the same files, byte for byte (the default fixture is
    hash-pinned by tests/test_synthetic_physical.py)."""
    jax_make_synthetic_stacks(str(tmp_path / "jax"), **kwargs)
    make_synthetic_stacks(str(tmp_path / "port"), **kwargs)
    assert sorted(os.listdir(tmp_path / "jax")) == sorted(
        os.listdir(tmp_path / "port"))
    assert _digest(tmp_path / "jax") == _digest(tmp_path / "port")


def test_default_fixture_matches_the_pinned_hash(tmp_path):
    root = tmp_path / "default"
    make_synthetic_stacks(str(root), n_stack=2, n_grid=64,
                          redshifts=(0.0, 0.5, 1.0), seed=7)
    h = hashlib.sha256()
    for fn in sorted(os.listdir(root)):
        if fn.endswith(".npy"):
            h.update(fn.encode())
            h.update(np.load(root / fn).tobytes())
    assert h.hexdigest() == ("7b48b0af6a20bbc9b80951aed79ba731"
                             "c0c4db450bfb3b21aca955a3012e8399")


@pytest.fixture(scope="module")
def stacks(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stacks"))
    info = make_synthetic_stacks(root, n_stack=3, n_grid=64,
                                 redshifts=(0.0, 0.5))
    return root, info


def _datasets(stacks, **kw):
    root, info = stacks
    j = jds.BahamasTileDataset(
        files=jds.load_file_info(info), root_path=root,
        transforms={"dm": JaxRC("shift-log", 4.0),
                    "pressure": JaxRC("shift-log", 4.0)}, **kw)
    t = tds.BahamasTileDataset(
        files=tds.load_file_info(info), root_path=root,
        transforms={"dm": RangeCompress("shift-log", 4.0),
                    "pressure": RangeCompress("shift-log", 4.0)}, **kw)
    return j, t


DATASET_CASES = [
    dict(n_tile=2, tile_permutations=True),
    dict(n_tile=4, tile_permutations=False, subtract_minimum=True),
    dict(n_tile=2, tile_permutations=True, n_stack=2, stack_offset=1,
         scale_to_SLICS=False),
]


@pytest.mark.parametrize("kw", DATASET_CASES, ids=["perm", "submin",
                                                   "offset"])
def test_dataset_sampling_and_raw_batches_are_identical(stacks, kw):
    jd, td = _datasets(stacks, **kw)
    assert (len(td), td.n_sample, td.tile_size, td.tile_L) == (
        len(jd), jd.n_sample, jd.tile_size, jd.tile_L)
    assert dataclasses.astuple(td.scheme) == dataclasses.astuple(jd.scheme)
    for field in td.fields:
        for a, b in ((td.stats[field].z_grid, jd.stats[field].z_grid),
                     (td.stats[field].mean, jd.stats[field].mean),
                     (td.stats[field].var, jd.stats[field].var)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rj, rt = np.random.default_rng(3), np.random.default_rng(3)
    for size, z in ((5, None), (300, None), (4, 0.5)):
        ij = jd.sample_indices(rj, size, z=z)
        it = td.sample_indices(rt, size, z=z)
        np.testing.assert_array_equal(it, ij)
    bj, bt = jd.get_raw_batch(ij), td.get_raw_batch(it)
    assert bt.keys() == bj.keys()
    for key in bt:
        np.testing.assert_array_equal(bt[key], bj[key])


def test_dataset_rejects_stacks_beyond_the_files(stacks):
    with pytest.raises(ValueError, match="Highest stack"):
        _datasets(stacks, n_stack=3, stack_offset=1)


def test_slics_scale_factor_is_the_same():
    for g in (64, 1024):
        assert tds.slics_scale_factor(g) == jds.slics_scale_factor(g)


def test_dihedral_batch_matches_jax_and_numpy_for_all_eight_perms():
    rng = np.random.default_rng(0)
    tiles = rng.standard_normal((8, 2, 6, 6)).astype(np.float32)
    perms = np.arange(8)
    got = k2.dihedral_batch(torch.from_numpy(tiles),
                            torch.from_numpy(perms)).numpy()
    want = np.asarray(jax_dihedral_batch(jnp.asarray(tiles),
                                         jnp.asarray(perms)))
    np.testing.assert_array_equal(got, want)
    for p in range(8):
        np.testing.assert_array_equal(got[p],
                                      dihedral_transform(tiles[p], p))


@pytest.fixture(scope="module")
def caches(stacks):
    jd, td = _datasets(stacks, n_tile=2, tile_permutations=True)
    return jd, td, JaxDeviceStackCache(jd), DeviceStackCache(td,
                                                             device="cpu")


def test_k2_plain_version_matches_the_pallas_kernel(caches):
    jd, _, jcache, tcache = caches
    idx = jd.sample_indices(np.random.default_rng(1), 6)
    digits = tcache.digits(idx)
    np.testing.assert_array_equal(digits, jcache.digits(idx))
    want = np.asarray(gather_tiles_pallas(
        jcache.data100, jcache.data150, jnp.asarray(digits),
        jcache.tile_size, interpret=True))
    before = k2.gather_tiles.launches
    got = k2.gather_tiles(tcache.data100, tcache.data150, digits,
                          tcache.tile_size)
    assert k2.gather_tiles.launches == before   # the CPU launches nothing
    assert got.shape == (6, 2, 2, 32, 32)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        k2.gather_tiles_ref(tcache.data100, tcache.data150,
                            torch.from_numpy(digits), 32).numpy(), want)


@pytest.mark.parametrize("kw", DATASET_CASES, ids=["perm", "submin",
                                                   "offset"])
def test_device_cache_gather_matches_jax_and_the_host_batch(stacks, kw):
    jd, td = _datasets(stacks, **kw)
    jcache = JaxDeviceStackCache(jd, use_pallas=False)
    for use_kernel in ("auto", False):
        tcache = DeviceStackCache(td, device="cpu", use_kernel=use_kernel)
        idx = jd.sample_indices(np.random.default_rng(2), 7)
        digits = tcache.digits(idx)
        got = [t.numpy() for t in tcache.gather(digits)]
        want = [np.asarray(a) for a in jcache.gather(jnp.asarray(digits))]
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
        host = td.get_raw_batch(idx)
        np.testing.assert_array_equal(got[1], host["labels"])
        np.testing.assert_array_equal(got[2], host["z"])


def test_device_cache_size_and_budget(caches):
    _, td, jcache, _ = caches
    assert DeviceStackCache.nbytes(td) == JaxDeviceStackCache.nbytes(
        caches[0]) == 2 * 2 * 6 * 64 * 64 * 4
    assert DeviceStackCache.fits(td, budget_bytes=10 ** 6)
    assert not DeviceStackCache.fits(td, budget_bytes=10 ** 5)
    with pytest.warns(UserWarning, match="host batch path"):
        assert DeviceStackCache.create_if_fits(td, budget_bytes=10 ** 5,
                                               device="cpu") is None
    assert isinstance(DeviceStackCache.create_if_fits(td, device="cpu"),
                      DeviceStackCache)
    with pytest.raises(ValueError, match="use_kernel"):
        DeviceStackCache(td, device="cpu", use_kernel="yes")


def test_digit_range_is_checked(caches):
    _, td, _, tcache = caches
    good = tcache.digits(np.arange(3))
    args = (tcache.data100, tcache.data150)
    for col, name, value in ((0, "z", 2), (4, "tx100", 2), (8, "ty150", -1),
                             (3, "s100", 3), (6, "s150", 5), (1, "p100", 8)):
        bad = good.copy()
        bad[1, col] = value
        for fn in (k2.gather_tiles, k2.gather_tiles_ref):
            with pytest.raises(IndexError, match=name):
                fn(*args, bad, 32)
    with pytest.raises(ValueError, match=r"\(B, 9\)"):
        k2.gather_tiles(*args, good[:, :8], 32)
    with pytest.raises(TypeError, match="integers"):
        k2.gather_tiles(*args, good.astype(np.float32), 32)
    with pytest.raises(ValueError, match="does not fit"):
        k2.gather_tiles(*args, good, 128)


def test_cache_defaults_to_cuda_and_raises_without_it(caches):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceStackCache(caches[1])
