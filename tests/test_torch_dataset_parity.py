"""The dataset's reference-parity surface in the port against the JAX
package's (JAX ``data/dataset.py:170-319``).

Both datasets read the same synthetic stacks with the same transforms
(shift-log k=4, and the physical recipe's log-tanh); ``get_batch``,
``__getitem__``, the single samples and stacks, ``sample_idx_to_redshift``
and the transform callables give the JAX package's arrays for the same
``idx`` (rtol 1e-6: the transforms' f32 arithmetic in another library);
``BatchLoader(raw=False)`` yields ``get_batch`` for the index draws of
``raw=True``.
"""
import numpy as np
import pytest
import torch

from baryon_painter_tpu.data.dataset import BahamasTileDataset as JaxDataset
from baryon_painter_tpu.data.dataset import load_file_info
from baryon_painter_tpu.data.synthetic import make_synthetic_stacks
from baryon_painter_tpu.transforms import RangeCompress as JaxRC
from baryon_painter_tpu_torch.data.dataset import (BahamasTileDataset,
                                                   BatchLoader)
from baryon_painter_tpu_torch.transforms import RangeCompress

RTOL = 1e-6
MODES = {"shift-log": {f: "shift-log" for f in ("dm", "pressure")},
         "log-tanh": {"dm": "shift-log", "pressure": "log-tanh"}}
IDX = np.array([0, 5, 17, 40, 123, 200])


@pytest.fixture(scope="module", params=list(MODES))
def pair(request, tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stacks"))
    info = make_synthetic_stacks(root, n_stack=2, n_grid=64,
                                 redshifts=(0.0, 0.5, 1.0), seed=0,
                                 name="t")
    modes = MODES[request.param]
    common = dict(files=load_file_info(info), root_path=root, n_tile=2,
                  tile_permutations=True)
    jd = JaxDataset(transforms={f: JaxRC(m, 4.0, eps=1e-4)
                                for f, m in modes.items()}, **common)
    td = BahamasTileDataset(transforms={f: RangeCompress(m, 4.0, eps=1e-4)
                                        for f, m in modes.items()}, **common)
    return jd, td


def _close(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


@pytest.mark.parametrize("transform", [True, False])
def test_get_batch(pair, transform):
    jd, td = pair
    want = jd.get_batch(idx=IDX, transform=transform)
    got = td.get_batch(idx=IDX, transform=transform)
    _close(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(got[2], want[2])
    rng_j, rng_t = np.random.default_rng(3), np.random.default_rng(3)
    _close(td.get_batch(size=4, z=0.5, rng=rng_t)[0],
           jd.get_batch(size=4, z=0.5, rng=rng_j)[0])


@pytest.mark.parametrize("idx", [0, 77, 250])
def test_samples_and_stacks(pair, idx):
    jd, td = pair
    got, want = td[idx], jd[idx]
    assert got[1:] == want[1:]
    for g, w in zip(got[0], want[0]):
        _close(g, w)
    _close(td.get_input_sample(idx, transform=False),
           jd.get_input_sample(idx, transform=False))
    for g, w in zip(td.get_label_sample(idx, transform=False),
                    jd.get_label_sample(idx, transform=False)):
        _close(g, w)
    z = jd.sample_idx_to_redshift(idx)
    assert td.sample_idx_to_redshift(idx) == z
    _close(td.get_stack("pressure", z, idx), jd.get_stack("pressure", z, idx))
    np.testing.assert_array_equal(td.sample_idx_to_redshift(IDX),
                                  jd.sample_idx_to_redshift(IDX))


@pytest.mark.parametrize("inverse", [False, True])
def test_transform_callables(pair, inverse):
    """The callables of ``get_transforms`` / ``get_inverse_transforms``
    (by ``idx`` and by ``z``) and ``create_*`` on the same tile; the port's
    take tensors and return them on the tensor's device."""
    jd, td = pair
    raw = jd.get_raw_batch(IDX[:2])
    tiles = [raw["input"][1], raw["labels"][0][1]]
    idx = int(IDX[1])
    z = jd.sample_idx_to_redshift(idx)
    if inverse:
        tiles = [np.asarray(jd.transform(t, f, z))
                 for t, f in zip(tiles, jd.fields)]
    get = "get_inverse_transforms" if inverse else "get_transforms"
    for kw in ({"idx": idx}, {"z": z}):
        jfns, tfns = getattr(jd, get)(**kw), getattr(td, get)(**kw)
        assert len(tfns) == len(jfns) == 2
        for t, jf, tf in zip(tiles, jfns, tfns):
            got = tf(torch.from_numpy(np.array(t)))
            assert torch.is_tensor(got)
            _close(got.numpy(), jf(t))
    create = ("create_inverse_transform" if inverse
              else "create_transform")
    fn = getattr(td, create)("pressure", z)
    _close(fn(torch.from_numpy(np.array(tiles[1]))).numpy(),
           getattr(jd, create)("pressure", z)(tiles[1]))
    with pytest.raises(ValueError):
        getattr(td, get)()


def test_batch_loader_transformed(pair):
    """``raw=False`` yields ``get_batch(idx=...)`` for the index draws of
    ``raw=True`` (the same seed)."""
    _, td = pair
    loaders = {raw: BatchLoader(td, 3, seed=9, raw=raw)
               for raw in (True, False)}
    try:
        for _ in range(3):
            raw_b, batch = next(loaders[True]), next(loaders[False])
            want = td.get_batch(idx=raw_b["idx"])
            for g, w in zip(batch, want):
                np.testing.assert_array_equal(g, w)
    finally:
        for loader in loaders.values():
            loader.close()
