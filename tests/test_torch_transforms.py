"""The port's field transforms against the JAX package's.

Same inputs (numpy, seeded) through baryon_painter_tpu.transforms and
baryon_painter_tpu_torch.transforms: all six range-compression modes forward
and inverse, on lognormal fields (the physical case) and on fields with
negative values (the shift-log NaN floor), and the redshift interpolation of
the statistics inside, at and outside the grid. Tolerance rtol 1e-5 /
atol 1e-6: float32 elementwise math whose only difference is the libm of
each framework (a few ulp). The Gaussian blur, the split-scale pyramid and
the chain (forward, inverse, the dict round trip, the JAX package's
``tests/test_multiscale.py`` configuration and a blur wider than the tile)
to rtol 1e-5 / atol 1e-6 of the field's scale: f32 sums of up to 49 taps
in another order.
"""
import dataclasses
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baryon_painter_tpu import transforms as jtf
from baryon_painter_tpu_torch import transforms as ttf

Z_GRID = [0.0, 0.125, 0.25, 0.5, 1.0, 2.0]
STATS = {"z_grid": Z_GRID,
         "mean": [0.6, 0.7, 0.75, 0.9, 1.2, 1.8],
         "var": [0.36, 0.46, 0.58, 0.81, 1.48, 3.43]}
ZS = np.array([0.0, 0.3, 1.7, 2.5, -0.2], np.float32)

MODES = [
    {"mode": "log", "k": 4.0, "eps": 1e-4},
    {"mode": "shift-log", "k": 4.0, "eps": 1e-4},
    {"mode": "shift-log-2p", "k": [0.5, 3.0], "eps": 1e-3},
    {"mode": "log-tanh", "k": 4.0, "eps": 1e-4},
    {"mode": "x/(1+x)", "k": [2.0, 1.0], "eps": 1e-3},
    {"mode": "1/x", "k": 4.0, "eps": 1e-3},
]


def _pair(spec):
    d = {"type": "range_compress", "sqrt_of_mean": False, **spec}
    return jtf.transform_from_dict(d), ttf.transform_from_dict(d)


def _stats():
    return (jtf.FieldStats.from_dict(STATS),
            ttf.FieldStats.from_dict(STATS, device="cpu"))


def _lognormal(seed=0, shape=(5, 16, 16)):
    rng = np.random.default_rng(seed)
    return np.exp(rng.standard_normal(shape) - 0.5).astype(np.float32)


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("spec", MODES, ids=[m["mode"] for m in MODES])
def test_range_compress_forward_and_inverse(spec):
    jt, tt = _pair(spec)
    js, ts = _stats()
    x = _lognormal()
    fwd = tt.forward(torch.from_numpy(x), ts, torch.from_numpy(ZS))
    _close(fwd.numpy(), np.asarray(jt.forward(jnp.asarray(x), js, ZS)))
    inv = tt.inverse(fwd, ts, torch.from_numpy(ZS))
    _close(inv.numpy(), np.asarray(jt.inverse(jnp.asarray(fwd.numpy()), js,
                                              ZS)))


@pytest.mark.parametrize("spec", MODES, ids=[m["mode"] for m in MODES])
def test_range_compress_on_signed_fields(spec):
    """Negative and zero pixels exercise every mode's floor and cut-off
    branches, and the shift-log NaN floor."""
    jt, tt = _pair(spec)
    js, ts = _stats()
    rng = np.random.default_rng(1)
    x = (2.0 * rng.standard_normal((5, 8, 8))).astype(np.float32)
    x[:, 0, 0] = 0.0
    got = tt.forward(torch.from_numpy(x), ts, torch.from_numpy(ZS)).numpy()
    want = np.asarray(jt.forward(jnp.asarray(x), js, ZS))
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    _close(np.nan_to_num(got), np.nan_to_num(want))


def test_shift_log_floor_is_finite_and_keeps_nan():
    jt, tt = _pair(MODES[1])
    js, ts = _stats()
    x = np.array([[-10.0, -1.0, 0.0, 1.0, np.nan]], np.float32)
    z = np.array([0.5], np.float32)
    got = tt.forward(torch.from_numpy(x), ts, torch.from_numpy(z)).numpy()
    want = np.asarray(jt.forward(jnp.asarray(x), js, z))
    assert np.all(np.isfinite(got[0, :4]))
    assert np.isnan(got[0, 4])
    np.testing.assert_allclose(got[0, 0], math.log(1e-4) / 4.0, rtol=1e-6)
    _close(np.nan_to_num(got), np.nan_to_num(want))


@pytest.mark.parametrize("z", [-1.0, 0.0, 0.1, 0.125, 0.7, 2.0, 3.0])
def test_field_stats_at_z_scalar(z):
    js, ts = _stats()
    tm, tv = ts.at_z(z)
    jm, jv = js.at_z(z)
    _close(tm.numpy(), np.asarray(jm))
    _close(tv.numpy(), np.asarray(jv))


def test_field_stats_at_z_batch_and_clamp():
    js, ts = _stats()
    tm, tv = ts.at_z(torch.from_numpy(ZS))
    jm, jv = js.at_z(ZS)
    _close(tm.numpy(), np.asarray(jm))
    _close(tv.numpy(), np.asarray(jv))
    # clamped ends
    assert tm[3].item() == pytest.approx(STATS["mean"][-1])
    assert tm[4].item() == pytest.approx(STATS["mean"][0])


def test_to_delta_and_identity():
    js, ts = _stats()
    x = _lognormal(2)
    for name in ("to_delta", "identity"):
        jt = jtf.transform_from_dict({"type": name})
        tt = ttf.transform_from_dict({"type": name})
        fwd = tt.forward(torch.from_numpy(x), ts, torch.from_numpy(ZS))
        _close(fwd.numpy(), np.asarray(jt.forward(jnp.asarray(x), js, ZS)))
        _close(tt.inverse(fwd, ts, torch.from_numpy(ZS)).numpy(), x)


def test_transform_from_dict_and_errors():
    for spec in MODES:
        jt, tt = _pair(spec)
        assert dataclasses.asdict(tt) == dataclasses.asdict(jt)
    split = {"type": "split_scale", "n_scale": 3, "step_size": 4,
             "include_original": True, "truncate": 3.0}
    chain = {"type": "chain", "steps": [
        {"type": "range_compress", "mode": "shift-log", "k": 4.0,
         "eps": 1e-4, "sqrt_of_mean": False}, split]}
    for d in (split, chain):
        assert ttf.transform_from_dict(d).to_dict() == d
        assert (ttf.transform_from_dict(d).to_dict()
                == jtf.transform_from_dict(d).to_dict())
    with pytest.raises(ValueError):
        ttf.transform_from_dict({"type": "nope"})
    with pytest.raises(ValueError):
        ttf.RangeCompress("nope", 1.0)


@pytest.mark.parametrize("sigma,size", [(1.0, 16), (2.5, 24), (8.0, 16)],
                         ids=["narrow", "wide", "wider_than_tile"])
def test_gaussian_filter_2d_matches_jax(sigma, size):
    x = _lognormal(3, (2, 3, size, size))
    got = ttf.gaussian_filter_2d(torch.from_numpy(x), sigma)
    want = np.asarray(jtf.gaussian_filter_2d(jnp.asarray(x), sigma))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())


def _multiscale_pair(n_scale, step_size, include_original):
    kw = dict(n_scale=n_scale, step_size=step_size,
              include_original=include_original)
    return jtf.SplitScale(**kw), ttf.SplitScale(**kw)


@pytest.mark.parametrize("kw", [(3, 4, True), (2, 2, False)],
                         ids=["fiducial_pyramid", "multiscale_test"])
def test_split_scale_forward_and_inverse_match_jax(kw):
    jt, tt = _multiscale_pair(*kw)
    x = _lognormal(4, (3, 32, 32))
    fwd = tt.forward(torch.from_numpy(x))
    want = np.asarray(jt.forward(jnp.asarray(x)))
    assert fwd.shape == want.shape == (3, tt.n_out, 32, 32)
    np.testing.assert_allclose(fwd.numpy(), want, rtol=1e-5,
                               atol=1e-6 * np.abs(x).max())
    inv = tt.inverse(fwd)
    np.testing.assert_allclose(inv.numpy(),
                               np.asarray(jt.inverse(jnp.asarray(want))),
                               rtol=1e-5, atol=1e-6 * np.abs(x).max())
    np.testing.assert_allclose(inv.numpy(), x, rtol=1e-5,
                               atol=1e-5 * np.abs(x).max())
    with pytest.raises(ValueError):
        tt.inverse(fwd[:, :1])


def test_chain_of_the_multiscale_test_matches_jax():
    """The JAX package's tests/test_multiscale.py transform: shift-log,
    then a two-band split without the original; forward, inverse (the
    bands summed, then the compression undone, as the painter inverts a
    two-channel output) and a painter round trip on the port's side."""
    js, ts = _stats()
    steps = lambda m: (m.RangeCompress("shift-log", 4.0),
                       m.SplitScale(n_scale=2, step_size=2,
                                    include_original=False))
    jt = jtf.ChainTransform(steps=steps(jtf))
    tt = ttf.ChainTransform(steps=steps(ttf))
    x = _lognormal(5, (5, 32, 32))
    fwd = tt.forward(torch.from_numpy(x), ts, torch.from_numpy(ZS))
    want = np.asarray(jt.forward(jnp.asarray(x), js, ZS))
    assert fwd.shape == want.shape == (5, 2, 32, 32)
    _close(fwd.numpy(), want)
    inv = tt.inverse(fwd, ts, torch.from_numpy(ZS))
    _close(inv.numpy(), np.asarray(jt.inverse(jnp.asarray(want), js, ZS)))
    np.testing.assert_allclose(inv.numpy(), x, rtol=1e-4, atol=1e-5)
    assert jt.to_dict() == tt.to_dict()
    assert ttf.transform_from_dict(tt.to_dict()) == tt


def test_painter_inverts_a_two_channel_split_scale_as_jax(tmp_path):
    """The JAX package's tests/test_multiscale.py model (n_scale 2, its
    chain on both fields) painted by both painters at the prior mean from
    the same initial weights: the two-channel output reassembled and
    decompressed to one tile, rtol 1e-4 (f32 through the whole model)."""
    import jax

    from baryon_painter_tpu.data.dataset import BahamasTileDataset as JD
    from baryon_painter_tpu.data.dataset import load_file_info
    from baryon_painter_tpu.models.cvae import CVAE as JaxCVAE
    from baryon_painter_tpu.models.cvae import fiducial_cvae_architecture
    from baryon_painter_tpu.painter import CVAEPainter as JaxPainter
    from baryon_painter_tpu.train import checkpoint as jckpt
    from baryon_painter_tpu_torch.data.synthetic import make_synthetic_stacks
    from baryon_painter_tpu_torch.painter import CVAEPainter

    info = make_synthetic_stacks(str(tmp_path), n_stack=2, n_grid=64,
                                 redshifts=(0.0, 1.0))
    multi = jtf.ChainTransform(steps=(
        jtf.RangeCompress("shift-log", 4.0),
        jtf.SplitScale(n_scale=2, step_size=2, include_original=False)))
    jd = JD(files=load_file_info(info), root_path=str(tmp_path), n_tile=2,
            transforms={"dm": multi, "pressure": multi})
    arch = fiducial_cvae_architecture(tile_size=32, n_scale=2,
                                      n_res_blocks=1)
    model = JaxCVAE(arch)
    zeros = jnp.zeros((1, 32, 32, 2), jnp.float32)
    variables = jax.jit(model.init)(
        {"params": jax.random.PRNGKey(0), "sample": jax.random.PRNGKey(1)},
        zeros, zeros, jnp.zeros((1,), jnp.float32))
    meta = jckpt.meta_from_dataset(jd, arch)
    batch = jd.get_raw_batch(np.arange(3))
    want = np.asarray(JaxPainter(model=model, variables=variables,
                                 meta=meta).paint_batch(
        batch["input"], batch["z"], z_mode="mean"))
    to_np = lambda t: jax.tree.map(np.asarray, t)
    port = CVAEPainter(variables={"params": to_np(variables["params"]),
                                  "batch_stats": to_np(
                                      variables["batch_stats"])},
                       meta=meta, device="cpu")
    assert isinstance(port.transforms["pressure"], ttf.ChainTransform)
    got = port.paint_batch(batch["input"], batch["z"], z_mode="mean").numpy()
    assert got.shape == want.shape == (3, 32, 32)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())
