"""The port's field transforms against the JAX package's.

Same inputs (numpy, seeded) through baryon_painter_tpu.transforms and
baryon_painter_tpu_torch.transforms: all six range-compression modes forward
and inverse, on lognormal fields (the physical case) and on fields with
negative values (the shift-log NaN floor), and the redshift interpolation of
the statistics inside, at and outside the grid. Tolerance rtol 1e-5 /
atol 1e-6: float32 elementwise math whose only difference is the libm of
each framework (a few ulp).
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
    with pytest.raises(NotImplementedError):
        ttf.transform_from_dict({"type": "split_scale", "n_scale": 3,
                                 "step_size": 4, "include_original": True})
    with pytest.raises(ValueError):
        ttf.transform_from_dict({"type": "nope"})
    with pytest.raises(ValueError):
        ttf.RangeCompress("nope", 1.0)
