"""The port's 2-D power spectrum and angular power
(baryon_painter_tpu_torch/power_spectrum.py, angular_power.py) against the
JAX package's, on the same f32 fields.

Both compute the FFT and the binned sums in f32, in another summation order
(the port sums each bin as one reduction, JAX scatter-adds): every output
within rtol 1e-5, atol 1e-5 * max|JAX| (the variance's cancellation to its
clamp at 0 included). The bin assignment (host side, with the edges' 1e-9
relative hardening and the closed last bin) is equal, so n_mode is equal
bit for bit and the fundamental-mode bin is not empty.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baryon_painter_tpu.angular_power import (
    cl_fractional_error as jax_cl_error, pseudo_cl_2d as jax_cl)
from baryon_painter_tpu.power_spectrum import pseudo_pofk_2d as jax_pofk
from baryon_painter_tpu_torch.angular_power import (cl_fractional_error,
                                                    pseudo_cl_2d)
from baryon_painter_tpu_torch.power_spectrum import k_grid, pseudo_pofk_2d

TOL = 1e-5


def _close(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * max(np.abs(want).max(), 1e-30))


@pytest.mark.parametrize("cross", [False, True], ids=["auto", "cross"])
@pytest.mark.parametrize("logspaced", [True, False], ids=["log", "linear"])
@pytest.mark.parametrize("shape", [(64, 64), (3, 32, 32), (129, 129)],
                         ids=["64", "batch3x32", "129"])
def test_pofk_matches_jax(rng, shape, logspaced, cross):
    a = rng.standard_normal(shape).astype(np.float32)
    b = rng.standard_normal(shape).astype(np.float32) if cross else None
    kw = dict(L=50.0, n_k_bin=10, logspaced_k_bins=logspaced)
    want = jax_pofk(jnp.asarray(a), None if b is None else jnp.asarray(b),
                    **kw)
    got = pseudo_pofk_2d(torch.as_tensor(a),
                         None if b is None else torch.as_tensor(b), **kw)
    for g, w in zip(got, want):
        _close(g, w)
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


@pytest.mark.parametrize("logspaced", [True, False], ids=["log", "linear"])
def test_fundamental_mode_bin_is_not_empty(logspaced):
    """With the default k_min = 2*pi/L the four fundamental modes sit on
    edges[0] up to an ulp; the hardened edges keep them in the first bin,
    and the exact-Nyquist modes in the closed last bin."""
    n, L = 64, 100.0
    x = torch.zeros((n, n))
    _, k, _, n_mode = pseudo_pofk_2d(x, L=L, n_k_bin=8,
                                     logspaced_k_bins=logspaced)
    assert n_mode[0] >= 4
    kk = k_grid(n, L).ravel()
    in_range = (kk > 0) & (kk <= 2 * np.pi / L * (n / 2) * (1 + 1e-9))
    assert int(n_mode.sum()) == int(in_range.sum())
    assert float(k[0]) >= 2 * np.pi / L * (1 - 1e-6)


def test_white_noise_is_flat(rng):
    n, L, sigma = 128, 100.0, 2.0
    x = torch.as_tensor((rng.standard_normal((n, n)) * sigma)
                        .astype(np.float32))
    pk, _, _, n_mode = pseudo_pofk_2d(x, L=L, n_k_bin=12)
    expected = sigma ** 2 * (L / n) ** 2
    err = expected * np.sqrt(2.0 / np.maximum(n_mode.numpy(), 1))
    assert np.all(np.abs(pk.numpy() - expected) < 5 * err)


def test_cross_of_identical_fields_equals_auto(rng):
    x = torch.as_tensor(rng.standard_normal((64, 64)).astype(np.float32))
    auto = pseudo_pofk_2d(x, L=50.0)
    cross = pseudo_pofk_2d(x, x.clone(), L=50.0)
    for a, c in zip(auto, cross):
        np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-6)


def test_shape_validation_and_device(rng):
    with pytest.raises(ValueError, match="match"):
        pseudo_pofk_2d(torch.zeros(8, 8), torch.zeros(9, 9))
    with pytest.raises(ValueError, match="square"):
        pseudo_pofk_2d(torch.zeros(8, 9))
    out = pseudo_pofk_2d(np.zeros((8, 8), np.float32), device="cpu")
    assert all(o.device.type == "cpu" for o in out)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            pseudo_pofk_2d(np.zeros((8, 8), np.float32))


@pytest.mark.parametrize("cross", [False, True], ids=["auto", "cross"])
def test_pseudo_cl_matches_jax(rng, cross):
    a = rng.standard_normal((96, 96)).astype(np.float32)
    b = rng.standard_normal((96, 96)).astype(np.float32) if cross else None
    want = jax_cl(jnp.asarray(a), None if b is None else jnp.asarray(b),
                  theta_deg=10.0)
    got = pseudo_cl_2d(torch.as_tensor(a),
                       None if b is None else torch.as_tensor(b),
                       theta_deg=10.0)
    for g, w in zip(got, want):
        _close(g, w)
    theta = np.deg2rad(10.0)
    for g, w in zip(pseudo_cl_2d(torch.as_tensor(a), theta=theta), want
                    if not cross else jax_cl(jnp.asarray(a), theta=theta)):
        _close(g, w)
    with pytest.raises(ValueError, match="exactly one"):
        pseudo_cl_2d(torch.as_tensor(a))


@pytest.mark.parametrize("cross", [False, True], ids=["auto", "cross"])
def test_cl_fractional_error_matches_jax(rng, cross):
    """The y-map gate metric: NaN where a bin has no modes, else
    |Cl_pred / Cl_truth - 1| (of cross-spectra with ``cross_with``)."""
    truth = rng.standard_normal((64, 64)).astype(np.float32)
    pred = truth + 0.05 * rng.standard_normal((64, 64)).astype(np.float32)
    other = rng.standard_normal((64, 64)).astype(np.float32)
    kw = dict(theta_deg=10.0, n_l_bin=12,
              cross_with=other if cross else None)
    want, l_want = jax_cl_error(pred, truth, **kw)
    got, l_got = cl_fractional_error(torch.as_tensor(pred),
                                     torch.as_tensor(truth), **kw)
    assert isinstance(got, np.ndarray)
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    finite = ~np.isnan(want)
    # a ratio of two spectra each within TOL: 2 * TOL of the ratio
    np.testing.assert_allclose(got[finite] + 1, want[finite] + 1,
                               rtol=2 * TOL)
    _close(l_got, l_want)
