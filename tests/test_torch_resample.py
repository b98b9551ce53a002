"""The port's B-spline resampler (baryon_painter_tpu_torch/ops/resample.py)
against scipy.ndimage and against the JAX package's resize_spline.

* Against scipy in f64, over the grid of tests/test_resample.py: orders
  0/1/3/5, modes mirror/reflect/wrap (scipy's grid-wrap), zooms
  0.4/1.0/1.7/2.0, the half-integer nearest case, the FIR prefilter against
  the exact FFT one, batched and anisotropic inputs, with that file's
  tolerances (zoom: rtol 2e-3, atol 2e-4 * max|scipy|; prefilter: 2e-4;
  FIR against FFT: rtol 2e-5, atol 2e-5 * max|FFT|).
* Against JAX's resize_spline (f32 on the CPU) only at the (order, mode)
  pairs the JAX pipeline, the y map and the seamless path use: order 3
  reflect and mirror, order 5 mirror, order 3 wrap. The two compute the same
  f32 operations in another order: rtol 1e-5, atol 1e-5 * max|JAX|.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.ndimage import spline_filter1d, zoom as scipy_zoom

from baryon_painter_tpu.ops.resample import resize_spline as jax_resize
from baryon_painter_tpu_torch.ops.resample import (resize_spline,
                                                   spline_filter_1d, zoom)

ZOOM_RTOL, ZOOM_ATOL = 2e-3, 2e-4
JAX_TOL = 1e-5


def _scipy_mode(mode):
    return (dict(mode="grid-wrap", grid_mode=True) if mode == "wrap"
            else dict(mode=mode))


def _zoom(x, zf, **kw):
    return zoom(torch.as_tensor(x), zf, **kw).numpy()


@pytest.mark.parametrize("order", [0, 1, 3, 5])
@pytest.mark.parametrize("mode", ["mirror", "reflect", "wrap"])
@pytest.mark.parametrize("zf", [0.4, 1.0, 1.7, 2.0])
def test_zoom_matches_scipy(rng, order, mode, zf):
    x = rng.standard_normal((24, 30)).astype(np.float32)
    got = _zoom(x, zf, order=order, mode=mode)
    want = scipy_zoom(x.astype(np.float64), zoom=zf, order=order,
                      **_scipy_mode(mode))
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=ZOOM_RTOL,
                               atol=ZOOM_ATOL * np.abs(want).max())


def test_zoom_nearest_matches_scipy_at_half_integer_coords():
    """order 0 uses scipy's floor(x + 0.5) rule in f64: rounding half to
    even diverges on exact .5 coordinates (5/3 of a 3-pixel edge)."""
    x = np.arange(9, dtype=np.float32).reshape(3, 3)
    got = _zoom(x, 5 / 3, order=0, mode="reflect")
    want = scipy_zoom(x, zoom=5 / 3, order=0, mode="reflect")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("order", [3, 5])
@pytest.mark.parametrize("mode", ["mirror", "reflect", "wrap"])
def test_prefilter_matches_scipy(rng, order, mode):
    x = rng.standard_normal((4, 37)).astype(np.float32)
    got = spline_filter_1d(torch.as_tensor(x), order, mode).numpy()
    want = spline_filter1d(x.astype(np.float64), order=order,
                           mode="grid-wrap" if mode == "wrap" else mode)
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("order", [2, 3, 4, 5])
@pytest.mark.parametrize("mode", ["mirror", "reflect", "wrap"])
@pytest.mark.parametrize("n", [5, 23, 200])
def test_fir_prefilter_matches_fft(rng, order, mode, n):
    """The truncated FIR is the default; it agrees with the exact circular
    deconvolution at every length, n below the FIR half-width too (the pad
    wraps the periodic extension)."""
    x = torch.as_tensor(rng.standard_normal((3, n)).astype(np.float32))
    fir = spline_filter_1d(x, order, mode, impl="fir").numpy()
    fft = spline_filter_1d(x, order, mode, impl="fft").numpy()
    np.testing.assert_allclose(fir, fft, rtol=2e-5,
                               atol=2e-5 * np.abs(fft).max())


@pytest.mark.parametrize("axis", [0, 1, -1])
def test_prefilter_along_any_axis(rng, axis):
    x = rng.standard_normal((6, 7, 9)).astype(np.float32)
    got = spline_filter_1d(torch.as_tensor(x), 3, "mirror", axis=axis)
    want = spline_filter1d(x.astype(np.float64), order=3, mode="mirror",
                           axis=axis)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("mode", ["mirror", "reflect", "wrap"])
def test_zoom_batched(rng, mode):
    x = rng.standard_normal((3, 20, 20)).astype(np.float32)
    got = _zoom(x, 1.6, order=3, mode=mode)
    assert got.shape == (3, 32, 32)
    for i in range(3):
        want = scipy_zoom(x[i].astype(np.float64), 1.6, order=3,
                          **_scipy_mode(mode))
        np.testing.assert_allclose(got[i], want, rtol=ZOOM_RTOL,
                                   atol=ZOOM_ATOL * np.abs(want).max())


@pytest.mark.parametrize("zf", [(2.0, 0.5), (0.7, 1.3)])
def test_anisotropic_zoom(rng, zf):
    x = rng.standard_normal((12, 20)).astype(np.float32)
    got = _zoom(x, zf, order=3, mode="mirror")
    want = scipy_zoom(x.astype(np.float64), zf, order=3, mode="mirror")
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=ZOOM_RTOL,
                               atol=ZOOM_ATOL * np.abs(want).max())


def test_zoom_identity_and_constant(rng):
    x = rng.standard_normal((16, 16)).astype(np.float32)
    np.testing.assert_allclose(_zoom(x, 1.0, order=3, mode="mirror"), x,
                               rtol=1e-4, atol=1e-5)
    out = _zoom(np.ones((80, 80), np.float32), 512 / 80, order=3,
                mode="reflect")
    assert out.shape == (512, 512)
    np.testing.assert_allclose(out, 1.0, rtol=1e-5)


def test_arrays_go_to_the_device_asked_for(rng):
    """An array (not a tensor) is resampled on ``device``; the default is
    the card, which this host does not have."""
    x = rng.standard_normal((8, 8)).astype(np.float32)
    out = resize_spline(x, (5, 5), device="cpu")
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            resize_spline(x, (5, 5))


def test_unsupported_order_mode_and_impl_raise(rng):
    x = torch.as_tensor(rng.standard_normal((8, 8)).astype(np.float32))
    with pytest.raises(NotImplementedError):
        resize_spline(x, (4, 4), order=2)
    with pytest.raises(ValueError, match="mode"):
        resize_spline(x, (4, 4), mode="nearest")
    with pytest.raises(ValueError, match="impl"):
        spline_filter_1d(x, 3, impl="iir")


@pytest.mark.parametrize("order,mode", [(3, "reflect"), (3, "mirror"),
                                        (5, "mirror"), (3, "wrap")])
@pytest.mark.parametrize("shape,out", [((2, 37, 41), (64, 64)),
                                       ((1, 200, 200), (96, 80))],
                         ids=["up", "down"])
def test_resize_matches_jax(rng, order, mode, shape, out):
    """The pairs the JAX lightcone (order 3 reflect tiles, order 3 mirror
    massplane tile), its y map (order 5 mirror) and its seamless path
    (order 3 wrap) use."""
    x = rng.gamma(2.0, 0.5, shape).astype(np.float32)
    want = np.asarray(jax_resize(jnp.asarray(x), out, order=order,
                                 mode=mode))
    got = resize_spline(torch.as_tensor(x), out, order=order,
                        mode=mode).numpy()
    np.testing.assert_allclose(got, want, rtol=JAX_TOL,
                               atol=JAX_TOL * np.abs(want).max())
