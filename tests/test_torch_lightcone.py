"""The port's SLICS lightcone (baryon_painter_tpu_torch/lightcone/) against
the JAX package's, on the CPU.

* Tiling: ``generate_tiling``, ``tile_origin_pixels`` and
  ``make_weight_map`` equal to JAX's (numpy both), at every plane size of
  tests/test_lightcone.py's coverage test; ``get_tile`` on numpy and torch
  equal to JAX's on numpy (a gather: bit for bit).
* The SLICS readers equal JAX's on the committed tests/fixtures/slics/*.
* ``blend_tiles`` within 1e-6 relative of JAX's scan (the same adds in the
  same order, f32).
* ``paint_plane`` (with regularisation and ``collect_problematic``),
  ``paint_plane_from_massplane`` and ``process_slics`` (a small synthetic
  line of sight, also with bf16 plane transfer) with one stub painter, the
  same numpy function in both packages: within rtol 1e-5, atol 1e-5 *
  max|JAX| (the resamplers compute the same f32 operations in another
  order), NaN where JAX has NaN.
* ``effective_pixel_areas`` (numpy both: 1e-12) and ``create_y_map``
  (rtol 1e-5 of the map's largest value), NaN planes included.
* The whole slice with the real model: both packages' f32 ``CVAEPainter``
  on ``trained_models/CVAE/fiducial-512/model`` at the prior mean, through
  ``process_slics`` (a massplane shell and a delta shell of 4 tiles of
  512^2), ``create_y_map`` and ``pseudo_cl_2d``: planes and y map within
  the golden's rtol 5e-3, atol 5e-3 * mean|JAX|; the y map's Cl per bin
  within 1e-2 relative.
* A delta shell of 3 x 3 tiles of 512^2 painted by both packages at the
  prior mean: within that tolerance, and its border band (the tiles'
  zero-padded edges alone) as bright in both.
"""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baryon_painter_tpu.angular_power import pseudo_cl_2d as jax_cl
from baryon_painter_tpu.cosmology import SLICS_COSMOLOGY as JAX_COSMOLOGY
from baryon_painter_tpu.lightcone import io as jax_io
from baryon_painter_tpu.lightcone import pipeline as jax_pipe
from baryon_painter_tpu.lightcone import tiling as jax_tiling
from baryon_painter_tpu.lightcone import ymap as jax_ymap
from baryon_painter_tpu_torch.angular_power import pseudo_cl_2d
from baryon_painter_tpu_torch.cosmology import SLICS_COSMOLOGY
from baryon_painter_tpu_torch.lightcone import io as slics_io
from baryon_painter_tpu_torch.lightcone import pipeline, tiling, ymap
from golden_utils import REPO

FIX = os.path.join(REPO, "tests", "fixtures", "slics")
CHECKPOINT = os.path.join(REPO, "trained_models", "CVAE", "fiducial-512",
                          "model")
TOL = 1e-5
GOLDEN_RTOL = 5e-3


class TorchStub:
    """The port's stub painter: ``fn`` on the tiles, on ``device``."""

    def __init__(self, fn=lambda x: x, device="cpu"):
        self.fn, self.device = fn, torch.device(device)

    def paint_batch(self, tiles, zs):
        return torch.as_tensor(self.fn(tiles.cpu().numpy()),
                               device=self.device)


class JaxStub:
    def __init__(self, fn=lambda x: x):
        self.fn = fn

    def paint_batch(self, tiles, zs, **kw):
        return jnp.asarray(self.fn(np.asarray(tiles)))


def _square(x):
    return x * x + 0.25 * x


def _spike(x):
    x = _square(x)
    x[:, 0, 0] += 1000.0  # an outlier in every tile
    return x


def _close(got, want, tol=TOL):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_allclose(got[ok], want[ok], rtol=tol,
                               atol=tol * np.abs(want[ok]).max())


# --------------------------------------------------------------------- #
# tiling and I/O: numpy in both packages


@pytest.mark.parametrize("plane,tile,overlap", [
    (512, 256, 0.0), (512, 250, 0.0), (512, 256, 0.5), (512, 128, 0.0),
    (512, 32, 0.33), (1000, 300, 0.4), (3273, 512, 0.2), (562, 512, 0.2),
    (400, 512, 0.2)])
def test_generate_tiling_equals_jax(plane, tile, overlap):
    o, s = tiling.generate_tiling(plane, tile, overlap)
    jo, js = jax_tiling.generate_tiling(plane, tile, overlap)
    np.testing.assert_array_equal(o, jo)
    assert s == js


def test_origins_equal_jax_at_every_plane_size():
    """Every plane size of tests/test_lightcone.py's coverage test: the
    rounded, clamped origins shared by extraction and blend placement."""
    for n in [514, 517, 1198, 2534] + list(range(513, 1200, 7)):
        o, _ = tiling.generate_tiling(n, 512, min_tile_overlap=0.2)
        jo, _ = jax_tiling.generate_tiling(n, 512, min_tile_overlap=0.2)
        px = tiling.tile_origin_pixels(o, n, 512)
        np.testing.assert_array_equal(
            px, jax_tiling.tile_origin_pixels(jo, n, 512))
        cov = np.zeros(n, bool)
        for x0 in px:
            cov[x0:x0 + 512] = True
        assert cov.all(), n


@pytest.mark.parametrize("shape,falloff,sigma", [
    ((64, 64), 0.05, 0.5), ((512, 512), 0.05, 0.5), ((40, 72), 0.1, 1.0),
    ((16, 16), 0.0, 1.0)])
def test_weight_map_equals_jax(shape, falloff, sigma):
    np.testing.assert_array_equal(
        tiling.make_weight_map(shape, falloff, sigma),
        jax_tiling.make_weight_map(shape, falloff, sigma))


@pytest.mark.parametrize("shift,rel,exp", [
    ((0.0, 0.0), 0.5, 1.0), ((0.37, 0.81), 0.3, 1.0),
    ((0.9, 0.95), 0.25, 2.3), ((0.5, 0.1), 60 / 505, 100 / 60)])
def test_get_tile_numpy_and_torch_equal_jax(rng, shift, rel, exp):
    m = rng.standard_normal((97, 97)).astype(np.float32)
    want = jax_tiling.get_tile(m, shift, rel, exp)
    np.testing.assert_array_equal(tiling.get_tile(m, shift, rel, exp), want)
    got = tiling.get_tile(torch.as_tensor(m), shift, rel, exp)
    assert isinstance(got, torch.Tensor)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        tiling.get_tile(m, shift, rel, 0.5)


def test_slics_readers_equal_jax_on_the_fixtures():
    d = slics_io.delta_filename(FIX, 0.5, 9)
    assert d == jax_io.delta_filename(FIX, 0.5, 9)
    np.testing.assert_array_equal(slics_io.load_delta_plane(d, n_pixel=5),
                                  jax_io.load_delta_plane(d, n_pixel=5))
    np.testing.assert_array_equal(
        slics_io.load_delta_plane_raw(d, n_pixel=5),
        jax_io.load_delta_plane_raw(d, n_pixel=5))
    m = slics_io.massplane_filename(FIX, 0.042, 9, 0)
    assert m == jax_io.massplane_filename(FIX, 0.042, 9, 0)
    np.testing.assert_array_equal(slics_io.load_massplane(m, n_pixel=6),
                                  jax_io.load_massplane(m, n_pixel=6))
    np.testing.assert_array_equal(slics_io.load_massplane_raw(m, n_pixel=6),
                                  jax_io.load_massplane_raw(m, n_pixel=6))
    np.testing.assert_array_equal(slics_io.load_random_shifts(FIX, 9),
                                  jax_io.load_random_shifts(FIX, 9))
    k = slics_io.kappa_filename(FIX, 9)
    assert k == jax_io.kappa_filename(FIX, 9)
    for dec in (1, 2):
        np.testing.assert_array_equal(
            slics_io.load_kappa_map(k, n_pixel=5, decimate=dec),
            jax_io.load_kappa_map(k, n_pixel=5, decimate=dec))
    assert ([slics_io.massplane_filename("", 0.1, 3, i) for i in range(4)]
            == [jax_io.massplane_filename("", 0.1, 3, i) for i in range(4)])
    assert slics_io.density_filename("d", 0.5, 2) == jax_io.density_filename(
        "d", 0.5, 2)
    assert (slics_io.SLICS_NORM, slics_io.N_PIXEL_DELTA,
            slics_io.N_PIXEL_MASSPLANE, slics_io.MASSPLANE_SIZE) == (
        jax_io.SLICS_NORM, 7745, 12288, 505.0)


# --------------------------------------------------------------------- #
# blending and painting with a stub painter


def test_blend_tiles_matches_jax(rng):
    tiles = rng.standard_normal((7, 16, 16)).astype(np.float32)
    weights = rng.uniform(0.1, 1.0, (7, 16, 16)).astype(np.float32)
    origins = rng.integers(0, 48 - 16, (7, 2)).astype(np.int32)
    want = jax_pipe.blend_tiles(jnp.asarray(tiles), jnp.asarray(weights),
                                jnp.asarray(origins), 48)
    got = pipeline.blend_tiles(torch.as_tensor(tiles),
                               torch.as_tensor(weights),
                               torch.as_tensor(origins), 48)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6 * np.abs(np.asarray(w)).max())


@pytest.mark.parametrize("kw", [
    dict(delta_size=400.0, min_tile_overlap=0.5, zoom_order=1),
    dict(delta_size=250.0, min_tile_overlap=0.2, zoom_order=3,
         paint_batch_size=3),
    dict(delta_size=125.0, min_tile_overlap=0.5, zoom_order=3)],
    ids=["identity_order1", "order3_short_chunk", "two_by_two"])
def test_paint_plane_matches_jax(rng, kw):
    delta = rng.gamma(2.0, 0.5, (192, 192)).astype(np.float32)
    args = dict(z_slice=0.5, tile_size=100.0, n_pixel_tile=64, **kw)
    want = jax_pipe.paint_plane(JaxStub(_square), delta, **args)
    got = pipeline.paint_plane(TorchStub(_square), delta, **args)
    assert isinstance(got, np.ndarray)
    _close(got, want)
    dev = pipeline.paint_plane(TorchStub(_square), delta,
                               device_output=True, **args)
    assert isinstance(dev, torch.Tensor)
    np.testing.assert_array_equal(dev.numpy(), got)


def test_paint_plane_regularise_and_problematic_match_jax(rng):
    """jnp.std is the population std: the port's outliers (ddof 0) are
    JAX's, and so are the NaN pixels where every weight was zeroed."""
    delta = rng.gamma(2.0, 0.5, (128, 128)).astype(np.float32)
    args = dict(z_slice=0.0, tile_size=100.0, delta_size=200.0,
                n_pixel_tile=64, zoom_order=1, regularise=True,
                regularise_std=5.0, collect_problematic=True)
    want, want_p = jax_pipe.paint_plane(JaxStub(_spike), delta, **args)
    got, got_p = pipeline.paint_plane(TorchStub(_spike), delta, **args)
    _close(got, want)
    assert len(got_p) == len(want_p) > 0
    for (z, t, p), (jz, jt, jp) in zip(got_p, want_p):
        assert z == jz
        _close(t, jt)
        _close(p, jp)


@pytest.mark.parametrize("pre_extracted,subtract_minimum",
                         [(False, False), (True, False), (False, True)])
def test_paint_plane_from_massplane_matches_jax(rng, pre_extracted,
                                                subtract_minimum):
    mp = rng.gamma(2.0, 0.5, (300, 300)).astype(np.float32)
    shift, delta_size, tile_size = (0.3, 0.6), 50.0, 100.0
    if pre_extracted:
        mp = jax_tiling.get_tile(mp, shift, delta_size / 505.0,
                                 tile_size / delta_size)
    args = dict(shift=shift, z_slice=0.04, tile_size=tile_size,
                delta_size=delta_size, n_pixel_tile=64, massplane_size=505.0,
                zoom_order=3, pre_extracted=pre_extracted,
                subtract_minimum=subtract_minimum)
    want = jax_pipe.paint_plane_from_massplane(JaxStub(_square), mp, **args)
    got = pipeline.paint_plane_from_massplane(TorchStub(_square), mp, **args)
    assert got.shape == (32, 32)
    _close(got, want)


def _write_los(tmp_path, rng, n_delta=128, n_mass=96):
    """tests/test_lightcone.py's synthetic line of sight: one low-z shell
    from a massplane, one high-z shell from a delta plane."""
    paths = [tmp_path / p for p in ("delta", "massplanes", "shifts")]
    for p in paths:
        os.makedirs(p)
    (rng.gamma(2.0, 48.0, n_mass * n_mass + 1).astype(np.float32)
     .tofile(paths[1] / "0.042proj_half_finer_xy.dat_LOS7"))
    (rng.gamma(2.0, 48.0, n_delta * n_delta).astype(np.float32) - 96.0
     ).astype(np.float32).tofile(paths[0] / "0.500delta.dat_bicubic_LOS7")
    np.savetxt(paths[2] / "random_shift_LOS7",
               np.array([[0.2, 0.3], [0.5, 0.6]]))
    return dict(tile_size=100.0, n_pixel_tile=64, LOS=7,
                z_SLICS=[0.042, 0.500], delta_size=np.array([60.0, 250.0]),
                delta_path=str(paths[0]), massplane_path=str(paths[1]),
                shifts_path=str(paths[2]), z_slice=[0.02, 0.45],
                verbose=False, n_pixel_delta=n_delta,
                n_pixel_massplane=n_mass, massplane_size=505.0,
                paint_batch_size=4)


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16_transfer"])
def test_process_slics_matches_jax(tmp_path, rng, bf16):
    """The reference call contract end to end; with bf16 transfer both
    round the raw file values to bf16 before the +96 (the same rounding)."""
    los = _write_los(tmp_path, rng)
    want = jax_pipe.process_slics(
        JaxStub(_square), transfer_dtype=jnp.bfloat16 if bf16 else None,
        **los)
    stages = pipeline.StageTimes("cpu")
    got = pipeline.process_slics(
        TorchStub(_square), transfer_dtype=torch.bfloat16 if bf16 else None,
        stage_times=stages, **los)
    assert [p.shape for p in got] == [(38, 38), (160, 160)]
    for g, w in zip(got, want):
        _close(g, w)
    assert [s for s, _ in stages.intervals()] == [
        "setup", "upload", "zoom", "paint", "blend",
        "upload", "zoom", "paint", "blend"]
    assert all(ms >= 0 for _, ms in stages.intervals())


def test_process_slics_device_output_and_problematic(tmp_path, rng):
    los = _write_los(tmp_path, rng)
    dev = pipeline.process_slics(TorchStub(_square), device_output=True,
                                 **los)
    host = pipeline.process_slics(TorchStub(_square), **los)
    assert all(isinstance(p, torch.Tensor) for p in dev)
    for d, h in zip(dev, host):
        np.testing.assert_array_equal(d.numpy(), h)
    planes, probs = pipeline.process_slics(
        TorchStub(_spike), regularise=True, regularise_std=5.0,
        return_problematic_tiles=True, **los)
    j_planes, j_probs = jax_pipe.process_slics(
        JaxStub(_spike), regularise=True, regularise_std=5.0,
        return_problematic_tiles=True, **los)
    assert len(probs) == len(j_probs) > 0
    for g, w in zip(planes, j_planes):
        _close(g, w)


def test_process_slics_rejects_what_jax_rejects_and_what_is_not_ported(
        tmp_path, rng):
    stub = TorchStub()
    with pytest.raises(ValueError, match="match"):
        pipeline.process_slics(stub, 100.0, 64, 7, [0.1, 0.2], [1.0, 2.0],
                               "", "", "", z_slice=[0.0])
    with pytest.raises(ValueError, match="regularise"):
        pipeline.process_slics(stub, 100.0, 64, 7, [0.1], [1.0], "", "", "",
                               z_slice=[0.0], seamless=True, regularise=True)
    stub._fused_inference = True
    with pytest.raises(ValueError, match="fused"):
        pipeline.process_slics(stub, 100.0, 64, 7, [0.1], [1.0], "", "", "",
                               z_slice=[0.0], seamless=True)
    # painting takes a DeviceMesh (tests/test_torch_mesh_paint.py), and
    # refuses any other kind of mesh
    with pytest.raises(TypeError, match="DeviceMesh"):
        pipeline.process_slics(TorchStub(), 100.0, 64, 7, [0.1], [1.0], "",
                               "", "", z_slice=[0.0], mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        pipeline.paint_plane(TorchStub(), np.zeros((64, 64), np.float32),
                             0.0, 100.0, 200.0, 32, mesh=object())


# --------------------------------------------------------------------- #
# the Compton-y map


def test_effective_pixel_areas_equal_jax():
    z = np.array([0.042, 0.130, 0.221, 0.317, 2.007])
    theta = 10.0 / 512 * np.pi / 180
    np.testing.assert_allclose(
        ymap.effective_pixel_areas(SLICS_COSMOLOGY(), z, theta),
        jax_ymap.effective_pixel_areas(JAX_COSMOLOGY(), z, theta),
        rtol=1e-12)


@pytest.mark.parametrize("order", [1, 3, 5])
def test_create_y_map_matches_jax(rng, order):
    planes = [rng.gamma(2.0, 0.5, (n, n)).astype(np.float32)
              for n in (64, 80, 50)]
    planes[1][3, 4] = np.nan
    planes[2][0, :] = np.nan
    z = [0.042, 0.130, 0.9]
    kw = dict(resolution=40, map_size=10.0, order=order)
    want = jax_ymap.create_y_map(planes, z, cosmo=JAX_COSMOLOGY(), **kw)
    got = ymap.create_y_map(planes, z, cosmo=SLICS_COSMOLOGY(),
                            device="cpu", **kw)
    got_t = ymap.create_y_map([torch.as_tensor(p) for p in planes], z,
                              cosmo=SLICS_COSMOLOGY(), **kw)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    assert np.all(np.isfinite(got))
    _close(got, want)
    np.testing.assert_array_equal(got, got_t)
    with pytest.raises(ValueError):
        ymap.create_y_map(planes, z[:2], 40, 10.0, SLICS_COSMOLOGY(),
                          device="cpu")


def test_create_y_map_nan_plane_matches_jax():
    p = np.ones((32, 32), np.float32)
    p[0, 0] = np.nan
    want = jax_ymap.create_y_map([p], [0.2], 32, 10.0, JAX_COSMOLOGY())
    got = ymap.create_y_map([p], [0.2], 32, 10.0, SLICS_COSMOLOGY(),
                            device="cpu")
    assert np.all(np.isfinite(got))
    _close(got, want)


# --------------------------------------------------------------------- #
# the whole slice with the committed fiducial CVAE


class MeanPainter:
    """A painter at the prior mean (no noise to draw alike in both)."""

    def __init__(self, painter, device=None):
        self.painter, self.device = painter, device

    def paint_batch(self, tiles, zs):
        return self.painter.paint_batch(tiles, zs, z_mode="mean")


def _write_model_los(tmp_path, rng, n_delta=256, n_mass=400):
    paths = [tmp_path / p for p in ("delta", "massplanes", "shifts")]
    for p in paths:
        os.makedirs(p)
    (rng.gamma(2.0, 48.0, n_mass * n_mass + 1).astype(np.float32)
     .tofile(paths[1] / "0.042proj_half_finer_xy.dat_LOS3"))
    (rng.gamma(2.0, 48.0, n_delta * n_delta) - 96.0).astype(
        np.float32).tofile(paths[0] / "0.221delta.dat_bicubic_LOS3")
    np.savetxt(paths[2] / "random_shift_LOS3",
               np.array([[0.2, 0.7], [0.5, 0.6]]))
    # a 60 Mpc/h massplane shell (1 tile, cropped to 307^2) and a 150 Mpc/h
    # delta shell (a 768^2 plane: 2 x 2 tiles of 512^2 at overlap 0.2)
    return dict(tile_size=100.0, n_pixel_tile=512, LOS=3,
                z_SLICS=[0.042, 0.221], delta_size=np.array([60.0, 150.0]),
                delta_path=str(paths[0]), massplane_path=str(paths[1]),
                shifts_path=str(paths[2]), z_slice=[0.02, 0.2],
                min_tiling_overlap=0.2, verbose=False,
                n_pixel_delta=n_delta, n_pixel_massplane=n_mass,
                paint_batch_size=4)


def test_lightcone_with_the_fiducial_cvae_matches_jax(tmp_path, rng):
    from baryon_painter_tpu.painter import CVAEPainter as JaxPainter
    from baryon_painter_tpu_torch.painter import CVAEPainter

    los = _write_model_los(tmp_path, rng)
    want = jax_pipe.process_slics(MeanPainter(JaxPainter(CHECKPOINT)), **los)
    got = pipeline.process_slics(
        MeanPainter(CVAEPainter(CHECKPOINT, device="cpu"),
                    torch.device("cpu")), **los)
    assert [p.shape for p in got] == [(307, 307), (768, 768)]
    for g, w in zip(got, want):
        _golden_close(g, w)
    kw = dict(z=los["z_SLICS"], resolution=128, map_size=10.0, order=5)
    y_want = jax_ymap.create_y_map(want, cosmo=JAX_COSMOLOGY(), **kw)
    y_got = ymap.create_y_map(got, cosmo=SLICS_COSMOLOGY(), device="cpu",
                              **kw)
    _golden_close(y_got, y_want)
    cl_want, _, _, nm = jax_cl(jnp.asarray(y_want), theta_deg=10.0)
    cl_got = pseudo_cl_2d(torch.as_tensor(y_got), theta_deg=10.0)[0]
    has = np.asarray(nm) > 0
    np.testing.assert_allclose(cl_got.numpy()[has], np.asarray(cl_want)[has],
                               rtol=1e-2)


def _p9999_border_interior(plane, band: int = 32):
    """The 99.99th percentile of a plane's border band of ``band`` pixels
    and of its interior."""
    plane = np.asarray(plane, np.float64)
    border = np.zeros(plane.shape, bool)
    border[:band] = border[-band:] = True
    border[:, :band] = border[:, -band:] = True
    return (float(np.quantile(plane[border], 0.9999)),
            float(np.quantile(plane[~border], 0.9999)))


def test_tiled_plane_border_band_matches_jax(rng):
    """A delta shell tiled as the lightcone CLI tiles it (512^2 tiles,
    overlap 0.2) on a 1280^2 plane: 3 x 3 tiles, the outer ones meeting the
    plane's border as on the real shells. Both packages' f32 fiducial-512
    CVAE at the prior mean paint it within the golden tolerance, and the
    plane's border band, painted by the tiles' zero-padded edges alone,
    is as bright in the port as in JAX (99.99th percentiles within
    GOLDEN_RTOL), far brighter than the interior in both."""
    from baryon_painter_tpu.painter import CVAEPainter as JaxPainter
    from baryon_painter_tpu_torch.painter import CVAEPainter

    delta = (rng.gamma(2.0, 48.0, (500, 500))
             * slics_io.SLICS_NORM).astype(np.float32)
    args = dict(z_slice=2.0, tile_size=100.0, delta_size=250.0,
                n_pixel_tile=512, min_tile_overlap=0.2, paint_batch_size=3)
    assert len(tiling.generate_tiling(1280, 512, 0.2)[0]) == 3
    want = jax_pipe.paint_plane(MeanPainter(JaxPainter(CHECKPOINT)), delta,
                                **args)
    got = pipeline.paint_plane(
        MeanPainter(CVAEPainter(CHECKPOINT, device="cpu"),
                    torch.device("cpu")), delta, **args)
    assert got.shape == (1280, 1280)
    _golden_close(got, want)
    (b_got, i_got), (b_want, i_want) = (_p9999_border_interior(got),
                                        _p9999_border_interior(want))
    print(f"99.99th percentile, border band / interior: port {b_got:.4f} / "
          f"{i_got:.4f}, JAX {b_want:.4f} / {i_want:.4f}")
    np.testing.assert_allclose([b_got, i_got], [b_want, i_want],
                               rtol=GOLDEN_RTOL)
    assert b_want > 5 * i_want


def _golden_close(got, want):
    want = np.asarray(want, np.float64)
    got = np.asarray(got, np.float64)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=GOLDEN_RTOL,
                               atol=GOLDEN_RTOL * np.abs(want).mean())
