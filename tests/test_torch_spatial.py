"""The port's whole-plane painting (parallel/spatial.py) and the lightcone's
seamless path against the JAX package's, on the CPU.

* ``spec_receptive_margin``, ``latent_downsample`` and ``required_halo``
  equal JAX's on every committed architecture (288 px for the fiducial-512
  CVAE, 92 for the CGAN) and on small ones.
* ``paint_plane`` against JAX's ``paint_plane(mesh=None)`` on a 288 x 96
  plane (and a 150 x 91 one, which the alignment pads), with a small CVAE
  (latent grid /4, random flax weights, batch norm perturbed) in 'mean',
  'zero' and 'sample' mode (JAX's noise drawn on the global latent grid
  and handed to the port), and a small spectrally normalised CGAN
  generator (2 residual blocks; folded in the port, in the graph in JAX):
  rtol 1e-5, atol 1e-5 * max|JAX|.
* Halo sufficiency (paints at ``required_halo`` and twice it agree to rtol
  1e-5, atol 1e-6, as tests/test_spatial_paint.py holds JAX's) and
  ``calibrate_halo`` equal to JAX's.
* ``process_slics(seamless=True)`` on the committed tests/fixtures/slics
  line of sight (a massplane shell, a delta shell painted as one plane)
  against JAX's: the CGAN directly, the CVAE with each shell's noise
  JAX's ``PRNGKey(1000 * LOS + i)`` draw (the port's generator is seeded
  with the same number), within tests/test_torch_lightcone.py's tolerance
  for a model's lightcone (rtol 5e-3, atol 5e-3 * mean|JAX|); the shell
  equal to ``paint_plane`` of the port's own zoomed plane; the port's own
  draw reproducible.
* A mesh that is not a ``DeviceMesh`` raises ``TypeError`` (the sharded
  paths: tests/test_torch_mesh_paint.py).
"""
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baryon_painter_tpu.lightcone import pipeline as jax_pipe
from baryon_painter_tpu.models import dsl as jax_dsl
from baryon_painter_tpu.models.cgan import CGANGenerator as JaxGenerator
from baryon_painter_tpu.models.cgan import \
    cgan_generator_spec as jax_cgan_spec
from baryon_painter_tpu.models.cvae import CVAE as JaxCVAE
from baryon_painter_tpu.painter import CGANPainter as JaxCGANPainter
from baryon_painter_tpu.painter import CVAEPainter as JaxCVAEPainter
from baryon_painter_tpu.parallel import spatial as jax_spatial
from baryon_painter_tpu_torch.lightcone import io as slics_io
from baryon_painter_tpu_torch.lightcone import pipeline
from baryon_painter_tpu_torch.ops.resample import resize_spline
from baryon_painter_tpu_torch.models import dsl
from baryon_painter_tpu_torch.painter import CGANPainter, CVAEPainter
from baryon_painter_tpu_torch.parallel import spatial
from golden_utils import MODELS, REPO

TILE = 64
FIX = os.path.join(REPO, "tests", "fixtures", "slics")
TOL = 1e-5
GOLDEN_RTOL = 5e-3


def mini_cvae_arch(tile=TILE):
    """tests/test_spatial_paint.py's small fully convolutional CVAE (latent
    grid /4), so halos stay test-sized."""
    return {
        "type": "Type-1",
        "dim_x": (1, tile, tile),
        "dim_y": (1, tile, tile),
        "dim_z": (1, tile // 4, tile // 4),
        "n_x_features": 1,
        "aux_label": True,
        "prior_z_y": (dsl.conv_down(2, [8, 16], [2, 2])
                      + dsl.conv_block(16, 2, kernel=3)),
        "q_x_in": dsl.conv_down(1, [8, 16], [2, 2]),
        "q_y_in": dsl.conv_down(2, [8, 16], [2, 2]),
        "q_x_y_out": dsl.conv_block(32, 2, kernel=3),
        "p_y_in": None,
        "p_z_in": dsl.conv_up(1, [1, 1], [2, 2]),
        "p_y_z_in": (dsl.conv_block(3, 8, kernel=3)
                     + dsl.conv_down(8, [16], [2])
                     + [("residual block", dsl.res_block(16))]
                     + dsl.conv_up(16, [8], [2])),
        "p_y_z_out": (dsl.conv_block(8, 1, kernel=3, batchnorm=False,
                                     activation="softplus"),),
        "min_x_var": 1e-7,
        "min_z_var": 1e-7,
        "L": 1,
    }


def _meta(kind, arch):
    rc = {"type": "range_compress", "mode": "shift-log", "k": 4.0,
          "eps": 1e-4, "sqrt_of_mean": False}
    stats = {"z_grid": [0.0, 1.0], "mean": [1.0, 1.2], "var": [2.0, 2.6]}
    return {"model_kind": kind, "input_field": "dm",
            "label_fields": ["pressure"], "tile_L": 100.0,
            "tile_size": TILE, "transforms": {"dm": rc, "pressure": rc},
            "stats": {"dm": stats, "pressure": stats},
            "model_architecture": arch}


def _perturbed(variables, seed):
    rng = np.random.default_rng(seed)

    def perturb(path, a):
        a = np.asarray(a, np.float32)
        name = jax.tree_util.keystr(path)
        if "BatchNorm" in name and ("scale" in name or "var" in name):
            return (a * rng.uniform(0.7, 1.3, a.shape)).astype(np.float32)
        if "BatchNorm" in name and ("bias" in name or "mean" in name):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(
                np.float32)
        return a

    return jax.tree_util.tree_map_with_path(perturb, variables)


@pytest.fixture(scope="module")
def cvae_pair():
    arch = mini_cvae_arch()
    model = JaxCVAE(arch)
    y = jnp.ones((1, TILE, TILE, 1), jnp.float32)
    x = jnp.ones((1, TILE, TILE, 1), jnp.float32)
    v = _perturbed(model.init(jax.random.PRNGKey(0), x, y,
                              jnp.zeros((1,)), train=False), 1)
    meta = _meta("cvae", arch)
    return (JaxCVAEPainter(model=model, variables=v, meta=meta),
            CVAEPainter(variables=v, meta=meta, device="cpu"))


@pytest.fixture(scope="module")
def cgan_pair():
    arch = {"in_channels": 2, "n_res_blocks": 2, "upsample": "transpose"}
    gen = JaxGenerator(n_res_blocks=2)
    v = _perturbed(gen.init(jax.random.PRNGKey(0),
                            jnp.ones((1, TILE, TILE, 1), jnp.float32),
                            jnp.zeros((1,)), train=False), 2)
    meta = _meta("cgan", arch)
    return (JaxCGANPainter(generator=gen, variables=v, meta=meta),
            CGANPainter(variables=v, meta=meta, device="cpu"))


def _plane(rows, cols, seed=3):
    rng = np.random.default_rng(seed)
    return np.abs(rng.lognormal(0.0, 0.8, (rows, cols))).astype(np.float32)


def _close(got, want):
    got = np.asarray(torch.as_tensor(got).float().cpu(), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * np.abs(want).max())


def _golden_close(got, want):
    """tests/test_torch_lightcone.py's tolerance for a lightcone painted by
    a model in both packages: their resamplers' f32 sums in another order
    (1e-5 apart) reach the network, which moves them further."""
    got = np.asarray(torch.as_tensor(got).float().cpu(), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=GOLDEN_RTOL,
                               atol=GOLDEN_RTOL * np.abs(want).mean())


# --------------------------------------------------------------------- #
# receptive-field accounting


@pytest.mark.parametrize("name,base,kind,tile,n", MODELS,
                         ids=[m[0] for m in MODELS])
def test_required_halo_equals_jax_on_committed_architectures(name, base,
                                                             kind, tile, n):
    with open(os.path.join(REPO, base) + "_meta.json") as f:
        arch = json.load(f)["model_architecture"]
    got = spatial.required_halo(arch, kind)
    assert got == jax_spatial.required_halo(arch, kind)
    assert spatial.latent_downsample(arch) == jax_spatial.latent_downsample(
        arch)
    if name == "cvae_512":
        assert got == 288
    if kind == "cgan":
        assert got == 92


def test_receptive_margin_equals_jax_on_small_specs():
    arch = mini_cvae_arch()
    specs = [arch[k] for k in ("prior_z_y", "q_x_in", "p_z_in", "p_y_z_in",
                               "p_y_z_out")]
    specs[-1] = specs[-1][0]
    specs += list(jax_cgan_spec(2, 3, "resize"))
    specs += [dsl.conv_block(1, 8, scale=4), dsl.conv_block(1, 8, scale=2),
              dsl.conv_up(4, [4, 2], [2, 4], mode="resize")]
    for spec in specs:
        for f in (1.0, 4.0):
            assert spatial.spec_receptive_margin(spec, f) == \
                jax_spatial.spec_receptive_margin(spec, f)
    assert spatial.spec_receptive_margin(dsl.conv_block(1, 8, scale=4)) == (
        5, 4)
    for k in ("cvae", "cgan"):
        a = mini_cvae_arch() if k == "cvae" else {"n_res_blocks": 2}
        assert spatial.required_halo(a, k) == jax_spatial.required_halo(a, k)
    wide = dict(arch, p_y_in=jax_dsl.conv_block(1, 1, kernel=121,
                                                batchnorm=False,
                                                activation=None))
    assert spatial.required_halo(wide) == jax_spatial.required_halo(wide)
    with pytest.raises(ValueError, match="linear"):
        spatial.spec_receptive_margin((("linear", {"out_features": 4}),))
    with pytest.raises(ValueError, match="model kind"):
        spatial.required_halo(arch, "gan")


# --------------------------------------------------------------------- #
# paint_plane


def _jax_eps(jp, shape, key):
    f = jax_spatial.latent_downsample(jp.architecture)
    cz = int(jp.architecture["dim_z"][0])
    q, w = -(-shape[0] // f) * f, -(-shape[1] // f) * f
    return np.asarray(jax.random.normal(jax.random.PRNGKey(key),
                                        (q // f, w // f, cz), jnp.float32))


@pytest.mark.parametrize("z_mode", ["mean", "zero", "sample"])
@pytest.mark.parametrize("shape", [(288, 96), (150, 91)],
                         ids=["288x96", "150x91"])
def test_cvae_paint_plane_matches_jax(cvae_pair, z_mode, shape):
    jp, pp = cvae_pair
    plane = _plane(*shape)
    want = jax_spatial.paint_plane(jp, plane, z=0.5, z_mode=z_mode,
                                   rng=jax.random.PRNGKey(11))
    eps = _jax_eps(jp, shape, 11) if z_mode == "sample" else None
    if eps is not None:
        assert eps.shape == spatial.latent_noise_shape(pp, shape)
    got = spatial.paint_plane(pp, plane, z=0.5, z_mode=z_mode, eps=eps)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.float32
    _close(got, want)


@pytest.mark.parametrize("shape", [(288, 96), (150, 91)],
                         ids=["288x96", "150x91"])
def test_cgan_paint_plane_matches_jax(cgan_pair, shape):
    jp, pp = cgan_pair
    plane = _plane(*shape, seed=4)
    want = jax_spatial.paint_plane(jp, plane, z=1.0)
    _close(spatial.paint_plane(pp, plane, z=1.0), want)


def test_cvae_sample_draws_from_the_generator(cvae_pair):
    _, pp = cvae_pair
    plane = _plane(96, 64)
    draw = lambda seed: spatial.paint_plane(
        pp, plane, 0.5, generator=torch.Generator().manual_seed(seed))
    a, b, c = draw(5), draw(5), draw(6)
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)
    eps = torch.randn(spatial.latent_noise_shape(pp, plane.shape),
                      generator=torch.Generator().manual_seed(5))
    torch.testing.assert_close(spatial.paint_plane(pp, plane, 0.5, eps=eps),
                               a, rtol=0, atol=0)
    with pytest.raises(ValueError, match="latent grid"):
        spatial.paint_plane(pp, plane, 0.5, eps=eps[:-1])


@pytest.mark.parametrize("kind", ["cvae", "cgan"])
def test_halo_sufficiency(cvae_pair, cgan_pair, kind):
    _, pp = cvae_pair if kind == "cvae" else cgan_pair
    h = spatial.required_halo(pp.architecture, kind)
    plane = _plane(160, 96, seed=9)
    eps = (torch.randn(spatial.latent_noise_shape(pp, plane.shape),
                       generator=torch.Generator().manual_seed(7))
           if kind == "cvae" else None)
    a = spatial.paint_plane(pp, plane, 0.5, halo=h, eps=eps)
    b = spatial.paint_plane(pp, plane, 0.5, halo=2 * h, eps=eps)
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("kind", ["cvae", "cgan"])
def test_calibrate_halo_equals_jax(cvae_pair, cgan_pair, kind):
    jp, pp = cvae_pair if kind == "cvae" else cgan_pair
    got = spatial.calibrate_halo(pp, z=0.5)
    want = jax_spatial.calibrate_halo(jp, z=0.5)
    assert got == want
    f = spatial.latent_downsample(pp.architecture)
    assert 0 < got <= spatial.required_halo(pp.architecture, kind)
    assert got % f == 0


def test_mesh_raises(cvae_pair):
    with pytest.raises(TypeError, match="DeviceMesh"):
        spatial.paint_plane(cvae_pair[1], _plane(64, 64), 0.5, mesh=object())
    with pytest.raises(TypeError, match="DeviceMesh"):
        pipeline.paint_plane_seamless(cvae_pair[1], _plane(8, 8), 0.5, 100.0,
                                      250.0, TILE, mesh=object())


# --------------------------------------------------------------------- #
# the lightcone's seamless path


def _fixture_los(tmp_path):
    """tests/fixtures/slics laid out as the SLICS release lays it out: a
    6^2 massplane at z = 0.042 (a 60 Mpc/h shell) and a 5^2 delta plane at
    z = 0.500 (250 Mpc/h: a 160^2 plane at TILE px per 100 Mpc/h)."""
    for sub, name in (("delta", "0.500delta.dat_bicubic_LOS9"),
                      ("massplanes", "0.042proj_half_finer_xy.dat_LOS9"),
                      ("random_shifts", "random_shift_LOS9")):
        os.makedirs(tmp_path / sub, exist_ok=True)
        shutil.copy(os.path.join(FIX, name), tmp_path / sub / name)
    return dict(tile_size=100.0, n_pixel_tile=TILE, LOS=9,
                z_SLICS=[0.042, 0.500], delta_size=np.array([60.0, 250.0]),
                delta_path=str(tmp_path / "delta"),
                massplane_path=str(tmp_path / "massplanes"),
                shifts_path=str(tmp_path / "random_shifts"),
                z_slice=[0.02, 0.45], verbose=False, n_pixel_delta=5,
                n_pixel_massplane=6, massplane_size=150.0, seamless=True)


def test_process_slics_seamless_cgan_matches_jax(cgan_pair, tmp_path):
    jp, pp = cgan_pair
    los = _fixture_los(tmp_path)
    want = jax_pipe.process_slics(jp, **los)
    stages = pipeline.StageTimes("cpu")
    got = pipeline.process_slics(pp, stage_times=stages, **los)
    assert [p.shape for p in got] == [(38, 38), (160, 160)]
    for g, w in zip(got, want):
        _golden_close(g, w)
    # the shell is the whole zoomed plane painted in one pass
    plane = slics_io.load_delta_plane(
        slics_io.delta_filename(los["delta_path"], 0.5, 9), n_pixel=5)
    zoomed = resize_spline(torch.as_tensor(plane)[None], (160, 160),
                           order=3, mode="wrap")[0]
    np.testing.assert_array_equal(
        got[1], spatial.paint_plane(pp, zoomed, 0.45).numpy())
    assert [s for s, _ in stages.intervals()] == [
        "setup", "upload", "zoom", "paint", "blend", "upload", "zoom",
        "paint"]


def test_process_slics_seamless_cvae_matches_jax(cvae_pair, tmp_path,
                                                 monkeypatch):
    """Each shell's noise: the port seeds its generator with 1000 * LOS + i
    as JAX keys the shell; JAX's draw for that key is handed to the port."""
    jp, pp = cvae_pair
    los = _fixture_los(tmp_path)
    want = jax_pipe.process_slics(jp, **los)
    paint, seeds = spatial.paint_plane, []

    def with_jax_noise(painter, plane, z, generator=None, **kw):
        seeds.append(generator.initial_seed())
        eps = _jax_eps(jp, tuple(plane.shape), seeds[-1])
        return paint(painter, plane, z, eps=eps, **kw)

    monkeypatch.setattr(spatial, "paint_plane", with_jax_noise)
    got = pipeline.process_slics(pp, **los)
    assert seeds == [1000 * 9 + 1]
    for g, w in zip(got, want):
        _golden_close(g, w)
    monkeypatch.undo()
    own = [pipeline.process_slics(pp, **los)[1] for _ in range(2)]
    np.testing.assert_array_equal(own[0], own[1])
    assert not np.allclose(own[0], got[1], rtol=1e-3)


def test_process_slics_seamless_refusals(cvae_pair, tmp_path):
    los = _fixture_los(tmp_path)
    with pytest.raises(ValueError, match="regularise"):
        pipeline.process_slics(cvae_pair[1], regularise=True, **los)
    fused = cvae_pair[1]
    fused._fused_inference = True
    try:
        with pytest.raises(ValueError, match="fused"):
            pipeline.process_slics(fused, **los)
    finally:
        fused._fused_inference = False
