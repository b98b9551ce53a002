"""The port's painting over a ``DeviceMesh`` (parallel/mesh.py) on the CPU:
devices repeat (``["cpu"] * n``), so the split, halo and merge logic runs
as it does over cards.

* The sharded tile paint (``lightcone.pipeline.paint_batch_sharded``) of 8
  tiles over 2, 3 and 4 devices equals the port's unsharded paint and the
  JAX package's paint of the same tiles sharded over its 8-device mesh
  (tests/test_sharded_paint.py:22), with the JAX painter's prior noise
  recovered and handed to the port (scripts/make_golden_eps.py's recipe);
  the small fully convolutional CVAE of tests/test_torch_spatial.py,
  random flax weights, batch norm perturbed.
* The lightcone's tiled ``paint_plane`` over a mesh equals its unsharded
  paint from the same painter seed: the sharded path draws the same noise
  (``CVAEPainter.latent_noise``), in f32 and in bf16.
* ``parallel.spatial.paint_plane`` over 2, 3 and 4 devices on a 150 x 91
  plane (150 is not a multiple of the latent factor 4: the plane is
  treated as 152-periodic) equals ``mesh=None`` and the JAX package's
  ``paint_plane(mesh)`` with the same noise (the JAX package's halo ring
  over two devices, its gather path over three and four); the port's
  slabs keep 76, 52 and 40 rows (ceil(152 / n) rounded up to 4), each
  extended by the halo on both sides. The CGAN generator too, against
  ``mesh=None``.

Tolerance: tests/test_torch_spatial.py's (rtol 1e-5, atol 1e-5 of the
largest value), in bf16 relative L2 1e-2 (bf16 chaos between batch sizes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from baryon_painter_tpu.models.cgan import CGANGenerator as JaxGenerator
from baryon_painter_tpu.models.cvae import CVAE as JaxCVAE
from baryon_painter_tpu.painter import CVAEPainter as JaxCVAEPainter
from baryon_painter_tpu.parallel import spatial as jax_spatial
from baryon_painter_tpu_torch.lightcone import pipeline
from baryon_painter_tpu_torch.painter import CGANPainter, CVAEPainter
from baryon_painter_tpu_torch.parallel import spatial
from baryon_painter_tpu_torch.parallel.mesh import DeviceMesh, replicate
from test_torch_spatial import TILE, _meta, _perturbed, mini_cvae_arch

TOL = 1e-5


def _close(got, want):
    got = np.asarray(torch.as_tensor(got).float(), np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=TOL,
                               atol=TOL * np.abs(want).max())


def _cpus(n):
    return DeviceMesh(["cpu"] * n)


@pytest.fixture(scope="module")
def cvae():
    arch = mini_cvae_arch()
    model = JaxCVAE(arch)
    ones = jnp.ones((1, TILE, TILE, 1), jnp.float32)
    v = _perturbed(model.init(jax.random.PRNGKey(0), ones, ones,
                              jnp.zeros((1,)), train=False), 1)
    meta = _meta("cvae", arch)
    return (JaxCVAEPainter(model=model, variables=v, meta=meta), v, meta)


def _tiles(n=8, seed=2):
    rng = np.random.default_rng(seed)
    return (np.abs(rng.lognormal(0.0, 0.8, (n, TILE, TILE))).astype(
        np.float32), np.linspace(0.0, 1.0, n).astype(np.float32))


@pytest.fixture(scope="module")
def jax_sharded_paint(cvae):
    """The JAX painter's paint of 8 tiles sharded over 8 devices, and its
    prior noise (N, h, w)."""
    jp = cvae[0]
    tiles, zs = _tiles()
    rng = jax.random.PRNGKey(0)
    mesh = Mesh(np.array(jax.devices()[:8]), axis_names=("data",))
    sh = NamedSharding(mesh, P("data"))
    out = jp.paint_batch(jax.device_put(jnp.asarray(tiles), sh),
                         jax.device_put(jnp.asarray(zs), sh), rng=rng)
    f = jp.input_field
    y = jp.transforms[f].forward(jnp.asarray(tiles), jp.stats[f],
                                 jnp.asarray(zs))[..., None]
    model, v = jp.model, jp.variables
    z = model.apply(v, y, zs, train=False, rngs={"sample": rng},
                    method=model.sample_prior)
    mu, log_var = model.apply(v, y, zs, train=False, method=model.prior)
    eps = (z - mu) / (jnp.exp(log_var / 2)
                      + jp.architecture.get("min_z_var", 1e-7))
    return np.asarray(out), np.asarray(eps[..., 0], np.float32)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_sharded_tile_paint(cvae, jax_sharded_paint, n):
    _, v, meta = cvae
    want_jax, eps = jax_sharded_paint
    tiles, zs = _tiles()
    tp = CVAEPainter(variables=v, meta=meta, device="cpu")
    t, z = torch.from_numpy(tiles), torch.from_numpy(zs)
    got = pipeline.paint_batch_sharded(tp, t, z, _cpus(n), eps=eps)
    _close(got, tp.paint_batch(t, z, eps=eps))
    _close(got, want_jax)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_tiled_plane_over_a_mesh_draws_the_same_noise(cvae, dtype):
    _, v, meta = cvae
    rng = np.random.default_rng(4)
    delta = np.abs(rng.lognormal(0.0, 0.8, (90, 90))).astype(np.float32)
    kw = dict(z_slice=0.4, tile_size=100.0, delta_size=200.0,
              n_pixel_tile=TILE, min_tile_overlap=0.5, paint_batch_size=4)
    plain = pipeline.paint_plane(
        CVAEPainter(variables=v, meta=meta, device="cpu", dtype=dtype),
        delta, **kw)
    sharded = pipeline.paint_plane(
        CVAEPainter(variables=v, meta=meta, device="cpu", dtype=dtype),
        delta, mesh=_cpus(2), **kw)
    if dtype is None:
        _close(sharded, plain)
    else:
        d = np.linalg.norm(sharded - plain) / np.linalg.norm(plain)
        assert d < 1e-2, d


def _plane(rows=150, cols=91, seed=3):
    rng = np.random.default_rng(seed)
    return np.abs(rng.lognormal(0.0, 0.8, (rows, cols))).astype(np.float32)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_paint_plane_over_a_mesh(cvae, n):
    jp, v, meta = cvae
    tp = CVAEPainter(variables=v, meta=meta, device="cpu")
    plane = _plane()
    rng = jax.random.PRNGKey(3)
    mesh = Mesh(np.array(jax.devices()[:n]), axis_names=("data",))
    want = np.asarray(jax_spatial.paint_plane(jp, plane, 0.5, mesh=mesh,
                                              rng=rng))
    f = spatial.latent_downsample(tp.architecture)
    eps = np.asarray(jax.random.normal(
        rng, spatial.latent_noise_shape(tp, plane.shape), jnp.float32))
    halo = spatial._round_up(spatial.required_halo(tp.architecture), f)
    slabs, _, rows = spatial._mesh_slabs(torch.zeros(152, 92), None, n,
                                         halo, f)
    assert rows == {2: 76, 3: 52, 4: 40}[n]
    assert [s.shape for s in slabs] == [(rows + 2 * halo, 92 + 2 * halo)] * n
    got = spatial.paint_plane(tp, plane, 0.5, mesh=_cpus(n), eps=eps)
    _close(got, spatial.paint_plane(tp, plane, 0.5, eps=eps))
    _close(got, want)


@pytest.mark.parametrize("n", [2, 3])
def test_cgan_paint_plane_over_a_mesh(n):
    arch = {"in_channels": 2, "n_res_blocks": 1, "upsample": "transpose"}
    gen = JaxGenerator(n_res_blocks=1)
    v = _perturbed(gen.init(jax.random.PRNGKey(0),
                            jnp.ones((1, TILE, TILE, 1), jnp.float32),
                            jnp.zeros((1,)), train=False), 2)
    tp = CGANPainter(variables=v, meta=_meta("cgan", arch), device="cpu")
    plane = _plane(100, 70)
    got = spatial.paint_plane(tp, plane, 0.5, mesh=_cpus(n))
    _close(got, spatial.paint_plane(tp, plane, 0.5))


def test_replicate_reuses_the_painter_on_its_own_device(cvae):
    """``replicate`` keeps the painter on its own device and makes each
    other device's copy once; a copy (``replica``, what a mesh over
    distinct cards makes) paints what the painter paints, with a model of
    its own."""
    _, v, meta = cvae
    tp = CVAEPainter(variables=v, meta=meta, device="cpu")
    mesh = _cpus(3)
    copies = replicate(tp, mesh)
    assert list(copies) == [torch.device("cpu")]
    assert copies[torch.device("cpu")] is tp
    assert replicate(tp, mesh) is copies
    tiles, zs = _tiles(4)
    eps = np.random.default_rng(0).standard_normal(
        (4, TILE // 4, TILE // 4)).astype(np.float32)
    rep = tp.replica("cpu")
    assert rep.model is not tp.model and rep.device == tp.device
    _close(rep.paint_batch(tiles, zs, eps=eps),
           tp.paint_batch(tiles, zs, eps=eps))
    arch = {"in_channels": 2, "n_res_blocks": 1, "upsample": "transpose"}
    gv = _perturbed(JaxGenerator(n_res_blocks=1).init(
        jax.random.PRNGKey(0), jnp.ones((1, TILE, TILE, 1), jnp.float32),
        jnp.zeros((1,)), train=False), 2)
    gp = CGANPainter(variables=gv, meta=_meta("cgan", arch), device="cpu")
    grep_ = gp.replica("cpu")
    assert grep_.generator is not gp.generator
    _close(grep_.paint_batch(tiles, zs), gp.paint_batch(tiles, zs))
