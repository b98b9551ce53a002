"""The port's fused-layout conversion and CVAE eval methods against the JAX
package.

A small fiducial architecture (64^2 tiles, 2 residual blocks) is initialized
with random flax parameters and random running statistics; the port gets the
same variables through its converter. Compared: fuse_cvae_variables (exact:
it only renames), the prior heads, the decoder P at a fixed latent, sample_P
with injected noise, and the painter in all three z_modes, fused and unfused.
Tolerance 3e-4 (rtol and atol), as tests/test_torch_oracle_cvae.py uses for
the same nets: f32 convolutions summed in another order through ~15 layers.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baryon_painter_tpu.models.cvae import CVAE as JaxCVAE
from baryon_painter_tpu.models.cvae import \
    fiducial_cvae_architecture as jax_arch
from baryon_painter_tpu.models.fuse import \
    fuse_cvae_variables as jax_fuse
from baryon_painter_tpu.transforms import FieldStats as JaxStats
from baryon_painter_tpu.transforms import RangeCompress as JaxRC
from baryon_painter_tpu_torch.convert import from_jax_variables
from baryon_painter_tpu_torch.models.cvae import fiducial_cvae_architecture
from baryon_painter_tpu_torch.models.fuse import fuse_cvae_variables
from baryon_painter_tpu_torch.painter import CVAEPainter

TILE = 64
TOL = 3e-4
STATS = {"z_grid": [0.0, 0.5, 1.0, 2.0], "mean": [0.5, 0.8, 1.1, 1.5],
         "var": [0.3, 0.5, 0.9, 1.6]}
TRANSFORM = {"type": "range_compress", "mode": "shift-log", "k": 4.0,
             "eps": 1e-4, "sqrt_of_mean": False}


def _random_stats(tree, rng):
    """Running means ~N(0, 0.1^2) and variances ~U(0.5, 1.5): nontrivial,
    and mild enough that the random net's output still depends on z."""
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out[k] = _random_stats(v, rng)
        elif k.endswith("mean"):
            out[k] = (0.1 * rng.standard_normal(v.shape)).astype(np.float32)
        else:
            out[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def setup():
    arch = jax_arch(tile_size=TILE, n_res_blocks=2)
    model = JaxCVAE(arch)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, TILE, TILE, 1)).astype(np.float32)
    y = np.exp(rng.standard_normal((2, TILE, TILE))).astype(np.float32)
    zs = np.array([0.3, 1.4], np.float32)
    variables = model.init({"params": jax.random.PRNGKey(0),
                            "sample": jax.random.PRNGKey(1)},
                           jnp.asarray(x), jnp.asarray(x), zs, train=False)
    np_vars = {"params": jax.tree.map(np.asarray, variables["params"]),
               "batch_stats": _random_stats(variables["batch_stats"], rng)}
    eps = rng.standard_normal((2, 1, TILE // 32, TILE // 32)).astype(
        np.float32)
    return {"arch": arch, "model": model, "vars": np_vars, "y": y, "zs": zs,
            "eps": eps}


def _nchw(a):
    return np.asarray(a).transpose(0, 3, 1, 2)


def _t(a):  # NHWC numpy -> NCHW torch
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_architecture_matches_jax():
    assert fiducial_cvae_architecture(tile_size=128, n_res_blocks=3,
                                      upsample="resize") == \
        jax_arch(tile_size=128, n_res_blocks=3, upsample="resize")


def _same_tree(a, b):
    assert isinstance(a, dict) == isinstance(b, dict)
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same_tree(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_fuse_cvae_variables_matches_jax(setup):
    got, got_arch = fuse_cvae_variables(setup["vars"], setup["arch"])
    want, want_arch = jax_fuse(setup["vars"], setup["arch"])
    assert got_arch == want_arch and got_arch["fused_res_blocks"]
    _same_tree(got, want)
    assert "FusedResBlock_1" in got["params"]["p_y_z_in"]
    assert not any(k.startswith("ResidualBlock")
                   for k in got["params"]["p_y_z_in"])


@pytest.mark.parametrize("fused", [False, True])
def test_prior_and_decoder_match_jax(setup, fused):
    vars_np, arch = setup["vars"], setup["arch"]
    if fused:
        vars_np, arch = fuse_cvae_variables(vars_np, arch)
    jmodel = JaxCVAE(arch)
    tmodel = from_jax_variables(vars_np, arch)
    y = setup["y"][..., None]
    zs = setup["zs"]
    mu, lv = jmodel.apply(vars_np, jnp.asarray(y), zs, train=False,
                          method=JaxCVAE.prior)
    with torch.no_grad():
        tmu, tlv = tmodel.prior(_t(y), torch.from_numpy(zs))
    _close(tmu.numpy(), _nchw(mu))
    _close(tlv.numpy(), _nchw(lv))

    z = np.random.default_rng(5).standard_normal(
        (2, TILE // 32, TILE // 32, 1)).astype(np.float32)
    jmu, jlv = jmodel.apply(vars_np, jnp.asarray(z), jnp.asarray(y), zs,
                            train=False, method=JaxCVAE.P)
    with torch.no_grad():
        pmu, plv = tmodel.P(_t(z), _t(y), torch.from_numpy(zs))
    _close(pmu.numpy(), _nchw(jmu))
    _close(plv.numpy(), _nchw(jlv))


def test_sample_P_with_injected_noise_matches_jax(setup):
    vars_np, arch = setup["vars"], setup["arch"]
    jmodel = JaxCVAE(arch)
    tmodel = from_jax_variables(vars_np, arch)
    y = setup["y"][..., None]
    zs, eps = setup["zs"], setup["eps"]
    mu, lv = jmodel.apply(vars_np, jnp.asarray(y), zs, train=False,
                          method=JaxCVAE.prior)
    z = mu + jnp.asarray(eps.transpose(0, 2, 3, 1)) * (
        jnp.exp(lv / 2) + arch["min_z_var"])
    want_mu, want_var = jmodel.apply(vars_np, jnp.asarray(y), zs, z=z,
                                     return_var=True, train=False,
                                     method=JaxCVAE.sample_P)
    with torch.no_grad():
        got_mu, got_var = tmodel.sample_P(_t(y), torch.from_numpy(zs),
                                          eps=torch.from_numpy(eps),
                                          return_var=True)
    _close(got_mu.numpy(), _nchw(want_mu))
    _close(got_var.numpy(), _nchw(want_var))


def _jax_paint(setup, z_mode):
    """The JAX painter's _paint with the latent chosen by z_mode; 'sample'
    uses the injected noise (jax.random cannot be matched from torch)."""
    vars_np, arch = setup["vars"], setup["arch"]
    model = JaxCVAE(arch)
    tf = JaxRC("shift-log", 4.0, eps=1e-4)
    st = JaxStats.from_dict(STATS)
    zs = setup["zs"]
    y = tf.forward(jnp.asarray(setup["y"]), st, zs)[..., None]
    mu, lv = model.apply(vars_np, y, zs, train=False, method=JaxCVAE.prior)
    if z_mode == "sample":
        z = mu + jnp.asarray(setup["eps"].transpose(0, 2, 3, 1)) * (
            jnp.exp(lv / 2) + arch["min_z_var"])
    else:
        z = mu if z_mode == "mean" else jnp.zeros_like(mu)
    pred, var = model.apply(vars_np, y, zs, z=z, return_var=True,
                            train=False, method=JaxCVAE.sample_P)
    return np.asarray(tf.inverse(pred[..., 0], st, zs)), np.asarray(
        var[..., 0])


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("z_mode", ["sample", "mean", "zero"])
def test_painter_z_modes_match_jax(setup, z_mode, fused):
    meta = {"model_architecture": setup["arch"], "input_field": "dm",
            "label_fields": ["pressure"], "tile_L": 25.0, "tile_size": TILE,
            "transforms": {"dm": TRANSFORM, "pressure": TRANSFORM},
            "stats": {"dm": STATS, "pressure": STATS}}
    painter = CVAEPainter(variables=setup["vars"], meta=meta,
                          fused_inference=fused, device="cpu")
    eps = setup["eps"] if z_mode == "sample" else None
    got, got_var = painter.paint_batch(setup["y"], setup["zs"],
                                       return_var=True, z_mode=z_mode,
                                       eps=eps)
    want, want_var = _jax_paint(setup, z_mode)
    assert got.shape == (2, TILE, TILE)
    scale = np.abs(want).mean()
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL * scale)
    np.testing.assert_allclose(got_var.numpy(), want_var, rtol=TOL,
                               atol=TOL * np.abs(want_var).mean())


def test_painter_sampling_uses_its_generator(setup, monkeypatch):
    meta = {"model_architecture": setup["arch"], "input_field": "dm",
            "label_fields": ["pressure"], "tile_L": 25.0, "tile_size": TILE,
            "transforms": {"dm": TRANSFORM, "pressure": TRANSFORM},
            "stats": {"dm": STATS, "pressure": STATS}}
    painter = CVAEPainter(variables=setup["vars"], meta=meta, device="cpu")
    drawn = []
    sample_z = painter.model.sample_z
    monkeypatch.setattr(painter.model, "sample_z",
                        lambda mu, lv, eps: drawn.append(eps) or
                        sample_z(mu, lv, eps))
    for gen in (torch.Generator().manual_seed(3),
                torch.Generator().manual_seed(3), None, None):
        painter.paint_batch(setup["y"], setup["zs"], generator=gen)
    assert drawn[0].shape == (2, 1, TILE // 32, TILE // 32)
    assert torch.equal(drawn[0], drawn[1])
    # the painter's own generator advances from call to call
    assert not torch.equal(drawn[0], drawn[2])
    assert not torch.equal(drawn[2], drawn[3])
    with pytest.raises(ValueError, match="z_mode"):
        painter.paint_batch(setup["y"], setup["zs"], z_mode="median")
    with pytest.raises(ValueError, match="eps"):
        painter.paint_batch(setup["y"], setup["zs"], eps=np.zeros((2, 3, 3)))


@pytest.mark.parametrize("n_heads", [1, 2, 3])
def test_heads_fuse_only_with_exactly_two_specs(n_heads):
    """K3 computes two heads: ``_heads_fusable`` accepts the fiducial pair
    and refuses a third spec after them (which a zip over two tails would
    not look at), or a lone mean head."""
    from baryon_painter_tpu_torch.models.cvae import CVAE
    arch = fiducial_cvae_architecture(32, n_res_blocks=1)
    heads = list(arch["p_y_z_out"])
    arch["p_y_z_out"] = tuple((heads + [heads[1]])[:n_heads])
    model = CVAE(arch, fused_heads=True)
    h = torch.zeros(1, 16, 32, 32)
    assert model._heads_fusable(h) is (n_heads == 2)
