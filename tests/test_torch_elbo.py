"""The port's training ELBO (``CVAE.forward``) against the JAX package's
``CVAE.__call__``, term for term.

A small fiducial architecture (32^2 tiles, one residual block) is
initialised by flax; the port gets the same variables through its converter
and the same latent noise: the JAX ``CVAE.sample_z`` is patched in the test
(and only there) to use the given noise instead of drawing it. Both run in
train mode (batch statistics) on the same seeded numpy inputs. Compared: the
KL, the log-likelihoods (with fixed and free variance), the ELBO, x_mu,
x_var and the updated running statistics, with alpha_var, beta_KL and
sample weights, L = 1 and 2, with the output heads unfused and fused (JAX:
``BPT_FUSED_HEADS=1``, its Pallas kernel in interpret mode; the port:
``fused_heads=True``, K3's plain version on the CPU). Tolerance rtol/atol
2e-4: f32 sums in another order through ~20 layers, and pixel sums over
the batch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baryon_painter_tpu.models import cvae as jcvae
from baryon_painter_tpu_torch.convert import from_jax_variables
from baryon_painter_tpu_torch.models.cvae import fiducial_cvae_architecture

TILE, N = 32, 3
TOL = dict(rtol=2e-4, atol=2e-4)


def patch_sample_z(monkeypatch, eps_nchw):
    """JAX's sample_z with the given noise (L, N, C, h, w) in place of a
    draw; at init (batch 1) the noise of the first sample."""
    def sample_z(self, rng, z_mu, z_log_var, L=1):
        e = jnp.asarray(eps_nchw).transpose(0, 1, 3, 4, 2)
        e = e[:, :z_mu.shape[0]]
        z = z_mu[None] + e * (jnp.exp(z_log_var[None] / 2) + self.min_z_var)
        return z.reshape(-1, *z_mu.shape[1:])
    monkeypatch.setattr(jcvae.CVAE, "sample_z", sample_z)


CASES = {
    "plain": dict(),
    "annealed_weighted": dict(alpha_var=0.3, beta_KL=0.5,
                              sample_weight=[0.5, 1.0, 1.5]),
    "fused_heads": dict(fused=True, alpha_var=0.7, beta_KL=2.0),
    "fused_heads_weighted": dict(fused=True, sample_weight=[2.0, 0.5, 0.5]),
    "L2": dict(L=2, alpha_var=0.5),
    "no_variance_head": dict(predict_var=False, beta_KL=0.5),
}


@pytest.mark.parametrize("case", CASES)
def test_elbo_matches_jax(case, monkeypatch):
    c = dict(CASES[case])
    fused = c.pop("fused", False)
    L = c.pop("L", 1)
    arch = fiducial_cvae_architecture(
        TILE, n_res_blocks=1, predict_var=c.pop("predict_var", True))
    arch = {**arch, "L": L}
    rng = np.random.default_rng(0)
    x = rng.standard_normal((N, TILE, TILE, 1)).astype(np.float32)
    y = np.exp(rng.standard_normal((N, TILE, TILE, 1))).astype(np.float32)
    zs = np.array([0.0, 0.5, 1.0], np.float32)[:N]
    eps = rng.standard_normal((L, N, 1, TILE // 32, TILE // 32)).astype(
        np.float32)
    patch_sample_z(monkeypatch, eps)
    monkeypatch.setenv("BPT_FUSED_HEADS", "1" if fused else "0")

    model = jcvae.CVAE(arch)
    variables = model.init({"params": jax.random.PRNGKey(0),
                            "sample": jax.random.PRNGKey(1)},
                           jnp.asarray(x[:1]), jnp.asarray(y[:1]),
                           jnp.asarray(zs[:1]))
    variables = jax.tree.map(np.asarray, dict(variables))
    sw = c.get("sample_weight")
    out, upd = model.apply(
        variables, jnp.asarray(x), jnp.asarray(y), jnp.asarray(zs),
        alpha_var=c.get("alpha_var", 1.0), beta_KL=c.get("beta_KL", 1.0),
        train=True, sample_weight=None if sw is None else jnp.asarray(sw),
        rngs={"sample": jax.random.PRNGKey(2)}, mutable=["batch_stats"])

    tmodel = from_jax_variables(variables, arch, fused_heads=fused).train()
    nchw = lambda a: torch.from_numpy(a.transpose(0, 3, 1, 2).copy())
    with torch.no_grad():
        got = tmodel(nchw(x), nchw(y), torch.from_numpy(zs),
                     alpha_var=c.get("alpha_var", 1.0),
                     beta_KL=c.get("beta_KL", 1.0), sample_weight=sw,
                     eps=torch.from_numpy(eps))
    assert tmodel._heads_fusable(torch.zeros(1, 16, TILE, TILE)) == fused
    keys = {"kl", "log_likelihood", "elbo", "x_mu"}
    if arch["p_y_z_out"][1:]:
        keys |= {"log_likelihood_fixed_var", "log_likelihood_free_var",
                 "x_var"}
    assert set(got) == keys == set(out)
    for k in keys:
        want = np.asarray(out[k])
        g = got[k].numpy()
        if g.ndim == 4:
            g = g.transpose(0, 2, 3, 1)
        assert g.shape == want.shape, k
        np.testing.assert_allclose(g, want, **TOL, err_msg=k)
    from baryon_painter_tpu_torch.convert import to_jax_variables
    stats = to_jax_variables(tmodel)["batch_stats"]
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b, **TOL),
                 stats, jax.tree.map(np.asarray, upd["batch_stats"]))


def test_heads_gate_follows_the_jax_gate():
    """The same configurations take the fused path: tile %4, >= 32, the
    canonical head specs."""
    from baryon_painter_tpu_torch.models.cvae import CVAE
    arch = fiducial_cvae_architecture(64, n_res_blocks=1)
    model = CVAE(arch, fused_heads=True)
    fusable = lambda h, w: model._heads_fusable(torch.zeros(1, 16, h, w))
    assert fusable(64, 64) and fusable(32, 36)
    assert not fusable(28, 28) and not fusable(34, 64)
    assert not CVAE(arch)._heads_fusable(torch.zeros(1, 16, 64, 64))
    heads = list(arch["p_y_z_out"])
    heads[1] = heads[1] + [("softplus",)]
    assert not CVAE({**arch, "p_y_z_out": tuple(heads)},
                    fused_heads=True)._heads_fusable(
        torch.zeros(1, 16, 64, 64))
    assert not CVAE(fiducial_cvae_architecture(64, predict_var=False),
                    fused_heads=True)._heads_fusable(
        torch.zeros(1, 16, 64, 64))
