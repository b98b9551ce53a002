"""The port's layers in train mode against the JAX package's, and the weight
conversion both ways and the port's own initialisation.

Train mode: batch norm normalises with the batch statistics (E[x^2] -
E[x]^2, f32) and moves its running averages by momentum 0.9 with the biased
batch variance; PReLU's slope is learned. Each case runs the same seeded
numpy input and the same flax-initialised weights (with random running
statistics) through flax (``train=True``, ``mutable=["batch_stats"]``) and
the port (``.train()``), and compares the output, the updated running
statistics and the gradients of a seeded cotangent: rtol/atol 1e-4, f32
sums in another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baryon_painter_tpu.models import dsl
from baryon_painter_tpu.models.cvae import CVAE as JaxCVAE
from baryon_painter_tpu.models.layers import SpecSequential as FlaxSeq
from baryon_painter_tpu_torch.convert import (from_jax_variables, init_cvae,
                                              load_spec_sequential,
                                              to_jax_variables)
from baryon_painter_tpu_torch.models import layers as tl
from baryon_painter_tpu_torch.models.cvae import (CVAE,
                                                  fiducial_cvae_architecture)

TOL = dict(rtol=1e-4, atol=1e-4)


def _random_stats(tree, rng):
    if isinstance(tree, dict):
        return {k: _random_stats(v, rng) for k, v in tree.items()}
    return rng.uniform(0.5, 1.5, np.shape(tree)).astype(np.float32)


def _train_pair(spec, cin, size=16, batch=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, size, size, cin)).astype(np.float32)
    fseq = FlaxSeq(tuple(map(tuple, spec)))
    variables = fseq.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                          train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = _random_stats(jax.tree.map(np.asarray,
                                       variables.get("batch_stats", {})), rng)

    def fwd(p, xx):
        return fseq.apply({"params": p, "batch_stats": stats}, xx,
                          train=True, mutable=["batch_stats"])

    y, upd = fwd(params, jnp.asarray(x))
    cot = rng.standard_normal(y.shape).astype(np.float32)
    gp, gx = jax.grad(lambda p, xx: jnp.sum(fwd(p, xx)[0] * cot),
                      argnums=(0, 1))(params, jnp.asarray(x))

    tseq = tl.SpecSequential(spec)
    load_spec_sequential(tseq, params, stats)
    tseq.train()
    xt = torch.from_numpy(x.transpose(0, 3, 1, 2).copy()).requires_grad_()
    yt = tseq(xt)
    (yt * torch.from_numpy(cot.transpose(0, 3, 1, 2).copy())).sum().backward()
    return {"y": (yt.detach().numpy().transpose(0, 2, 3, 1), np.asarray(y)),
            "dx": (xt.grad.numpy().transpose(0, 2, 3, 1), np.asarray(gx)),
            "tseq": tseq, "jax_stats": upd.get("batch_stats", {}),
            "jax_grads": jax.tree.map(np.asarray, gp)}


def _export(tseq, grads=False):
    p, s = {}, {}
    from baryon_painter_tpu_torch.convert import _export_spec_sequential
    _export_spec_sequential(
        tseq, (lambda t: t.grad) if grads else (lambda t: t), p, s)
    return p, s


def _assert_trees_close(got, want, **tol):
    assert set(got) == set(want), (set(got), set(want))
    for k in want:
        if isinstance(want[k], dict):
            _assert_trees_close(got[k], want[k], **tol)
        else:
            np.testing.assert_allclose(got[k], np.asarray(want[k]), **tol,
                                       err_msg=k)


CASES = {
    "batchnorm": ([("batchnorm", {"num_features": 6})], 6),
    "conv_bn_prelu": (dsl.conv_block(3, 5, kernel=5, bias=True,
                                     batchnorm=True, activation="PReLU"), 3),
    "transp_conv_bn_relu": (dsl.conv_block(4, 3, type="transp conv",
                                           scale=2, bias=False,
                                           batchnorm=True,
                                           activation="ReLU"), 4),
    "residual_block": ([("residual block", dsl.res_block(8))], 8),
}


@pytest.mark.parametrize("case", CASES)
def test_train_mode_matches_flax(case):
    spec, cin = CASES[case]
    r = _train_pair(spec, cin)
    for key in ("y", "dx"):
        got, want = r[key]
        assert got.shape == want.shape, key
        np.testing.assert_allclose(got, want, **TOL, err_msg=key)
    params, stats = _export(r["tseq"])
    _assert_trees_close(stats, r["jax_stats"], **TOL)
    grads, _ = _export(r["tseq"], grads=True)
    _assert_trees_close(grads, r["jax_grads"], **TOL)


def test_batch_norm_running_stats_move_by_momentum_0_9_and_biased_var():
    bn = tl.BatchNorm(2).train()
    x = torch.randn(4, 2, 5, 5)
    bn(x)
    mean = x.mean(dim=(0, 2, 3))
    var = x.var(dim=(0, 2, 3), unbiased=False)
    torch.testing.assert_close(bn.running_mean, 0.1 * mean)
    torch.testing.assert_close(bn.running_var, 0.9 + 0.1 * var)
    before = bn.running_mean.clone()
    bn.eval()(x)
    assert torch.equal(bn.running_mean, before)


def test_layers_are_built_in_eval_mode():
    seq = tl.SpecSequential(CASES["conv_bn_prelu"][0])
    assert not seq.training and not any(m.training for m in seq.modules())
    assert all(p.requires_grad for p in seq.parameters())


def test_fused_residual_block_is_inference_only():
    block = tl.FusedResBlock(8).train()
    with pytest.raises(NotImplementedError, match="inference-only"):
        block(torch.zeros(1, 8, 4, 4))


@pytest.fixture(scope="module")
def jax_init():
    arch = fiducial_cvae_architecture(32, n_res_blocks=1)
    x = jnp.zeros((1, 32, 32, 1), jnp.float32)
    variables = JaxCVAE(arch).init({"params": jax.random.PRNGKey(0),
                                    "sample": jax.random.PRNGKey(1)},
                                   x, x, jnp.zeros((1,), jnp.float32))
    return arch, jax.tree.map(np.asarray, dict(variables))


def test_variables_round_trip_through_the_port(jax_init):
    arch, variables = jax_init
    model = from_jax_variables(variables, arch)
    back = to_jax_variables(model)
    _assert_trees_close(back, variables, rtol=0, atol=0)


def test_own_initialisation_follows_the_jax_distributions(jax_init):
    arch, variables = jax_init
    model = init_cvae(CVAE(arch), seed=0)
    mine = to_jax_variables(model)
    # the same tree of the same shapes
    jax.tree.map(lambda a, b: np.testing.assert_equal(a.shape, b.shape),
                 mine, variables)
    for sub in ("q_x_in", "p_y_z_in", "p_mu_out"):
        for name, p in mine["params"][sub].items():
            if "kernel" in p:
                k = p["kernel"]
                bound = 1 / np.sqrt(np.prod(k.shape[:3]))
                assert np.abs(k).max() <= bound
                assert np.abs(k).max() > 0.8 * bound
    var_kernels = np.concatenate([
        p["kernel"].ravel() for p in mine["params"]["p_var_out"].values()
        if "kernel" in p])
    assert abs(var_kernels.std() - 0.01) < 0.002
    for name, s in mine["batch_stats"]["p_z_in"].items():
        np.testing.assert_array_equal(s["mean"], 0.0)
        np.testing.assert_array_equal(s["var"], 1.0)
    for p in mine["params"]["p_mu_out"].values():
        if "negative_slope" in p:
            assert p["negative_slope"] == np.float32(0.25)
    again = to_jax_variables(init_cvae(CVAE(arch), seed=0))
    _assert_trees_close(again, mine, rtol=0, atol=0)
    other = to_jax_variables(init_cvae(CVAE(arch), seed=1))
    assert not np.array_equal(other["params"]["q_out"]["Conv2d_0"]["kernel"],
                              mine["params"]["q_out"]["Conv2d_0"]["kernel"])
