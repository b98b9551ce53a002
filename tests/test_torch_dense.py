"""The DSL's ``linear`` and ``flatten`` in the port against the JAX package.

A conv -> flatten -> linear (-> relu -> linear) spec is built as a flax
``SpecSequential`` (JAX package) and as the port's, the flax variables are
carried across with ``convert.load_spec_sequential`` and back with
``to_jax_variables`` / ``train_state_to_jax``, and the same seeded input
runs through both, with and without spectral norm, in eval and train mode,
with the gradients of a seeded cotangent. JAX flattens NHWC, so the port
flattens in (H, W, C) order and a dense kernel (in, out) is ``nn.Linear``'s
weight transposed. Tolerance 1e-5 relative to the output's largest entry
(f32 sums in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baryon_painter_tpu.models.layers import SpecSequential as FlaxSeq
from baryon_painter_tpu_torch.convert import (_export_spec_sequential,
                                              load_spec_sequential)
from baryon_painter_tpu_torch.models import layers as tl

C_IN, C_MID, SIZE = 3, 4, 8
F_IN = C_MID * (SIZE // 2) ** 2


def _spec(bias: bool):
    return (("conv", {"in_channels": C_IN, "out_channels": C_MID,
                      "kernel_size": 3, "stride": 2, "padding": 1,
                      "bias": True}),
            ("flatten",),
            ("linear", {"in_features": F_IN, "out_features": 6,
                        "bias": bias}),
            ("relu",),
            ("linear", {"in_features": 6, "out_features": 5,
                        "bias": True}))


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _close(got, want, rel=1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rel,
                               atol=rel * max(np.abs(want).max(), 1e-30))


def _trees_close(got, want, rel=1e-5):
    assert set(got) == set(want), (set(got), set(want))
    for k in want:
        if isinstance(want[k], dict):
            _trees_close(got[k], want[k], rel)
        else:
            _close(got[k], want[k], rel)


@pytest.mark.parametrize("spectral_norm", [False, True], ids=["plain", "sn"])
@pytest.mark.parametrize("bias", [True, False], ids=["bias", "nobias"])
def test_conv_flatten_linear_against_flax(spectral_norm, bias):
    spec = _spec(bias)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, SIZE, SIZE, C_IN)).astype(np.float32)
    jseq = FlaxSeq(spec, spectral_norm=spectral_norm)
    variables = _np(jseq.init(jax.random.PRNGKey(1), jnp.asarray(x),
                              train=False))
    params, stats = variables["params"], variables.get("batch_stats", {})
    assert params["Dense_0"]["kernel"].shape == (F_IN, 6)

    def fwd(p, train):
        out = jseq.apply({"params": p, "batch_stats": stats},
                         jnp.asarray(x), train=train,
                         mutable=["batch_stats"] if train else False)
        return out if train else (out, {})

    seq = tl.SpecSequential(spec, spectral_norm=spectral_norm)
    load_spec_sequential(seq, params, stats)
    assert list(seq.layers) == ["Conv2d_0", "Dense_0", "Dense_1"]
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    # eval mode
    with torch.no_grad():
        got = seq(xt)
    _close(got.numpy(), fwd(params, False)[0])
    # train mode: the output, spectral norm's new state and the gradients
    jy, mut = fwd(params, True)
    r = rng.standard_normal(jy.shape).astype(np.float32)
    jgrad = _np(jax.grad(lambda p: jnp.sum(fwd(p, True)[0] * r))(params))
    seq.train()
    y = seq(xt)
    _close(y.detach().numpy(), jy)
    (y * torch.from_numpy(r)).sum().backward()
    gp, gs = {}, {}
    _export_spec_sequential(seq, lambda t: t.grad, gp, gs)
    _trees_close(gp, jgrad)
    if spectral_norm:
        _trees_close(gs, _np(mut["batch_stats"]), rel=1e-6)
    # back to the flax layout: the same arrays
    p_back, s_back = {}, {}
    _export_spec_sequential(seq, lambda t: t, p_back, s_back)
    _trees_close(p_back, params, rel=0)


def test_linear_on_channels_and_flatten_order():
    """A dense layer on an (N, C, H, W) input acts on the channels, as
    flax's on NHWC's last axis; flatten takes (H, W, C) order."""
    spec = (("linear", {"in_features": 3, "out_features": 2}),
            ("flatten",))
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 4, 4, 3)).astype(np.float32)
    jseq = FlaxSeq(spec)
    variables = _np(jseq.init(jax.random.PRNGKey(0), jnp.asarray(x),
                              train=False))
    want = np.asarray(jseq.apply(variables, jnp.asarray(x), train=False))
    seq = tl.SpecSequential(spec)
    load_spec_sequential(seq, variables["params"], {})
    with torch.no_grad():
        got = seq(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got.shape == (2, 4 * 4 * 2)
    _close(got.numpy(), want)


def test_linear_needs_in_features():
    with pytest.raises(ValueError, match="in_features"):
        tl.SpecSequential([("linear", {"out_features": 3})])


def test_dense_state_round_trip_and_init():
    """``train_state_to_jax`` carries the dense layers and Adam's moments to
    the flax layout and ``train_state_from_jax`` back, exactly; the port's
    own initialisation draws flax's ``lecun_normal`` and a zero bias."""
    from baryon_painter_tpu_torch.convert import (_init_spec_sequential,
                                                  adam_state_from_jax,
                                                  adam_state_to_jax,
                                                  trainable)

    class Net(torch.nn.Module):
        jax_scopes = ("body",)

        def __init__(self):
            super().__init__()
            self.body = tl.SpecSequential(_spec(True))

    net = Net()
    _init_spec_sequential(net.body, torch.Generator().manual_seed(0))
    d = net.body.layers["Dense_0"]
    assert float(d.bias.detach().abs().max()) == 0.0
    std = np.sqrt(1.0 / F_IN)
    bound = 2 * std / .87962566103423978
    assert float(d.weight.detach().abs().max()) <= bound
    assert abs(float(d.weight.detach().std()) - std) < 0.25 * std
    params = trainable(net)
    mu = [torch.randn(p.shape) for p in params]
    nu = [torch.rand(p.shape) for p in params]
    adam = adam_state_to_jax(net, mu, nu, 3)
    assert adam["0"]["mu"]["body"]["Dense_0"]["kernel"].shape == (F_IN, 6)
    np.testing.assert_array_equal(adam["0"]["mu"]["body"]["Dense_0"][
        "kernel"], mu[2].numpy().T)
    back = adam_state_from_jax(net, adam, {})
    for a, b in zip(back["mu"] + back["nu"], mu + nu):
        assert torch.equal(a, b)
