"""The port's eval-mode layers against the JAX package's flax layers.

Each case builds the same layer spec as a flax ``SpecSequential`` (JAX
package) and as the port's ``SpecSequential``, carries the flax variables
across with the port's converter (``convert.load_spec_sequential``), runs
the same seeded numpy input (NHWC for flax, NCHW for the port) in eval mode,
and compares. Running statistics are randomized so batch norm's eval path is
really exercised. Tolerance rtol 1e-4 / atol 1e-5: float32 convolutions
summed in another order (XLA's MXU rewrites vs PyTorch's CPU kernels).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baryon_painter_tpu.models import dsl
from baryon_painter_tpu.models.layers import SpecSequential as FlaxSeq
from baryon_painter_tpu.models.layers import merge_aux_label as jax_merge
from baryon_painter_tpu_torch.convert import load_spec_sequential
from baryon_painter_tpu_torch.models import layers as tl


def _run_pair(spec, cin, size=16, batch=2, seed=0, fused=False):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, size, size, cin)).astype(np.float32)
    fseq = FlaxSeq(tuple(map(tuple, spec)), fused_res_blocks=fused)
    variables = fseq.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                          train=False)
    params = variables["params"]
    stats = jax.tree.map(
        lambda a: jnp.asarray(rng.uniform(0.5, 1.5, a.shape), jnp.float32),
        variables.get("batch_stats", {}))
    want = np.asarray(fseq.apply({"params": params, "batch_stats": stats},
                                 jnp.asarray(x), train=False))
    tseq = tl.SpecSequential(spec, fused_res_blocks=fused)
    load_spec_sequential(tseq, jax.tree.map(np.asarray, params),
                         jax.tree.map(np.asarray, stats))
    with torch.no_grad():
        got = tseq(torch.from_numpy(x.transpose(0, 3, 1, 2).copy()))
    return got.numpy().transpose(0, 2, 3, 1), want, tseq


def _close(got, want):
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kernel,scale,bias", [
    (3, 1, True), (5, 1, False), (7, 1, False), (4, 2, False), (8, 4, True)])
def test_conv(kernel, scale, bias):
    spec = dsl.conv_block(3, 5, kernel=kernel, scale=scale, bias=bias,
                          batchnorm=False, activation=None)
    got, want, _ = _run_pair(spec, cin=3, size=32)
    _close(got, want)


@pytest.mark.parametrize("scale,bias", [(2, False), (4, True)])
def test_transposed_conv(scale, bias):
    spec = dsl.conv_block(4, 3, type="transp conv", scale=scale, bias=bias,
                          batchnorm=False, activation=None)
    got, want, _ = _run_pair(spec, cin=4, size=8)
    _close(got, want)


def test_transposed_conv_output_padding():
    spec = [("transp conv", {"in_channels": 2, "out_channels": 3,
                             "kernel_size": 3, "padding": 1, "stride": 2,
                             "output_padding": 1, "bias": True})]
    got, want, _ = _run_pair(spec, cin=2, size=8)
    assert got.shape[1] == 16
    _close(got, want)


def test_batchnorm_eval():
    spec = [("batchnorm", {"num_features": 6})]
    got, want, _ = _run_pair(spec, cin=6)
    _close(got, want)


@pytest.mark.parametrize("activation", ["relu", "leaky relu", "prelu", "tanh",
                                        "sigmoid", "softplus"])
def test_activation(activation):
    spec = dsl.conv_block(2, 4, kernel=3, bias=True, batchnorm=True,
                          activation=activation)
    got, want, _ = _run_pair(spec, cin=2)
    _close(got, want)


def test_upsample_nearest():
    spec = dsl.conv_up(4, [3, 2], [2, 4], mode="resize", bias=False,
                       batchnorm=True, activation="relu")
    got, want, _ = _run_pair(spec, cin=4, size=4)
    assert got.shape[1:3] == (32, 32)
    _close(got, want)


def test_residual_block_unfused():
    spec = [("residual block", dsl.res_block(8))]
    got, want, tseq = _run_pair(spec, cin=8)
    assert isinstance(tseq.layers["ResidualBlock_0"], tl.ResidualBlock)
    _close(got, want)


@pytest.mark.parametrize("slope", [0.0, 0.2])
def test_residual_block_fused(slope):
    """FusedResBlock (K1's plain version on the CPU) against flax's
    FusedResBlock (its XLA path off the TPU), ReLU and LeakyReLU(0.2)."""
    act = "relu" if slope == 0.0 else "leaky relu"
    inner = (dsl.conv_block(8, 8, kernel=3, bias=False, batchnorm=True,
                            activation=act, relu_slope=slope)
             + dsl.conv_block(8, 8, kernel=3, bias=False, batchnorm=True,
                              activation=None))
    outer = ("ReLU",) if slope == 0.0 else ("Leaky ReLU", slope)
    spec = [("residual block", (inner, outer)),
            ("residual block", (inner, outer))]
    got, want, tseq = _run_pair(spec, cin=8, fused=True)
    assert isinstance(tseq.layers["FusedResBlock_1"], tl.FusedResBlock)
    _close(got, want)


def test_mixed_blocks_are_numbered_as_flax_numbers_them():
    """A non-canonical block between canonical ones stays ResidualBlock_0
    while the canonical ones become FusedResBlock_0/1."""
    spec = [("residual block", dsl.res_block(4)),
            ("residual block", dsl.res_block(4, activation="tanh")),
            ("residual block", dsl.res_block(4))]
    got, want, tseq = _run_pair(spec, cin=4, fused=True)
    assert list(tseq.layers) == ["FusedResBlock_0", "ResidualBlock_0",
                                 "FusedResBlock_1"]
    _close(got, want)


def test_merge_aux_label():
    rng = np.random.default_rng(3)
    y = rng.standard_normal((3, 5, 5, 2)).astype(np.float32)
    for aux in (rng.uniform(0, 2, 3).astype(np.float32),
                rng.uniform(0, 2, (3, 2)).astype(np.float32)):
        want = np.asarray(jax_merge(jnp.asarray(y), aux))
        got = tl.merge_aux_label(torch.from_numpy(y.transpose(0, 3, 1, 2)),
                                 torch.from_numpy(aux))
        np.testing.assert_array_equal(got.numpy().transpose(0, 2, 3, 1), want)
    with pytest.raises(ValueError):
        tl.merge_aux_label(torch.zeros(3, 1, 4, 4), torch.zeros(2))


def test_conv_on_too_small_tile_raises():
    seq = tl.SpecSequential(dsl.conv_block(1, 1, scale=4, batchnorm=False,
                                           activation=None))
    with pytest.raises(ValueError, match="too small"):
        seq(torch.zeros(1, 1, 2, 2))


def test_unknown_layer_raises():
    with pytest.raises(NotImplementedError):
        tl.SpecSequential([("lstm", {"out_features": 3})])
