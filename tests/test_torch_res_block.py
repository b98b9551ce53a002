"""K1 (the fused inference residual block): the port's plain version against
the JAX package's Pallas kernel and XLA version, and the wrapper's CPU
dispatch. The CUDA kernel itself is held against the plain version on the
card by tests/test_torch_cuda.py and chip_smoke.py.

Inputs are seeded numpy arrays handed to both frameworks, at (2, 16, 16, 8)
as tests/test_pallas_ops.py uses. Tolerance rtol/atol 1e-5 in float32 (the
same function, convolutions summed in another order); bfloat16 compares at
2e-2 of the output's scale, since one rounding of the intermediate can flip
by one bf16 ulp (2^-8 relative) when the f32 sums differ in the last bits.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baryon_painter_tpu.ops import pallas_conv
from baryon_painter_tpu_torch.ops import res_block as k1

SHAPE = (2, 16, 16, 8)


def _inputs(shape=SHAPE, seed=0):
    n, h, w, c = shape
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"x": f(n, h, w, c), "w1": 0.1 * f(3, 3, c, c),
            "w2": 0.1 * f(3, 3, c, c),
            "s1": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "b1": 0.1 * f(c),
            "s2": rng.uniform(0.5, 1.5, c).astype(np.float32),
            "b2": 0.1 * f(c)}


_ORDER = ("x", "w1", "s1", "b1", "w2", "s2", "b2")


def _torch_args(d, dtype=torch.float32):
    return [torch.from_numpy(d[k]).to(dtype if k in ("x", "w1", "w2")
                                      else torch.float32)
            for k in _ORDER]


def _jax_args(d, dtype=jnp.float32):
    return [jnp.asarray(d[k], dtype if k in ("x", "w1", "w2")
                        else jnp.float32) for k in _ORDER]


@pytest.mark.parametrize("slope", [0.0, 0.2])
def test_plain_version_matches_pallas_kernel_interpret(slope):
    d = _inputs()
    want = np.asarray(pallas_conv.res_block_infer(
        *_jax_args(d), interpret=True, inner_slope=slope, outer_slope=slope))
    got = k1.res_block_infer_ref(*_torch_args(d), inner_slope=slope,
                                 outer_slope=slope).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if slope == 0.0:
        assert np.all(got >= 0)
    else:
        assert np.any(got < 0)


@pytest.mark.parametrize("slope", [(0.0, 0.0), (0.2, 0.2), (0.0, 0.2)])
def test_plain_version_matches_xla_version(slope):
    d = _inputs(seed=1)
    want = np.asarray(pallas_conv.res_block_infer_xla(
        *_jax_args(d), inner_slope=slope[0], outer_slope=slope[1]))
    got = k1.res_block_infer_ref(*_torch_args(d), inner_slope=slope[0],
                                 outer_slope=slope[1]).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_plain_version_bf16_matches_xla_version():
    d = _inputs(seed=2)
    want = np.asarray(pallas_conv.res_block_infer_xla(
        *_jax_args(d, jnp.bfloat16)).astype(jnp.float32))
    got = k1.res_block_infer_ref(*_torch_args(d, torch.bfloat16))
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    assert err <= 2e-2 * np.abs(want).max()


def test_fold_bn_matches_jax():
    rng = np.random.default_rng(4)
    a = [rng.uniform(0.5, 1.5, 8).astype(np.float32) for _ in range(4)]
    want = pallas_conv.fold_bn(*[jnp.asarray(v) for v in a])
    got = k1.fold_bn(*[torch.from_numpy(v) for v in a])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    args = _torch_args(_inputs())
    before = k1.res_block_infer.launches
    got = k1.res_block_infer(*args, inner_slope=0.2, outer_slope=0.2)
    want = k1.res_block_infer_ref(*args, inner_slope=0.2, outer_slope=0.2)
    assert torch.equal(got, want)
    assert k1.res_block_infer.launches == before


def test_wrapper_refuses_other_devices():
    args = [a.to("meta") for a in _torch_args(_inputs())]
    with pytest.raises(ValueError, match="device"):
        k1.res_block_infer(*args)
