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


def test_split_tf32_is_exact_and_big_is_tf32():
    """The host's 3xTF32 split of the f32 weights: big + small == v exactly,
    big's 13 low mantissa bits are 0, and small is below big's last tf32
    bit (|small| < 2^-10 |big|)."""
    rng = np.random.default_rng(6)
    v = (rng.standard_normal(20000)
         * 10.0 ** rng.uniform(-6, 6, 20000)).astype(np.float32)
    v = torch.from_numpy(v)
    big, small = k1.split_tf32(v)
    assert torch.equal(big + small, v)
    assert int((big.view(torch.int32) & 8191).abs().max()) == 0
    assert bool((small.abs() < 2.0 ** -10 * big.abs()).all())


@pytest.mark.parametrize("dtype,c,cp", [(torch.float32, 12, 12),
                                        (torch.bfloat16, 12, 16),
                                        (torch.bfloat16, 8, 8)],
                         ids=["f32", "bf16_padded", "bf16"])
def test_kernel_operands_layout(dtype, c, cp):
    """res_block_operands: (2 P, C', 9, C') w^T (co, tap 3 ky + kx, ci) in
    x's type, conv1 then conv2 (f32: each conv's big then small half), the
    channels past C zero; the folded BN in f32, zero past C. A bf16 C with
    C % 8 == 4 runs as C + 4 (TMA's 16-byte rows)."""
    d = _inputs((1, 4, 4, c), seed=7)
    w1, s1, b1, w2, s2, b2 = _torch_args(d)[1:]
    ops = k1.res_block_operands(w1, s1, b1, w2, s2, b2, dtype)
    parts = 2 if dtype == torch.float32 else 1
    assert ops.channels == cp == k1.kernel_channels(c, dtype)
    assert tuple(ops.weights.shape) == (2 * parts, cp, 9, cp)
    assert ops.weights.dtype == dtype and ops.weights.is_contiguous()
    for conv, w in enumerate((w1, w2)):
        got = sum(ops.weights[conv * parts + i].float()
                  for i in range(parts))
        want = w.to(dtype).float().permute(3, 0, 1, 2).reshape(c, 9, c)
        assert torch.equal(got[:c, :, :c], want)
        assert not got[c:].any() and not got[:, :, c:].any()
    for got, want in zip(ops[1:5], (s1, b1, s2, b2)):
        assert got.dtype == torch.float32 and torch.equal(got[:c], want)
        assert not got[c:].any()


def test_fused_block_makes_kernel_operands_once():
    """FusedResBlock keeps K1's operands: the same object on every call for
    one type, new ones for another type or after its weights change (as a
    checkpoint load changes them in place), equal to a fresh
    res_block_operands of its weights and folded BN."""
    from baryon_painter_tpu_torch.models.layers import FusedResBlock
    block = FusedResBlock(8).eval()
    sd = {k: torch.from_numpy(
        np.random.default_rng(i).uniform(0.5, 1.5, v.shape).astype(
            np.float32)) for i, (k, v) in enumerate(
                block.state_dict().items())}
    block.load_state_dict(sd)
    first = block.kernel_operands(torch.float32)
    assert block.kernel_operands(torch.float32) is first
    bf16 = block.kernel_operands(torch.bfloat16)
    assert bf16 is not first and bf16.weights.dtype == torch.bfloat16
    s1, b1 = k1.fold_bn(sd["bn1_scale"], sd["bn1_bias"], sd["bn1_mean"],
                        sd["bn1_var"])
    s2, b2 = k1.fold_bn(sd["bn2_scale"], sd["bn2_bias"], sd["bn2_mean"],
                        sd["bn2_var"])
    want = k1.res_block_operands(sd["conv1_kernel"], s1, b1,
                                 sd["conv2_kernel"], s2, b2, torch.bfloat16)
    for g, w in zip(bf16[:5], want[:5]):
        assert torch.equal(g, w)
    block.load_state_dict({k: v * 2 for k, v in sd.items()})
    again = block.kernel_operands(torch.bfloat16)
    assert again is not bf16
    assert not torch.equal(again.weights, bf16.weights)
