"""K3 (the fused output heads) in bf16: the port's plain bf16 versions
against the JAX package's Pallas kernel in bf16 (interpret mode) and its
gradient, the wrappers' bf16 dispatch and the bounds in bf16. The bf16
kernels' index rules are modelled with the f32 ones in
``tests/test_torch_head_stack_gemm.py``.

The JAX kernel runs in its input's dtype: x, the weights, v1, v2, the
cotangent, du2 and du1 are cast to bf16 before each product, the products
are summed in f32, PReLU and its slope gradients are f32, y and dx come
back in bf16, dx summed over the heads in bf16. The port's plain versions
round at those points (``ops/head_stack.py``). Each output is held to 2e-2
of its own largest entry (a sum in another order rounds the other way next
to a boundary, one bf16 step, and carries that on), and y and dx also to
half the JAX kernel's own bf16-f32 distance: a port that computed in f32
would sit at that whole distance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baryon_painter_tpu.ops.pallas_head_stack import \
    head_stack as jax_head_stack
from baryon_painter_tpu_torch import smoke
from baryon_painter_tpu_torch.ops import head_stack as k3

PADS = (3, 2, 1)
NAMES = ("y", "dx", "dw1", "dw2", "dw3", "dalphas")
SHAPES = [(2, 16, 16), (1, 12, 20)]


def _inputs(n, h, w, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, 16)).astype(np.float32)
    w1 = (rng.standard_normal((2, 7, 7, 16, 8)) * 0.2).astype(np.float32)
    w2 = (rng.standard_normal((2, 5, 5, 8, 1)) * 0.2).astype(np.float32)
    w3 = (rng.standard_normal((2, 3, 3, 1, 1)) * 0.5).astype(np.float32)
    al = rng.uniform(0.1, 0.5, (2, 2)).astype(np.float32)
    dy = rng.standard_normal((n, 2, h, w)).astype(np.float32)
    return (x, w1, w2, w3, al), dy


def _jax(args, dy, dtype):
    """y and the gradients of sum(y * dy) of the JAX kernel, x in dtype."""
    x, *rest = (jnp.asarray(a) for a in args)
    x = x.astype(dtype)
    f = lambda *a: jax_head_stack(*a, PADS, True)
    y = f(x, *rest)
    grads = jax.grad(lambda *a: jnp.sum(f(*a).astype(jnp.float32) * dy),
                     argnums=(0, 1, 2, 3, 4))(x, *rest)
    return [np.asarray(jnp.asarray(t).astype(jnp.float32))
            for t in (y, *grads)], (y.dtype, grads[0].dtype)


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("u1", ["recomputed", "kept"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_plain_bf16_versions_match_the_jax_kernel_in_bf16(shape, u1):
    args, dy = _inputs(*shape, seed=0)
    want, dtypes = _jax(args, dy, jnp.bfloat16)
    want_f32, _ = _jax(args, dy, jnp.float32)
    assert dtypes == (jnp.bfloat16, jnp.bfloat16)
    x, w1, w2, w3, al = (torch.from_numpy(a) for a in args)
    x = x.bfloat16()
    y, kept = k3.head_stack_ref(x, w1, w2, w3, al, keep_u1=True)
    grads = k3.head_stack_bwd_ref(x, w1, w2, w3, al, torch.from_numpy(dy),
                                  u1=kept if u1 == "kept" else None)
    got = [y, *grads]
    assert [t.dtype for t in got] == [torch.bfloat16, torch.bfloat16] + [
        torch.float32] * 4
    assert kept.dtype == torch.float32
    for name, g, w in zip(NAMES, got, want):
        g = g.float().numpy()
        assert g.shape == w.shape, name
        err = np.abs(g - w).max() / np.abs(w).max()
        assert err <= 2e-2, (name, err)
    for i, name in ((0, "y"), (1, "dx")):
        g = got[i].float().numpy()
        gap = _rel_l2(want_f32[i], want[i])
        assert gap > 1e-4, name       # bf16 is another result than f32
        assert _rel_l2(g, want[i]) <= 0.5 * gap, (name, _rel_l2(g, want[i]),
                                                   gap)


def test_kept_u1_is_f32_and_the_bf16_products_exact():
    """u1 is kept in f32 in bf16 too: the products of the bf16 x and w1 are
    exact in f32, so it is the f32 conv of the rounded operands."""
    args, _ = _inputs(1, 16, 16, seed=1)
    x, w1, w2, w3, al = (torch.from_numpy(a) for a in args)
    _, u1 = k3.head_stack_ref(x.bfloat16(), w1, w2, w3, al, keep_u1=True)
    _, want = k3.head_stack_ref(x.bfloat16().float(), w1.bfloat16().float(),
                                w2, w3, al, keep_u1=True)
    assert u1.dtype == torch.float32
    torch.testing.assert_close(u1, want, rtol=0, atol=0)


def test_wrappers_compute_the_plain_bf16_versions_on_the_cpu():
    args, dy = _inputs(1, 16, 16, seed=2)
    x, w1, w2, w3, al = (torch.from_numpy(a) for a in args)
    x, dy = x.bfloat16(), torch.from_numpy(dy).bfloat16()
    before = (k3.head_stack_fwd.launches, k3.head_stack_fwd.bf16_launches,
              k3.head_stack_bwd.launches, k3.head_stack_bwd.bf16_launches)
    y, u1 = k3.head_stack_fwd(x, w1, w2, w3, al, keep_u1=True)
    y_ref, u1_ref = k3.head_stack_ref(x, w1, w2, w3, al, keep_u1=True)
    assert torch.equal(y, y_ref) and torch.equal(u1, u1_ref)
    for a, b in zip(k3.head_stack_bwd(x, w1, w2, w3, al, dy, u1=u1),
                    k3.head_stack_bwd_ref(x, w1, w2, w3, al, dy, u1=u1)):
        assert torch.equal(a, b)
    assert (k3.head_stack_fwd.launches, k3.head_stack_fwd.bf16_launches,
            k3.head_stack_bwd.launches,
            k3.head_stack_bwd.bf16_launches) == before


def test_autograd_in_bf16_returns_each_gradient_in_its_input_dtype():
    args, dy = _inputs(1, 16, 16, seed=3)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    xb = leaves[0].detach().bfloat16().requires_grad_()
    y = k3.head_stack(xb, *leaves[1:])
    assert y.dtype == torch.bfloat16
    (y.float() * torch.from_numpy(dy)).sum().backward()
    assert xb.grad.dtype == torch.bfloat16
    assert all(t.grad.dtype == torch.float32 for t in leaves[1:])
    want = k3.head_stack_bwd_ref(xb.detach(), *[t.detach()
                                                for t in leaves[1:]],
                                 torch.from_numpy(dy))
    for a, b in zip(want, [xb, *leaves[1:]]):
        assert torch.equal(a, b.grad)


def test_operand_checks_take_f32_and_bf16():
    args, dy = _inputs(1, 16, 16, seed=4)
    x, w1, w2, w3, al = (torch.from_numpy(a) for a in args)
    for dt in (torch.float32, torch.bfloat16):
        k3._check_operands("f", x.to(dt), w1, w2, w3, al,
                           torch.from_numpy(dy).to(dt))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        k3._check_operands("f", x.half(), w1, w2, w3, al)
    with pytest.raises(TypeError, match="w1 must be torch.float32"):
        k3._check_operands("f", x.bfloat16(), w1.bfloat16(), w2, w3, al)
    with pytest.raises(TypeError, match="dy must be torch.bfloat16"):
        k3._check_operands("f", x.bfloat16(), w1, w2, w3, al,
                           torch.from_numpy(dy))


def test_bf16_bounds_at_the_training_shape():
    """In bf16 the 7x7 GEMMs run on the bf16 tensor cores (989 TFLOP/s):
    forward 157.8 GFLOP in 0.160 ms plus 5.3 GFLOP on the CUDA cores in
    0.079 ms; x (201 MB) and y (25 MB) in bf16, u1 (403 MB) in f32:
    >= 0.24 ms. Backward 315.7 GFLOP in 0.319 ms plus 15.6 GFLOP in 0.233
    ms; 0.83 GB and the partials (264 chain blocks' of dw2, dw3 and dalpha,
    132 splits' of dw1): >= 0.55 ms."""
    b = smoke.k3_bounds(24, 512, 512, dtype=torch.bfloat16)
    pix = 24 * 512 * 512
    weights = 2 * (7 * 7 * 16 * 8 + 5 * 5 * 8 + 3 * 3 + 2) * 4
    assert b["fwd_tc"]["bytes"] == pix * ((16 + 2) * 2 + 16 * 4) + weights
    assert b["bwd_tc"]["bytes"] == (pix * ((16 + 16 + 2) * 2 + 16 * 4)
                                    + weights + 264 * 2 * (200 + 9 + 2) * 4
                                    + 132 * 2 * 6272 * 4)
    assert b["fwd_tc"]["bound_ms"] == pytest.approx(0.2381, rel=1e-3)
    assert b["bwd_tc"]["bound_ms"] == pytest.approx(0.5510, rel=1e-3)
    assert b["fwd_tc"]["bound_by"] == b["bwd_tc"]["bound_by"] == "operations"
    gemm = 2 * pix * 2 * 7 * 7 * 16 * 8
    assert b["fwd_tc"]["bound_ms"] == pytest.approx(
        (gemm / 989e12 + (b["fwd"]["flops"] - gemm) / 67e12) * 1e3)


def test_bf16_kink_free_cotangent_uses_the_rounded_chain():
    x, w1, w2, w3, al, dy = smoke.head_inputs(1, 32, 32, "cpu")
    kept, zeroed = smoke.kink_free_cotangent(
        x.bfloat16(), w1, w2, w3, al, dy.bfloat16(), rel=1e-4,
        dtype=torch.bfloat16)
    assert kept.dtype == torch.bfloat16 and 0 < zeroed < 0.5
    assert torch.all(kept[kept != dy.bfloat16()] == 0)
