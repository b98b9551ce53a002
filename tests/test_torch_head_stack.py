"""K3 (the fused output heads): the port's plain versions against the JAX
package's Pallas kernel (interpret mode) and XLA version, forward and
backward, and the wrapper's CPU dispatch. The CUDA kernels themselves are
held against the plain versions on the card by tests/test_torch_cuda.py and
chip_smoke.py.

Inputs are seeded numpy arrays handed to both frameworks, at the kernel's
channel counts (16 -> 8 -> 1 -> 1, 2 heads) and small images. Tolerances
are the JAX package's own (tests/test_pallas_head_stack.py): rtol/atol 2e-5
for the forward, rtol 5e-4 and atol 5e-5 for the gradients, f32 sums in
another order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baryon_painter_tpu.ops.pallas_head_stack import \
    head_stack as jax_head_stack
from baryon_painter_tpu.ops.pallas_head_stack import head_stack_xla
from baryon_painter_tpu_torch import smoke
from baryon_painter_tpu_torch.ops import head_stack as k3

PADS = (3, 2, 1)
GRADS = ("dx", "dw1", "dw2", "dw3", "dalphas")


def _inputs(n, h, w, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, 16)).astype(np.float32)
    w1 = (rng.standard_normal((2, 7, 7, 16, 8)) * 0.2).astype(np.float32)
    w2 = (rng.standard_normal((2, 5, 5, 8, 1)) * 0.2).astype(np.float32)
    w3 = (rng.standard_normal((2, 3, 3, 1, 1)) * 0.5).astype(np.float32)
    al = rng.uniform(0.1, 0.5, (2, 2)).astype(np.float32)
    dy = rng.standard_normal((n, 2, h, w)).astype(np.float32)
    return (x, w1, w2, w3, al), dy


SHAPES = [(2, 16, 16), (1, 12, 20)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_forward_matches_pallas_and_xla(shape):
    args, _ = _inputs(*shape, seed=0)
    jargs = [jnp.asarray(a) for a in args]
    want_pallas = np.asarray(jax_head_stack(*jargs, PADS, True))
    want_xla = np.asarray(head_stack_xla(*jargs, PADS))
    targs = [torch.from_numpy(a) for a in args]
    before = k3.head_stack_fwd.launches
    for got in (k3.head_stack_ref(*targs), k3.head_stack_fwd(*targs),
                k3.head_stack(*targs)):
        assert got.shape == (shape[0], 2, shape[1], shape[2])
        for want in (want_pallas, want_xla):
            np.testing.assert_allclose(got.detach().numpy(), want,
                                       rtol=2e-5, atol=2e-5)
    assert k3.head_stack_fwd.launches == before   # the CPU launches nothing


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_backward_matches_jax_grad_of_the_pallas_kernel(shape):
    args, dy = _inputs(*shape, seed=1)
    jargs = [jnp.asarray(a) for a in args]
    want = jax.grad(lambda *a: jnp.sum(jax_head_stack(*a, PADS, True) * dy),
                    argnums=(0, 1, 2, 3, 4))(*jargs)
    targs = [torch.from_numpy(a) for a in args]
    got = k3.head_stack_bwd_ref(*targs, torch.from_numpy(dy))
    before = k3.head_stack_bwd.launches
    via_wrapper = k3.head_stack_bwd(*targs, torch.from_numpy(dy))
    assert k3.head_stack_bwd.launches == before
    for name, a, b, c in zip(GRADS, got, want, via_wrapper):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=5e-4,
                                   atol=5e-5, err_msg=name)
        np.testing.assert_array_equal(c.numpy(), a.numpy())


def test_explicit_backward_matches_autograd_of_the_plain_forward():
    args, dy = _inputs(2, 20, 16, seed=2)
    dy = torch.from_numpy(dy)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    (k3.head_stack_ref(*leaves) * dy).sum().backward()
    got = k3.head_stack_bwd_ref(*[torch.from_numpy(a) for a in args], dy)
    for name, a, b in zip(GRADS, got, leaves):
        torch.testing.assert_close(a, b.grad, rtol=5e-4, atol=5e-5,
                                   msg=name)


def test_autograd_function_runs_the_explicit_backward_on_the_cpu():
    args, dy = _inputs(1, 16, 16, seed=3)
    dy = torch.from_numpy(dy)
    leaves = [torch.from_numpy(a).requires_grad_() for a in args]
    (k3.head_stack(*leaves) * dy).sum().backward()
    want = k3.head_stack_bwd_ref(*[torch.from_numpy(a) for a in args], dy)
    for name, a, b in zip(GRADS, want, leaves):
        torch.testing.assert_close(b.grad, a, rtol=0, atol=0, msg=name)


def test_kink_free_cotangent_zeroes_only_near_the_kink():
    x, w1, w2, w3, al, dy = smoke.head_inputs(2, 32, 32, "cpu")
    kept, zeroed = smoke.kink_free_cotangent(x, w1, w2, w3, al, dy, rel=1e-4)
    assert 0 < zeroed < 0.5
    changed = kept != dy
    assert torch.all(kept[changed] == 0)
    assert abs(changed.float().mean().item() - zeroed) < 1e-6
    # the default, narrower band around the kink zeroes less
    _, narrower = smoke.kink_free_cotangent(x, w1, w2, w3, al, dy)
    assert narrower < zeroed


def test_bounds_at_the_training_shape():
    """163 GFLOP forward, 489 GFLOP backward at (24, 512, 512), both heads:
    >= 2.43 and 7.30 ms at 67 TFLOP/s, bound by operations. On the tensor
    cores (``bwd_tc``) the backward's three 7x7 GEMMs, 473 GFLOP, take
    >= 2.869 ms at 495/3 TFLOP/s and the rest, 15.6 GFLOP, >= 0.233 ms on
    the CUDA cores: 3.10 ms, against 1,536 blocks' partials and x, dy, dx
    moved once (0.28 ms at 3.35 TB/s)."""
    b = smoke.k3_bounds(24, 512, 512)
    pix = 24 * 512 * 512
    assert b["fwd"]["flops"] == 2 * pix * 12962
    assert b["bwd"]["flops"] == 2 * pix * 38868
    assert b["fwd"]["bound_by"] == b["bwd"]["bound_by"] == "operations"
    assert b["fwd"]["bound_ms"] == pytest.approx(2.434, rel=1e-3)
    assert b["bwd"]["bound_ms"] == pytest.approx(7.300, rel=1e-3)
    tc = b["bwd_tc"]
    gemm = 2 * pix * 3 * 2 * 7 * 7 * 16 * 8
    assert gemm == pytest.approx(473.4e9, rel=1e-3)
    assert tc["flops"] == b["bwd"]["flops"]
    assert tc["bound_by"] == "operations"
    assert tc["bound_ms"] == pytest.approx(
        (gemm / (495e12 / 3) + (tc["flops"] - gemm) / 67e12) * 1e3)
    assert tc["bound_ms"] == pytest.approx(3.102, rel=1e-3)
    assert smoke.k3_bwd_blocks(24, 512, 512) == 24 * 32 * 2
    weights = 2 * (7 * 7 * 16 * 8 + 5 * 5 * 8 + 3 * 3 + 2) * 4
    assert tc["bytes"] == pix * 34 * 4 + (1 + 1536) * weights
    k2b = smoke.k2_bound(24, 2, 512)
    assert k2b["bytes"] == 2 * 24 * 2 * 2 * 512 * 512 * 4
    assert k2b["bound_by"] == "bytes"
    assert k2b["bound_ms"] == pytest.approx(0.0601, rel=1e-2)


def test_library_heads_are_the_same_function():
    x, w1, w2, w3, al, _ = smoke.head_inputs(2, 16, 16, "cpu")
    oihw = lambda w: w.permute(0, 4, 3, 1, 2)
    got = smoke.library_heads(x.permute(0, 3, 1, 2), oihw(w1), oihw(w2),
                              oihw(w3), al)
    torch.testing.assert_close(got, k3.head_stack_ref(x, w1, w2, w3, al),
                               rtol=1e-5, atol=1e-5)
