"""K3 (the fused output heads): the port's plain versions against the JAX
package's Pallas kernel (interpret mode) and XLA version, forward and
backward (recomputing u1, or from the u1 the forward keeps), the wrapper's
CPU dispatch, and where ``head_stack`` keeps u1. The CUDA kernels themselves
are held against the plain versions on the card by tests/test_torch_cuda.py
and chip_smoke.py.

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
    y, u1 = k3.head_stack_fwd(*targs, keep_u1=True)
    for got in (k3.head_stack_ref(*targs), k3.head_stack_fwd(*targs),
                k3.head_stack(*targs), y):
        assert got.shape == (shape[0], 2, shape[1], shape[2])
        for want in (want_pallas, want_xla):
            np.testing.assert_allclose(got.detach().numpy(), want,
                                       rtol=2e-5, atol=2e-5)
    assert k3.head_stack_fwd.launches == before   # the CPU launches nothing
    assert k3.head_stack_fwd.kept_u1 == 0
    # the kept u1: (N, H, W, 16), channel 8 h + c, each head's conv7
    assert u1.shape == (shape[0], shape[1], shape[2], 16)
    xc = targs[0].permute(0, 3, 1, 2)
    for h in range(2):
        conv7 = torch.nn.functional.conv2d(
            xc, targs[1][h].permute(3, 2, 0, 1), padding=3)
        torch.testing.assert_close(u1[..., 8 * h:8 * h + 8],
                                   conv7.permute(0, 2, 3, 1), rtol=0, atol=0)


@pytest.mark.parametrize("u1", ["recomputed", "kept"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_backward_matches_jax_grad_of_the_pallas_kernel(shape, u1):
    """The plain backward, recomputing u1 or from the u1 the forward keeps
    (PReLU1's mask and conv5's input taken from it, as K3-bwd does),
    against JAX's gradient of its Pallas kernel."""
    args, dy = _inputs(*shape, seed=1)
    jargs = [jnp.asarray(a) for a in args]
    want = jax.grad(lambda *a: jnp.sum(jax_head_stack(*a, PADS, True) * dy),
                    argnums=(0, 1, 2, 3, 4))(*jargs)
    targs = [torch.from_numpy(a) for a in args]
    kept = (k3.head_stack_ref(*targs, keep_u1=True)[1] if u1 == "kept"
            else None)
    got = k3.head_stack_bwd_ref(*targs, torch.from_numpy(dy), u1=kept)
    before = k3.head_stack_bwd.launches
    via_wrapper = k3.head_stack_bwd(*targs, torch.from_numpy(dy), u1=kept)
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


def test_head_stack_keeps_u1_only_under_autograd(monkeypatch):
    """Under autograd with an input that requires a gradient ``head_stack``
    asks the forward to keep u1 and hands that same u1 to the backward;
    under ``torch.inference_mode`` (the painter), ``no_grad`` or with no
    input requiring a gradient it keeps none."""
    calls = {"fwd": [], "bwd": []}
    fwd, bwd = k3.head_stack_fwd, k3.head_stack_bwd

    def spy_fwd(*a, keep_u1=False):
        out = fwd(*a, keep_u1=keep_u1)
        calls["fwd"].append(out[1] if keep_u1 else None)
        return out

    def spy_bwd(*a, u1=None):
        calls["bwd"].append(u1)
        return bwd(*a, u1=u1)

    monkeypatch.setattr(k3, "head_stack_fwd", spy_fwd)
    monkeypatch.setattr(k3, "head_stack_bwd", spy_bwd)
    args, dy = _inputs(1, 16, 16, seed=4)
    plain = [torch.from_numpy(a) for a in args]
    leaves = [t.clone().requires_grad_() for t in plain]
    with torch.inference_mode():
        k3.head_stack(*leaves)
    with torch.no_grad():
        k3.head_stack(*leaves)
    k3.head_stack(*plain)
    assert calls["fwd"] == [None] * 3
    y = k3.head_stack(*leaves)
    (y * torch.from_numpy(dy)).sum().backward()
    assert len(calls["fwd"]) == 4 and len(calls["bwd"]) == 1
    assert calls["bwd"][0] is calls["fwd"][3]
    assert calls["bwd"][0].shape == (1, 16, 16, 16)


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
    """163 GFLOP forward, 331 GFLOP backward at (24, 512, 512), both heads
    (the backward from the kept u1: u2 recomputed, the gradients of the
    three convs): >= 2.43 and 4.94 ms at 67 TFLOP/s, bound by operations.
    On the tensor cores the forward's 7x7 GEMM, 158 GFLOP, takes >= 0.957
    ms at 495/3 TFLOP/s and the rest, 5.3 GFLOP, >= 0.079 ms on the CUDA
    cores: 1.035 ms (``fwd_tc``), against x read and y and u1 written (0.26
    ms at 3.35 TB/s). The backward's two 7x7 GEMMs (dx, dw1), 316 GFLOP,
    take >= 1.913 ms and the rest, 15.6 GFLOP, >= 0.232 ms: 2.145 ms
    (``bwd_tc``), against x, u1 and dy read, dx written and the partials:
    264 chain blocks' of dw2, dw3 and dalpha, 132 splits' of dw1."""
    b = smoke.k3_bounds(24, 512, 512)
    pix = 24 * 512 * 512
    weights = 2 * (7 * 7 * 16 * 8 + 5 * 5 * 8 + 3 * 3 + 2) * 4
    assert b["fwd"]["flops"] == 2 * pix * 12962
    assert b["bwd"]["flops"] == 2 * pix * 26324
    assert b["fwd"]["bound_by"] == b["bwd"]["bound_by"] == "operations"
    assert b["fwd"]["bound_ms"] == pytest.approx(2.434, rel=1e-3)
    assert b["bwd"]["bound_ms"] == pytest.approx(4.944, rel=1e-3)
    for key, gemm, ms, nbytes in (
            ("fwd_tc", 2 * pix * 2 * 7 * 7 * 16 * 8, 1.035,
             pix * (16 + 2 + 16) * 4 + weights),
            ("bwd_tc", 2 * pix * 2 * 2 * 7 * 7 * 16 * 8, 2.145,
             pix * (16 + 16 + 2 + 16) * 4 + weights
             + 264 * 2 * (200 + 9 + 2) * 4 + 132 * 2 * 6272 * 4)):
        tc = b[key]
        assert tc["flops"] == b[key[:3]]["flops"]
        assert tc["bound_by"] == "operations"
        assert tc["bytes"] == nbytes
        assert tc["bound_ms"] == pytest.approx(
            (gemm / (495e12 / 3) + (tc["flops"] - gemm) / 67e12) * 1e3)
        assert tc["bound_ms"] == pytest.approx(ms, rel=1e-3)
    assert 2 * pix * 2 * 2 * 7 * 7 * 16 * 8 == pytest.approx(315.7e9,
                                                             rel=1e-3)
    paint = smoke.k3_bounds(16, 512, 512, keep_u1=False)["fwd_tc"]
    assert paint["bytes"] == 16 * 512 * 512 * (16 + 2) * 4 + weights
    assert paint["bound_ms"] == pytest.approx(0.690, rel=1e-3)
    assert smoke.k3_bwd_blocks(24, 512, 512) == {"chain": 264, "dw1": 132}
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
