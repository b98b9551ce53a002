"""K3 (the fused output heads) in bf16: the port's plain bf16 versions
against the JAX package's Pallas kernel in bf16 (interpret mode) and its
gradient, the wrappers' bf16 dispatch, the bounds in bf16, and a plain model
of the bf16 kernels' fragment index rules (csrc/head_stack.cu).

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
    ms; 0.83 GB: >= 0.55 ms."""
    b = smoke.k3_bounds(24, 512, 512, dtype=torch.bfloat16)
    pix = 24 * 512 * 512
    weights = 2 * (7 * 7 * 16 * 8 + 5 * 5 * 8 + 3 * 3 + 2) * 4
    assert b["fwd_tc"]["bytes"] == pix * ((16 + 2) * 2 + 16 * 4) + weights
    assert b["bwd_tc"]["bytes"] == (pix * ((16 + 16 + 2) * 2 + 16 * 4)
                                    + (1 + 1536) * weights)
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


# ---------------------------------------------------------------------- #
# the bf16 kernels' fragment index rules, modelled in numpy
# (csrc/head_stack.cu: kFX, kFXS, kFPB, kLDWF, kBD1, kPD1, kPD1B)

FX, FXS, FPB, LDWF, FA1 = 28, 30, 840, 792, 22
BD1, PD1, PD1B = 22, 488, 488


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16(
        ).float().numpy().astype(np.float64)


def _frag_a(A, g, t):
    """m16n8k16 A registers of lane (g, t): (row, k) pairs of a0..a3."""
    return [((g, 2 * t), (g, 2 * t + 1)), ((g + 8, 2 * t), (g + 8, 2 * t + 1)),
            ((g, 2 * t + 8), (g, 2 * t + 9)),
            ((g + 8, 2 * t + 8), (g + 8, 2 * t + 9))]


def test_fwd_pair_planes_feed_the_u1_gemm_and_hit_every_bank():
    """K3-fwd in bf16: plane q of the staged x holds channels (2 q, 2 q + 1)
    of pixel (ry, rx) at word ry * 30 + rx; GEMM row p (of the tile + 3)
    at tap (ky, kx) reads word (p // 22) * 30 + p % 22 + 30 ky + kx of
    plane tig (a0, a1) and tig + 4 (a2, a3); B word (n, k pair) at
    n * 396 + 8 tap + tig (+ 4). Modelled over a tile, the GEMM is conv7
    of both heads, and a half-warp's loads hit distinct banks."""
    rng = np.random.default_rng(0)
    xr = _bf16(rng.standard_normal((FX, FX, 16)))
    wu = _bf16(rng.standard_normal((16, 784)))
    planes = np.full((8, FPB, 2), np.nan)
    q = (np.arange(FX)[:, None] * FXS + np.arange(FX)[None, :]).ravel()
    for c in range(8):
        planes[c, q, 0] = xr[..., 2 * c].ravel()
        planes[c, q, 1] = xr[..., 2 * c + 1].ravel()
    rows = np.arange(FA1 * FA1)
    qrow = (rows // FA1) * FXS + rows % FA1
    u = np.zeros((rows.size, 16))
    for ky in range(7):
        for kx in range(7):
            tap = 7 * ky + kx
            addr = qrow + ky * FXS + kx
            a = np.concatenate([planes[:, addr, 0].T[:, :, None],
                                planes[:, addr, 1].T[:, :, None]],
                               axis=2).reshape(rows.size, 16)
            u += a @ wu[:, 16 * tap:16 * tap + 16].T
    want = np.zeros((FA1, FA1, 16))
    w = wu.reshape(16, 7, 7, 16)
    for ky in range(7):
        for kx in range(7):
            want += xr[ky:ky + FA1, kx:kx + FA1] @ w[:, ky, kx].T
    np.testing.assert_allclose(u.reshape(FA1, FA1, 16), want, rtol=1e-12,
                               atol=1e-9)
    # banks: lanes (g, tig) of a warp's m16 tile read plane tig at rows g
    for base in range(0, rows.size - 15, 16):
        for tap in (0, 24, 48):
            ky, kx = divmod(tap, 7)
            banks = {(t * FPB + qrow[base + g] + ky * FXS + kx) % 32
                     for g in range(8) for t in range(4)}
            assert len(banks) == 32
    banks = {(n * LDWF // 2 + t) % 32 for n in range(8) for t in range(4)}
    assert len(banks) == 32


def _du1_and_x(rng):
    du1 = _bf16(rng.standard_normal((BD1, BD1, 16)))     # tile + 3, (h, c)
    xr = _bf16(rng.standard_normal((BD1, BD1, 16)))
    return du1, xr


def test_dx_head_split_sums_each_head_then_rounds():
    """K3-bwd's dx in bf16: k16 step = a tap's 16 (h, c); A registers a0,
    a1 hold head 0's channels (2 tig, 2 tig + 1), a2, a3 head 1's; one MMA
    a head with the other's registers zero gives each head's transposed
    conv, rounded to bf16, then summed and rounded: the plain version's
    per-head dx summed in bf16."""
    rng = np.random.default_rng(1)
    du1, _ = _du1_and_x(rng)
    w1 = _bf16(rng.standard_normal((2, 7, 7, 16, 8)) * 0.1)
    wdx = w1.transpose(3, 1, 2, 0, 4).reshape(16, 784)  # [ci][ky, kx, h, c]
    heads = np.zeros((2, 16, 16, 16))
    for r in range(16):
        for col in range(16):
            for ky in range(7):
                for kx in range(7):
                    a = du1[r + 6 - ky, col + 6 - kx]      # (16,) = (h, c)
                    b = wdx[:, 16 * (7 * ky + kx):16 * (7 * ky + kx) + 16]
                    heads[0, r, col] += b[:, :8] @ a[:8]
                    heads[1, r, col] += b[:, 8:] @ a[8:]
    got = _bf16(_bf16(heads[0]) + _bf16(heads[1]))
    xg = torch.zeros(1, 16, 16, 16)
    dx = torch.zeros(1, 16, 16, 16)
    for h in range(2):
        g = torch.from_numpy(du1[None, :, :, 8 * h:8 * h + 8]).permute(
            0, 3, 1, 2).float()
        w = torch.from_numpy(w1[h]).permute(3, 2, 0, 1).float()   # OIHW
        full = torch.nn.grad.conv2d_input((1, 16, 22, 22), w, g, padding=3)
        part = full[:, :, 3:19, 3:19].bfloat16().float()
        dx = (dx + part).bfloat16().float()
    np.testing.assert_allclose(got, dx.permute(0, 2, 3, 1)[0].numpy(),
                               rtol=0, atol=1e-6)
    # A fragment registers of the pair planes: word tig * 488 + pixel;
    # 8 consecutive pixels and 4 planes: 32 banks
    banks = {(t * PD1 + g) % 32 for g in range(8) for t in range(4)}
    assert len(banks) == 32
    del xg


def test_dw1_planar_copies_give_even_pairs_and_the_weight_gradient():
    """K3-bwd's dw1 in bf16: K = a tile row's 16 pixels a k16 step; du1's
    planar copy holds pixel (py, px) at element py * 22 + px + 1, x's two
    copies at py * 22 + px and py * 22 + px + 1; every register's pixel
    pair starts at an even element of the copy it reads, and the product
    is du1^T x over the tile, for every tap."""
    rng = np.random.default_rng(2)
    du1, xr = _du1_and_x(rng)
    dpl = np.full((16, PD1B), np.nan)
    x0 = np.full((16, PD1B), np.nan)
    x1 = np.full((16, PD1B), np.nan)
    p = np.arange(BD1 * BD1)
    for c in range(16):
        dpl[c, p + 1] = du1[..., c].ravel()
        x0[c, p] = xr[..., c].ravel()
        x1[c, p + 1] = xr[..., c].ravel()
    got = np.zeros((49, 16, 16))     # [tap][ci][(h, c)]
    for r in range(16):
        for t in range(4):
            for half in (0, 8):
                a_off = (r + 3) * BD1 + 2 * t + 4 + half
                assert a_off % 2 == 0
                for tap in range(49):
                    ky, kx = divmod(tap, 7)
                    src, off = (x1, 1) if kx % 2 else (x0, 0)
                    b_off = off + (r + ky) * BD1 + 2 * t + kx + half
                    assert b_off % 2 == 0
                    for e in (0, 1):
                        got[tap] += np.outer(src[:, b_off + e],
                                             dpl[:, a_off + e])
    want = np.zeros((49, 16, 16))
    for tap in range(49):
        ky, kx = divmod(tap, 7)
        want[tap] = np.einsum("rcm,rci->im", du1[3:19, 3:19],
                              xr[ky:ky + 16, kx:kx + 16])
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-9)
    # dw1's A loads (8 planes x 4 words) and B loads hit 32 banks
    banks = {(g * PD1B // 2 + t) % 32 for g in range(8) for t in range(4)}
    assert len(banks) == 32
