"""K4 (``baryon_painter_tpu_torch/ops/conv_bn.py``) against the JAX package's
``fused_conv_bn_relu`` on the CPU, and its shape rules against the JAX
package's.

The JAX side runs its Pallas kernels in interpret mode on the five cases of
``tests/test_pallas_conv_bn.py`` (both families, the stride-4 transposed
conv, planes taller than one 32-row strip), with its 3-window weights built
from the same logical kernel; the port takes that kernel in its own layout
(OIHW for a conv; IOHW, spatially flipped, for a transposed conv). Seeded
numpy inputs, f32. Tolerances: y, mean and var differ by summation order
only (rtol 1e-4, atol 1e-5); every gradient to 2e-4 of its largest entry
(sums over every pixel, in another order).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baryon_painter_tpu.ops import conv_rewrites as cr
from baryon_painter_tpu.ops.pallas_conv_bn import fused_conv_bn_relu
from baryon_painter_tpu_torch.models.layers import BatchNorm
from baryon_painter_tpu_torch.ops import conv_bn as k4
from baryon_painter_tpu_torch.ops import conv_rules

EPS = 1e-5
FWD_TOL = dict(rtol=1e-4, atol=1e-5)
GRAD_TOL = 2e-4

# (kind, x NHWC, w HWIO, s, p): tests/test_pallas_conv_bn.py:55-66
CASES = [
    ("transp", (2, 8, 8, 6), (4, 4, 6, 5), 2, 1),
    ("transp", (2, 4, 4, 3), (8, 8, 3, 2), 4, 2),
    ("s2d", (2, 16, 16, 3), (5, 5, 3, 4), 1, 2),
    ("transp", (1, 40, 12, 3), (4, 4, 3, 4), 2, 1),
    ("transp", (1, 64, 12, 3), (4, 4, 3, 4), 2, 1),
]
IDS = ["transp_s2", "transp_s4", "same_k5", "transp_tall", "transp_2strips"]


def _inputs(xs, ws, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(xs).astype(np.float32)
    w = (rng.standard_normal(ws) * 0.3).astype(np.float32)
    c = ws[-1]
    gamma = rng.uniform(0.5, 1.5, c).astype(np.float32)
    beta = (rng.standard_normal(c) * 0.1).astype(np.float32)
    return x, w, gamma, beta


def _jax(kind, x, w, gamma, beta, s, p):
    if kind == "transp":
        w2 = cr._transp_kernel_3window(w, s, p)
        return fused_conv_bn_relu(x, w2, gamma, beta, 0, s, EPS, True)
    w2 = cr._s2d_kernel_3window(w, 4, p)
    return fused_conv_bn_relu(x, w2, gamma, beta, 4, 4, EPS, True)


def _port_weight(kind, w):
    """HWIO -> OIHW (conv) or the flipped IOHW (transposed conv)."""
    if kind == "transp":
        return np.ascontiguousarray(w[::-1, ::-1].transpose(2, 3, 0, 1))
    return np.ascontiguousarray(w.transpose(3, 2, 0, 1))


def _jax_weight(kind, g):
    g = g.numpy()
    if kind == "transp":
        return g.transpose(2, 3, 0, 1)[::-1, ::-1]
    return g.transpose(2, 3, 1, 0)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _kw(kind, s, p):
    return dict(transposed=kind == "transp", stride=s, padding=p)


def _rel(got, want):
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("kind,xs,ws,s,p", CASES, ids=IDS)
def test_forward_matches_jax(kind, xs, ws, s, p):
    x, w, gamma, beta = _inputs(xs, ws, 0)
    y, mean, var = _jax(kind, jnp.asarray(x), jnp.asarray(w),
                        jnp.asarray(gamma), jnp.asarray(beta), s, p)
    yt, mt, vt = k4.conv_bn_relu(
        _nchw(x), torch.from_numpy(_port_weight(kind, w)),
        torch.from_numpy(gamma), torch.from_numpy(beta), **_kw(kind, s, p))
    assert not mt.requires_grad and not vt.requires_grad
    np.testing.assert_allclose(yt.numpy().transpose(0, 2, 3, 1),
                               np.asarray(y), **FWD_TOL)
    np.testing.assert_allclose(mt.numpy(), np.asarray(mean), **FWD_TOL)
    np.testing.assert_allclose(vt.numpy(), np.asarray(var), **FWD_TOL)


@pytest.mark.parametrize("kind,xs,ws,s,p", CASES, ids=IDS)
def test_gradients_match_jax(kind, xs, ws, s, p):
    x, w, gamma, beta = _inputs(xs, ws, 1)
    y_shape = _jax(kind, jnp.asarray(x), jnp.asarray(w), jnp.asarray(gamma),
                   jnp.asarray(beta), s, p)[0].shape
    cot = np.random.default_rng(2).standard_normal(y_shape).astype(
        np.float32)

    def loss(x_, w_, g_, b_):
        y, mu, var = _jax(kind, x_, w_, g_, b_, s, p)
        return jnp.sum(y * cot) + 0.0 * jnp.sum(
            jax.lax.stop_gradient(mu + var))

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, w, gamma, beta)))
    leaves = [t.requires_grad_() for t in (
        _nchw(x), torch.from_numpy(_port_weight(kind, w)),
        torch.from_numpy(gamma), torch.from_numpy(beta))]
    yt, _, _ = k4.conv_bn_relu(*leaves, **_kw(kind, s, p))
    (yt * _nchw(cot)).sum().backward()
    got = (leaves[0].grad.numpy().transpose(0, 2, 3, 1),
           _jax_weight(kind, leaves[1].grad), leaves[2].grad.numpy(),
           leaves[3].grad.numpy())
    for name, a, b in zip(("dx", "dw", "dgamma", "dbeta"), got, want):
        assert a.shape == b.shape, name
        assert _rel(a, np.asarray(b)) <= GRAD_TOL, name


@pytest.mark.parametrize("kind,xs,ws,s,p", CASES, ids=IDS)
def test_plain_versions_match_autograd_of_the_unfused_layers(kind, xs, ws, s,
                                                             p):
    """conv_bn_relu_ref / conv_bn_relu_bwd_ref (chip_smoke.py's oracle)
    against autograd through the port's unfused conv, BatchNorm and ReLU."""
    x, w, gamma, beta = _inputs(xs, ws, 3)
    kw = _kw(kind, s, p)
    xt, wt = _nchw(x), torch.from_numpy(_port_weight(kind, w))
    gt, bt = torch.from_numpy(gamma), torch.from_numpy(beta)
    y, mean, var = k4.conv_bn_relu_ref(xt, wt, gt, bt, **kw)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(4))
    got = k4.conv_bn_relu_bwd_ref(xt, wt, gt, bt, mean, var, dy,
                                  active=y > 0, **kw)
    bn = BatchNorm(gt.shape[0]).train()
    with torch.no_grad():
        bn.weight.copy_(gt)
        bn.bias.copy_(bt)
    leaves = [t.clone().requires_grad_() for t in (xt, wt)]
    u = k4._conv(*leaves, **kw)
    yu = torch.relu(bn(u))
    (yu * dy).sum().backward()
    torch.testing.assert_close(y, yu.detach(), **FWD_TOL)
    torch.testing.assert_close(mean, u.detach().mean((0, 2, 3)), **FWD_TOL)
    torch.testing.assert_close(bn.running_mean, 0.1 * mean, **FWD_TOL)
    want = (leaves[0].grad, leaves[1].grad, bn.weight.grad, bn.bias.grad)
    for name, a, b in zip(("dx", "dw", "dgamma", "dbeta"), got, want):
        assert _rel(a.numpy(), b.numpy()) <= GRAD_TOL, name


def test_kernel_wrappers_on_the_cpu_are_the_plain_pieces():
    x, w, gamma, beta = _inputs((2, 8, 8, 6), (4, 4, 6, 5), 5)
    kw = _kw("transp", 2, 1)
    xt, wt = _nchw(x), torch.from_numpy(_port_weight("transp", w))
    gt, bt = torch.from_numpy(gamma), torch.from_numpy(beta)
    before = {f: f.launches for f in (k4.conv_bn_stats, k4.conv_bn_fwd,
                                      k4.conv_bn_bwd1, k4.conv_bn_bwd2)}
    y, mean, var = k4.conv_bn_relu_ref(xt, wt, gt, bt, **kw)
    s1, s2, u = k4.conv_bn_stats(xt, wt, **kw)
    torch.testing.assert_close(u, k4._conv(xt, wt, **kw), rtol=0, atol=0)
    n = y.shape[0] * y.shape[2] * y.shape[3]
    torch.testing.assert_close(k4.batch_stats(s1, s2, n), (mean, var))
    inv, a, b = k4.bn_affine(gt, bt, mean, var)
    u_before = u.clone()
    y_k = k4.conv_bn_fwd(u, a, b)
    # in place, as on the card: y is u's storage, the plain version's values
    assert y_k.data_ptr() == u.data_ptr()
    assert torch.equal(y_k, k4.conv_bn_fwd_ref(u_before, a, b))
    torch.testing.assert_close(y_k, y)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(6))
    dx, dw, dg, db = k4.conv_bn_relu_bwd_ref(xt, wt, gt, bt, mean, var, dy,
                                             active=y > 0, **kw)
    g1, g2, u = k4.conv_bn_bwd1(xt, wt, mean, inv, y, dy, **kw)
    torch.testing.assert_close((g2, g1), (dg, db))
    torch.testing.assert_close(
        k4.conv_bn_bwd2(xt, wt, a, mean, inv, g1 / n, g2 / n, u, y, dy,
                        **kw),
        (dx, dw))
    for f, count in before.items():
        assert f.launches == count   # the plain versions launch nothing


@pytest.mark.parametrize("hw,off", [((7, 9), 0), ((7, 9), 3), ((1, 3), 1),
                                    ((3, 1367), 2)])
def test_fwd_on_the_cpu_writes_y_over_u_in_place(hw, off):
    """K4-fwd's contract on the CPU is the card's: y written over u (here a
    view at an offset into a larger buffer), bit for bit the plain version,
    nothing outside u written (``test_torch_cuda.py``'s
    ``test_k4_fwd_takes_any_plane_length_and_offset`` on the card)."""
    g = torch.Generator().manual_seed(0)
    n, c = 2, 5
    size = n * c * hw[0] * hw[1]
    flat = torch.randn(size + 8, generator=g)
    before = flat.clone()
    u = flat[off:off + size].view(n, c, *hw)
    a = torch.rand(c, generator=g) + 0.5
    b = torch.randn(c, generator=g)
    want = k4.conv_bn_fwd_ref(u.clone(), a, b)
    launches = k4.conv_bn_fwd.launches
    y = k4.conv_bn_fwd(u, a, b)
    assert torch.equal(y, want) and y.data_ptr() == u.data_ptr()
    assert torch.equal(flat[off:off + size].view(n, c, *hw), want)
    assert torch.equal(flat[:off], before[:off])
    assert torch.equal(flat[off + size:], before[off + size:])
    assert k4.conv_bn_fwd.launches == launches


def _plain_pieces(kind, xs, ws, s, p, seed):
    """The port's plain forward and the backward's inputs: (x, w, gamma,
    beta, y, mean, var, inv, a, dy, kw)."""
    x, w, gamma, beta = _inputs(xs, ws, seed)
    kw = _kw(kind, s, p)
    xt, wt = _nchw(x), torch.from_numpy(_port_weight(kind, w))
    gt, bt = torch.from_numpy(gamma), torch.from_numpy(beta)
    y, mean, var = k4.conv_bn_relu_ref(xt, wt, gt, bt, **kw)
    inv, a, _ = k4.bn_affine(gt, bt, mean, var)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(seed))
    return xt, wt, gt, bt, y, mean, var, inv, a, dy, kw


@pytest.mark.parametrize("kind,xs,ws,s,p", CASES, ids=IDS)
def test_stats_returns_u_and_its_sums(kind, xs, ws, s, p):
    """K4-stats writes u (y's buffer on the card) beside the sums of u and
    u^2: the plain version (and the CPU wrapper) return the convolution
    itself, the u K4-bwd1 returns, and K4-fwd of it is the plain y."""
    xt, wt, gt, bt, y, mean, var, inv, _, dy, kw = _plain_pieces(kind, xs,
                                                                 ws, s, p, 11)
    s1, s2, u = k4.conv_bn_stats_ref(xt, wt, **kw)
    torch.testing.assert_close(u, k4._conv(xt, wt, **kw), rtol=0, atol=0)
    torch.testing.assert_close(s1, u.sum((0, 2, 3)), rtol=0, atol=0)
    torch.testing.assert_close(s2, (u * u).sum((0, 2, 3)), rtol=0, atol=0)
    _, _, u_bwd1 = k4.conv_bn_bwd1_ref(xt, wt, mean, inv, dy, active=y > 0,
                                       **kw)
    assert torch.equal(u, u_bwd1)
    _, a, b = k4.bn_affine(gt, bt, mean, var)
    assert torch.equal(k4.conv_bn_fwd_ref(u, a, b), y)
    assert torch.equal(k4.conv_bn_stats(xt, wt, **kw)[2], u)


@pytest.mark.parametrize("kind,xs,ws,s,p", CASES, ids=IDS)
def test_bwd1_returns_u_equal_to_the_conv(kind, xs, ws, s, p):
    """K4-bwd1 keeps u for K4-bwd2: the plain version (and the CPU wrapper)
    return the convolution itself beside S1 and S2."""
    xt, wt, _, _, y, mean, _, inv, _, dy, kw = _plain_pieces(kind, xs, ws,
                                                             s, p, 7)
    s1, s2, u = k4.conv_bn_bwd1_ref(xt, wt, mean, inv, dy, active=y > 0,
                                    **kw)
    torch.testing.assert_close(u, k4._conv(xt, wt, **kw), rtol=0, atol=0)
    dv = torch.where(y > 0, dy, 0.0)
    torch.testing.assert_close(s1, dv.sum((0, 2, 3)))
    g1, g2, uw = k4.conv_bn_bwd1(xt, wt, mean, inv, y, dy, **kw)
    torch.testing.assert_close((g1, g2, uw), (s1, s2, u), rtol=0, atol=0)


@pytest.mark.parametrize("kind,xs,ws,s,p", CASES, ids=IDS)
def test_bwd2_from_a_stored_u_equals_bwd2_from_a_recomputed_u(kind, xs, ws,
                                                              s, p):
    xt, wt, _, _, y, mean, _, inv, a, dy, kw = _plain_pieces(kind, xs, ws,
                                                             s, p, 8)
    n = y.shape[0] * y.shape[2] * y.shape[3]
    s1, s2, u = k4.conv_bn_bwd1_ref(xt, wt, mean, inv, dy, active=y > 0,
                                    **kw)
    args = (xt, wt, a, mean, inv, s1 / n, s2 / n, dy)
    stored = k4.conv_bn_bwd2_ref(*args, active=y > 0, u=u, **kw)
    again = k4.conv_bn_bwd2_ref(*args, active=y > 0, **kw)
    torch.testing.assert_close(stored, again, rtol=0, atol=0)
    torch.testing.assert_close(
        k4.conv_bn_bwd2(xt, wt, a, mean, inv, s1 / n, s2 / n, u, y, dy,
                        **kw), stored, rtol=0, atol=0)


@pytest.mark.parametrize("kind,xs,ws,s,p", CASES, ids=IDS)
def test_backward_with_the_forward_mask_matches_jax(kind, xs, ws, s, p):
    """The plain backward with the ReLU mask taken from the forward's y > 0
    (as the kernels take it) against the JAX package's gradients (its
    Pallas kernels in interpret mode), on the port's own forward."""
    x, w, gamma, beta = _inputs(xs, ws, 9)
    y_shape = _jax(kind, jnp.asarray(x), jnp.asarray(w), jnp.asarray(gamma),
                   jnp.asarray(beta), s, p)[0].shape
    cot = np.random.default_rng(10).standard_normal(y_shape).astype(
        np.float32)

    def loss(x_, w_, g_, b_):
        return jnp.sum(_jax(kind, x_, w_, g_, b_, s, p)[0] * cot)

    want = jax.grad(loss, argnums=(0, 1, 2, 3))(
        *(jnp.asarray(a) for a in (x, w, gamma, beta)))
    kw = _kw(kind, s, p)
    xt, wt = _nchw(x), torch.from_numpy(_port_weight(kind, w))
    gt, bt = torch.from_numpy(gamma), torch.from_numpy(beta)
    y, mean, var = k4.conv_bn_relu_ref(xt, wt, gt, bt, **kw)
    dx, dw, dg, db = k4.conv_bn_relu_bwd_ref(xt, wt, gt, bt, mean, var,
                                             _nchw(cot), active=y > 0, **kw)
    got = (dx.numpy().transpose(0, 2, 3, 1), _jax_weight(kind, dw),
           dg.numpy(), db.numpy())
    for name, a, b in zip(("dx", "dw", "dgamma", "dbeta"), got, want):
        assert a.shape == b.shape, name
        assert _rel(a, np.asarray(b)) <= GRAD_TOL, name


@pytest.mark.parametrize("transposed,k,s,p,ok", [
    (False, 5, 1, 2, True), (False, 3, 1, 1, True), (False, 7, 1, 3, True),
    (False, 1, 1, 0, True), (False, 4, 2, 1, False), (False, 5, 1, 1, False),
    (False, 9, 1, 4, False), (True, 4, 2, 1, True), (True, 8, 4, 2, True),
    (True, 3, 2, 1, False), (True, 4, 2, 0, False), (True, 12, 6, 3, False),
])
def test_kernel_family(transposed, k, s, p, ok):
    w = torch.zeros((3, 4, k, k))
    if ok:
        assert k4.kernel_family(None, w, transposed, s, p) == (
            k, s if transposed else 1)
    else:
        with pytest.raises(ValueError, match="kernels take"):
            k4.kernel_family(None, w, transposed, s, p)


def _fwd_operands(shape=(2, 5, 7, 9), c=5):
    return (torch.zeros(shape), torch.ones(c), torch.zeros(c))


@pytest.mark.parametrize("case,exc,match", [
    ("bf16_u", TypeError, "float32"),
    ("f64_a", TypeError, "float32"),
    ("strided_u", ValueError, "contiguous"),
    ("strided_b", ValueError, "contiguous"),
    ("a_elsewhere", ValueError, "is on meta"),
    ("u_3d", ValueError, r"\(N, C, H, W\)"),
    ("a_length", ValueError, r"a must be \(5,\)"),
    ("b_2d", ValueError, r"b must be \(5,\)"),
    ("empty_u", ValueError, "non-empty"),
    ("f16_y", TypeError, "float16"),
])
def test_fwd_check_raises_on_what_k4_fwd_does_not_take(case, exc, match):
    """K4-fwd's operand check (run before a launch on the card): u must be
    f32 (in bf16 too: y is bf16, u f32), contiguous, 4-D and non-empty, a
    and b (C,) f32 contiguous vectors on u's device, y float32 or bfloat16
    (float16 is refused). Nothing is copied: in f32 y is written over u."""
    u, a, b = _fwd_operands()
    dtype = torch.float32
    if case == "bf16_u":
        u = u.bfloat16()
    elif case == "f64_a":
        a = a.double()
    elif case == "strided_u":
        u = torch.zeros(2, 5, 7, 18)[..., ::2]
    elif case == "strided_b":
        b = torch.zeros(10)[::2]
    elif case == "a_elsewhere":
        a = torch.ones(5, device="meta")
    elif case == "u_3d":
        u = u[0]
    elif case == "a_length":
        a = torch.ones(4)
    elif case == "b_2d":
        b = b[:, None]
    elif case == "empty_u":
        u = torch.zeros(0, 5, 7, 9)
    elif case == "f16_y":
        dtype = torch.float16
    with pytest.raises(exc, match=match):
        k4._check_fwd("conv_bn_fwd", u, a, b, dtype)


def test_fwd_check_takes_the_sites_operands():
    for shape in ((24, 16, 512, 512), (24, 64, 128, 128), (1, 5, 7, 9)):
        u = torch.empty(shape, device="meta")
        k4._check_fwd("conv_bn_fwd", u, torch.empty(shape[1], device="meta"),
                      torch.empty(shape[1], device="meta"))


@pytest.mark.parametrize("case,exc,match", [
    ("bf16_x", TypeError, "float32"),
    ("channels", ValueError, "channels"),
    ("family", ValueError, "kernels take"),
    ("grid", ValueError, r"below 2\^31"),
    ("f16_x", TypeError, "float16"),
    ("f16_x_and_w", TypeError, "float16"),
])
def test_stats_check_raises_on_what_k4_stats_does_not_take(case, exc, match):
    """K4-stats' operand check (before a launch on the card), on meta
    tensors: x and w of one dtype, float32 or bfloat16 (a bf16 x with an
    f32 w is refused, and float16), x's channels those of w, the two
    families, and the persistent grids' tile count (16 ceil(W / 16)
    ceil(H / 12) N ceil(max(Cin, Cout) / 8) numbered in an int)."""
    x = torch.empty(2, 3, 16, 16, device="meta")
    w = torch.empty(16, 3, 5, 5, device="meta")
    kw = dict(transposed=False, stride=1, padding=2)
    if case == "bf16_x":
        x = x.bfloat16()
    elif case == "f16_x":
        x = x.half()
    elif case == "f16_x_and_w":
        x, w = x.half(), w.half()
    elif case == "channels":
        x = torch.empty(2, 4, 16, 16, device="meta")
    elif case == "family":
        kw["padding"] = 1
    elif case == "grid":   # 16 x 1 x 2 x N x 2 tiles at 16 x 16, Cout 16
        x = torch.empty(2 ** 25, 3, 16, 16, device="meta")
    with pytest.raises(exc, match=match):
        k4._check("conv_bn_stats", x, w, **kw)
    if case == "bf16_x":   # with a bf16 w it is taken
        k4._check("conv_bn_stats", x, w.bfloat16(), **kw)
    if case == "grid":   # one sample fewer fits
        k4._check("conv_bn_stats",
                  torch.empty(2 ** 25 - 1, 3, 16, 16, device="meta"), w,
                  **kw)


def test_a_bias_raises():
    x, w, gamma, beta = (torch.zeros(1, 3, 8, 8), torch.zeros(4, 3, 3, 3),
                         torch.ones(4), torch.zeros(4))
    with pytest.raises(ValueError, match="bias-free"):
        k4.conv_bn_relu(x, w, gamma, beta, transposed=False, stride=1,
                        padding=1, bias=torch.zeros(4))


def test_shape_rules_are_the_jax_packages():
    for k in (1, 3, 4, 5, 7, 8):
        for s in (1, 2, 4):
            for p in range(0, 5):
                for op in (0, 1):
                    assert (conv_rules.transp_conv_rewrite_applicable(
                        k, s, p, op)
                        == cr.transp_conv_rewrite_applicable(k, s, p, op))
                for h in (16, 64, 128, 130, 512):
                    for cin in (1, 3, 16, 48):
                        assert (conv_rules.s2d_rewrite_applicable(
                            k, s, p, h, h, cin)
                            == cr.s2d_rewrite_applicable(k, s, p, h, h,
                                                         cin))
    from baryon_painter_tpu.ops.conv_rewrites import s2d_rewrite_profitable
    for k in (3, 5, 7):
        for cin in (1, 3, 8, 16, 64):
            for cout in (1, 8, 16, 32, 128):
                assert (conv_rules.s2d_rewrite_profitable(k, cin, cout)
                        == s2d_rewrite_profitable(k, cin, cout))
