"""K4 in bf16 (``baryon_painter_tpu_torch/ops/conv_bn.py``) against the JAX
package's ``fused_conv_bn_relu`` in bf16 on the CPU, and numpy models of the
bf16 GEMMs' fragment and index rules (``csrc/conv_bn.cu``).

The JAX side casts x and the logical kernel to bf16 before the 3-window
transform, as ``baryon_painter_tpu/models/layers.py:538-550`` does, and runs
its Pallas kernels in interpret mode, op by op (not jitted), forward and
``jax.vjp`` on a cotangent rounded to bf16, at the five cases of
``tests/test_torch_conv_bn.py``. The port's plain bf16 versions (the
wrappers on CPU tensors) take the same bf16 values. Tolerances, each of
max|port - JAX| / max|JAX|, and what this file's seeds read:

* y within 2e-2 and bit-equal in at least 99.9 % of its elements (all
  equal but 1.3e-4 of ``transp_tall``'s: a sum next to a bf16 rounding
  boundary rounds the other way in another order);
* mean and var within 1e-5 (f32 sums in another order; read <= 3.9e-7);
* dx and dW within 2e-2, one bf16 step (read: 0, but dx 8.2e-5 at
  ``same_k5``);
* dgamma and dbeta within 1e-3 (read <= 6e-7).

Site A's dW (``same_k5``, the space-to-depth site) is a known difference.
JAX's logical dW there is the adjoint of the space-to-depth 3-window
transform (``ops/conv_rewrites.py:125-141``): each logical entry is the
bf16 sum of up to 16 entries of the 3-window gradient, each already rounded
to bf16. The port computes the logical convolution's dW and rounds its f32
sum once (``ROADMAP.md``: the TPU layout tricks are not ported). Measured
here: the port's dW lies 6.4e-3 of its largest entry from JAX's; JAX's own
lies 7.2e-3 from the f32 sum of its rounded 3-window entries, and the
port's 2.7e-3 from it. Both gaps sit inside the 2e-2 of a bf16 step, and
``test_site_a_dw_gap_is_the_s2d_adjoints_rounding`` pins them.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_input, conv2d_weight

from baryon_painter_tpu.ops import conv_rewrites as cr
from baryon_painter_tpu.ops.pallas_conv_bn import fused_conv_bn_relu
from baryon_painter_tpu_torch.ops import conv_bn as k4
from test_torch_conv_bn import (CASES, EPS, IDS, _inputs, _jax_weight, _kw,
                                _nchw, _port_weight)

BF16 = jnp.bfloat16
Y_TOL, Y_EQUAL, STAT_TOL, GRAD_TOL, AFFINE_TOL = 2e-2, 0.999, 1e-5, 2e-2, 1e-3


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _transform(kind, s, p):
    if kind == "transp":
        return lambda w: cr._transp_kernel_3window(w, s, p)
    return lambda w: cr._s2d_kernel_3window(w, 4, p)


def _jax_from_w2(kind, s):
    if kind == "transp":
        return lambda x, w2, g, b: fused_conv_bn_relu(x, w2, g, b, 0, s, EPS,
                                                      True)
    return lambda x, w2, g, b: fused_conv_bn_relu(x, w2, g, b, 4, 4, EPS,
                                                  True)


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    """JAX's bf16 forward and vjp, and the port's, on the same bf16 values:
    the results of both as f32 numpy, NHWC, the kernel HWIO."""
    kind, xs, ws, s, p = request.param
    x, w, gamma, beta = _inputs(xs, ws, 0)
    xb, wb = jnp.asarray(x).astype(BF16), jnp.asarray(w).astype(BF16)
    tf, run = _transform(kind, s, p), _jax_from_w2(kind, s)
    args = (xb, wb, jnp.asarray(gamma), jnp.asarray(beta))
    (y, mean, var), vjp = jax.vjp(
        lambda a, w_, g, b: run(a, tf(w_), g, b), *args)
    cot = jnp.asarray(np.random.default_rng(2).standard_normal(
        y.shape).astype(np.float32)).astype(BF16)
    zeros = (jnp.zeros_like(mean), jnp.zeros_like(var))
    jdx, jdw, jdg, jdb = vjp((cot,) + zeros)
    # JAX's 3-window gradient (rounded to bf16 per entry), brought to the
    # logical kernel through the transform's adjoint in f32
    w2 = tf(wb)
    dw2 = jax.vjp(lambda w2_: run(xb, w2_, *args[2:]), w2)[1](
        (cot,) + zeros)[0]
    dw_f32_sum = jax.vjp(tf, jnp.asarray(_f32(wb)))[1](
        dw2.astype(jnp.float32))[0]
    leaves = [t.requires_grad_() for t in (
        _nchw(_f32(xb)).bfloat16(),
        torch.from_numpy(_port_weight(kind, _f32(wb))).bfloat16(),
        torch.from_numpy(gamma), torch.from_numpy(beta))]
    launches = {f: (f.launches, f.bf16_launches) for f in (
        k4.conv_bn_stats, k4.conv_bn_fwd, k4.conv_bn_bwd1, k4.conv_bn_bwd2)}
    yt, mt, vt = k4.conv_bn_relu(*leaves, **_kw(kind, s, p))
    yt.backward(_nchw(_f32(cot)).bfloat16())
    nhwc = lambda t: t.detach().float().numpy().transpose(0, 2, 3, 1)
    return dict(
        kind=kind,
        jax=dict(y=_f32(y), mean=np.asarray(mean), var=np.asarray(var),
                 dx=_f32(jdx), dw=_f32(jdw), dgamma=np.asarray(jdg),
                 dbeta=np.asarray(jdb), dw_f32_sum=np.asarray(dw_f32_sum)),
        port=dict(y=nhwc(yt), mean=mt.numpy(), var=vt.numpy(),
                  dx=nhwc(leaves[0].grad),
                  dw=_jax_weight(kind, leaves[1].grad.float()),
                  dgamma=leaves[2].grad.numpy(),
                  dbeta=leaves[3].grad.numpy()),
        dtypes={k: t.dtype for k, t in (
            ("y", yt), ("mean", mt), ("var", vt), ("dx", leaves[0].grad),
            ("dw", leaves[1].grad), ("dgamma", leaves[2].grad),
            ("dbeta", leaves[3].grad))},
        launched={f: (f.launches, f.bf16_launches) != n
                  for f, n in launches.items()})


def test_y_matches_jax_in_bf16(case):
    got, want = case["port"]["y"], case["jax"]["y"]
    assert got.shape == want.shape
    assert _rel(got, want) <= Y_TOL
    assert np.mean(got == want) >= Y_EQUAL


def test_batch_statistics_match_jax_in_bf16(case):
    for k in ("mean", "var"):
        assert _rel(case["port"][k], case["jax"][k]) <= STAT_TOL, k


def test_dx_matches_jax_in_bf16(case):
    assert _rel(case["port"]["dx"], case["jax"]["dx"]) <= GRAD_TOL


def test_dw_matches_jax_in_bf16(case):
    assert case["port"]["dw"].shape == case["jax"]["dw"].shape
    assert _rel(case["port"]["dw"], case["jax"]["dw"]) <= GRAD_TOL


def test_dgamma_dbeta_match_jax_in_bf16(case):
    for k in ("dgamma", "dbeta"):
        assert _rel(case["port"][k], case["jax"][k]) <= AFFINE_TOL, k


def test_bf16_dtypes_and_no_launch_on_the_cpu(case):
    """y, dx and dW come back in bf16 (x's and w's dtype), the statistics
    and the batch-norm gradients f32; the CPU wrappers launch nothing."""
    bf, f32 = torch.bfloat16, torch.float32
    assert case["dtypes"] == {"y": bf, "mean": f32, "var": f32, "dx": bf,
                              "dw": bf, "dgamma": f32, "dbeta": f32}
    assert not any(case["launched"].values())


def test_site_a_dw_gap_is_the_s2d_adjoints_rounding(case):
    """Where JAX's logical kernel reaches its 3-window through a gather
    (the transposed sites) the two dW agree bit for bit with the f32 sum
    of JAX's 3-window entries; at the space-to-depth site JAX sums up to
    16 bf16-rounded entries in bf16 and the port rounds the f32 sum once
    (module docstring: 6.4e-3, 7.2e-3 and 2.7e-3 here)."""
    ref = case["jax"]["dw_f32_sum"]
    jax_gap = _rel(case["jax"]["dw"], ref)
    port_gap = _rel(case["port"]["dw"], ref)
    if case["kind"] == "transp":
        assert jax_gap == 0.0 and port_gap == 0.0
    else:
        assert 1e-3 < jax_gap <= 1e-2
        assert port_gap <= 5e-3            # one rounding, not sixteen
        assert _rel(case["port"]["dw"], case["jax"]["dw"]) <= 1e-2


# ---------------------------------------------------------------------- #
# The plain bf16 versions' rounding points and the wrappers' operand rules

def _site(seed=0, transposed=True):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(2, 6, 8, 8, generator=g).abs().bfloat16()
    w = (torch.randn((6, 5, 4, 4) if transposed else (5, 6, 5, 5),
                     generator=g) * 0.2).bfloat16()
    kw = (dict(transposed=True, stride=2, padding=1) if transposed
          else dict(transposed=False, stride=1, padding=2))
    return x, w, torch.rand(5, generator=g) + 0.5, torch.randn(5,
                                                               generator=g), kw


@pytest.mark.parametrize("transposed", [True, False], ids=["transp", "same"])
def test_plain_bf16_versions_round_where_jax_rounds(transposed):
    """u is the f32 sum of the bf16 products (the f64 conv of the bf16
    values to f32's precision); y = bf16(relu(u a + b)); du is rounded to
    bf16 before both of its products, dx and dW rounded once from f32."""
    x, w, gamma, beta, kw = _site(1, transposed)
    conv = F.conv_transpose2d if transposed else F.conv2d
    ckw = dict(stride=kw["stride"], padding=kw["padding"])
    s1, s2, u = k4.conv_bn_stats_ref(x, w, **kw)
    assert u.dtype == torch.float32
    exact = conv(x.double(), w.double(), **ckw)
    assert ((u.double() - exact).abs().max() / exact.abs().max()) < 1e-6
    n = u.shape[0] * u.shape[2] * u.shape[3]
    mean, var = k4.batch_stats(s1, s2, n)
    inv, a, b = k4.bn_affine(gamma, beta, mean, var)
    y = k4.conv_bn_fwd_ref(u, a, b, torch.bfloat16)
    assert torch.equal(y, torch.relu(u * a[:, None, None]
                                     + b[:, None, None]).bfloat16())
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(2)
                     ).bfloat16()
    g1, g2, _ = k4.conv_bn_bwd1_ref(x, w, mean, inv, dy, active=y > 0, **kw)
    dx, dw = k4.conv_bn_bwd2_ref(x, w, a, mean, inv, g1 / n, g2 / n, dy,
                                 active=y > 0, u=u, **kw)
    assert dx.dtype == dw.dtype == torch.bfloat16
    du = (a[:, None, None] * (torch.where(y > 0, dy.float(), 0.0)
                              - (g1 / n)[:, None, None]
                              - (u - mean[:, None, None]) * inv[:, None, None]
                              * (g2 / n)[:, None, None])).bfloat16().float()
    if transposed:
        want_dx = F.conv2d(du, w.float(), **ckw)
        want_dw = conv2d_weight(du, w.shape, x.float(), **ckw)
    else:
        want_dx = conv2d_input(x.shape, w.float(), du, **ckw)
        want_dw = conv2d_weight(x.float(), w.shape, du, **ckw)
    assert torch.equal(dx, want_dx.bfloat16())
    assert torch.equal(dw, want_dw.bfloat16())


def test_plain_bf16_versions_never_use_the_cpu_bf16_convolution(
        monkeypatch):
    """PyTorch's CPU bf16 convolution is wrong at some shapes: every conv
    the plain versions run takes f32 operands."""
    seen = []
    for name in ("conv2d", "conv_transpose2d"):
        real = getattr(F, name)

        def spy(inp, weight, *a, real=real, **kw):
            seen.append((inp.dtype, weight.dtype))
            return real(inp, weight, *a, **kw)
        monkeypatch.setattr(k4.F, name, spy)
    for transposed in (True, False):
        x, w, gamma, beta, kw = _site(3, transposed)
        y, mean, var = k4.conv_bn_relu_ref(x, w, gamma, beta, **kw)
        k4.conv_bn_relu_bwd_ref(x, w, gamma, beta, mean, var,
                                torch.ones_like(y), active=y > 0, **kw)
    assert seen and all(d == (torch.float32, torch.float32) for d in seen)


def test_bf16_fwd_on_the_cpu_returns_a_new_tensor():
    g = torch.Generator().manual_seed(4)
    u = torch.randn(2, 3, 5, 7, generator=g)
    a, b = torch.rand(3, generator=g) + 0.5, torch.randn(3, generator=g)
    before = u.clone()
    y = k4.conv_bn_fwd(u, a, b, torch.bfloat16)
    assert y.dtype == torch.bfloat16 and y.data_ptr() != u.data_ptr()
    assert torch.equal(u, before)
    assert torch.equal(y, k4.conv_bn_fwd_ref(before, a, b, torch.bfloat16))
    with pytest.raises(TypeError, match="float16"):
        k4.conv_bn_fwd(u, a, b, torch.float16)


@pytest.mark.parametrize("case", ["f16_x", "f16_all", "bf16_x_f32_w",
                                  "bf16_u", "bf16_mean", "f32_dy"])
def test_wrappers_refuse_what_the_bf16_kernels_do_not_take(case):
    """float16 is refused; x, w, y and dy share one dtype (float32 or
    bfloat16); u and the per-channel vectors are f32."""
    meta = dict(device="meta")
    x = torch.empty(2, 6, 8, 8, dtype=torch.bfloat16, **meta)
    w = torch.empty(6, 5, 4, 4, dtype=torch.bfloat16, **meta)
    y = torch.empty(2, 5, 16, 16, dtype=torch.bfloat16, **meta)
    u = torch.empty(2, 5, 16, 16, **meta)
    vec = torch.empty(5, **meta)
    outs, vecs = {"u": u, "y": y, "dy": y}, {"mean": vec}
    if case == "f16_x":
        x = x.half()
    elif case == "f16_all":
        x, w, outs = x.half(), w.half(), {"y": y.half(), "dy": y.half()}
    elif case == "bf16_x_f32_w":
        w = w.float()
    elif case == "bf16_u":
        outs["u"] = u.bfloat16()
    elif case == "bf16_mean":
        vecs["mean"] = vec.bfloat16()
    elif case == "f32_dy":
        outs["dy"] = y.float()
    with pytest.raises(TypeError):
        k4._check("conv_bn_bwd2", x, w, True, 2, 1, vecs, outs)
    x32, w32 = x.float(), w.float()
    k4._check("conv_bn_bwd2", x32, w32, True, 2, 1, {"mean": vec},
              {"u": u, "y": y.float(), "dy": y.float()})   # f32: taken
    k4._check("conv_bn_bwd2", x32.bfloat16(), w32.bfloat16(), True, 2, 1,
              {"mean": vec}, {"u": u, "y": y, "dy": y})    # bf16: taken


def test_autograd_brings_dw_to_the_f32_parameter_through_the_cast():
    """As in a bf16 model: the f32 weight is cast to bf16 before K4, whose
    dW is the f32 sum rounded to bf16; the cast's adjoint hands that to
    the f32 parameter, so its gradient holds bf16 values."""
    x, w, gamma, beta, kw = _site(5, True)
    wp = w.float().requires_grad_()
    xp = x.float().requires_grad_()
    gp, bp = gamma.clone().requires_grad_(), beta.clone().requires_grad_()
    y, mean, var = k4.conv_bn_relu(xp.bfloat16(), wp.bfloat16(), gp, bp,
                                   **kw)
    assert y.dtype == torch.bfloat16 and mean.dtype == torch.float32
    (y.float() * torch.linspace(-1, 1, y.numel()).view(y.shape)).sum(
        ).backward()
    for t in (wp, xp, gp, bp):
        assert t.grad.dtype == torch.float32
    assert torch.equal(wp.grad, wp.grad.bfloat16().float())
    assert torch.equal(xp.grad, xp.grad.bfloat16().float())


# ---------------------------------------------------------------------- #
# numpy models of the bf16 GEMMs' fragment and index rules, written as the
# kernels compute their shared-memory offsets (csrc/conv_bn.cu: BwdB,
# u_gemm_kernel, dx_kernel and dw_kernel on their bf16 branch). A bf16
# fragment register of mma.sync m16n8k16 holds two adjacent K elements in
# one 32-bit word, the lower K index in the low half. f64 sums of the
# words' bf16 values, so the comparison sees the index rules only.

FAMILIES = [(False, 1, 1), (False, 3, 1), (False, 5, 1), (False, 7, 1),
            (True, 4, 2), (True, 8, 4)]
FAM_IDS = ["same_k1", "same_k3", "same_k5", "same_k7", "transp_s2",
           "transp_s4"]


def _rup(v, m):
    return -(-v // m) * m


def _plane(n):
    return n + (40 - n % 32) % 32


class _Geo:
    """The kernels' constants for a family (Bwd and BwdB)."""

    def __init__(self, transposed, k, s):
        self.S = s if transposed else 1
        self.K = k
        self.P = s // 2 if transposed else (k - 1) // 2
        self.TW1 = 2 if transposed else k
        self.T1 = self.TW1 ** 2
        self.T2 = k * k
        clamp = lambda v, lo, hi: max(lo, min(hi, v))
        self.CIC = (_rup(clamp(100 // self.T1, 1, 16), 2) if self.S == 1
                    else 16)
        self.NP1 = self.CIC // 2 * self.T1
        self.KP1 = _rup(self.NP1, 8)
        self.COC = (_rup(clamp(104 // self.T2, 1, 8), 2) if self.S == 1
                    else 2)
        self.NP2 = self.COC // 2 * self.T2
        self.KP2 = _rup(self.NP2, 8)

    def fx(self, t):
        return t + self.TW1 - 1

    def fd(self, t):
        return t + self.K - 1 if self.S == 1 else self.S * (t - 1) + self.K

    def x_tap(self, t, fw):
        o = (t // self.TW1) * fw + t % self.TW1
        return o if self.S == 1 else -o

    def x_pix(self, r, c, fw):
        return r * fw + c if self.S == 1 else (r + 1) * fw + c + 1

    def phase(self, ph):
        """(ry, rx, offy, offx, ky0, kx0) of output phase ph."""
        if self.S == 1:
            return 0, 0, 0, 0, 0, 0
        ry, rx = divmod(ph, self.S)
        return (ry, rx, (ry + self.P) // self.S, (rx + self.P) // self.S,
                (ry + self.P) % self.S, (rx + self.P) % self.S)

    def ky(self, ph, t):
        return t // self.K if self.S == 1 else self.phase(ph)[4] + \
            self.S * (t // 2)

    def kx(self, ph, t):
        return t % self.K if self.S == 1 else self.phase(ph)[5] + \
            self.S * (t % 2)


def _bf(a):
    """Values rounded to bf16, as f64."""
    return torch.as_tensor(a).to(torch.bfloat16).double().numpy()


def _word(lo, hi):
    """32-bit words of two bf16 values (low half: the lower K index)."""
    b = lambda v: (np.asarray(v, np.float32).view(np.uint32) >> 16)
    return (b(lo) | (b(hi) << 16)).astype(np.uint32)


def _halves(words):
    """The two bf16 values of each word, f64: (..., 2)."""
    w = np.asarray(words, np.uint32)
    lo = (w << 16).view(np.float32)
    hi = (w & 0xffff0000).view(np.float32)
    return np.stack([lo, hi], -1).astype(np.float64)


def _at(a, iy, ix):
    """a[..., iy, ix], 0 outside the image."""
    h, w = a.shape[-2:]
    out = np.zeros(a.shape[:-2] + iy.shape)
    ok = (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
    out[..., ok] = a[..., iy[ok], ix[ok]]
    return out


def _w(w, transposed, co, ci, ky, kx):
    return w[ci, co, ky, kx] if transposed else w[co, ci, ky, kx]


def _family_inputs(transposed, k, s, cin, cout, h=10, wd=20, seed=0):
    g = np.random.default_rng(seed)
    x = _bf(g.standard_normal((2, cin, h, wd)))
    ws = (cin, cout, k, k) if transposed else (cout, cin, k, k)
    return x, _bf(g.standard_normal(ws))


def _conv(x, w, transposed, k, s):
    p = s // 2 if transposed else (k - 1) // 2
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    if transposed:
        return F.conv_transpose2d(xt, wt, stride=s, padding=p).numpy()
    return F.conv2d(xt, wt, padding=p).numpy()


def _u_block(x, w, geo, transposed, n, ph, q0, qx0, R):
    """u of one u-GEMM block (phase ph, rows q0 + [0, 8R), columns qx0 +
    [0, 16)) from its channel-pair planes and weight pair words: (pixels,
    Cout) and the pixels' (q, qx)."""
    S, cin = geo.S, x.shape[1]
    cout = w.shape[1] if transposed else w.shape[0]
    _, _, offy, offx, _, _ = geo.phase(ph)
    fh, fxw = geo.fx(8 * R), geo.fx(16)
    pl, cp_n = _plane(fh * fxw), geo.CIC // 2
    orgy = q0 - geo.P if S == 1 else q0 + offy - 1
    orgx = qx0 - geo.P if S == 1 else qx0 + offx - 1
    rows, cols = np.meshgrid(np.arange(8 * R), np.arange(16), indexing="ij")
    pix = geo.x_pix(rows, cols, fxw).ravel()
    fy, fx_ = np.meshgrid(np.arange(fh), np.arange(fxw), indexing="ij")
    koff = np.array([(kp % cp_n) * pl + geo.x_tap(kp // cp_n, fxw)
                     if kp < geo.NP1 else 0 for kp in range(geo.KP1)])
    acc = np.zeros((pix.size, cout))
    for ci0 in range(0, cin, geo.CIC):
        nci = min(geo.CIC, cin - ci0)
        planes = np.zeros((cp_n, pl), np.uint32)
        for cp in range(cp_n):
            ch = [_at(x[n, ci0 + c], orgy + fy, orgx + fx_) if c < nci
                  else np.zeros(fy.shape) for c in (2 * cp, 2 * cp + 1)]
            planes[cp, :fh * fxw] = _word(ch[0], ch[1]).ravel()
        wb = np.zeros((geo.KP1, cout), np.uint32)
        for kp in range(geo.NP1):
            t, c = divmod(kp, cp_n)
            ph_k = (geo.ky(ph, t), geo.kx(ph, t))
            for co in range(cout):
                v = [_w(w, transposed, co, ci0 + 2 * c + e, *ph_k)
                     if 2 * c + e < nci else 0.0 for e in (0, 1)]
                wb[kp, co] = _word(v[0], v[1])
        a = _halves(planes.ravel()[pix[:, None] + koff[None, :]])
        b = _halves(wb.T).transpose(1, 2, 0)        # (KP1, 2, Cout)
        acc += a.reshape(pix.size, -1) @ b.reshape(-1, cout)
    q, qx = q0 + rows.ravel(), qx0 + cols.ravel()
    return acc, q, qx


@pytest.mark.parametrize("transposed,k,s", FAMILIES, ids=FAM_IDS)
@pytest.mark.parametrize("cin", [3, 20])
def test_bf16_u_gemm_pair_planes_are_the_conv(transposed, k, s, cin):
    """u from channel-pair planes (Cin = 3 padded to 4 with a zero half,
    Cin = 20 in chunks of CIC with a short last one) and (tap, pair) K
    order, every block of a 10 x 20 input grid, every phase."""
    geo = _Geo(transposed, k, s)
    x, w = _family_inputs(transposed, k, s, cin, 5)
    want = _conv(x, w, transposed, k, s)
    seen = np.zeros(want.shape[:1] + want.shape[2:], bool)
    R = 2   # Cout <= 32
    for n in range(x.shape[0]):
        for ph in range(geo.S * geo.S):
            ry, rx = geo.phase(ph)[:2]
            for q0 in range(0, x.shape[2], 8 * R):
                for qx0 in range(0, x.shape[3], 16):
                    u, q, qx = _u_block(x, w, geo, transposed, n, ph, q0,
                                        qx0, R)
                    ok = (q < x.shape[2]) & (qx < x.shape[3])
                    oy, ox = geo.S * q[ok] + ry, geo.S * qx[ok] + rx
                    np.testing.assert_allclose(
                        u[ok], want[n][:, oy, ox].T, rtol=1e-10,
                        atol=1e-10)
                    seen[n, oy, ox] = True
    assert seen.all()


def _du_planes(du, geo, n, co0, nco, orgy, fx0, fh, fdw, pl):
    fy, fx_ = np.meshgrid(np.arange(fh), np.arange(fdw), indexing="ij")
    planes = np.zeros((geo.COC // 2, pl), np.uint32)
    for cp in range(geo.COC // 2):
        ch = [_at(du[n, co0 + c], orgy + fy, fx0 + fx_) if c < nco
              else np.zeros(fy.shape) for c in (2 * cp, 2 * cp + 1)]
        planes[cp, :fh * fdw] = _word(ch[0], ch[1]).ravel()
    return planes


@pytest.mark.parametrize("transposed,k,s", FAMILIES, ids=FAM_IDS)
def test_bf16_dx_gemm_channel_pairs_are_the_adjoint(transposed, k, s):
    """dx from du's channel-pair planes (an odd Cout = 5: the last pair's
    high half zero) and (tap, output-channel pair) K order."""
    geo = _Geo(transposed, k, s)
    cin, cout, h, wd = 6, 5, 10, 20
    x, w = _family_inputs(transposed, k, s, cin, cout, h, wd)
    g = np.random.default_rng(1)
    du = _bf(g.standard_normal(_conv(x, w, transposed, k, s).shape))
    p = geo.P
    if transposed:
        want = F.conv2d(torch.from_numpy(du), torch.from_numpy(w), stride=s,
                        padding=p).numpy()
    else:
        want = conv2d_input(x.shape, torch.from_numpy(w),
                            torch.from_numpy(du), padding=p).numpy()
    R = 2   # Cin <= 32
    S, K = geo.S, k
    fh, fdw = geo.fd(8 * R), geo.fd(16)
    pl, cp_n = _plane(fh * fdw), geo.COC // 2
    rows, cols = np.meshgrid(np.arange(8 * R), np.arange(16), indexing="ij")
    pix = (((rows + K - 1) * fdw + cols + K - 1) if S == 1
           else S * rows * fdw + S * cols).ravel()
    koff = np.zeros(geo.KP2, int)
    for kp in range(geo.NP2):
        t, c = divmod(kp, cp_n)
        tap = (t // K) * fdw + t % K
        koff[kp] = c * pl + (-tap if S == 1 else tap)
    for n in range(2):
        for p0y in range(0, h, 8 * R):
            for p0x in range(0, wd, 16):
                orgy = p0y + p - (K - 1) if S == 1 else S * p0y - p
                fx0 = p0x + p - (K - 1) if S == 1 else S * p0x - p
                acc = np.zeros((pix.size, cin))
                for co0 in range(0, cout, geo.COC):
                    nco = min(geo.COC, cout - co0)
                    planes = _du_planes(du, geo, n, co0, nco, orgy, fx0, fh,
                                        fdw, pl)
                    wb = np.zeros((geo.KP2, cin), np.uint32)
                    for kp in range(geo.NP2):
                        t, c = divmod(kp, cp_n)
                        for ci in range(cin):
                            v = [_w(w, transposed, co0 + 2 * c + e, ci,
                                    t // K, t % K) if 2 * c + e < nco
                                 else 0.0 for e in (0, 1)]
                            wb[kp, ci] = _word(v[0], v[1])
                    a = _halves(planes.ravel()[pix[:, None] + koff[None]])
                    b = _halves(wb.T).transpose(1, 2, 0)
                    acc += a.reshape(pix.size, -1) @ b.reshape(-1, cin)
                iy, ix = p0y + rows.ravel(), p0x + cols.ravel()
                ok = (iy < h) & (ix < wd)
                np.testing.assert_allclose(acc[ok], want[n][:, iy[ok],
                                                            ix[ok]].T,
                                           rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("transposed,k,s", FAMILIES, ids=FAM_IDS)
@pytest.mark.parametrize("dwc", [16, 32])
def test_bf16_dw_gemm_pixel_pairs_are_the_weight_gradient(transposed, k, s,
                                                          dwc):
    """dW from du as pixel-pair words of each chunk's 2 x dwc pixels and x
    as a word at every footprint position (it and its right neighbour), so
    the pair at any tap offset, odd or even, is one word; chunks past the
    image's edge give zero."""
    geo = _Geo(transposed, k, s)
    cin, cout, h, wd = 3, 5, 7, 20
    x, w = _family_inputs(transposed, k, s, cin, cout, h, wd)
    du = _bf(np.random.default_rng(2).standard_normal(
        _conv(x, w, transposed, k, s).shape))
    p, S = geo.P, geo.S
    if transposed:
        want = conv2d_weight(torch.from_numpy(du), w.shape,
                             torch.from_numpy(x), stride=s,
                             padding=p).numpy()
    else:
        want = conv2d_weight(torch.from_numpy(x), w.shape,
                             torch.from_numpy(du), padding=p).numpy()
    got = np.zeros_like(want)
    px = 2 * dwc
    fxr, fxc = geo.fx(2), geo.fx(dwc)
    xpl = fxr * fxc
    pxo = np.array([geo.x_pix(i // dwc, i % dwc, fxc) for i in range(px)])
    noff = np.array([(c // geo.T1) * xpl + geo.x_tap(c % geo.T1, fxc)
                     for c in range(cin * geo.T1)])
    fy, fx_ = np.meshgrid(np.arange(fxr), np.arange(fxc), indexing="ij")
    for ph in range(S * S):
        ry, rx, offy, offx, _, _ = geo.phase(ph)
        part = np.zeros((cout, cin * geo.T1))
        for n in range(2):
            for q0 in range(0, h, 2):
                for qx0 in range(0, wd, dwc):
                    q = q0 + np.arange(px) // dwc
                    qx = qx0 + np.arange(px) % dwc
                    inside = (q < h) & (qx < wd)
                    vals = np.where(inside, du[n][:, np.minimum(
                        S * q + ry, du.shape[2] - 1), np.minimum(
                        S * qx + rx, du.shape[3] - 1)], 0.0)
                    duw = _word(vals[:, 0::2], vals[:, 1::2])  # (Cout, dwc)
                    orgy = q0 - p if S == 1 else q0 + offy - 1
                    orgx = qx0 - p if S == 1 else qx0 + offx - 1
                    xs = _at(x[n], orgy + fy, orgx + fx_)    # (Cin, fxr, fxc)
                    right = np.concatenate(
                        [xs[..., 1:], np.zeros(xs.shape[:-1] + (1,))], -1)
                    xw = _word(xs, right).ravel()
                    # B: pixel pairs (2 i, 2 i + 1) at column c: one word
                    b = _halves(xw[pxo[0::2][:, None] + noff[None, :]])
                    b = b.transpose(0, 2, 1).reshape(px, -1)
                    a = _halves(duw).reshape(cout, px)
                    part += a @ b
        for c in range(cin * geo.T1):
            ci, t = divmod(c, geo.T1)
            for co in range(cout):
                idx = ((ci, co) if transposed else (co, ci)) + (
                    geo.ky(ph, t), geo.kx(ph, t))
                got[idx] = part[co, c]
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-10)


def _banks(addresses):
    return len({int(a) % 32 for a in addresses})


# distinct banks of a warp's first A load in the u GEMM: 32 where a lane
# group's four K pairs are four channel pairs at one tap (CIC >= 8); the
# "same" convs with fewer channels a chunk put neighbouring taps of one
# pair in a k16 step, whose words are one column apart: site A's k = 5
# (CIC = 4: two pairs a tap) hits 17 banks, k = 7 (one pair) 11
U_BANKS = {"same_k1": 32, "same_k3": 32, "same_k5": 17, "same_k7": 11,
           "transp_s2": 32, "transp_s4": 32}


@pytest.mark.parametrize("transposed,k,s", FAMILIES, ids=FAM_IDS)
def test_bf16_pair_planes_spread_a_warps_loads_over_the_banks(transposed, k,
                                                              s):
    """Pair planes are 8 mod 32 words apart, so four channel pairs at one
    tap put a warp's A loads on 32 banks (``U_BANKS`` per family); the
    weights' rows (8 mod 32 words, ``ldb``) put the B loads on 32 banks at
    every site."""
    geo = _Geo(transposed, k, s)
    for R in (1, 2):
        fh, fxw = geo.fx(8 * R), geo.fx(16)
        assert _plane(fh * fxw) % 32 == 8
        assert _plane(geo.fd(8 * R) * geo.fd(16)) % 32 == 8
    cp_n = geo.CIC // 2
    pl = _plane(geo.fx(8) * geo.fx(16))
    koff = [(kp % cp_n) * pl + geo.x_tap(kp // cp_n, geo.fx(16))
            for kp in range(8)]
    a0 = [geo.x_pix(0, g, geo.fx(16)) + koff[tig] for g in range(8)
          for tig in range(4)]
    name = FAM_IDS[FAMILIES.index((transposed, k, s))]
    assert _banks(a0) == U_BANKS[name]
    for ntv in (8, 16, 32, 64):
        ld = 8 if ntv <= 8 else _rup(ntv, 32) + 8
        assert _banks([tig * ld + g for g in range(8)
                       for tig in range(4)]) == 32


@pytest.mark.parametrize("dwc", [16, 32, 64])
def test_bf16_dw_du_words_spread_a_warps_loads_over_the_banks(dwc):
    """du's pixel-pair rows are dwc + 4 words (4 mod 8): the A loads of a
    warp (rows g, pairs tig) hit 32 distinct banks."""
    ldw = dwc + 4
    assert _banks([g * ldw + tig for g in range(8) for tig in range(4)]) == 32
