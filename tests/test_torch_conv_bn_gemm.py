"""A plain-torch model of K4's backward GEMMs (csrc/conv_bn.cu), held against
``F.conv2d`` / ``F.conv_transpose2d`` and their autograd, and an emulation
of the 3xTF32 split the kernels multiply with.

The kernels run three implicit GEMMs a site:
  bwd1 (u):  for each output phase (oy % s, ox % s), M = the phase's pixels,
             N = Cout, K = (ci, ty, tx) with ci slowest, taps TW1 x TW1
             (TW1 = k for the "same" conv, 2 for the transposed conv)
  bwd2 (dx): M = input pixels, N = Cin, K = (co, ky, kx) with co slowest:
             du at p - k + P (same conv) or s p + k - P (transposed conv)
  bwd2 (dW): for each phase, M = Cout, N = (ci, ty, tx), K = the phase's
             pixels in chunks of 2 rows x 16 or 64 columns (columns
             fastest); each split takes a run of consecutive chunks, and
             the splits' partials are summed.
The model builds each operand with the kernels' index rules and checks the
products at small shapes of both families and every compiled (k, s). f64,
so the comparison sees the index rules only (rtol 1e-10).

The 3xTF32 emulation rounds each f32 operand to TF32 (10 mantissa bits,
to nearest, ties away: cvt.rna.tf32.f32), forms big = tf32(v) and small =
tf32(v - big), and accumulates small*big + big*small + big*big in f32, as
the tensor cores do. At the fiducial sites' contraction lengths it holds
``smoke.K4_TOL`` with a wide margin, where one TF32 pass does not.
"""
import zlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from mma_emulation import _toward_zero

from baryon_painter_tpu_torch import smoke

# (transposed, k, s): every (stride, kernel) pair the kernels are compiled for
FAMILIES = [(False, 1, 1), (False, 3, 1), (False, 5, 1), (False, 7, 1),
            (True, 4, 2), (True, 8, 4)]
IDS = ["same_k1", "same_k3", "same_k5", "same_k7", "transp_s2", "transp_s4"]
RTOL = 1e-10


def _inputs(transposed, k, cin=3, cout=5, n=2, h=7, w=9, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, cin, h, w, generator=g, dtype=torch.float64)
    ws = (cin, cout, k, k) if transposed else (cout, cin, k, k)
    return x, torch.randn(ws, generator=g, dtype=torch.float64)


def _pad(transposed, k, s):
    return s // 2 if transposed else (k - 1) // 2


def _conv(x, w, transposed, k, s):
    p = _pad(transposed, k, s)
    if transposed:
        return F.conv_transpose2d(x, w, stride=s, padding=p)
    return F.conv2d(x, w, padding=p)


def _w(w, transposed, co, ci, ky, kx):
    return w[ci, co, ky, kx] if transposed else w[co, ci, ky, kx]


def _phases(transposed, s):
    return [(ry, rx) for ry in range(s) for rx in range(s)] if transposed \
        else [(0, 0)]


def _phase_taps(transposed, k, s, r):
    """(row offset, kernel origin, taps a dimension) of phase r."""
    if not transposed:
        return 0, 0, k
    p = s // 2
    return (r + p) // s, (r + p) % s, 2


def _x_at(x, n, ci, iy, ix):
    _, _, h, w = x.shape
    if 0 <= iy < h and 0 <= ix < w:
        return x[n, ci, iy, ix].item()
    return 0.0


def _u_operands(x, w, transposed, k, s, phase):
    """A (the phase's pixels x (ci, ty, tx)) and B ((ci, ty, tx) x Cout) of
    the u GEMM, and the pixels' (n, oy, ox)."""
    n_, cin, h, wd = x.shape
    cout = w.shape[1] if transposed else w.shape[0]
    p = _pad(transposed, k, s)
    offy, ky0, tw = _phase_taps(transposed, k, s, phase[0])
    offx, kx0, _ = _phase_taps(transposed, k, s, phase[1])
    kdim = cin * tw * tw
    a = torch.zeros(n_ * h * wd, kdim, dtype=torch.float64)
    b = torch.zeros(kdim, cout, dtype=torch.float64)
    pix = []
    for kk in range(kdim):
        ci, t = divmod(kk, tw * tw)
        ty, tx = divmod(t, tw)
        ky = ty if not transposed else ky0 + s * ty
        kx = tx if not transposed else kx0 + s * tx
        for co in range(cout):
            b[kk, co] = _w(w, transposed, co, ci, ky, kx)
    m = 0
    for n in range(n_):
        for q in range(h):
            for qx in range(wd):
                for kk in range(kdim):
                    ci, t = divmod(kk, tw * tw)
                    ty, tx = divmod(t, tw)
                    if transposed:
                        iy, ix = q + offy - ty, qx + offx - tx
                    else:
                        iy, ix = q + ty - p, qx + tx - p
                    a[m, kk] = _x_at(x, n, ci, iy, ix)
                oy = s * q + phase[0] if transposed else q
                ox = s * qx + phase[1] if transposed else qx
                pix.append((n, oy, ox))
                m += 1
    return a, b, pix


@pytest.mark.parametrize("transposed,k,s", FAMILIES, ids=IDS)
def test_u_gemm_per_phase_is_the_conv(transposed, k, s):
    x, w = _inputs(transposed, k, h=5, w=6)
    u = _conv(x, w, transposed, k, s)
    seen = torch.zeros(u.shape[0], u.shape[2], u.shape[3], dtype=torch.bool)
    for phase in _phases(transposed, s):
        a, b, pix = _u_operands(x, w, transposed, k, s, phase)
        got = a @ b
        for m, (n, oy, ox) in enumerate(pix):
            torch.testing.assert_close(got[m], u[n, :, oy, ox], rtol=RTOL,
                                       atol=RTOL)
            seen[n, oy, ox] = True
    assert bool(seen.all())   # the phases cover every output pixel once


def _dx_operands(du, w, transposed, k, s, cin, h, wd):
    """A (input pixels x (co, ky, kx)) and B ((co, ky, kx) x Cin) of the dx
    GEMM."""
    n_, cout, ho, wo = du.shape
    p = _pad(transposed, k, s)
    kdim = cout * k * k
    a = torch.zeros(n_ * h * wd, kdim, dtype=torch.float64)
    b = torch.zeros(kdim, cin, dtype=torch.float64)
    for kk in range(kdim):
        co, t = divmod(kk, k * k)
        for ci in range(cin):
            b[kk, ci] = _w(w, transposed, co, ci, *divmod(t, k))
    m = 0
    for n in range(n_):
        for py in range(h):
            for px in range(wd):
                for kk in range(kdim):
                    co, t = divmod(kk, k * k)
                    ky, kx = divmod(t, k)
                    if transposed:
                        oy, ox = s * py + ky - p, s * px + kx - p
                    else:
                        oy, ox = py - ky + p, px - kx + p
                    if 0 <= oy < ho and 0 <= ox < wo:
                        a[m, kk] = du[n, co, oy, ox]
                m += 1
    return a, b


@pytest.mark.parametrize("transposed,k,s", FAMILIES, ids=IDS)
def test_dx_gemm_is_the_adjoint(transposed, k, s):
    """dx as a conv of du: with kernel k and stride s for the transposed
    conv (du at s p + k - P), with the flipped kernel for the "same" one."""
    x, w = _inputs(transposed, k, h=5, w=6)
    xg = x.clone().requires_grad_()
    u = _conv(xg, w, transposed, k, s)
    du = torch.randn(u.shape, generator=torch.Generator().manual_seed(1),
                     dtype=torch.float64)
    u.backward(du)
    n_, cin, h, wd = x.shape
    a, b = _dx_operands(du, w, transposed, k, s, cin, h, wd)
    got = (a @ b).reshape(n_, h, wd, cin).permute(0, 3, 1, 2)
    torch.testing.assert_close(got, xg.grad, rtol=RTOL, atol=RTOL)


def _dw_partials(x, w, du, transposed, k, s, nsplit, cols):
    """The dW GEMM per phase, over chunks of 2 x ``cols`` pixels of the
    phase's grid dealt to ``nsplit`` splits: (nsplit, w's shape)
    partials."""
    n_, cin, h, wd = x.shape
    parts = torch.zeros((nsplit,) + tuple(w.shape), dtype=torch.float64)
    nrows, ncols = (h + 1) // 2, -(-wd // cols)
    per = -(-n_ * nrows * ncols // nsplit)
    for phase in _phases(transposed, s):
        a, b, pix = _u_operands(x, w, transposed, k, s, phase)
        _, ky0, tw = _phase_taps(transposed, k, s, phase[0])
        _, kx0, _ = _phase_taps(transposed, k, s, phase[1])
        index = {(n, q, qx): m for m, (n, q, qx) in enumerate(
            (n, q, qx) for n in range(n_) for q in range(h)
            for qx in range(wd))}
        for c in range(n_ * nrows * ncols):
            n, r = divmod(c, nrows * ncols)
            q0, qx0 = 2 * (r // ncols), cols * (r % ncols)
            rows = [index[(n, q, qx)] for q in range(q0, min(q0 + 2, h))
                    for qx in range(qx0, min(qx0 + cols, wd))]
            d = torch.stack([du[pix[m][0], :, pix[m][1], pix[m][2]]
                             for m in rows], 1)          # (Cout, pixels)
            prod = d @ a[rows]                           # (Cout, (ci, t))
            for kk in range(prod.shape[1]):
                ci, t = divmod(kk, tw * tw)
                ty, tx = divmod(t, tw)
                ky = ty if not transposed else ky0 + s * ty
                kx = tx if not transposed else kx0 + s * tx
                if transposed:
                    parts[c // per, ci, :, ky, kx] += prod[:, kk]
                else:
                    parts[c // per, :, ci, ky, kx] += prod[:, kk]
    return parts


@pytest.mark.parametrize("transposed,k,s", FAMILIES, ids=IDS)
@pytest.mark.parametrize("nsplit,cols", [(1, 16), (3, 16), (2, 64)])
def test_dw_gemm_split_over_pixels_is_the_weight_gradient(transposed, k, s,
                                                         nsplit, cols):
    x, w = _inputs(transposed, k, h=5, w=19)   # ragged column chunks
    wg = w.clone().requires_grad_()
    u = _conv(x, wg, transposed, k, s)
    du = torch.randn(u.shape, generator=torch.Generator().manual_seed(2),
                     dtype=torch.float64)
    u.backward(du)
    parts = _dw_partials(x, w, du, transposed, k, s, nsplit, cols)
    torch.testing.assert_close(parts.sum(0), wg.grad, rtol=RTOL, atol=RTOL)


# ---------------------------------------------------------------------- #
# 3xTF32

def tf32(v: np.ndarray) -> np.ndarray:
    """Round f32 to TF32 (10 mantissa bits), to nearest, ties away from 0,
    as cvt.rna.tf32.f32 does (finite inputs)."""
    b = np.asarray(v, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def dot_3xtf32(a: np.ndarray, b: np.ndarray, chunks: int) -> np.ndarray:
    """a (K, M) . b (K, N) with each product as small*big + big*small +
    big*big (f32), summed in f32 over ``chunks`` blocks of K whose partials
    are summed in f32, as the kernels accumulate."""
    ah, bh = tf32(a), tf32(b)
    al, bl = tf32(a - ah), tf32(b - bh)
    out = np.zeros((a.shape[1], b.shape[1]), np.float32)
    for ka, kb in zip(np.array_split(np.arange(a.shape[0]), chunks),
                      np.array_split(np.arange(a.shape[0]), chunks)):
        part = (al[ka].T @ bh[kb]).astype(np.float32)
        part = part + (ah[ka].T @ bl[kb]).astype(np.float32)
        part = part + (ah[ka].T @ bh[kb]).astype(np.float32)
        out = out + part
    return out


def dot_tf32(a, b, chunks):
    out = np.zeros((a.shape[1], b.shape[1]), np.float32)
    for ka in np.array_split(np.arange(a.shape[0]), chunks):
        out = out + (tf32(a[ka]).T @ tf32(b[ka])).astype(np.float32)
    return out


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def test_tf32_rounding_is_round_to_nearest_ties_away():
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    v = np.array([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -20,
                  3.0, 1e-30], np.float32)
    want = np.array([one + ulp, -(one + ulp), one, 3.0,
                     tf32(np.float32(1e-30))], np.float32)
    np.testing.assert_array_equal(tf32(v), want)
    assert (tf32(v).view(np.uint32) & 0x1FFF == 0).all()


# per site (A-D at batch 24, 512^2): the contraction length of each GEMM;
# dW's over the pixels of a phase, in the same number of splits the kernels
# use at most (64)
SITE_K = {"A": {"u": 3 * 25, "dx": 16 * 25, "dw": 24 * 512 * 512},
          "B": {"u": 128 * 4, "dx": 64 * 16, "dw": 24 * 64 * 64},
          "C": {"u": 64 * 4, "dx": 32 * 16, "dw": 24 * 128 * 128},
          "D": {"u": 32 * 4, "dx": 16 * 16, "dw": 24 * 256 * 256}}
GEMM_TOL = {"u": smoke.K4_TOL["y"], "dx": smoke.K4_TOL["dx"],
            "dw": smoke.K4_TOL["dw"]}


@pytest.mark.parametrize("gemm", ["u", "dx", "dw"])
@pytest.mark.parametrize("site", ["A", "B", "C", "D"])
def test_3xtf32_holds_k4_tol_at_the_sites_contraction_lengths(site, gemm):
    """Half-normal activations against zero-mean operands (x and y are
    ReLU outputs or range-compressed fields; weights and du have either
    sign); a few output columns. 3xTF32 stays 10x inside K4_TOL; one TF32
    pass is at least 30x worse than 3xTF32."""
    k = SITE_K[site][gemm]
    rng = np.random.default_rng(zlib.crc32(f"{site}/{gemm}".encode()))
    cols = 2 if gemm == "dw" else 8
    a = np.abs(rng.standard_normal((k, cols))).astype(np.float32)
    b = rng.standard_normal((k, cols)).astype(np.float32)
    want = a.astype(np.float64).T @ b.astype(np.float64)
    chunks = 64 if gemm == "dw" else 1
    err3 = _rel(dot_3xtf32(a, b, chunks), want)
    err1 = _rel(dot_tf32(a, b, chunks), want)
    assert err3 <= GEMM_TOL[gemm] / 10, err3
    assert err1 >= 30 * err3, (err1, err3)


# ---------------------------------------------------------------------- #
# K4-stats' epilogue and K4-fwd's index rule

KNT, KTH, KTW = 64, 8, 16   # the u GEMM's block: 64 columns, 8 R x 16 pixels


def _rows_for(cout):
    """Pixel rows a warp owns: 2 where a block's columns fill at most 4 n8
    tiles (rows_for in the source)."""
    return 2 if -(-min(cout, KNT) // 8) * 8 <= 32 else 1


def _stats_grid(h, w, cout, s):
    """(phases, grid x, grid y, R) of the u GEMM's launch for x (h, w):
    grid x = phases x 16-column tiles, grid y = 8 R-row tiles."""
    r = _rows_for(cout)
    ph = s * s
    return ph, ph * -(-w // KTW), -(-h // (KTH * r)), r


def _fma32(acc, a, b):
    """acc + a * b rounded once to f32, as the kernel's contracted
    multiply-add (a * b is exact in f64; up to a double rounding)."""
    return (acc.astype(np.float64) + a.astype(np.float64)
            * b.astype(np.float64)).astype(np.float32)


def stats_partials(u, s):
    """The per-block partial sums of u and u^2 that K4-stats writes, in
    the kernel's order, from u (N, Cout, s h, s w) f32: each thread sums
    its pixels (rows warp + 8 r, columns g, g + 8; r outer) of its channel,
    skipping pixels outside the image; lanes xor 4, 8, 16 add pairwise
    (((g0 + g1) + (g2 + g3)) + ((g4 + g5) + (g6 + g7))); the 8 warps add in
    turn. Returns p1, p2 (N x tiles, Cout) and a count of how often each
    output element was summed."""
    n_, cout, ho, wo = u.shape
    h, w = ho // s, wo // s
    ph, gx, gy, r_ = _stats_grid(h, w, cout, s)
    # outside the image the kernel's accumulators hold values of padded
    # tiles; NaN here, so a pixel that is not skipped poisons the sums
    pad = np.full((n_, cout, ho + 2 * s * KTH * 2, wo + 2 * s * KTW),
                  np.nan, np.float32)
    pad[:, :, :ho, :wo] = u
    p1 = np.zeros((n_ * gx * gy, cout), np.float32)
    p2 = np.zeros_like(p1)
    seen = np.zeros(u.shape, np.int64)
    warp = np.arange(8)[:, None, None]
    g = np.arange(8)[None, :, None]
    col = np.arange(KNT)[None, None, :]
    for n in range(n_):
        for co0 in range(0, cout, KNT):
            co = co0 + col
            for by in range(gy):
                for bx in range(gx):
                    ry, rx = divmod(bx % ph, s)
                    qx0, q0 = (bx // ph) * KTW, by * KTH * r_
                    a1 = np.zeros((8, 8, KNT), np.float32)
                    a2 = np.zeros_like(a1)
                    for r in range(r_):
                        for hh in range(2):
                            q, qx = q0 + warp + 8 * r, qx0 + g + 8 * hh
                            ok = (q < h) & (qx < w) & (co < cout)
                            oy, ox = s * q + ry, s * qx + rx
                            v = pad[n, np.minimum(co, cout - 1), oy, ox]
                            v = np.where(ok, v, np.float32(0))
                            np.add.at(seen[n], (np.minimum(co, cout - 1),
                                                np.minimum(oy, ho - 1),
                                                np.minimum(ox, wo - 1)),
                                      ok.astype(np.int64))
                            a1 = (a1 + v).astype(np.float32)
                            a2 = _fma32(a2, v, v)
                    sums = []
                    for a in (a1, a2):
                        b = (a[:, 0::2] + a[:, 1::2]).astype(np.float32)
                        c = (b[:, 0::2] + b[:, 1::2]).astype(np.float32)
                        d = (c[:, 0] + c[:, 1]).astype(np.float32)
                        t = np.zeros(KNT, np.float32)
                        for wi in range(8):
                            t = (t + d[wi]).astype(np.float32)
                        sums.append(t)
                    blk = (n * gy + by) * gx + bx
                    m = min(KNT, cout - co0)
                    p1[blk, co0:co0 + m] = sums[0][:m]
                    p2[blk, co0:co0 + m] = sums[1][:m]
    return p1, p2, seen


@pytest.mark.parametrize("transposed,k,s", FAMILIES, ids=IDS)
@pytest.mark.parametrize("cout", [5, 40, 70])
def test_stats_epilogue_partials_sum_to_the_plain_sums(transposed, k, s,
                                                      cout):
    """Ragged tiles (h = 7, w = 9 against 8 R x 16 tiles), R = 2 (cout 5)
    and R = 1 (40, and 70 in two channel groups): each output element is
    summed exactly once, the pixels past the image are skipped, and the
    partial rows summed over the blocks equal the plain sums of u and u^2
    to 1e-6 of their scale."""
    x, wt = _inputs(transposed, k, cin=3, cout=cout, h=7, w=9)
    u = _conv(x, wt, transposed, k, s).float().numpy()
    s_ = s if transposed else 1
    p1, p2, seen = stats_partials(u, s_)
    assert (seen == 1).all()
    _, gx, gy, _ = _stats_grid(7, 9, cout, s_)
    assert p1.shape == (2 * gx * gy, cout)
    u64 = u.astype(np.float64)
    for got, want, scale in (
            (p1, u64.sum((0, 2, 3)), np.abs(u64).sum((0, 2, 3))),
            (p2, (u64 * u64).sum((0, 2, 3)), (u64 * u64).sum((0, 2, 3)))):
        err = np.abs(got.astype(np.float64).sum(0) - want).max()
        assert err <= 1e-6 * scale.max(), (err, scale.max())


def fwd_model(flat, offset, n, c, hw, a, b):
    """K4-fwd in place over u = flat[offset : offset + n c hw] (flat is a
    16-byte aligned f32 storage), as bn_relu_kernel walks it: block (plane
    p, run by) takes float4 groups by * 1024 + 256 j + t (j < 4) from the
    plane's first 16-byte boundary, with channel p % c; the plane's first
    block takes the head before that boundary and the tail after the last
    whole group. Returns the result and how often each element was
    written."""
    out = flat.copy()
    writes = np.zeros(flat.shape, np.int64)
    runs = max(1, -(-(hw // 4) // 1024))
    t = np.arange(256)
    for p in range(n * c):
        base = offset + p * hw
        head = min(hw, -base & 3)
        n4 = (hw - head) >> 2
        idx = []
        for by in range(runs):
            for j in range(4):
                i = by * 1024 + j * 256 + t
                i = i[i < n4]
                idx.append((base + head + 4 * i[:, None]
                            + np.arange(4)).ravel())
        tail = hw - head - 4 * n4
        th = t[:head + tail]
        idx.append(base + np.where(th < head, th, head + 4 * n4 + th - head))
        idx = np.concatenate(idx)
        v = (out[idx] * a[p % c]).astype(np.float32)
        v = (v + b[p % c]).astype(np.float32)
        out[idx] = np.where(v < 0, np.float32(0), v)
        np.add.at(writes, idx, 1)
    return out, writes


@pytest.mark.parametrize("hw", [(7, 9), (8, 8), (1, 1), (1, 3), (3, 1367)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("offset", [0, 1, 2, 3])
def test_fwd_index_rule_is_the_plain_affine_relu(hw, offset):
    """Planes whose length is not a multiple of 4 (63, 1, 3, 4101: more
    than one run of 1024 groups), and u starting 0 to 3 elements past a
    16-byte boundary: every element of u written once, with its own
    channel's a and b, bit for bit as ``conv_bn_fwd_ref``; nothing outside
    u written."""
    from baryon_painter_tpu_torch.ops.conv_bn import conv_bn_fwd_ref
    n, c = 2, 5
    rng = np.random.default_rng(offset)
    size = n * c * hw[0] * hw[1]
    flat = rng.standard_normal(size + 8).astype(np.float32)
    a = rng.uniform(0.5, 2, c).astype(np.float32)
    b = rng.standard_normal(c).astype(np.float32)
    out, writes = fwd_model(flat, offset, n, c, hw[0] * hw[1], a, b)
    inside = np.zeros(flat.shape, bool)
    inside[offset:offset + size] = True
    assert (writes[inside] == 1).all() and (writes[~inside] == 0).all()
    u = torch.from_numpy(flat[offset:offset + size].reshape(n, c, *hw))
    want = conv_bn_fwd_ref(u, torch.from_numpy(a), torch.from_numpy(b))
    assert torch.equal(torch.from_numpy(out[inside].reshape(n, c, *hw)),
                       want)


def u_gemm_3xtf32(a, b, ksteps: int) -> np.ndarray:
    """a (M, K) @ b (K, N) as K4's u GEMM multiplies: each operand split
    into big = tf32(v) and small = tf32(v - big), both rounded to nearest
    (cvt.rna); per m16n8k8 k-step the products small*big, big*small and
    big*big added into the tensor cores' accumulator, which rounds toward
    zero; that accumulator summed from zero over ``ksteps`` k-steps and
    added into an f32 sum rounded to nearest."""
    pad = -a.shape[1] % 8
    a = np.pad(np.asarray(a, np.float32), ((0, 0), (0, pad)))
    b = np.pad(np.asarray(b, np.float32), ((0, pad), (0, 0)))
    ah, bh = tf32(a), tf32(b)
    pairs = [(x.astype(np.float64), y.astype(np.float64)) for x, y in (
        (tf32(a - ah), bh), (ah, tf32(b - bh)), (ah, bh))]
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for c0 in range(0, a.shape[1], 8 * ksteps):
        acc = np.zeros_like(out)
        for k0 in range(c0, min(c0 + 8 * ksteps, a.shape[1]), 8):
            for x, y in pairs:
                acc = _toward_zero(acc.astype(np.float64)
                                   + x[:, k0:k0 + 8] @ y[k0:k0 + 8])
        out = (out + acc).astype(np.float32)
    return out


# the u GEMM at the sites: contraction length and k-steps of a K chunk
U_SITES = {"A": (3 * 25, 10), "B": (128 * 4, 4), "D": (32 * 4, 4)}


@pytest.mark.parametrize("site", sorted(U_SITES))
def test_u_gemm_summed_a_k_step_at_a_time_does_not_drift(site):
    """The accumulator truncates, so a u summed across the k-steps of a K
    chunk in it drifts toward zero, and the drift reaches the batch mean;
    summed a k-step at a time from zero (``mma3_add``) the drift is gone
    to a tenth of that or better at site A, and the spread of the error
    is at most an f32 FMA chain's. Half-normal x against zero-mean
    weights, as ``smoke.k4_inputs`` makes them."""
    k, ksteps = U_SITES[site]
    rng = np.random.default_rng(zlib.crc32(f"u/{site}".encode()))
    x = np.abs(rng.standard_normal((4000, k))).astype(np.float32)
    w = (rng.uniform(-1, 1, (k, 8)) / np.sqrt(k)).astype(np.float32)
    exact = x.astype(np.float64) @ w.astype(np.float64)
    scale = np.abs(exact).mean()
    fma = np.zeros(exact.shape, np.float32)
    for i in range(k):
        fma = (fma + x[:, i:i + 1].astype(np.float64)
               * w[i].astype(np.float64)).astype(np.float32)

    def drift_spread(u):
        e = u.astype(np.float64) - exact
        return (-(e * np.sign(exact)).mean() / scale,
                np.sqrt((e * e).mean()) / scale)

    chunk = drift_spread(u_gemm_3xtf32(x, w, ksteps))
    kstep = drift_spread(u_gemm_3xtf32(x, w, 1))
    assert chunk[0] > 0 and kstep[0] < chunk[0] / 3, (chunk, kstep)
    assert abs(kstep[0]) < 1e-7, kstep
    assert kstep[1] <= 1.1 * drift_spread(fma)[1], (kstep, chunk)
    if site == "A":
        assert kstep[0] < chunk[0] / 10, (chunk, kstep)
