"""A plain model of K3's three 7x7 GEMMs (csrc/head_stack.cu), held against
the port's plain versions and the JAX package's Pallas kernel (interpret
mode) and its gradient, and the 3xTF32 arithmetic emulated at the GEMMs'
contraction lengths.

Per 16 x 16 output tile, both heads stacked (n = (h, c), 16 columns):
  u1 (K3-fwd): M = the tile + 3 (22 x 22 pixels), N = 16, K = (ky, kx, ci)
       = 784 in k-steps of 8 (tap, channel half hf, r): x staged on the
       tile + 6 in 8 pair planes, plane 4 hf + t holding channels 8 hf + t
       (.x) and 8 hf + t + 4 (.y) of a pixel, pixel (ry, rx) at ry * 30 +
       rx; GEMM row p reads the pixel (p // 22) * 30 + p % 22 + ky * 30 +
       kx; thread tig's float2 is its A fragment pair k = tig, tig + 4. B =
       wu (16, 784) staged with each 8-wide k group permuted so k = tig and
       tig + 4 lie at 2 tig, 2 tig + 1. a1 = prelu(u1) on the region, 0
       outside the image; a kept u1 is stored for the tile's own pixels
       only; conv5 and conv3 follow on the regions.
  dx (K3-bwd): M = the tile's 256 pixels, N = 16 input channels, K = (ky,
       kx, h, c) = 784: du1 staged on the tile + 3, pixel (r, c) reading
       (r + 6 - ky, c + 6 - kx); B = wdx (16, 784); the heads' sum is part
       of the GEMM
  dw1 (K3-bwd): the transposed product du1^T x, M = 16 (h, c), N = 784
       (ky, kx, ci), K = the tile's pixels, x staged on the tile + 3 and
       read at (r + ky, c + kx); each tile's product is one K chunk, added
       in f32 to its block's sum; a block walks up to 16 tiles of a tile
       row and writes one partial, and the partials are summed.
K3-bwd stages the kept u1 on the tile + 7 (0 outside the image) for the
small convs of the chain.
The model builds the operands with those index rules. Its products are
exact (f64: the index rules alone) or the tensor cores' 3xTF32 emulation
(``mma_emulation``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from numpy.lib.stride_tricks import sliding_window_view
from torch.nn.grad import conv2d_input

from baryon_painter_tpu.ops.pallas_head_stack import \
    head_stack as jax_head_stack
from baryon_painter_tpu_torch import smoke
from baryon_painter_tpu_torch.ops.head_stack import (gemm_weights,
                                                     head_stack_bwd_ref,
                                                     head_stack_ref)
from mma_emulation import exact_gemm, mma_gemm

T, WALK = smoke.K3_TILE, smoke.K3_WALK
KC = 7 * 16    # the u1 and dx GEMMs' K chunk: a row of 7 taps x 16
# K3-fwd's staging (csrc/head_stack.cu kFX, kFXS, kFA1, kFPP, kLDWF)
FX, FXS, FA1, FPP, LDWF = 28, 30, 22, 844, 792
PADS = (3, 2, 1)


def _region(a, y0, x0, size):
    """a (H, W, C) on the square [y0, y0 + size) x [x0, x0 + size), zero
    outside the image."""
    h, w, c = a.shape
    out = np.zeros((size, size, c), np.float64)
    ys, xs = max(y0, 0), max(x0, 0)
    ye, xe = min(y0 + size, h), min(x0 + size, w)
    if ye > ys and xe > xs:
        out[ys - y0:ye - y0, xs - x0:xe - x0] = a[ys:ye, xs:xe]
    return out


def _inside(y0, x0, size, h, w):
    gy = y0 + np.arange(size)[:, None]
    gx = x0 + np.arange(size)[None, :]
    return (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)


def _im2col(src, off, size, flip=False):
    """(size^2 pixels, 49 taps x channels), the tap slowest: pixel (r, c)
    reads src at (r + off + ky, c + off + kx), or with ``flip`` at
    (r + off - ky, c + off - kx)."""
    s = -1 if flip else 1
    return np.concatenate(
        [src[off + s * ky:off + s * ky + size,
             off + s * kx:off + s * kx + size].reshape(size * size, -1)
         for ky in range(7) for kx in range(7)], axis=1)


def stage_pairs(xr):
    """x on the tile + 6 (28, 28, 16) in K3-fwd's pair planes (8, 844, 2);
    the slots no pixel fills (columns 28, 29 of a row, the planes' tail)
    are NaN, so a read of one poisons the product."""
    out = np.full((8, FPP, 2), np.nan)
    q = (np.arange(FX)[:, None] * FXS + np.arange(FX)[None, :]).ravel()
    for hf in range(2):
        for t in range(4):
            out[4 * hf + t, q, 0] = xr[..., 8 * hf + t].ravel()
            out[4 * hf + t, q, 1] = xr[..., 8 * hf + t + 4].ravel()
    return out


def stage_weights(wu):
    """wu (16, 784) as K3-fwd stages it (16, 792): k = 8 grp + r at
    8 grp + 2 (r % 4) + r // 4; the row's tail is NaN."""
    ws = np.full((16, LDWF), np.nan)
    k = np.arange(784)
    r = k % 8
    ws[:, k - r + 2 * (r % 4) + r // 4] = wu
    return ws


def qrow(p):
    """The pair-plane pixel of GEMM row p (of the tile + 3) at tap (0, 0)."""
    return (p // FA1) * FXS + p % FA1


def fwd_operands(pairs, ws):
    """A (484, 784) and B (784, 16) of the u1 GEMM as the fragments read
    them: at k-step (ky, s), s = 2 kx + hf, thread tig loads the float2 of
    pair plane 4 hf + tig at pixel qrow(p) + 30 ky + kx for A (.x is k =
    kb + tig, .y k = kb + tig + 4) and the float2 of staged weight row n at
    kb + 2 tig for B (the same two k)."""
    rows = qrow(np.arange(FA1 * FA1))
    a = np.empty((rows.size, 784))
    b = np.empty((784, 16))
    for ky in range(7):
        for s in range(14):
            kb = ky * KC + 8 * s
            for tig in range(4):
                pair = pairs[4 * (s & 1) + tig, rows + ky * FXS + (s >> 1)]
                a[:, kb + tig], a[:, kb + tig + 4] = pair[:, 0], pair[:, 1]
                b[kb + tig] = ws[:, kb + 2 * tig]
                b[kb + tig + 4] = ws[:, kb + 2 * tig + 1]
    return a, b


def _prelu(u, a):
    return np.where(u >= 0, u, a * u)


def fwd_model(x, w1, w2, w3, al, gemm=exact_gemm):
    """K3-fwd by its index rules: y (N, 2, H, W), the kept u1 (N, H, W, 16)
    and how many times each u1 pixel was stored."""
    x, w1, w2, w3, al = (np.asarray(t, np.float64)
                         for t in (x, w1, w2, w3, al))
    n, h, w, _ = x.shape
    ws = stage_weights(gemm_weights(torch.from_numpy(w1))[0].numpy())
    y = np.zeros((n, 2, h, w))
    u1 = np.zeros((n, h, w, 16))
    stores = np.zeros((n, h, w), int)
    for b in range(n):
        for ty, tx in _tiles(h, w):
            a, bm = fwd_operands(stage_pairs(_region(x[b], ty - 6, tx - 6,
                                                     FX)), ws)
            u = np.asarray(gemm(a, bm), np.float64).reshape(FA1, FA1, 16)
            th, tw = min(T, h - ty), min(T, w - tx)
            u1[b, ty:ty + th, tx:tx + tw] = u[3:3 + th, 3:3 + tw]
            stores[b, ty:ty + th, tx:tx + tw] += 1
            in1 = _inside(ty - 3, tx - 3, FA1, h, w)
            in2 = _inside(ty - 1, tx - 1, T + 2, h, w)
            for hd in range(2):
                a1 = np.where(in1[..., None],
                              _prelu(u[..., 8 * hd:8 * hd + 8], al[hd, 0]),
                              0.0)
                u2 = np.einsum("yxcij,ijc->yx",
                               sliding_window_view(a1, (5, 5), (0, 1)),
                               w2[hd, ..., 0])
                a2 = np.where(in2, _prelu(u2, al[hd, 1]), 0.0)
                yt = np.einsum("yxij,ij->yx",
                               sliding_window_view(a2, (3, 3)),
                               w3[hd, ..., 0, 0])
                y[b, hd, ty:ty + th, tx:tx + tw] = yt[:th, :tw]
    return y, u1, stores


def _tiles(h, w):
    return [(ty, tx) for ty in range(0, h, T) for tx in range(0, w, T)]


def dx_dw1_model(x, du1, wdx, gemm=exact_gemm, dw1_gemm=exact_gemm):
    """dx (N, H, W, 16) and the blocks' dw1 partials (B, 16, 784) from the
    tiles' GEMMs, with du1 (N, H, W, 16) the gradient at u1."""
    n, h, w, _ = x.shape
    dx = np.zeros((n, h, w, 16))
    parts = []
    tiles_x = -(-w // T)
    for b in range(n):
        for ty in range(0, h, T):
            for g0 in range(0, tiles_x, WALK):
                block = np.zeros((16, 784), np.float32)
                for bx in range(g0, min(g0 + WALK, tiles_x)):
                    tx = bx * T
                    d = _region(du1[b], ty - 3, tx - 3, 22)
                    got = np.asarray(gemm(_im2col(d, 6, T, flip=True),
                                          wdx.T)).reshape(T, T, 16)
                    th, tw = min(T, h - ty), min(T, w - tx)
                    dx[b, ty:ty + th, tx:tx + tw] = got[:th, :tw]
                    xr = _region(x[b], ty - 3, tx - 3, 22)
                    a = d[3:3 + T, 3:3 + T].reshape(T * T, 16).T
                    block = block + np.asarray(
                        dw1_gemm(a, _im2col(xr, 0, T)), np.float32)
                parts.append(block)
    return dx, np.stack(parts)


def _dw1(parts):
    """(2, 7, 7, 16, 8) from the partials' [h, c][ky, kx, ci]."""
    return parts.sum(0).reshape(2, 8, 7, 7, 16).transpose(0, 2, 3, 4, 1)


def _inputs(n, h, w, seed=0):
    return smoke.head_inputs(n, h, w, "cpu", seed=seed)


def _du1(x, w1, w2, w3, al, dy):
    """The gradient at u1 (N, H, W, 16), both heads, in plain PyTorch."""
    xc = x.permute(0, 3, 1, 2)
    oihw = lambda w: w.permute(3, 2, 0, 1)
    out = []
    for h in range(2):
        u1 = F.conv2d(xc, oihw(w1[h]), padding=3)
        v1 = torch.where(u1 >= 0, u1, al[h, 0] * u1)
        u2 = F.conv2d(v1, oihw(w2[h]), padding=2)
        dv2 = conv2d_input(u2.shape, oihw(w3[h]), dy[:, h:h + 1], padding=1)
        du2 = torch.where(u2 >= 0, dv2, al[h, 1] * dv2)
        dv1 = conv2d_input(v1.shape, oihw(w2[h]), du2, padding=2)
        out.append(torch.where(u1 >= 0, dv1, al[h, 0] * dv1))
    return torch.cat(out, 1).permute(0, 2, 3, 1)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("shape", [(2, 16, 16), (1, 20, 37)],
                         ids=["one_tile", "ragged_tiles"])
def test_u1_gemm_is_both_heads_conv7(shape):
    """K3-fwd's u1 GEMM by its index rules (pair planes, the permuted
    weights, the tile + 3 rows) is both heads' conv7, stored once for
    every pixel; no unfilled staging slot is read (they are NaN)."""
    args = [a.double() for a in _inputs(*shape)]
    _, got, stores = fwd_model(*(a.numpy() for a in args[:5]))
    _, want = head_stack_ref(*args[:5], keep_u1=True)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-10, atol=1e-10)
    assert (stores == 1).all()


@pytest.mark.parametrize("shape", [(2, 16, 16), (1, 20, 36), (1, 12, 20)],
                         ids=["one_tile", "ragged_tiles", "partial_tiles"])
def test_forward_model_is_the_heads_and_the_pallas_kernel(shape):
    """y from the model's u1 region through a1 (zero outside the image),
    conv5 on the tile + 1 and conv3, against the plain forward and the JAX
    package's Pallas kernel (interpret mode, f32: its own tolerance)."""
    args = _inputs(*shape, seed=4)
    y, _, _ = fwd_model(*(a.numpy() for a in args[:5]))
    want = head_stack_ref(*(a.double() for a in args[:5]))
    np.testing.assert_allclose(y, want.numpy(), rtol=1e-10, atol=1e-10)
    jargs = [jnp.asarray(a.numpy()) for a in args[:5]]
    np.testing.assert_allclose(y, np.asarray(jax_head_stack(*jargs, PADS,
                                                            True)),
                               rtol=2e-5, atol=2e-5)


def test_fwd_fragment_loads_hit_every_bank():
    """Each half-warp phase of K3-fwd's 64-bit fragment loads (16 lanes,
    g = 0..3 or 4..7 by tig) reads 32 distinct banks: A from the pair
    planes at every k-step of every m16 tile, B from the staged weights."""
    rows = qrow(np.arange(FA1 * FA1))
    rows = np.concatenate([rows, np.zeros(-rows.size % 16, int)])
    for ky in range(7):
        for s in range(14):
            for tile in range(rows.size // 16):
                for g0 in (0, 4):
                    for hh in (0, 1):
                        banks = [
                            (2 * ((4 * (s & 1) + tig) * FPP
                                  + rows[16 * tile + g + 8 * hh]
                                  + ky * FXS + (s >> 1)) + e) % 32
                            for g in range(g0, g0 + 4) for tig in range(4)
                            for e in (0, 1)]
                        if 16 * tile + g0 + 3 + 8 * hh < FA1 * FA1:
                            assert len(set(banks)) == 32, (ky, s, tile)
            for j in (0, 1):
                for g0 in (0, 4):
                    banks = [((8 * j + g) * LDWF + ky * KC + 8 * s + 2 * tig
                              + e) % 32 for g in range(g0, g0 + 4)
                             for tig in range(4) for e in (0, 1)]
                    assert len(set(banks)) == 32, (ky, s, j)


def test_bwd_u1_staging_feeds_the_small_convs():
    """K3-bwd stages the kept u1 on the tile + 7, 0 outside the image; conv5
    of prelu of that region is u2 on the tile + 5 wherever it lies in the
    image (where the chain uses it)."""
    x, w1, w2, w3, al, _ = (a.double() for a in _inputs(1, 21, 37, seed=5))
    _, u1 = head_stack_ref(x, w1, w2, w3, al, keep_u1=True)
    u1 = u1.numpy()[0]
    for hd in range(2):
        a1 = _prelu(u1[..., 8 * hd:8 * hd + 8], al[hd, 0].item())
        want = F.conv2d(torch.from_numpy(a1).permute(2, 0, 1)[None],
                        w2[hd].permute(3, 2, 0, 1), padding=2)[0, 0].numpy()
        for ty, tx in _tiles(21, 37):
            r = _prelu(_region(u1, ty - 7, tx - 7, 30)[..., 8 * hd:8 * hd + 8],
                       al[hd, 0].item())
            u2 = np.einsum("yxcij,ijc->yx", sliding_window_view(r, (5, 5),
                                                                (0, 1)),
                           w2[hd, ..., 0].numpy())
            ys, xs = np.nonzero(_inside(ty - 5, tx - 5, T + 10, 21, 37))
            np.testing.assert_allclose(
                u2[ys, xs], want[ty - 5 + ys, tx - 5 + xs], rtol=1e-10,
                atol=1e-10)


@pytest.mark.parametrize("shape", [(2, 16, 16), (1, 20, 280)],
                         ids=["one_tile", "two_blocks_a_row"])
def test_dx_and_dw1_gemms_are_the_gradients(shape):
    """dx (the transposed conv of du1, both heads) and dw1 (du1^T x over
    the tiles, summed per block and then over the partials) against the
    plain backward and the gradient of the Pallas kernel."""
    args = _inputs(*shape, seed=1)
    d = [a.double() for a in args]
    x, w1 = d[0], d[1]
    _, wdx = gemm_weights(w1)
    dx, parts = dx_dw1_model(x.numpy(), _du1(*d).numpy(), wdx.numpy())
    assert len(parts) == smoke.k3_bwd_blocks(*shape)
    want = head_stack_bwd_ref(*d)
    np.testing.assert_allclose(dx, want[0].numpy(), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(_dw1(parts), want[1].numpy(), rtol=1e-5,
                               atol=1e-5)   # dw1 summed in f32, as blocks do
    pads = (3, 2, 1)
    jargs = [jnp.asarray(a.numpy()) for a in args[:5]]
    dy = np.asarray(args[5])
    jdx, jdw1 = jax.grad(
        lambda *a: jnp.sum(jax_head_stack(*a, pads, True) * dy),
        argnums=(0, 1))(*jargs)
    np.testing.assert_allclose(dx, np.asarray(jdx), rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(_dw1(parts), np.asarray(jdw1), rtol=5e-4,
                               atol=5e-5)


def test_3xtf32_emulation_at_k784_meets_k3_tol():
    """K3-fwd's u1 (and y from it) and K3-bwd's dx in 3xTF32 with truncating
    accumulators over K = 784 in chunks of 112, in the kernels' operand
    order (the forward's pair planes and permuted weights), dw1 with each
    tile's 256 pixels a chunk: within a tenth of K3_TOL of the exact
    products; one TF32 pass is not."""
    args = [a.double() for a in _inputs(1, 32, 32, seed=2)]
    x, w1 = args[0], args[1]
    _, wdx = gemm_weights(w1)
    fwd_args = [a.numpy() for a in args[:5]]
    xn, du1 = x.numpy(), _du1(*args).numpy()
    y_want, u_want, _ = fwd_model(*fwd_args)
    dx_want, parts = dx_dw1_model(xn, du1, wdx.numpy())
    err = {}
    for mode in ("3xtf32", "tf32"):
        k784 = lambda a, b: mma_gemm(a, b, kstep=8, chunk=KC, mode=mode)
        tile = lambda a, b: mma_gemm(a, b, kstep=8, chunk=T * T, mode=mode)
        y, u, _ = fwd_model(*fwd_args, gemm=k784)
        dx, p = dx_dw1_model(xn, du1, wdx.numpy(), k784, tile)
        err[mode] = {"y": _rel(y, y_want), "u1": _rel(u, u_want),
                     "dx": _rel(dx, dx_want),
                     "dw1": _rel(p.sum(0), parts.sum(0))}
    for name in ("y", "u1", "dx", "dw1"):
        assert err["3xtf32"][name] <= smoke.K3_TOL[name] / 10, err
        assert err["tf32"][name] > err["3xtf32"][name] * 30, err


@pytest.mark.parametrize("chunk", [T * T, WALK * T * T],
                         ids=["a_tile_a_chunk", "a_block_in_one_chunk"])
def test_3xtf32_dw1_over_a_blocks_pixels(chunk):
    """dw1 over one block's 16 tiles (4,096 pixels): with each tile's sum a
    chunk added in f32, as the kernel does, 3xTF32 stays within a tenth of
    K3_TOL's 1e-3; summed in one truncating accumulator it drifts several
    times further (the lesson of K4's dW at site A)."""
    rng = np.random.default_rng(3)
    k = WALK * T * T
    a = rng.standard_normal((16, k)).astype(np.float32)
    b = rng.standard_normal((k, 8)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    err = _rel(mma_gemm(a, b, kstep=8, chunk=chunk), want)
    if chunk == T * T:
        assert err <= smoke.K3_TOL["dw1"] / 10
    else:
        assert err > _rel(mma_gemm(a, b, kstep=8, chunk=T * T), want)
