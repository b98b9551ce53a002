"""A plain model of K3-bwd's three 7x7 GEMMs (csrc/head_stack.cu), held against
the port's plain backward and the JAX package's gradient of its Pallas
kernel (interpret mode), and the 3xTF32 arithmetic emulated at the GEMMs'
contraction lengths.

Per 16 x 16 output tile, both heads stacked (n = (h, c), 16 columns):
  u1:  M = the tile + 7 (30 x 30 pixels), N = 16, K = (ky, kx, ci) = 784:
       x staged on the tile + 10, pixel (r, c) reading (r + ky, c + kx);
       B = wu (16, 784); u1 is 0 outside the image
  dx:  M = the tile's 256 pixels, N = 16 input channels, K = (ky, kx, h, c)
       = 784: du1 staged on the tile + 3, pixel (r, c) reading
       (r + 6 - ky, c + 6 - kx); B = wdx (16, 784); the heads' sum is part
       of the GEMM
  dw1: the transposed product du1^T x, M = 16 (h, c), N = 784 (ky, kx, ci),
       K = the tile's pixels, x read at (r + 3 + ky, c + 3 + kx) of the
       tile + 3; each tile's product is one K chunk, added in f32 to its
       block's sum; a block walks up to 16 tiles of a tile row and writes
       one partial, and the partials are summed.
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
from torch.nn.grad import conv2d_input

from baryon_painter_tpu.ops.pallas_head_stack import \
    head_stack as jax_head_stack
from baryon_painter_tpu_torch import smoke
from baryon_painter_tpu_torch.ops.head_stack import (gemm_weights,
                                                     head_stack_bwd_ref)
from mma_emulation import exact_gemm, mma_gemm

T, WALK = smoke.K3_TILE, smoke.K3_WALK
KC = 7 * 16    # the u1 and dx GEMMs' K chunk: a row of 7 taps x 16


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


def _im2col(src, off, size, flip=False):
    """(size^2 pixels, 49 taps x channels), the tap slowest: pixel (r, c)
    reads src at (r + off + ky, c + off + kx), or with ``flip`` at
    (r + off - ky, c + off - kx)."""
    s = -1 if flip else 1
    return np.concatenate(
        [src[off + s * ky:off + s * ky + size,
             off + s * kx:off + s * kx + size].reshape(size * size, -1)
         for ky in range(7) for kx in range(7)], axis=1)


def _tiles(h, w):
    return [(ty, tx) for ty in range(0, h, T) for tx in range(0, w, T)]


def u1_model(x, wu, gemm=exact_gemm):
    """u1 (N, H, W, 16) from each tile's GEMM on its tile + 7, kept on the
    tile (every region must agree with its neighbours: checked by the
    caller against the conv); also each region's values outside the
    image."""
    n, h, w, _ = x.shape
    out = np.zeros((n, h, w, 16))
    outside = []
    for b in range(n):
        for ty, tx in _tiles(h, w):
            xr = _region(x[b], ty - 10, tx - 10, 36)
            u = np.asarray(gemm(_im2col(xr, 0, 30), wu.T)).reshape(30, 30, 16)
            gy = ty - 7 + np.arange(30)[:, None]
            gx = tx - 7 + np.arange(30)[None, :]
            inside = (gy >= 0) & (gy < h) & (gx >= 0) & (gx < w)
            u = np.where(inside[..., None], u, 0.0)
            outside.append(np.abs(u[~inside]).max(initial=0.0))
            th, tw = min(T, h - ty), min(T, w - tx)
            out[b, ty:ty + th, tx:tx + tw] = u[7:7 + th, 7:7 + tw]
    return out, max(outside)


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
    args = [a.double() for a in _inputs(*shape)]
    x, w1 = args[0], args[1]
    wu, _ = gemm_weights(w1)
    got, outside = u1_model(x.numpy(), wu.numpy())
    want = torch.cat([F.conv2d(x.permute(0, 3, 1, 2),
                               w1[h].permute(3, 2, 0, 1), padding=3)
                      for h in range(2)], 1).permute(0, 2, 3, 1)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-10, atol=1e-10)
    assert outside == 0.0


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
    """u1 and dx in 3xTF32 with truncating accumulators over K = 784 in
    chunks of 112, dw1 with each tile's 256 pixels a chunk: within a tenth
    of K3_TOL of the exact products; one TF32 pass is not."""
    args = [a.double() for a in _inputs(1, 32, 32, seed=2)]
    x, w1 = args[0], args[1]
    wu, wdx = gemm_weights(w1)
    xn, du1 = x.numpy(), _du1(*args).numpy()
    u_want, _ = u1_model(xn, wu.numpy())
    dx_want, parts = dx_dw1_model(xn, du1, wdx.numpy())
    err = {}
    for mode in ("3xtf32", "tf32"):
        k784 = lambda a, b: mma_gemm(a, b, kstep=8, chunk=KC, mode=mode)
        tile = lambda a, b: mma_gemm(a, b, kstep=8, chunk=T * T, mode=mode)
        u, _ = u1_model(xn, wu.numpy(), k784)
        dx, p = dx_dw1_model(xn, du1, wdx.numpy(), k784, tile)
        err[mode] = {"u1": _rel(u, u_want), "dx": _rel(dx, dx_want),
                     "dw1": _rel(p.sum(0), parts.sum(0))}
    for name, tol in (("u1", smoke.K3_TOL["y"]), ("dx", smoke.K3_TOL["dx"]),
                      ("dw1", smoke.K3_TOL["dw1"])):
        assert err["3xtf32"][name] <= tol / 10, err
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
