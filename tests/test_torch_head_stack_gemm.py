"""A plain model of K3's kernels (csrc/head_stack.cu) by their index rules,
held against the port's plain versions and the JAX package's Pallas kernel
(interpret mode) and its gradient, and the tensor cores' arithmetic
emulated at the GEMMs' contraction lengths.

The design computes every pixel's 7x7 products once, in passes:
  u1 GEMM (K3-fwd): tiles of 24 (f32) or 48 (bf16) x 16 pixels; a
       warpgroup's warp w holds tile rows 4 wg + w + 12 m of its two (f32)
       or four (bf16) m64 tiles; the tile's window of
       x, rows and columns - 3 .. + 3, lands by TMA (zeros outside the
       image) as 16-channel pixel rows in the 64-byte (f32) or 32-byte
       (bf16) swizzle; each k-step's A fragment is one ldmatrix.x4 whose
       lane group mi gives the row addresses of its matrix (pixel column
       lane % 8 + 8 (mi % 2), the k-step's tap and 16-byte chunk); B is
       ``gemm_weights``' wu, K = (ky, kx, ci) padded to 128-byte rows.
  chain (K3-fwd): 24 x 32 tiles; a1 on the tile + 3 (rows of 40, planar),
       a2 on the tile + 1 in runs of 4 columns, y.
  chain (K3-bwd): 16 x 32 tiles, a head at a time: a1 on the tile + 4, dy
       on the tile + 3, u2 and du2 on the tile + 2, du1 (rounded to x's
       dtype), dw2, dw3, dalpha at the owned pixels.
  dx GEMM (K3-bwd): as u1 over the window of du1, read at (r + 3 - ky, c +
       3 - kx), K = (h, ky, kx, c) with each head's 392 padded to whole rows
       (in bf16 each head's sum is rounded, then the two added and rounded).
  dw1 GEMM (K3-bwd): chunks of 4 rows x 32 (f32) or 64 (bf16) columns, in
       splits of consecutive chunks sized from the SM count; M = (tap, ci)
       in m64 tiles of 4 taps (f32: a tap's rows ordered so that the 32-bit
       gathers hit every bank), K = the chunk's pixels; du1 transposed into
       K-major B tiles, x gathered from its window (rows and columns - 3 ..
       + 3 of the chunk).
The tensor cores' sums truncate: f32 sums each 128-byte K row (4 k-steps)
from zero and adds it into an f32 side sum; bf16 sums a head's rows (u1:
all of K) or a dw1 chunk's in one accumulator. Products are exact (f64: the
index rules alone) or the tensor cores' arithmetic emulated
(``mma_emulation``).
"""
import importlib.util
from pathlib import Path

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
                                                     head_stack_bwd_ref,
                                                     head_stack_ref)
from mma_emulation import exact_gemm, mma_gemm

REPO = Path(__file__).resolve().parent.parent
F32, BF16 = "float32", "bfloat16"
# csrc/head_stack.cu: the pixel GEMMs' tile rows (gemm_tr) and columns
# (kTW) and window width (kFW); the chains' tiles (kCFH, kCFW; kCBH, kCBW);
# dw1's chunk rows (kRD)
TRS, TW, FW = {"float32": 24, "bfloat16": 48}, 16, 22
CFH, CFW = 24, 32
CBH, CBW = smoke.K3_CHAIN_TILE
RD = smoke.K3_DW1_ROWS
PADS = (3, 2, 1)


def kch(dtype):
    """K values of a 128-byte row (a wgmma k-step is a quarter of it)."""
    return 32 if dtype == F32 else 64


def ebytes(dtype):
    return 4 if dtype == F32 else 2


def swz_off(p, ci, dtype):
    """Byte offset of channel ci of pixel row p in a TMA-swizzled window:
    f32 64-byte rows, 16-byte chunk j at j ^ (p / 2 % 4); bf16 32-byte
    rows, j ^ (p / 4 % 2)."""
    p, ci = np.asarray(p), np.asarray(ci)
    e = ebytes(dtype)
    per = 16 // e
    j = ci // per
    if dtype == F32:
        j = j ^ ((p >> 1) & 3)
        return p * 64 + j * 16 + (ci % per) * e
    j = j ^ ((p >> 2) & 1)
    return p * 32 + j * 16 + (ci % per) * e


def box(a, y0, x0, rows, cols):
    """a (H, W, 16) on rows [y0, y0 + rows) x columns [x0, x0 + cols), zero
    outside (a TMA box), as (rows * cols, 16)."""
    h, w, c = a.shape
    out = np.zeros((rows, cols, c), np.float64)
    ys, xs = max(y0, 0), max(x0, 0)
    ye, xe = min(y0 + rows, h), min(x0 + cols, w)
    if ye > ys and xe > xs:
        out[ys - y0:ye - y0, xs - x0:xe - x0] = a[ys:ye, xs:xe]
    return out.reshape(rows * cols, c)


def swizzled(win, dtype):
    """The window's shared memory as elements (NaN where no pixel lands)."""
    e = ebytes(dtype)
    flat = np.full(win.size, np.nan)
    p, ci = np.meshgrid(np.arange(win.shape[0]), np.arange(16),
                        indexing="ij")
    flat[swz_off(p, ci, dtype) // e] = win
    return flat


def ldm(flat, addr, dtype):
    """The 16 bytes at each byte address (an ldmatrix row): (..., 16 / e)."""
    e = ebytes(dtype)
    idx = np.asarray(addr)[..., None] // e + np.arange(16 // e)
    return flat[idx]


def kstep_tap(ks, mi, dtype, kind):
    """csrc/head_stack.cu kstep_tap: the tap and 16-byte chunk matrix mi of
    k-step ks reads (u1: K = (ky, kx, ci); dx: (h, ky, kx, c))."""
    if kind == "u1":
        if dtype == F32:
            tap, chunk = ks >> 1, 2 * (ks & 1) + (mi >> 1)
        else:
            tap, chunk = ks, mi >> 1
    else:
        sh = 2 * (2 * -(-392 // kch(dtype)))
        h = int(ks >= sh)
        s = ks - h * sh
        if dtype == F32:
            tap, chunk = s, 2 * h + (mi >> 1)
        else:
            tap, chunk = 2 * s + (mi >> 1), h
    return min(tap, 48), chunk


def gemm_rows(dtype, kind):
    return (-(-784 // kch(dtype)) if kind == "u1"
            else 2 * -(-392 // kch(dtype)))


def tile_a(flat, dtype, kind):
    """A (tile pixels, rows x 128-byte K) of the u1 or dx GEMM as the
    ldmatrix fragments read it from the swizzled window."""
    ksteps = 4 * gemm_rows(dtype, kind)
    kstep = kch(dtype) // 4
    half = kstep // 2
    tr = TRS[dtype]
    rows = np.arange(tr)[:, None]
    a = np.zeros((tr, TW, ksteps * kstep))
    for ks in range(ksteps):
        for mi in range(4):
            tap, chunk = kstep_tap(ks, mi, dtype, kind)
            toff = (tap // 7) * FW + tap % 7
            rho = np.arange(8)[None, :] + 8 * (mi & 1)
            if kind == "u1":
                p = rows * FW + rho + toff
            else:
                p = (rows + 6) * FW + rho + 6 - toff
            addr = p * (16 * ebytes(dtype)) + (
                (chunk ^ ((p >> 1) & 3)) if dtype == F32
                else (chunk ^ ((p >> 2) & 1))) * 16
            k0 = ks * kstep + (mi >> 1) * half
            a[:, 8 * (mi & 1):8 * (mi & 1) + 8, k0:k0 + half] = ldm(
                flat, addr, dtype)
    return a.reshape(tr * TW, -1)


def b_matrix(w, dtype):
    """B (Kp, 16) from ``gemm_weights``' (parts, 16, Kp): the parts summed
    (big + small is w exactly)."""
    return w.double().sum(0).numpy().T


def gemm_tiles(h, w, dtype):
    return [(ty, tx) for ty in range(0, h, TRS[dtype])
            for tx in range(0, w, TW)]


def u1_model(x, w1, dtype=F32, gemm=exact_gemm):
    """The u1 GEMM: u1 (N, H, W, 16) and how often each pixel was stored."""
    n, h, w, _ = x.shape
    b = b_matrix(gemm_weights(torch.as_tensor(w1),
                              getattr(torch, dtype))[0], dtype)
    u1 = np.zeros((n, h, w, 16))
    stores = np.zeros((n, h, w), int)
    tr = TRS[dtype]
    for s in range(n):
        for ty, tx in gemm_tiles(h, w, dtype):
            flat = swizzled(box(x[s], ty - 3, tx - 3, tr + 6, FW), dtype)
            u = np.asarray(gemm(tile_a(flat, dtype, "u1"), b)).reshape(
                tr, TW, 16)
            th, tw = min(tr, h - ty), min(TW, w - tx)
            u1[s, ty:ty + th, tx:tx + tw] = u[:th, :tw]
            stores[s, ty:ty + th, tx:tx + tw] += 1
    return u1, stores


def dx_model(du1, w1, dtype=F32, gemm=exact_gemm):
    """The dx GEMM from du1 (N, H, W, 16): f32 one sum over both heads;
    bf16 each head's sum rounded to bf16, the two added and rounded."""
    n, h, w, _ = du1.shape
    b = b_matrix(gemm_weights(torch.as_tensor(w1),
                              getattr(torch, dtype))[1], dtype)
    kh = b.shape[0] // 2
    dx = np.zeros((n, h, w, 16))
    tr = TRS[dtype]
    for s in range(n):
        for ty, tx in gemm_tiles(h, w, dtype):
            flat = swizzled(box(du1[s], ty - 3, tx - 3, tr + 6, FW), dtype)
            a = tile_a(flat, dtype, "dx")
            if dtype == F32:
                d = np.asarray(gemm(a, b), np.float64)
            else:
                d = sum(_bf16(np.asarray(gemm(a[:, i * kh:(i + 1) * kh],
                                              b[i * kh:(i + 1) * kh])))
                        for i in range(2))
                d = _bf16(d)
            th, tw = min(tr, h - ty), min(TW, w - tx)
            dx[s, ty:ty + th, tx:tx + tw] = d.reshape(tr, TW, 16)[:th, :tw]
    return dx


def _bf16(v):
    return torch.as_tensor(np.asarray(v, np.float32)).bfloat16().double() \
        .numpy()


def dw1_split(n, h, w, dtype, sms=smoke.H100_SMS):
    """dw1's chunks, chunks a split and splits (csrc/head_stack.cu dw_geo)."""
    chunks = n * -(-h // RD) * -(-w // kch(dtype))
    per = -(-chunks // min(sms, chunks))
    return chunks, per, -(-chunks // per)


def dw1_channel(rho, dtype):
    if dtype == F32:
        return (rho & 3) + 4 * (rho >> 3) + 8 * ((rho >> 2) & 1)
    return rho


def dw1_chunk_a(flat, dtype, cw):
    """A (49 taps, a tap's 16 rows, the chunk's RD x cw pixels) as the
    kernel gathers it from the x window (rows RD + 6, columns cw + 6)."""
    fwx = cw + 6
    tap = np.arange(49)[:, None, None]
    ky, kx = tap // 7, tap % 7
    a = np.zeros((49, 16, RD * cw))
    e = ebytes(dtype)
    for r in range(RD):
        for kk in range(4):
            if dtype == F32:
                gl = np.arange(8)[None, :, None]
                tig = np.arange(4)[None, None, :]
                p0 = (r + ky) * fwx + 8 * kk + tig + kx
                ci0 = (gl & 3) + 8 * (gl >> 2)
                cols = r * cw + 8 * kk + np.arange(4)
                for dp, dk in ((0, 0), (4, 4)):
                    for dr, dc in ((0, 0), (8, 4)):
                        a[:, dr:dr + 8, cols + dk] = flat[
                            swz_off(p0 + dp, ci0 + dc, dtype) // e]
            else:
                for mi in range(4):
                    li = np.arange(8)[None, :]
                    p = ((r + ky[:, :, 0]) * fwx + 16 * kk + 8 * (mi >> 1)
                         + li + kx[:, :, 0])
                    chunk = mi & 1
                    addr = p * 32 + ((chunk ^ ((p >> 2) & 1)) << 4)
                    rows = ldm(flat, addr, dtype)   # (tap, pixel li, chan)
                    cols = r * cw + 16 * kk + 8 * (mi >> 1) + np.arange(8)
                    a[:, 8 * chunk:8 * chunk + 8, cols] = rows.transpose(
                        0, 2, 1)
    return a


def dw1_model(x, du1, dtype=F32, gemm=exact_gemm, sms=smoke.H100_SMS):
    """dw1's partials (splits, 2, 49, 16, 8) = [h][tap][ci][c]: each split
    sums its chunks' products; a chunk's x window by TMA, du1 into B."""
    n, h, w, _ = x.shape
    cw = kch(dtype)
    chunks, per, splits = dw1_split(n, h, w, dtype, sms)
    segs, rbs = -(-w // cw), -(-h // RD)
    parts = np.zeros((splits, 2, 49, 16, 8))
    for c in range(chunks):
        s = c // (rbs * segs)
        y0 = (c % (rbs * segs)) // segs * RD
        x0 = c % segs * cw
        flat = swizzled(box(x[s], y0 - 3, x0 - 3, RD + 6, cw + 6), dtype)
        bmat = box(du1[s], y0, x0, RD, cw)          # (pixels, (h, c))
        a = dw1_chunk_a(flat, dtype, cw).reshape(49 * 16, RD * cw)
        prod = np.asarray(gemm(a, bmat), np.float64).reshape(49, 16, 2, 8)
        ci = dw1_channel(np.arange(16), dtype)
        # rows (tap, ci) to [h][tap][ci][c]
        parts[c // per][:, :, ci, :] += prod.transpose(2, 0, 1, 3)
    return parts


def _prelu(u, a):
    return np.where(u >= 0, u, a * u)


def fwd_chain_model(u1, w2, w3, al, dtype=F32):
    """The forward chain from u1: y (N, 2, H, W)."""
    n, h, w, _ = u1.shape
    rnd = (lambda v: v) if dtype == F32 else _bf16
    y = np.zeros((n, 2, h, w))
    for s in range(n):
        for ty in range(0, h, CFH):
            for tx in range(0, w, CFW):
                reg = box(u1[s], ty - 3, tx - 3, CFH + 6, 40).reshape(
                    CFH + 6, 40, 16)
                inside = box(np.ones((h, w, 1)), ty - 3, tx - 3, CFH + 6,
                             40).reshape(CFH + 6, 40) > 0
                inside[:, CFW + 6:] = False
                for hd in range(2):
                    a1 = np.where(inside[..., None],
                                  rnd(_prelu(reg[..., 8 * hd:8 * hd + 8],
                                             al[hd, 0])), 0.0)
                    a2 = np.zeros((CFH + 2, 36))
                    for py in range(CFH + 2):
                        for px in range(0, 36, 4):
                            seg = a1[py:py + 5, px:px + 8]     # (5, 8, c)
                            for o in range(4):
                                a2[py, px + o] = np.einsum(
                                    "ijc,ijc->", seg[:, o:o + 5],
                                    w2[hd, ..., 0])
                    in2 = box(np.ones((h, w, 1)), ty - 1, tx - 1, CFH + 2,
                              36).reshape(CFH + 2, 36) > 0
                    a2 = np.where(in2, rnd(_prelu(a2, al[hd, 1])), 0.0)
                    th, tw = min(CFH, h - ty), min(CFW, w - tx)
                    for py in range(th):
                        for px in range(tw):
                            y[s, hd, ty + py, tx + px] = np.sum(
                                a2[py:py + 3, px:px + 3] * w3[hd, ..., 0, 0])
    return rnd(y)


def bwd_chain_model(u1, dy, w2, w3, al, dtype=F32):
    """The backward chain from u1 and dy: du1 (N, H, W, 16) rounded to the
    dtype, dw2 (2, 5, 5, 8), dw3 (2, 3, 3), dalpha (2, 2)."""
    n, h, w, _ = u1.shape
    rnd = (lambda v: v) if dtype == F32 else _bf16
    du1 = np.zeros((n, h, w, 16))
    dw2, dw3, dal = np.zeros((2, 5, 5, 8)), np.zeros((2, 3, 3)), \
        np.zeros((2, 2))
    ones = np.ones((h, w, 1))
    for s in range(n):
        for ty in range(0, h, CBH):
            for tx in range(0, w, CBW):
                in4 = box(ones, ty - 4, tx - 4, CBH + 8, 40).reshape(
                    CBH + 8, 40) > 0
                in2 = box(ones, ty - 2, tx - 2, CBH + 4, 36).reshape(
                    CBH + 4, 36) > 0
                own = np.zeros((CBH + 4, 36), bool)
                own[2:2 + CBH, 2:2 + CBW] = True
                reg = box(u1[s], ty - 4, tx - 4, CBH + 8, 40).reshape(
                    CBH + 8, 40, 16)
                for hd in range(2):
                    a1 = np.where(in4[..., None],
                                  rnd(_prelu(reg[..., 8 * hd:8 * hd + 8],
                                             al[hd, 0])), 0.0)
                    dys = box(dy[s, hd][..., None], ty - 3, tx - 3, CBH + 6,
                              40).reshape(CBH + 6, 40)
                    dys[:, CBW + 6:] = 0.0
                    u2 = np.zeros((CBH + 4, 36))
                    for py in range(CBH + 4):
                        for px in range(0, 36, 4):
                            for o in range(4):
                                u2[py, px + o] = np.einsum(
                                    "ijc,ijc->", a1[py:py + 5,
                                                    px + o:px + o + 5],
                                    w2[hd, ..., 0])
                    u2 = np.where(in2, u2, 0.0)
                    dv2 = np.zeros_like(u2)
                    for ky in range(3):
                        for kx in range(3):
                            dv2 += w3[hd, ky, kx, 0, 0] * dys[
                                2 - ky:2 - ky + CBH + 4, 2 - kx:2 - kx + 36]
                    du2 = np.where(in2, rnd(np.where(u2 >= 0, dv2,
                                                     al[hd, 1] * dv2)), 0.0)
                    dal[hd, 1] += np.sum(np.where(in2 & own & (u2 < 0),
                                                  dv2 * u2, 0.0))
                    a2 = rnd(_prelu(u2, al[hd, 1]))
                    for ky in range(3):
                        for kx in range(3):
                            dw3[hd, ky, kx] += np.sum(
                                dys[3:3 + CBH, 3:3 + CBW]
                                * a2[1 + ky:1 + ky + CBH, 1 + kx:1 + kx + CBW])
                    for r in range(CBH):
                        for px in range(0, CBW, 4):
                            seg = np.stack([du2[r + 4 - ky, px:px + 8]
                                            for ky in range(5)])   # (5, 8)
                            for o in range(4):
                                gy, gx = ty + r, tx + px + o
                                if gy >= h or gx >= w:
                                    continue
                                dv1 = np.einsum(
                                    "ij,ijc->c",
                                    seg[:, o + 4 - np.arange(5)],
                                    w2[hd, ..., 0])
                                u = u1[s, gy, gx, 8 * hd:8 * hd + 8]
                                du1[s, gy, gx, 8 * hd:8 * hd + 8] = rnd(
                                    np.where(u >= 0, dv1, al[hd, 0] * dv1))
                                dal[hd, 0] += np.sum(np.where(u < 0, dv1 * u,
                                                              0.0))
                            d = du2[r + 2, px + 2:px + 6]
                            for ky in range(5):
                                a = a1[r + 2 + ky, px + 2:px + 10]   # (8, c)
                                for kx in range(5):
                                    dw2[hd, ky, kx] += d @ a[kx:kx + 4]
    return du1, dw2, dw3, dal


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


def _jax_grads(args, pads=PADS):
    jargs = [jnp.asarray(a.numpy()) for a in args[:5]]
    dy = np.asarray(args[5])
    return jax.grad(lambda *a: jnp.sum(jax_head_stack(*a, pads, True) * dy),
                    argnums=(0, 1))(*jargs)


@pytest.mark.parametrize("dtype", [F32, BF16])
@pytest.mark.parametrize("shape", [(1, 24, 16), (1, 29, 37)],
                         ids=["one_tile", "ragged_tiles"])
def test_u1_gemm_is_both_heads_conv7(shape, dtype):
    """The u1 GEMM by its index rules (the TMA window, its swizzle, each
    lane's ldmatrix row address, wu's K order and padding) is both heads'
    conv7 on x as the dtype holds it, stored once for every pixel; no
    unfilled shared-memory slot is read (they are NaN)."""
    args = [a.double() for a in _inputs(*shape)]
    x = args[0] if dtype == F32 else args[0].bfloat16().double()
    w1 = args[1] if dtype == F32 else args[1].bfloat16().double()
    got, stores = u1_model(x.numpy(), args[1].numpy(), dtype)
    _, want = head_stack_ref(x, w1, *args[2:5], keep_u1=True)
    np.testing.assert_allclose(got, want.numpy(), rtol=1e-10, atol=1e-10)
    assert (stores == 1).all()


@pytest.mark.parametrize("shape", [(2, 24, 32), (1, 28, 36), (1, 12, 20)],
                         ids=["one_tile", "ragged_tiles", "partial_tile"])
def test_forward_model_is_the_heads_and_the_pallas_kernel(shape):
    """y from the model's u1 through the forward chain (a1 on the tile + 3,
    zero outside the image and in the rows' padding columns, a2 in runs of
    4 on the tile + 1, conv3) against the plain forward and the JAX
    package's Pallas kernel (interpret mode, f32: its own tolerance)."""
    args = _inputs(*shape, seed=4)
    d = [a.double().numpy() for a in args[:5]]
    u1, _ = u1_model(*d[:2])
    y = fwd_chain_model(u1, *d[2:5])
    want = head_stack_ref(*(a.double() for a in args[:5]))
    np.testing.assert_allclose(y, want.numpy(), rtol=1e-10, atol=1e-10)
    jargs = [jnp.asarray(a.numpy()) for a in args[:5]]
    np.testing.assert_allclose(y, np.asarray(jax_head_stack(*jargs, PADS,
                                                            True)),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_fragment_loads_hit_every_bank(dtype):
    """Each ldmatrix phase (8 lanes, one matrix) of the u1 and dx GEMMs
    reads 8 distinct 16-byte bank groups of the swizzled window at every
    k-step and tile row; dw1's f32 gathers (32 lanes, 32-bit words) hit 32
    distinct banks, its bf16 ldmatrix.trans phases 8 groups."""
    rows = np.arange(TRS[dtype])
    for kind in ("u1", "dx"):
        for ks in range(4 * gemm_rows(dtype, kind)):
            for mi in range(4):
                tap, chunk = kstep_tap(ks, mi, dtype, kind)
                toff = (tap // 7) * FW + tap % 7
                rho = np.arange(8) + 8 * (mi & 1)
                for r in rows:
                    p = (r * FW + rho + toff if kind == "u1"
                         else (r + 6) * FW + rho + 6 - toff)
                    groups = (swz_off(p, 16 // ebytes(dtype) * chunk,
                                      dtype) >> 4) & 7
                    assert len(set(groups.tolist())) == 8, (kind, ks, mi, r)
    fwx = kch(dtype) + 6
    for tap in range(49):
        for r in range(RD):
            for kk in range(4):
                if dtype == F32:
                    gl, tig = np.meshgrid(np.arange(8), np.arange(4),
                                          indexing="ij")
                    p0 = (r + tap // 7) * fwx + 8 * kk + tig + tap % 7
                    ci0 = (gl & 3) + 8 * (gl >> 2)
                    for dp in (0, 4):
                        for dc in (0, 4):
                            banks = (swz_off(p0 + dp, ci0 + dc, F32) // 4) \
                                % 32
                            assert len(set(banks.ravel().tolist())) == 32
                else:
                    for mi in range(4):
                        p = ((r + tap // 7) * fwx + 16 * kk + 8 * (mi >> 1)
                             + np.arange(8) + tap % 7)
                        groups = (swz_off(p, 8 * (mi & 1), BF16) >> 4) & 7
                        assert len(set(groups.tolist())) == 8


@pytest.mark.parametrize("dtype", [F32, BF16])
def test_backward_chain_model_is_the_gradients(dtype):
    """The backward chain by its index rules (a1 on the tile + 4, dy on the
    tile + 3, u2 and du2 on the tile + 2, du1 from du2's row segments, dw2
    from a1's) against the plain backward from the same u1: du1 as the
    dx GEMM reads it (rounded to the dtype), dw2, dw3 and dalpha."""
    args = [a.double() for a in _inputs(1, 21, 37, seed=5)]
    if dtype == BF16:
        args[0] = args[0].bfloat16().double()
        args[5] = args[5].bfloat16().double()
    x, w1, w2, w3, al, dy = args
    wr = (lambda t: t) if dtype == F32 else (
        lambda t: t.bfloat16().double())
    _, u1 = head_stack_ref(x, wr(w1), w2, w3, al, keep_u1=True)
    du1, dw2, dw3, dal = bwd_chain_model(u1.numpy(), dy.numpy(),
                                         wr(w2).numpy(), wr(w3).numpy(),
                                         al.numpy(), dtype)
    want = head_stack_bwd_ref(x.to(getattr(torch, dtype)) if dtype == BF16
                              else x, w1, w2, w3, al,
                              dy.to(getattr(torch, dtype)) if dtype == BF16
                              else dy, u1=u1.float() if dtype == BF16 else u1)
    tol = 1e-10 if dtype == F32 else 1e-5
    np.testing.assert_allclose(dw2, want[2].numpy()[..., 0], rtol=tol,
                               atol=tol * np.abs(dw2).max())
    np.testing.assert_allclose(dw3, want[3].numpy()[..., 0, 0], rtol=tol,
                               atol=tol * np.abs(dw3).max())
    np.testing.assert_allclose(dal, want[4].numpy(), rtol=tol,
                               atol=tol * np.abs(dal).max())
    if dtype == F32:
        np.testing.assert_allclose(du1, _du1(*args).numpy(), rtol=1e-10,
                                   atol=1e-10)


@pytest.mark.parametrize("shape", [(1, 24, 32), (2, 12, 68)],
                         ids=["one_tile", "ragged_splits"])
def test_dx_and_dw1_gemms_are_the_gradients(shape):
    """dx (the transposed 7x7 conv of du1 over its window, K = (h, ky, kx,
    c)) and dw1 (du1^T x over chunks in splits sized from the SM count,
    the partials then summed) against the plain backward and the gradient
    of the Pallas kernel; with 3 SMs the chunks spread over 3 splits."""
    args = _inputs(*shape, seed=1)
    d = [a.double() for a in args]
    du1 = _du1(*d).numpy()
    dx = dx_model(du1, d[1].numpy())
    parts = dw1_model(d[0].numpy(), du1, sms=3)
    assert len(parts) == dw1_split(*shape, F32, sms=3)[2] == 3
    dw1 = parts.sum(0).reshape(2, 7, 7, 16, 8)
    assert smoke.k3_bwd_blocks(*shape)["dw1"] == dw1_split(*shape, F32)[2]
    want = head_stack_bwd_ref(*d)
    np.testing.assert_allclose(dx, want[0].numpy(), rtol=1e-10, atol=1e-10)
    np.testing.assert_allclose(dw1, want[1].numpy(), rtol=1e-10, atol=1e-10)
    jdx, jdw1 = _jax_grads(args)
    np.testing.assert_allclose(dx, np.asarray(jdx), rtol=5e-4, atol=5e-5)
    np.testing.assert_allclose(dw1, np.asarray(jdw1), rtol=5e-4, atol=5e-5)


def test_bf16_dx_rounds_each_head_before_the_sum():
    """In bf16 the dx GEMM keeps the heads' sums apart (each head's K its
    own rows) and rounds each to bf16 before adding and rounding again, as
    the JAX kernel sums the heads' dx in bf16: the model matches the plain
    bf16 backward entry for entry up to the f32 summation order, where one
    sum over both heads rounded once does not."""
    args = [a.double() for a in _inputs(1, 24, 16, seed=7)]
    x, w1 = args[0].bfloat16(), args[1]
    du1 = torch.as_tensor(_du1(*args).numpy()).bfloat16().double().numpy()
    got = dx_model(du1, w1.numpy(), BF16)
    # the plain backward's dx from this du1: per head in f32, rounded
    w1r = w1.bfloat16().double()
    xc = x.double().permute(0, 3, 1, 2)
    dd = torch.as_tensor(du1).permute(0, 3, 1, 2)
    heads = [conv2d_input(xc.shape, w1r[h].permute(3, 2, 0, 1),
                          dd[:, 8 * h:8 * h + 8], padding=3)
             for h in range(2)]
    want = _bf16(_bf16(heads[0].float()) + _bf16(heads[1].float()))
    once = _bf16((heads[0] + heads[1]).float())
    want = want.transpose(0, 2, 3, 1)
    once = once.transpose(0, 2, 3, 1)
    step = np.abs(want).max() * 2.0 ** -8
    assert np.abs(got - want).max() <= step
    assert (got != want).mean() < 0.01
    assert (once != want).mean() > 5 * (got != want).mean()


def test_3xtf32_emulation_at_k784_meets_k3_tol():
    """u1 (and y from it) and dx in 3xTF32 with truncating accumulators,
    each 128-byte K row (32 values, 4 k-steps) summed from zero and added
    in f32 (a row later, while the next row's products run), over K = 784 (u1, padded to 800) and 2 x 392 (dx, each head
    padded to 416), in the kernels' operand order: within a tenth of
    K3_TOL of the exact products; one TF32 pass is not."""
    args = [a.double() for a in _inputs(1, 24, 16, seed=2)]
    d = [a.numpy() for a in args]
    du1 = _du1(*args).numpy()
    u_want, _ = u1_model(*d[:2])
    y_want = fwd_chain_model(u_want, *d[2:5])
    dx_want = dx_model(du1, d[1])
    err = {}
    for mode in ("3xtf32", "tf32"):
        row = lambda a, b: mma_gemm(a, b, kstep=8, chunk=32, mode=mode)
        u, _ = u1_model(*d[:2], gemm=row)
        y = fwd_chain_model(u, *d[2:5])
        err[mode] = {"y": _rel(y, y_want), "u1": _rel(u, u_want),
                     "dx": _rel(dx_model(du1, d[1], gemm=row), dx_want)}
    for name in ("y", "u1", "dx"):
        assert err["3xtf32"][name] <= smoke.K3_TOL[name] / 10, err
        assert err["tf32"][name] > err["3xtf32"][name] * 30, err


@pytest.mark.parametrize("chunk", [32, None],
                         ids=["a_row_a_chunk", "the_split_in_one_chunk"])
def test_3xtf32_dw1_over_a_splits_pixels(chunk):
    """dw1 over one split's pixels at the training shape (49,152 chunks of
    4 x 32 pixels in 132 splits: 373 chunks, 47,744 pixels): with each
    128-byte K row (32 pixels) summed from zero and added in f32, as the
    kernel drains it, 3xTF32 stays within a tenth of K3_TOL's 1e-3; in one
    truncating accumulator over the split it drifts further."""
    chunks, per, splits = dw1_split(24, 512, 512, F32)
    assert (chunks, per, splits) == (49152, 373, 132)
    assert smoke.k3_bwd_blocks(24, 512, 512)["dw1"] == splits
    k = per * RD * kch(F32)
    rng = np.random.default_rng(3)
    a = rng.standard_normal((16, k)).astype(np.float32)
    b = rng.standard_normal((k, 8)).astype(np.float32)
    want = a.astype(np.float64) @ b.astype(np.float64)
    err = _rel(mma_gemm(a, b, kstep=8, chunk=chunk or k), want)
    if chunk:
        assert err <= smoke.K3_TOL["dw1"] / 10
    else:
        assert err > _rel(mma_gemm(a, b, kstep=8, chunk=32), want)


@pytest.mark.parametrize("case", ["u1_dx", "dw1_split"])
def test_bf16_products_in_one_accumulator_meet_k3_tol_bf16(case):
    """bf16 products are exact in f32, so only the accumulator's truncating
    adds err: u1 over all of K (784, padded to 832: 52 k-steps) and dx over
    a head's 392 (padded to 448) in one accumulator each, and dw1 summed a
    chunk (4 rows of 64 pixels) at a time over one split at the training
    shape (24,576 chunks in 132 splits: 187 chunks), stay within a tenth of
    K3_TOL_BF16's f32 u1 limit (1e-4)."""
    rng = np.random.default_rng(5)
    bf = lambda a: torch.as_tensor(a).bfloat16().float().numpy()
    if case == "u1_dx":
        for k in (832, 448):
            a = bf(rng.standard_normal((256, k)).astype(np.float32))
            b = bf(rng.standard_normal((k, 16)).astype(np.float32))
            want = a.astype(np.float64) @ b.astype(np.float64)
            got = mma_gemm(a, b, kstep=16, chunk=k, mode="bf16")
            assert _rel(got, want) <= smoke.K3_TOL_BF16["u1"] / 10
    else:
        chunks, per, splits = dw1_split(24, 512, 512, BF16)
        assert (chunks, per, splits) == (24576, 187, 132)
        k = per * RD * kch(BF16)
        a = bf(rng.standard_normal((16, k)).astype(np.float32))
        b = bf(rng.standard_normal((k, 8)).astype(np.float32))
        want = a.astype(np.float64) @ b.astype(np.float64)
        got = mma_gemm(a, b, kstep=16, chunk=RD * kch(BF16), mode="bf16")
        assert _rel(got, want) <= smoke.K3_TOL_BF16["u1"] / 10


def test_phase_trace_anchors_are_in_k3s_source():
    """scripts/k3_phase_trace_torch.py stamps the GEMM passes at anchor
    lines of csrc/head_stack.cu: each anchor is a line of code (not a
    comment) and there as often as the design has it, the stamped copy
    records every phase of a block, and a source without an anchor
    raises."""
    path = REPO / "scripts" / "k3_phase_trace_torch.py"
    spec = importlib.util.spec_from_file_location("k3_phase_trace", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    text = (REPO / "baryon_painter_tpu_torch" / "csrc" /
            "head_stack.cu").read_text()
    assert mod.design(text) == "split"
    for anchors in (mod.FUSED_ANCHORS, mod.SPLIT_ANCHORS):
        for anchor, _, _, _ in anchors:
            assert not anchor.lstrip().startswith("//"), anchor
    src = mod.instrumented(text, mod.SPLIT_ANCHORS)
    for k in range(len(mod.SPLIT_PHASES)):
        assert f"BPT_MARK({k})" in src
    assert src.count("bpt_trace_read") == 1
    anchor = mod.SPLIT_ANCHORS[-1][0]
    with pytest.raises(ValueError, match="anchor"):
        mod.instrumented(text.replace(anchor, ""), mod.SPLIT_ANCHORS)
