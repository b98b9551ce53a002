"""A plain model of K1's implicit GEMMs (csrc/res_block.cu), held against the
port's plain version and the JAX package's Pallas kernel (interpret mode),
and the 3xTF32 and bf16 tensor-core arithmetic emulated at K1's contraction
length.

The kernel, per (sample, 8 x 16 output tile):
  - stages x on the tile + 2 (12 x 20 pixels), zero outside the image and
    for channels C..CP (C zero-padded to CP, a multiple of the K chunk);
  - conv1 on the tile + 1 (10 x 18 = 180 pixels) as A (pixels x K) . B
    (K x C), K = (tap, ci) with the tap slowest, tap = 3 ky + kx, pixel
    (r, c) reading x at (r + ky, c + kx); in two passes of 96 pixels whose
    output h is written over the staged x;
  - h = round_T(act(s1 u + b1)), 0 outside the image (conv2's padding);
  - conv2 on the tile (8 x 16 = 128 pixels) the same way from h, then
    act(s2 v + b2 + x) rounded to T.
The model builds each operand with those index rules; its products are
exact (f64, so the comparison sees the index rules only) or the tensor
cores' emulation (``mma_emulation``).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baryon_painter_tpu.ops import pallas_conv
from baryon_painter_tpu_torch import smoke
from baryon_painter_tpu_torch.ops.res_block import res_block_infer_ref
from mma_emulation import exact_gemm, mma_gemm

TH, TW = 8, 16                  # output tile (kTH, kTW)
MH, MW = TH + 2, TW + 2         # conv1 region
XH, XW = TH + 4, TW + 4         # staged x
PASS = 96                       # conv1 pixels a pass: 2 x 3 m16 tiles x 16
KC = {torch.float32: 64, torch.bfloat16: 128}      # K chunk (channels)
KSTEP = {torch.float32: 8, torch.bfloat16: 16}     # the mma's k
TOL = {dt: tol for dt, _, tol in smoke.K1_CASES}


def _act(v, slope):
    return np.where(v >= 0, v, slope * v)


def _rows(src, h, w):
    """The implicit GEMM's A: (h w pixels, 9 taps x channels), the tap
    slowest; pixel (r, c) takes src at (r + ky, c + kx)."""
    return np.concatenate([src[ky:ky + h, kx:kx + w].reshape(h * w, -1)
                           for ky in range(3) for kx in range(3)], axis=1)


def _weights(w, cp):
    """B: (9 taps x CP input channels, C output channels) from HWIO, zero
    for input channels past C."""
    c = w.shape[2]
    b = np.zeros((9, cp, w.shape[3]), np.float32)
    b[:, :c] = w.reshape(9, c, -1)
    return b.reshape(9 * cp, -1)


def k1_model(x, w1, s1, b1, w2, s2, b2, slope, dtype, gemm=exact_gemm):
    """K1 tile by tile with the kernel's index rules. x, w1, w2 are f32
    arrays holding values of ``dtype``; ``gemm(a, b)`` multiplies."""
    rnd = lambda v: torch.from_numpy(np.asarray(v, np.float32)).to(
        dtype).float().numpy()
    n, hh, ww, c = x.shape
    cp = -(-c // KC[dtype]) * KC[dtype]
    bw1, bw2 = _weights(w1, cp), _weights(w2, cp)
    out = np.full(x.shape, np.nan, np.float32)
    for b in range(n):
        for ty0 in range(0, hh, TH):
            for tx0 in range(0, ww, TW):
                xs = np.zeros((XH, XW, cp), np.float32)
                y0, x0 = max(ty0 - 2, 0), max(tx0 - 2, 0)
                y1, x1 = min(ty0 - 2 + XH, hh), min(tx0 - 2 + XW, ww)
                xs[y0 - ty0 + 2:y1 - ty0 + 2, x0 - tx0 + 2:x1 - tx0 + 2,
                   :c] = x[b, y0:y1, x0:x1]
                u = np.asarray(gemm(_rows(xs, MH, MW), bw1))
                gy = ty0 - 1 + np.arange(MH)[:, None]
                gx = tx0 - 1 + np.arange(MW)[None, :]
                inside = ((gy >= 0) & (gy < hh) & (gx >= 0) & (gx < ww))
                h = _act(u * s1 + b1, slope).reshape(MH, MW, c)
                hs = np.zeros((MH, MW, cp), np.float32)
                hs[..., :c] = np.where(inside[..., None], rnd(h), 0.0)
                v = np.asarray(gemm(_rows(hs, TH, TW), bw2)).reshape(
                    TH, TW, c)
                th, tw = min(TH, hh - ty0), min(TW, ww - tx0)
                res = x[b, ty0:ty0 + th, tx0:tx0 + tw]
                out[b, ty0:ty0 + th, tx0:tx0 + tw] = rnd(_act(
                    v[:th, :tw] * s2 + b2 + res, slope))
    return out


def _inputs(shape, dtype, seed=0):
    args = smoke.k1_inputs(shape, dtype, "cpu", seed=seed)
    return [a.float().numpy() for a in args], args


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("shape", [(2, 13, 21, 12), (1, 3, 5, 8)],
                         ids=["ragged_tiles", "image_inside_one_tile"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("slope", [0.0, 0.2])
def test_gemm_model_is_the_residual_block(shape, dtype, slope):
    """The index rules (tap/channel K order, the conv1 halo region of the
    8 x 16 tile, h rounded to x's type, zeros outside the image) give the
    plain version's and the Pallas kernel's block: to 1e-5 in f32; in bf16
    to K1's tolerance, since h may round to the neighbouring bf16 value
    where sums in another order differ in the last bit."""
    arrays, args = _inputs(shape, dtype)
    got = k1_model(*arrays, slope, dtype)
    want = res_block_infer_ref(*args, inner_slope=slope,
                               outer_slope=slope).float().numpy()
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    pallas = np.asarray(pallas_conv.res_block_infer(
        *[jnp.asarray(a, jdt if i in (0, 1, 4) else jnp.float32)
          for i, a in enumerate(arrays)],
        interpret=True, inner_slope=slope, outer_slope=slope
    ).astype(jnp.float32))
    assert np.isfinite(got).all()   # every output pixel written
    tol = 1e-5 if dtype == torch.float32 else TOL[dtype]
    assert _rel(got, want) <= tol
    assert _rel(got, pallas) <= tol


def _slot(p, tap):
    """Staged-x slot (row-major 12 x 20) that conv1's region pixel p reads
    at tap = 3 ky + kx."""
    return (p // MW + tap // 3) * XW + p % MW + tap % 3


def test_conv1_passes_write_h_only_where_x_is_read_no_more():
    """h of a pass lands on the x slots of its own pixels (slot p of the
    10 x 18 region, the row stride unchanged): pass 1 writes slots < 96,
    which pass 2 never reads (its least slot, pixel 96 at tap 0, is 106;
    its rows past the region repeat pixel 96); pass 2 writes behind the
    barrier that ends its reads. And the 10 x 18 region covers the tile
    and its 1-pixel halo once."""
    pass2 = [_slot(p, t) for p in range(PASS, MH * MW) for t in range(9)]
    assert min(pass2) == _slot(PASS, 0) == 106 > PASS - 1
    assert 2 * PASS >= MH * MW > PASS
    assert max(_slot(p, t) for p in range(MH * MW)
               for t in range(9)) == XH * XW - 1


@pytest.mark.parametrize("slope", [0.0, 0.2])
def test_3xtf32_emulation_at_k1152_meets_k1_tol(slope):
    """f32 at C = 128: K = 9 x 128 = 1152 in chunks of 64 (one tap's
    channel group), 3xTF32 with the accumulators truncating: within
    K1_CASES' 1e-4 of the plain version, with a wide margin; one TF32 pass
    is not."""
    dtype = torch.float32
    arrays, args = _inputs((1, 8, 16, 128), dtype, seed=3)
    want = res_block_infer_ref(*args, inner_slope=slope,
                               outer_slope=slope).numpy()
    err = {}
    for mode in ("3xtf32", "tf32"):
        gemm = lambda a, b: mma_gemm(a, b, kstep=KSTEP[dtype],
                                     chunk=KC[dtype], mode=mode)
        err[mode] = _rel(k1_model(*arrays, slope, dtype, gemm), want)
    assert err["3xtf32"] <= TOL[dtype] / 10, err
    assert err["tf32"] > TOL[dtype], err


def test_bf16_emulation_meets_k1_tol():
    """bf16 at C = 128: m16n8k16 products (exact) accumulated in f32 over
    chunks of 128 channels (a tap), h rounded to bf16: within K1's 2e-2."""
    dtype = torch.bfloat16
    arrays, args = _inputs((1, 8, 16, 128), dtype, seed=4)
    want = res_block_infer_ref(*args, inner_slope=0.2,
                               outer_slope=0.2).float().numpy()
    gemm = lambda a, b: mma_gemm(a, b, kstep=KSTEP[dtype], chunk=KC[dtype],
                                 mode="bf16")
    assert _rel(k1_model(*arrays, 0.2, dtype, gemm), want) <= TOL[dtype]
