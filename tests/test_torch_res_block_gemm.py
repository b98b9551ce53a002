"""A plain model of K1's implicit GEMMs (csrc/res_block.cu), held against the
port's plain version and the JAX package's Pallas kernel (interpret mode),
and the 3xTF32 and bf16 tensor-core arithmetic emulated at K1's contraction
length and accumulation scheme.

The kernel, per (sample, TH x 16 output tile: TH = 8 in f32, 12 in bf16),
with C' = the kernel's channels (``kernel_channels``: a bf16 C % 8 == 4
gains 4 zero channels):
  - TMA stages x on the tile + 2 ((TH + 4) x 20 pixels) as G groups of KW
    channels (128 bytes: 32 f32 or 64 bf16), one 128-byte row a pixel, each
    row's 16-byte unit u stored at u ^ (pixel % 8) (the 128-byte swizzle);
    zeros outside the image and for channels past C';
  - conv1 on the tile + 1 ((TH + 2) x 18 pixels: 180 in three m64 tiles
    of 64 rows in f32, 252 in four in bf16, one a warpgroup, rows past the
    region repeating its last pixel) as A (pixels x K) . B (K x
    128), K in chunks (tap, channel group) with the tap slowest, tap = 3 ky
    + kx, pixel (r, c) reading x at (r + ky, c + kx). A row's K slice is
    read by ldmatrix at its swizzled addresses;
  - h = round_T(act(s1 u + b1)), 0 outside the image (conv2's padding) and
    past C', written in the same swizzled rows (one row a region pixel);
  - conv2 on the tile (TH x 16 pixels, TH / 4 m64 tiles) the same way from
    h, then act(s2 v + b2 + x) rounded to T, staged in h's rows and written
    by TMA, which drops what lies past the image.
The model builds each operand through those byte-level index rules; its
products are exact (f64, so the comparison sees the index rules only) or
the tensor cores' emulation (``mma_emulation``) summed as the kernel sums
them: in f32 each tap's products from zero in the wgmma accumulator, added
into an f32 side sum at the tap's end; in bf16 one accumulator over a
conv's whole K.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baryon_painter_tpu.ops import pallas_conv
from baryon_painter_tpu_torch import smoke
from baryon_painter_tpu_torch.ops.res_block import (kernel_channels,
                                                    res_block_infer_ref,
                                                    res_block_operands)
from mma_emulation import exact_gemm, mma_gemm

SOURCE = Path(smoke.REPO) / smoke.K1_SOURCE
TW = 16                         # the output tile's columns (kTW)
MW, XW = TW + 2, TW + 4         # conv1 region's and staged x's columns
TH = {torch.float32: 8, torch.bfloat16: 12}        # the output tile's rows
WGS = {torch.float32: 3, torch.bfloat16: 4}        # consumer warpgroups
ROW = 128                       # bytes of a pixel's channel group
N = 128                         # output channels of a wgmma
KW = {torch.float32: 32, torch.bfloat16: 64}       # channels a group
KSTEP = {torch.float32: 8, torch.bfloat16: 16}     # the wgmma's k
STAGES = {torch.float32: 3, torch.bfloat16: 5}     # the weight ring
PARTS = {torch.float32: 2, torch.bfloat16: 1}      # big/small in f32
NP_BITS = {torch.float32: np.uint32, torch.bfloat16: np.uint16}
SMEM_MAX = 232448               # a block's shared memory on the H100
TOL = {dt: tol for dt, _, tol in smoke.K1_CASES}


def _act(v, slope):
    return np.where(v >= 0, v, slope * v)


def _bits(v, dtype):
    """f32 values (of ``dtype``) as the bytes the card holds."""
    t = torch.from_numpy(np.ascontiguousarray(v, np.float32)).to(dtype)
    if dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint8)
    return t.numpy().view(np.uint8)


def _values(b, dtype):
    """Bytes of ``dtype`` values back as f32."""
    b = np.ascontiguousarray(b)
    if dtype == torch.bfloat16:
        return torch.from_numpy(b.view(np.int16).copy()).view(
            torch.bfloat16).float().numpy()
    return b.view(np.float32)


def swizzle_unit(q, u):
    """Where the 16-byte unit u of a region's pixel row q lies: TMA's
    128-byte swizzle (unit u ^ (row % 8) of a 1024-byte aligned atom), which
    h's rows copy."""
    return np.bitwise_xor(u, np.asarray(q) % 8)


def stage(rows, dtype, groups):
    """A region (pixels, channels) written in the kernel's layout: G groups
    of (pixels x 128 bytes), each row's units swizzled. Channels past the
    array are zero."""
    pix = rows.shape[0]
    kw = KW[dtype]
    vals = np.zeros((pix, groups * kw), np.float32)
    vals[:, :rows.shape[1]] = rows
    buf = np.zeros((groups, pix, 8, 16), np.uint8)
    logical = _bits(vals, dtype).reshape(pix, groups, 8, 16)
    q = np.arange(pix)[:, None]
    for g in range(groups):
        buf[g, q, swizzle_unit(q, np.arange(8)[None, :])] = logical[:, g]
    return buf.reshape(-1)


def a_row_addresses(q, tap, g, sw, dtype, pixels):
    """The byte addresses (within the region) of the 8 16-byte units a
    conv's A row reads at chunk (tap, g): pixel q + ky sw + kx of a region
    with ``pixels`` pixels a group, unit u at its swizzled place. The k-step
    kk's two units 2 kk, 2 kk + 1 are the ldmatrix rows of lanes l % 16
    (l < 16) and l % 16 + 16."""
    q = np.asarray(q) + (tap // 3) * sw + tap % 3
    u = np.arange(8)
    return (g * pixels * ROW + q[:, None] * ROW
            + swizzle_unit(q[:, None], u[None, :]) * 16)


def a_matrix(buf, q0, sw, dtype, groups, pixels):
    """The implicit GEMM's A (rows, 9 taps x G groups x KW channels) read
    from a staged region through the kernel's addresses; ``q0`` each row's
    pixel at tap 0."""
    cols = []
    for tap in range(9):
        for g in range(groups):
            addr = a_row_addresses(q0, tap, g, sw, dtype, pixels)
            raw = buf[addr[..., None] + np.arange(16)].reshape(len(q0), ROW)
            cols.append(_values(raw, dtype).reshape(len(q0), -1))
    return np.concatenate(cols, axis=1)


def b_matrix(weights, conv, dtype, groups):
    """B (9 taps x G groups x KW, 128) of one conv from the kernel's weight
    layout (2 P, C', 9, C'): what the TMA boxes (KW input channels, one tap,
    128 output channels) hold, zeros past C'. In f32 the conv's big + small
    halves (the host's split; the emulation splits again, identically)."""
    w = weights.float().numpy()
    p = PARTS[dtype]
    wt = sum(w[conv * p + i] for i in range(p))        # (co, tap, ci)
    c = wt.shape[0]
    kw = KW[dtype]
    b = np.zeros((N, 9, groups * kw), np.float32)
    b[:c, :, :c] = wt
    return b.transpose(1, 2, 0).reshape(9 * groups * kw, N)


def m64_rows(n_pix, tiles):
    """The rows of ``tiles`` m64 tiles over a region of n_pix pixels: rows
    past it repeat its last pixel (computed and discarded)."""
    return np.minimum(np.arange(64 * tiles), n_pix - 1)


def k1_model(x, w1, s1, b1, w2, s2, b2, slope, dtype, gemm=exact_gemm):
    """K1 tile by tile with the kernel's index rules. x, w1, w2 are f32
    arrays holding values of ``dtype``; ``gemm(a, b)`` multiplies."""
    rnd = lambda v: torch.from_numpy(np.asarray(v, np.float32)).to(
        dtype).float().numpy()
    n, hh, ww, c = x.shape
    t = lambda a: torch.from_numpy(a)
    ops = res_block_operands(t(w1), t(s1), t(b1), t(w2), t(s2), t(b2), dtype)
    cp = ops.channels
    groups = -(-cp // KW[dtype])
    bw1, bw2 = (b_matrix(ops.weights, i, dtype, groups) for i in (0, 1))
    sb = [np.zeros(N, np.float32) for _ in range(4)]
    for v, o in zip(sb, ops[1:5]):
        v[:cp] = o.numpy()
    s1p, b1p, s2p, b2p = sb
    xp = np.zeros((n, hh, ww, cp), np.float32)
    xp[..., :c] = x
    out = np.full(xp.shape, np.nan, np.float32)
    th_, wgs = TH[dtype], WGS[dtype]
    mh, xh = th_ + 2, th_ + 4
    r1 = m64_rows(mh * MW, wgs)                 # conv1's region rows
    r2 = m64_rows(th_ * TW, th_ * TW // 64)     # conv2's tile rows
    for b in range(n):
        for ty0 in range(0, hh, th_):
            for tx0 in range(0, ww, TW):
                # TMA's box at (tx0 - 2, ty0 - 2): zeros out of bounds
                xs = np.zeros((xh, XW, cp), np.float32)
                y0, x0 = max(ty0 - 2, 0), max(tx0 - 2, 0)
                y1, x1 = min(ty0 - 2 + xh, hh), min(tx0 - 2 + XW, ww)
                xs[y0 - ty0 + 2:y1 - ty0 + 2, x0 - tx0 + 2:x1 - tx0 + 2] = \
                    xp[b, y0:y1, x0:x1]
                xbuf = stage(xs.reshape(xh * XW, cp), dtype, groups)
                a1 = a_matrix(xbuf, (r1 // MW) * XW + r1 % MW, XW, dtype,
                              groups, xh * XW)
                u = np.asarray(gemm(a1, bw1))[:mh * MW]
                gy = ty0 - 1 + np.arange(mh * MW) // MW
                gx = tx0 - 1 + np.arange(mh * MW) % MW
                inside = (gy >= 0) & (gy < hh) & (gx >= 0) & (gx < ww)
                h = rnd(_act(u * s1p + b1p, slope))
                h = np.where(inside[:, None], h, 0.0)[:, :groups * KW[dtype]]
                hbuf = stage(h, dtype, groups)
                a2 = a_matrix(hbuf, (r2 // TW) * MW + r2 % TW, MW, dtype,
                              groups, mh * MW)
                v = np.asarray(gemm(a2, bw2))[:th_ * TW, :cp].reshape(
                    th_, TW, cp)
                th, tw = min(th_, hh - ty0), min(TW, ww - tx0)
                res = xp[b, ty0:ty0 + th, tx0:tx0 + tw]
                out[b, ty0:ty0 + th, tx0:tx0 + tw] = rnd(_act(
                    v[:th, :tw] * s2p[:cp] + b2p[:cp] + res, slope))
    return out[..., :c]


def _inputs(shape, dtype, seed=0):
    args = smoke.k1_inputs(shape, dtype, "cpu", seed=seed)
    return [a.float().numpy() for a in args], args


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("shape", [(2, 13, 21, 12), (1, 3, 5, 8),
                                   (1, 9, 18, 128)],
                         ids=["ragged_tiles", "image_inside_one_tile",
                              "c128_two_column_tiles"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("slope", [0.0, 0.2])
def test_gemm_model_is_the_residual_block(shape, dtype, slope):
    """The index rules (the swizzled rows and each A row's addresses, the
    tap/channel-group K order, the conv1 region's three m64 tiles, h rounded
    to x's type, zeros outside the image and past C) give the plain
    version's and the Pallas kernel's block: to 1e-5 in f32; in bf16 to K1's
    tolerance, since h may round to the neighbouring bf16 value where sums
    in another order differ in the last bit. C = 12 in bf16 runs as 16."""
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


def _ldmatrix_x4(buf, addrs):
    """ldmatrix.x4 of 32 lanes' row addresses: matrix m's rows are lanes
    8 m .. 8 m + 7; lane t receives 32-bit word t % 4 of row t / 4 of each
    matrix (two b16 elements, or one f32)."""
    rows = np.stack([buf[a:a + 16].view(np.uint32) for a in addrs])
    t = np.arange(32)
    return np.stack([rows[8 * m + t // 4, t % 4] for m in range(4)], axis=1)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_each_lanes_ldmatrix_reads_the_a_fragment(dtype):
    """For pixel rows of the staged x and every tap and k-step, the address
    each lane gives ldmatrix (its row l % 16, unit 2 kk + l / 16 of the
    32-byte k-step, swizzled by its pixel) yields the wgmma's A fragment in
    registers: bf16 a0 = (row g, k 2 tig, 2 tig + 1), a1 = row g + 8, a2 =
    k + 8, a3 both; tf32 the same with k tig and tig + 4 (g = lane / 4,
    tig = lane % 4)."""
    rng = np.random.default_rng(5)
    groups = 2
    kw = KW[dtype]
    xh, mh = TH[dtype] + 4, TH[dtype] + 2
    xs = rng.standard_normal((xh * XW, groups * kw)).astype(np.float32)
    xs = torch.from_numpy(xs).to(dtype).float().numpy()
    buf = stage(xs, dtype, groups)
    logical = _bits(xs, dtype).reshape(xh * XW, -1).view(NP_BITS[dtype])
    per_word = 2 if dtype == torch.bfloat16 else 1
    lane = np.arange(32)
    g8, tig = lane // 4, lane % 4
    for m0 in (0, 16, 48, 112, 176, 240):    # warps' rows of the m64 tiles
        p = np.minimum(m0 + lane % 16, mh * MW - 1)
        q0 = (p // MW) * XW + p % MW
        for tap in range(9):
            for g in range(groups):
                addr = a_row_addresses(q0, tap, g, XW, dtype, xh * XW)
                q = q0 + (tap // 3) * XW + tap % 3
                for kk in range(4):
                    regs = _ldmatrix_x4(buf, addr[lane, 2 * kk + lane // 16])
                    col0 = g * kw + kk * KSTEP[dtype]
                    rows_ = (q[g8], q[np.minimum(g8 + 8, 15)])
                    for r, (row, dk) in enumerate(
                            ((rows_[0], 0), (rows_[1], 0),
                             (rows_[0], KSTEP[dtype] // 2),
                             (rows_[1], KSTEP[dtype] // 2))):
                        k = col0 + dk + per_word * tig
                        want = logical[row, k].astype(np.uint32)
                        if per_word == 2:
                            want |= logical[row, k + 1].astype(
                                np.uint32) << 16
                        np.testing.assert_array_equal(regs[:, r], want)


def _constants():
    src = SOURCE.read_text()
    get = lambda name: int(re.search(rf"constexpr int {name} = (\d+)",
                                     src).group(1))
    elt = {dt: re.search(rf"struct Elt<{name}> {{\s*static constexpr int "
                         rf"KW = (\d+), STAGES = (\d+), PARTS = (\d+), "
                         rf"TH = (\d+), WGS = (\d+);\s*"
                         rf"static constexpr int PRODUCERS = (\d+), "
                         rf"PRODUCER_REGS = (\d+),\s*CONSUMER_REGS = (\d+);"
                         rf"\s*static constexpr bool ALIAS = (\w+), "
                         rf"SIDE_SUM = (\w+);", src)
           for dt, name in ((torch.float32, "float"),
                            (torch.bfloat16, "__nv_bfloat16"))}
    return ({k: get(k) for k in ("kTW", "kN", "kRow")},
            {dt: tuple(int(v) for v in m.groups()[:8])
             + (m.group(9) == "true", m.group(10) == "true")
             for dt, m in elt.items()})


def smem_layout(c, dtype):
    """The kernel's shared memory (``layout`` in csrc/res_block.cu) at C
    channels: (x, h, ring offset, bytes requested): x, h (over x in f32),
    the weight ring, the barriers (full and empty a stage, x's) and the
    folded BN (4 x 128 f32), and 1024 bytes to align the base."""
    kw, stages, parts, th, *_, alias, _ = _constants()[1][dtype]
    groups = -(-kernel_channels(c, dtype) // kw)
    x = groups * (th + 4) * XW * ROW
    h = groups * (th + 2) * MW * ROW
    h_end = x if alias else x + h
    ring = -(-h_end // 1024) * 1024
    bars = ring + stages * parts * N * ROW
    return x, h, ring, bars + (2 * stages + 2) * 8 + 4 * N * 4 + 1024


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_shared_memory_and_the_h_over_x_rule(dtype):
    """The source's constants are the model's; at every C the block fits the
    H100's 232,448 bytes; TMA's boxes (x groups, ring stages, out's
    staging) start on 1024-byte swizzle atoms; one m64 tile a warpgroup
    covers conv1's region (180 of 192 rows in f32, 252 of 256 in bf16) and
    TH / 4 conv2's tile. f32 writes h over x (its x and h side by side would
    not fit at C = 128): h's rows fit inside x's, and since conv1 is one
    pass (every m64 tile of the region at once, each warpgroup's whole K)
    all of x's reads end at the barrier before the first h write; bf16
    keeps both and reads the residual from the staged x. The output tile's
    staging fits in h's rows."""
    consts, elt = _constants()
    assert (consts["kTW"], consts["kN"], consts["kRow"]) == (TW, N, ROW)
    (kw, stages, parts, th, wgs, producers, p_regs, c_regs, alias,
     _) = elt[dtype]
    # registers: a producer warp, or a producer warpgroup whose registers
    # (setmaxnreg) fund the consumers' within the SM's 65,536
    assert producers in (32, 128)
    if producers == 128:
        assert 128 * p_regs + 128 * wgs * c_regs <= 65536
        assert p_regs % 8 == 0 and c_regs % 8 == 0
    assert (kw, stages, parts, th, wgs) == (
        KW[dtype], STAGES[dtype], PARTS[dtype], TH[dtype], WGS[dtype])
    assert kw * dtype.itemsize == ROW
    assert alias == (dtype == torch.float32)
    mpix = (th + 2) * MW
    assert 64 * wgs >= mpix > 64 * (wgs - 1) and (th * TW) % 64 == 0
    assert ((th + 4) * XW * ROW) % 1024 == 0
    assert (parts * N * ROW) % 1024 == 0 and (th * TW * ROW) % 1024 == 0
    for c in range(4, 129, 4):
        x, h, ring, total = smem_layout(c, dtype)
        assert total <= SMEM_MAX, c
        assert h < x and ring % 1024 == 0
        groups = -(-kernel_channels(c, dtype) // kw)
        assert groups * th * TW * ROW <= h
        if dtype == torch.float32 and c == 128:
            assert x + h + stages * parts * N * ROW > SMEM_MAX


def emulated_gemm(dtype, mode):
    """The tensor cores' GEMM at K1's accumulation scheme: with the
    source's SIDE_SUM, each tap's K (G groups of KW channels; K = 9 taps,
    the tap slowest) summed from zero and added into an f32 sum; else one
    accumulator over the whole K."""
    side_sum = _constants()[1][dtype][-1]
    return lambda a, b: mma_gemm(
        a, b, kstep=KSTEP[dtype],
        chunk=a.shape[1] // 9 if side_sum else a.shape[1], mode=mode)


@pytest.mark.parametrize("slope", [0.0, 0.2])
def test_3xtf32_emulation_at_k1152_meets_k1_tol(slope):
    """f32 at C = 128: K = 9 x 128 = 1152 in k8 steps, three products
    each, the accumulator truncating after each; each tap's 128 summed from
    zero and added into an f32 side sum, as the kernel does: within
    K1_CASES' 1e-4 of the plain version with a margin of 10 (2.8e-6 here).
    One accumulator over the whole K would not keep that margin (2.1e-5),
    and one TF32 pass is not within 1e-4."""
    dtype = torch.float32
    assert _constants()[1][dtype][-1]     # f32 keeps the side sum
    arrays, args = _inputs((1, 8, 16, 128), dtype, seed=3)
    want = res_block_infer_ref(*args, inner_slope=slope,
                               outer_slope=slope).numpy()
    err = {mode: _rel(k1_model(*arrays, slope, dtype,
                               emulated_gemm(dtype, mode)), want)
           for mode in ("3xtf32", "tf32")}
    whole_k = lambda a, b: mma_gemm(a, b, kstep=KSTEP[dtype],
                                    chunk=a.shape[1], mode="3xtf32")
    err["3xtf32, one accumulator"] = _rel(
        k1_model(*arrays, slope, dtype, whole_k), want)
    assert err["3xtf32"] <= TOL[dtype] / 10, err
    assert err["3xtf32, one accumulator"] > TOL[dtype] / 10, err
    assert err["tf32"] > TOL[dtype], err


def test_bf16_emulation_meets_k1_tol():
    """bf16 at C = 128: k16 products (exact) accumulated in f32 over the
    whole K = 1152 in one accumulator, h rounded to bf16: within K1's
    2e-2."""
    dtype = torch.bfloat16
    arrays, args = _inputs((1, 8, 16, 128), dtype, seed=4)
    want = res_block_infer_ref(*args, inner_slope=0.2,
                               outer_slope=0.2).float().numpy()
    got = k1_model(*arrays, 0.2, dtype, emulated_gemm(dtype, "bf16"))
    assert _rel(got, want) <= TOL[dtype]
