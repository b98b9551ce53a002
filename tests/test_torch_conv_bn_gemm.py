"""A plain model of K4's implicit GEMMs (csrc/conv_bn.cu), held against
``F.conv2d`` / ``F.conv_transpose2d`` and their autograd, and an emulation
of the tensor-core arithmetic the kernels sum with.

The kernels (Hopper's wgmma, A gathered into registers, B from shared
memory in the 128-byte swizzle, everything streamed by TMA):
  u (stats, bwd1): per (output phase, tr x 16 tile of x's grid, sample,
      N columns; tr = 24 for N <= 16, two m64 tiles a warpgroup, else
      12), M = the tile's pixels, N = Cout, K = (ci, tap) with ci
      slowest, in chunks of KCH (32 f32, 64 bf16: one 128-byte row). A
      chunk's window of x (the channels its K indices span, FH rows x FW
      columns from the 16-byte boundary at or before its first needed
      column, zeros out of bounds) is one TMA box; a lane reads A at its
      pixel's offset plus the chunk's table of (channel, tap) offsets,
      which the producer writes into the chunk's ring stage (so shared
      memory does not grow with K); B is the wrapper's weight layout
      (``_kernel_weights``).
  dx: the same over du's window, N = Cin, K = (co, ky, kx).
  dW: M = a tile of 64 rows (channel, tap) of one phase (a "slab" of 64 //
      taps channels), N = Cout, K = the phase's pixels in chunks of RD
      coarse rows x KCH columns; TMA stages whole fine rows of du (every
      phase) and x's window; the consumers split du into per-phase B
      tiles (big/small in f32, swizzled as TMA writes the weights); each
      split walks a run of chunks, sized so at least two blocks an SM run.
  du: formed once a pixel before dW and dx, in y's dtype, rows padded to
      16 bytes with zeros.
The model builds each operand with those index rules; its products are
f64 (rtol 1e-10), so the comparison sees the index rules only. The
arithmetic (``mma_emulation``): the 3xTF32 split, rounded to nearest in
the u GEMM and the weights (big = tf32(v), small = tf32(v - big),
cvt.rna) and truncating for dx's and dW's gathered operands (big = v with
13 low bits cleared, small = v - big, truncated by the tensor cores),
each k-step's three products added into a truncating accumulator from
zero and drained into an f32 side sum; at the fiducial sites' contraction
lengths (dW's over the pixels of a phase, split as the kernel splits it at
132 SMs) it holds ``smoke.K4_TOL`` with a wide margin, where one TF32 pass
does not.
"""
import zlib

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from mma_emulation import _toward_zero, tf32, tf32_trunc

from baryon_painter_tpu_torch import smoke
from baryon_painter_tpu_torch.ops.conv_bn import (_kernel_weights, _pitched,
                                                  _split_tf32, _tf32, du_ref)

# (transposed, k, s): every (stride, kernel) pair the kernels are compiled for
FAMILIES = [(False, 1, 1), (False, 3, 1), (False, 5, 1), (False, 7, 1),
            (True, 4, 2), (True, 8, 4)]
IDS = ["same_k1", "same_k3", "same_k5", "same_k7", "transp_s2", "transp_s4"]
DTYPES = [torch.float32, torch.bfloat16]
RTOL = 1e-10
TW = 16                          # a u / dx tile: tr rows x 16 columns
KCH = {torch.float32: 32, torch.bfloat16: 64}   # K a 128-byte row
KSTEP = {torch.float32: 8, torch.bfloat16: 16}
ESIZE = {torch.float32: 4, torch.bfloat16: 2}
MAX_SMEM = 232448
MAX_BOX = 256


def _inputs(transposed, k, cin=3, cout=5, n=2, h=7, w=9, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, cin, h, w, generator=g, dtype=torch.float64)
    ws = (cin, cout, k, k) if transposed else (cout, cin, k, k)
    return x, torch.randn(ws, generator=g, dtype=torch.float64)


def _pad(transposed, k, s):
    return s // 2 if transposed else (k - 1) // 2


def _exact(t, dtype):
    """t's values in dtype, f32 ones tf32 values (their 3xTF32 small half
    is 0, so the weight layout's halves sum to them exactly), as f64."""
    t = t.to(dtype)
    return (_tf32(t) if dtype == torch.float32 else t).double()


def _conv(x, w, transposed, k, s):
    p = _pad(transposed, k, s)
    if transposed:
        return F.conv_transpose2d(x, w, stride=s, padding=p)
    return F.conv2d(x, w, padding=p)


def cdiv(a, b):
    return -(-a // b)


def rup(a, b):
    return cdiv(a, b) * b


def aligned(c, dtype):
    """The 16-byte boundary at or before column c (a TMA box's start)."""
    al = 16 // ESIZE[dtype]
    return c - c % al


def box(t, c0, y0, ch0, n, shape):
    """A TMA box of t (N, C, H, W): ``shape`` (channels, rows, columns)
    from (ch0, y0, c0) of sample n, zeros out of bounds."""
    nch, fh, fw = shape
    out = torch.zeros(shape, dtype=t.dtype)
    _, c, h, w = t.shape
    cs, ys, xs = (slice(max(0, a), min(b, a + m)) for a, b, m in
                  ((ch0, c, nch), (y0, h, fh), (c0, w, fw)))
    if cs.start < cs.stop and ys.start < ys.stop and xs.start < xs.stop:
        out[cs.start - ch0:cs.stop - ch0, ys.start - y0:ys.stop - y0,
            xs.start - c0:xs.stop - c0] = t[n, cs, ys, xs]
    return out


# ---------------------------------------------------------------------- #
# the pixel GEMMs: u (kind 0) and dx (kind 1)

def tile_rows(nt):
    """A u / dx tile's rows: 12 x the m64 tiles a warpgroup holds."""
    return 24 if nt <= 16 else 12


def pix_geo(kind, s, k, chans, dtype, nt):
    """``pix_geo`` in the source: taps a channel, K, its 128-byte rows, the
    rows a chunk (up to 4 for N <= 16, 2 for 32, 1 for 64, fewer where
    they do not fit), the chunks, the window's rows, pitch and channels,
    the ring's stages and the block's shared memory in bytes (a stage: the
    chunk's weight tiles, window and table of K offsets)."""
    e = ESIZE[dtype]
    al = 16 // e
    kch = KCH[dtype]
    parts = 2 if dtype == torch.float32 else 1
    taps = k * k if kind == 1 or s == 1 else 4
    kdim = chans * taps
    nrows = cdiv(kdim, kch)
    tr = tile_rows(nt)
    if s == 1:
        fh, fw = tr + k - 1, rup(TW + k - 1 + al - 1, al)
    elif kind == 0:
        fh, fw = tr + 1, rup(TW + 1 + al - 1, al)
    else:
        fh, fw = s * (tr - 1) + k, rup(s * (TW - 1) + k + al - 1, al)
    for rr in range(4 if nt <= 16 else 2 if nt == 32 else 1, 0, -1):
        if rr > nrows:
            continue
        nchunks = cdiv(nrows, rr)
        nch = max(min(chans - 1, ((j + 1) * rr * kch - 1) // taps)
                  - j * rr * kch // taps + 1 for j in range(nchunks))
        stage = rup(rr * parts * nt * 128 + rup(nch * fh * fw * e, 16)
                    + 4 * rr * kch, 1024)
        stages = next((st for st in (4, 3, 2) if st * stage + 16 * st
                       + 4 * 12 * nt * 2 + 1024 <= MAX_SMEM), None)
        if stages and nch <= MAX_BOX:
            break
    return dict(taps=taps, kdim=kdim, nrows=nrows, r=rr, nchunks=nchunks,
                fh=fh, fw=fw, nch=nch, tr=tr, stages=stages,
                bytes=stages * stage + 16 * stages + 4 * 12 * nt * 2 + 1024
                if stages else 0)


def tap_off(kind, s, k, fw, t):
    tw = 2 if kind == 0 and s > 1 else k
    o = (t // tw) * fw + t % tw
    return o if (kind == 0) == (s == 1) else -o


def pix_off(kind, s, k, fw, r, c):
    if kind == 0:
        return r * fw + c if s == 1 else (r + 1) * fw + c + 1
    return ((r + k - 1) * fw + c + k - 1) if s == 1 else s * (r * fw + c)


def koff_table(g, kind, s, k, dtype, j):
    """Chunk j's K offsets, as the producer's lanes write them into its
    stage (``pixel_producer``): one a K index of the chunk's rows, from
    its first channel; 0 past K."""
    kch = KCH[dtype] * g["r"]          # K of a chunk
    k0 = j * kch
    rows = min(g["r"], g["nrows"] - j * g["r"])
    out = []
    for kk in range(k0, k0 + rows * KCH[dtype]):
        if kk < g["kdim"]:
            ch = kk // g["taps"]
            out.append((ch - k0 // g["taps"]) * g["fh"] * g["fw"]
                       + tap_off(kind, s, k, g["fw"], kk - ch * g["taps"]))
        else:
            out.append(0)
    return out


def window_origin(kind, s, k, ph, qx0, q0):
    """(first needed column, first row) of a tile's window."""
    p = (k - 1) // 2 if s == 1 else s // 2
    if kind == 0:
        offy = 0 if s == 1 else (ph // s + p) // s
        offx = 0 if s == 1 else (ph % s + p) // s
        return ((qx0 - p, q0 - p) if s == 1
                else (qx0 + offx - 1, q0 + offy - 1))
    return ((qx0 + p - (k - 1), q0 + p - (k - 1)) if s == 1
            else (s * qx0 - p, s * q0 - p))


def pixel_gemm(src, wk, kind, s, k, dtype, ph, qx0, q0, n, n0, nt):
    """One tile's (tr x 16 pixels x nt columns) products as the kernel forms
    them: for each chunk the window box at its aligned origin, A gathered
    through the offset table, B the chunk's rows of the weight layout
    (parts summed: big + small is the f32 value)."""
    g = pix_geo(kind, s, k, src.shape[1], dtype, nt)
    kch = KCH[dtype] * g["r"]
    cx, oy = window_origin(kind, s, k, ph, qx0, q0)
    ox = aligned(cx, dtype)
    pix = torch.tensor([cx - ox + pix_off(kind, s, k, g["fw"], r, c)
                        for r in range(g["tr"]) for c in range(TW)])
    b_all = wk[ph].sum(0).double()                     # (N, Kp)
    out = torch.zeros(g["tr"] * TW, nt, dtype=torch.float64)
    for j in range(g["nchunks"]):
        win = box(src, ox, oy, j * kch // g["taps"], n,
                  (g["nch"], g["fh"], g["fw"])).reshape(-1)
        koff = torch.tensor(koff_table(g, kind, s, k, dtype, j))
        ks = slice(j * kch, j * kch + len(koff))
        a = win[pix[:, None] + koff[None, :]]
        b = torch.zeros(len(koff), nt, dtype=torch.float64)
        cols = b_all[n0:n0 + nt, ks].T
        b[:, :cols.shape[1]] = cols
        out += a @ b
    return out


def tile_pixels(q0, qx0, h, w, tr):
    """The tile's (row, column) pixels inside the grid, and their rows m."""
    m = torch.arange(tr * TW)
    q, qx = q0 + m // TW, qx0 + m % TW
    ok = (q < h) & (qx < w)
    return q[ok], qx[ok], m[ok]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("transposed,k,s", FAMILIES, ids=IDS)
def test_u_gemm_per_phase_is_the_conv(transposed, k, s, dtype):
    """Every tile of a ragged grid (30 x 19 against 24 x 16 tiles, N = 8),
    every phase: the model's u equals the library's conv, each output
    pixel once; K chunks of 32 (f32) and 64 (bf16) K indices straddle
    channels."""
    x, w = _inputs(transposed, k, cin=5, cout=6, h=30, w=19)
    x, w = x.to(dtype).double(), _exact(w, dtype)
    u = _conv(x, w, transposed, k, s)
    wk = _kernel_weights(w.to(dtype), transposed, k, s, "u").double()
    seen = torch.zeros(u.shape, dtype=torch.int64)
    ss = s if transposed else 1
    for n in range(x.shape[0]):
        for ph in range(ss * ss):
            for q0 in range(0, x.shape[2], tile_rows(8)):
                for qx0 in range(0, x.shape[3], TW):
                    got = pixel_gemm(x, wk, 0, ss, k, dtype, ph, qx0, q0, n,
                                     0, 8)
                    q, qx, m = tile_pixels(q0, qx0, *x.shape[2:],
                                           tile_rows(8))
                    oy, ox = ss * q + ph // ss, ss * qx + ph % ss
                    torch.testing.assert_close(got[m, :6],
                                               u[n, :, oy, ox].T,
                                               rtol=RTOL, atol=RTOL)
                    seen[n, :, oy, ox] += 1
    assert bool((seen == 1).all())


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("transposed,k,s", FAMILIES, ids=IDS)
def test_dx_gemm_is_the_adjoint(transposed, k, s, dtype):
    """dx as a conv of du's windows (du at s p + k - P for the transposed
    conv, p - k + P for the "same" one) with the wrapper's dx weights,
    against autograd; du's rows padded to 16 bytes as bwd2 stages them."""
    x, w = _inputs(transposed, k, cin=3, cout=4, h=27, w=18)
    x, w = x.to(dtype).double(), _exact(w, dtype)
    xg = x.clone().requires_grad_()
    u = _conv(xg, w, transposed, k, s)
    du = torch.randn(u.shape, generator=torch.Generator().manual_seed(1),
                     dtype=torch.float64).to(dtype).double()
    u.backward(du)
    dup, _ = _pitched(du.to(dtype))
    wk = _kernel_weights(w.to(dtype), transposed, k, s, "dx").double()
    ss = s if transposed else 1
    got = torch.zeros_like(x)
    for n in range(x.shape[0]):
        for q0 in range(0, x.shape[2], tile_rows(8)):
            for qx0 in range(0, x.shape[3], TW):
                out = pixel_gemm(dup.double(), wk, 1, ss, k, dtype, 0, qx0,
                                 q0, n, 0, 8)
                q, qx, m = tile_pixels(q0, qx0, *x.shape[2:], tile_rows(8))
                got[n, :, q, qx] = out[m, :x.shape[1]].T
    torch.testing.assert_close(got, xg.grad, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("transposed,k,s", FAMILIES, ids=IDS)
def test_window_boxes_start_on_16_byte_boundaries(transposed, k, s, dtype):
    """Each tile's window (u: x; dx: du) starts at the 16-byte boundary at
    or before its first needed column, within one TMA box limit, and its
    pitch holds every column a lane reads, the lead included: the largest
    offset read lies inside the window of the chunk's channels."""
    ss = s if transposed else 1
    for kind, chans, nt in ((0, 70, 16), (1, 70, 64), (1, 3, 8)):
        g = pix_geo(kind, ss, k, chans, dtype, nt)
        koff = [o for j in range(g["nchunks"])
                for o in koff_table(g, kind, ss, k, dtype, j)]
        assert g["fw"] * ESIZE[dtype] % 16 == 0
        assert max(g["fw"], g["fh"], g["nch"]) <= MAX_BOX
        for ph in range(ss * ss if kind == 0 else 1):
            for qx0 in (0, 16, 32):
                cx, _ = window_origin(kind, ss, k, ph, qx0, 0)
                ox = aligned(cx, dtype)
                assert ox % (16 // ESIZE[dtype]) == 0 and 0 <= cx - ox
                lead = cx - ox
                offs = [lead + pix_off(kind, ss, k, g["fw"], r, c) + o
                        for r in (0, g["tr"] - 1) for c in (0, TW - 1)
                        for o in koff]
                assert min(offs) >= 0
                assert max(offs) < g["nch"] * g["fh"] * g["fw"]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("transposed,k,s", FAMILIES, ids=IDS)
def test_pixel_gemm_shared_memory_does_not_grow_with_k(transposed, k, s,
                                                       dtype):
    """The u GEMM and dx hold one chunk's table of K offsets a stage, so
    their blocks fit 232448 bytes from 1 to 4096 channels at every N, and
    a wide K asks for the same bytes at 640, 2048 and 4096 channels; each
    chunk's table covers its rows' K indices, and its offsets stay inside
    the chunk's window."""
    ss = s if transposed else 1
    for kind in (0, 1):
        for nt in (8, 16, 32, 64):
            wide = set()
            for chans in (1, 3, 16, 70, 128, 640, 2048, 4096):
                g = pix_geo(kind, ss, k, chans, dtype, nt)
                assert 0 < g["bytes"] <= MAX_SMEM, (kind, nt, chans)
                if chans >= 640:
                    wide.add((g["r"], g["stages"], g["bytes"]))
                for j in (0, g["nchunks"] - 1):
                    koff = koff_table(g, kind, ss, k, dtype, j)
                    assert len(koff) == KCH[dtype] * min(
                        g["r"], g["nrows"] - j * g["r"])
                    assert max(koff) < g["nch"] * g["fh"] * g["fw"]
            assert len(wide) == 1, (kind, nt, wide)


# ---------------------------------------------------------------------- #
# du, once a pixel

def du_model(u, y, dy, a, mean, inv, s1n, s2n, dtype):
    """``du_kernel``: rows of the pitch ``_pitched`` gives, V = 16 bytes a
    thread, each element formed once; zeros past the width. Returns du
    and how often each element was written."""
    n, c, ho, wo = y.shape
    al = 16 // ESIZE[dtype]
    pitch = rup(wo, al)
    du = torch.full((n, c, ho, pitch), float("nan"), dtype=torch.float32)
    writes = torch.zeros(du.shape, dtype=torch.int64)
    active = y > 0
    want = du_ref(u, dy, a, mean, inv, s1n, s2n, active, dtype).float()
    for i in range(ho * (pitch // al)):
        row, c0 = divmod(i, pitch // al)
        cols = slice(c0 * al, c0 * al + al)
        vals = torch.zeros(n, c, al)
        inside = min(al, max(0, wo - c0 * al))
        vals[..., :inside] = want[:, :, row, c0 * al:c0 * al + inside]
        du[:, :, row, cols] = vals
        writes[:, :, row, cols] += 1
    return du.to(dtype), writes


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("wo", [16, 19])
def test_du_is_formed_once_a_pixel(dtype, wo):
    """du's rows as TMA reads them: every element written once, equal to
    the plain du rounded to the working dtype, zeros in the pitch's pad
    (the adjoints' zero padding), and that pitch ``_pitched``'s."""
    g = torch.Generator().manual_seed(3)
    n, c, ho = 2, 3, 5
    u = torch.randn(n, c, ho, wo, generator=g)
    y = torch.relu(torch.randn(n, c, ho, wo, generator=g)).to(dtype)
    dy = torch.randn(n, c, ho, wo, generator=g).to(dtype)
    vecs = [torch.rand(c, generator=g) + 0.5 for _ in range(5)]
    du, writes = du_model(u, y, dy, *vecs, dtype)
    assert bool((writes == 1).all())
    assert du.shape[-1] == _pitched(y)[1]
    want = du_ref(u, dy, *vecs, y > 0, dtype).to(dtype)
    assert torch.equal(du[..., :wo], want)
    assert bool((du[..., wo:] == 0).all())


# ---------------------------------------------------------------------- #
# dW

def pick_nt(c):
    return next(n for n in (8, 16, 32, 64) if c <= n or n == 64)


def dw_geo(s, k, n, cin, h, w, cout, dtype, sms, nt=None):
    """``dw_geo`` in the source (and ``dw_nt``'s N): slabs, tiles a block,
    chunk rows, the window, stages and the splits; None where nothing
    fits."""
    e = ESIZE[dtype]
    parts = 2 if dtype == torch.float32 else 1
    al = 16 // e
    if nt is None:
        for nt_ in (64, 32, 16, 8):
            if nt_ <= pick_nt(cout) and dw_geo(s, k, n, cin, h, w, cout,
                                               dtype, sms, nt_):
                return dw_geo(s, k, n, cin, h, w, cout, dtype, sms, nt_)
        return None
    ph_n = s * s
    t1 = k * k if s == 1 else 4
    cb = max(1, 64 // t1)
    tiles = cdiv(cin, cb) * ph_n
    cw = KCH[dtype]
    lg = 0
    while lg < 3 and (2 << lg) <= h and \
            nt * s * (2 << lg) * s * cw * e <= 32768:
        lg += 1
    rd = 1 << lg
    fh = rd + (k - 1 if s == 1 else 2)
    fw = rup(cw + (k - 1 if s == 1 else 2) + al - 1, al)
    raw = nt * s * rd * s * cw * e
    bbytes = ph_n * rd * parts * nt * 128
    mtw = 1 if nt >= 64 else min(4, 64 // nt)
    for tb in range(min(3 * mtw, tiles), 0, -1):
        nch = max(((min(b0 + tb, tiles) - 1) // ph_n - b0 // ph_n + 1) * cb
                  for b0 in range(0, tiles, tb))
        xbytes = nch * fh * fw * e
        stage = rup(raw, 1024) + rup(xbytes, 1024)
        stages = next((st for st in (4, 3, 2) if st * stage + bbytes
                       + 16 * st + 1024 <= MAX_SMEM), None)
        if stages is not None and nch <= MAX_BOX:
            break
    else:
        return None
    if fw > MAX_BOX or s * cw > MAX_BOX:
        return None
    nchunks = n * cdiv(h, rd) * cdiv(w, cw)
    blocks = cdiv(tiles, tb) * cdiv(cout, nt)
    splits = min(max(cdiv(2 * sms, blocks), 1), nchunks)
    per = cdiv(nchunks, splits)
    return dict(nt=nt, t1=t1, cb=cb, tiles=tiles, tb=tb, mtw=mtw, rd=rd,
                cw=cw, fh=fh, fw=fw, nch=nch, stages=stages,
                nchunks=nchunks, per=per, nsplit=cdiv(nchunks, per),
                blocks=blocks * cdiv(nchunks, per))


def swizzled(co, j, nt, esize, part=0):
    """Byte of element (row co, column j) of a 128-byte-swizzled B tile
    (NT rows a part): the 16-byte unit u of row r at u ^ (r % 8)."""
    r = part * nt + co
    b = j * esize
    return r * 128 + (((b >> 4) ^ (r & 7)) << 4) + (b & 15)


def du_tiles(raw, s, rd, nt, cw, dtype):
    """The consumers' conversion: raw du (NT, S RD fine rows, S CW fine
    columns) into per-(phase, coarse row) B tiles, bytes as the kernel
    writes them (f32: big, then small, NT rows on). Returns {(phase, row):
    byte array} of 128-byte rows."""
    e = ESIZE[dtype]
    parts = 2 if dtype == torch.float32 else 1
    tiles = {}
    bits = raw.contiguous().view(torch.int32 if e == 4 else torch.int16)
    for co in range(nt):
        for fr in range(s * rd):
            for fc in range(s * cw):
                ph = (fr % s) * s + fc % s
                t = tiles.setdefault((ph, fr // s),
                                     np.zeros(parts * nt * 128, np.uint8))
                v = raw[co, fr, fc]
                if e == 4:   # the kernel's truncating split
                    big = v.view(torch.int32).item() & -8192
                    small = (v - torch.tensor(big, dtype=torch.int32)
                             .view(torch.float32)).view(torch.int32).item()
                    vals = [big, small]
                else:
                    vals = [bits[co, fr, fc].item()]
                for p, bv in enumerate(vals):
                    at = swizzled(co, fc // s, nt, e, p)
                    t[at:at + e] = np.frombuffer(
                        np.array([bv], np.int32 if e == 4 else np.int16)
                        .tobytes(), np.uint8)
    return tiles


def read_tile(t, nt, cw, dtype, part=0):
    """A B tile read back through the swizzle: (NT, CW) values."""
    e = ESIZE[dtype]
    out = np.zeros((nt, cw), np.float32)
    for co in range(nt):
        for j in range(cw):
            at = swizzled(co, j, nt, e, part)
            word = t[at:at + e].tobytes()
            out[co, j] = (np.frombuffer(word, np.float32)[0] if e == 4 else
                          np.frombuffer(b"\0\0" + word, np.float32)[0])
    return out


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("s", [1, 2, 4])
def test_du_tiles_are_the_phases_in_tma_swizzle(s, dtype):
    """A chunk's whole fine rows of du, split into one B tile a (phase,
    coarse row): each tile read back through the 128-byte swizzle (the
    layout TMA writes the weight tiles in, which wgmma's descriptor reads)
    is that phase's du, coarse columns in order; in f32 as its halves big
    (du with 13 low bits cleared) and small = du - big, exactly."""
    nt, rd = 8, 2
    cw = KCH[dtype]
    g = torch.Generator().manual_seed(s)
    raw = torch.randn(nt, s * rd, s * cw, generator=g).to(dtype)
    tiles = du_tiles(raw, s, rd, nt, cw, dtype)
    assert set(tiles) == {(ph, r) for ph in range(s * s) for r in range(rd)}
    for (ph, r), t in tiles.items():
        want = raw[:, r * s + ph // s, ph % s::s].float().numpy()
        if dtype == torch.float32:
            big = read_tile(t, nt, cw, dtype, 0)
            np.testing.assert_array_equal(big, tf32_trunc(want))
            np.testing.assert_array_equal(big + read_tile(t, nt, cw, dtype, 1),
                                          want)
        else:
            np.testing.assert_array_equal(read_tile(t, nt, cw, dtype), want)


def dw_partials(x, w, du, transposed, k, s, dtype, sms):
    """dW as the kernel forms it: per split, per row-tile block, per chunk
    the raw du box and x's window at their TMA origins, du de-interleaved
    by phase, A gathered at each (channel, tap) row's offset; (nsplit, w's
    shape) partials, each entry of a split written once."""
    n_, cin, h, wd = x.shape
    cout = du.shape[1]
    ss = s if transposed else 1
    p = _pad(transposed, k, s)
    g = dw_geo(ss, k, n_, cin, h, wd, cout, dtype, sms)
    nt, cb, t1, rd, cw = g["nt"], g["cb"], g["t1"], g["rd"], g["cw"]
    ph_n = ss * ss
    dup, _ = _pitched(du.to(dtype))
    dup = dup.double()
    xp = x.to(dtype).double()
    parts = torch.zeros((g["nsplit"],) + tuple(w.shape), dtype=torch.float64)
    writes = torch.zeros(parts.shape, dtype=torch.int64)
    cx = -p if ss == 1 else -1
    lead = cx - aligned(cx, dtype)
    segs, nrb = cdiv(wd, cw), cdiv(h, rd)
    for z in range(g["nsplit"]):
        c0 = min(g["nchunks"], z * g["per"])
        c1 = min(g["nchunks"], c0 + g["per"])
        for base in range(0, g["tiles"], g["tb"]):
            lim = min(g["tiles"], base + g["tb"])
            clo = (base // ph_n) * cb
            for co0 in range(0, cout, nt):
                acc = {m: torch.zeros(64, nt, dtype=torch.float64)
                       for m in range(base, lim)}
                for c in range(c0, c1):
                    n, rem = divmod(c, nrb * segs)
                    q0, qx0 = (rem // segs) * rd, (rem % segs) * cw
                    raw = box(dup, ss * qx0, ss * q0, co0, n,
                              (nt, ss * rd, ss * cw))
                    xs = box(xp, aligned(qx0 + cx, dtype),
                             q0 - p if ss == 1 else q0 - 1, clo, n,
                             (g["nch"], g["fh"], g["fw"])).reshape(-1)
                    for m in range(base, lim):
                        sb, ph = divmod(m, ph_n)
                        ry, rx = divmod(ph, ss)
                        offy = 0 if ss == 1 else (ry + p) // ss
                        offx = 0 if ss == 1 else (rx + p) // ss
                        for rho in range(64):
                            ci = sb * cb + rho // t1
                            t = rho % t1
                            if rho >= cb * t1 or ci >= cin:
                                continue
                            tw = k if ss == 1 else 2
                            ty, tx = divmod(t, tw)
                            ro = (ci - clo) * g["fh"] * g["fw"] + lead + (
                                ty * g["fw"] + tx if ss == 1 else
                                (offy - ty + 1) * g["fw"] + offx - tx + 1)
                            for r in range(rd):
                                a = xs[ro + r * g["fw"]:
                                       ro + r * g["fw"] + cw]
                                b = raw[:, r * ss + ry, rx::ss]   # (nt, cw)
                                acc[m][rho] += b @ a
                for m in range(base, lim):
                    sb, ph = divmod(m, ph_n)
                    ry, rx = divmod(ph, ss)
                    ky0, kx0 = (ry + p) % ss, (rx + p) % ss
                    for rho in range(min(64, cb * t1)):
                        ci = sb * cb + rho // t1
                        if ci >= cin:
                            continue
                        t = rho % t1
                        ky = t // k if ss == 1 else ky0 + ss * (t // 2)
                        kx = t % k if ss == 1 else kx0 + ss * (t % 2)
                        for j in range(min(nt, cout - co0)):
                            at = ((z, ci, co0 + j, ky, kx) if transposed
                                  else (z, co0 + j, ci, ky, kx))
                            parts[at] = acc[m][rho, j]
                            writes[at] += 1
    return parts, writes


@pytest.mark.parametrize("transposed,k,s", FAMILIES, ids=IDS)
@pytest.mark.parametrize("sms,dtype", [(1, torch.float32),
                                       (3, torch.float32),
                                       (2, torch.bfloat16)],
                         ids=["sms1_f32", "sms3_f32", "sms2_bf16"])
def test_dw_gemm_split_over_pixels_is_the_weight_gradient(transposed, k, s,
                                                         sms, dtype):
    """Ragged chunks (w = 37 against 32 and 64 columns), several chunks
    and splits: the splits' partials sum to autograd's dW, each entry
    written once a split."""
    x, w = _inputs(transposed, k, cin=5, cout=6, h=5, w=37)
    x, w = x.to(dtype).double(), w.to(dtype).double()
    wg = w.clone().requires_grad_()
    u = _conv(x, wg, transposed, k, s)
    du = torch.randn(u.shape, generator=torch.Generator().manual_seed(2),
                     dtype=torch.float64).to(dtype).double()
    u.backward(du)
    parts, writes = dw_partials(x, w, du, transposed, k, s, dtype, sms)
    assert bool((writes == 1).all())
    torch.testing.assert_close(parts.sum(0), wg.grad, rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("site", ["A", "B", "C", "D"])
def test_dw_split_fills_the_card_at_the_sites(site, dtype):
    """At 132 SMs every site's dW launch runs at least as many blocks as
    SMs (sized for two an SM; site A more than the old design's 64
    splits), each split walks a contiguous run of chunks, and the runs
    cover every chunk once; the block fits TMA's box limit."""
    st = smoke.K4_SITES[site]
    s = st["stride"] if st["transposed"] else 1
    h = st["h"]
    g = dw_geo(s, st["k"], smoke.TRAIN_BATCH, st["cin"], h, h, st["cout"],
               dtype, 132)
    assert g is not None and g["nt"] == pick_nt(st["cout"])
    assert g["blocks"] >= 132
    if site == "A":
        assert g["nsplit"] > 64
    runs = [range(min(g["nchunks"], z * g["per"]),
                  min(g["nchunks"], z * g["per"] + g["per"]))
            for z in range(g["nsplit"])]
    covered = sorted(c for r in runs for c in r)
    assert covered == list(range(g["nchunks"]))
    assert all(len(r) > 0 for r in runs)
    assert g["nch"] <= MAX_BOX and g["fw"] <= MAX_BOX


# ---------------------------------------------------------------------- #
# 3xTF32

def test_tf32_rounding_is_round_to_nearest_ties_away():
    """The kernels' 3xTF32 halves (the wrapper's split of the weights, the
    kernels' cvt.rna of A and du): big = tf32(v) rounded to nearest, ties
    away from zero, small = tf32(v - big); both tf32 values, and big +
    small within 2^-21 of v."""
    one = np.float32(1.0)
    ulp = np.float32(2.0 ** -10)
    v = np.array([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -20,
                  3.0, 1e-30, -7.3e5 - 1.0 / 3], np.float32)
    want = np.array([one + ulp, -(one + ulp), one, 3.0,
                     tf32(np.float32(1e-30)), tf32(v[5:6])[0]], np.float32)
    big, small = _split_tf32(torch.from_numpy(v))
    np.testing.assert_array_equal(big.numpy(), want)
    np.testing.assert_array_equal(small.numpy(), tf32(v - want))
    for h in (big, small):
        assert bool(((h.view(torch.int32) & 0x1FFF) == 0).all())
    err = (big.double() + small.double() - torch.from_numpy(v).double())
    assert bool((err.abs().numpy() <= 2.0 ** -21 * np.abs(v)).all())


def kstep_3xtf32(a, b, kstep, splits=1, chunk=1, rna=True, rna_b=True):
    """a (K, M) . b (K, N) as the kernels sum it: each split rounded to
    nearest (``rna``, ``rna_b``: the u GEMM's A, the wrapper's weights) or
    truncating (dx's and dW's A, dW's du: big = v with 13 low bits
    cleared, small = v - big, read truncated by the tensor cores); per
    k-step the products
    small*big, big*small, big*big added into an accumulator that starts at
    zero (every ``chunk`` k-steps; the kernels: 1) and rounds toward zero;
    each chunk's sum drained into an f32 side sum (in order, per split of
    consecutive k-steps); the splits' partials summed in f32."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    pad = -a.shape[0] % (kstep * chunk)
    a = np.pad(a, ((0, pad), (0, 0)))
    b = np.pad(b, ((0, pad), (0, 0)))
    rnd = tf32 if rna else tf32_trunc
    rnd_b = tf32 if rna_b else tf32_trunc
    ah, bh = rnd(a), rnd_b(b)
    al, bl = rnd(a - ah), rnd_b(b - bh)
    n = a.shape[0] // (kstep * chunk)
    r = lambda t: t.astype(np.float64).reshape(n, chunk, kstep, -1)
    acc = np.zeros((n, a.shape[1], b.shape[1]), np.float32)
    for i in range(chunk):
        for x, y in ((al, bh), (ah, bl), (ah, bh)):
            acc = _toward_zero(acc.astype(np.float64) + np.einsum(
                "skm,skn->smn", r(x)[:, i], r(y)[:, i]))
    out = np.zeros(acc.shape[1:], np.float32)
    for part in np.array_split(acc, splits):
        out = out + np.cumsum(part, 0, dtype=np.float32)[-1]
    return out


def tf32_pass(a, b, kstep, splits=1):
    """One TF32 pass (operands rounded to tf32), summed the same way."""
    a, b = tf32(a).astype(np.float64), tf32(b).astype(np.float64)
    pad = -a.shape[0] % kstep
    a = np.pad(a, ((0, pad), (0, 0)))
    b = np.pad(b, ((0, pad), (0, 0)))
    steps = a.shape[0] // kstep
    acc = _toward_zero(np.einsum("skm,skn->smn",
                                 a.reshape(steps, kstep, -1),
                                 b.reshape(steps, kstep, -1)))
    out = np.zeros(acc.shape[1:], np.float32)
    for part in np.array_split(acc, splits):
        out = out + np.cumsum(part, 0, dtype=np.float32)[-1]
    return out


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


# per site (A-D at batch 24, 512^2): the contraction length of each GEMM
# (dW's over the pixels of a phase) and dW's splits at 132 SMs
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
    sign), a few output columns, dW split as the kernel splits it (site A:
    6.29 M pixels in 262 splits). The kernels' sums stay 10x inside
    K4_TOL; one TF32 pass is at least 30x worse."""
    k = SITE_K[site][gemm]
    rng = np.random.default_rng(zlib.crc32(f"{site}/{gemm}".encode()))
    cols = 2 if gemm == "dw" else 8
    a = np.abs(rng.standard_normal((k, cols))).astype(np.float32)
    b = rng.standard_normal((k, cols)).astype(np.float32)
    want = a.astype(np.float64).T @ b.astype(np.float64)
    splits = 1
    if gemm == "dw":
        st = smoke.K4_SITES[site]
        s = st["stride"] if st["transposed"] else 1
        splits = dw_geo(s, st["k"], smoke.TRAIN_BATCH, st["cin"], st["h"],
                        st["h"], st["cout"], torch.float32, 132)["nsplit"]
    err3 = _rel(kstep_3xtf32(a, b, 8, splits, rna=gemm == "u",
                             rna_b=gemm != "dw"), want)
    err1 = _rel(tf32_pass(a, b, 8, splits), want)
    assert err3 <= GEMM_TOL[gemm] / 10, err3
    assert err1 >= 30 * err3, (err1, err3)


# ---------------------------------------------------------------------- #
# K4-stats' epilogue and K4-fwd's index rule

def _fma32(acc, a, b):
    """acc + a * b rounded once to f32, as the kernel's fmaf (a * b is
    exact in f64; up to a double rounding)."""
    return (acc.astype(np.float64) + a.astype(np.float64)
            * b.astype(np.float64)).astype(np.float32)


def stats_partials(u, s, nt):
    """The per-tile partial sums of u and u^2 that K4-stats writes, in the
    kernel's order, from u (N, Cout, s h, s w) f32: warp w (0..11) holds
    tile rows w + 12 m (m < tr / 12); each lane its pixels (rows m in
    turn, in each the columns gl, gl + 8), skipping pixels outside the
    image; lanes xor 4, 8, 16 add pairwise (((g0 + g1) + (g2 + g3)) + ((g4
    + g5) + (g6 + g7))); the 12 warps add in turn. Returns p1, p2 (N x
    tiles, Cout) and a count of how often each output element was
    summed."""
    n_, cout, ho, wo = u.shape
    h, w = ho // s, wo // s
    tr = tile_rows(nt)
    gx, gy = s * s * cdiv(w, TW), cdiv(h, tr)
    p1 = np.zeros((n_ * gx * gy, cout), np.float32)
    p2 = np.zeros_like(p1)
    seen = np.zeros(u.shape, np.int64)
    for n in range(n_):
        for n0 in range(0, cout, nt):
            for by in range(gy):
                for bx in range(gx):
                    ph = bx % (s * s)
                    ry, rx = divmod(ph, s)
                    qx0, q0 = (bx // (s * s)) * TW, by * tr
                    a1 = np.zeros((12, 8, nt), np.float32)
                    a2 = np.zeros_like(a1)
                    for mm, hh in ((mm, hh) for mm in range(tr // 12)
                                   for hh in range(2)):
                        for wi in range(12):
                            for gl in range(8):
                                q, qx = q0 + wi + 12 * mm, qx0 + gl + 8 * hh
                                for col in range(nt):
                                    co = n0 + col
                                    if q >= h or qx >= w or co >= cout:
                                        continue
                                    v = u[n, co, s * q + ry, s * qx + rx]
                                    seen[n, co, s * q + ry, s * qx + rx] += 1
                                    a1[wi, gl, col] = np.float32(
                                        a1[wi, gl, col] + v)
                                    a2[wi, gl, col] = _fma32(
                                        a2[wi, gl, col], v, v)
                    sums = []
                    for a in (a1, a2):
                        b = (a[:, 0::2] + a[:, 1::2]).astype(np.float32)
                        c = (b[:, 0::2] + b[:, 1::2]).astype(np.float32)
                        d = (c[:, 0] + c[:, 1]).astype(np.float32)
                        t = np.zeros(nt, np.float32)
                        for wi in range(12):
                            t = (t + d[wi]).astype(np.float32)
                        sums.append(t)
                    row = (n * gy + by) * gx + bx
                    m = min(nt, cout - n0)
                    p1[row, n0:n0 + m] = sums[0][:m]
                    p2[row, n0:n0 + m] = sums[1][:m]
    return p1, p2, seen


@pytest.mark.parametrize("transposed,k,s", FAMILIES, ids=IDS)
@pytest.mark.parametrize("cout", [5, 40, 70])
def test_stats_epilogue_partials_sum_to_the_plain_sums(transposed, k, s,
                                                      cout):
    """Ragged tiles (h = 30, w = 19 against 24 x 16 tiles for N = 8, cout
    5; 12 x 16 for 64, cout 40, and two column tiles of 64, 70): each
    output element is summed exactly once, the pixels past the image are
    skipped, and the partial rows summed over the tiles equal the plain
    sums of u and u^2 to 1e-6 of their scale."""
    x, wt = _inputs(transposed, k, cin=3, cout=cout, h=30, w=19, n=1)
    u = _conv(x, wt, transposed, k, s).float().numpy()
    s_ = s if transposed else 1
    p1, p2, seen = stats_partials(u, s_, pick_nt(cout))
    assert (seen == 1).all()
    assert p1.shape == (s_ * s_ * cdiv(19, TW)
                        * cdiv(30, tile_rows(pick_nt(cout))), cout)
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


# the u GEMM at the sites: contraction length, and the k-steps a chunk
# would hold if its sum stayed in the accumulator (a 128-byte K row)
U_SITES = {"A": (3 * 25, 10), "B": (128 * 4, 4), "D": (32 * 4, 4)}


@pytest.mark.parametrize("site", sorted(U_SITES))
def test_u_gemm_summed_a_k_step_at_a_time_does_not_drift(site):
    """The accumulator truncates, so a u summed across a chunk's k-steps in
    it drifts toward zero, and the drift reaches the batch mean; summed a
    k-step at a time from zero and drained into f32 (the kernels' two
    accumulators in turn) the drift is at most a third of that (a tenth
    at site A, against a 10-k-step chunk) and under 1e-7 of u's scale,
    and the spread of the error at most an f32 FMA
    chain's. Half-normal x against zero-mean weights, as
    ``smoke.k4_inputs`` makes them."""
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

    chunk = drift_spread(kstep_3xtf32(x.T, w, 8, chunk=ksteps))
    kstep = drift_spread(kstep_3xtf32(x.T, w, 8))
    assert chunk[0] > 0 and kstep[0] < chunk[0] / 3, (chunk, kstep)
    assert abs(kstep[0]) < 1e-7, kstep
    assert kstep[1] <= 1.1 * drift_spread(fma)[1], (kstep, chunk)
    if site == "A":
        assert kstep[0] < chunk[0] / 10, (chunk, kstep)
