"""K4, the fused train-mode conv (or transposed conv) + batch norm + ReLU:
the four CUDA kernels' wrappers, an autograd function over them, and their
plain PyTorch versions.

Port of ``baryon_painter_tpu/ops/pallas_conv_bn.py`` (``fused_conv_bn_relu``
with its custom VJP and its XLA backward ``_bwd_xla``). Layout NCHW with the
port's weight layouts: OIHW for a conv, IOHW for a transposed conv (as
``F.conv2d`` and ``F.conv_transpose2d`` take them). With u = conv(x, w), no
bias, and the batch statistics of u over (N, H, W) per channel in f32 (the
fast biased variance E[u^2] - E[u]^2, as flax computes it):

    inv = rsqrt(var + eps); a = gamma * inv; b = beta - mean * a
    y = relu(u * a + b)

``mean`` and ``var`` are returned for the caller's running-statistics
update and carry no gradient (the JAX ``stop_gradient`` contract). The
backward is the exact full batch-norm backward through the batch
statistics (``_bwd_xla``):

    dv = dy where the forward's y > 0, else 0;  uhat = (u - mean) * inv
    S1 = sum(dv), S2 = sum(dv * uhat) over (N, H, W);  n = N H W
    du = a * (dv - S1/n - uhat * S2/n);  dgamma = S2;  dbeta = S1
    dx, dW = the convolution's adjoints applied to du

The ReLU mask is the forward's own (y > 0, y saved for the backward), so
the backward's rounding cannot send a pre-activation near 0 to the other
branch (in bf16, y > 0 is v > 0 but for a v below bf16's smallest
subnormal, which rounds to a y of 0). Four kernels (``csrc/conv_bn.cu``):
K4-stats (u, in f32 written into the buffer that becomes y, and per-tile
partial sums of u and u^2), K4-fwd (y, in f32 in place over u), K4-bwd1
(u again, kept in a scratch tensor for K4-bwd2, and partial S1, S2) and
K4-bwd2 (three launches: du formed once a pixel, in f32 over u, which it is
the last to read; dW as partials over a split of the pixels; dx). K4-bwd2
consumes u: on the card its contents are unspecified after the call, in
either dtype, and a caller that needs u afterwards passes a clone. stats,
bwd1 and bwd2's dx and dW are implicit GEMMs on Hopper's warpgroup
products fed by TMA, in 3xTF32 for f32 and one bf16 pass for bf16; stats
and bwd1 share one mainloop, so the u behind the batch statistics and the
ReLU mask is, bit for bit, the u of the backward. The weights reach the
kernels in their GEMM layouts (``_kernel_weights``, made per call: a few
small tensors) and TMA reads rows whose pitch is a multiple of 16 bytes,
so x and du are padded where the width is not (``_pitched``). The
partials are summed here in torch, so every result is deterministic. The
kernels take two families: a stride-1 "same" conv with odd k in (1, 3, 5,
7), and a transposed conv with k = 2s, p = s/2, s in (2, 4), in float32 or
bfloat16. On CUDA tensors anything else raises; on CPU tensors each wrapper
is its plain version, which takes any stride and padding (K4-fwd in place in
f32, as on the card).

bfloat16 (the JAX package's default compute dtype) keeps the JAX kernels'
rounding points (``pallas_conv_bn.py``): x, w, y, dy and dx are bf16; u is
the f32 sum of the bf16 products (``preferred_element_type=f32``), and its
sums, mean, var, a, b, S1, S2 and the dW partials are f32; y =
bf16(relu(u a + b)) is a new bf16 tensor (it cannot take the 4-byte u's
buffer); du is rounded to bf16 before both of its products; dx is rounded
once from its f32 sum; dW is the f32 sum rounded once to bf16 (the dtype of
w, whose cast's adjoint brings it to the f32 parameter). The plain versions
compute u in f32 from the bf16 values and round where the kernels round;
they never use PyTorch's CPU bf16 convolution (wrong at some shapes) nor, on
the card, cuDNN's bf16 convolution (which would round u to bf16). Each
wrapper counts its bf16 launches apart in ``.bf16_launches``.

Under a ``ProcessMesh`` (``parallel/mesh.py``, inside its ``active()``
block) each rank's kernels run on its own rows, and ``conv_bn_relu``
all-reduces between launches: K4-stats' (s1, s2) before the statistics,
with the global count, and K4-bwd1's (S1, S2) before K4-bwd2. No kernel
changes; dgamma and dbeta stay the rank's share.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_input, conv2d_weight

from baryon_painter_tpu_torch.ops.head_stack import (_DTYPE_CODES,
                                                     _compute_dtype, _launch,
                                                     _operand, rounder)
from baryon_painter_tpu_torch.parallel.mesh import active_mesh

__all__ = ["conv_bn_relu", "conv_bn_stats", "conv_bn_fwd", "conv_bn_bwd1",
           "conv_bn_bwd2", "conv_bn_stats_ref", "conv_bn_fwd_ref", "du_ref",
           "conv_bn_bwd1_ref", "conv_bn_bwd2_ref", "conv_bn_relu_ref",
           "conv_bn_relu_bwd_ref", "batch_stats", "bn_affine",
           "kernel_family"]

EPS = 1e-5
# (stride, kernel) pairs the kernels are compiled for: stride 1 is the
# "same" conv, stride > 1 the transposed conv with k = 2s, p = s/2
_SAME_K = (1, 3, 5, 7)
_TRANSP_S = (2, 4)


def _conv(x, w, transposed, stride, padding):
    if transposed:
        return F.conv_transpose2d(x, w, stride=stride, padding=padding)
    return F.conv2d(x, w, stride=stride, padding=padding)


def _adjoints(x, w, du, transposed, stride, padding):
    """(dx, dW) of the convolution at x for the output cotangent du."""
    if transposed:
        # conv_transpose2d is the input gradient of conv2d with the same
        # (IOHW read as OIHW) weight; its adjoints are conv2d's forward and
        # weight gradient with the roles of x and du exchanged
        dx = F.conv2d(du, w, stride=stride, padding=padding)
        dw = conv2d_weight(du, w.shape, x, stride=stride, padding=padding)
        return dx, dw
    return (conv2d_input(x.shape, w, du, stride=stride, padding=padding),
            conv2d_weight(x, w.shape, du, stride=stride, padding=padding))


def _vec(t):
    return t[:, None, None]


def batch_stats(s1, s2, count: int):
    """(mean, var) from the sums of u and u^2: the fast biased variance."""
    mean = s1 / count
    return mean, s2 / count - mean * mean


def bn_affine(gamma, beta, mean, var, eps: float = EPS):
    """(inv, a, b): inv = rsqrt(var + eps), a = gamma inv, b = beta - mean a."""
    inv = torch.rsqrt(var + eps)
    a = gamma * inv
    return inv, a, beta - mean * a


def kernel_family(x, w, transposed: bool, stride: int, padding: int):
    """(k, s) of the kernels' family, s = 1 for the "same" conv; raises
    ValueError for a configuration the kernels do not take."""
    k = w.shape[-1]
    if w.ndim != 4 or w.shape[-2] != k:
        raise ValueError(f"conv_bn: w must be (., ., k, k), got "
                         f"{tuple(w.shape)}")
    if transposed:
        if stride in _TRANSP_S and k == 2 * stride and padding == stride // 2:
            return k, stride
        raise ValueError(
            f"conv_bn: the kernels take a transposed conv with k = 2s, "
            f"p = s/2, s in {_TRANSP_S}; got k={k}, s={stride}, "
            f"p={padding}")
    if stride == 1 and k in _SAME_K and padding == (k - 1) // 2:
        return k, 1
    raise ValueError(
        f"conv_bn: the kernels take a stride-1 'same' conv with k in "
        f"{_SAME_K}; got k={k}, s={stride}, p={padding}")


def _out_shape(x, w, transposed, stride):
    n, _, h, wd = x.shape
    cout = w.shape[1] if transposed else w.shape[0]
    s = stride if transposed else 1
    return n, cout, h * s, wd * s


def _check_dtype(fn, dtype):
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"{fn}: the kernels take float32 or bfloat16, got "
                        f"{dtype}")


def _check_fwd(fn, u, a, b, dtype=torch.float32):
    """Raise on anything K4-fwd does not take: u (N, C, H, W), a and b
    (C,), all f32, contiguous and on one device (in f32 y is written over
    u, so nothing is copied), and y's ``dtype`` float32 or bfloat16."""
    _check_dtype(fn, dtype)
    for name, t in {"u": u, "a": a, "b": b}.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: {name} must be float32 (u, a and b are "
                            f"f32 in both dtypes), got {t.dtype}")
        if t.device != u.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, u on "
                             f"{u.device}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous (y is "
                             f"written over u in place)")
    if u.ndim != 4:
        raise ValueError(f"{fn}: u must be (N, C, H, W), got "
                         f"{tuple(u.shape)}")
    n, c, h, w = u.shape
    for name, t in (("a", a), ("b", b)):
        if tuple(t.shape) != (c,):
            raise ValueError(f"{fn}: {name} must be ({c},), got "
                             f"{tuple(t.shape)}")
    # the grid: a block per (plane, run of 1024 float4 groups)
    if u.numel() == 0 or n * c > 2**31 - 1 or h * w > 4 * 1024 * 65535:
        raise ValueError(f"{fn}: u must be non-empty with N * C < 2^31 "
                         f"and H * W <= 4 * 1024 * 65535, got "
                         f"{tuple(u.shape)}")


def _check(fn, x, w, transposed, stride, padding, vecs=None, outs=None):
    """Raise on anything the kernels do not take; returns (k, s). ``outs``
    (name: tensor) must have y's shape."""
    vecs, outs = vecs or {}, outs or {}
    _check_dtype(fn, x.dtype)
    tensors = {"x": x, "w": w, **vecs, **outs}
    for name, t in tensors.items():
        # u and the per-channel vectors are f32; w, y and dy x's dtype
        want = x.dtype if name in ("x", "w", "y", "dy") else torch.float32
        if t.dtype != want:
            raise TypeError(f"{fn}: {name} must be {want} (x is {x.dtype}; "
                            f"u and the vectors are float32), got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, x on "
                             f"{x.device}")
    if x.ndim != 4:
        raise ValueError(f"{fn}: x must be (N, C, H, W), got "
                         f"{tuple(x.shape)}")
    cin = w.shape[0] if transposed else w.shape[1]
    if x.shape[1] != cin:
        raise ValueError(f"{fn}: x has {x.shape[1]} channels, w takes {cin}")
    k, s = kernel_family(x, w, transposed, stride, padding)
    n, cout, ho, wo = _out_shape(x, w, transposed, stride)
    for name, t in vecs.items():
        if tuple(t.shape) != (cout,):
            raise ValueError(f"{fn}: {name} must be ({cout},), got "
                             f"{tuple(t.shape)}")
    for name, t in outs.items():
        if tuple(t.shape) != (n, cout, ho, wo):
            raise ValueError(f"{fn}: {name} must be {(n, cout, ho, wo)}, "
                             f"got {tuple(t.shape)}")
    # the persistent grids number their tiles (phases x 16-column x 12-row
    # tiles x samples x column blocks) in an int
    h, wd = x.shape[2], x.shape[3]
    if 16 * -(-wd // 16) * -(-h // 12) * n * -(-max(cin, cout) // 8) \
            > 2**31 - 1:
        raise ValueError(f"{fn}: 16 ceil(W / 16) ceil(H / 12) N "
                         f"ceil(max(Cin, Cout) / 8) must be below 2^31")
    return k, s


def _device(fn, x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {x.device}")
    return x.device.type == "cuda"


def _dims(x, w, transposed, k, s):
    n, cin, h, wd = x.shape
    cout = w.shape[1] if transposed else w.shape[0]
    return n, cin, h, wd, cout, k, s



# K elements a 128-byte row of a weight tile holds (a K chunk)
_KCH = {torch.float32: 32, torch.bfloat16: 64}


def _tf32(t):
    """f32 rounded to tf32 (10 mantissa bits), to nearest, ties away from
    zero, as cvt.rna.tf32.f32 rounds (finite values)."""
    return ((t.view(torch.int32) + 0x1000) & -8192).view(torch.float32)


def _split_tf32(t):
    """(big, small) of an f32 tensor, the 3xTF32 halves the kernels
    multiply: big = tf32(t), small = tf32(t - big), both rounded to
    nearest (the tensor cores then truncate neither)."""
    big = _tf32(t)
    return big, _tf32(t - big)


def _kernel_weights(w, transposed: bool, k: int, s: int, which: str):
    """w in a GEMM's B layout, (phases, parts, N, Kp): ``which`` "u" (the
    u GEMM of stats and bwd1: one phase per output phase (ry, rx) = (p // s,
    p % s), N = Cout, K = (ci, tap) with the phase's taps (ty, tx) at kernel
    entry ((ry + s/2) % s + s ty, ...), or (ci, ky, kx) for the "same"
    conv) or "dx" (one phase, N = Cin, K = (co, ky, kx)); K zero-padded to
    a whole number of 128-byte rows; parts (big, small) in f32, the raw
    values in bf16."""
    if which == "u":
        if transposed:
            p = s // 2
            mats = [w[:, :, (ry + p) % s::s, (rx + p) % s::s]
                    .permute(1, 0, 2, 3).reshape(w.shape[1], -1)
                    for ry in range(s) for rx in range(s)]
        else:
            mats = [w.reshape(w.shape[0], -1)]
    else:
        wt = w if transposed else w.permute(1, 0, 2, 3)
        mats = [wt.reshape(wt.shape[0], -1)]
    m = torch.stack(mats)
    m = F.pad(m, (0, -m.shape[-1] % _KCH[w.dtype]))
    if w.dtype == torch.float32:
        return torch.stack(_split_tf32(m.contiguous()), 1).contiguous()
    return m[:, None].contiguous()


def _pitched(t):
    """(t, pitch): t's rows padded with zeros to a multiple of 16 bytes
    (TMA's row pitch), and the pitch in elements; t itself where its rows
    are already."""
    al = 16 // t.element_size()
    w = t.shape[-1]
    if w % al == 0:
        return t, w
    return F.pad(t, (0, al - w % al)), w + al - w % al

def _u(x, w, transposed, stride, padding):
    """u = the library's conv, in f32 on the values of 16-bit x and w."""
    dt = _compute_dtype(x.dtype)
    return _conv(x.to(dt), w.to(dt), transposed, stride, padding)


def conv_bn_stats_ref(x, w, *, transposed: bool, stride: int,
                      padding: int):
    """Plain version of K4-stats: (sum of u, sum of u^2, u) with u the
    library's conv (f32 for bf16 x and w) and the sums in f32."""
    u = _u(x, w, transposed, stride, padding)
    uf = u.float()
    return uf.sum((0, 2, 3)), (uf * uf).sum((0, 2, 3)), u


def conv_bn_fwd_ref(u, a, b, dtype=None):
    """Plain version of K4-fwd: relu(u * a + b) per channel, a new tensor,
    rounded to ``dtype`` (None: u's)."""
    return torch.relu(u * _vec(a) + _vec(b)).to(dtype or u.dtype)


def _dv_uhat(u, mean, inv, dy, active):
    return torch.where(active, dy, 0.0), (u - _vec(mean)) * _vec(inv)


def conv_bn_bwd1_ref(x, w, mean, inv, dy, *, transposed: bool, stride: int,
                     padding: int, active):
    """Plain version of K4-bwd1: (S1, S2, u) with u = the library's conv and
    ``active`` (y's shape, bool) the forward's ReLU mask, y > 0."""
    u = _u(x, w, transposed, stride, padding)
    dv, uhat = _dv_uhat(u, mean, inv, dy.to(u.dtype), active)
    return dv.sum((0, 2, 3)), (dv * uhat).sum((0, 2, 3)), u


def du_ref(u, dy, a, mean, inv, s1n, s2n, active, dtype):
    """Plain du = a (dv - s1n - uhat s2n) from u (f32) and dy, rounded to
    ``dtype`` (the value bwd2's products read)."""
    dv, uhat = _dv_uhat(u, mean, inv, dy.to(u.dtype), active)
    return rounder(dtype)(_vec(a) * (dv - _vec(s1n) - uhat * _vec(s2n)))


def conv_bn_bwd2_ref(x, w, a, mean, inv, s1n, s2n, dy, *, transposed: bool,
                     stride: int, padding: int, active, u=None):
    """Plain version of K4-bwd2: du from u (given, as K4-bwd1 returns it, or
    recomputed), then the library's adjoints (``active`` as in
    ``conv_bn_bwd1_ref``). In bf16 du is rounded to bf16 before both
    products, which sum in f32; dx returns in x's dtype and dW in w's, each
    rounded once."""
    if u is None:
        u = _u(x, w, transposed, stride, padding)
    du = du_ref(u, dy, a, mean, inv, s1n, s2n, active, x.dtype)
    dt = _compute_dtype(x.dtype)
    dx, dw = _adjoints(x.to(dt), w.to(dt), du, transposed, stride, padding)
    return dx.to(x.dtype), dw.to(w.dtype)


def conv_bn_stats(x, w, *, transposed: bool, stride: int, padding: int):
    """K4-stats: (sum of u, sum of u^2, u) per output channel, f32, with
    u = conv(x, w) of y's shape, f32 for bf16 x and w too (in f32 K4-fwd
    turns it into y in place).

    On CPU tensors the plain version. On CUDA tensors one launch on the
    current stream (adds one to ``conv_bn_stats.launches``, and in bf16 to
    ``.bf16_launches``), the u GEMM of
    K4-bwd1, writing u and per-tile partial sums, summed here in f64 and
    rounded once. The training step's gradients are sensitive to the
    rounding of the batch statistics: with an f32 sum of the 3k to 25k
    partial rows they stood ten times further from the plain step's than
    with this one (``PERF.md`` §6)."""
    kw = dict(transposed=transposed, stride=stride, padding=padding)
    if not _device("conv_bn_stats", x):
        return conv_bn_stats_ref(x, w, **kw)
    k, s = _check("conv_bn_stats", x, w, transposed, stride, padding)
    from baryon_painter_tpu_torch.ops._build import load_library
    n, cin, h, wd, cout = _dims(x, w, transposed, k, s)[:5]
    rows = n * load_library().bpt_conv_bn_bwd1_tiles(h, wd, cout, k, s)
    u = torch.empty(_out_shape(x, w, transposed, stride), dtype=torch.float32,
                    device=x.device)
    p1 = torch.empty((rows, cout), dtype=torch.float32, device=x.device)
    p2 = torch.empty_like(p1)
    xp, pitch = _pitched(_operand(x))
    _launch("conv_bn_stats", "bpt_conv_bn_stats", xp,
            _kernel_weights(_operand(w), transposed, k, s, "u"), u, p1, p2,
            n, cin, h, wd, pitch, cout, k, s, _DTYPE_CODES[x.dtype])
    conv_bn_stats.launches += 1
    conv_bn_stats.bf16_launches += x.dtype == torch.bfloat16
    return (p1.sum(0, dtype=torch.float64).float(),
            p2.sum(0, dtype=torch.float64).float(), u)


conv_bn_stats.launches = 0
conv_bn_stats.bf16_launches = 0


def conv_bn_fwd(u, a, b, dtype=torch.float32):
    """K4-fwd: y = relu(u * a + b) per channel, u (N, C, H, W) f32 as
    K4-stats returns it, y in ``dtype``: float32 written over u in place
    (returns u), bfloat16 into a new tensor (rounded to nearest even).

    On CPU tensors the plain version's operations (in f32 in place, each
    rounded as in ``conv_bn_fwd_ref``, so the two agree bit for bit). On
    CUDA tensors one launch (adds one to ``conv_bn_fwd.launches``, and in
    bf16 to ``.bf16_launches``)."""
    if not _device("conv_bn_fwd", u):
        if dtype == torch.float32:
            return u.mul_(_vec(a)).add_(_vec(b)).clamp_min_(0.0)
        _check_dtype("conv_bn_fwd", dtype)
        return conv_bn_fwd_ref(u, a, b, dtype)
    _check_fwd("conv_bn_fwd", u, a, b, dtype)
    n, c, h, w = u.shape
    y = u if dtype == torch.float32 else torch.empty_like(u, dtype=dtype)
    _launch("conv_bn_fwd", "bpt_conv_bn_fwd", u, a, b, y, n, c, h * w,
            _DTYPE_CODES[dtype])
    conv_bn_fwd.launches += 1
    conv_bn_fwd.bf16_launches += dtype == torch.bfloat16
    return y


conv_bn_fwd.launches = 0
conv_bn_fwd.bf16_launches = 0


def conv_bn_bwd1(x, w, mean, inv, y, dy, *, transposed: bool, stride: int,
                 padding: int):
    """K4-bwd1: (S1, S2, u), S1 = sum of dv, S2 = sum of dv * uhat per
    channel with the forward's mask y > 0, and u = conv(x, w) (f32) for
    K4-bwd2; y and dy in x's dtype.

    On CPU tensors the plain version; on CUDA tensors one launch (adds one
    to ``conv_bn_bwd1.launches``, and in bf16 to ``.bf16_launches``)
    writing u into an f32 tensor of y's shape and per-tile partials,
    summed here."""
    if not _device("conv_bn_bwd1", x):
        return conv_bn_bwd1_ref(x, w, mean, inv, dy, transposed=transposed,
                                stride=stride, padding=padding,
                                active=y > 0)
    k, s = _check("conv_bn_bwd1", x, w, transposed, stride, padding,
                  {"mean": mean, "inv": inv}, {"y": y, "dy": dy})
    from baryon_painter_tpu_torch.ops._build import load_library
    n, cin, h, wd, cout = _dims(x, w, transposed, k, s)[:5]
    rows = n * load_library().bpt_conv_bn_bwd1_tiles(h, wd, cout, k, s)
    u = torch.empty(y.shape, dtype=torch.float32, device=x.device)
    p1 = torch.empty((rows, cout), dtype=torch.float32, device=x.device)
    p2 = torch.empty_like(p1)
    xp, pitch = _pitched(_operand(x))
    _launch("conv_bn_bwd1", "bpt_conv_bn_bwd1", xp,
            _kernel_weights(_operand(w), transposed, k, s, "u"),
            *(_operand(t) for t in (mean, inv, y, dy)), u, p1, p2, n, cin, h,
            wd, pitch, cout, k, s, _DTYPE_CODES[x.dtype])
    conv_bn_bwd1.launches += 1
    conv_bn_bwd1.bf16_launches += x.dtype == torch.bfloat16
    return p1.sum(0), p2.sum(0), u


conv_bn_bwd1.launches = 0
conv_bn_bwd1.bf16_launches = 0


def bwd2_du(u, y, dy, a, mean, inv, s1n, s2n):
    """K4-bwd2's first launch: (du, pitch), du = a (dv - s1n - uhat s2n) in
    y's dtype, (N, C, Ho, pitch) with zeros past the width; in f32 written
    over u where u's rows need no padding (``conv_bn_bwd2`` consumes u)."""
    n, c, ho, wo = y.shape
    al = 16 // y.element_size()
    pitch = -(-wo // al) * al
    u = _operand(u)   # du over the very tensor the kernel reads
    if y.dtype == torch.float32 and pitch == wo:
        du = u
    else:
        du = torch.empty((n, c, ho, pitch), dtype=y.dtype, device=y.device)
    _launch("conv_bn_bwd2", "bpt_conv_bn_du", u,
            *(_operand(t) for t in (y, dy, a, mean, inv, s1n, s2n)), du, n,
            c, ho, wo, pitch, _DTYPE_CODES[y.dtype])
    return du, pitch


def bwd2_dw(x, w, du, pitch, k, s):
    """K4-bwd2's dW launch: dW in w's dtype, the f32 sum of the per-split
    partials in a fixed order, rounded once."""
    from baryon_painter_tpu_torch.ops._build import load_library
    lib = load_library()
    n, cin, h, wd = x.shape
    cout = du.shape[1]
    code = _DTYPE_CODES[x.dtype]
    splits = lib.bpt_conv_bn_bwd2_splits(n, cin, h, wd, cout, k, s, code)
    dwp = torch.empty((splits,) + tuple(w.shape), dtype=torch.float32,
                      device=x.device)
    xp, xpitch = _pitched(_operand(x))
    _launch("conv_bn_bwd2", "bpt_conv_bn_dw", xp, du, dwp, n, cin, h, wd,
            xpitch, cout, pitch, k, s, splits, code)
    return dwp.sum(0).to(w.dtype)


def bwd2_dx(x, w, du, pitch, transposed, k, s):
    """K4-bwd2's dx launch: dx in x's dtype."""
    n, cin, h, wd = x.shape
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    _launch("conv_bn_bwd2", "bpt_conv_bn_dx", du,
            _kernel_weights(_operand(w), transposed, k, s, "dx"), dx, n, cin,
            h, wd, du.shape[1], pitch, k, s, _DTYPE_CODES[x.dtype])
    return dx


def conv_bn_bwd2(x, w, a, mean, inv, s1n, s2n, u, y, dy, *, transposed: bool,
                 stride: int, padding: int):
    """K4-bwd2: (dx, dW) from du = a (dv - s1n - uhat s2n), with s1n = S1/n,
    s2n = S2/n, u (f32) from K4-bwd1 and the forward's mask y > 0; dx in
    x's dtype, dW in w's.

    u is consumed: on CUDA tensors its contents are unspecified on return
    (in f32 du is formed in u's buffer where its rows need no padding),
    so a caller that needs u afterwards passes a clone. On CPU tensors the
    plain version, which leaves u as it is; on CUDA tensors one call (adds
    one to ``conv_bn_bwd2.launches``, and in bf16 to ``.bf16_launches``) of
    three launches: du (``bwd2_du``), dW as f32 partials over a split of
    the pixels, summed here in f32 and rounded once to w's dtype
    (``bwd2_dw``), and dx (``bwd2_dx``)."""
    if not _device("conv_bn_bwd2", x):
        return conv_bn_bwd2_ref(x, w, a, mean, inv, s1n, s2n, dy,
                                transposed=transposed, stride=stride,
                                padding=padding, active=y > 0, u=u)
    vecs = {"a": a, "mean": mean, "inv": inv, "s1n": s1n, "s2n": s2n}
    k, s = _check("conv_bn_bwd2", x, w, transposed, stride, padding, vecs,
                  {"u": u, "y": y, "dy": dy})
    du, pitch = bwd2_du(u, y, dy, a, mean, inv, s1n, s2n)
    dw = bwd2_dw(x, w, du, pitch, k, s)
    dx = bwd2_dx(x, w, du, pitch, transposed, k, s)
    conv_bn_bwd2.launches += 1
    conv_bn_bwd2.bf16_launches += x.dtype == torch.bfloat16
    return dx, dw


conv_bn_bwd2.launches = 0
conv_bn_bwd2.bf16_launches = 0


def _count(x, w, transposed, stride):
    n, _, ho, wo = _out_shape(x, w, transposed, stride)
    return n * ho * wo


def conv_bn_relu_ref(x, w, gamma, beta, *, transposed: bool, stride: int,
                     padding: int, eps: float = EPS):
    """Plain PyTorch forward: (y, mean, var), the library's conv, the batch
    statistics in f32, the affine and the ReLU; y in x's dtype."""
    kw = dict(transposed=transposed, stride=stride, padding=padding)
    s1, s2, u = conv_bn_stats_ref(x, w, **kw)
    mean, var = batch_stats(s1, s2, _count(x, w, transposed, stride))
    _, a, b = bn_affine(gamma, beta, mean, var, eps)
    return conv_bn_fwd_ref(u, a, b, x.dtype), mean, var


def conv_bn_relu_bwd_ref(x, w, gamma, beta, mean, var, dy, *,
                         transposed: bool, stride: int, padding: int,
                         active, eps: float = EPS):
    """Plain PyTorch backward, the math of the JAX ``_bwd_xla`` on the
    logical convolution: (dx, dW, dgamma, dbeta) for the cotangent dy of y,
    given the forward's batch statistics and, as ``active``, where its ReLU
    passed (y > 0); dx in x's dtype, dW in w's, dgamma and dbeta f32."""
    kw = dict(transposed=transposed, stride=stride, padding=padding,
              active=active)
    inv, a, _ = bn_affine(gamma, beta, mean, var, eps)
    s1, s2, u = conv_bn_bwd1_ref(x, w, mean, inv, dy, **kw)
    n = _count(x, w, transposed, stride)
    dx, dw = conv_bn_bwd2_ref(x, w, a, mean, inv, s1 / n, s2 / n, dy, u=u,
                              **kw)
    return dx, dw, s2, s1


class _ConvBnRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, gamma, beta, transposed, stride, padding, eps):
        kw = dict(transposed=transposed, stride=stride, padding=padding)
        count = _count(x, w, transposed, stride)
        s1, s2, u = conv_bn_stats(x, w, **kw)
        mesh = active_mesh()
        if mesh is not None:
            # the global batch's sums between K4-stats and K4-fwd; every
            # rank holds an equal share
            s1, s2 = mesh.all_reduce(torch.stack([s1, s2]))
            count *= mesh.size
        ctx.mesh = mesh
        mean, var = batch_stats(s1, s2, count)
        inv, a, b = bn_affine(gamma, beta, mean, var, eps)
        # f32: in place over u; bf16: a new tensor, u freed on return
        y = conv_bn_fwd(u, a, b, x.dtype)
        # y carries the ReLU mask to the backward (the next layer keeps it)
        ctx.save_for_backward(x, w, a, mean, inv, y)
        ctx.kw, ctx.count = kw, count
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, w, a, mean, inv, y = ctx.saved_tensors
        dy = dy.to(x.dtype).contiguous()
        s1, s2, u = conv_bn_bwd1(x, w, mean, inv, y, dy, **ctx.kw)
        g1, g2 = s1, s2
        if ctx.mesh is not None:
            # K4-bwd2 needs the global batch's sums; dgamma and dbeta stay
            # this rank's share, summed with the other gradients
            g1, g2 = ctx.mesh.all_reduce(torch.stack([s1, s2]))
        dx, dw = conv_bn_bwd2(x, w, a, mean, inv, g1 / ctx.count,
                              g2 / ctx.count, u, y, dy, **ctx.kw)
        return dx, dw, s2, s1, None, None, None, None


def conv_bn_relu(x, w, gamma, beta, *, transposed: bool, stride: int,
                 padding: int, eps: float = EPS, bias=None):
    """Fused train-mode ``relu(batch_norm(conv(x, w)))``: (y, mean, var).

    x (N, Cin, H, W) and w, OIHW (conv) or IOHW (``transposed``), both
    float32 or both bfloat16; gamma, beta (Cout,) f32. Differentiable in x,
    w, gamma and beta (dx in x's dtype, dW in w's, dgamma and dbeta f32);
    y in x's dtype; mean and var f32, with no gradient. On CUDA tensors the
    forward is K4-stats then K4-fwd (in f32 y written over stats' u) and
    the backward K4-bwd1 then K4-bwd2 (u kept between them, y's mask); on
    CPU tensors their plain versions. The triple it fuses has a bias-free
    conv: a ``bias`` raises."""
    if bias is not None:
        raise ValueError("conv_bn_relu: the conv must be bias-free (a bias "
                         "before a batch norm cancels)")
    return _ConvBnRelu.apply(x, w, gamma, beta, transposed, stride, padding,
                             eps)
