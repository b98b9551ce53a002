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

    dv = dy where u * a + b > 0 (strictly), else 0;  uhat = (u - mean) * inv
    S1 = sum(dv), S2 = sum(dv * uhat) over (N, H, W);  n = N H W
    du = a * (dv - S1/n - uhat * S2/n);  dgamma = S2;  dbeta = S1
    dx, dW = the convolution's adjoints applied to du

Four kernels (``csrc/conv_bn.cu``), each recomputing u from x: K4-stats
(per-block partial sums of u and u^2), K4-fwd (y), K4-bwd1 (partial S1, S2)
and K4-bwd2 (dx and partial dW); the partials are summed here in torch, so
every result is deterministic. The kernels take two families: a stride-1
"same" conv with odd k in (1, 3, 5, 7), and a transposed conv with k = 2s,
p = s/2, s in (2, 4); f32 only. On CUDA tensors anything else raises; on
CPU tensors each wrapper is its plain version, which takes any stride and
padding.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_input, conv2d_weight

from baryon_painter_tpu_torch.ops.head_stack import _launch, _operand

__all__ = ["conv_bn_relu", "conv_bn_stats", "conv_bn_fwd", "conv_bn_bwd1",
           "conv_bn_bwd2", "conv_bn_stats_ref", "conv_bn_fwd_ref",
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


def _check(fn, x, w, transposed, stride, padding, vecs=None, dy=None):
    """Raise on anything the kernels do not take; returns (k, s)."""
    vecs = vecs or {}
    tensors = {"x": x, "w": w, **vecs}
    if dy is not None:
        tensors["dy"] = dy
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise TypeError(f"{fn}: {name} must be float32 (the kernels are "
                            f"f32 only), got {t.dtype}")
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
    if dy is not None and tuple(dy.shape) != (n, cout, ho, wo):
        raise ValueError(f"{fn}: dy must be {(n, cout, ho, wo)}, got "
                         f"{tuple(dy.shape)}")
    if n * -(-cout // 16) > 65535:
        raise ValueError(f"{fn}: N * ceil(Cout / 16) must be at most 65535")
    return k, s


def _device(fn, x):
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{fn}: unsupported device {x.device}")
    return x.device.type == "cuda"


def _dims(x, w, transposed, k, s):
    n, cin, h, wd = x.shape
    cout = w.shape[1] if transposed else w.shape[0]
    return n, cin, h, wd, cout, k, s


def conv_bn_stats_ref(x, w, *, transposed: bool, stride: int,
                      padding: int):
    """Plain version of K4-stats: the library's conv, then the sums."""
    u = _conv(x, w, transposed, stride, padding).float()
    return u.sum((0, 2, 3)), (u * u).sum((0, 2, 3))


def conv_bn_fwd_ref(x, w, a, b, *, transposed: bool, stride: int,
                    padding: int):
    """Plain version of K4-fwd."""
    u = _conv(x, w, transposed, stride, padding)
    return torch.relu(u * _vec(a) + _vec(b))


def _dv_uhat(x, w, a, b, mean, inv, dy, transposed, stride, padding,
             active=None):
    u = _conv(x, w, transposed, stride, padding)
    if active is None:
        active = u * _vec(a) + _vec(b) > 0
    return torch.where(active, dy, 0.0), (u - _vec(mean)) * _vec(inv)


def conv_bn_bwd1_ref(x, w, a, b, mean, inv, dy, *, transposed: bool,
                     stride: int, padding: int, active=None):
    """Plain version of K4-bwd1. ``active`` (y's shape, bool): where the
    ReLU passes, given instead of recomputed from u * a + b > 0."""
    dv, uhat = _dv_uhat(x, w, a, b, mean, inv, dy, transposed, stride,
                        padding, active)
    return dv.sum((0, 2, 3)), (dv * uhat).sum((0, 2, 3))


def conv_bn_bwd2_ref(x, w, a, b, mean, inv, s1n, s2n, dy, *,
                     transposed: bool, stride: int, padding: int,
                     active=None):
    """Plain version of K4-bwd2: du, then the library's adjoints
    (``active`` as in ``conv_bn_bwd1_ref``)."""
    dv, uhat = _dv_uhat(x, w, a, b, mean, inv, dy, transposed, stride,
                        padding, active)
    du = _vec(a) * (dv - _vec(s1n) - uhat * _vec(s2n))
    return _adjoints(x, w, du, transposed, stride, padding)


def conv_bn_stats(x, w, *, transposed: bool, stride: int, padding: int):
    """K4-stats: (sum of u, sum of u^2) per output channel, f32.

    On CPU tensors the plain version. On CUDA tensors one launch on the
    current stream (adds one to ``conv_bn_stats.launches``) writing per-block
    partial sums, summed here."""
    kw = dict(transposed=transposed, stride=stride, padding=padding)
    if not _device("conv_bn_stats", x):
        return conv_bn_stats_ref(x, w, **kw)
    k, s = _check("conv_bn_stats", x, w, transposed, stride, padding)
    from baryon_painter_tpu_torch.ops._build import load_library
    dims = _dims(x, w, transposed, k, s)
    rows = x.shape[0] * load_library().bpt_conv_bn_fwd_tiles(
        x.shape[2], x.shape[3], s)
    p1 = torch.empty((rows, dims[4]), dtype=torch.float32, device=x.device)
    p2 = torch.empty_like(p1)
    _launch("conv_bn_stats", "bpt_conv_bn_stats", _operand(x), _operand(w),
            p1, p2, *dims)
    conv_bn_stats.launches += 1
    return p1.sum(0), p2.sum(0)


conv_bn_stats.launches = 0


def conv_bn_fwd(x, w, a, b, *, transposed: bool, stride: int, padding: int):
    """K4-fwd: y = relu(u * a + b).

    On CPU tensors the plain version; on CUDA tensors one launch (adds one
    to ``conv_bn_fwd.launches``)."""
    if not _device("conv_bn_fwd", x):
        return conv_bn_fwd_ref(x, w, a, b, transposed=transposed,
                               stride=stride, padding=padding)
    k, s = _check("conv_bn_fwd", x, w, transposed, stride, padding,
                  {"a": a, "b": b})
    y = torch.empty(_out_shape(x, w, transposed, stride), dtype=x.dtype,
                    device=x.device)
    _launch("conv_bn_fwd", "bpt_conv_bn_fwd", _operand(x), _operand(w),
            _operand(a), _operand(b), y, *_dims(x, w, transposed, k, s))
    conv_bn_fwd.launches += 1
    return y


conv_bn_fwd.launches = 0


def conv_bn_bwd1(x, w, a, b, mean, inv, dy, *, transposed: bool,
                 stride: int, padding: int):
    """K4-bwd1: (S1, S2) = (sum of dv, sum of dv * uhat) per channel.

    On CPU tensors the plain version; on CUDA tensors one launch (adds one
    to ``conv_bn_bwd1.launches``) writing per-block partials, summed here."""
    if not _device("conv_bn_bwd1", x):
        return conv_bn_bwd1_ref(x, w, a, b, mean, inv, dy,
                                transposed=transposed, stride=stride,
                                padding=padding)
    vecs = {"a": a, "b": b, "mean": mean, "inv": inv}
    k, s = _check("conv_bn_bwd1", x, w, transposed, stride, padding, vecs, dy)
    from baryon_painter_tpu_torch.ops._build import load_library
    dims = _dims(x, w, transposed, k, s)
    rows = x.shape[0] * load_library().bpt_conv_bn_fwd_tiles(
        x.shape[2], x.shape[3], s)
    p1 = torch.empty((rows, dims[4]), dtype=torch.float32, device=x.device)
    p2 = torch.empty_like(p1)
    _launch("conv_bn_bwd1", "bpt_conv_bn_bwd1", _operand(x), _operand(w),
            *(_operand(t) for t in (a, b, mean, inv, dy)), p1, p2, *dims)
    conv_bn_bwd1.launches += 1
    return p1.sum(0), p2.sum(0)


conv_bn_bwd1.launches = 0


def conv_bn_bwd2(x, w, a, b, mean, inv, s1n, s2n, dy, *, transposed: bool,
                 stride: int, padding: int):
    """K4-bwd2: (dx, dW) from du = a (dv - s1n - uhat s2n), with s1n = S1/n
    and s2n = S2/n.

    On CPU tensors the plain version; on CUDA tensors one launch (adds one
    to ``conv_bn_bwd2.launches``) writing dx and per-block partial dW,
    summed here."""
    if not _device("conv_bn_bwd2", x):
        return conv_bn_bwd2_ref(x, w, a, b, mean, inv, s1n, s2n, dy,
                                transposed=transposed, stride=stride,
                                padding=padding)
    vecs = {"a": a, "b": b, "mean": mean, "inv": inv, "s1n": s1n,
            "s2n": s2n}
    k, s = _check("conv_bn_bwd2", x, w, transposed, stride, padding, vecs, dy)
    from baryon_painter_tpu_torch.ops._build import load_library
    lib = load_library()
    dims = _dims(x, w, transposed, k, s)
    smem = lib.bpt_conv_bn_bwd2_smem(dims[4], k, s)
    if not 0 < smem <= 232448:
        raise ValueError(f"conv_bn_bwd2: {dims[4]} output channels need "
                         f"{smem} bytes of shared memory a block, more than "
                         f"the 232448 an H100 block may use")
    rows = x.shape[0] * lib.bpt_conv_bn_bwd2_tiles(x.shape[2], x.shape[3],
                                                   k, s)
    dx = torch.empty_like(x, memory_format=torch.contiguous_format)
    dwp = torch.empty((rows,) + tuple(w.shape), dtype=torch.float32,
                      device=x.device)
    _launch("conv_bn_bwd2", "bpt_conv_bn_bwd2", _operand(x), _operand(w),
            *(_operand(t) for t in (a, b, mean, inv, s1n, s2n, dy)), dx, dwp,
            *dims)
    conv_bn_bwd2.launches += 1
    return dx, dwp.sum(0)


conv_bn_bwd2.launches = 0


def _count(x, w, transposed, stride):
    n, _, ho, wo = _out_shape(x, w, transposed, stride)
    return n * ho * wo


def conv_bn_relu_ref(x, w, gamma, beta, *, transposed: bool, stride: int,
                     padding: int, eps: float = EPS):
    """Plain PyTorch forward: (y, mean, var), the library's conv, the batch
    statistics in f32, the affine and the ReLU."""
    kw = dict(transposed=transposed, stride=stride, padding=padding)
    mean, var = batch_stats(*conv_bn_stats_ref(x, w, **kw),
                            _count(x, w, transposed, stride))
    _, a, b = bn_affine(gamma, beta, mean, var, eps)
    return conv_bn_fwd_ref(x, w, a, b, **kw), mean, var


def conv_bn_relu_bwd_ref(x, w, gamma, beta, mean, var, dy, *,
                         transposed: bool, stride: int, padding: int,
                         eps: float = EPS, active=None):
    """Plain PyTorch backward, the math of the JAX ``_bwd_xla`` on the
    logical convolution: (dx, dW, dgamma, dbeta) for the cotangent dy of y,
    given the forward's batch statistics (and, as ``active``, where its
    ReLU passed, else recomputed)."""
    kw = dict(transposed=transposed, stride=stride, padding=padding,
              active=active)
    inv, a, b = bn_affine(gamma, beta, mean, var, eps)
    s1, s2 = conv_bn_bwd1_ref(x, w, a, b, mean, inv, dy, **kw)
    n = _count(x, w, transposed, stride)
    dx, dw = conv_bn_bwd2_ref(x, w, a, b, mean, inv, s1 / n, s2 / n, dy,
                              **kw)
    return dx, dw, s2, s1


class _ConvBnRelu(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, gamma, beta, transposed, stride, padding, eps):
        kw = dict(transposed=transposed, stride=stride, padding=padding)
        count = _count(x, w, transposed, stride)
        mean, var = batch_stats(*conv_bn_stats(x, w, **kw), count)
        inv, a, b = bn_affine(gamma, beta, mean, var, eps)
        y = conv_bn_fwd(x, w, a, b, **kw)
        ctx.save_for_backward(x, w, a, b, mean, inv)
        ctx.kw, ctx.count = kw, count
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, w, a, b, mean, inv = ctx.saved_tensors
        dy = dy.contiguous()
        s1, s2 = conv_bn_bwd1(x, w, a, b, mean, inv, dy, **ctx.kw)
        dx, dw = conv_bn_bwd2(x, w, a, b, mean, inv, s1 / ctx.count,
                              s2 / ctx.count, dy, **ctx.kw)
        return dx, dw, s2, s1, None, None, None, None


def conv_bn_relu(x, w, gamma, beta, *, transposed: bool, stride: int,
                 padding: int, eps: float = EPS, bias=None):
    """Fused train-mode ``relu(batch_norm(conv(x, w)))``: (y, mean, var).

    x (N, Cin, H, W); w OIHW (conv) or IOHW (``transposed``); gamma, beta
    (Cout,). Differentiable in x, w, gamma and beta; mean and var carry no
    gradient. On CUDA tensors the forward is K4-stats then K4-fwd and the
    backward K4-bwd1 then K4-bwd2; on CPU tensors their plain versions. The
    triple it fuses has a bias-free conv: a ``bias`` raises."""
    if bias is not None:
        raise ValueError("conv_bn_relu: the conv must be bias-free (a bias "
                         "before a batch norm cancels)")
    return _ConvBnRelu.apply(x, w, gamma, beta, transposed, stride, padding,
                             eps)
