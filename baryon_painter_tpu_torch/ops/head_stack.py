"""K3, the decoder's fused output heads (forward and backward): the CUDA
kernels' wrappers, an autograd function over them, and their plain PyTorch
versions.

Port of ``baryon_painter_tpu/ops/pallas_head_stack.py`` (``head_stack`` with
its custom VJP, ``head_stack_xla``). The functions keep the JAX layout, x
NHWC and weights HWIO stacked over heads, so the tests compare like with
like. For each sample and head h, bias-free with "same" padding:

    u1 = conv(x, w1[h]);  a1 = prelu(u1, alphas[h, 0])
    u2 = conv(a1, w2[h]); a2 = prelu(u2, alphas[h, 1])
    y[:, h] = conv(a2, w3[h])

with prelu(u, a) = u if u >= 0 else a * u. The head's final softplus or
identity stays with the caller (``models/cvae.py``).

``head_stack`` is differentiable in all five inputs. On CUDA tensors its
forward runs K3-fwd and its backward K3-bwd (``csrc/head_stack.cu``); anything
the kernels do not take raises. K3-fwd is two CUDA launches: conv7 of both
heads as one GEMM on the tensor cores, which writes u1, the conv7
pre-activation of both heads as (N, H, W, 16) f32 with channel 8 h + c, once a
pixel; then the chain of small convs from u1 to y. When a gradient will be
taken the forward keeps u1, and K3-bwd reads it (PReLU1's mask and conv5's
input) instead of recomputing it; painting writes it into a scratch tensor that
is freed on return. K3-bwd is three CUDA launches: the chain's adjoint from u1
and dy, which writes du1 once a pixel into a scratch tensor in x's dtype, then
dx and dw1 as GEMMs from it. ``head_stack`` keeps u1 only under autograd with
an input that requires a gradient, so painting (``torch.inference_mode``) keeps
none. On CPU tensors the functions are the plain versions, ``head_stack_ref``
and ``head_stack_bwd_ref``, which are also the tests' oracles and
``chip_smoke.py``'s comparison. Each wrapper counts its calls (``.launches``)
and, in ``.cuda_launches``, every CUDA launch it makes, by the library's entry
point.

x and dy are float32 or bfloat16 (the JAX package's kernels run in the input
dtype); the weights, the slopes and the kept u1 stay f32, and so do the
weight and slope gradients. In bf16 the functions round where the JAX
kernels round (``pallas_head_stack.py`` ``_chain_fwd``, ``_bwd_kernel``):
every convolution's inputs (x, the weights, v1, v2, dy, du2, du1) are cast to
bf16 and their products summed in f32 (the products of two bf16 values are
exact in f32), PReLU and its masks and slope gradients are f32, y is
returned in bf16, and dx is each head's input gradient cast to bf16 and
summed over the heads in bf16. u1 is kept in f32 in bf16 too: the JAX
backward recomputes it in f32, and a bf16 u1 would move PReLU1's mask and
dalpha1.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.nn.grad import conv2d_input, conv2d_weight

__all__ = ["head_stack", "head_stack_fwd", "head_stack_bwd", "rounder",
           "head_stack_ref", "head_stack_bwd_ref", "gemm_weights"]

# the dtypes of x, y, dy and dx the kernels take, and their codes
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# the shapes the kernels are written for: the fiducial heads
_KERNEL_SHAPES = {"w1": (2, 7, 7, 16, 8), "w2": (2, 5, 5, 8, 1),
                  "w3": (2, 3, 3, 1, 1), "alphas": (2, 2)}


def _prelu(u, a):
    return torch.where(u >= 0, u, a * u)


def _oihw(w):
    """HWIO -> OIHW."""
    return w.permute(3, 2, 0, 1)


_LOW = (torch.bfloat16, torch.float16)


def rounder(dtype):
    """v -> v rounded to ``dtype`` and held in f32 where ``dtype`` is a
    16-bit float; the identity otherwise (f32, or f64 in the tests)."""
    if dtype not in _LOW:
        return lambda v: v
    return lambda v: v.to(dtype).float()


def _compute_dtype(dtype):
    """The dtype the plain versions sum in: f32 for 16-bit inputs."""
    return torch.float32 if dtype in _LOW else dtype


def _chain(xc, w1, w2, a1, a2, u1=None, r=rounder(torch.float32)):
    """One head's u1, act1, u2, act2 in NCHW, f32, each conv's inputs
    rounded by ``r``; u1 computed unless given."""
    if u1 is None:
        u1 = F.conv2d(xc, _oihw(r(w1)), padding=w1.shape[0] // 2)
    v1 = _prelu(u1, a1)
    u2 = F.conv2d(r(v1), _oihw(r(w2)), padding=w2.shape[0] // 2)
    return u1, v1, u2, _prelu(u2, a2)


def head_stack_ref(x, w1, w2, w3, alphas, keep_u1: bool = False):
    """Plain PyTorch version of K3's forward: x (N, H, W, Cin) ->
    (N, n_heads, H, W) in x's dtype, a chain of ``F.conv2d`` per head in
    f32 on inputs rounded to x's dtype. With ``keep_u1`` returns (y, u1):
    u1 (N, H, W, n_heads * C1) f32 the heads' conv7 pre-activations,
    channel C1 * h + c, in K3-fwd's layout."""
    r = rounder(x.dtype)
    xc = x.permute(0, 3, 1, 2).to(_compute_dtype(x.dtype))
    out, u1s = [], []
    for h in range(w1.shape[0]):
        u1, _, _, v2 = _chain(xc, w1[h], w2[h], alphas[h, 0], alphas[h, 1],
                              r=r)
        u1s.append(u1)
        out.append(F.conv2d(r(v2), _oihw(r(w3[h])),
                            padding=w3.shape[1] // 2)[:, 0])
    y = torch.stack(out, dim=1).to(x.dtype)
    if not keep_u1:
        return y
    return y, torch.cat(u1s, dim=1).permute(0, 2, 3, 1).contiguous()


def head_stack_bwd_ref(x, w1, w2, w3, alphas, dy, u1=None):
    """Plain PyTorch version of K3's backward, written out as K3-bwd
    computes it: the chain from u1 (given, as ``head_stack_ref(...,
    keep_u1=True)`` returns it, or recomputed when None), then per head the
    input and weight gradients of conv3, prelu2, conv5, prelu1 and conv7, dx
    summed over the heads. PReLU1's mask and conv5's input come from that
    u1. Returns (dx, dw1, dw2, dw3, dalphas) in the inputs' shapes, dx in
    x's dtype, the rest f32; in bf16 with the rounding points of the module
    docstring."""
    r = rounder(x.dtype)
    xc = x.permute(0, 3, 1, 2).to(_compute_dtype(x.dtype))
    dy = r(dy.to(xc.dtype))
    dx = torch.zeros_like(xc)
    dws = ([], [], [])
    dal = []
    c1 = w1.shape[-1]
    for h in range(w1.shape[0]):
        k1, k2, k3 = (w[h] for w in (w1, w2, w3))
        al1, al2 = alphas[h, 0], alphas[h, 1]
        kept = (None if u1 is None
                else u1[..., c1 * h:c1 * (h + 1)].permute(0, 3, 1, 2))
        u1h, v1, u2, v2 = _chain(xc, k1, k2, al1, al2, kept, r=r)
        g = dy[:, h:h + 1]
        k1, k2, k3 = r(k1), r(k2), r(k3)
        p1, p2, p3 = k1.shape[0] // 2, k2.shape[0] // 2, k3.shape[0] // 2
        dw3 = conv2d_weight(r(v2), _oihw(k3).shape, g, padding=p3)
        dv2 = conv2d_input(v2.shape, _oihw(k3), g, padding=p3)
        du2 = torch.where(u2 >= 0, dv2, al2 * dv2)
        dal2 = torch.where(u2 < 0, dv2 * u2, 0.0).sum()
        dw2 = conv2d_weight(r(v1), _oihw(k2).shape, r(du2), padding=p2)
        dv1 = conv2d_input(v1.shape, _oihw(k2), r(du2), padding=p2)
        du1 = torch.where(u1h >= 0, dv1, al1 * dv1)
        dal1 = torch.where(u1h < 0, dv1 * u1h, 0.0).sum()
        dw1 = conv2d_weight(xc, _oihw(k1).shape, r(du1), padding=p1)
        # each head's dx in x's dtype, summed over the heads in it
        dx = r(dx + r(conv2d_input(xc.shape, _oihw(k1), r(du1),
                                   padding=p1)))
        for lst, dw in zip(dws, (dw1, dw2, dw3)):
            lst.append(dw.permute(2, 3, 1, 0))                 # OIHW -> HWIO
        dal.append(torch.stack([dal1, dal2]))
    return (dx.permute(0, 2, 3, 1).to(x.dtype),
            *(torch.stack(d) for d in dws), torch.stack(dal))


def _check_operands(fn, x, w1, w2, w3, alphas, dy=None, u1=None):
    """Raise on anything the kernels do not take: x (and dy, in x's dtype)
    float32 or bfloat16; the weights, slopes and u1 float32."""
    tensors = {"x": x, "w1": w1, "w2": w2, "w3": w3, "alphas": alphas}
    for name, t in (("dy", dy), ("u1", u1)):
        if t is not None:
            tensors[name] = t
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"{fn}: x must be float32 or bfloat16, got "
                        f"{x.dtype}")
    for name, t in tensors.items():
        want = x.dtype if name in ("x", "dy") else torch.float32
        if t.dtype != want:
            raise TypeError(f"{fn}: {name} must be {want}, got {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{fn}: {name} is on {t.device}, x on "
                             f"{x.device}")
    if x.ndim != 4 or x.shape[-1] != 16:
        raise ValueError(f"{fn}: x must be (N, H, W, 16), got "
                         f"{tuple(x.shape)}")
    for name, shape in _KERNEL_SHAPES.items():
        if tuple(tensors[name].shape) != shape:
            raise ValueError(f"{fn}: {name} must be {shape}, got "
                             f"{tuple(tensors[name].shape)}")
    n, h, w, _ = x.shape
    for name, shape in (("dy", (n, 2, h, w)), ("u1", (n, h, w, 16))):
        if name in tensors and tuple(tensors[name].shape) != shape:
            raise ValueError(f"{fn}: {name} must be {shape}, got "
                             f"{tuple(tensors[name].shape)}")


def _operand(t):
    """Contiguous, 16-byte aligned copy (or view) of t."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _launch(fn, name, *args):
    from baryon_painter_tpu_torch.ops._build import load_library
    lib = load_library()
    device = args[0].device
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        ptrs = [a.data_ptr() if isinstance(a, torch.Tensor) else a
                for a in args]
        err = getattr(lib, name)(*ptrs, stream)
    if err != 0:
        raise RuntimeError(f"{fn}: kernel launch failed: "
                           f"{lib.bpt_error_string(err).decode()} ({err})")


def _launch_pass(wrapper, name, *args):
    """``_launch`` of one of K3's passes, the library's entry point ``name``:
    adds one to ``wrapper.cuda_launches[name]`` once it has launched."""
    _launch(wrapper.__name__, name, *args)
    wrapper.cuda_launches[name] += 1


def gemm_weights(w1, dtype=torch.float32):
    """The B operands of K3's 7x7 GEMMs from w1 (2, 7, 7, 16, 8) in the
    kernels' layouts, (parts, 16, Kp) in ``dtype``: K3-fwd's u1 GEMM wu =
    [h, c][ky, kx, ci], K = 784 zero-padded to whole 128-byte rows (32 f32
    or 64 bf16 values), and K3-bwd's dx GEMM wdx = [ci][h][ky, kx, c] with
    each head's 392 zero-padded to whole rows. f32 has two parts, big = w
    with its 13 low mantissa bits cleared and small = w - big (3xTF32);
    bf16 one, the rounded weights."""
    return _wu(w1, dtype), _wdx(w1, dtype)


def _row(dtype):
    """Values of a 128-byte row of K."""
    return 32 if dtype == torch.float32 else 64


def _parts(w, dtype):
    if dtype != torch.float32:
        return w.to(dtype)[None].contiguous()
    w = w.float().contiguous()
    big = (w.view(torch.int32) & -8192).view(torch.float32)  # 0xffffe000
    return torch.stack([big, w - big]).contiguous()


def _wu(w1, dtype):
    wu = w1.permute(0, 4, 1, 2, 3).reshape(16, 784)
    return _parts(F.pad(wu, (0, -784 % _row(dtype))), dtype)


def _wdx(w1, dtype):
    wdx = w1.permute(3, 0, 1, 2, 4).reshape(16, 2, 392)
    return _parts(F.pad(wdx, (0, -392 % _row(dtype))).reshape(16, -1), dtype)


def head_stack_fwd(x, w1, w2, w3, alphas, keep_u1: bool = False):
    """K3-fwd: (N, 2, H, W) head outputs; with ``keep_u1`` (y, u1), u1
    (N, H, W, 16) as ``head_stack_ref`` returns it, for ``head_stack_bwd``.

    On CPU tensors this is ``head_stack_ref``. On CUDA tensors it launches
    the u1 GEMM and the chain on the current stream without synchronising
    (one each to ``head_stack_fwd.cuda_launches``) and adds one to
    ``head_stack_fwd.launches`` (and in bf16 to ``.bf16_launches``), and
    with ``keep_u1`` one to ``head_stack_fwd.kept_u1``; without it u1 goes
    into a scratch tensor, so y is the same either way. Anything the
    kernels do not take (another dtype, channel count or number of heads)
    raises. y is in x's dtype, u1 f32."""
    if x.device.type == "cpu":
        return head_stack_ref(x, w1, w2, w3, alphas, keep_u1=keep_u1)
    if x.device.type != "cuda":
        raise ValueError(f"head_stack_fwd: unsupported device {x.device}")
    _check_operands("head_stack_fwd", x, w1, w2, w3, alphas)
    n, h, w, _ = x.shape
    r = rounder(x.dtype)
    code = _DTYPE_CODES[x.dtype]
    y = torch.empty((n, 2, h, w), dtype=x.dtype, device=x.device)
    u1 = torch.empty((n, h, w, 16), dtype=torch.float32, device=x.device)
    _launch_pass(head_stack_fwd, "bpt_head_u1_gemm", _operand(x),
                 _wu(w1, x.dtype), u1, n, h, w, code)
    _launch_pass(head_stack_fwd, "bpt_head_chain_fwd", u1,
                 *(_operand(t) for t in (r(w2), r(w3), alphas)), y, n, h, w,
                 code)
    head_stack_fwd.launches += 1
    head_stack_fwd.bf16_launches += x.dtype == torch.bfloat16
    if not keep_u1:
        return y
    head_stack_fwd.kept_u1 += 1
    return y, u1


head_stack_fwd.launches = 0
head_stack_fwd.bf16_launches = 0
head_stack_fwd.kept_u1 = 0
head_stack_fwd.cuda_launches = dict.fromkeys(("bpt_head_u1_gemm",
                                              "bpt_head_chain_fwd"), 0)


def head_stack_bwd(x, w1, w2, w3, alphas, dy, u1=None):
    """K3-bwd: (dx, dw1, dw2, dw3, dalphas) from u1 as
    ``head_stack_fwd(..., keep_u1=True)`` kept it.

    The kernels write dx and partial sums of the weight and slope
    gradients (the chain's per block, dw1's per split of the pixels),
    summed here (deterministic: no atomics). On CPU tensors this is
    ``head_stack_bwd_ref``, which recomputes u1 when none is given. On CUDA
    tensors u1 is required; the chain, dx and dw1 launch on the current stream
    without synchronising (one each to ``head_stack_bwd.cuda_launches``) and
    the call adds one to ``head_stack_bwd.launches`` (and in bf16 to
    ``.bf16_launches``); anything the kernels do not take raises. dy is cast to
    x's dtype, as the JAX package casts it; dx comes back in x's dtype, the
    weight and slope gradients in f32."""
    dy = dy.to(x.dtype)
    if x.device.type == "cpu":
        return head_stack_bwd_ref(x, w1, w2, w3, alphas, dy, u1=u1)
    if x.device.type != "cuda":
        raise ValueError(f"head_stack_bwd: unsupported device {x.device}")
    if u1 is None:
        raise ValueError("head_stack_bwd: u1 is required on the card (K3-bwd "
                         "reads the u1 that head_stack_fwd(..., "
                         "keep_u1=True) keeps)")
    _check_operands("head_stack_bwd", x, w1, w2, w3, alphas, dy, u1)
    n, h, w, _ = x.shape
    r = rounder(x.dtype)
    code = _DTYPE_CODES[x.dtype]
    from baryon_painter_tpu_torch.ops._build import load_library
    lib = load_library()
    blocks = lib.bpt_head_grid(2, n, h, w, code)
    splits = lib.bpt_head_grid(4, n, h, w, code)
    if blocks < 1 or splits < 1:
        raise ValueError(f"head_stack_bwd: the kernels do not take x of "
                         f"shape {tuple(x.shape)}")
    dev = dict(dtype=torch.float32, device=x.device)
    xo = _operand(x)
    du1 = torch.empty_like(xo)
    dw2p = torch.empty((blocks,) + tuple(w2.shape), **dev)
    dw3p = torch.empty((blocks,) + tuple(w3.shape), **dev)
    dalp = torch.empty((blocks,) + tuple(alphas.shape), **dev)
    _launch_pass(head_stack_bwd, "bpt_head_chain_bwd", _operand(u1),
                 _operand(dy), *(_operand(t) for t in (r(w2), r(w3), alphas)),
                 du1, dw2p, dw3p, dalp, n, h, w, blocks, code)
    dx = torch.empty_like(xo)
    _launch_pass(head_stack_bwd, "bpt_head_dx", du1, _wdx(w1, x.dtype), dx,
                 n, h, w, code)
    dw1p = torch.empty((splits,) + tuple(w1.shape), **dev)
    _launch_pass(head_stack_bwd, "bpt_head_dw1", xo, du1, dw1p, n, h, w,
                 splits, code)
    head_stack_bwd.launches += 1
    head_stack_bwd.bf16_launches += x.dtype == torch.bfloat16
    return dx, dw1p.sum(0), dw2p.sum(0), dw3p.sum(0), dalp.sum(0)


head_stack_bwd.launches = 0
head_stack_bwd.bf16_launches = 0
head_stack_bwd.cuda_launches = dict.fromkeys(("bpt_head_chain_bwd",
                                              "bpt_head_dx", "bpt_head_dw1"),
                                             0)


class _HeadStack(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w1, w2, w3, alphas, keep_u1):
        if not keep_u1:
            return head_stack_fwd(x, w1, w2, w3, alphas)
        y, u1 = head_stack_fwd(x, w1, w2, w3, alphas, keep_u1=True)
        ctx.save_for_backward(x, w1, w2, w3, alphas, u1)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w1, w2, w3, alphas, u1 = ctx.saved_tensors
        return (*head_stack_bwd(x, w1, w2, w3, alphas, dy.contiguous(),
                                u1=u1), None)


def head_stack(x, w1, w2, w3, alphas):
    """Fused train-mode head stack, differentiable in every input.

    x: (N, H, W, Cin) NHWC; w1: (n_heads, 7, 7, Cin, C1), w2: (n_heads, 5,
    5, C1, 1), w3: (n_heads, 3, 3, 1, 1) HWIO; alphas: (n_heads, 2) PReLU
    slopes. Returns (N, n_heads, H, W): each head's last conv output,
    before its final activation. Forward K3-fwd, backward K3-bwd on the
    card; the plain versions on the CPU. u1 is kept for the backward only
    where one can follow: gradients enabled and an input requiring one."""
    keep_u1 = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, w1, w2, w3, alphas))
    return _HeadStack.apply(x, w1, w2, w3, alphas, keep_u1)
