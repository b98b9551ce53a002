"""K1, the fused inference residual block: its CUDA kernel's wrapper and its
plain PyTorch version.

Port of ``baryon_painter_tpu/ops/pallas_conv.py`` (``fold_bn``,
``res_block_infer``, ``res_block_infer_xla``). Both functions keep the JAX
signature, x NHWC and w HWIO, so the tests compare like with like:

    act_o(x + s2 * conv3x3(round_x(act_i(s1 * conv3x3(x) + b1))) + b2)

``res_block_infer`` launches the hand-written kernel
(``csrc/res_block.cu``) on a CUDA tensor and raises if it cannot; on a CPU
tensor it computes the plain version. ``res_block_infer_ref`` is the plain
version: the CPU path, the tests' oracle and ``chip_smoke.py``'s yardstick.
``res_block_operands`` makes the kernel's operands (the weights in its
layout, the folded BN in f32) once, for a caller that launches the block
many times with the same weights (``models/layers.FusedResBlock``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

__all__ = ["K1Operands", "fold_bn", "kernel_channels", "res_block_infer",
           "res_block_infer_ref", "res_block_operands", "split_tf32"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# output channels a block computes: all of them (conv2 needs all of h)
_MAX_C = 128
# TMA reads rows whose byte stride is a multiple of 16: channels a multiple
# of 4 in f32, of 8 in bf16 (a bf16 x with C % 8 == 4 is padded by 4)
_CHANNEL_MULTIPLE = {torch.float32: 4, torch.bfloat16: 8}
# the 13 low mantissa bits of an f32, which TF32 drops
_TF32_MASK = -8192      # 0xffffe000 as an int32


def fold_bn(scale, bias, mean, var, eps: float = 1e-5):
    """Fold eval-mode batch norm into a per-channel (scale', bias')."""
    s = scale / torch.sqrt(var + eps)
    return s, bias - mean * s


def _leaky(h, slope: float):
    """(Leaky) ReLU; slope 0.0 is plain ReLU."""
    if slope == 0.0:
        return torch.clamp(h, min=0.0)
    return torch.where(h >= 0, h, slope * h)


def res_block_infer_ref(x, w1, scale1, bias1, w2, scale2, bias2,
                        inner_slope: float = 0.0, outer_slope: float = 0.0):
    """Plain PyTorch version of K1 (x NHWC, w HWIO, folded BN (C,)).

    Convolutions run in f32 on the values rounded to x's type (the products
    of two bfloat16 numbers are exact in f32, so this is an f32-accumulated
    conv in x's type); the intermediate is rounded to x's type, the output
    is in x's type."""
    dt = x.dtype

    def conv(v, w):
        w = w.to(dt).float().permute(3, 2, 0, 1)           # HWIO -> OIHW
        out = F.conv2d(v.float().permute(0, 3, 1, 2), w, padding=1)
        return out.permute(0, 2, 3, 1)                      # -> NHWC

    f32 = lambda t: t.float()
    h = _leaky(conv(x, w1) * f32(scale1) + f32(bias1), inner_slope)
    h = conv(h.to(dt), w2) * f32(scale2) + f32(bias2)
    return _leaky(h + x.float(), outer_slope).to(dt)


def split_tf32(v):
    """The 3xTF32 split of f32 values: big = v with its 13 low mantissa
    bits cleared (a tf32 value) and small = v - big (exact in f32)."""
    big = (v.contiguous().view(torch.int32) & _TF32_MASK).view(torch.float32)
    return big, v - big


def kernel_channels(c: int, dtype) -> int:
    """The channels the kernel runs for C channels of ``dtype``: C, or C + 4
    for a bf16 C with C % 8 == 4 (zero channels, cropped from the output)."""
    m = _CHANNEL_MULTIPLE[dtype]
    return -(-c // m) * m


class K1Operands(NamedTuple):
    """K1's operands in the kernel's layout, for ``channels`` channels.

    weights: (2 P, channels, 9, channels) in the block's type, w^T (output
    channel, tap 3 ky + kx, input channel) of conv1 then conv2; in f32 P = 2,
    each conv's big then small half (``split_tf32``), in bf16 P = 1. scale1,
    bias1, scale2, bias2: (channels,) f32. Channels past the block's C are
    zero."""
    weights: torch.Tensor
    scale1: torch.Tensor
    bias1: torch.Tensor
    scale2: torch.Tensor
    bias2: torch.Tensor
    channels: int


def res_block_operands(w1, scale1, bias1, w2, scale2, bias2,
                       dtype) -> K1Operands:
    """The kernel's operands for HWIO weights and the folded BN, for x of
    ``dtype`` (float32 or bfloat16): the weights rounded to ``dtype``,
    transposed to (co, tap, ci), zero-padded to ``kernel_channels`` and, in
    f32, split into big and small halves. Plain PyTorch on the weights'
    device; a caller with fixed weights makes them once."""
    if dtype not in _DTYPE_CODES:
        raise TypeError(f"res_block_operands: dtype must be float32 or "
                        f"bfloat16, got {dtype}")
    c = w1.shape[2]
    cp = kernel_channels(c, dtype)
    # HWIO -> (C_out, 3, 3, C_in) -> (C_out, 9, C_in), both C padded to cp
    wt = [F.pad(w.to(dtype).permute(3, 0, 1, 2).reshape(c, 9, c),
                (0, cp - c, 0, 0, 0, cp - c)) for w in (w1, w2)]
    if dtype == torch.float32:
        wt = [half for w in wt for half in split_tf32(w)]
    s1, b1, s2, b2 = (F.pad(t.to(torch.float32), (0, cp - c))
                      for t in (scale1, bias1, scale2, bias2))
    return K1Operands(torch.stack(wt), s1, b1, s2, b2, cp)


def res_block_infer(x, w1, scale1, bias1, w2, scale2, bias2,
                    inner_slope: float = 0.0, outer_slope: float = 0.0,
                    operands: K1Operands | None = None):
    """Fused inference residual block, one kernel launch on the card.

    x: (N, H, W, C) NHWC, float32 or bfloat16, contiguous; w1/w2: (3, 3, C, C)
    HWIO (cast to x's type); scale/bias: (C,) folded BN (see ``fold_bn``).
    ``operands``: the same weights and BN already in the kernel's layout
    (``res_block_operands`` for x's type), which a CUDA launch then reads in
    place of w1..bias2 (those may then be None there); None makes them for
    this call. The plain version on the CPU reads w1..bias2 and ignores
    them.
    On a CPU tensor this is ``res_block_infer_ref``. On a CUDA tensor it
    launches K1 on the current stream without synchronising and adds one to
    ``res_block_infer.launches`` (and in bf16 to ``.bf16_launches``);
    anything the kernel does not take (C not a multiple of 4 or above 128,
    another dtype, layout or device) raises.
    """
    if x.device.type == "cpu":
        return res_block_infer_ref(x, w1, scale1, bias1, w2, scale2, bias2,
                                   inner_slope, outer_slope)
    if x.device.type != "cuda":
        raise ValueError(f"res_block_infer: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"res_block_infer: x must be float32 or bfloat16, "
                        f"got {x.dtype}")
    if x.ndim != 4:
        raise ValueError(f"res_block_infer: x must be (N, H, W, C), got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("res_block_infer: x must be contiguous NHWC")
    if x.data_ptr() % 16:
        raise ValueError("res_block_infer: x must be 16-byte aligned")
    n, h, w, c = x.shape
    if c % 4:
        raise ValueError(f"res_block_infer: C={c} must be a multiple of 4")
    if c > _MAX_C:
        raise ValueError(f"res_block_infer: C={c} is more than the "
                         f"{_MAX_C} channels a block computes")
    cp = kernel_channels(c, x.dtype)
    if operands is None:
        for name, t, shape in (("w1", w1, (3, 3, c, c)),
                               ("w2", w2, (3, 3, c, c)),
                               ("scale1", scale1, (c,)),
                               ("bias1", bias1, (c,)),
                               ("scale2", scale2, (c,)),
                               ("bias2", bias2, (c,))):
            if tuple(t.shape) != shape:
                raise ValueError(f"res_block_infer: {name} must be {shape}, "
                                 f"got {tuple(t.shape)}")
            if t.device != x.device:
                raise ValueError(f"res_block_infer: {name} is on {t.device},"
                                 f" x on {x.device}")
        operands = res_block_operands(w1, scale1, bias1, w2, scale2, bias2,
                                      x.dtype)
    parts = 2 if x.dtype == torch.float32 else 1
    want = (2 * parts, cp, 9, cp)
    if (operands.channels != cp or tuple(operands.weights.shape) != want
            or operands.weights.dtype != x.dtype
            or operands.weights.device != x.device
            or not operands.weights.is_contiguous()):
        raise ValueError(f"res_block_infer: operands must be "
                         f"res_block_operands(..., {x.dtype}) on {x.device}: "
                         f"weights {want}, got "
                         f"{tuple(operands.weights.shape)} "
                         f"{operands.weights.dtype} on "
                         f"{operands.weights.device}")
    # x with the kernel's channels (TMA's 16-byte rows); cropped after
    xk = x if cp == c else F.pad(x, (0, cp - c)).contiguous()
    out = torch.empty_like(xk, memory_format=torch.contiguous_format)

    from baryon_painter_tpu_torch.ops._build import load_library
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bpt_res_block_infer(
            xk.data_ptr(), operands.weights.data_ptr(),
            operands.scale1.data_ptr(), operands.bias1.data_ptr(),
            operands.scale2.data_ptr(), operands.bias2.data_ptr(),
            out.data_ptr(), n, h, w, cp, float(inner_slope),
            float(outer_slope), _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"res_block_infer: kernel launch failed: "
                           f"{lib.bpt_error_string(err).decode()} ({err})")
    res_block_infer.launches += 1
    res_block_infer.bf16_launches += x.dtype == torch.bfloat16
    return out if cp == c else out[..., :c].contiguous()


res_block_infer.launches = 0
res_block_infer.bf16_launches = 0
