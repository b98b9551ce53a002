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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = ["fold_bn", "res_block_infer", "res_block_infer_ref"]

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# shared memory a block may use on Hopper (bytes)
_MAX_SMEM = 232448
# staged input (12x12) and intermediate (10x10) pixels per block, f32
_SMEM_PIXELS = 12 * 12 + 10 * 10


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


def _kernel_operand(t, dtype):
    """Contiguous, 16-byte aligned copy (or view) of t in dtype."""
    t = t.to(dtype).contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def res_block_infer(x, w1, scale1, bias1, w2, scale2, bias2,
                    inner_slope: float = 0.0, outer_slope: float = 0.0):
    """Fused inference residual block, one kernel launch on the card.

    x: (N, H, W, C) NHWC, float32 or bfloat16, contiguous; w1/w2: (3, 3, C, C)
    HWIO (cast to x's type); scale/bias: (C,) folded BN (see ``fold_bn``).
    On a CPU tensor this is ``res_block_infer_ref``. On a CUDA tensor it
    launches K1 on the current stream without synchronising and adds one to
    ``res_block_infer.launches``; anything the kernel does not take raises.
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
    if _SMEM_PIXELS * c * 4 > _MAX_SMEM:
        raise ValueError(f"res_block_infer: C={c} needs more shared memory "
                         f"than a block has")
    for name, t, shape in (("w1", w1, (3, 3, c, c)), ("w2", w2, (3, 3, c, c)),
                           ("scale1", scale1, (c,)), ("bias1", bias1, (c,)),
                           ("scale2", scale2, (c,)), ("bias2", bias2, (c,))):
        if tuple(t.shape) != shape:
            raise ValueError(f"res_block_infer: {name} must be {shape}, got "
                             f"{tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"res_block_infer: {name} is on {t.device}, "
                             f"x on {x.device}")
    w1k, w2k = (_kernel_operand(t, x.dtype) for t in (w1, w2))
    s1, b1, s2, b2 = (_kernel_operand(t, torch.float32)
                      for t in (scale1, bias1, scale2, bias2))
    out = torch.empty_like(x, memory_format=torch.contiguous_format)

    from baryon_painter_tpu_torch.ops._build import load_library
    lib = load_library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.bpt_res_block_infer(
            x.data_ptr(), w1k.data_ptr(), s1.data_ptr(), b1.data_ptr(),
            w2k.data_ptr(), s2.data_ptr(), b2.data_ptr(), out.data_ptr(),
            n, h, w, c, float(inner_slope), float(outer_slope),
            _DTYPE_CODES[x.dtype], stream)
    if err != 0:
        raise RuntimeError(f"res_block_infer: kernel launch failed: "
                           f"{lib.bpt_error_string(err).decode()} ({err})")
    res_block_infer.launches += 1
    return out


res_block_infer.launches = 0
