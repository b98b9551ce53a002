"""The tensor cores' products as the port's kernels use them, emulated in
numpy for the CPU tests of their GEMM designs (csrc/res_block.cu,
csrc/head_stack.cu, csrc/conv_bn.cu).

mma.sync and wgmma with f32 accumulation add each k-step's products into
the accumulator and round the sum toward zero (they truncate), and read a tf32
operand's top 19 bits. In 3xTF32 each f32 operand v is split into big = v
with its 13 low mantissa bits cleared and small = v - big, which enters the
product truncated to tf32 (``split_tf32`` in csrc/ptx.cuh); small*big +
big*small + big*big accumulate. In bf16 the operands are bf16 values and
their products are exact. The kernels sum each K chunk from zero on the
tensor cores and add the chunk's sum into an f32 sum with an ordinary,
rounding add.
"""
import numpy as np


def tf32(v) -> np.ndarray:
    """Round f32 to TF32 (10 mantissa bits), to nearest, ties away from 0,
    as cvt.rna.tf32.f32 does (finite inputs)."""
    b = np.asarray(v, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def tf32_trunc(v) -> np.ndarray:
    """f32 with its 13 low mantissa bits cleared: a tf32 value, rounded
    toward zero."""
    b = np.asarray(v, np.float32).view(np.uint32)
    return (b & np.uint32(0xFFFFE000)).view(np.float32)


def _toward_zero(v: np.ndarray) -> np.ndarray:
    """f64 -> f32, rounded toward zero."""
    f = v.astype(np.float32)
    over = np.abs(f.astype(np.float64)) > np.abs(v)
    f[over] = np.nextafter(f[over], np.float32(0))
    return f


def mma_gemm(a, b, *, kstep: int, chunk: int, mode: str = "3xtf32"):
    """a (M, K) @ b (K, N) in f32 as the kernels compute it: K in chunks of
    ``chunk``, each summed from zero in k-steps of ``kstep`` whose products
    are added into the accumulator and truncated, the chunks' sums added in
    f32. ``mode``: "3xtf32" (the three products of the kernels' split),
    "tf32" (one pass on the operands rounded to tf32) or "bf16" (operands
    already bf16 values, exact products). K is zero-padded to a multiple
    of ``kstep``."""
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    pad = -a.shape[1] % kstep
    a = np.pad(a, ((0, 0), (0, pad)))
    b = np.pad(b, ((0, pad), (0, 0)))
    if mode == "3xtf32":
        ah, bh = tf32_trunc(a), tf32_trunc(b)
        pairs = ((tf32_trunc(a - ah), bh), (ah, tf32_trunc(b - bh)),
                 (ah, bh))
    elif mode == "tf32":
        pairs = ((tf32(a), tf32(b)),)
    elif mode == "bf16":
        pairs = ((a, b),)
    else:
        raise ValueError(mode)
    pairs = [(x.astype(np.float64), y.astype(np.float64)) for x, y in pairs]
    out = np.zeros((a.shape[0], b.shape[1]), np.float32)
    for c0 in range(0, a.shape[1], chunk):
        acc = np.zeros_like(out)
        for k0 in range(c0, min(c0 + chunk, a.shape[1]), kstep):
            for x, y in pairs:
                acc = _toward_zero(acc.astype(np.float64)
                                   + x[:, k0:k0 + kstep] @ y[k0:k0 + kstep])
        out = out + acc
    return out


def exact_gemm(a, b):
    """a @ b in f64: the index rules alone."""
    return np.asarray(a, np.float64) @ np.asarray(b, np.float64)
