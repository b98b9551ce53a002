"""The shape rules that decide which train-mode (conv, batch norm, ReLU)
triples run through K4 (``ops/conv_bn.py``).

Copies of the three predicates of ``baryon_painter_tpu/ops/conv_rewrites.py``
(``transp_conv_rewrite_applicable``, ``s2d_rewrite_applicable``,
``s2d_rewrite_profitable``), which that module applies to pick the triples
its fused kernel takes. ``s2d_rewrite_profitable`` is a TPU tile heuristic
(128-wide matrix-unit padding); it is kept as it is so that the port fuses
exactly the sites the JAX package fuses. The rewrites themselves are not
copied: the port's kernels compute the logical convolution.
"""
from __future__ import annotations

__all__ = ["transp_conv_rewrite_applicable", "s2d_rewrite_applicable",
           "s2d_rewrite_profitable"]


def transp_conv_rewrite_applicable(k: int, s: int, p: int,
                                   output_padding: int) -> bool:
    """Every phase of ConvTranspose2d(k, s, p) takes its taps from coarse
    cells {-1, 0, 1}. Covers the DSL's (4, 2, 1) and (8, 4, 2)."""
    return (s > 1 and output_padding == 0 and 0 < k - p <= 2 * s
            and 0 <= p <= s)


def s2d_rewrite_applicable(k: int, s: int, p: int, h: int, w: int,
                           cin: int, r: int = 4) -> bool:
    """A stride-1 "same" conv with an odd kernel, spatial dims divisible by
    r, at least 32 r rows, few input channels, and every phase's taps within
    cells {-1, 0, 1}."""
    return (s == 1 and p == (k - 1) // 2 and k % 2 == 1
            and h % r == 0 and w % r == 0 and h >= 32 * r
            and cin * k * k <= 1024
            and k - p <= r + 1 and p <= r)


def s2d_rewrite_profitable(k: int, cin: int, cout: int, r: int = 4) -> bool:
    """128-wide tile-op counts per fine output pixel: direct =
    ceil(k^2 cin/128) * ceil(cout/128); space-to-depth = ceil(9 r^2 cin/128)
    * ceil(r^2 cout/128) / r^2; profitable below 0.75 of direct."""
    tiles = lambda n: -(-n // 128)
    direct = tiles(k * k * cin) * tiles(cout)
    s2d = tiles(9 * r * r * cin) * tiles(r * r * cout) / (r * r)
    return s2d < 0.75 * direct
