"""Shapes and direct-convolution operation counts of a layer list.

``walk(spec, c, h, w)`` follows a layer list (the configuration file's
JSON form) from an input of c channels and h x w pixels and returns one
record a convolution (``kind`` ``conv`` or ``transp``: in and out
channels, kernel, stride, input and output size) and one a residual block
(``kind`` ``res_block``: channels and size, and its inner convolutions
under ``convs``), with the output's (c, h, w). ``conv_flops`` counts what
a direct convolution computes, two operations a multiply-add: 2 C_in C_out
k^2 H_out W_out for a convolution, 2 C_in C_out k^2 H_in W_in for a
transposed one (each input pixel meets k^2 taps), nothing for batch
norms and activations.
"""
from __future__ import annotations

__all__ = ["walk", "conv_flops", "convs"]


def walk(spec, c: int, h: int, w: int):
    out = []
    for layer in spec or ():
        kind = str(layer[0]).lower()
        cfg = layer[1] if len(layer) > 1 else None
        if kind in ("conv", "transp conv"):
            k, s = cfg["kernel_size"], cfg.get("stride", 1)
            pad = cfg.get("padding", 0)
            if cfg["in_channels"] != c:
                raise ValueError(f"{layer}: input has {c} channels")
            if kind == "conv":
                ho, wo = (h + 2 * pad - k) // s + 1, (w + 2 * pad - k) // s + 1
            else:
                op = cfg.get("output_padding", 0)
                ho, wo = ((h - 1) * s - 2 * pad + k + op,
                          (w - 1) * s - 2 * pad + k + op)
            out.append({"kind": "conv" if kind == "conv" else "transp",
                        "cin": c, "cout": cfg["out_channels"], "k": k,
                        "s": s, "h": h, "w": w, "ho": ho, "wo": wo})
            c, h, w = cfg["out_channels"], ho, wo
        elif kind == "residual block":
            inner, (c2, h2, w2) = walk(cfg[0], c, h, w)
            if (c2, h2, w2) != (c, h, w):
                raise ValueError("a residual block changes its input's shape")
            out.append({"kind": "res_block", "c": c, "h": h, "w": w,
                        "convs": inner})
        elif kind == "upsample nearest":
            h, w = h * cfg["scale"], w * cfg["scale"]
        elif kind in ("linear", "flatten"):
            raise NotImplementedError(f"layer {layer[0]}")
    return out, (c, h, w)


def convs(records) -> list:
    """Every convolution of ``walk``'s records, residual blocks' included."""
    out = []
    for r in records:
        out += convs(r["convs"]) if r["kind"] == "res_block" else [r]
    return out


def conv_flops(records) -> float:
    total = 0.0
    for r in convs(records):
        taps = r["cin"] * r["cout"] * r["k"] * r["k"]
        pixels = r["ho"] * r["wo"] if r["kind"] == "conv" else r["h"] * r["w"]
        total += 2.0 * taps * pixels
    return total
