"""Plain PyTorch reference of the painters' networks, written from the
layer specs alone.

A network is a list of layer specs (the JSON form of the configuration
file: ``["conv", {...}]``, ``["batchnorm", {...}]``, ``["ReLU"]``,
``["residual block", [inner, activation]]``, ...). ``apply`` runs one on a
flat parameter dict whose names are the module paths a PyTorch model of the
spec carries (``q_x_in.layers.Conv2d_0.weight``, ``p_y_z_in.layers.
ResidualBlock_0.SpecSequential_0.layers.BatchNorm_1.running_var``): each
class of layer is numbered in order within its list, as flax numbers it.
Convolutions are ``F.conv2d`` / ``F.conv_transpose2d`` on the whole batch,
batch norm is written out, nothing is fused, folded or cached.

``Numerics`` says in which precision the convolutions' operands are taken:
``"f32"`` as they are (the caller turns TF32 off), ``"tf32"`` rounded to
TF32 (10 mantissa bits, nearest even: what a tensor core's TF32 path reads,
accumulating in f32), ``"fp8"`` rounded to float8 e4m3 after a per-tensor
scale that maps the largest magnitude to 448, and ``"f64"`` in float64.
The lower two are the controls the benchmark's comparison must refuse.
"""
from __future__ import annotations

import math
import re

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["Numerics", "apply", "param_specs", "flax_to_flat",
           "fold_spectral_norm", "BN_EPS"]

BN_EPS = 1e-5
_FP8_MAX = 448.0
_SN_EPS = 1e-12


class _Rounded(torch.autograd.Function):
    """``fn(t)`` forward, the gradient passed through unchanged."""

    @staticmethod
    def forward(ctx, t, fn):
        return fn(t)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _RoundedGrad(torch.autograd.Function):
    """t forward, ``fn`` of the gradient backward."""

    @staticmethod
    def forward(ctx, t, fn):
        ctx.fn = fn
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.fn(g), None


def _tf32(t):
    bits = t.contiguous().view(torch.int32)
    # round to nearest even at bit 13, then clear the 13 low bits
    lsb = (bits >> 13) & 1
    return ((bits + 0xFFF + lsb) & ~0x1FFF).view(torch.float32)


def _fp8(t):
    amax = t.abs().max()
    scale = torch.where(amax > 0, _FP8_MAX / amax, torch.ones_like(amax))
    return (t * scale).to(torch.float8_e4m3fn).to(t.dtype) / scale


class Numerics:
    """The precision of the convolutions' operands (module docstring). In
    the lower precisions a convolution's backward reads rounded operands
    too: its input and weight as the forward rounded them, and its output's
    gradient rounded (``output``)."""

    MODES = ("f32", "tf32", "fp8", "f64")

    def __init__(self, mode: str = "f32"):
        if mode not in self.MODES:
            raise ValueError(f"unknown precision {mode!r}")
        self.mode = mode
        self._round = {"tf32": _tf32, "fp8": _fp8}.get(mode)

    @property
    def dtype(self):
        return torch.float64 if self.mode == "f64" else torch.float32

    def operand(self, t: torch.Tensor) -> torch.Tensor:
        t = t.to(self.dtype)
        return t if self._round is None else _Rounded.apply(t, self._round)

    def output(self, t: torch.Tensor) -> torch.Tensor:
        if self._round is None or not t.requires_grad:
            return t
        return _RoundedGrad.apply(t, self._round)


def _name(counters: dict, cls: str) -> str:
    k = counters.get(cls, 0)
    counters[cls] = k + 1
    return f"{cls}_{k}"


def _activation(name: str, arg, x):
    name = name.lower()
    if name == "relu":
        return F.relu(x)
    if name == "leaky relu":
        return F.leaky_relu(x, 0.2 if arg is None else float(arg))
    if name == "tanh":
        return torch.tanh(x)
    if name == "sigmoid":
        return torch.sigmoid(x)
    if name == "softplus":
        return F.softplus(x)
    raise NotImplementedError(f"activation {name}")


def _batchnorm(x, p: dict, key: str, train: bool):
    """Batch norm: batch mean and biased variance in train mode (two
    passes), the running statistics in eval mode."""
    w, b = p[key + ".weight"], p[key + ".bias"]
    if train:
        mean = x.mean(dim=(0, 2, 3))
        var = ((x - mean[:, None, None]) ** 2).mean(dim=(0, 2, 3))
    else:
        mean, var = p[key + ".running_mean"], p[key + ".running_var"]
    inv = 1.0 / torch.sqrt(var.to(x.dtype) + BN_EPS)
    return ((x - mean.to(x.dtype)[:, None, None]) * (w.to(x.dtype) * inv)
            [:, None, None] + b.to(x.dtype)[:, None, None])


def apply(spec, p: dict, x, prefix: str, nm: Numerics, train: bool = False):
    """Run the layer list ``spec`` on x (N, C, H, W) with the parameters
    ``p`` under ``prefix`` (``"<subnet>.layers."``)."""
    counters: dict = {}
    for layer in spec or ():
        kind = str(layer[0]).lower()
        cfg = layer[1] if len(layer) > 1 else None
        if kind == "conv":
            key = prefix + _name(counters, "Conv2d")
            bias = p.get(key + ".bias")
            x = nm.output(F.conv2d(
                nm.operand(x), nm.operand(p[key + ".weight"]), None,
                stride=cfg.get("stride", 1), padding=cfg.get("padding", 0)))
            if bias is not None:
                x = x + bias.to(x.dtype)[:, None, None]
        elif kind == "transp conv":
            key = prefix + _name(counters, "ConvTranspose2d")
            bias = p.get(key + ".bias")
            x = nm.output(F.conv_transpose2d(
                nm.operand(x), nm.operand(p[key + ".weight"]), None,
                stride=cfg.get("stride", 1), padding=cfg.get("padding", 0),
                output_padding=cfg.get("output_padding", 0)))
            if bias is not None:
                x = x + bias.to(x.dtype)[:, None, None]
        elif kind == "batchnorm":
            x = _batchnorm(x, p, prefix + _name(counters, "BatchNorm"),
                           train)
        elif kind == "prelu":
            a = p[prefix + _name(counters, "PReLU") + ".weight"]
            x = torch.where(x >= 0, x, a.to(x.dtype) * x)
        elif kind in ("relu", "leaky relu", "tanh", "sigmoid", "softplus"):
            x = _activation(kind, cfg, x)
        elif kind == "residual block":
            inner, act = cfg
            key = prefix + _name(counters, "ResidualBlock")
            h = apply(inner, p, x, key + ".SpecSequential_0.layers.", nm,
                      train)
            x = _activation(act[0], act[1] if len(act) > 1 else None, h + x)
        elif kind == "upsample nearest":
            s = int(cfg["scale"])
            x = x.repeat_interleave(s, dim=2).repeat_interleave(s, dim=3)
        elif kind == "unflatten":
            continue
        else:
            raise NotImplementedError(f"layer {layer[0]}")
    return x


def param_specs(spec, prefix: str, kernel_init=("uniform",)) -> list:
    """(name, shape, init) of every parameter and buffer of a layer list:
    init is ``("uniform", bound)``, ``("normal", std)`` or
    ``("const", value)``. Kernels take ``kernel_init``: ``("uniform",)``
    draws U(-b, b) with b = 1/sqrt(k^2 C_in), ``("normal", std)`` N(0,
    std^2); biases U(-b, b); batch norm scale 1, bias 0, running mean 0 and
    variance 1; a PReLU slope 0.25. Residual blocks' inner lists take the
    uniform kernels."""
    out: list = []
    counters: dict = {}
    for layer in spec or ():
        kind = str(layer[0]).lower()
        cfg = layer[1] if len(layer) > 1 else None
        if kind in ("conv", "transp conv"):
            key = prefix + _name(counters, "Conv2d" if kind == "conv"
                                 else "ConvTranspose2d")
            cin, cout, k = (cfg["in_channels"], cfg["out_channels"],
                            cfg["kernel_size"])
            shape = (cout, cin, k, k) if kind == "conv" else (cin, cout, k, k)
            bound = 1.0 / math.sqrt(k * k * cin)
            init = (("uniform", bound) if kernel_init[0] == "uniform"
                    else ("normal", kernel_init[1]))
            out.append((key + ".weight", shape, init))
            if cfg.get("bias", True):
                out.append((key + ".bias", (cout,), ("uniform", bound)))
        elif kind == "batchnorm":
            key = prefix + _name(counters, "BatchNorm")
            c = cfg["num_features"]
            out += [(key + ".weight", (c,), ("const", 1.0)),
                    (key + ".bias", (c,), ("const", 0.0)),
                    (key + ".running_mean", (c,), ("const", 0.0)),
                    (key + ".running_var", (c,), ("const", 1.0))]
        elif kind == "prelu":
            key = prefix + _name(counters, "PReLU")
            out.append((key + ".weight", (), ("const", 0.25)))
        elif kind == "residual block":
            key = prefix + _name(counters, "ResidualBlock")
            out += param_specs(cfg[0], key + ".SpecSequential_0.layers.")
    return out


_LAYER = re.compile(r"^(Conv2d|ConvTranspose2d|BatchNorm|PReLU)_\d+$")


def flax_to_flat(params: dict, stats: dict, prefix: str) -> dict:
    """One flax scope (a layer list's variables as a checkpoint holds them)
    as flat numpy arrays under the reference's names: conv kernels HWIO ->
    OIHW; transposed-conv kernels flipped in space and HWIO -> IOHW (flax
    computes a transposed conv as an input-dilated correlation); batch norm
    scale, bias, mean, var; PReLU slopes. Spectral-norm state is not read
    here (``fold_spectral_norm``)."""
    out = {}
    stats = stats or {}
    for key, sub in params.items():
        if key.startswith("ResidualBlock_"):
            out.update(flax_to_flat(
                sub["SpecSequential_0"],
                stats.get(key, {}).get("SpecSequential_0", {}),
                f"{prefix}{key}.SpecSequential_0.layers."))
            continue
        if not _LAYER.match(key):
            raise ValueError(f"unknown flax scope {key}")
        name = prefix + key
        arr = lambda v: np.array(v, dtype=np.float32)
        if key.startswith("Conv2d_"):
            out[name + ".weight"] = arr(sub["kernel"]).transpose(3, 2, 0, 1)
        elif key.startswith("ConvTranspose2d_"):
            out[name + ".weight"] = arr(
                sub["kernel"])[::-1, ::-1].transpose(2, 3, 0, 1)
        elif key.startswith("BatchNorm_"):
            out[name + ".weight"] = arr(sub["scale"])
            out[name + ".running_mean"] = arr(stats[key]["mean"])
            out[name + ".running_var"] = arr(stats[key]["var"])
        elif key.startswith("PReLU_"):
            out[name + ".weight"] = arr(sub["negative_slope"])
        if "bias" in sub:
            out[name + ".bias"] = arr(sub["bias"])
    return {k: np.ascontiguousarray(v) for k, v in out.items()}


def _l2n(v):
    return v / np.sqrt((v * v).sum() + _SN_EPS)


def fold_spectral_norm(params: dict, stats: dict) -> dict:
    """One flax scope's params with every spectrally normalised kernel
    divided by the sigma of flax's eval-time spectral norm: the kernel as a
    (fan_in, C_out) matrix in flax's layout, one power iteration from the
    stored u (v = l2n(u W^T), u' = l2n(v W)), sigma = v W u'^T (1 where
    that is 0). Computed in float64 and applied to the f32 kernel. Nested
    scopes (residual blocks) recurse."""
    params = {k: dict(v) if isinstance(v, dict) else v
              for k, v in params.items()}
    for key, sub in (stats or {}).items():
        if key.startswith("SpectralNorm_"):
            for var, u in sub.items():
                if not var.endswith("/u"):
                    continue
                layer, pname, _ = var.split("/")
                w = np.asarray(params[layer][pname], np.float64)
                mat = w.reshape(-1, w.shape[-1])
                v = _l2n(np.asarray(u, np.float64) @ mat.T)
                u1 = _l2n(v @ mat)
                sigma = float((v @ mat @ u1.T)[0, 0]) or 1.0
                params[layer][pname] = (np.asarray(params[layer][pname],
                                                   np.float32) / sigma)
        elif key in params and isinstance(sub, dict):
            params[key] = fold_spectral_norm(params[key], sub)
    return params
