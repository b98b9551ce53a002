"""Eval-mode layers interpreting the layer DSL (``models/dsl.py``), NCHW.

Port of ``baryon_painter_tpu/models/layers.py`` for painting: batch norm
uses its running statistics, and nothing here trains yet. Shape rules are
PyTorch's, as in the JAX package:

  * Conv2d:          out = floor((in + 2p - k)/s) + 1
  * ConvTranspose2d: out = (in - 1)*s - 2p + k + output_padding

Every parametric layer is named as flax names it (``Conv2d_0``,
``BatchNorm_1``, ``ResidualBlock_0``, ``FusedResBlock_0``, ...), so the
weights of a JAX checkpoint map onto it one to one (``convert.py``).
Convolutions outside the fused residual block are PyTorch's own, as the JAX
package leaves them to XLA; the fused block runs K1 (``ops/res_block.py``).
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from baryon_painter_tpu_torch.ops.res_block import fold_bn, res_block_infer

__all__ = ["Conv2d", "ConvTranspose2d", "BatchNorm", "PReLU",
           "ResidualBlock", "FusedResBlock", "SpecSequential",
           "merge_aux_label"]

_BN_EPS = 1e-5


def _frozen(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape), requires_grad=False)


class Conv2d(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, bias=True):
        super().__init__()
        self.stride, self.padding = stride, padding
        self.weight = _frozen(out_channels, in_channels, kernel_size,
                              kernel_size)                         # OIHW
        self.bias = _frozen(out_channels) if bias else None

    def forward(self, x):
        k = self.weight.shape[-1]
        out_h = (x.shape[2] + 2 * self.padding - k) // self.stride + 1
        if out_h <= 0:
            raise ValueError(
                f"Conv2d(k={k}, s={self.stride}, p={self.padding}) on a "
                f"{x.shape[2]}x{x.shape[3]} input produces a {out_h}-pixel "
                f"output; the tile is too small for this architecture.")
        return F.conv2d(x, self.weight, self.bias, self.stride, self.padding)


class ConvTranspose2d(nn.Module):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, bias=True):
        super().__init__()
        if kernel_size - 1 - padding < 0:
            raise ValueError(f"Unsupported transp-conv padding: "
                             f"k={kernel_size}, p={padding}.")
        self.stride, self.padding = stride, padding
        self.output_padding = output_padding
        self.weight = _frozen(in_channels, out_channels, kernel_size,
                              kernel_size)                         # IOHW
        self.bias = _frozen(out_channels) if bias else None

    def forward(self, x):
        return F.conv_transpose2d(x, self.weight, self.bias, self.stride,
                                  self.padding, self.output_padding)


class BatchNorm(nn.Module):
    """Eval-mode batch norm: x * a + b with a = scale / sqrt(var + eps) and
    b = bias - mean * a, computed as the JAX package computes it."""

    def __init__(self, num_features):
        super().__init__()
        self.weight = _frozen(num_features)
        self.bias = _frozen(num_features)
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    def forward(self, x):
        a = self.weight * torch.rsqrt(self.running_var + _BN_EPS)
        b = self.bias - self.running_mean * a
        return x * a[:, None, None] + b[:, None, None]


class PReLU(nn.Module):
    """Single learnable slope, as torch's default PReLU."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.full((), 0.25), requires_grad=False)

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight * x)


def _act_slope(layer):
    """(leaky-)ReLU slope of an activation spec entry, or None if it is
    neither: ('ReLU',) -> 0.0, ('Leaky ReLU', s) -> s (default 0.2)."""
    name = str(layer[0]).lower()
    if name == "relu":
        return 0.0
    if name == "leaky relu":
        return (float(layer[1]) if len(layer) > 1 and layer[1] is not None
                else 0.2)
    return None


def _activation(name, config=None):
    """Elementwise activation for a spec name (None is the identity)."""
    if name is None:
        return lambda x: x
    name = name.lower()
    if name == "relu":
        return F.relu
    if name == "leaky relu":
        slope = 0.2 if config is None else config
        return lambda x: F.leaky_relu(x, slope)
    if name == "tanh":
        return torch.tanh
    if name == "sigmoid":
        return torch.sigmoid
    if name == "softplus":
        return F.softplus
    raise NotImplementedError(f"Activation {name} not supported yet!")


def canonical_res_block_slopes(config):
    """``(inner_slope, outer_slope)`` when a residual-block spec is the
    canonical conv3x3/bn/act/conv3x3/bn shape with (leaky-)ReLU activations,
    else ``None`` (the JAX package's ``_canonical_res_block_slopes``)."""
    inner, act = config
    outer_slope = _act_slope(act)
    if outer_slope is None:
        return None
    names = [str(l[0]).lower() for l in inner]
    if (len(names) != 5
            or names != ["conv", "batchnorm", names[2], "conv", "batchnorm"]):
        return None
    inner_slope = _act_slope(inner[2])
    if inner_slope is None:
        return None
    c1, c2 = inner[0][1], inner[3][1]
    for c in (c1, c2):
        if (c["kernel_size"], c.get("stride", 1), c.get("padding", 0),
                c.get("bias", True)) != (3, 1, 1, False):
            return None
    if not (c1["in_channels"] == c1["out_channels"] == c2["out_channels"]):
        return None
    return inner_slope, outer_slope


class ResidualBlock(nn.Module):
    """x -> act(inner(x) + x)."""

    def __init__(self, inner_spec, activation):
        super().__init__()
        self.SpecSequential_0 = SpecSequential(inner_spec)
        act = tuple(activation)
        self._act = _activation(act[0], act[1] if len(act) > 1 else None)

    def forward(self, x):
        return self._act(self.SpecSequential_0(x) + x)


class FusedResBlock(nn.Module):
    """Canonical residual block run as one K1 launch: batch norm folded to a
    per-channel scale and bias, x handed to the kernel as NHWC.

    The NHWC view of a ``channels_last`` tensor is free; the output comes
    back ``channels_last``, so consecutive blocks pass it on without a copy.
    """

    def __init__(self, features, inner_slope=0.0, outer_slope=0.0):
        super().__init__()
        c = features
        self.inner_slope, self.outer_slope = inner_slope, outer_slope
        self.conv1_kernel = _frozen(3, 3, c, c)                    # HWIO
        self.conv2_kernel = _frozen(3, 3, c, c)
        for name in ("bn1_scale", "bn1_bias", "bn2_scale", "bn2_bias"):
            setattr(self, name, _frozen(c))
        for name, init in (("bn1_mean", torch.zeros), ("bn1_var", torch.ones),
                           ("bn2_mean", torch.zeros), ("bn2_var", torch.ones)):
            self.register_buffer(name, init(c))

    def forward(self, x):
        s1, b1 = fold_bn(self.bn1_scale, self.bn1_bias, self.bn1_mean,
                         self.bn1_var, _BN_EPS)
        s2, b2 = fold_bn(self.bn2_scale, self.bn2_bias, self.bn2_mean,
                         self.bn2_var, _BN_EPS)
        out = res_block_infer(x.permute(0, 2, 3, 1).contiguous(),
                              self.conv1_kernel, s1, b1,
                              self.conv2_kernel, s2, b2,
                              inner_slope=self.inner_slope,
                              outer_slope=self.outer_slope)
        return out.permute(0, 3, 1, 2)


def _upsample_nearest(x, s: int):
    n, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(n, c, h, s, w, s).reshape(
        n, c, h * s, w * s)


class SpecSequential(nn.Module):
    """Interpret a layer-spec list (see models/dsl.py) in eval mode.

    ``spec=None`` is the identity. With ``fused_res_blocks=True`` every
    canonical residual block becomes a ``FusedResBlock`` (K1); the others
    stay ``ResidualBlock``s, numbered apart, as flax numbers them.
    """

    def __init__(self, spec: Optional[Sequence], fused_res_blocks=False):
        super().__init__()
        self.layers = nn.ModuleDict()
        self._steps = []   # module names and elementwise callables, in order
        counters = {}

        def add(module):
            cls = type(module).__name__
            name = f"{cls}_{counters.get(cls, 0)}"
            counters[cls] = counters.get(cls, 0) + 1
            self.layers[name] = module
            self._steps.append(name)

        for layer in spec or ():
            name = layer[0]
            config = layer[1] if len(layer) > 1 else None
            lname = name.lower() if isinstance(name, str) else name
            if lname == "conv":
                add(Conv2d(config["in_channels"], config["out_channels"],
                           config["kernel_size"], config.get("stride", 1),
                           config.get("padding", 0), config.get("bias", True)))
            elif lname == "transp conv":
                add(ConvTranspose2d(
                    config["in_channels"], config["out_channels"],
                    config["kernel_size"], config.get("stride", 1),
                    config.get("padding", 0),
                    config.get("output_padding", 0),
                    config.get("bias", True)))
            elif lname == "batchnorm":
                add(BatchNorm(config["num_features"]))
            elif lname == "prelu":
                add(PReLU())
            elif lname in ("relu", "leaky relu", "tanh", "sigmoid",
                           "softplus"):
                self._steps.append(_activation(lname, config))
            elif lname == "residual block":
                inner, act = config
                slopes = (canonical_res_block_slopes(config)
                          if fused_res_blocks else None)
                if slopes is not None:
                    add(FusedResBlock(inner[0][1]["out_channels"], *slopes))
                else:
                    add(ResidualBlock(inner, act))
            elif lname == "upsample nearest":
                s = config["scale"]
                self._steps.append(lambda x, s=s: _upsample_nearest(x, s))
            elif lname == "unflatten":
                # heads split channels explicitly in the models; a no-op
                # marker kept for spec compatibility
                pass
            else:
                raise NotImplementedError(f"Layer {name} not supported yet!")

    def forward(self, x):
        for step in self._steps:
            x = self.layers[step](x) if isinstance(step, str) else step(x)
        return x


def merge_aux_label(y, aux_label):
    """Concatenate scalar labels as constant feature maps (NCHW):
    y (N,C,H,W), aux (N,) or (N,K) -> (N,C+K,H,W)."""
    aux = torch.as_tensor(aux_label, dtype=y.dtype, device=y.device)
    if aux.ndim == 0:
        aux = aux.reshape(1, 1)
    elif aux.ndim == 1:
        aux = aux.reshape(-1, 1)
    if aux.shape[0] != y.shape[0]:
        raise ValueError("aux_label batch size needs to match that of y")
    n, _, h, w = y.shape
    maps = aux[:, :, None, None].expand(n, aux.shape[1], h, w)
    return torch.cat([y, maps], dim=1)
