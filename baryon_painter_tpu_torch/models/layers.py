"""Layers interpreting the layer DSL (``models/dsl.py``), NCHW.

Port of ``baryon_painter_tpu/models/layers.py``. The module's ``training``
flag plays the JAX ``train`` argument (layers are built in eval mode, the
painting default; ``.train()`` switches them). In train mode batch norm
normalises with the batch statistics and updates its running averages as the
JAX package's ``BatchNorm`` does (E[x^2] - E[x]^2 batch variance in f32, running
statistics updated with that biased variance, momentum 0.9 as the fraction
kept: ``running = 0.9 * running + 0.1 * batch``); in eval mode it uses the
running statistics. Shape rules are PyTorch's, as in the JAX package:

  * Conv2d:          out = floor((in + 2p - k)/s) + 1
  * ConvTranspose2d: out = (in - 1)*s - 2p + k + output_padding

Every parametric layer is named as flax names it (``Conv2d_0``,
``BatchNorm_1``, ``ResidualBlock_0``, ``FusedResBlock_0``, ...), so the
weights of a JAX checkpoint map onto it one to one (``convert.py``).
Convolutions outside the fused residual block are PyTorch's own, as the JAX
package leaves them to XLA; the fused block runs K1 (``ops/res_block.py``)
and is inference-only, as K1 has no backward. With
``fused_train_conv=True`` (the JAX package's ``BPT_FUSED_TRAIN_CONV=1``) a
train-mode (conv | transposed conv, batch norm, ReLU) triple that passes the
JAX package's gate runs as one K4 call (``ops/conv_bn.py``).

``dtype`` (None or ``torch.bfloat16``) is the JAX package's compute dtype
and rounds where it rounds (``baryon_painter_tpu/models/layers.py``): a
convolution casts x and its weight to it, and its f32 bias promotes the sum
to f32; batch norm casts x to it, keeps its statistics and affine in f32
and returns x's dtype; PReLU casts its slope to x's dtype; the fused block
casts x to it; a leaky ReLU's slope meets x in its dtype (in bf16 0.2 is
0.2001953125, as JAX's weak-typed scalar becomes); a K4 triple casts x and
the conv's weight to it and keeps
K4's rounding points (``ops/conv_bn.py``: u and the batch statistics f32,
y in the dtype). Parameters, running statistics and gradients of
parameters stay f32. ``None`` computes in x's dtype: f32 as before, bit for
bit.

``spectral_norm=True`` (the CGAN's) gives every convolution and transposed
convolution flax's ``SpectralNorm`` (``flax.linen.SpectralNorm``, one power
iteration, epsilon 1e-12), as the JAX package wraps them
(``baryon_painter_tpu/models/layers.py:486-489``): the kernel in flax's
layout (HWIO, for a transposed conv as well) reshaped to (fan_in, C_out),
v = l2n(u W^T) and u' = l2n(v W) from the stored u (1, C_out) without a
gradient, sigma = v W u'^T with the gradient through W, and the kernel used
is W / sigma (1 where sigma is 0). In train mode u' and sigma are stored in
the layer's buffers ``sn_u`` and ``sn_sigma`` (flax's ``update_stats``); in
eval mode the iteration still runs from the stored u, and nothing is
stored. Biases and batch-norm parameters are not normalised.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from baryon_painter_tpu_torch.ops import conv_rules
from baryon_painter_tpu_torch.ops.conv_bn import conv_bn_relu
from baryon_painter_tpu_torch.ops.res_block import (K1Operands, fold_bn,
                                                    res_block_infer,
                                                    res_block_operands)
from baryon_painter_tpu_torch.parallel.mesh import active_mesh

__all__ = ["Conv2d", "ConvTranspose2d", "Dense", "BatchNorm", "PReLU",
           "ResidualBlock", "FusedResBlock", "SpecSequential",
           "merge_aux_label", "softplus"]

_BN_EPS = 1e-5
# the fraction of the running statistics kept per training step: every
# batch norm of the JAX package's SpecSequential is built with momentum=0.9
_BN_MOMENTUM = 0.9
# flax.linen.SpectralNorm's epsilon inside the l2 normalisation's rsqrt
_SN_EPS = 1e-12


def _param(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape))


def _frozen(*shape) -> nn.Parameter:
    return nn.Parameter(torch.zeros(*shape), requires_grad=False)


def _low_precision_in_f32(fn, x, weight) -> bool:
    """Whether a low-precision ``fn`` of ``x`` with ``weight`` runs in f32
    on the rounded operands instead of the library's low-precision path:
    on the CPU always, on the card for an ``F.conv2d`` with one input and
    one output channel (see ``_conv``)."""
    if x.device.type == "cpu":
        return True
    return fn is F.conv2d and weight.shape[0] == weight.shape[1] == 1


def _conv(fn, x, weight, bias, dtype, **kw):
    """``fn`` (a conv) in ``dtype`` (None: x's): x and the weight rounded to
    it, the products summed in f32 and the sum rounded to it; an f32 bias
    is added after a low-precision conv, which promotes the sum to f32 as
    in JAX. On the card cuDNN computes exactly that in bf16, except for a
    1 -> 1 channel ``F.conv2d``, which on an H100 (cuDNN 9.22) is wrong
    from 32^2 up whatever the layout (off by about its own size, or NaN
    when the allocator's free memory holds NaN). There, and always on the
    CPU, the bf16 conv runs in f32 on the rounded values (the products of
    two bf16 numbers are exact in f32): PyTorch's CPU bf16 convolution is
    wrong at some shapes (a stride-4 8 -> 16 conv at 64^2 misses by 100 %).
    An f64 conv is f64 on both."""
    dt = dtype or x.dtype
    if x.dtype == weight.dtype == dt and (bias is None or bias.dtype == dt):
        return fn(x, weight, bias, **kw)
    if dt.itemsize < 4 and _low_precision_in_f32(fn, x, weight):
        out = fn(x.to(dt).float(), weight.to(dt).float(), None, **kw).to(dt)
    else:
        out = fn(x.to(dt), weight.to(dt), None, **kw)
    return out if bias is None else out + bias[:, None, None]


def _l2_normalize(x):
    """flax's ``_l2_normalize``: x * rsqrt(sum(x^2) + eps)."""
    return x * torch.rsqrt((x * x).sum() + _SN_EPS)


class _SpectralNormConv(nn.Module):
    """A convolution's weight, spectrally normalised when built with
    ``spectral_norm=True`` (module docstring)."""

    def _init_spectral_norm(self, spectral_norm: bool, out_channels: int):
        self.spectral_norm = spectral_norm
        if spectral_norm:
            self.register_buffer("sn_u", torch.zeros(1, out_channels))
            self.register_buffer("sn_sigma", torch.ones(()))

    def flax_matrix(self) -> torch.Tensor:
        """The weight as flax's (fan_in, C_out) matrix (HWIO rows)."""
        raise NotImplementedError

    def normalized_weight(self) -> torch.Tensor:
        """The weight the convolution uses: W / sigma with spectral norm
        (storing u' and sigma in train mode), else the weight itself."""
        if not self.spectral_norm:
            return self.weight
        w = self.flax_matrix()
        with torch.no_grad():
            v = _l2_normalize(self.sn_u @ w.T)
            u = _l2_normalize(v @ w)
        sigma = ((v @ w) @ u.T)[0, 0]
        if self.training:
            with torch.no_grad():
                self.sn_u.copy_(u)
                self.sn_sigma.copy_(sigma)
        return self.weight / torch.where(sigma != 0, sigma,
                                         torch.ones_like(sigma))


class Conv2d(_SpectralNormConv):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, bias=True, dtype=None, spectral_norm=False):
        super().__init__()
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.weight = _param(out_channels, in_channels, kernel_size,
                             kernel_size)                          # OIHW
        self.bias = _param(out_channels) if bias else None
        self._init_spectral_norm(spectral_norm, out_channels)

    def flax_matrix(self):
        return self.weight.permute(2, 3, 1, 0).reshape(
            -1, self.weight.shape[0])

    def forward(self, x):
        k = self.weight.shape[-1]
        out_h = (x.shape[2] + 2 * self.padding - k) // self.stride + 1
        if out_h <= 0:
            raise ValueError(
                f"Conv2d(k={k}, s={self.stride}, p={self.padding}) on a "
                f"{x.shape[2]}x{x.shape[3]} input produces a {out_h}-pixel "
                f"output; the tile is too small for this architecture.")
        return _conv(F.conv2d, x, self.normalized_weight(), self.bias,
                     self.dtype, stride=self.stride, padding=self.padding)


class ConvTranspose2d(_SpectralNormConv):
    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, bias=True, dtype=None,
                 spectral_norm=False):
        super().__init__()
        if kernel_size - 1 - padding < 0:
            raise ValueError(f"Unsupported transp-conv padding: "
                             f"k={kernel_size}, p={padding}.")
        self.stride, self.padding, self.dtype = stride, padding, dtype
        self.output_padding = output_padding
        self.weight = _param(in_channels, out_channels, kernel_size,
                             kernel_size)                          # IOHW
        self.bias = _param(out_channels) if bias else None
        self._init_spectral_norm(spectral_norm, out_channels)

    def flax_matrix(self):
        # the port's IOHW weight is flax's HWIO kernel flipped in space
        return self.weight.flip(2, 3).permute(2, 3, 0, 1).reshape(
            -1, self.weight.shape[1])

    def forward(self, x):
        return _conv(F.conv_transpose2d, x, self.normalized_weight(),
                     self.bias, self.dtype, stride=self.stride,
                     padding=self.padding,
                     output_padding=self.output_padding)


class Dense(_SpectralNormConv):
    """The DSL's ``linear``: flax's ``nn.Dense`` on the features, the last
    axis of a flattened (N, F) input or the channels of an (N, C, H, W)
    one (flax's NHWC last axis). The weight is ``nn.Linear``'s (out, in),
    flax's (in, out) kernel transposed (``convert.py``). In ``dtype``, as
    flax's ``promote_dtype``: x, the weight and the bias rounded to it, the
    products summed in f32 and the sum rounded. With ``spectral_norm`` the
    kernel is normalised as flax's ``SpectralNorm`` wraps ``nn.Dense``."""

    def __init__(self, in_features, out_features, bias=True, dtype=None,
                 spectral_norm=False):
        super().__init__()
        self.dtype = dtype
        self.weight = _param(out_features, in_features)
        self.bias = _param(out_features) if bias else None
        self._init_spectral_norm(spectral_norm, out_features)

    def flax_matrix(self):
        return self.weight.t()

    def forward(self, x):
        channels = x.ndim == 4
        if channels:
            x = x.permute(0, 2, 3, 1)
        w, b = self.normalized_weight(), self.bias
        dt = self.dtype or x.dtype
        if dt.itemsize < 4:
            out = F.linear(x.to(dt).float(), w.to(dt).float()).to(dt)
            out = out if b is None else out + b.to(dt)
        else:
            out = F.linear(x.to(dt), w.to(dt),
                           None if b is None else b.to(dt))
        return out.permute(0, 3, 1, 2) if channels else out


class BatchNorm(nn.Module):
    """Batch norm with the JAX package's semantics (module docstring).

    Both modes compute ``x * a + b`` with a = scale / sqrt(var + eps) and
    b = bias - mean * a, as the JAX package does; train mode takes mean and
    var from the batch (f32) and the gradient flows through them. Inside a
    ``ProcessMesh``'s ``active()`` block the batch is the global one: the
    ranks' per-channel E[x] and E[x^2] are averaged (equal shares), and
    the backward averages their gradients the same way. x is cast
    to ``dtype`` (None: kept), the affine computed in f32 (f64 for f64) and
    the result returned in that dtype; in train mode the gradient reaching
    x is rounded to it too."""

    def __init__(self, num_features, dtype=None):
        super().__init__()
        self.dtype = dtype
        self.weight = _param(num_features)
        self.bias = _param(num_features)
        self.register_buffer("running_mean", torch.zeros(num_features))
        self.register_buffer("running_var", torch.ones(num_features))

    @torch.no_grad()
    def update_running(self, mean, var):
        """Move the running statistics towards a batch's (biased) ones."""
        m = _BN_MOMENTUM
        self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
        self.running_var.copy_(m * self.running_var + (1 - m) * var)

    def forward(self, x):
        dt = self.dtype or x.dtype
        xf = x.to(dt).to(torch.promote_types(dt, torch.float32))
        if self.training:
            mean = xf.mean(dim=(0, 2, 3))
            mean_sq = (xf * xf).mean(dim=(0, 2, 3))
            mesh = active_mesh()
            if mesh is not None:
                # over the global batch: the ranks' equal shares averaged,
                # differentiably (the backward all-reduces too)
                mean, mean_sq = mesh.mean(torch.stack([mean, mean_sq]))
            var = mean_sq - mean * mean
            self.update_running(mean, var)
        else:
            mean, var = self.running_mean, self.running_var
            if torch.is_grad_enabled():
                # a graph through the running statistics (the trainer's
                # spectral term) keeps their values of this call: a
                # train-mode call later in the step updates them in place
                mean, var = mean.clone(), var.clone()
        a = self.weight * torch.rsqrt(var + _BN_EPS)
        b = self.bias - mean * a
        return (xf * a[:, None, None] + b[:, None, None]).to(dt)


class PReLU(nn.Module):
    """Single learnable slope, as torch's default PReLU, in x's dtype (the
    slope is cast to it, as the JAX package casts it)."""

    def __init__(self):
        super().__init__()
        self.weight = nn.Parameter(torch.full((), 0.25))

    def forward(self, x):
        return torch.where(x >= 0, x, self.weight.to(x.dtype) * x)


class _LowPrecisionSoftplus(torch.autograd.Function):
    """The JAX package's softplus (``jnp.logaddexp(x, 0)``) in x's dtype,
    each operation rounded to it: max(x, 0) + log1p(exp(-|x|)), and its
    JVP's gradient g * exp(x - softplus(x))."""

    @staticmethod
    def forward(ctx, x):
        out = torch.clamp(x, min=0) + torch.log1p(torch.exp(-x.abs()))
        ctx.save_for_backward(x, out)
        return out

    @staticmethod
    def backward(ctx, g):
        x, out = ctx.saved_tensors
        return g * torch.exp(x - out)


def softplus(x):
    """Softplus in x's dtype: PyTorch's in f32, the JAX package's rounding
    points below it (PyTorch's bf16 softplus rounds once, JAX's after each
    of its operations; about one bf16 output in six differs)."""
    if x.dtype == torch.float32:
        return F.softplus(x)
    return _LowPrecisionSoftplus.apply(x)


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


def _slope_in(slope: float, dtype) -> float:
    """A leaky ReLU's slope as the JAX package applies it to x of
    ``dtype``: a Python float meets a bf16 x as a bf16 number (0.2 becomes
    0.2001953125), and the product is rounded once; f32 and f64 keep it."""
    if dtype.itemsize >= 4:
        return slope
    return float(torch.tensor(slope, dtype=dtype))


def _activation(name, config=None):
    """Elementwise activation for a spec name (None is the identity)."""
    if name is None:
        return lambda x: x
    name = name.lower()
    if name == "relu":
        return F.relu
    if name == "leaky relu":
        slope = 0.2 if config is None else config
        return lambda x: F.leaky_relu(x, _slope_in(slope, x.dtype))
    if name == "tanh":
        return torch.tanh
    if name == "sigmoid":
        return torch.sigmoid
    if name == "softplus":
        return softplus
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

    def __init__(self, inner_spec, activation, fused_train_conv=False,
                 dtype=None, spectral_norm=False):
        super().__init__()
        self.SpecSequential_0 = SpecSequential(
            inner_spec, fused_train_conv=fused_train_conv, dtype=dtype,
            spectral_norm=spectral_norm)
        act = tuple(activation)
        self._act = _activation(act[0], act[1] if len(act) > 1 else None)

    def forward(self, x):
        return self._act(self.SpecSequential_0(x) + x)


class FusedResBlock(nn.Module):
    """Canonical residual block run as one K1 launch: batch norm folded to a
    per-channel scale and bias, x handed to the kernel as NHWC.

    The NHWC view of a ``channels_last`` tensor is free; the output comes
    back ``channels_last``, so consecutive blocks pass it on without a copy.
    x is cast to ``dtype`` (None: kept), in which K1 computes and returns.
    The kernel's operands (the weights in its layout, the folded BN) are
    made once per weights, type and device (``kernel_operands``), not on
    every call; the folded BN is also what the plain version takes on the
    CPU.
    """

    def __init__(self, features, inner_slope=0.0, outer_slope=0.0,
                 dtype=None):
        super().__init__()
        c = features
        self.dtype = dtype
        self.inner_slope, self.outer_slope = inner_slope, outer_slope
        self.conv1_kernel = _frozen(3, 3, c, c)                    # HWIO
        self.conv2_kernel = _frozen(3, 3, c, c)
        for name in ("bn1_scale", "bn1_bias", "bn2_scale", "bn2_bias"):
            setattr(self, name, _frozen(c))
        for name, init in (("bn1_mean", torch.zeros), ("bn1_var", torch.ones),
                           ("bn2_mean", torch.zeros), ("bn2_var", torch.ones)):
            self.register_buffer(name, init(c))
        self._k1_key = None
        self._k1_operands = None

    def _folded(self):
        return (*fold_bn(self.bn1_scale, self.bn1_bias, self.bn1_mean,
                         self.bn1_var, _BN_EPS),
                *fold_bn(self.bn2_scale, self.bn2_bias, self.bn2_mean,
                         self.bn2_var, _BN_EPS))

    def kernel_operands(self, dtype) -> K1Operands:
        """K1's operands for x of ``dtype`` (``res_block_operands``), made
        on the first call and again only when a weight or batch-norm tensor
        changes (in place, as ``load_state_dict`` does, or by a move)."""
        tensors = (self.conv1_kernel, self.conv2_kernel, self.bn1_scale,
                   self.bn1_bias, self.bn2_scale, self.bn2_bias,
                   self.bn1_mean, self.bn1_var, self.bn2_mean, self.bn2_var)
        key = (dtype,) + tuple((t.device, t.data_ptr(), t._version)
                               for t in tensors)
        if key != self._k1_key:
            with torch.no_grad():
                s1, b1, s2, b2 = self._folded()
                self._k1_operands = res_block_operands(
                    self.conv1_kernel, s1, b1, self.conv2_kernel, s2, b2,
                    dtype)
            self._k1_key = key
        return self._k1_operands

    def forward(self, x):
        if self.training:
            raise NotImplementedError(
                "FusedResBlock is inference-only (K1 has no backward); train "
                "the unfused layout (fused_res_blocks=False) and fuse the "
                "trained weights for painting.")
        x = x.to(self.dtype or x.dtype)
        xk = x.permute(0, 2, 3, 1).contiguous()
        ops = self.kernel_operands(x.dtype)
        c = xk.shape[-1]
        out = res_block_infer(xk, self.conv1_kernel, ops.scale1[:c],
                              ops.bias1[:c], self.conv2_kernel,
                              ops.scale2[:c], ops.bias2[:c],
                              inner_slope=self.inner_slope,
                              outer_slope=self.outer_slope, operands=ops)
        return out.permute(0, 3, 1, 2)


def _flatten_nhwc(x):
    """The DSL's ``flatten`` in the JAX package's order: it flattens NHWC,
    so a ``linear`` after it sees the features as (H, W, C)."""
    if x.ndim == 4:
        x = x.permute(0, 2, 3, 1)
    return x.reshape(x.shape[0], -1)


def _upsample_nearest(x, s: int):
    n, c, h, w = x.shape
    return x[:, :, :, None, :, None].expand(n, c, h, s, w, s).reshape(
        n, c, h * s, w * s)


class SpecSequential(nn.Module):
    """Interpret a layer-spec list (see models/dsl.py).

    Built in eval mode, the painting default; ``.train()`` switches batch
    norm to batch statistics. ``spec=None`` is the identity. With
    ``fused_res_blocks=True`` every canonical residual block becomes a
    ``FusedResBlock`` (K1); the others stay ``ResidualBlock``s, numbered
    apart, as flax numbers them.

    With ``fused_train_conv=True``, in train mode, each (conv | transposed
    conv, batch norm, ReLU) triple with a bias-free conv of at least 8
    output channels runs as one ``conv_bn_relu`` (K4) call when the JAX
    package's shape gate passes on the actual input
    (``baryon_painter_tpu/models/layers.py:491-531``, rules in
    ``ops/conv_rules.py``); the triple's modules and names stay as they are,
    and the batch norm's running statistics move as they would unfused.

    ``dtype`` is every layer's compute dtype (module docstring); a fused
    triple casts x and the conv's weight to it before K4, as the JAX
    package does (``baryon_painter_tpu/models/layers.py:538-551``).

    ``spectral_norm=True`` normalises every convolution, transposed
    convolution and ``linear``, here and in the residual blocks (module
    docstring). As in
    the JAX package it turns the fused residual blocks and the K4 triples
    off (``baryon_painter_tpu/models/layers.py:499, 628``).
    """

    def __init__(self, spec: Optional[Sequence], fused_res_blocks=False,
                 fused_train_conv=False, dtype=None, spectral_norm=False):
        super().__init__()
        fused_res_blocks = fused_res_blocks and not spectral_norm
        fused_train_conv = fused_train_conv and not spectral_norm
        self.spectral_norm = spectral_norm
        self.fused_train_conv = fused_train_conv
        self.layers = nn.ModuleDict()
        self._steps = []   # module names and elementwise callables, in order
        self._triples = {}  # step index of a conv -> what K4 needs of it
        counters = {}
        spec = list(spec or ())
        step_of = []       # the step index each spec entry starts at

        def add(module):
            cls = type(module).__name__
            name = f"{cls}_{counters.get(cls, 0)}"
            counters[cls] = counters.get(cls, 0) + 1
            self.layers[name] = module
            self._steps.append(name)

        for layer in spec:
            step_of.append(len(self._steps))
            name = layer[0]
            config = layer[1] if len(layer) > 1 else None
            lname = name.lower() if isinstance(name, str) else name
            if lname == "conv":
                add(Conv2d(config["in_channels"], config["out_channels"],
                           config["kernel_size"], config.get("stride", 1),
                           config.get("padding", 0), config.get("bias", True),
                           dtype=dtype, spectral_norm=spectral_norm))
            elif lname == "transp conv":
                add(ConvTranspose2d(
                    config["in_channels"], config["out_channels"],
                    config["kernel_size"], config.get("stride", 1),
                    config.get("padding", 0),
                    config.get("output_padding", 0),
                    config.get("bias", True), dtype=dtype,
                    spectral_norm=spectral_norm))
            elif lname == "linear":
                if "in_features" not in config:
                    raise ValueError(
                        f"linear {config}: the port needs in_features (as "
                        f"the reference's nn.Linear does); flax infers it")
                add(Dense(config["in_features"], config["out_features"],
                          config.get("bias", True), dtype=dtype,
                          spectral_norm=spectral_norm))
            elif lname == "flatten":
                self._steps.append(_flatten_nhwc)
            elif lname == "batchnorm":
                add(BatchNorm(config["num_features"], dtype=dtype))
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
                    add(FusedResBlock(inner[0][1]["out_channels"], *slopes,
                                      dtype=dtype))
                else:
                    add(ResidualBlock(inner, act, fused_train_conv, dtype,
                                      spectral_norm))
            elif lname == "upsample nearest":
                s = config["scale"]
                self._steps.append(lambda x, s=s: _upsample_nearest(x, s))
            elif lname == "unflatten":
                # heads split channels explicitly in the models; a no-op
                # marker kept for spec compatibility
                pass
            else:
                raise NotImplementedError(f"Layer {name} not supported yet!")
        for i, layer in enumerate(spec[:-2]):
            kind = str(layer[0]).lower()
            cfg = layer[1] if len(layer) > 1 else None
            if (kind in ("conv", "transp conv")
                    and str(spec[i + 1][0]).lower() == "batchnorm"
                    and str(spec[i + 2][0]).lower() == "relu"
                    and not cfg.get("bias", True)
                    and cfg["out_channels"] >= 8):
                j = step_of[i]
                self._triples[j] = (kind == "transp conv", self._steps[j],
                                    self._steps[j + 1])
        self.eval()

    def _fusable(self, i, x):
        """The K4 triple at step i when it is fused for this input (the
        JAX package's ``_train_conv_fusion`` gate), else None."""
        triple = self._triples.get(i) if (self.fused_train_conv
                                          and self.training) else None
        if triple is None:
            return None
        transposed, conv_name, _ = triple
        conv = self.layers[conv_name]
        k = conv.weight.shape[-1]
        s, p = conv.stride, conv.padding
        if transposed:
            ok = (conv.output_padding == 0
                  and conv_rules.transp_conv_rewrite_applicable(k, s, p, 0)
                  and x.shape[2] * s % 8 == 0)
        else:
            cin, cout = x.shape[1], conv.weight.shape[0]
            ok = (conv_rules.s2d_rewrite_applicable(k, s, p, x.shape[2],
                                                    x.shape[3], cin, 4)
                  and conv_rules.s2d_rewrite_profitable(k, cin, cout, 4))
        return triple if ok else None

    def _fused_train_conv(self, triple, x):
        transposed, conv_name, bn_name = triple
        conv, bn = self.layers[conv_name], self.layers[bn_name]
        dt = conv.dtype or x.dtype
        y, mean, var = conv_bn_relu(x.to(dt), conv.weight.to(dt), bn.weight,
                                    bn.bias, transposed=transposed,
                                    stride=conv.stride, padding=conv.padding,
                                    eps=_BN_EPS)
        bn.update_running(mean, var)
        return y

    def forward(self, x):
        i = 0
        while i < len(self._steps):
            triple = self._fusable(i, x)
            if triple is not None:
                x = self._fused_train_conv(triple, x)
                i += 3   # the conv, its batch norm and its ReLU
                continue
            step = self._steps[i]
            x = self.layers[step](x) if isinstance(step, str) else step(x)
            i += 1
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
