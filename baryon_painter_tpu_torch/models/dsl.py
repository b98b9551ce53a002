"""Declarative architecture DSL: list-of-tuples layer specs.

Keeps the exact semantic keys and helper signatures of the reference's dict
DSL (models/utils.py:40-157) so fiducial configs port 1:1:

    conv_block(in, out, type, scale, kernel, bias, batchnorm, activation)
    res_block(n_channel)
    conv_down(in, channels, scales, **kw)  /  conv_up(...)

scale in {1, 2, 4} maps to (kernel, padding, stride) = (k, (k-1)/2, 1),
(4, 1, 2), (8, 2, 4) exactly as models/utils.py:40-51. Specs are plain
tuples/dicts (JSON-able) interpreted by ``layers.SpecSequential``.
"""
from __future__ import annotations

__all__ = ["conv_block", "res_block", "conv_down", "conv_up"]


def conv_block(in_channel, out_channel, type="conv", scale=1, kernel=3,
               bias=False, batchnorm=True, activation="relu", relu_slope=0.2):
    if scale == 1:
        if kernel % 2 != 1:
            raise ValueError("Kernel with scale=1 should be odd.")
        kps = {"kernel_size": kernel, "padding": (kernel - 1) // 2, "stride": 1}
    elif scale == 2:
        kps = {"kernel_size": 4, "padding": 1, "stride": 2}
    elif scale == 4:
        kps = {"kernel_size": 8, "padding": 2, "stride": 4}
    else:
        raise NotImplementedError(f"Scaling {scale} not supported yet!")

    arch = [(type, {"in_channels": in_channel, "out_channels": out_channel,
                    **kps, "bias": bias})]
    if batchnorm:
        arch.append(("batchnorm", {"num_features": out_channel}))

    if activation is None or str(activation).lower() == "none":
        pass
    elif activation.lower() == "relu":
        arch.append(("ReLU",))
    elif activation.lower() == "leaky relu":
        arch.append(("Leaky ReLU", relu_slope))
    elif activation.lower() == "prelu":
        arch.append(("prelu",))
    elif activation.lower() == "tanh":
        arch.append(("tanh",))
    elif activation.lower() == "sigmoid":
        arch.append(("sigmoid",))
    elif activation.lower() == "softplus":
        arch.append(("softplus",))
    else:
        raise NotImplementedError(f"Activation {activation} not supported yet!")
    return arch


def res_block(n_channel, activation="ReLU"):
    inner = (conv_block(n_channel, n_channel, kernel=3, bias=False,
                        batchnorm=True, activation="relu")
             + conv_block(n_channel, n_channel, kernel=3, bias=False,
                          batchnorm=True, activation=None))
    return (inner, (activation,))


def conv_down(in_channel, channels, scales, **kw_args):
    arch = conv_block(in_channel, channels[0], scale=scales[0], **kw_args)
    for i in range(1, len(channels)):
        arch += conv_block(channels[i - 1], channels[i], scale=scales[i], **kw_args)
    return arch


def conv_up(in_channel, channels, scales, mode="transpose", **kw_args):
    """Upsampling stack. mode='transpose' mirrors the reference (strided
    transposed convs); mode='resize' uses nearest-neighbour resize + odd-kernel
    conv, which cannot produce checkerboard artifacts (useful because the
    transposed-conv decoder's high-k hash is the slowest thing to train away
    - see scripts/fidelity_check.py)."""
    if mode == "transpose":
        arch = conv_block(in_channel, channels[0], type="transp conv",
                          scale=scales[0], **kw_args)
        for i in range(1, len(channels)):
            arch += conv_block(channels[i - 1], channels[i],
                               type="transp conv", scale=scales[i], **kw_args)
        return arch
    if mode != "resize":
        raise ValueError(f"Unknown conv_up mode '{mode}'.")
    arch = []
    prev = in_channel
    for ch, sc in zip(channels, scales):
        if sc > 1:
            arch.append(("upsample nearest", {"scale": sc}))
        arch += conv_block(prev, ch, type="conv", scale=1, kernel=3,
                           **kw_args)
        prev = ch
    return arch
