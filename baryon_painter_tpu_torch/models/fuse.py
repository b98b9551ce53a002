"""Checkpoint conversion to the fused-inference parameter layout.

Port of the CVAE half of ``baryon_painter_tpu/models/fuse.py``. Checkpoints
trained with ``fused_res_blocks=False`` (all committed ones) keep each
residual block's weights under ``ResidualBlock_i/SpecSequential_0``; the
fused block (K1) wants them under ``FusedResBlock_c`` with explicit names
(``conv1_kernel``, ``bn1_scale``, ...). Both layouts describe the same
function; this renames the variable tree so any canonical checkpoint paints
through K1 without retraining. Works on the nested numpy dicts that
``train.checkpoint.load_checkpoint`` yields. The CGAN half (spectral-norm
folding) comes with the CGAN painter.
"""
from __future__ import annotations

import copy

from baryon_painter_tpu_torch.models.layers import canonical_res_block_slopes

__all__ = ["fuse_cvae_variables"]

# the CVAE subnets built with the fused_res_blocks flag (the JAX CVAE's
# setup); only these can hold a FusedResBlock
_FUSED_SUBNETS = {
    "q_x_in": "q_x_in",
    "q_y_in": "q_y_in",
    "q_out": "q_x_y_out",
    "p_z_in": "p_z_in",
    "p_y_z_in": "p_y_z_in",
}


def _fuse_subnet(spec, params, stats):
    """Rename canonical residual blocks in one SpecSequential scope.

    Walks the spec in layer order, mirroring flax's per-class counters: the
    i-th residual block overall becomes FusedResBlock_<c> if canonical (c
    counts canonical blocks) and stays ResidualBlock_<n> otherwise (n counts
    the rest) - the names SpecSequential gives with fused_res_blocks=True.
    """
    if spec is None or params is None:
        return params, stats
    params = dict(params)
    stats = dict(stats or {})
    i = c = n = 0
    for layer in spec:
        if str(layer[0]).lower() != "residual block":
            continue
        src = f"ResidualBlock_{i}"
        i += 1
        if canonical_res_block_slopes(layer[1]) is None:
            dst = f"ResidualBlock_{n}"
            n += 1
            if dst != src:  # shift down past converted siblings
                params[dst] = params.pop(src)
                if src in stats:
                    stats[dst] = stats.pop(src)
            continue
        dst = f"FusedResBlock_{c}"
        c += 1
        inner_p = params.pop(src)["SpecSequential_0"]
        params[dst] = {
            "conv1_kernel": inner_p["Conv2d_0"]["kernel"],
            "bn1_scale": inner_p["BatchNorm_0"]["scale"],
            "bn1_bias": inner_p["BatchNorm_0"]["bias"],
            "conv2_kernel": inner_p["Conv2d_1"]["kernel"],
            "bn2_scale": inner_p["BatchNorm_1"]["scale"],
            "bn2_bias": inner_p["BatchNorm_1"]["bias"],
        }
        inner_s = stats.pop(src)["SpecSequential_0"]
        stats[dst] = {
            "bn1_mean": inner_s["BatchNorm_0"]["mean"],
            "bn1_var": inner_s["BatchNorm_0"]["var"],
            "bn2_mean": inner_s["BatchNorm_1"]["mean"],
            "bn2_var": inner_s["BatchNorm_1"]["var"],
        }
    return params, stats


def fuse_cvae_variables(variables: dict, architecture: dict):
    """Convert CVAE variables to the fused-inference layout.

    Returns ``(variables', architecture')``: every canonical residual block's
    parameters renamed into FusedResBlock form, and the architecture with
    ``fused_res_blocks=True``. Array values pass through untouched.
    """
    arch = copy.deepcopy(dict(architecture))
    params = dict(variables.get("params", {}))
    stats = dict(variables.get("batch_stats", {}))
    for attr, key in _FUSED_SUBNETS.items():
        if attr not in params:
            continue
        spec = arch.get(key)
        if spec is None:
            continue
        params[attr], stats_attr = _fuse_subnet(
            spec, params[attr], stats.get(attr))
        if stats_attr:
            stats[attr] = stats_attr
    arch["fused_res_blocks"] = True
    return {"params": params, "batch_stats": stats}, arch
