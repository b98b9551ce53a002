"""Checkpoint conversion to the fused-inference parameter layout.

Port of the CVAE half of ``baryon_painter_tpu/models/fuse.py``. Checkpoints
trained with ``fused_res_blocks=False`` (all committed ones) keep each
residual block's weights under ``ResidualBlock_i/SpecSequential_0``; the
fused block (K1) wants them under ``FusedResBlock_c`` with explicit names
(``conv1_kernel``, ``bn1_scale``, ...). Both layouts describe the same
function; this renames the variable tree so any canonical checkpoint paints
through K1 without retraining. Works on the nested numpy dicts that
``train.checkpoint.load_checkpoint`` yields.

The CGAN half folds flax's spectral normalisation into the generator's
kernels (``fold_spectral_norm``): at eval flax's ``SpectralNorm`` runs one
power iteration from the stored ``u`` on every call and divides the kernel
by the sigma that iteration gives, so the fold replicates that iteration
(``sn_sigma_from_u``), not the stored ``sigma``.
"""
from __future__ import annotations

import copy

import numpy as np

from baryon_painter_tpu_torch.models.cgan import cgan_generator_spec
from baryon_painter_tpu_torch.models.layers import canonical_res_block_slopes

__all__ = ["fuse_cvae_variables", "sn_sigma_from_u", "fold_spectral_norm",
           "fold_cgan_spectral_norm", "fuse_cgan_generator_variables"]

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


# --------------------------------------------------------------------- #
# CGAN generator: spectral-norm folding + fused residual blocks

_SN_EPS = 1e-12   # flax.linen.SpectralNorm's epsilon


def _l2_normalize(x):
    """flax's ``_l2_normalize``: x * rsqrt(sum(x^2) + eps), in f32."""
    return x * np.float32(1.0 / np.sqrt(np.float32((x * x).sum())
                                        + np.float32(_SN_EPS)))


def sn_sigma_from_u(kernel, u, n_steps: int = 1) -> float:
    """flax's eval-time sigma of a spectrally normalised kernel: the kernel
    reshaped to (fan_in, C_out) in flax's layout (HWIO for a conv and for
    a transposed conv alike), ``n_steps`` power iterations from the stored
    u (1, C_out), then sigma = v W u^T; 1 where that is 0, as flax divides
    by 1 there."""
    w = np.asarray(kernel, np.float32).reshape(-1, np.shape(kernel)[-1])
    u0 = np.asarray(u, np.float32)
    for _ in range(n_steps):
        v0 = _l2_normalize(u0 @ w.T)
        u0 = _l2_normalize(v0 @ w)
    sigma = float((v0 @ w @ u0.T)[0, 0])
    return sigma if sigma != 0 else 1.0


def fold_spectral_norm(params: dict, stats: dict):
    """Divide every spectrally normalised kernel in one module scope by its
    sigma, recursing through nested scopes (``ResidualBlock_k``); returns
    ``(params', stats')`` without the SpectralNorm state. A
    ``SpectralNorm_k`` scope holds flat slash-joined names
    (``"Conv2d_0/kernel/u"``, ``".../sigma"``) that address the parameter
    in the sibling params. The kernels stay f32: flax's SpectralNorm
    computes in f32 and the layer casts the result to its dtype after."""
    params = dict(params)
    out_stats = {}
    for key, sub in (stats or {}).items():
        if not key.startswith("SpectralNorm_"):
            if key in params and isinstance(params[key], dict):
                params[key], sub = fold_spectral_norm(params[key], sub)
            out_stats[key] = sub
            continue
        for var_name, u in sub.items():
            if not var_name.endswith("/u"):
                continue
            *path, param_name, _ = var_name.split("/")
            node = params
            for part in path[:-1]:
                node[part] = dict(node[part])
                node = node[part]
            layer = dict(node[path[-1]])
            kernel = np.asarray(layer[param_name], np.float32)
            layer[param_name] = kernel / np.float32(sn_sigma_from_u(kernel, u))
            node[path[-1]] = layer
    return params, out_stats


_CGAN_SEQS = ("SpecSequential_0", "SpecSequential_1")


def fold_cgan_spectral_norm(variables: dict) -> dict:
    """The generator's ``{"params", "batch_stats"}`` with the spectral norm
    of both its scopes folded into the kernels (a copy without
    SpectralNorm state; unchanged values where there is none)."""
    params = dict(variables.get("params", {}))
    stats = dict(variables.get("batch_stats", {}))
    for seq in _CGAN_SEQS:
        if seq in params:
            params[seq], stats_seq = fold_spectral_norm(params[seq],
                                                        stats.get(seq))
            if stats_seq or seq in stats:
                stats[seq] = stats_seq
    return {"params": params, "batch_stats": stats}


def fuse_cgan_generator_variables(variables: dict, architecture: dict):
    """Convert CGAN generator variables to the fused-inference layout.

    Folds the spectral norm (``fold_cgan_spectral_norm``) and renames the
    body's canonical LeakyReLU residual blocks into FusedResBlock form.
    Returns ``(variables', generator_kwargs)``: build the generator with
    ``CGANGenerator(**generator_kwargs)`` (``fused_res_blocks=True`` and
    the architecture's own fields)."""
    kwargs = {"in_channels": architecture.get("in_channels", 2),
              "n_res_blocks": architecture.get("n_res_blocks", 9),
              "upsample": architecture.get("upsample", "transpose")}
    body_spec, _ = cgan_generator_spec(**kwargs)
    folded = fold_cgan_spectral_norm(variables)
    params, stats = folded["params"], folded["batch_stats"]
    params["SpecSequential_0"], stats_body = _fuse_subnet(
        body_spec, params["SpecSequential_0"], stats.get("SpecSequential_0"))
    if stats_body:
        stats["SpecSequential_0"] = stats_body
    return ({"params": params, "batch_stats": stats},
            {**kwargs, "fused_res_blocks": True})
