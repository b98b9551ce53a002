"""Conditional VAE, NCHW: painting and the training ELBO.

Port of ``baryon_painter_tpu/models/cvae.py``: the recognition net Q(z|x,y),
the prior net p(z|y), the latent draw z = mu + eps*(exp(logvar/2) +
min_z_var), the generator P(x|y,z) with its optional predicted variance,
the redshift merged as a constant feature map, and the ELBO of
``CVAE.__call__`` term for term (``forward``). Subnets carry the JAX module's
attribute names (``q_x_in``, ``q_out``, ``prior_network``, ``p_z_in``,
``p_y_z_in``, ``p_mu_out``, ...) so checkpoints map onto them one to one.

``fused_heads=True`` is the counterpart of the JAX package's
``BPT_FUSED_HEADS=1``: where both output heads have the canonical shape
(``_heads_fusable``, the JAX gate), they run through K3
(``ops/head_stack.py``) in training and in painting alike.
``fused_train_conv=True`` is the counterpart of ``BPT_FUSED_TRAIN_CONV=1``:
every subnet runs its gated train-mode (conv, batch norm, ReLU) triples
through K4 (``ops/conv_bn.py``, ``SpecSequential``); in the fiducial
architecture those are ``p_y_z_in``'s input conv and its three up-convs,
in the model's dtype (in bf16 with u and the batch statistics f32, as the
JAX kernel keeps them). Both switches are off by default, as in the JAX
package.

``dtype`` is the JAX package's compute dtype (``CVAE(..., dtype=
jnp.bfloat16)``): every subnet's convolutions and the activations between
them run in it, with the JAX package's rounding points
(``models/layers.py``); the latent heads' KL and reparameterisation and the
likelihood terms stay f32 in training, and the painted prior sample is
drawn in the latent's dtype. Parameters and their gradients stay f32.
``None`` is f32, bit for bit as without it. ``torch.float64`` with the
parameters in f64 (``.double()``) computes the whole ELBO in f64, the KL
and the likelihood terms too: the reference a training step is held to.

The model is built in eval mode (painting); ``.train()`` switches batch norm
to batch statistics for ``forward``.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
from torch import nn

from baryon_painter_tpu_torch.models import dsl
from baryon_painter_tpu_torch.models.layers import (SpecSequential,
                                                    merge_aux_label,
                                                    softplus)
from baryon_painter_tpu_torch.ops.head_stack import head_stack
from baryon_painter_tpu_torch.utils import profiling

__all__ = ["CVAE", "fiducial_cvae_architecture", "count_parameters",
           "print_model_statistics", "stats_from_outputs"]

LOG_2PI = math.log(2 * math.pi)


def _strip_unflatten(spec):
    if spec is None:
        return None
    return [l for l in spec if str(l[0]).lower() != "unflatten"]


class CVAE(nn.Module):
    """CVAE built from the architecture dict of a checkpoint."""

    def __init__(self, architecture: dict, fused_heads: bool = False,
                 fused_train_conv: bool = False, dtype=None):
        super().__init__()
        arch = architecture
        if arch.get("type", "Type-1") != "Type-1":
            raise NotImplementedError(
                f"Architecture {arch.get('type')} not supported yet!")
        self.architecture = arch
        self.fused_heads = fused_heads
        self.dtype = dtype
        self.dim_z = tuple(arch["dim_z"])  # channel-first (C,H,W)
        self.L = arch.get("L", 1)
        self.use_aux_label = arch.get("aux_label", False)
        self.min_z_var = arch.get("min_z_var", 1e-7)
        self.likelihood_scaling = arch.get("likelihood_scaling", 1.0)

        fused = arch.get("fused_res_blocks", False)
        seq = lambda spec, res=False: SpecSequential(
            _strip_unflatten(spec), fused_res_blocks=res,
            fused_train_conv=fused_train_conv, dtype=dtype)
        mk = lambda key: seq(arch.get(key), fused)
        self.q_x_in = mk("q_x_in")
        self.q_y_in = mk("q_y_in")
        self.q_out = mk("q_x_y_out")
        self.p_y_in = seq(arch.get("p_y_in"))
        self.p_z_in = mk("p_z_in")
        self.p_y_z_in = mk("p_y_z_in")
        self.p_mu_out = seq(arch["p_y_z_out"][0])
        self.predict_var = len(arch["p_y_z_out"]) > 1
        self.p_var_out = (
            seq(arch["p_y_z_out"][1])
            if self.predict_var else None)
        self.prior_network = (
            seq(arch["prior_z_y"])
            if arch.get("prior_z_y") is not None else None)
        self.eval()

    def _merge_aux(self, y, aux_label):
        if aux_label is not None and self.use_aux_label:
            return merge_aux_label(y, aux_label)
        return y

    def _split_heads(self, h):
        """(N,2*Cz,H,W) -> z_mu, z_log_var each (N,Cz,H,W)."""
        cz = self.dim_z[0]
        if h.shape[1] != 2 * cz:
            raise ValueError(
                f"Head produced {h.shape[1]} channels, expected {2 * cz} "
                f"for dim_z={self.dim_z}.")
        return h[:, :cz], h[:, cz:]

    def Q(self, x, y, aux_label=None):
        """(z_mu, z_log_var) of the recognition net q(z|x,y)."""
        y = self._merge_aux(y, aux_label)
        h = torch.cat([self.q_x_in(x), self.q_y_in(y)], dim=1)
        return self._split_heads(self.q_out(h))

    def prior(self, y, aux_label=None):
        """(z_mu, z_log_var) of p(z|y); zeros without a prior net."""
        if self.prior_network is None:
            cz, hz, wz = self.dim_z
            z = torch.zeros((y.shape[0], cz, hz, wz), dtype=y.dtype,
                            device=y.device)
            return z, z
        y = self._merge_aux(y, aux_label)
        return self._split_heads(self.prior_network(y))

    def sample_z(self, z_mu, z_log_var, eps):
        """Reparameterized sample z = mu + eps*(exp(logvar/2) + min_z_var),
        in z_mu's dtype. ``eps`` is standard normal noise of z_mu's shape,
        or (L, *z_mu.shape) for L samples, returned as (L*N, ...) with the
        sample index major."""
        z = z_mu + eps * (torch.exp(z_log_var / 2) + self.min_z_var)
        return z.reshape(-1, *z_mu.shape[1:])

    def _heads_fusable(self, h) -> bool:
        """Both output heads match the canonical (conv k7, prelu, conv k5,
        prelu, conv k3[, softplus]) pattern at the shapes the JAX package
        fuses (its ``_heads_fusable``, whose %4 is its space-to-depth radix:
        kept so that the same configurations take the fused path). K3
        computes exactly two heads: any other count of ``p_y_z_out`` specs
        stays unfused."""
        if not self.fused_heads or not self.predict_var:
            return False
        if len(self.architecture["p_y_z_out"]) != 2:
            return False
        if h.shape[2] % 4 or h.shape[3] % 4 or h.shape[2] < 32:
            return False
        # _fused_heads hardcodes the trailing activations: softplus on head
        # 0 (mu), raw conv output on head 1 (log-var)
        tails = (["softplus"], [])
        for spec, tail in zip(self.architecture["p_y_z_out"], tails):
            names = [str(l[0]).lower() for l in spec]
            if names[:5] != ["conv", "prelu", "conv", "prelu", "conv"]:
                return False
            if names[5:] != tail:
                return False
            convs = [l[1] for l in spec if l[0] == "conv"]
            ks = [c["kernel_size"] for c in convs]
            ps = [c["padding"] for c in convs]
            ss = [c.get("stride", 1) for c in convs]
            if (ks, ps, ss) != ([7, 5, 3], [3, 2, 1], [1, 1, 1]):
                return False
            if any(c.get("bias", True) for c in convs):
                return False
            if [c["out_channels"] for c in convs] != [8, 1, 1]:
                return False
        return True

    def _fused_heads(self, h):
        """Both output heads through K3, reading the parameters of the
        unfused heads' modules (so the parameters are the same either way).
        Softplus on head 0 and the identity on head 1 stay outside; both
        come back in h's dtype, as K3 computes in it."""
        heads = (self.p_mu_out.layers, self.p_var_out.layers)
        hwio = lambda w: w.permute(2, 3, 1, 0)
        w1, w2, w3 = (torch.stack([hwio(m[name].weight) for m in heads])
                      for name in ("Conv2d_0", "Conv2d_1", "Conv2d_2"))
        alphas = torch.stack([torch.stack([m["PReLU_0"].weight,
                                           m["PReLU_1"].weight])
                              for m in heads])
        out = head_stack(h.permute(0, 2, 3, 1).contiguous(), w1, w2, w3,
                         alphas)
        return (softplus(out[:, 0:1]).to(h.dtype),
                out[:, 1:2].to(h.dtype))

    def P(self, z, y, aux_label=None, L: int = 1):
        """Decoder: (x_mu, x_log_var) or (x_mu,), each (L*N,C_x,H,W)."""
        y = self._merge_aux(y, aux_label)
        h_y = self.p_y_in(y).repeat(L, 1, 1, 1)
        h = torch.cat([self.p_z_in(z), h_y], dim=1)
        h = self.p_y_z_in(h)
        with profiling.span("decode.heads"):
            if self._heads_fusable(h):
                return self._fused_heads(h)
            x_mu = self.p_mu_out(h)
            if self.predict_var:
                return x_mu, self.p_var_out(h)
            return (x_mu,)

    def forward(self, x, y, aux_label=None, alpha_var: float = 1.0,
                beta_KL: float = 1.0, sample_weight=None, eps=None,
                generator: Optional[torch.Generator] = None,
                batch_rows: Optional[Tuple[int, int]] = None) -> dict:
        """ELBO and its terms, as the JAX ``CVAE.__call__`` computes them.

        x: (N,C_x,H,W) transformed target field(s); y: (N,C_y,H,W) input.
        ``eps``: the latent noise, (L, N, Cz, hz, wz) (or (N, Cz, hz, wz)
        for L = 1); drawn from ``generator`` when not given.
        ``sample_weight``: optional (N,) weights of each sample's KL and
        log-likelihood. ``batch_rows`` = (lo, B): these N rows are rows
        lo..lo+N of a global batch of B split over ranks (a data-parallel
        step): the terms are normalised by B, so the ranks' terms sum to
        the global batch's, and drawn noise is rows lo..lo+N of the draw
        for B rows. Returns a dict: elbo, kl, log_likelihood (per output
        channel), x_mu, and with a predicted variance
        log_likelihood_fixed_var, log_likelihood_free_var and x_var."""
        M = x.shape[0]
        lo = 0
        if batch_rows is not None:
            lo, M = batch_rows
        L = self.L
        z_mu, z_log_var = self.Q(x, y, aux_label)
        # the KL and the reparameterisation in f32, as in the JAX package
        # (in f64 for an f64 model: the reference step)
        acc = torch.float64 if self.dtype == torch.float64 else torch.float32
        z_mu, z_log_var = z_mu.to(acc), z_log_var.to(acc)
        if eps is None:
            eps = torch.randn((L, M, *z_mu.shape[1:]), generator=generator,
                              dtype=z_mu.dtype, device=z_mu.device
                              )[:, lo:lo + x.shape[0]]
        eps = torch.as_tensor(eps, dtype=z_mu.dtype, device=z_mu.device)
        z = self.sample_z(z_mu, z_log_var, eps.reshape(L, *z_mu.shape))

        prior_mu, prior_log_var = self.prior(y, aux_label)
        prior_mu, prior_log_var = prior_mu.to(acc), prior_log_var.to(acc)
        prior_var = torch.exp(prior_log_var)
        kl_elem = ((prior_mu - z_mu) ** 2 / prior_var
                   + torch.exp(z_log_var) / prior_var
                   + prior_log_var - z_log_var - 1.0)
        w = None
        if sample_weight is not None:
            w = torch.as_tensor(sample_weight, dtype=acc,
                                device=x.device)
            kl = 0.5 / M * torch.sum(w * kl_elem.sum(dim=(1, 2, 3)))
        else:
            kl = 0.5 / M * torch.sum(kl_elem)

        params = self.P(z, y, aux_label, L=L)
        x_mu = params[0]
        sq = (x.repeat(L, 1, 1, 1) - x_mu.to(x.dtype)) ** 2
        norm = M * L
        # the constant term, this process's share of it (all of it unless
        # batch_rows splits the batch)
        const = -0.5 * LOG_2PI * (x.shape[0] / M)
        if w is not None:
            w_rep = w.repeat(L)[:, None, None, None].to(x.dtype)
            wsum = lambda t: (w_rep * t).sum(dim=(0, 2, 3))
        else:
            wsum = lambda t: t.sum(dim=(0, 2, 3))
        out = {"kl": kl}
        if self.predict_var:
            x_log_var = params[1].to(x.dtype)
            x_var = torch.exp(x_log_var)
            ll_fixed = const + wsum(-0.5 * sq) / norm
            ll_free = const + wsum(
                -0.5 * x_log_var - 0.5 * sq / x_var) / norm
            ll = (1 - alpha_var) * ll_fixed + alpha_var * ll_free
            out.update(log_likelihood_fixed_var=ll_fixed,
                       log_likelihood_free_var=ll_free, x_var=x_var)
        else:
            ll = const + wsum(-0.5 * sq) / norm
        out["log_likelihood"] = ll
        out["x_mu"] = x_mu
        out["elbo"] = -kl * beta_KL + self.likelihood_scaling * ll.sum()
        return out

    def sample_prior(self, y, aux_label=None, eps=None,
                     generator: Optional[torch.Generator] = None,
                     batch_rows: Optional[Tuple[int, int]] = None):
        """A latent drawn from the prior p(z|y): noise ``eps``, else drawn
        from ``generator``, in the latent's dtype (with ``batch_rows`` =
        (lo, B), rows lo..lo+N of the draw for B rows, as in ``forward``)."""
        z_mu, z_log_var = self.prior(y, aux_label)
        if eps is None:
            lo, n = batch_rows or (0, z_mu.shape[0])
            eps = torch.randn((n, *z_mu.shape[1:]), generator=generator,
                              dtype=z_mu.dtype, device=z_mu.device
                              )[lo:lo + z_mu.shape[0]]
        return self.sample_z(z_mu, z_log_var, torch.as_tensor(
            eps, dtype=z_mu.dtype, device=z_mu.device))

    def sample_P(self, y, aux_label=None, z=None, eps=None,
                 generator: Optional[torch.Generator] = None,
                 return_var: bool = False,
                 batch_rows: Optional[Tuple[int, int]] = None):
        """Paint: draw z from the prior (``sample_prior``) unless ``z`` is
        given, and decode."""
        if z is None:
            z = self.sample_prior(y, aux_label, eps=eps, generator=generator,
                                  batch_rows=batch_rows)
        p = self.P(z, y, aux_label)
        if return_var and self.predict_var:
            return p[0], torch.exp(p[1])
        return p[0]

    def get_stats_labels(self):
        """The training-statistics columns: ELBO, KL term and the
        likelihood terms per output feature (the JAX ``CVAE``'s)."""
        n_x = self.architecture["n_x_features"]
        predict_var = len(self.architecture["p_y_z_out"]) > 1
        labels = ["ELBO", "KL_term"] + [
            f"log_likelihood_{i}" for i in range(n_x)]
        if predict_var:
            labels += [f"log_likelihood_fixed_var_{i}" for i in range(n_x)]
            labels += [f"log_likelihood_free_var_{i}" for i in range(n_x)]
        return labels


def _flat_params(params, prefix=()) -> dict:
    """{("scope", "layer", "kernel"): array} of a nested parameter dict."""
    out = {}
    for k, v in params.items():
        if isinstance(v, dict):
            out.update(_flat_params(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _jax_params(params) -> dict:
    """A model's parameters in the flax layout (``convert.to_jax_variables``,
    flax's names), or a JAX-layout ``params`` dict as it is."""
    if isinstance(params, nn.Module):
        from baryon_painter_tpu_torch.convert import to_jax_variables
        return to_jax_variables(params)["params"]
    return params


def count_parameters(params) -> int:
    """Total trainable parameter count (cvae.py:182-183 equivalent) of a
    model, or of a JAX-layout ``params`` dict."""
    return sum(int(np.prod(np.shape(p)))
               for p in _flat_params(_jax_params(params)).values())


def print_model_statistics(params, percentile: float = 0.9):
    """Parameter-count distribution report (cvae.py:185-194 equivalent) of
    a model or a JAX-layout ``params`` dict, under the flax paths (for
    example ``p_y_z_in/Conv2d_0/kernel``): the JAX package's text, line
    for line."""
    flat = _flat_params(_jax_params(params))
    sizes = sorted(((int(np.prod(np.shape(p))), "/".join(k))
                    for k, p in flat.items()), reverse=True)
    total = sum(n for n, _ in sizes)
    print(f"Total number of parameters: {total}")
    print(f"Top {percentile * 100:.0f}% of all parameters are in the "
          f"following layers")
    cum = 0
    for n, name in sizes:
        if cum >= total * percentile:
            break
        cum += n
        print(f"{name:<60s} {n:>10d}")
    return total


def stats_from_outputs(out: dict) -> tuple:
    """Flatten a CVAE output dict (``CVAE.forward``'s) to the reference
    stats tuple order (cvae.py:164-171): (ELBO, -KL, *ll[, *ll_fixed,
    *ll_free]), as host floats."""
    host = lambda t: torch.as_tensor(t).detach().float().reshape(-1).cpu()
    vals = [float(host(out["elbo"])[0]), -float(host(out["kl"])[0])]
    vals += [float(v) for v in host(out["log_likelihood"])]
    if "log_likelihood_fixed_var" in out:
        vals += [float(v) for v in host(out["log_likelihood_fixed_var"])]
        vals += [float(v) for v in host(out["log_likelihood_free_var"])]
    return tuple(vals)


def fiducial_cvae_architecture(tile_size: int = 512, n_scale: int = 1,
                               n_aux_label: int = 1, n_label_fields: int = 1,
                               n_res_blocks: int = 4,
                               predict_var: bool = True,
                               fused_res_blocks: bool = False,
                               upsample: str = "transpose") -> dict:
    """The fiducial architecture, parameterized by tile size (fully
    convolutional: dim_z scales with it); the JAX package's function."""
    n_x = n_label_fields * n_scale
    dim_x = (n_x, tile_size, tile_size)
    dim_y = (n_scale, tile_size, tile_size)
    dim_z = (1, tile_size // 32, tile_size // 32)

    p_y_z_out_mu = (
        dsl.conv_block(16, 8, kernel=7, bias=False, batchnorm=False,
                       activation="PReLU")
        + dsl.conv_block(8, n_x, kernel=5, bias=False, batchnorm=False,
                         activation="PReLU")
        + dsl.conv_block(n_x, n_x, kernel=3, bias=False, batchnorm=False,
                         activation="softplus"))
    p_y_z_out = [p_y_z_out_mu]
    if predict_var:
        p_y_z_out.append(
            dsl.conv_block(16, 8, kernel=7, bias=False, batchnorm=False,
                           activation="PReLU")
            + dsl.conv_block(8, n_x, kernel=5, bias=False, batchnorm=False,
                             activation="PReLU")
            + dsl.conv_block(n_x, n_x, kernel=3, bias=False, batchnorm=False,
                             activation=None))

    return {
        "type": "Type-1",
        "dim_x": dim_x,
        "dim_y": dim_y,
        "dim_z": dim_z,
        "n_x_features": n_x,
        "aux_label": True,
        "prior_z_y": (dsl.conv_down(in_channel=n_scale + n_aux_label,
                                    channels=[8, 16, 32], scales=[2, 4, 4])
                      + dsl.conv_block(32, 2 * dim_z[0], kernel=5)),
        "q_x_in": dsl.conv_down(in_channel=n_x, channels=[8, 16, 32],
                                scales=[2, 4, 4]),
        "q_y_in": dsl.conv_down(in_channel=n_scale + n_aux_label,
                                channels=[8, 16, 32], scales=[2, 4, 4]),
        "q_x_y_out": dsl.conv_block(64, 2 * dim_z[0], kernel=5),
        "p_y_in": None,
        "p_z_in": dsl.conv_up(1, channels=[1, 1, 1], scales=[2, 4, 4],
                              bias=False, batchnorm=True, mode=upsample),
        "p_y_z_in": (dsl.conv_block(n_aux_label + n_scale + 1, 16, kernel=5)
                     + dsl.conv_down(in_channel=16, channels=[32, 64, 128],
                                     scales=[2, 2, 2])
                     + [("residual block", dsl.res_block(128))
                        for _ in range(n_res_blocks)]
                     + dsl.conv_up(128, channels=[64, 32, 16],
                                   scales=[2, 2, 2], bias=False,
                                   batchnorm=True, activation="ReLU",
                                   mode=upsample)),
        "p_y_z_out": tuple(p_y_z_out),
        "min_x_var": 1e-7,
        "min_z_var": 1e-7,
        "L": 1,
        "fused_res_blocks": fused_res_blocks,
    }
