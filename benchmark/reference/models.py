"""The reference's models: the CVAE's painting and training step and the
CGAN generator's painting, in plain PyTorch over ``nets.apply``, with the
shift-log range compression and its inverse.

Everything is computed here from the configuration file, the inputs the
benchmark made and the raw checkpoint bytes (decoded by this package's own
``msgpack``): the batch norms run unfolded on their running statistics,
the CGAN's spectral norm is folded here (``nets.fold_spectral_norm``), and
the transforms' statistics are interpolated here.
"""
from __future__ import annotations

import json
import math

import numpy as np
import torch

from benchmark.reference import nets
from benchmark.reference.msgpack import msgpack_restore

__all__ = ["load_checkpoint", "FieldTransform", "CVAE_SUBNETS",
           "cvae_params_from_checkpoint", "cgan_params_from_checkpoint",
           "cvae_param_specs", "cvae_paint", "cvae_loss", "cgan_paint",
           "Adam"]

LOG_2PI = math.log(2 * math.pi)

# the CVAE's subnets: (name, the architecture key of its layer list, and
# for the output heads the head's index)
CVAE_SUBNETS = (("q_x_in", "q_x_in", None), ("q_y_in", "q_y_in", None),
                ("q_out", "q_x_y_out", None), ("p_y_in", "p_y_in", None),
                ("p_z_in", "p_z_in", None), ("p_y_z_in", "p_y_z_in", None),
                ("p_mu_out", "p_y_z_out", 0), ("p_var_out", "p_y_z_out", 1),
                ("prior_network", "prior_z_y", None))


def _spec(arch: dict, key: str, head):
    spec = arch.get(key)
    if spec is None:
        return None
    return spec[head] if head is not None else spec


def load_checkpoint(base: str):
    """(state tree, meta) of a checkpoint pair by base path."""
    with open(base + "_state.msgpack", "rb") as f:
        state = msgpack_restore(f.read())
    with open(base + "_meta.json") as f:
        meta = json.load(f)
    return state, meta


class FieldTransform:
    """The shift-log range compression log(max(x/std(z) + 1, eps)) / k of
    one field and its inverse (exp(k x) - 1) std(z), std(z) the square root
    of the field's variance table interpolated linearly in z (clamped at
    the grid's ends), in float64 then rounded to f32."""

    def __init__(self, spec: dict, stats: dict):
        if spec.get("type") != "range_compress" or spec.get(
                "mode") != "shift-log" or spec.get("sqrt_of_mean", False):
            raise NotImplementedError(f"transform {spec}")
        self.k = float(spec["k"])
        self.eps = float(spec.get("eps", 1e-3))
        self.z_grid = np.asarray(stats["z_grid"], np.float64)
        self.var = np.asarray(stats["var"], np.float64)

    def std(self, zs, like: torch.Tensor) -> torch.Tensor:
        z = np.asarray(torch.as_tensor(zs).detach().cpu(), np.float64)
        s = np.sqrt(np.interp(z, self.z_grid, self.var))
        return torch.as_tensor(s, dtype=like.dtype,
                               device=like.device)[:, None, None]

    def forward(self, x, zs):
        return torch.log(torch.clamp(x / self.std(zs, x) + 1,
                                     min=self.eps)) / self.k

    def inverse(self, x, zs):
        return (torch.exp(x * self.k) - 1) * self.std(zs, x)


def _merge_z(y, zs):
    return torch.cat([y, zs.to(y.dtype)[:, None, None, None].expand(
        y.shape[0], 1, *y.shape[2:])], dim=1)


def cvae_params_from_checkpoint(state: dict) -> dict:
    """The CVAE checkpoint's parameters and running statistics as flat f32
    arrays under the reference's names."""
    flat = {}
    for name, _, _ in CVAE_SUBNETS:
        if name in state["params"]:
            flat.update(nets.flax_to_flat(
                state["params"][name], state.get("batch_stats", {}).get(
                    name, {}), f"{name}.layers."))
    return flat


def cgan_params_from_checkpoint(state: dict) -> dict:
    """The CGAN generator's parameters (spectral norm folded) and running
    statistics as flat f32 arrays under the reference's names."""
    flat = {}
    for scope in ("SpecSequential_0", "SpecSequential_1"):
        stats = state.get("g_stats", {}).get(scope, {})
        params = nets.fold_spectral_norm(state["g_params"][scope], stats)
        flat.update(nets.flax_to_flat(params, stats, f"{scope}.layers."))
    return flat


def cvae_param_specs(arch: dict, var_init_std: float = 0.01) -> list:
    """(name, shape, init) of every CVAE parameter and buffer
    (``nets.param_specs``); the variance head's kernels N(0, 0.01^2)."""
    out = []
    for name, key, head in CVAE_SUBNETS:
        out += nets.param_specs(
            _spec(arch, key, head), f"{name}.layers.",
            kernel_init=(("normal", var_init_std) if name == "p_var_out"
                         else ("uniform",)))
    return out


def _run(arch, p, name, x, nm, train):
    for sub, key, head in CVAE_SUBNETS:
        if sub == name:
            return nets.apply(_spec(arch, key, head), p, x,
                              f"{name}.layers.", nm, train)
    raise KeyError(name)


def _split(h):
    c = h.shape[1] // 2
    return h[:, :c], h[:, c:]


def _decode(arch, p, zlat, yz, nm, train):
    """The decoder's two heads: p_z_in(z) beside p_y_in(y, z), the trunk,
    softplus mean and raw log-variance."""
    h = torch.cat([_run(arch, p, "p_z_in", zlat, nm, train),
                   _run(arch, p, "p_y_in", yz, nm, train)], dim=1)
    h = _run(arch, p, "p_y_z_in", h, nm, train)
    return (_run(arch, p, "p_mu_out", h, nm, train),
            _run(arch, p, "p_var_out", h, nm, train))


def cvae_paint(arch: dict, p: dict, y, zs, eps, nm: nets.Numerics):
    """Transformed input y (N, 1, H, W), redshifts (N,), prior noise eps
    (N, Cz, h, w) -> the decoder's mean (N, 1, H, W): z = mu + eps
    (exp(logvar / 2) + min_z_var) from the prior net, batch norm on the
    running statistics."""
    yz = _merge_z(y, zs)
    mu, logvar = _split(_run(arch, p, "prior_network", yz, nm, False))
    zlat = mu + eps.to(mu.dtype) * (torch.exp(logvar / 2)
                                    + arch.get("min_z_var", 1e-7))
    return _decode(arch, p, zlat, yz, nm, False)[0]


def cvae_loss(arch: dict, p: dict, x, y, zs, eps, nm: nets.Numerics):
    """The negative ELBO of a training batch (batch norm on the batch's
    statistics): x (N, 1, H, W) the transformed target, y the transformed
    input, eps (N, Cz, h, w) the latent noise; alpha_var = beta_KL = 1,
    one sample (L = 1)."""
    n = x.shape[0]
    yz = _merge_z(y, zs)
    h = torch.cat([_run(arch, p, "q_x_in", x, nm, True),
                   _run(arch, p, "q_y_in", yz, nm, True)], dim=1)
    z_mu, z_lv = _split(_run(arch, p, "q_out", h, nm, True))
    zlat = z_mu + eps.to(z_mu.dtype) * (torch.exp(z_lv / 2)
                                        + arch.get("min_z_var", 1e-7))
    p_mu, p_lv = _split(_run(arch, p, "prior_network", yz, nm, True))
    p_var = torch.exp(p_lv)
    kl = 0.5 / n * torch.sum((p_mu - z_mu) ** 2 / p_var
                             + torch.exp(z_lv) / p_var + p_lv - z_lv - 1.0)
    x_mu, x_lv = _decode(arch, p, zlat, yz, nm, True)
    sq = (x - x_mu) ** 2
    ll = (-0.5 * LOG_2PI
          + torch.sum(-0.5 * x_lv - 0.5 * sq / torch.exp(x_lv),
                      dim=(0, 2, 3)) / n)
    return kl - arch.get("likelihood_scaling", 1.0) * ll.sum()


def cgan_paint(spec: dict, p: dict, y, zs, nm: nets.Numerics):
    """The CGAN generator: y (N, 1, H, W) beside the map z - 1, its body and
    its head, batch norm on the running statistics."""
    h = _merge_z(y, zs - 1.0)
    h = nets.apply(spec["body"], p, h, "SpecSequential_0.layers.", nm)
    return nets.apply(spec["head"], p, h, "SpecSequential_1.layers.", nm)


class Adam:
    """Adam (b1, b2, eps = 1e-8, bias-corrected), the step lr times the
    negative of m_hat / (sqrt(v_hat) + eps), over a dict of tensors."""

    def __init__(self, params: dict, b1=0.9, b2=0.999, eps=1e-8):
        self.b1, self.b2, self.eps = b1, b2, eps
        self.m = {k: torch.zeros_like(v) for k, v in params.items()}
        self.v = {k: torch.zeros_like(v) for k, v in params.items()}
        self.t = 0

    @torch.no_grad()
    def step(self, params: dict, grads: dict, lr: float):
        self.t += 1
        c1 = 1 - self.b1 ** self.t
        c2 = 1 - self.b2 ** self.t
        for k, g in grads.items():
            self.m[k].mul_(self.b1).add_((1 - self.b1) * g)
            self.v[k].mul_(self.b2).add_((1 - self.b2) * g * g)
            params[k].sub_(lr * (self.m[k] / c1)
                           / (torch.sqrt(self.v[k] / c2) + self.eps))
