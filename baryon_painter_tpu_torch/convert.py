"""Weights carried across between the JAX package's variables and the port's
modules, both ways, and the port's own initialisation.

``from_jax_variables(variables, architecture)`` takes ``{"params",
"batch_stats"}`` as nested dicts of numpy arrays (what
``train.checkpoint.load_checkpoint`` yields, or ``jax.tree.map(np.asarray,
...)`` of live flax variables) and returns an eval-mode ``CVAE`` carrying
them; ``load_jax_variables`` loads them into an existing one.
``generator_from_jax_variables(variables, architecture)`` does the same for
the CGAN generator, with flax's spectral norm folded into its kernels.
``to_jax_variables`` goes the other way (the port's parameters, or their
gradients, in the flax layout, as numpy), so the two packages can be
compared. ``train_state_to_jax`` and ``train_state_from_jax`` carry a
trainer's whole state, Adam's moments included, to and from the JAX
trainer's checkpoint tree; ``gan_state_to_jax`` and ``gan_state_from_jax``
do the same for the CGAN trainer's (``g_params``, ``g_stats``, ``g_opt``,
``d_params``, ``d_stats``, ``d_opt``, ``step``). ``init_cvae``,
``init_cgan`` and ``init_discriminator`` draw the port's own initial
weights from the distributions the JAX package initialises with, on a
seeded ``torch.Generator``. The same functions serve the CVAE, the CGAN's
generator and its discriminator (a model's ``jax_scopes`` names its flax
scopes). Layer names match flax's per-class auto-names, so the mapping is
one to one:

  * conv kernels HWIO <-> OIHW;
  * transposed-conv kernels: spatial flip plus HWIO <-> IOHW, because the JAX
    package computes a transposed conv as an lhs-dilated correlation and
    PyTorch applies its weight as the gradient of a conv;
  * dense (the DSL's ``linear``) kernels (in, out) <-> ``nn.Linear``'s
    (out, in); the DSL's ``flatten`` flattens in flax's NHWC order, so the
    features a kernel's rows index are the same in both;
  * batch norm scale/bias and running mean/var;
  * PReLU slopes;
  * fused residual blocks keep their HWIO kernels (K1 takes HWIO);
  * a spectrally normalised layer's u and sigma (``sn_u``, ``sn_sigma``)
    sit in the scope's batch statistics under ``SpectralNorm_k`` (k counts
    the scope's convs, transposed convs and dense layers together) as
    flat names,
    ``"Conv2d_0/kernel/u"`` and ``"Conv2d_0/kernel/sigma"``, as flax's
    ``SpectralNorm`` keeps them.
"""
from __future__ import annotations

import copy
import math

import numpy as np
import torch

from baryon_painter_tpu_torch.models.cgan import (CGANDiscriminator,
                                                  CGANGenerator)
from baryon_painter_tpu_torch.models.cvae import CVAE
from baryon_painter_tpu_torch.models.fuse import fold_cgan_spectral_norm
from baryon_painter_tpu_torch.models.layers import (BatchNorm, Conv2d,
                                                    ConvTranspose2d, Dense,
                                                    FusedResBlock, PReLU,
                                                    ResidualBlock,
                                                    SpecSequential)

__all__ = ["from_jax_variables", "load_jax_variables", "load_spec_sequential",
           "generator_from_jax_variables", "to_jax_variables", "init_cvae",
           "init_cgan", "init_discriminator", "trainable",
           "train_state_to_jax", "train_state_from_jax", "adam_state_to_jax",
           "adam_state_from_jax", "gan_state_to_jax", "gan_state_from_jax"]

# the CVAE's subnets, by their flax scope names
_CVAE_SUBNETS = ("q_x_in", "q_y_in", "q_out", "p_y_in", "p_z_in", "p_y_z_in",
                 "p_mu_out", "p_var_out", "prior_network")


def _scopes(model) -> tuple:
    """The flax scopes of a model's variables: the CGAN networks name
    theirs (``jax_scopes``), the CVAE's are its subnets."""
    return getattr(model, "jax_scopes", _CVAE_SUBNETS)


def _sn_layers(seq: SpecSequential):
    """(``SpectralNorm_k`` scope, layer name, layer) of each spectrally
    normalised layer of one scope, in flax's order."""
    layers = [(n, m) for n, m in seq.layers.items()
              if getattr(m, "spectral_norm", False)
              and isinstance(m, (Conv2d, ConvTranspose2d, Dense))]
    return [(f"SpectralNorm_{k}", n, m) for k, (n, m) in enumerate(layers)]


def _copy(dst: torch.Tensor, a):
    a = np.asarray(a, dtype=np.float32)
    if tuple(a.shape) != tuple(dst.shape):
        raise ValueError(f"shape mismatch: checkpoint {a.shape} vs module "
                         f"{tuple(dst.shape)}")
    # copy: flips give negative strides, and decoded leaves are read-only
    dst.copy_(torch.from_numpy(np.array(a, copy=True)))


@torch.no_grad()
def load_spec_sequential(seq: SpecSequential, params: dict, stats: dict):
    """Copy one flax SpecSequential scope into its torch twin."""
    params = params or {}
    stats = stats or {}
    for name, m in seq.layers.items():
        p, s = params[name], stats.get(name, {})
        if isinstance(m, Conv2d):
            _copy(m.weight, np.asarray(p["kernel"]).transpose(3, 2, 0, 1))
            if m.bias is not None:
                _copy(m.bias, p["bias"])
        elif isinstance(m, ConvTranspose2d):
            k = np.asarray(p["kernel"])
            _copy(m.weight, k[::-1, ::-1].transpose(2, 3, 0, 1))
            if m.bias is not None:
                _copy(m.bias, p["bias"])
        elif isinstance(m, Dense):
            _copy(m.weight, np.asarray(p["kernel"]).T)
            if m.bias is not None:
                _copy(m.bias, p["bias"])
        elif isinstance(m, BatchNorm):
            _copy(m.weight, p["scale"])
            _copy(m.bias, p["bias"])
            _copy(m.running_mean, s["mean"])
            _copy(m.running_var, s["var"])
        elif isinstance(m, PReLU):
            _copy(m.weight, p["negative_slope"])
        elif isinstance(m, ResidualBlock):
            load_spec_sequential(m.SpecSequential_0, p["SpecSequential_0"],
                                 s.get("SpecSequential_0", {}))
        elif isinstance(m, FusedResBlock):
            for key in ("conv1_kernel", "conv2_kernel", "bn1_scale",
                        "bn1_bias", "bn2_scale", "bn2_bias"):
                _copy(getattr(m, key), p[key])
            for key in ("bn1_mean", "bn1_var", "bn2_mean", "bn2_var"):
                _copy(getattr(m, key), s[key])
        else:
            raise NotImplementedError(f"no weight mapping for {name}")
    for scope, name, m in _sn_layers(seq):
        _copy(m.sn_u, stats[scope][f"{name}/kernel/u"])
        _copy(m.sn_sigma, stats[scope][f"{name}/kernel/sigma"])


def load_jax_variables(model, variables: dict):
    """Load JAX-layout ``{"params", "batch_stats"}`` into ``model`` (a
    CVAE, or a CGAN generator or discriminator)."""
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    for attr in _scopes(model):
        seq = getattr(model, attr)
        if seq is None or not seq.layers:
            continue
        load_spec_sequential(seq, params.get(attr), stats.get(attr))
    return model


def from_jax_variables(variables: dict, architecture: dict,
                       fused_heads: bool = False, dtype=None) -> CVAE:
    """An eval-mode CVAE (on the CPU) carrying the JAX variables, computing
    in ``dtype`` (``CVAE``'s). The weights stay f32 whatever the dtype, as
    the JAX package keeps them, so a bf16 JAX model's variables load
    unchanged."""
    model = CVAE(architecture, fused_heads=fused_heads, dtype=dtype)
    return load_jax_variables(model, variables).eval()


def generator_from_jax_variables(variables: dict, architecture: dict,
                                 dtype=None) -> CGANGenerator:
    """An eval-mode ``CGANGenerator`` (on the CPU) carrying the JAX
    generator's ``{"params", "batch_stats"}`` (a checkpoint's ``g_params``
    and ``g_stats``), computing in ``dtype``. Spectral norm, where the
    variables carry its state, is folded into the kernels first
    (``models/fuse.fold_cgan_spectral_norm``); ``architecture``'s
    ``fused_res_blocks`` says which layout the variables are in."""
    variables = fold_cgan_spectral_norm(variables)
    gen = CGANGenerator(
        in_channels=architecture.get("in_channels", 2),
        n_res_blocks=architecture.get("n_res_blocks", 9),
        upsample=architecture.get("upsample", "transpose"),
        fused_res_blocks=architecture.get("fused_res_blocks", False),
        dtype=dtype)
    params, stats = variables["params"], variables["batch_stats"]
    for name in ("SpecSequential_0", "SpecSequential_1"):
        load_spec_sequential(getattr(gen, name), params[name],
                             stats.get(name))
    return gen.eval()


def _np(t):
    return t.detach().cpu().numpy().astype(np.float32)


def _export_spec_sequential(seq: SpecSequential, value, params, stats):
    """Inverse of ``load_spec_sequential``: ``value(param)`` is exported
    (the parameter itself, or its gradient), running statistics with it
    into ``stats``."""
    for name, m in seq.layers.items():
        if isinstance(m, (Conv2d, ConvTranspose2d, Dense)):
            w = _np(value(m.weight))
            k = (w.T if isinstance(m, Dense)
                 else w.transpose(2, 3, 1, 0) if isinstance(m, Conv2d)
                 else w.transpose(2, 3, 0, 1)[::-1, ::-1])
            p = {"kernel": np.ascontiguousarray(k)}
            if m.bias is not None:
                p["bias"] = _np(value(m.bias))
            params[name] = p
        elif isinstance(m, BatchNorm):
            params[name] = {"scale": _np(value(m.weight)),
                            "bias": _np(value(m.bias))}
            stats[name] = {"mean": _np(m.running_mean),
                           "var": _np(m.running_var)}
        elif isinstance(m, PReLU):
            params[name] = {"negative_slope": _np(value(m.weight))}
        elif isinstance(m, ResidualBlock):
            p, s = {}, {}
            _export_spec_sequential(m.SpecSequential_0, value, p, s)
            params[name] = {"SpecSequential_0": p}
            if s:
                stats[name] = {"SpecSequential_0": s}
        else:
            raise NotImplementedError(f"no export for {name}")
    for scope, name, m in _sn_layers(seq):
        stats.setdefault(scope, {}).update({
            f"{name}/kernel/sigma": _np(m.sn_sigma),
            f"{name}/kernel/u": _np(m.sn_u)})


def to_jax_variables(model, grads: bool = False, value=None) -> dict:
    """The model's ``{"params", "batch_stats"}`` in the flax layout, as
    nested numpy dicts; with ``grads=True`` the parameters' gradients in
    place of the parameters (a parameter without one exports as zeros);
    with ``value`` what it maps each parameter to."""
    if grads:
        value = lambda p: p.grad if p.grad is not None else torch.zeros_like(p)
    elif value is None:
        value = lambda p: p
    params, stats = {}, {}
    for attr in _scopes(model):
        seq = getattr(model, attr)
        if seq is None or not seq.layers:
            continue
        p, s = {}, {}
        _export_spec_sequential(seq, value, p, s)
        params[attr] = p
        if s:
            stats[attr] = s
    return {"params": params, "batch_stats": stats}


def trainable(model) -> list:
    """The model's trainable parameters, in the order the trainer's
    optimizer keeps its moments."""
    return [p for p in model.parameters() if p.requires_grad]


def adam_state_to_jax(model, mu, nu, count: int) -> dict:
    """Adam's state as optax's ``chain(scale_by_adam, scale)`` state,
    ``{"0": {"count", "mu", "nu"}, "1": {}}``. ``mu`` and ``nu`` (aligned
    with ``trainable(model)``) take the parameters' layout map: Adam's
    moments are elementwise, so a transposed conv's are flipped as its
    kernel is."""
    params = trainable(model)

    def moments(tensors):
        by_id = {id(p): t for p, t in zip(params, tensors)}
        return to_jax_variables(model, value=lambda p: by_id[id(p)])[
            "params"]

    return {"0": {"count": np.asarray(count, np.int32),
                  "mu": moments(mu), "nu": moments(nu)},
            "1": {}}


def adam_state_from_jax(model, adam: dict, stats: dict) -> dict:
    """optax's Adam state (``adam_state_to_jax``'s layout) in the port's
    terms: ``{"mu", "nu"}`` as lists aligned with ``trainable(model)``, on
    the model's device, and ``count`` as an int; ``stats`` are the model's
    batch statistics in the same tree (a twin of the model loads them)."""
    twin = copy.deepcopy(model)
    out = {}
    for key in ("mu", "nu"):
        load_jax_variables(twin, {"params": adam["0"][key],
                                  "batch_stats": stats})
        out[key] = [p.detach().clone() for p in trainable(twin)]
    out["count"] = int(adam["0"]["count"])
    return out


def train_state_to_jax(model: CVAE, mu, nu, count: int, step: int) -> dict:
    """A trainer's state as the JAX trainer's checkpoint tree: the model's
    ``params`` and ``batch_stats``, ``step``, and ``opt_state``
    (``adam_state_to_jax``)."""
    variables = to_jax_variables(model)
    return {"params": variables["params"],
            "batch_stats": variables["batch_stats"],
            "step": np.asarray(step, np.int32),
            "opt_state": adam_state_to_jax(model, mu, nu, count)}


def train_state_from_jax(model: CVAE, state: dict) -> dict:
    """Load a JAX trainer's checkpoint tree into ``model`` (``params`` and
    ``batch_stats``) and return its optimizer state in the port's terms:
    ``{"mu", "nu"}`` as lists aligned with ``trainable(model)`` (on the
    model's device; absent without ``opt_state``), ``count`` and ``step``
    as ints."""
    load_jax_variables(model, state)
    out = {"step": int(state["step"])}
    if "opt_state" in state:
        out.update(adam_state_from_jax(model, state["opt_state"],
                                       state["batch_stats"]))
    return out


def gan_state_to_jax(generator: CGANGenerator,
                     discriminator: CGANDiscriminator, g_adam: tuple,
                     d_adam: tuple, step: int) -> dict:
    """A CGAN trainer's state as the JAX ``GANTrainState``'s checkpoint
    tree: each network's ``*_params`` and ``*_stats`` (batch norm and
    spectral norm) and its Adam state ``*_opt`` from ``(mu, nu, count)``,
    and ``step``."""
    out = {"step": np.asarray(step, np.int32)}
    for net, model, adam in (("g", generator, g_adam),
                             ("d", discriminator, d_adam)):
        v = to_jax_variables(model)
        out[f"{net}_params"] = v["params"]
        out[f"{net}_stats"] = v["batch_stats"]
        out[f"{net}_opt"] = adam_state_to_jax(model, *adam)
    return out


def gan_state_from_jax(generator: CGANGenerator,
                       discriminator: CGANDiscriminator, state: dict) -> dict:
    """Load a CGAN checkpoint tree into both networks and return
    ``{"step"}`` and, for each network whose Adam state the tree holds,
    ``"g"`` / ``"d"``: ``adam_state_from_jax``'s dict (a tree without
    ``step`` is at step 0)."""
    out = {"step": int(state.get("step", 0))}
    for net, model in (("g", generator), ("d", discriminator)):
        stats = state.get(f"{net}_stats", {})
        load_jax_variables(model, {"params": state[f"{net}_params"],
                                   "batch_stats": stats})
        if f"{net}_opt" in state:
            out[net] = adam_state_from_jax(model, state[f"{net}_opt"], stats)
    return out


def _uniform_(t, bound, gen):
    t.copy_((torch.rand(t.shape, generator=gen) * 2 - 1) * bound)


@torch.no_grad()
def _init_spec_sequential(seq: SpecSequential, gen: torch.Generator,
                          kernel=("uniform",)):
    """Initialise one scope: kernels by ``kernel`` (``("uniform",)``
    PyTorch's U(+-1/sqrt(fan_in)), ``("normal", std)``, ``("kaiming",)``
    N(0, 2/fan_in), ``("xavier", gain)`` U(+-gain sqrt(6/(k^2 (C_in +
    C_out))))), biases U(+-1/sqrt(fan_in)), batch norm scale 1, bias 0,
    mean 0, var 1, PReLU 0.25, spectral norm u ~ N(0, 1) and sigma 1; a
    residual block's inner scope with the uniform kernels, as the JAX
    package's ``ResidualBlock`` builds it; a dense layer as flax's
    ``nn.Dense`` defaults: ``lecun_normal`` (a normal of variance 1/fan_in
    truncated at 2 standard deviations, rescaled) and a zero bias."""
    for m in seq.layers.values():
        if isinstance(m, Dense):
            # flax's variance_scaling(1, "fan_in", "truncated_normal")
            std = math.sqrt(1.0 / m.weight.shape[1]) / .87962566103423978
            torch.nn.init.trunc_normal_(m.weight, std=std, a=-2 * std,
                                        b=2 * std, generator=gen)
            if m.bias is not None:
                m.bias.zero_()
            if m.spectral_norm:
                m.sn_u.copy_(torch.randn(m.sn_u.shape, generator=gen))
                m.sn_sigma.fill_(1.0)
            continue
        if isinstance(m, (Conv2d, ConvTranspose2d)):
            k = m.weight.shape[-1]
            cin, cout = ((m.weight.shape[1], m.weight.shape[0])
                         if isinstance(m, Conv2d)
                         else (m.weight.shape[0], m.weight.shape[1]))
            bound = 1.0 / math.sqrt(k * k * cin)
            if kernel[0] == "uniform":
                _uniform_(m.weight, bound, gen)
            elif kernel[0] == "xavier":
                _uniform_(m.weight, kernel[1] * math.sqrt(
                    6.0 / (k * k * (cin + cout))), gen)
            else:
                std = (kernel[1] if kernel[0] == "normal"
                       else math.sqrt(2.0 / (k * k * cin)))
                m.weight.copy_(std * torch.randn(m.weight.shape,
                                                 generator=gen))
            if m.bias is not None:
                _uniform_(m.bias, bound, gen)
            if m.spectral_norm:
                m.sn_u.copy_(torch.randn(m.sn_u.shape, generator=gen))
                m.sn_sigma.fill_(1.0)
        elif isinstance(m, BatchNorm):
            m.weight.fill_(1.0)
            m.bias.fill_(0.0)
            m.running_mean.fill_(0.0)
            m.running_var.fill_(1.0)
        elif isinstance(m, PReLU):
            m.weight.fill_(0.25)
        elif isinstance(m, ResidualBlock):
            _init_spec_sequential(m.SpecSequential_0, gen)
        else:
            raise NotImplementedError(f"no initialisation for {type(m)}")


def init_cvae(model: CVAE, seed: int = 0) -> CVAE:
    """Draw the model's initial weights (on the CPU) as the JAX package
    does: conv and transposed-conv kernels and biases U(-b, b) with
    b = 1/sqrt(k*k*C_in) (PyTorch's default, ``torch_conv_init``), the
    variance head's kernels N(0, x_var_init_std^2) (default 0.01,
    ``_normal_init``), batch norm scale 1, bias 0, running mean 0 and
    variance 1, PReLU slopes 0.25. The draws come from a
    ``torch.Generator`` seeded with ``seed``: the same distributions as
    JAX's, not the same numbers."""
    gen = torch.Generator().manual_seed(seed)
    std = model.architecture.get("x_var_init_std", 0.01)
    for attr in _CVAE_SUBNETS:
        seq = getattr(model, attr)
        if seq is None:
            continue
        _init_spec_sequential(seq, gen, kernel=(("normal", std)
                                                if attr == "p_var_out"
                                                else ("uniform",)))
    return model


def _init_cgan_network(model, gen: torch.Generator):
    # the JAX models' kernel_init: Kaiming-normal for the body, Xavier
    # uniform with gain 0.25 for the head (baryon_painter_tpu/models/
    # cgan.py:120-126, :145-150)
    _init_spec_sequential(model.SpecSequential_0, gen, kernel=("kaiming",))
    _init_spec_sequential(model.SpecSequential_1, gen,
                          kernel=("xavier", 0.25))
    return model


def init_discriminator(discriminator: CGANDiscriminator,
                       seed: int = 0) -> CGANDiscriminator:
    """Draw the discriminator's initial weights (on the CPU) as the JAX
    package does (``init_cgan``), from a ``torch.Generator`` seeded
    ``seed``."""
    return _init_cgan_network(discriminator,
                              torch.Generator().manual_seed(seed))


def init_cgan(generator: CGANGenerator, discriminator: CGANDiscriminator,
              seed: int = 0) -> tuple:
    """Draw both CGAN networks' initial weights (on the CPU) as the JAX
    package does (``baryon_painter_tpu/models/layers.py:46-61``): the body
    kernels Kaiming-normal, N(0, 2/(k*k*C_in)), the residual blocks' inner
    kernels U(+-1/sqrt(k*k*C_in)) (the JAX ``ResidualBlock`` passes no
    kernel initialiser), the heads' kernels Xavier-uniform with gain 0.25,
    the conv biases U(+-1/sqrt(k*k*C_in)), spectral norm u from N(0, 1) and
    sigma 1, batch norm scale 1, bias 0, mean 0 and var 1. One
    ``torch.Generator`` seeded ``seed`` draws the generator's, then the
    discriminator's: the same distributions as JAX's, not the same
    numbers."""
    gen = torch.Generator().manual_seed(seed)
    return (_init_cgan_network(generator, gen),
            _init_cgan_network(discriminator, gen))
