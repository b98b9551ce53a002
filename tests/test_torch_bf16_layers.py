"""The bf16 configuration's rounding points, layer by layer and module by
module, against the JAX package's ``dtype=jnp.bfloat16``.

* Dtype trace: for a small bf16 CVAE (``fiducial_cvae_architecture(64,
  n_res_blocks=1)``) the dtype of every submodule's output in painting
  (``sample_P``) and in the train-mode forward equals the JAX model's
  (flax ``capture_intermediates``; the port's forward hooks), with the
  heads unfused and fused. 49 of them are bf16; ``p_y_in`` (the identity)
  passes the f32 input on.
* Single layers and short stacks in bf16 on the same seeded input and
  weights give the JAX package's result run op by op (its source's
  rounding points) to at most ``FLIP_FRACTION`` of the outputs, each off by
  one bf16 step: a sum that lands next to a rounding boundary may round
  the other way when summed in another order. Under ``jax.jit`` XLA on the
  CPU drops the rounding of a convolution's bf16 output where a batch norm
  casts it to f32 (27 % of those outputs differ by one step from the
  package's op-by-op result); the port keeps the source's rounding point.
* The port's own rules: PyTorch's CPU bf16 convolution is not used (it is
  wrong at some shapes), f32 stays f32 bit for bit, a bf16 model with
  ``fused_train_conv=True`` routes its K4 sites through ``conv_bn_relu``
  in bf16.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import traverse_util

from baryon_painter_tpu.models import cvae as jcvae
from baryon_painter_tpu.models import dsl as jdsl
from baryon_painter_tpu.models import layers as jlayers
from baryon_painter_tpu_torch.convert import (from_jax_variables,
                                              load_spec_sequential)
from baryon_painter_tpu_torch.models import layers as tlayers
from baryon_painter_tpu_torch.models.cvae import (CVAE,
                                                  fiducial_cvae_architecture)

BF16 = jnp.bfloat16
# outputs that may differ by one bf16 step between the port and the JAX
# package: sums in another order round the other way near a boundary
FLIP_FRACTION = 2e-3


def _cvae_variables(arch, tile, seed=0):
    model = jcvae.CVAE(arch, dtype=BF16)
    rng = np.random.default_rng(seed)
    x = jnp.asarray(rng.standard_normal((2, tile, tile, 1)), jnp.float32)
    v = model.init({"params": jax.random.PRNGKey(seed),
                    "sample": jax.random.PRNGKey(1)}, x, x,
                   jnp.zeros(2, jnp.float32), train=False)
    return model, jax.tree.map(np.asarray, v), rng


def _jax_dtypes(intermediates):
    out = {}
    for k, val in traverse_util.flatten_dict(intermediates).items():
        if k[-1] != "__call__" or len(k) < 2:
            continue
        a = val[0] if isinstance(val, tuple) else val
        if hasattr(a, "dtype"):
            out["/".join(k[:-1])] = str(a.dtype)
    return out


def _port_dtypes(model, run):
    seen, hooks = {}, []
    for name, m in model.named_modules():
        if not name:
            continue
        key = name.replace(".layers.", "/").replace(".", "/")

        def hook(mod, inp, out, key=key):
            if isinstance(out, torch.Tensor):
                seen[key] = str(out.dtype).replace("torch.", "")
        hooks.append(m.register_forward_hook(hook))
    try:
        run()
    finally:
        for h in hooks:
            h.remove()
    return seen


@pytest.mark.parametrize("fused_heads", [False, True],
                         ids=["heads_unfused", "heads_fused"])
@pytest.mark.parametrize("mode", ["sample_P", "train_forward"])
def test_module_output_dtypes_match_the_jax_package(mode, fused_heads,
                                                    monkeypatch):
    monkeypatch.setenv("BPT_FUSED_HEADS", "1" if fused_heads else "0")
    tile = 64
    arch = fiducial_cvae_architecture(tile, n_res_blocks=1)
    jmodel, v, rng = _cvae_variables(arch, tile)
    y = rng.standard_normal((2, tile, tile, 1)).astype(np.float32)
    x = rng.standard_normal((2, tile, tile, 1)).astype(np.float32)
    zs = np.array([0.0, 1.0], np.float32)
    model = from_jax_variables(v, arch, fused_heads=fused_heads,
                               dtype=torch.bfloat16)
    t = lambda a: torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()
    if mode == "sample_P":
        _, st = jmodel.apply(v, y, zs, train=False,
                             rngs={"sample": jax.random.PRNGKey(7)},
                             method=jmodel.sample_P,
                             capture_intermediates=True,
                             mutable=["intermediates"])
        port = _port_dtypes(model, lambda: model.sample_P(
            t(y), torch.from_numpy(zs)))
    else:
        _, st = jmodel.apply(v, x, y, zs, train=True,
                             rngs={"sample": jax.random.PRNGKey(7)},
                             capture_intermediates=True,
                             mutable=["intermediates", "batch_stats"])
        model.train()
        port = _port_dtypes(model, lambda: model(t(x), t(y),
                                                 torch.from_numpy(zs)))
    want = _jax_dtypes(st["intermediates"])
    assert len(want) >= 20
    assert {k: port.get(k) for k in want} == want
    assert want["p_y_in"] == "float32"
    assert sum(d == "bfloat16" for d in want.values()) == len(want) - 1


def _spec_pair(spec, x, seed=0):
    """The JAX package's SpecSequential in bf16 on x (NHWC) with seeded
    parameters and batch statistics, run op by op, and the port's with the
    same weights, both in eval mode; outputs as f32 numpy NHWC."""
    jm = jlayers.SpecSequential(tuple(map(tuple, spec)), dtype=BF16)
    v = jm.init(jax.random.PRNGKey(seed), jnp.asarray(x), train=False)
    rng = np.random.default_rng(seed)
    v = jax.tree.map(
        lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(
            np.float32), v)
    v["batch_stats"] = jax.tree.map(np.abs, v.get("batch_stats", {}))
    want = jm.apply(v, jnp.asarray(x), train=False)
    tm = tlayers.SpecSequential(spec, dtype=torch.bfloat16)
    load_spec_sequential(tm, v["params"], v.get("batch_stats", {}))
    got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    return (np.asarray(want.astype(jnp.float32)),
            got.detach().float().permute(0, 2, 3, 1).numpy(),
            str(want.dtype), str(got.dtype).replace("torch.", ""))


def _conv(ci, co, k=3, s=1, p=1, bias=False, kind="conv"):
    return (kind, {"in_channels": ci, "out_channels": co, "kernel_size": k,
                   "stride": s, "padding": p, "bias": bias})


SPECS = {
    "conv": [_conv(8, 8)],
    "conv_bias": [_conv(8, 8, bias=True)],
    "conv_stride2": [_conv(8, 16, k=4, s=2, p=1)],
    "conv_stride4_8to16": [_conv(8, 16, k=8, s=4, p=2)],
    "transposed_stride2": [_conv(8, 8, k=4, s=2, p=1, kind="transp conv")],
    "transposed_stride4": [_conv(8, 4, k=8, s=4, p=2, kind="transp conv")],
    "batchnorm": [("batchnorm", {"num_features": 8})],
    "conv_bn_relu": jdsl.conv_block(8, 16, kernel=5),
    "prelu_chain": (jdsl.conv_block(8, 8, kernel=7, batchnorm=False,
                                    activation="PReLU")
                    + jdsl.conv_block(8, 1, kernel=5, batchnorm=False,
                                      activation="PReLU")),
    "softplus_head": jdsl.conv_block(8, 1, kernel=3, batchnorm=False,
                                     activation="softplus"),
    "residual_block": [("residual block", jdsl.res_block(8))],
}


@pytest.mark.parametrize("name", list(SPECS))
def test_layers_round_where_the_jax_package_rounds(name):
    x = np.random.default_rng(1).standard_normal((2, 64, 64, 8)).astype(
        np.float32)
    want, got, jdt, tdt = _spec_pair(SPECS[name], x)
    assert tdt == jdt
    assert got.shape == want.shape
    differ = np.mean(got != want)
    assert differ <= FLIP_FRACTION, (name, differ)
    # a flip moves an output by a bf16 step (or the next layer's outputs
    # computed from it): far below the rounding of the whole stack
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel <= 1e-3, (name, rel)


def test_bf16_is_not_f32():
    """The same stack in f32 is another result: the bf16 layers round."""
    x = np.random.default_rng(2).standard_normal((2, 32, 32, 8)).astype(
        np.float32)
    spec = jdsl.conv_block(8, 16, kernel=5) + jdsl.conv_block(16, 8)
    f32 = tlayers.SpecSequential(spec)
    bf = tlayers.SpecSequential(spec, dtype=torch.bfloat16)
    with torch.no_grad():
        for p in f32.parameters():
            p.uniform_(0.5, 1.5) if p.ndim == 1 else p.uniform_(-0.2, 0.2)
    bf.load_state_dict(f32.state_dict())
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    a, b = f32(xt), bf(xt)
    assert a.dtype == torch.float32 and b.dtype == torch.bfloat16
    rel = ((a - b.float()).norm() / a.norm()).item()
    assert 1e-4 < rel < 5e-2


def test_cpu_bf16_convolution_of_pytorch_is_not_used():
    """PyTorch's CPU bf16 convolution misses a stride-4 8 -> 16 conv at
    64^2 by about 100 %; the port's bf16 layers compute it in f32 on the
    bf16 values and round once, which is exact to a bf16 step."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 8, 64, 64, generator=g).relu().bfloat16()
    w = (torch.randn(16, 8, 8, 8, generator=g) * 0.05).bfloat16()
    exact = F.conv2d(x.double(), w.double(), stride=4, padding=2)
    conv = tlayers.Conv2d(8, 16, 8, stride=4, padding=2, bias=False,
                          dtype=torch.bfloat16)
    with torch.no_grad():
        conv.weight.copy_(w.float())
    got = conv(x.float())
    assert got.dtype == torch.bfloat16
    rel = ((got.double() - exact).norm() / exact.norm()).item()
    assert rel < 4e-3


def test_f32_layers_are_unchanged_by_the_dtype_argument():
    """``dtype=None`` and ``dtype=torch.float32`` are the f32 path, bit for
    bit."""
    spec = (jdsl.conv_block(4, 8, kernel=5, bias=True)
            + jdsl.conv_block(8, 8, type="transp conv", scale=2)
            + [("residual block", jdsl.res_block(8))]
            + jdsl.conv_block(8, 1, kernel=3, batchnorm=False,
                              activation="softplus"))
    torch.manual_seed(0)
    a = tlayers.SpecSequential(spec)
    b = tlayers.SpecSequential(spec, dtype=torch.float32)
    with torch.no_grad():
        for p in a.parameters():
            p.uniform_(-0.3, 0.3)
    b.load_state_dict(a.state_dict())
    x = torch.randn(2, 4, 16, 16)
    assert torch.equal(a(x), b(x))
    a.train(), b.train()
    assert torch.equal(a(x), b(x))


def test_fused_train_conv_in_bf16_raises(monkeypatch):
    """The name is kept from when K4 had no bf16 kernels and this
    configuration raised. It no longer does: a bf16 CVAE builds with
    ``fused_train_conv=True``, and at 128^2 its ``p_y_z_in`` in train mode
    routes the four sites (the 5x5 input conv, the three up-convs) through
    ``conv_bn_relu`` with bf16 x and weight and f32 batch-norm parameters,
    and returns bf16; f32 builds as before."""
    arch = fiducial_cvae_architecture(128, n_res_blocks=1)
    model = CVAE(arch, fused_train_conv=True, dtype=torch.bfloat16)
    assert all(m.fused_train_conv for m in model.modules()
               if isinstance(m, tlayers.SpecSequential))
    calls, real = [], tlayers.conv_bn_relu

    def counting(x, w, gamma, beta, **kw):
        calls.append((kw["transposed"], int(gamma.shape[0]), x.dtype,
                      w.dtype, gamma.dtype))
        return real(x, w, gamma, beta, **kw)

    monkeypatch.setattr(tlayers, "conv_bn_relu", counting)
    x = torch.randn(2, 3, 128, 128, generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        y = model.p_y_z_in.train()(x)
    bf, f32 = torch.bfloat16, torch.float32
    assert calls == [(t, c, bf, bf, f32) for t, c in
                     ((False, 16), (True, 64), (True, 32), (True, 16))]
    assert y.dtype == bf
    CVAE(arch, fused_train_conv=True)                   # f32: as before
    CVAE(arch, fused_train_conv=True, dtype=torch.float32)


def test_prelu_slope_is_cast_to_x_dtype():
    """A 0-dim f32 tensor does not promote a bf16 tensor in PyTorch, but a
    one-element 1-dim one does; the port casts the slope explicitly, as the
    JAX package does."""
    p = tlayers.PReLU()
    x = torch.tensor([-1.0, 2.0], dtype=torch.bfloat16)
    assert p(x).dtype == torch.bfloat16
    assert p(x.float()).dtype == torch.float32


def test_softplus_rounds_after_each_operation_as_jax():
    x = (torch.randn(4096, generator=torch.Generator().manual_seed(0))
         * 3).bfloat16()
    want = np.asarray(jax.nn.softplus(jnp.asarray(x.float().numpy()).astype(
        BF16)).astype(jnp.float32))
    got = tlayers.softplus(x)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    # torch's own bf16 softplus rounds once: another result
    assert np.mean(F.softplus(x).float().numpy() != want) > 0.05
    # its gradient is JAX's g * exp(x - softplus(x)), in bf16
    xr = x.clone().requires_grad_()
    tlayers.softplus(xr).backward(torch.ones_like(xr))
    jg = jax.grad(lambda v: jnp.sum(jax.nn.softplus(v).astype(jnp.float32)))(
        jnp.asarray(x.float().numpy()).astype(BF16))
    np.testing.assert_array_equal(xr.grad.float().numpy(),
                                  np.asarray(jg.astype(jnp.float32)))
