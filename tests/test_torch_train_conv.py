"""The train-mode triple fusion (``SpecSequential(..., fused_train_conv=True)``,
K4) against the JAX package's ``BPT_FUSED_TRAIN_CONV=1`` on the CPU.

Gate: on the fiducial ``p_y_z_in`` the port fuses exactly the triples the
JAX package fuses, counted by wrapping each side's fused function: at 32^2
tiles the three up-convs only (the input conv fails the space-to-depth
rule's h >= 128), at 128^2 the input conv too.

Layer: ``p_y_z_in`` with one residual block at 128^2, batch 2, from the same
flax-initialised weights and random running statistics, fused (all four
sites) and unfused on both sides. The output and the updated running
statistics: port fused against JAX fused, rtol/atol 1e-4 (f32 sums in
another order; the JAX kernels run in interpret mode). Gradients of a seeded
cotangent: the fusion is exact on each side (fused against unfused, each
parameter to 1e-4 of its largest entry), and port fused against JAX fused
differs per parameter by no more than port unfused against JAX unfused, plus
1e-4 of the parameter's largest entry. The cross-framework gradients are held
to that baseline rather than to a fixed tolerance because at this size one
ReLU pre-activation (|v| = 6.9e-7 after the first up-conv's batch norm)
takes different branches in the two frameworks' f32 sums, which moves every
gradient upstream of it by up to 1.4e-3 of the largest gradient entry,
fused or not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import baryon_painter_tpu.ops.pallas_conv_bn as jax_k4
from baryon_painter_tpu.models.layers import SpecSequential as FlaxSeq
from baryon_painter_tpu_torch.convert import load_spec_sequential
from baryon_painter_tpu_torch.models import layers as tl
from baryon_painter_tpu_torch.models.cvae import (CVAE,
                                                  fiducial_cvae_architecture)
from test_torch_train_layers import (_assert_trees_close, _export,
                                     _random_stats)

TOL = dict(rtol=1e-4, atol=1e-4)


def _spec(tile, n_res_blocks=1):
    arch = fiducial_cvae_architecture(tile, n_res_blocks=n_res_blocks)
    return arch["p_y_z_in"]


def _pair(tile, batch, monkeypatch, seed=0, fused=True):
    """Both sides of p_y_z_in in train mode, the fusion on or off, each
    fused call recorded as (transposed, output channels)."""
    spec = _spec(tile)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((batch, tile, tile, 3)).astype(np.float32)
    fseq = FlaxSeq(tuple(map(tuple, spec)))
    variables = fseq.init(jax.random.PRNGKey(seed), jnp.asarray(x),
                          train=False)
    params = jax.tree.map(np.asarray, variables["params"])
    stats = _random_stats(jax.tree.map(np.asarray,
                                       variables["batch_stats"]), rng)
    calls = {"jax": [], "port": []}
    jax_fused, port_fused = jax_k4.fused_conv_bn_relu, tl.conv_bn_relu

    def jax_counting(x_, w2, gamma, beta, in_radix, out_radix, *a):
        calls["jax"].append((in_radix == 0, int(gamma.shape[0])))
        return jax_fused(x_, w2, gamma, beta, in_radix, out_radix, *a)

    def port_counting(x_, w, gamma, beta, **kw):
        calls["port"].append((kw["transposed"], int(gamma.shape[0])))
        return port_fused(x_, w, gamma, beta, **kw)

    monkeypatch.setattr(jax_k4, "fused_conv_bn_relu", jax_counting)
    monkeypatch.setattr(tl, "conv_bn_relu", port_counting)
    monkeypatch.setenv("BPT_FUSED_TRAIN_CONV", "1" if fused else "0")

    def fwd(p, xx):
        return fseq.apply({"params": p, "batch_stats": stats}, xx,
                          train=True, mutable=["batch_stats"])

    tseq = tl.SpecSequential(spec, fused_train_conv=fused)
    load_spec_sequential(tseq, params, stats)
    tseq.train()
    return dict(x=x, fwd=fwd, params=params, tseq=tseq, calls=calls, rng=rng)


@pytest.mark.parametrize("tile,want", [
    (32, [(True, 64), (True, 32), (True, 16)]),
    (128, [(False, 16), (True, 64), (True, 32), (True, 16)]),
], ids=["32", "128"])
def test_the_port_fuses_the_sites_jax_fuses(tile, want, monkeypatch):
    r = _pair(tile, 2, monkeypatch)
    r["fwd"](r["params"], jnp.asarray(r["x"]))
    with torch.no_grad():
        r["tseq"](torch.from_numpy(r["x"].transpose(0, 3, 1, 2).copy()))
    assert r["calls"]["jax"] == want
    assert r["calls"]["port"] == want


def test_no_fusion_in_eval_mode_or_with_the_switch_off():
    seq = tl.SpecSequential(_spec(128), fused_train_conv=True)
    # candidates: the input conv, the three stride-2 down convs (which the
    # shape gate refuses) and the three up-convs
    assert sorted(seq._triples) == [0, 3, 6, 9, 13, 16, 19]
    x = torch.zeros(1, 3, 128, 128)
    assert all(seq._fusable(i, x) is None for i in seq._triples)  # eval
    assert seq.train()._fusable(0, x) is not None
    assert seq._fusable(3, torch.zeros(1, 16, 128, 128)) is None
    off = tl.SpecSequential(_spec(128)).train()
    assert all(off._fusable(i, x) is None for i in off._triples)


def test_cvae_passes_the_switch_to_every_subnet():
    model = CVAE(fiducial_cvae_architecture(32, n_res_blocks=1),
                 fused_train_conv=True)
    seqs = [m for m in model.modules() if isinstance(m, tl.SpecSequential)]
    assert seqs and all(m.fused_train_conv for m in seqs)
    default = CVAE(fiducial_cvae_architecture(32, n_res_blocks=1))
    assert not any(m.fused_train_conv for m in default.modules()
                   if isinstance(m, tl.SpecSequential))


def _layer_run(fused, monkeypatch):
    r = _pair(128, 2, monkeypatch, seed=1, fused=fused)
    x = jnp.asarray(r["x"])
    y, upd = r["fwd"](r["params"], x)
    cot = r["rng"].standard_normal(y.shape).astype(np.float32)
    gp = jax.grad(lambda p: jnp.sum(r["fwd"](p, x)[0] * cot))(r["params"])
    tseq = r["tseq"]
    yt = tseq(torch.from_numpy(r["x"].transpose(0, 3, 1, 2).copy()))
    (yt * torch.from_numpy(cot.transpose(0, 3, 1, 2).copy())).sum().backward()
    flat = lambda t: dict(jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, t)))
    return dict(calls=r["calls"], y=(yt.detach().numpy().transpose(0, 2, 3, 1),
                                     np.asarray(y)),
                stats=(_export(tseq)[1], jax.tree.map(np.asarray,
                                                      upd["batch_stats"])),
                grads=(flat(_export(tseq, grads=True)[0]), flat(gp)))


def test_fused_p_y_z_in_at_128_matches_jax(monkeypatch):
    fused = _layer_run(True, monkeypatch)
    unfused = _layer_run(False, monkeypatch)
    want = [(False, 16), (True, 64), (True, 32), (True, 16)]
    # the JAX side runs its forward twice: alone and under jax.grad
    assert fused["calls"] == {"jax": want * 2, "port": want}
    assert unfused["calls"] == {"jax": [], "port": []}
    np.testing.assert_allclose(*fused["y"], **TOL)
    _assert_trees_close(*fused["stats"], **TOL)
    (pf, jf), (pu, ju) = fused["grads"], unfused["grads"]
    assert set(pf) == set(jf) == set(pu) == set(ju)
    for k in jf:
        scale = np.abs(ju[k]).max()
        assert np.abs(pf[k] - pu[k]).max() <= 1e-4 * scale, k
        assert np.abs(jf[k] - ju[k]).max() <= 1e-4 * scale, k
        assert (np.abs(pf[k] - jf[k]).max()
                <= np.abs(pu[k] - ju[k]).max() + 1e-4 * scale), k
