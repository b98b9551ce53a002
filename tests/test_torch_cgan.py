"""The port's CGAN painter (models/cgan.py, the spectral-norm fold in
models/fuse.py, convert.generator_from_jax_variables, painter.CGANPainter,
load_painter) against the JAX package's, on the CPU.

* ``cgan_generator_spec`` equals JAX's for both upsample modes.
* The generator at 32^2 with 2 residual blocks, random flax weights
  (spectral norm on, its u vectors as flax draws them; batch norm
  statistics perturbed from a seeded numpy generator), against JAX's
  ``CGANGenerator.apply(train=False)``, whose spectral norm runs its
  power iteration in the graph: unfused and fused (K1's plain version at
  slope 0.2), both upsample modes, in f32 within rtol 1e-4, atol 1e-4 *
  max|JAX|. In bf16 with phase 17c's rule (d the relative L2 distance, the
  JAX package op by op): d(port bf16, JAX bf16) <= max(0.5 d(JAX f32, JAX
  bf16), d(JAX bf16 jitted, JAX bf16)), and d(port bf16, port f32) >= 0.5
  d(JAX f32, JAX bf16).
* ``sn_sigma_from_u`` against JAX's ``_sn_sigma_from_u`` on every kernel of
  both committed CGAN checkpoints (rtol 1e-6), and the folded, fused
  variables against JAX's ``fuse_cgan_generator_variables`` (rtol 1e-6).
* ``cgan_fiducial`` and ``cgan_adv`` (tests/goldens/paint_goldens.npz)
  repainted unfused and fused, at the golden test's tolerance (rtol 5e-3,
  atol 5e-3 * mean|golden|).
* bf16 on the committed ``cgan_fiducial`` checkpoint: the port in each
  layout against the JAX package in the same layout, with phase 17c's
  rule; the committed reference (tests/goldens/bf16_cgan_paint_reference
  .npz) is what the JAX package paints now.
* ``load_painter`` dispatches all seven golden checkpoints.
* Phase 17's control flow on the CPU (``smoke.k1_cgan_cases`` and
  ``smoke.paint_cgan_bf16``).
"""
import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baryon_painter_tpu.models.cgan import CGANGenerator as JaxGenerator
from baryon_painter_tpu.models.cgan import \
    cgan_generator_spec as jax_cgan_spec
from baryon_painter_tpu.models.fuse import _sn_sigma_from_u
from baryon_painter_tpu.models.fuse import \
    fuse_cgan_generator_variables as jax_fuse_cgan
from baryon_painter_tpu_torch import smoke
from baryon_painter_tpu_torch.convert import generator_from_jax_variables
from baryon_painter_tpu_torch.models.cgan import cgan_generator_spec
from baryon_painter_tpu_torch.models.fuse import (
    fold_cgan_spectral_norm, fuse_cgan_generator_variables, sn_sigma_from_u)
from baryon_painter_tpu_torch.models.layers import FusedResBlock
from baryon_painter_tpu_torch.painter import (CGANPainter, CVAEPainter,
                                              load_painter)
from baryon_painter_tpu_torch.train.checkpoint import load_checkpoint
from golden_utils import GOLDEN_PATH, MODELS, REPO, golden_inputs

CGAN_GOLDENS = [m for m in MODELS if m[2] == "cgan"]
CHECKPOINTS = {m[0]: os.path.join(REPO, m[1]) for m in CGAN_GOLDENS}
SIZE = 32


def _script():
    path = os.path.join(REPO, "scripts", "make_bf16_cgan_paint_reference.py")
    spec = importlib.util.spec_from_file_location("make_bf16_cgan_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _script()


def rel_l2(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


@pytest.mark.parametrize("upsample", ["transpose", "resize"])
@pytest.mark.parametrize("n_res_blocks", [0, 2, 9])
def test_generator_spec_equals_jax(upsample, n_res_blocks):
    assert cgan_generator_spec(2, n_res_blocks, upsample) == jax_cgan_spec(
        2, n_res_blocks, upsample)


def test_unknown_upsample_raises():
    with pytest.raises(ValueError, match="upsample"):
        cgan_generator_spec(upsample="bilinear")


# --------------------------------------------------------------------- #
# the generator at 32^2 with random flax weights


def _random_generator(upsample, seed=0):
    """A spectrally normalised JAX generator with 2 residual blocks, its
    variables as numpy (batch norm perturbed), and a seeded input."""
    rng = np.random.default_rng(seed)
    gen = JaxGenerator(n_res_blocks=2, upsample=upsample)
    y = rng.standard_normal((2, SIZE, SIZE, 1)).astype(np.float32)
    z = np.array([0.3, 1.2], np.float32)
    v = _np_tree(gen.init(jax.random.PRNGKey(seed), jnp.asarray(y),
                          jnp.asarray(z), train=False))

    def perturb(path, a):
        name = jax.tree_util.keystr(path)
        if "BatchNorm" in name and ("scale" in name or "var" in name):
            return (a * rng.uniform(0.7, 1.3, a.shape)).astype(np.float32)
        if "BatchNorm" in name and ("bias" in name or "mean" in name):
            return (a + 0.1 * rng.standard_normal(a.shape)).astype(
                np.float32)
        return a

    v = jax.tree_util.tree_map_with_path(perturb, v)
    arch = {"in_channels": 2, "n_res_blocks": 2, "upsample": upsample}
    return gen, v, arch, y, z


def _port(v, arch, fused, dtype=None):
    if fused:
        v, kw = fuse_cgan_generator_variables(v, arch)
        arch = {**arch, **kw}
    return generator_from_jax_variables(v, arch, dtype=dtype)


def _port_paint(gen, y, z):
    with torch.no_grad():
        out = gen(torch.from_numpy(y.transpose(0, 3, 1, 2)),
                  torch.from_numpy(z))
    return out.float().numpy().transpose(0, 2, 3, 1)


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("upsample", ["transpose", "resize"])
def test_generator_matches_jax_f32(upsample, fused):
    jgen, v, arch, y, z = _random_generator(upsample)
    want = np.asarray(jgen.apply(v, jnp.asarray(y), jnp.asarray(z),
                                 train=False))
    gen = _port(v, arch, fused)
    blocks = [m for m in gen.modules() if isinstance(m, FusedResBlock)]
    assert len(blocks) == (2 if fused else 0)
    assert all((b.inner_slope, b.outer_slope) == (0.2, 0.2) for b in blocks)
    got = _port_paint(gen, y, z)
    assert got.shape == want.shape == (2, SIZE, SIZE, 1)
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-4 * np.abs(want).max())


def _bf16_rule(port_bf16, port_f32, jax_bf16, jax_f32, jax_jit):
    gap = rel_l2(jax_bf16, jax_f32)
    limit = max(0.5 * gap, rel_l2(jax_jit, jax_bf16))
    d_ref = rel_l2(port_bf16, jax_bf16)
    d_real = rel_l2(port_bf16, port_f32)
    assert d_ref <= limit, (d_ref / gap, limit / gap)
    assert d_real >= 0.5 * gap, d_real / gap


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_generator_matches_jax_bf16(fused):
    jgen, v, arch, y, z = _random_generator("transpose", seed=1)
    jb = JaxGenerator(n_res_blocks=2, dtype=jnp.bfloat16)
    run = lambda m, v: m.apply(v, jnp.asarray(y), jnp.asarray(z),
                               train=False)
    if fused:
        jv, kw = jax_fuse_cgan(v, arch)
        jgen = JaxGenerator(**kw)
        jb = JaxGenerator(dtype=jnp.bfloat16, **kw)
    else:
        jv = v
    as_np = lambda a: np.asarray(jnp.asarray(a).astype(jnp.float32))
    jax_bf16, jax_f32 = as_np(run(jb, jv)), as_np(run(jgen, jv))
    jax_jit = as_np(jax.jit(lambda v: run(jb, v))(jv))
    port_bf16 = _port_paint(_port(v, arch, fused, torch.bfloat16), y, z)
    port_f32 = _port_paint(_port(v, arch, fused), y, z)
    _bf16_rule(port_bf16, port_f32, jax_bf16, jax_f32, jax_jit)


# --------------------------------------------------------------------- #
# the spectral-norm fold on the committed checkpoints


def _sn_kernels(params, stats, prefix=""):
    """(name, kernel, u) of every spectrally normalised kernel."""
    out = []
    for key, sub in stats.items():
        if key.startswith("SpectralNorm_"):
            for var, u in sub.items():
                if var.endswith("/u"):
                    *path, pname, _ = var.split("/")
                    node = params
                    for part in path:
                        node = node[part]
                    out.append((prefix + var, node[pname], u))
        elif isinstance(sub, dict) and key in params:
            out += _sn_kernels(params[key], sub, prefix + key + "/")
    return out


@pytest.mark.parametrize("name", list(CHECKPOINTS))
def test_sn_sigma_equals_jax_on_every_kernel(name):
    state, _ = load_checkpoint(CHECKPOINTS[name])
    kernels = _sn_kernels(state["g_params"], state["g_stats"])
    # 3 body convs, 2 transposed convs, 18 in the residual blocks, the head
    assert len(kernels) == 24
    shapes = {np.shape(u) for _, _, u in kernels}
    assert (1, 1) in shapes
    for var, kernel, u in kernels:
        got, want = sn_sigma_from_u(kernel, u), _sn_sigma_from_u(kernel, u)
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=var)


@pytest.mark.parametrize("name", list(CHECKPOINTS))
def test_fold_and_fuse_equal_jax(name):
    state, meta = load_checkpoint(CHECKPOINTS[name])
    v = {"params": state["g_params"], "batch_stats": state["g_stats"]}
    arch = meta["model_architecture"]
    got, kw = fuse_cgan_generator_variables(v, arch)
    want, jkw = jax_fuse_cgan(v, arch)
    assert kw == {k: jkw[k] for k in kw} and kw["fused_res_blocks"]
    g = jax.tree_util.tree_leaves_with_path(got)
    w = dict(jax.tree_util.tree_leaves_with_path(want))
    assert len(g) == len(w)
    for path, a in g:
        np.testing.assert_allclose(np.asarray(a), np.asarray(w[path]),
                                   rtol=1e-6, atol=0,
                                   err_msg=jax.tree_util.keystr(path))
    folded = fold_cgan_spectral_norm(v)
    assert not any("SpectralNorm" in jax.tree_util.keystr(p) for p, _ in
                   jax.tree_util.tree_leaves_with_path(folded))
    # folding twice changes nothing: no SpectralNorm state is left
    again = fold_cgan_spectral_norm(folded)
    for (p, a), (_, b) in zip(jax.tree_util.tree_leaves_with_path(folded),
                              jax.tree_util.tree_leaves_with_path(again)):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------- #
# the committed goldens


@pytest.fixture(scope="module")
def goldens():
    with np.load(GOLDEN_PATH) as g:
        return {m[0]: g[m[0]].astype(np.float32) for m in CGAN_GOLDENS}


def test_two_cgan_goldens_are_covered():
    assert [m[0] for m in CGAN_GOLDENS] == ["cgan_fiducial", "cgan_adv"]


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("name,base,kind,tile,n", CGAN_GOLDENS,
                         ids=[m[0] for m in CGAN_GOLDENS])
def test_port_paints_committed_cgan_golden(goldens, name, base, kind, tile,
                                           n, fused):
    painter = CGANPainter(os.path.join(REPO, base), fused_inference=fused,
                          device="cpu")
    zs = np.linspace(0.0, 1.0, n).astype(np.float32)
    got = painter.paint_batch(golden_inputs(tile, n), zs).numpy()
    want = goldens[name]
    assert got.shape == want.shape and np.all(np.isfinite(got))
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=5e-3,
                               atol=5e-3 * np.abs(want).mean(),
                               err_msg=f"{name}: the port's paint differs "
                                       f"from the committed golden")


def test_paint_single_tile_returns_numpy():
    painter = CGANPainter(CHECKPOINTS["cgan_fiducial"], device="cpu")
    tile = golden_inputs(256, 1)[0]
    out = painter.paint(tile, z=0.5)
    assert isinstance(out, np.ndarray) and out.shape == (256, 256)
    batch = painter.paint_batch(tile[None], [0.5], z_mode="mean").numpy()
    np.testing.assert_array_equal(out, batch[0])
    with pytest.raises(ValueError, match="2-D"):
        painter.paint(np.ones((1, 64, 64), np.float32))
    with pytest.raises(ValueError, match="filename"):
        CGANPainter(device="cpu")


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_bf16_cgan_paint_matches_the_jax_package(fused):
    """The port in bf16 against the JAX package in bf16, op by op, in the
    same layout (the two layouts of the JAX package lie about one
    d(JAX f32, JAX bf16) apart: the CGAN's 9 blocks carry a rounding
    difference through the whole tile)."""
    tiles, zs = REF.golden_batch()
    jb = REF.jax_paint(jnp.bfloat16, fused_inference=fused)
    jf = REF.jax_paint(None, fused_inference=fused)
    jj = REF.jax_paint(jnp.bfloat16, fused_inference=fused, jit=True)
    kw = dict(fused_inference=fused, device="cpu")
    pb = CGANPainter(CHECKPOINTS["cgan_fiducial"], dtype=torch.bfloat16,
                     **kw).paint_batch(tiles, zs, inverse_transform=False)
    pf = CGANPainter(CHECKPOINTS["cgan_fiducial"], **kw).paint_batch(
        tiles, zs, inverse_transform=False)
    assert pb.dtype == torch.bfloat16 and pf.dtype == torch.float32
    _bf16_rule(pb.float().numpy(), pf.numpy(), jb, jf, jj)
    # painted (inverse transform) output is f32, as the JAX painter's
    painted = CGANPainter(CHECKPOINTS["cgan_fiducial"], dtype=torch.bfloat16,
                          **kw).paint_batch(tiles, zs)
    assert painted.dtype == torch.float32


def test_committed_bf16_cgan_reference_is_what_the_jax_package_paints():
    with np.load(os.path.join(REPO, "tests", "goldens",
                              "bf16_cgan_paint_reference.npz")) as r:
        ref = {k: r[k] for k in r.files}
    now = REF.compute_reference()
    assert set(ref) == set(now)
    for key in ("jax_bf16", "jax_f32"):
        np.testing.assert_array_equal(ref[key], now[key])
    for key in ("d_bf16_f32", "d_bf16_jit"):
        np.testing.assert_allclose(ref[key], now[key], rtol=1e-12)


# --------------------------------------------------------------------- #
# load_painter


@pytest.mark.parametrize("name,base,kind,tile,n", MODELS,
                         ids=[m[0] for m in MODELS])
def test_load_painter_dispatches_on_model_kind(name, base, kind, tile, n):
    painter = load_painter(os.path.join(REPO, base), fused_inference=True,
                           device="cpu")
    with open(os.path.join(REPO, base) + "_meta.json") as f:
        meta = json.load(f)
    assert meta.get("model_kind", "cvae") == kind
    assert type(painter) is (CGANPainter if kind == "cgan" else CVAEPainter)
    assert painter.architecture["fused_res_blocks"]
    assert painter.device == torch.device("cpu")


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        CGANPainter(CHECKPOINTS["cgan_fiducial"])


# --------------------------------------------------------------------- #
# phase 17 on the CPU


def test_phase17_k1_cases_at_the_cgan_shapes():
    cases = smoke.k1_cgan_cases()
    assert [(c[0], c[1], c[2]) for c in cases] == [
        ((2, 64, 64, 128), torch.float32, 0.2),
        ((2, 64, 64, 128), torch.bfloat16, 0.2),
        ((16, 128, 128, 128), torch.float32, 0.2),
        ((16, 128, 128, 128), torch.bfloat16, 0.2)]
    out = smoke.check_k1_cgan(torch.device("cpu"),
                              cases=[((1, 8, 8, 128), dt, 0.2, tol)
                                     for _, dt, _, tol in cases[:2]])
    assert len(out) == 2 and all(r["max_abs_err"] <= r["tol"] for r in out)


def test_phase17_goldens_and_bf16_on_cpu():
    goldens = smoke.paint_cgan_goldens(torch.device("cpu"))
    assert [g["name"] for g in goldens["goldens"]] == ["cgan_fiducial",
                                                       "cgan_adv"]
    assert all(g["worst_err_over_tol"] <= 1.0 for g in goldens["goldens"])
    assert goldens["launches"] == 0
    bf16 = smoke.paint_cgan_bf16(torch.device("cpu"))
    assert bf16["d_jax_bf16"] <= bf16["limit"]
    assert bf16["d_port_f32"] >= 0.5 * bf16["gap"]
    assert set(bf16["bf16_launches"].values()) == {0}
