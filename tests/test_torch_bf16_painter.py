"""The port's bf16 painter against the JAX package's bf16 painter, the
committed bf16 paint reference, and the latent channel axis.

* ``CVAEPainter(dtype=torch.bfloat16)`` on the committed ``cvae_512``
  checkpoint, one golden tile, residual blocks and heads unfused and fused
  (the port's K1 and K3 plain bf16 versions; the JAX package's
  ``res_block_infer_xla`` and its Pallas heads in interpret mode), at the
  prior mean and with a prior sample (the noise drawn by JAX in bf16 from
  PRNGKey(7) at the latent's shape and handed to both), in the
  transformed space and painted. The JAX package runs op by op
  (``scripts/make_bf16_paint_reference.py`` ``paint_eager``), so that its
  rounding points are its source's. With d the relative L2 distance:
    - d(port bf16, JAX bf16) <= max(0.5 d(JAX f32, JAX bf16),
      d(JAX bf16 jitted, JAX bf16)): the port is no further from the JAX
      package's bf16 paint than half the bf16-f32 distance, or than the
      package's own paint moves when XLA compiles it (``jax.jit`` on the
      CPU drops the bf16 rounding of a convolution's output where a batch
      norm casts it to f32), which is 0.84 of that distance here.
      The port on the CPU reads 0.14-0.56 of it;
    - d(port bf16, port f32) >= 0.5 d(JAX bf16, JAX f32): the port really
      paints in bf16.
* The committed reference (tests/goldens/bf16_paint_reference.npz), which
  ``chip_smoke.py`` holds the card's bf16 paint to, is what the JAX
  package computes now.
* A transform that emits (N, C, H, W) (as split-scale ones do) reaches the
  model with its channels, in the painter and the trainer, as in the JAX
  package.
"""
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from baryon_painter_tpu_torch import smoke
from baryon_painter_tpu_torch.painter import CVAEPainter
from golden_utils import REPO, golden_inputs

BASE = os.path.join(REPO, "trained_models", "CVAE", "fiducial-512", "model")


def _script():
    path = os.path.join(REPO, "scripts", "make_bf16_paint_reference.py")
    spec = importlib.util.spec_from_file_location("make_bf16_ref", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


REF = _script()


def _noise():
    """JAX's bf16 prior noise under PRNGKey(7) at the latent's shape (L=1,
    N=1, 16, 16, 1), as its ``sample_z`` draws it, as (1, 16, 16) f32."""
    e = jax.random.normal(jax.random.PRNGKey(7), (1, 1, 16, 16, 1),
                          jnp.bfloat16)
    return np.array(e.astype(jnp.float32)).reshape(1, 16, 16)


CONFIGS = [(fi, fh, zm) for fi in (False, True) for fh in (False, True)
           for zm in ("mean", "sample")]


@pytest.mark.parametrize("fused_inference,fused_heads,z_mode", CONFIGS,
                         ids=[f"{'k1' if fi else 'blocks'}-"
                              f"{'k3' if fh else 'heads'}-{zm}"
                              for fi, fh, zm in CONFIGS])
def test_bf16_paint_matches_the_jax_package(fused_inference, fused_heads,
                                            z_mode):
    eps = _noise() if z_mode == "sample" else None
    kw = dict(fused_heads=fused_heads, fused_inference=fused_inference,
              z_mode=z_mode, eps=eps)
    jb = REF.jax_paint(jnp.bfloat16, **kw)
    jf = REF.jax_paint(None, **kw)
    jj = REF.jax_paint(jnp.bfloat16, jit=True, **kw)
    tiles, zs = golden_inputs(512, 1), np.zeros(1, np.float32)
    port = {}
    for dt in (None, torch.bfloat16):
        p = CVAEPainter(BASE, dtype=dt, fused_inference=fused_inference,
                        fused_heads=fused_heads, device="cpu")
        pk = dict(z_mode=z_mode, eps=eps)
        t = p.paint_batch(tiles, zs, inverse_transform=False, **pk)
        painted = p.paint_batch(tiles, zs, **pk)
        assert t.dtype == (dt or torch.float32)
        assert painted.dtype == torch.float32     # as the JAX painter's
        port[dt] = (t.float().numpy(), painted.numpy())
    for i, space in enumerate(("transformed", "painted")):
        gap = REF.rel_l2(jb[i], jf[i])
        limit = REF.bf16_paint_limit(gap, REF.rel_l2(jj[i], jb[i]))
        d = REF.rel_l2(port[torch.bfloat16][i], jb[i])
        assert np.all(np.isfinite(port[torch.bfloat16][i]))
        assert d <= limit, (space, d / gap, limit / gap)
        real = REF.rel_l2(port[torch.bfloat16][i], port[None][i])
        assert real >= 0.5 * gap, (space, real / gap)
        # and the f32 paints agree as the f32 tests hold them
        assert REF.rel_l2(port[None][i], jf[i]) < 1e-5, space


def test_committed_bf16_reference_is_what_the_jax_package_paints():
    with np.load(REF.REFERENCE_PATH) as z:
        committed = {k: z[k] for k in z.files}
    fresh = REF.compute_reference()
    assert set(committed) == {"jax_bf16", "jax_f32", "d_bf16_f32",
                              "d_bf16_jit"}
    assert committed["jax_bf16"].shape == (1, 512, 512)
    np.testing.assert_allclose(committed["jax_f32"], fresh["jax_f32"],
                               rtol=1e-5, atol=1e-6)
    gap = float(committed["d_bf16_f32"])
    assert REF.rel_l2(fresh["jax_bf16"], committed["jax_bf16"]) <= 0.05 * gap
    for key in ("d_bf16_f32", "d_bf16_jit"):
        assert float(fresh[key]) == pytest.approx(float(committed[key]),
                                                  rel=0.1), key
    # the values are bf16 values held in f32
    b = committed["jax_bf16"]
    np.testing.assert_array_equal(
        torch.from_numpy(b).bfloat16().float().numpy(), b)
    # chip_smoke.py's limit from the file: the jitted paint's distance
    limit = REF.bf16_paint_limit(gap, committed["d_bf16_jit"])
    assert 0.5 * gap <= limit < gap
    assert smoke.BF16_REFERENCE == os.path.relpath(REF.REFERENCE_PATH, REPO)


def test_smoke_bf16_paint_phase_on_cpu():
    """Phase 14 on the CPU: the plain versions, no launches, the committed
    reference met."""
    res = smoke.paint_bf16("cpu", n_tiles=1, warmup=0, iters=1)
    assert res["dtype"] == "torch.bfloat16"
    assert res["d_jax_bf16"] <= res["limit"]
    assert res["real_ratio"] >= smoke.BF16_REAL_RATIO
    assert all(v == 0 for v in res["launches"].values())
    assert all(v == 0 for v in res["bf16_launches"].values())


class ChannelAxis:
    """A transform that emits (N, 1, H, W), as split-scale transforms emit
    their channels: the inner transform's output with a channel axis."""

    def __init__(self, inner):
        self.inner = inner

    def forward(self, x, stats, z):
        return self.inner.forward(x, stats, z)[:, None]

    def inverse(self, x, stats, z):
        return self.inner.inverse(x, stats, z)


def test_painter_takes_a_transform_with_channels(monkeypatch):
    from baryon_painter_tpu import painter as jpainter
    tiles, zs = golden_inputs(512, 1), np.zeros(1, np.float32)
    plain = CVAEPainter(BASE, device="cpu")
    want = plain.paint_batch(tiles, zs, z_mode="mean")
    chan = CVAEPainter(BASE, device="cpu")
    chan.transforms[chan.input_field] = ChannelAxis(
        chan.transforms[chan.input_field])
    got = chan.paint_batch(tiles, zs, z_mode="mean")
    assert torch.equal(got, want)
    # the JAX painter with the same transform paints the same
    load = jpainter.ckpt.transforms_from_meta

    def with_channels(meta):
        tfs, stats = load(meta)
        f = meta["input_field"]
        return {**tfs, f: ChannelAxis(tfs[f])}, stats

    monkeypatch.setattr(jpainter.ckpt, "transforms_from_meta", with_channels)
    jp = jpainter.CVAEPainter(BASE)
    jgot = np.asarray(jp.paint_batch(tiles, zs, z_mode="mean"))
    np.testing.assert_allclose(got.numpy(), jgot, rtol=1e-4, atol=1e-5)


def test_trainer_takes_transforms_with_channels(tmp_path):
    """The trainer's batch with (N, 1, H, W) transforms is its batch with
    (N, H, W) ones, and the JAX trainer's with the same transforms."""
    from baryon_painter_tpu.data.dataset import \
        BahamasTileDataset as JaxDataset
    from baryon_painter_tpu.data.dataset import load_file_info
    from baryon_painter_tpu.models import cvae as jcvae
    from baryon_painter_tpu.train import trainer as jtrainer
    from baryon_painter_tpu.transforms import RangeCompress as JaxRC
    from baryon_painter_tpu_torch.data.dataset import BahamasTileDataset
    from baryon_painter_tpu_torch.data.synthetic import make_synthetic_stacks
    from baryon_painter_tpu_torch.models.cvae import (
        CVAE, fiducial_cvae_architecture)
    from baryon_painter_tpu_torch.train.trainer import CVAETrainer
    from baryon_painter_tpu_torch.transforms import RangeCompress
    info = make_synthetic_stacks(str(tmp_path), n_stack=2, n_grid=64,
                                 redshifts=(0.0, 1.0), seed=0)
    kw = dict(files=load_file_info(info), root_path=str(tmp_path), n_tile=2,
              tile_permutations=True)
    td = BahamasTileDataset(**kw, transforms={
        "dm": RangeCompress("shift-log", 4.0),
        "pressure": RangeCompress("shift-log", 4.0)})
    jd = JaxDataset(**kw, transforms={"dm": JaxRC("shift-log", 4.0),
                                      "pressure": JaxRC("shift-log", 4.0)})
    arch = fiducial_cvae_architecture(32, n_res_blocks=1)
    tr = CVAETrainer(CVAE(arch), td, device="cpu")
    jt = jtrainer.CVAETrainer(jcvae.CVAE(arch), jd,
                              config=jtrainer.TrainConfig(seed=0))
    batch = td.get_raw_batch(td.sample_indices(np.random.default_rng(0), 2))
    raw = [torch.as_tensor(np.asarray(batch[k], np.float32))
           for k in ("input", "labels", "z")]
    want = [t.clone() for t in tr._prepare(*raw)]
    for t in (tr, jt):
        t._transforms = {f: ChannelAxis(v) for f, v in t._transforms.items()}
    got = tr._prepare(*raw)
    for a, b in zip(got, want):
        assert a.shape == b.shape == (2, 1, 32, 32)
        assert torch.equal(a, b)
    jx, jy = jt._prepare(*(jnp.asarray(t.numpy()) for t in raw))
    for a, b in zip(got, (jx, jy)):
        np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(),
                                   np.asarray(b), rtol=1e-6, atol=1e-6)
