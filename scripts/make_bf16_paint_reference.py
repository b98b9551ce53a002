#!/usr/bin/env python
"""Write the JAX package's bf16 paint of the cvae_512 golden input
(tests/goldens/bf16_paint_reference.npz), the reference the port's bf16
painter is held to on a machine without JAX (``chip_smoke.py``).

The JAX package paints the golden input (``golden_inputs(512, 1)``,
redshift 0) with ``trained_models/CVAE/fiducial-512/model`` through its
``CVAEPainter(dtype=..., fused_inference=True)`` with its fused heads
(``BPT_FUSED_HEADS=1``, the Pallas kernel in interpret mode) at
``z_mode="mean"``, in the transformed space (``inverse_transform=False``),
in bfloat16 and in float32, op by op (``paint_eager``: the painter's
computation outside ``jax.jit``, whose rounding points are the package's
source's). The file holds both paints (f32 arrays, the bf16 one holding
bf16 values), their relative L2 distance ``d_bf16_f32``, and
``d_bf16_jit``: the distance of the bf16 paint from the same computation
under ``jax.jit``, as the package's painter runs it, which is how far the
JAX package's own bf16 paint moves with how XLA compiles it (on the CPU
XLA drops some of the source's bf16 roundings). The port's bf16 paint is
held to be no further from the op-by-op paint than that, or than half of
``d_bf16_f32`` where that is larger (``bf16_paint_limit``).
tests/test_torch_bf16_painter.py recomputes the file.

With ``--report`` it writes nothing and prints, on the CPU, how far the
port's bf16 painter lies from the JAX package's (op by op) for each of the
configurations tests/test_torch_bf16_painter.py holds, as fractions of
d(JAX f32, JAX bf16), beside the JAX package's own jit distance, and the
three rounding differences the port had to meet: PyTorch's CPU bf16
convolution at the prior's stride-4 8 -> 16 conv, PyTorch's bf16 softplus
against JAX's, and XLA's jit against JAX op by op on a conv + batch norm.

Run: JAX_PLATFORMS=cpu python scripts/make_bf16_paint_reference.py [--report]
"""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import numpy as np  # noqa: E402

CHECKPOINT = "trained_models/CVAE/fiducial-512/model"
REFERENCE_PATH = os.path.join(REPO, "tests", "goldens",
                              "bf16_paint_reference.npz")


def rel_l2(a, b) -> float:
    """||a - b|| / ||b||, in f64."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def bf16_paint_limit(d_bf16_f32, d_bf16_jit) -> float:
    """How far a bf16 paint may lie from the JAX package's op-by-op bf16
    paint: half the bf16-f32 distance, or the package's own jitted paint's
    distance where that is larger."""
    return max(0.5 * float(d_bf16_f32), float(d_bf16_jit))


def paint_eager(painter, tiles, zs, z_mode="mean", eps=None,
                inverse_transform=True, jit=False):
    """What the JAX painter's ``paint_batch`` computes, run op by op
    (``model.apply``, not under ``jax.jit``; with ``jit``, jitted as the
    painter jits it), as f32 numpy: the transform, the prior, the latent
    (the prior mean, or with ``z_mode="sample"`` z = mu + eps *
    (exp(logvar / 2) + min_z_var), ``sample_z``'s formula, with ``eps`` (N,
    h, w) cast to the latent's dtype), the decoder and, with
    ``inverse_transform``, the inverse transform; returns (transformed,
    painted or None). Op by op every operation rounds to the model's dtype
    where the package's source rounds; under ``jax.jit`` XLA on the CPU
    drops the bf16 rounding of a convolution's output where a batch norm
    casts it to f32, which moves a quarter of those outputs by a bf16
    step."""
    import jax
    import jax.numpy as jnp
    f_in, f_out = painter.input_field, painter.label_fields[0]
    model, v = painter.model, painter.variables
    min_z_var = painter.architecture.get("min_z_var", 1e-7)

    def run(tiles, zs, eps):
        y = painter.transforms[f_in].forward(tiles, painter.stats[f_in], zs)
        y = y[..., None]
        mu, log_var = model.apply(v, y, zs, train=False, method=model.prior)
        if z_mode == "mean":
            z = mu
        else:
            e = eps[..., None].astype(mu.dtype)
            z = mu + e * (jnp.exp(log_var / 2) + min_z_var)
        pred = model.apply(v, y, zs, z=z, train=False,
                           method=model.sample_P)[..., 0]
        painted = (painter.transforms[f_out].inverse(
            pred, painter.stats[f_out], zs) if inverse_transform else None)
        return pred, painted

    eps = jnp.zeros((1,), jnp.float32) if eps is None else jnp.asarray(eps)
    out = (jax.jit(run) if jit else run)(jnp.asarray(tiles), jnp.asarray(zs),
                                         eps)
    return tuple(None if a is None else np.asarray(
        jnp.asarray(a).astype(jnp.float32)) for a in out)


def jax_paint(dtype, fused_heads: bool = True, fused_inference: bool = True,
              **kw):
    """``paint_eager`` of the golden input at redshift 0 with the
    checkpoint in ``dtype``, fused residual blocks and heads unless told
    otherwise (the heads' Pallas kernel in interpret mode)."""
    from baryon_painter_tpu.painter import CVAEPainter
    from golden_utils import golden_inputs

    saved = os.environ.get("BPT_FUSED_HEADS")
    os.environ["BPT_FUSED_HEADS"] = "1" if fused_heads else "0"
    try:
        painter = CVAEPainter(os.path.join(REPO, CHECKPOINT), dtype=dtype,
                              fused_inference=fused_inference)
        return paint_eager(painter, golden_inputs(512, 1),
                           np.zeros(1, np.float32), **kw)
    finally:
        if saved is None:
            os.environ.pop("BPT_FUSED_HEADS", None)
        else:
            os.environ["BPT_FUSED_HEADS"] = saved


def compute_reference() -> dict:
    import jax.numpy as jnp
    kw = dict(z_mode="mean", inverse_transform=False)
    bf16 = jax_paint(jnp.bfloat16, **kw)[0]
    f32 = jax_paint(None, **kw)[0]
    jitted = jax_paint(jnp.bfloat16, jit=True, **kw)[0]
    return {"jax_bf16": bf16, "jax_f32": f32,
            "d_bf16_f32": np.float64(rel_l2(bf16, f32)),
            "d_bf16_jit": np.float64(rel_l2(jitted, bf16))}


def _noise():
    """JAX's bf16 prior noise under PRNGKey(7) at the 512^2 latent's shape
    (L=1, N=1, 16, 16, 1), as its ``sample_z`` draws it, as (1, 16, 16)."""
    import jax
    import jax.numpy as jnp
    e = jax.random.normal(jax.random.PRNGKey(7), (1, 1, 16, 16, 1),
                          jnp.bfloat16)
    return np.array(e.astype(jnp.float32)).reshape(1, 16, 16)


def report():
    """Print the port's bf16 paint against the JAX package's, and the
    rounding differences, on the CPU."""
    import jax
    import jax.numpy as jnp
    import torch
    import torch.nn.functional as F

    from baryon_painter_tpu.models import layers as jlayers
    from baryon_painter_tpu_torch.painter import CVAEPainter as TorchPainter
    from golden_utils import golden_inputs

    tiles, zs = golden_inputs(512, 1), np.zeros(1, np.float32)
    for fi in (False, True):
        for fh in (False, True):
            for zm in ("mean", "sample"):
                eps = _noise() if zm == "sample" else None
                kw = dict(fused_heads=fh, fused_inference=fi, z_mode=zm,
                          eps=eps)
                jb, jf, jj = (jax_paint(jnp.bfloat16, **kw),
                              jax_paint(None, **kw),
                              jax_paint(jnp.bfloat16, jit=True, **kw))
                port = {}
                for dt in (None, torch.bfloat16):
                    p = TorchPainter(os.path.join(REPO, CHECKPOINT),
                                     dtype=dt, fused_inference=fi,
                                     fused_heads=fh, device="cpu")
                    port[dt] = (p.paint_batch(tiles, zs, z_mode=zm, eps=eps,
                                              inverse_transform=False
                                              ).float().numpy(),
                                p.paint_batch(tiles, zs, z_mode=zm,
                                              eps=eps).numpy())
                for i, space in enumerate(("transformed", "painted")):
                    gap = rel_l2(jb[i], jf[i])
                    pb, pf = port[torch.bfloat16][i], port[None][i]
                    print(f"fused_inference={fi} fused_heads={fh} {zm} "
                          f"{space}: d(JAX f32, JAX bf16) {gap:.4e}; of "
                          f"it, port bf16 from JAX bf16 "
                          f"{rel_l2(pb, jb[i]) / gap:.4f}, JAX jitted "
                          f"from JAX bf16 {rel_l2(jj[i], jb[i]) / gap:.4f}"
                          f", port bf16 from port f32 "
                          f"{rel_l2(pb, pf) / gap:.4f}", flush=True)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(1, 8, 64, 64, generator=g).relu().bfloat16()
    w = (torch.randn(16, 8, 8, 8, generator=g) * 0.05).bfloat16()
    exact = F.conv2d(x.double(), w.double(), stride=4, padding=2)
    native = F.conv2d(x, w, stride=4, padding=2).double()
    print(f"PyTorch's CPU bf16 conv (stride 4, 8 -> 16, 64^2): relative "
          f"error {rel_l2(native.numpy(), exact.numpy()):.4f}")
    v = (torch.randn(100000, generator=g) * 3).bfloat16()
    want = np.asarray(jax.nn.softplus(jnp.asarray(v.float().numpy()).astype(
        jnp.bfloat16)).astype(jnp.float32))
    print(f"PyTorch's bf16 softplus differs from JAX's in "
          f"{np.mean(F.softplus(v).float().numpy() != want):.4f} of outputs")
    spec = (("conv", {"in_channels": 8, "out_channels": 8, "kernel_size": 3,
                      "stride": 1, "padding": 1, "bias": False}),
            ("batchnorm", {"num_features": 8}))
    m = jlayers.SpecSequential(spec, dtype=jnp.bfloat16)
    xs = jnp.asarray(np.random.default_rng(0).standard_normal(
        (2, 32, 32, 8)).astype(np.float32))
    v = m.init(jax.random.PRNGKey(0), xs, train=False)
    rng = np.random.default_rng(1)     # a trained batch norm's statistics
    v = jax.tree.map(lambda a: np.abs(np.asarray(a) + 0.1 * rng.normal(
        size=a.shape).astype(np.float32)), v)
    eager = m.apply(v, xs, train=False)
    jitted = jax.jit(lambda v, x: m.apply(v, x, train=False))(v, xs)
    print(f"JAX bf16 conv + batch norm, jitted against op by op: "
          f"{float(jnp.mean(eager != jitted)):.4f} of outputs differ")


def main():
    if "--report" in sys.argv[1:]:
        report()
        return
    ref = compute_reference()
    np.savez_compressed(REFERENCE_PATH, **ref)
    print(f"wrote {REFERENCE_PATH}: d_bf16_f32 {float(ref['d_bf16_f32']):.4e}"
          f", d_bf16_jit {float(ref['d_bf16_jit']):.4e}")


if __name__ == "__main__":
    main()
