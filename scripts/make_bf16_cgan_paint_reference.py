#!/usr/bin/env python
"""Write the JAX package's bf16 paint of the cgan_fiducial golden inputs
(tests/goldens/bf16_cgan_paint_reference.npz), the reference the port's
bf16 CGAN painter is held to on a machine without JAX (``chip_smoke.py``
phase 17c).

The JAX package paints the golden inputs of ``cgan_fiducial``
(``golden_inputs(256, 2)``, redshifts ``linspace(0, 1, 2)``) with
``trained_models/CGAN/fiducial/model`` through its
``CGANPainter(dtype=..., fused_inference=True)`` (spectral norm folded,
the fused residual blocks' XLA version on the CPU), in the transformed
space (no inverse transform: the tanh output), in bfloat16 and in
float32, op by op (the painter's computation outside ``jax.jit``, whose
rounding points are the package's source's). The file holds both paints
(f32 arrays, the bf16 one holding bf16 values), their relative L2
distance ``d_bf16_f32``, and ``d_bf16_jit``: the bf16 paint's distance
from the same computation under ``jax.jit``, as the package's painter
runs it. The port's bf16 paint is held to lie no further from the op-by-op
paint than max(0.5 * d_bf16_f32, d_bf16_jit), and at least 0.5 *
d_bf16_f32 from the port's own f32 paint. tests/test_torch_cgan.py
recomputes the file.

Run: JAX_PLATFORMS=cpu python scripts/make_bf16_cgan_paint_reference.py
"""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))
sys.path.insert(0, os.path.join(REPO, "scripts"))

import numpy as np  # noqa: E402

from make_bf16_paint_reference import rel_l2  # noqa: E402

CHECKPOINT = "trained_models/CGAN/fiducial/model"
REFERENCE_PATH = os.path.join(REPO, "tests", "goldens",
                              "bf16_cgan_paint_reference.npz")
TILE, N_TILES = 256, 2


def golden_batch():
    """The cgan_fiducial golden's inputs and redshifts."""
    from golden_utils import golden_inputs
    return (golden_inputs(TILE, N_TILES),
            np.linspace(0.0, 1.0, N_TILES).astype(np.float32))


def paint_eager(painter, tiles, zs, inverse_transform=False, jit=False):
    """What the JAX CGAN painter's ``paint_batch`` computes, op by op (with
    ``jit``, jitted as the painter jits it), as f32 numpy: the transform,
    the generator and, with ``inverse_transform``, the inverse."""
    import jax
    import jax.numpy as jnp
    f_in, f_out = painter.input_field, painter.label_fields[0]

    def run(tiles, zs):
        y = painter.transforms[f_in].forward(tiles, painter.stats[f_in], zs)
        pred = painter.generator.apply(painter.variables, y[..., None], zs,
                                       train=False)[..., 0]
        if inverse_transform:
            pred = painter.transforms[f_out].inverse(
                pred, painter.stats[f_out], zs)
        return pred

    out = (jax.jit(run) if jit else run)(jnp.asarray(tiles), jnp.asarray(zs))
    return np.asarray(jnp.asarray(out).astype(jnp.float32))


def jax_paint(dtype, fused_inference: bool = True, **kw):
    """``paint_eager`` of the golden batch with the checkpoint in
    ``dtype``."""
    from baryon_painter_tpu.painter import CGANPainter
    painter = CGANPainter(os.path.join(REPO, CHECKPOINT), dtype=dtype,
                          fused_inference=fused_inference)
    return paint_eager(painter, *golden_batch(), **kw)


def compute_reference() -> dict:
    import jax.numpy as jnp
    bf16 = jax_paint(jnp.bfloat16)
    f32 = jax_paint(None)
    jitted = jax_paint(jnp.bfloat16, jit=True)
    return {"jax_bf16": bf16, "jax_f32": f32,
            "d_bf16_f32": np.float64(rel_l2(bf16, f32)),
            "d_bf16_jit": np.float64(rel_l2(jitted, bf16))}


def main():
    ref = compute_reference()
    np.savez_compressed(REFERENCE_PATH, **ref)
    print(f"wrote {REFERENCE_PATH}: d_bf16_f32 {float(ref['d_bf16_f32']):.4e}"
          f", d_bf16_jit {float(ref['d_bf16_jit']):.4e}")


if __name__ == "__main__":
    main()
