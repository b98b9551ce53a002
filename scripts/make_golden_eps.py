#!/usr/bin/env python
"""Write the prior noise of the committed CVAE paint goldens
(baryon_painter_tpu_torch/data/golden_eps.npz).

The goldens (tests/goldens/paint_goldens.npz) paint with a prior sample
drawn by jax.random under PRNGKey(7), which torch cannot reproduce. This
script recovers that noise from the JAX painter,

    eps = (z - mu) / (exp(logvar / 2) + min_z_var),

with z the prior sample and (mu, logvar) the prior's heads on the golden
inputs, and stores it per latent shape: ``eps_256`` (2, 8, 8) for the 256^2
goldens (2 tiles) and ``eps_512`` (1, 16, 16) for the 512^2 ones (1 tile).
The noise depends only on the key and the shape, not on the checkpoint.
The port's painter takes it through its ``eps`` argument;
tests/test_torch_painter.py recomputes it so the pin cannot drift.

Run: JAX_PLATFORMS=cpu python scripts/make_golden_eps.py
"""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tests"))

import numpy as np  # noqa: E402

# one checkpoint for each latent shape of the goldens
SOURCES = {"eps_256": "cvae_fiducial", "eps_512": "cvae_512"}
EPS_PATH = os.path.join(REPO, "baryon_painter_tpu_torch", "data",
                        "golden_eps.npz")


def recover_eps(base: str, tile: int, n: int) -> np.ndarray:
    """The (n, h, w) prior noise the JAX painter draws under PRNGKey(7)
    for the golden inputs of one checkpoint."""
    import jax
    import jax.numpy as jnp

    from baryon_painter_tpu.painter import CVAEPainter
    from golden_utils import golden_inputs

    painter = CVAEPainter(os.path.join(REPO, base), dtype=None)
    tiles = jnp.asarray(golden_inputs(tile, n))
    zs = jnp.asarray(np.linspace(0.0, 1.0, n).astype(np.float32))
    f = painter.input_field
    y = painter.transforms[f].forward(tiles, painter.stats[f], zs)[..., None]
    model, variables = painter.model, painter.variables
    z = model.apply(variables, y, zs, train=False,
                    rngs={"sample": jax.random.PRNGKey(7)},
                    method=model.sample_prior)
    mu, log_var = model.apply(variables, y, zs, train=False,
                              method=model.prior)
    min_z_var = painter.architecture.get("min_z_var", 1e-7)
    eps = (z - mu) / (jnp.exp(log_var / 2) + min_z_var)
    return np.asarray(eps[..., 0], np.float32)


def main():
    from golden_utils import MODELS
    by_name = {m[0]: m for m in MODELS}
    arrays = {}
    for key, name in SOURCES.items():
        _, base, _, tile, n = by_name[name]
        arrays[key] = recover_eps(base, tile, n)
    np.savez_compressed(EPS_PATH, **arrays)
    print(f"wrote {EPS_PATH}: " + ", ".join(
        f"{k} {v.shape}" for k, v in arrays.items()))


if __name__ == "__main__":
    main()
