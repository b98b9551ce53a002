#!/usr/bin/env python
"""How well conditioned the CGAN step's readings are in f32, on the CPU.

From the committed fiducial-adv state (G, D) on the smoke's synthetic
stacks (``smoke.training_data``, ``--tile`` tiles, batch ``--batch``), the
discriminator's two readings of one batch, D_real = mean D(y, z, x) and
D_fake = mean D(y, z, fake) (``fake`` the generator's train-mode paint in
f64), are computed by the JAX package's discriminator (64-bit mode on) in
f32 and in f64 on the same inputs, and by the port's in f32 and in f64.
It prints one JSON object: each reading, and the relative distance of each
f32 reading from its package's f64 one. Where D is saturated (a
probability near 0 or 1) the relative error of the mean probability is the
absolute error of the logits, whatever computes them:

    JAX_PLATFORMS=cpu python scripts/cgan_step_conditioning.py \\
        --tile 32 --batch 2
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

BASE = "trained_models/CGAN/fiducial-adv/model"


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--tile", type=int, default=32)
    p.add_argument("--batch", type=int, default=2)
    p.add_argument("--seed", type=int, default=1)
    args = p.parse_args()

    import jax
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    import numpy as np
    import torch

    from baryon_painter_tpu.models.cgan import CGANDiscriminator as JaxD
    from baryon_painter_tpu_torch import smoke
    from baryon_painter_tpu_torch.train import checkpoint as ckpt
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    ds = smoke.training_data(tile=args.tile)
    tr = smoke._cgan_trainer("cpu", ds, base=BASE, dtype=torch.float64,
                             batch_size=args.batch)
    idx = ds.sample_indices(np.random.default_rng(args.seed), args.batch)
    raw_input, raw_labels, z = tr.device_cache.gather(
        tr.device_cache.digits(idx))
    x, y = tr._prepare(raw_input, raw_labels[0], z)
    with torch.no_grad():
        tr.generator.train()
        fake = tr.generator(y, z)
    inputs = {"real": x, "fake": fake}
    out = {"tile": args.tile, "batch": args.batch}

    state, _ = ckpt.load_checkpoint(os.path.join(repo, BASE))
    jd = JaxD()
    nhwc = lambda t, dt: jnp.asarray(t.permute(0, 2, 3, 1).numpy(), dt)
    for name, t in inputs.items():
        reads = {}
        for label, dt in (("f32", jnp.float32), ("f64", jnp.float64)):
            cast = lambda tree: jax.tree.map(lambda a: jnp.asarray(a, dt),
                                             tree)
            pr, _ = jd.apply({"params": cast(state["d_params"]),
                              "batch_stats": cast(state["d_stats"])},
                             nhwc(y, dt), jnp.asarray(z.numpy(), dt),
                             nhwc(t, dt), train=True,
                             mutable=["batch_stats"])
            reads[label] = float(jnp.mean(pr))
        port = {}
        for label, dtype in (("f32", torch.float32),
                             ("f64", torch.float64)):
            d = tr.discriminator.to(dtype).train()
            with torch.no_grad():
                saved = [b.clone() for b in d.buffers()]
                port[label] = float(d(y.to(dtype), z, t.to(dtype)).mean())
                for b, v in zip(d.buffers(), saved):
                    b.copy_(v)
        rel = lambda r: abs(r["f32"] - r["f64"]) / abs(r["f64"])
        out[f"D_{name}"] = {"jax": reads, "port": port,
                            "jax_f32_vs_f64": rel(reads),
                            "port_f32_vs_f64": rel(port)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
