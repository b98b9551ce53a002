#!/usr/bin/env python
"""How well conditioned one training step is after a restore, on the CPU.

The JAX trainer trains the 32^2 CVAE (one residual block) for 4 steps at
batch 2 on synthetic stacks, with tests/test_torch_checkpoint_write.py's
plan, and writes its checkpoint. A second process, with JAX's 64-bit mode
on, restores that checkpoint into the JAX trainer and the port's trainer
and computes the gradient of one further step on the same batch and latent
noise: the port in f32, JAX in f32 and JAX in f64. It prints, for each
pair, the largest relative error of an entry beyond 1e-4 of the largest
gradient entry (tests/test_torch_trainer.py's rule: 0 passes rtol 1e-3
when below it), and the largest absolute error over the largest entry:

    JAX_PLATFORMS=cpu python scripts/restored_step_conditioning.py \\
        --batch 2 4
"""
import argparse
import os
import subprocess
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

TILE = 32


def _data(root):
    from baryon_painter_tpu import transforms as jtransforms
    from baryon_painter_tpu.data.dataset import BahamasTileDataset as JaxDs
    from baryon_painter_tpu.data.dataset import load_file_info
    from baryon_painter_tpu_torch import transforms as ttransforms
    from baryon_painter_tpu_torch.data.dataset import BahamasTileDataset
    from baryon_painter_tpu_torch.data.synthetic import make_synthetic_stacks
    info = make_synthetic_stacks(root, n_stack=3, n_grid=2 * TILE,
                                 redshifts=(0.0, 1.0), seed=0)
    kw = dict(files=load_file_info(info), root_path=root, n_tile=2,
              tile_permutations=True, n_stack=2, stack_offset=1)
    jd = JaxDs(**kw, transforms={f: jtransforms.RangeCompress(
        "shift-log", 4.0, eps=1e-4) for f in ("dm", "pressure")})
    td = BahamasTileDataset(**kw, transforms={f: ttransforms.RangeCompress(
        "shift-log", 4.0, eps=1e-4) for f in ("dm", "pressure")})
    return jd, td


def _arch():
    from baryon_painter_tpu_torch.models.cvae import (
        fiducial_cvae_architecture)
    return fiducial_cvae_architecture(TILE, n_res_blocks=1)


def train(root):
    """The JAX trainer's 4-step run; its checkpoint at <root>/run/model."""
    from baryon_painter_tpu.data.dataset import BahamasTileDataset as JaxDs
    from baryon_painter_tpu.models import cvae as jcvae
    from baryon_painter_tpu.train import schedules as jsched
    from baryon_painter_tpu.train import trainer as jtrainer
    jd, _ = _data(os.path.join(root, "stacks"))
    jtest = JaxDs(data=jd.data, n_stack=1, n_tile=2, tile_permutations=True,
                  transforms=jd.transforms)
    cfg = jtrainer.TrainConfig(
        learning_rate=1e-3, batch_size=2, n_pepoch=2, pepoch_size=4,
        validation_loss_frequency=4, validation_loss_batch_size=2,
        checkpoint_frequency=4, statistics_report_frequency=0,
        stats_sync_every=2, seed=3,
        adaptive_learning_rate=jsched.ReduceLROnPlateau(patience=0),
        output_path=os.path.join(root, "run"))
    jtrainer.CVAETrainer(jcvae.CVAE(_arch()), jd, test_data=jtest,
                         config=cfg).train()


def _flat(tree, prefix=""):
    import numpy as np
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float64)
    return out


def _errors(got, want):
    import numpy as np
    top = max(np.abs(v).max() for v in want.values())
    rel = absolute = 0.0
    for k in want:
        d = np.abs(got[k] - want[k])
        over = d - 1e-4 * top
        rel = max(rel, float(np.max(np.where(
            over > 0, over / np.maximum(np.abs(want[k]), 1e-30), 0.0))))
        absolute = max(absolute, float(d.max() / top))
    return rel, absolute


def measure(root, batch):
    """One further step's gradients after the restore (64-bit mode on)."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from baryon_painter_tpu.models import cvae as jcvae
    from baryon_painter_tpu.train import trainer as jtrainer
    from baryon_painter_tpu_torch.convert import to_jax_variables
    from baryon_painter_tpu_torch.models.cvae import CVAE
    from baryon_painter_tpu_torch.train import trainer as ttrainer
    assert jax.config.jax_enable_x64
    jd, td = _data(os.path.join(root, "stacks"))
    base = os.path.join(root, "run", "model")
    idx = td.sample_indices(np.random.default_rng(11), batch)
    eps = np.random.default_rng(12).standard_normal(
        (batch, 1, TILE // 32, TILE // 32)).astype(np.float32)

    tr = ttrainer.CVAETrainer(CVAE(_arch()), td, device="cpu")
    tr.restore(base)
    tr.step(td.get_raw_batch(idx), 1e-3, eps=eps)
    port = _flat(to_jax_variables(tr.model, grads=True)["params"])

    def sample_z(self, rng, z_mu, z_log_var, L=1):
        e = jnp.asarray(eps, z_mu.dtype)[None].transpose(0, 1, 3, 4, 2)[
            :, :z_mu.shape[0]]
        z = z_mu[None] + e * (jnp.exp(z_log_var[None] / 2) + self.min_z_var)
        return z.reshape(-1, *z_mu.shape[1:])

    jcvae.CVAE.sample_z = sample_z
    jt = jtrainer.CVAETrainer(jcvae.CVAE(_arch()), jd)
    jt.restore(base)
    raw = jd.get_raw_batch(idx)
    batch_arrays = [jnp.asarray(raw[k]) for k in ("input", "labels", "z")]

    def grads(dtype):
        cast = lambda t: jax.tree.map(lambda a: jnp.asarray(a, dtype), t)
        params, stats = cast(jt.state.params), cast(jt.state.batch_stats)
        arrays = [a.astype(dtype) for a in batch_arrays]

        def loss(p):
            out, _ = jt._forward(p, stats, *arrays, jax.random.PRNGKey(0),
                                 1.0, 1.0, True)
            return -out["elbo"]
        return _flat(jax.device_get(jax.jit(jax.grad(loss))(params)))

    j32, j64 = grads(jnp.float32), grads(jnp.float64)
    for name, (a, b) in {"port_f32_vs_jax_f64": (port, j64),
                         "jax_f32_vs_jax_f64": (j32, j64),
                         "port_f32_vs_jax_f32": (port, j32)}.items():
        rel, absolute = _errors(a, b)
        print(f"batch={batch} {name}: rel_beyond_atol={rel:.3e} "
              f"max_abs_over_top={absolute:.3e}", flush=True)


def main():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, nargs="+", default=[2, 4])
    p.add_argument("--measure", metavar="ROOT", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.measure:
        for batch in args.batch:
            measure(args.measure, batch)
        return
    with tempfile.TemporaryDirectory() as root:
        train(root)
        env = dict(os.environ, JAX_ENABLE_X64="1")
        subprocess.run([sys.executable, __file__, "--measure", root,
                        "--batch", *map(str, args.batch)], env=env,
                       check=True)


if __name__ == "__main__":
    main()
