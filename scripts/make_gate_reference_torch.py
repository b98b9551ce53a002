#!/usr/bin/env python
"""Write the JAX package's gate readings that ``chip_smoke.py`` phase 20
holds the port's to (baryon_painter_tpu_torch/data/gate_reference.npz).

The committed fidelity reports were scored on a TPU. Their f32 readings
are reproducible: the JAX package on the CPU, at the same tiles and the
same prior noise (``jax.random.PRNGKey(seed)``), gives them again. Their
bf16 ("model") readings are not: XLA's bf16 arithmetic on the TPU is its
own, and the same JAX code on the CPU lies up to 7e-3 from them (fiducial
CVAE, 48 tiles). So this script scores, with the JAX package on the CPU,
the committed evaluations that phase 20 repeats (``scripts/
fidelity_check.py``'s ``pk_errors`` on the synthetic validation stacks):

- the fiducial CVAE (512^2) at z = 0, 0.125, 0.25 (``smoke.GATE_CVAE_Z``,
  phase 20a) and at its other eight redshifts (``cvae_z11``, phase 20d),
  both CGANs (fiducial and fiducial-adv, 256^2) at their three redshifts,
  and the other three committed CVAEs (fiducial-resize at 256^2,
  physical-512-lt-wip and physical-512-resize-wip at 512^2 with
  ``--physical``, phase 20d) at the redshifts of the bf16 readings 20d
  decides, 48 tiles each, through each checkpoint meta's transforms;
- in f32 (``jax.default_matmul_precision("highest")``, as the JAX script's
  f32 leg), in bf16 jitted (the JAX painter as it runs), in bf16 with
  the eval-mode batch norm's input pinned at its storage dtype by an
  optimization barrier (the source's rounding points, which ``jax.jit`` on
  the CPU otherwise folds away), and, for the CGANs, in bf16 through the
  fused residual blocks (``fused_inference=True``: on the CPU the JAX
  package's XLA version of K1, whose rounding points K1's are: the
  products summed in f32, the inner activation rounded once);

and stores the prior noise each CVAE paints with: the draws of
``PRNGKey(seed)`` in f32 and in bf16 (the bf16 model draws its noise in
bf16: other values), at the latent's shape (48, tile/32, tile/32), which
the port's painter takes through ``eps``.

Run: JAX_PLATFORMS=cpu python scripts/make_gate_reference_torch.py
(about 25 minutes). ``--case NAME`` (repeatable: the names of ``CASES``)
and ``--mode MODE`` (repeatable) score only those cases and modes and
keep every other array of the existing file as it is.

With ``--witness BASE --z Z`` it writes nothing and prints one JSON
object instead: the JAX package's own noise spread of one committed f32
reading. The JAX gate (``scripts/fidelity_check.py --eval-only``, f32 leg,
the committed evaluation's dataset flags) paints that redshift's
committed tiles at ``PRNGKey(s)`` for s in 0..``--seeds``-1 (s = 0 is the
committed draw) and scores each, on the CPU:

    JAX_PLATFORMS=cpu python scripts/make_gate_reference_torch.py \
        --witness trained_models/CVAE/physical-512-resize-wip/model \
        --z 0.125 --seeds 8
"""
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "scripts"))

import numpy as np  # noqa: E402

OUT = os.path.join(REPO, "baryon_painter_tpu_torch", "data",
                   "gate_reference.npz")
TILES = 48
SEED = 0
ALL_Z = (0.0, 0.125, 0.25, 0.375, 0.5, 0.75, 1.0, 1.25, 1.5, 1.75, 2.0)
# (name, key prefix, checkpoint, tile, --physical, redshifts of the
# committed evaluation's stacks, redshifts scored). The synthetic stacks
# draw the redshifts in order, so the first three of the fiducial CVAE's
# eleven are its committed tiles; ``cvae_z11`` scores its other eight on
# all eleven stacks, under the same prefix. The other CVAEs are scored at
# the redshifts whose bf16 readings phase 20d decides (ROADMAP.md §3 of
# the PR that added them), with their meta's ``fidelity_dataset``.
CASES = (
    ("cvae", "cvae", "trained_models/CVAE/fiducial-512/model", 512, False,
     (0.0, 0.125, 0.25), (0.0, 0.125, 0.25)),
    ("cgan", "cgan", "trained_models/CGAN/fiducial/model", 256, False,
     (0.0, 0.5, 1.0), (0.0, 0.5, 1.0)),
    ("cgan_adv", "cgan_adv", "trained_models/CGAN/fiducial-adv/model", 256,
     False, (0.0, 0.5, 1.0), (0.0, 0.5, 1.0)),
    ("cvae_z11", "cvae", "trained_models/CVAE/fiducial-512/model", 512,
     False, ALL_Z, ALL_Z[3:]),
    ("cvae_resize", "cvae_resize", "trained_models/CVAE/fiducial-resize/model",
     256, False, (0.0, 0.5, 1.0), (0.5,)),
    ("cvae_lt", "cvae_lt", "trained_models/CVAE/physical-512-lt-wip/model",
     512, True, ALL_Z, (0.25, 1.25, 1.75, 2.0)),
    ("cvae_resize_wip", "cvae_resize_wip",
     "trained_models/CVAE/physical-512-resize-wip/model", 512, True, ALL_Z,
     (0.25, 1.0, 1.25, 1.5, 1.75, 2.0)),
)
MODES = ("f32", "bf16_jit", "bf16_pinned", "bf16_fused")


def pinned_batch_norm():
    """Patch the JAX eval-mode batch norm so its input keeps its storage
    dtype under ``jax.jit`` (an optimization barrier, as the train-mode
    one has); returns the undo."""
    import jax

    from baryon_painter_tpu.models import layers
    call = layers.BatchNorm.__call__

    def pinned(self, x, fused_stats=None, params_only=False,
               n_features=None):
        if (self.use_running_average and x is not None and not params_only
                and fused_stats is None):
            x = jax.lax.optimization_barrier(x.astype(self.dtype or x.dtype))
        return call(self, x, fused_stats, params_only, n_features)

    layers.BatchNorm.__call__ = pinned
    return lambda: setattr(layers.BatchNorm, "__call__", call)


def validation_set(tile, redshifts, root, base, physical=False):
    """The JAX script's validation set of the committed evaluation
    (``--n-stack 4``, pressure noise 0.1, seed 0; ``physical`` as
    ``--physical``), and its training set, whose statistics the gate's
    painter transforms with; both through the checkpoint meta's
    transforms, as the JAX script's ``--eval-only`` takes them."""
    import json

    from baryon_painter_tpu.data.dataset import (BahamasTileDataset,
                                                 load_file_info)
    from baryon_painter_tpu.data.synthetic import make_synthetic_stacks
    from baryon_painter_tpu.transforms import transform_from_dict
    physical_kw = (dict(spectrum="powerlaw", sigma0=1.2, pressure_smooth=2.0,
                        pressure_noise_corr=2.0) if physical else {})
    info = make_synthetic_stacks(root, n_stack=4, n_grid=2 * tile,
                                 redshifts=redshifts, seed=SEED, name="fid",
                                 pressure_noise=0.1, **physical_kw)
    with open(os.path.join(REPO, base) + "_meta.json") as f:
        tf = {k: transform_from_dict(d)
              for k, d in json.load(f)["transforms"].items()}
    train = BahamasTileDataset(files=load_file_info(info), root_path=root,
                               n_tile=2, n_stack=3, stack_offset=1,
                               tile_permutations=True, transforms=tf)
    val = BahamasTileDataset(data=train.data, n_stack=1, stack_offset=0,
                             n_tile=2, tile_permutations=True,
                             transforms=tf)
    return train, val


def painter(kind, base, train, dtype, fused=False):
    """The JAX gate's painter: the checkpoint's weights, the training
    set's statistics (as ``from_trainer`` builds it); ``fused`` (the
    CGAN) with the fused residual blocks."""
    from baryon_painter_tpu.models.cgan import CGANGenerator
    from baryon_painter_tpu.models.cvae import CVAE
    from baryon_painter_tpu.painter import CGANPainter, CVAEPainter
    from baryon_painter_tpu.train import checkpoint as ckpt
    if kind == "cvae":
        loaded = CVAEPainter(os.path.join(REPO, base), dtype=dtype)
        arch = loaded.meta["model_architecture"]
        return CVAEPainter(model=CVAE(arch, dtype=dtype),
                           variables=loaded.variables,
                           meta=ckpt.meta_from_dataset(train, arch))
    loaded = CGANPainter(os.path.join(REPO, base), dtype=dtype)
    arch = loaded.meta["model_architecture"]
    meta = dict(ckpt.meta_from_dataset(train, arch), model_kind="cgan")
    gen = CGANGenerator(dtype=dtype, **{k: arch[k] for k in (
        "in_channels", "n_res_blocks", "upsample") if k in arch})
    return CGANPainter(generator=gen, variables=loaded.variables, meta=meta,
                       fused_inference=fused)


def prior_noise(p, shape, dtype):
    """The noise the JAX painter draws under PRNGKey(SEED) for a latent of
    ``shape`` (N, h, w): the key ``make_rng`` derives in ``sample_prior``."""
    import jax
    key = p.model.apply(p.variables, method=lambda m: m.make_rng("sample"),
                        rngs={"sample": jax.random.PRNGKey(SEED)})
    eps = jax.random.normal(key, (1, *shape, 1), dtype)
    return np.asarray(eps[0, ..., 0].astype(np.float32))


def main(cases=None, modes=None):
    """Score ``cases`` (names of ``CASES``; None: all) in ``modes`` (of
    ``MODES``; None: all; ``bf16_fused`` for the CGANs only) and write them
    into the reference file beside the other arrays."""
    import tempfile

    import jax
    import jax.numpy as jnp

    import fidelity_check
    arrays = {}
    if (cases is not None or modes is not None) and os.path.exists(OUT):
        # the other cases' arrays as they are; the scored ones replaced
        with np.load(OUT) as old:
            arrays = {k: old[k] for k in old.files}
    for name, kind, base, tile, physical, stack_z, zs in CASES:
        if cases is not None and name not in cases:
            continue
        cvae = "/CVAE/" in base
        with tempfile.TemporaryDirectory() as root:
            train, val = validation_set(tile, stack_z, root, base, physical)
            for mode in MODES:
                if ((modes is not None and mode not in modes)
                        or (mode == "bf16_fused" and cvae)):
                    continue
                dtype = None if mode == "f32" else jnp.bfloat16
                undo = pinned_batch_norm() if mode == "bf16_pinned" else None
                try:
                    p = painter("cvae" if cvae else "cgan", base, train,
                                dtype, fused=mode == "bf16_fused")
                    if cvae:
                        h = tile // 32
                        key = f"{kind}_eps_{mode[:4]}"
                        eps = prior_noise(p, (TILES, h, h),
                                          dtype or jnp.float32)
                        if key in arrays and not np.array_equal(
                                arrays[key], eps):
                            raise AssertionError(f"{key}: another draw")
                        arrays[key] = eps
                    with jax.default_matmul_precision(
                            "highest" if mode == "f32" else "default"):
                        for z in zs:
                            auto, cross, _ = fidelity_check.pk_errors(
                                p, val, n_sample=TILES, seed=SEED, z=z)
                            arrays[f"{kind}_{mode}_z{z:g}"] = np.array(
                                [auto, cross], np.float64)
                            print(f"{name} {mode} z={z:g}: auto {auto:.5f} "
                                  f"cross {cross:.5f}", flush=True)
                finally:
                    if undo is not None:
                        undo()
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT}: {len(arrays)} arrays")


def _errors_at(painter, ds, cached, key):
    """The JAX gate's median auto and cross errors of the cached tiles
    painted at ``key`` (``fidelity_check.pk_errors`` with its noise key
    apart from its tile seed)."""
    import jax.numpy as jnp

    from baryon_painter_tpu.power_spectrum import pseudo_pofk_2d
    dm = jnp.asarray(cached["dm"])
    painted = painter.paint_batch(dm, cached["zs"], rng=key)
    painted = painted.astype(jnp.float32)
    occ = cached["occ"]
    pk_p, *_ = pseudo_pofk_2d(painted, L=ds.tile_L, n_k_bin=12)
    pk_cp, *_ = pseudo_pofk_2d(painted, dm, L=ds.tile_L, n_k_bin=12)
    auto = np.abs(np.asarray(pk_p).mean(0)[occ] / cached["pk_t"] - 1)
    cross = np.abs(np.asarray(pk_cp).mean(0)[occ] / cached["pk_ct"] - 1)
    return float(np.median(auto)), float(np.median(cross))


def witness(base, z, seeds):
    """See the module docstring (``--witness``)."""
    import contextlib
    import json
    import tempfile

    import jax

    import fidelity_check
    import fidelity_spread_torch as spread
    flags = spread.dataset_flags(os.path.join(REPO, base))
    zs = flags[flags.index("--redshifts") + 1].split(",")
    # the stacks are drawn in redshift order: the first ones up to z give
    # that redshift's committed tiles
    upto = zs[:[float(v) for v in zs].index(z) + 1]
    flags[flags.index("--redshifts") + 1] = ",".join(upto)
    orig, found = fidelity_check.pk_errors, {}

    def spy(painter, ds, n_sample=48, seed=0, z=None, matmul_precision=None):
        out = orig(painter, ds, n_sample=n_sample, seed=seed, z=z,
                   matmul_precision=matmul_precision)
        if z is not None and abs(z - want_z) < 1e-9 and not found:
            cached = fidelity_check._PK_TRUTH_CACHE[
                (id(ds), z, seed, n_sample)]
            with jax.default_matmul_precision("highest"):
                for s in range(seeds):
                    found[s] = _errors_at(painter, ds, cached,
                                          jax.random.PRNGKey(s))
            found["gate"] = out[:2]
        return out

    want_z = z
    fidelity_check.pk_errors = spy
    with tempfile.TemporaryDirectory() as tmp:
        argv = sys.argv
        sys.argv = ["fidelity_check.py", *flags, "--eval-only",
                    "--checkpoint", os.path.join(REPO, base),
                    "--gate-dtype", "f32", "--workdir", tmp]
        try:
            with contextlib.redirect_stdout(sys.stderr):
                fidelity_check.main()
        finally:
            sys.argv, fidelity_check.pk_errors = argv, orig
    vals = np.array([found[s] for s in range(seeds)], np.float64)
    with open(os.path.join(REPO, os.path.dirname(base),
                           "fidelity_report.json")) as f:
        committed = json.load(f)["per_z_by_dtype"]["f32"][f"{z:g}"]
    out = {"checkpoint": base, "z": z, "leg": "f32", "seeds": seeds,
           "gate_reading": list(found["gate"]), "committed": committed}
    for i, name in enumerate(("auto", "cross")):
        v = vals[:, i]
        out[name] = {"values": v.tolist(), "mean": float(v.mean()),
                     "std": float(v.std(ddof=1)) if seeds > 1 else 0.0}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    import argparse
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--witness", default=None,
                   help="a checkpoint base path (see the docstring)")
    p.add_argument("--z", type=float, default=None)
    p.add_argument("--seeds", type=int, default=8)
    p.add_argument("--case", action="append", default=None,
                   choices=[c[0] for c in CASES],
                   help="score only this case (repeatable); the file's "
                        "other arrays are kept")
    p.add_argument("--mode", action="append", default=None, choices=MODES,
                   help="score only this mode (repeatable); the file's "
                        "other arrays are kept")
    a = p.parse_args()
    if a.witness:
        witness(a.witness, a.z, a.seeds)
    else:
        main(a.case, a.mode)
