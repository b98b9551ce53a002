#!/usr/bin/env python
"""The eval-noise floor of the P(k) fidelity gate, in the PyTorch port.

The twin of ``scripts/gate_variance.py``, with its flags (and
``--device``), its stdout JSON line and its keys. For a committed
checkpoint whose meta records its gate geometry (``fidelity_dataset``):

  * the synthetic stacks of that geometry are written under
    ``--workdir`` and the gate's validation split (stack 0) is built;
  * ``--n-tiles`` tiles a redshift (default 192, 4x the standard eval)
    are painted in one ``paint_batch`` call on the card: the CVAE through
    K1 (the fused residual blocks) and K3 (the fused heads), the CGAN
    through K1; ``--dtype model`` in bf16, ``--dtype f32`` in f32 (the
    painter pins f32 convolutions, the JAX script's highest matmul
    precision);
  * the per-tile auto and cross spectra are computed on the card in one
    batched ``pseudo_pofk_2d`` each, and the gate metric (the median over
    k bins of |ratio of means - 1|, ``scripts/fidelity_check_torch.py``'s
    ``pk_errors``) on the full sample;
  * ``--n-boot`` subsets of ``--eval-n`` tiles are drawn in numpy exactly
    as the JAX script draws them (``default_rng(12345)``), so the same
    indices, and the metric's sampling distribution at the standard
    eval's size is reported: sigma, central 90 % interval and
    P(worst > gate).

The bootstrap includes both noise sources of a fresh eval: which tiles
were drawn and the prior-sample noise of each painted tile. The JAX script
paints every redshift with ``PRNGKey(seed)``; the twin draws each
redshift's noise from a ``torch.Generator`` seeded ``--seed`` afresh (not
the JAX package's draw; ``gate_variance(..., eps=)`` takes a given noise).

    python scripts/gate_variance_torch.py \\
        --checkpoint trained_models/CVAE/physical-512-lt-wip/model
    python scripts/gate_variance_torch.py \\
        --checkpoint trained_models/CGAN/fiducial/model --n-tiles 8 \\
        --redshifts 0 --n-boot 20 --device cpu

One JSON line on stdout; the timings (set-up, paint, spectra, bootstrap)
and the peak device memory on stderr. Imports only torch, numpy and the
port.
"""
import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

N_K_BIN = 12
BOOT_SEED = 12345


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", required=True,
                   help="checkpoint base, e.g. "
                        "trained_models/CVAE/physical-512-lt-wip/model")
    p.add_argument("--workdir",
                   default=os.path.join(tempfile.gettempdir(),
                                        "bpt_gate_var"))
    p.add_argument("--n-tiles", type=int, default=192,
                   help="tiles painted per redshift (the reference eval "
                        "uses 48)")
    p.add_argument("--eval-n", type=int, default=48,
                   help="bootstrap subset size = the standard eval's "
                        "tile count")
    p.add_argument("--n-boot", type=int, default=400)
    p.add_argument("--redshifts", default=None,
                   help="comma list; default: the checkpoint's "
                        "fidelity_dataset geometry")
    p.add_argument("--dtype", default="model", choices=["model", "f32"],
                   help="paint dtype leg: 'model' (bf16) or 'f32' (f32 "
                        "convolutions pinned)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--gate", type=float, default=0.05)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    return p.parse_args(argv)


def read_meta(checkpoint: str):
    """The checkpoint's meta and its gate geometry; refuses a meta without
    one, as the JAX script does."""
    with open(checkpoint + "_meta.json") as f:
        meta = json.load(f)
    geom = meta.get("fidelity_dataset")
    if geom is None:
        raise SystemExit(f"{checkpoint}: no fidelity_dataset geometry "
                         f"in the meta; pass an explicitly seeded workdir")
    return meta, geom


def write_stacks(workdir: str, geom: dict) -> str:
    """The gate's synthetic stacks of ``geom`` under ``workdir`` (the
    gate twin's ``--eval-only`` writes the same files); returns the
    files-info path."""
    from baryon_painter_tpu_torch.data.synthetic import make_synthetic_stacks
    tile = int(geom["tile"])
    physical_kw = (dict(spectrum="powerlaw", sigma0=1.2, pressure_smooth=2.0,
                        pressure_noise_corr=2.0) if geom.get("physical")
                   else {})
    return make_synthetic_stacks(
        workdir, n_stack=int(geom["n_stack"]), n_grid=2 * tile,
        redshifts=tuple(float(s) for s in geom["redshifts"].split(",")),
        seed=int(geom["seed"]), name="fid",
        pressure_noise=float(geom["pressure_noise"]), **physical_kw)


def validation_split(info: str, workdir: str, meta: dict):
    """The gate's validation split (stack 0, ``fidelity_check`` main) of
    the stacks of ``info``, with the checkpoint's transforms."""
    from baryon_painter_tpu_torch.data.dataset import (BahamasTileDataset,
                                                       load_file_info)
    from baryon_painter_tpu_torch.transforms import transform_from_dict
    transforms = {f: transform_from_dict(d)
                  for f, d in meta["transforms"].items()}
    return BahamasTileDataset(files=load_file_info(info), root_path=workdir,
                              n_stack=1, stack_offset=0, n_tile=2,
                              tile_permutations=True, transforms=transforms)


def validation_set(workdir: str, meta: dict, geom: dict):
    """``write_stacks`` then ``validation_split``."""
    return validation_split(write_stacks(workdir, geom), workdir, meta)


def make_painter(checkpoint: str, meta: dict, dtype: str, device=None,
                 fused: bool = True):
    """The painter the gate scores: the CVAE through K1 and K3-fwd, the
    CGAN through K1 (``fused=False``: cuDNN's blocks and heads), in bf16
    for ``dtype="model"``, else f32."""
    import torch

    from baryon_painter_tpu_torch.painter import CGANPainter, CVAEPainter
    torch_dtype = torch.bfloat16 if dtype == "model" else None
    if meta.get("model_kind") == "cgan":
        return CGANPainter(checkpoint, fused_inference=fused,
                           dtype=torch_dtype, device=device)
    return CVAEPainter(checkpoint, fused_inference=fused, fused_heads=fused,
                       dtype=torch_dtype, device=device)


def tile_spectra(painter, ds, z: float, n_tiles: int, seed: int, eps=None):
    """The ``n_tiles`` validation tiles at ``z`` (drawn with
    ``default_rng(seed)``, as the JAX script draws them) painted in one
    call, with noise ``eps`` when given, else drawn from a generator seeded
    ``seed`` on the painter's device (a CGAN draws none); their per-tile
    binned spectra on the occupied bins, as numpy f32: truth auto, truth x
    DM, painted auto, painted x DM. Also the seconds of the paint and of
    the spectra (each ending in a synchronise)."""
    import torch

    from baryon_painter_tpu_torch.power_spectrum import pseudo_pofk_2d
    device = painter.device
    sync = (lambda: torch.cuda.synchronize(device)) \
        if device.type == "cuda" else (lambda: None)
    rng = np.random.default_rng(seed)
    idx = ds.sample_indices(rng, n_tiles, z=z)
    batch = ds.get_raw_batch(idx)
    truth = torch.as_tensor(batch["labels"][0], dtype=torch.float32,
                            device=device)
    dm = torch.as_tensor(batch["input"], dtype=torch.float32, device=device)
    zs = torch.as_tensor(batch["z"], dtype=torch.float32, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    sync()
    t = time.perf_counter()
    painted = painter.paint_batch(dm, zs, generator=gen, eps=eps).float()
    sync()
    paint_s = time.perf_counter() - t
    pk = lambda a, b=None: pseudo_pofk_2d(a, b, L=ds.tile_L, n_k_bin=N_K_BIN)
    pk_t, _, _, nm = pk(truth)
    occ = nm > 0
    out = [s[:, occ].cpu().numpy() for s in (
        pk_t, pk(truth, dm)[0], pk(painted)[0], pk(painted, dm)[0])]
    sync()
    return out, paint_s, time.perf_counter() - t - paint_s


def metric(spectra, sel):
    """The gate metric of the tiles ``sel``: the medians over k bins of the
    auto and cross |ratio of means - 1|."""
    pk_t, pk_ct, pk_p, pk_cp = spectra
    auto = np.abs(pk_p[sel].mean(0) / pk_t[sel].mean(0) - 1)
    cross = np.abs(pk_cp[sel].mean(0) / pk_ct[sel].mean(0) - 1)
    return (float(np.median(auto)), float(np.median(cross)))


def bootstrap(spectra, boot_rng, n_tiles: int, eval_n: int, n_boot: int,
              gate: float):
    """One redshift's entry of ``per_z``: the full-sample metric and the
    distribution of ``n_boot`` subsets of ``eval_n`` tiles drawn from
    ``boot_rng`` with replacement, rounded as the JAX script rounds."""
    full_auto, full_cross = metric(spectra, slice(None))
    boots = np.array([
        metric(spectra, boot_rng.integers(0, n_tiles, eval_n))
        for _ in range(n_boot)])
    worst = boots.max(axis=1)
    q = np.percentile
    return {
        "auto_full": round(full_auto, 4),
        "cross_full": round(full_cross, 4),
        "auto_boot_mean": round(float(boots[:, 0].mean()), 4),
        "auto_boot_sigma": round(float(boots[:, 0].std()), 4),
        "auto_boot_p5_p95": [round(float(q(boots[:, 0], 5)), 4),
                             round(float(q(boots[:, 0], 95)), 4)],
        "cross_boot_sigma": round(float(boots[:, 1].std()), 4),
        "worst_boot_sigma": round(float(worst.std()), 4),
        "p_worst_gt_gate": round(float((worst > gate).mean()), 3),
    }


def gate_variance(painter, ds, redshifts, n_tiles: int = 192,
                  eval_n: int = 48, n_boot: int = 400, seed: int = 0,
                  gate: float = 0.05, eps=None, times=None):
    """``per_z`` of the JSON line: for each redshift, ``n_tiles`` tiles
    painted in one call (``tile_spectra``; ``eps`` the noise of every
    redshift's call when given) and bootstrapped from one
    ``default_rng(BOOT_SEED)`` shared across the redshifts, as in the JAX
    script. ``times`` (a dict) collects the seconds of the paint, the
    spectra and the bootstrap, each a list by redshift."""
    times = {} if times is None else times
    for key in ("paint_s", "spectra_s", "boot_s"):
        times.setdefault(key, [])
    boot_rng = np.random.default_rng(BOOT_SEED)
    out_z = {}
    for z in redshifts:
        spectra, paint_s, spectra_s = tile_spectra(painter, ds, z, n_tiles,
                                                   seed, eps=eps)
        t = time.perf_counter()
        r = bootstrap(spectra, boot_rng, n_tiles, eval_n, n_boot, gate)
        times["paint_s"].append(paint_s)
        times["spectra_s"].append(spectra_s)
        times["boot_s"].append(time.perf_counter() - t)
        out_z[str(z)] = r
        log(f"z={z}: full(auto={r['auto_full']:.4f}, "
            f"cross={r['cross_full']:.4f})  boot@{eval_n}: auto "
            f"{r['auto_boot_mean']}±{r['auto_boot_sigma']} "
            f"[{r['auto_boot_p5_p95'][0]}, {r['auto_boot_p5_p95'][1]}]")
    return out_z


def record(args, out_z: dict) -> dict:
    """The JSON line: the binding redshift (the worst full-sample value)
    and its worst-of-both sigma at ``eval_n`` tiles, beside ``per_z``."""
    binding = max(out_z, key=lambda k: max(out_z[k]["auto_full"],
                                           out_z[k]["cross_full"]))
    return {
        "metric": "gate_eval_variance",
        "checkpoint": args.checkpoint,
        "n_tiles_full": args.n_tiles,
        "eval_n": args.eval_n,
        "n_boot": args.n_boot,
        "dtype": args.dtype,
        "gate": args.gate,
        "binding_z": binding,
        "binding_full": round(max(out_z[binding]["auto_full"],
                                  out_z[binding]["cross_full"]), 4),
        "binding_sigma_at_eval_n": out_z[binding]["worst_boot_sigma"],
        "per_z": out_z,
    }


def main(argv=None):
    """Run the twin; returns the JSON line's record (also printed)."""
    args = parse_args(argv)
    import torch

    from baryon_painter_tpu_torch.utils.platform import resolve_device
    times = {}
    t0 = time.perf_counter()
    device = resolve_device(args.device)
    meta, geom = read_meta(args.checkpoint)
    redshifts = tuple(
        float(s) for s in (args.redshifts or geom["redshifts"]).split(","))
    ds = validation_set(args.workdir, meta, geom)
    painter = make_painter(args.checkpoint, meta, args.dtype, device)
    times["setup_s"] = time.perf_counter() - t0
    log(f"device: {device}  checkpoint: {args.checkpoint}  "
        f"tile={geom['tile']}  n_tiles={args.n_tiles}  dtype={args.dtype}")
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    out_z = gate_variance(painter, ds, redshifts, n_tiles=args.n_tiles,
                          eval_n=args.eval_n, n_boot=args.n_boot,
                          seed=args.seed, gate=args.gate, times=times)
    times["peak_bytes"] = (torch.cuda.max_memory_allocated(device)
                           if device.type == "cuda" else 0)
    log(f"set-up {times['setup_s']:.3f} s; by redshift: paint "
        f"{', '.join(f'{s:.3f}' for s in times['paint_s'])} s, spectra "
        f"{', '.join(f'{s:.3f}' for s in times['spectra_s'])} s, bootstrap "
        f"{', '.join(f'{s:.3f}' for s in times['boot_s'])} s; peak device "
        f"memory {times['peak_bytes'] / 1e9:.3f} GB")
    rec = record(args, out_z)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
