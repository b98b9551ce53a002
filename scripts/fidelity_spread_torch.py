#!/usr/bin/env python
"""The P(k) gate's spread over the prior's noise, for committed checkpoints.

For each ``--checkpoint`` (a base path with a ``fidelity_report.json``
beside it), repeats the port's ``--eval-only`` evaluation
(``scripts/fidelity_check_torch.py``) at the committed evaluation's own
validation tiles (its dataset flags, from the checkpoint meta's
``fidelity_dataset`` or, where the meta has none, from ``--dataset``;
tile seed 0, ``--eval-tiles`` tiles per redshift) over ``--seeds`` draws
of the prior's noise (generator seeds 0..n-1; the CGAN draws none, so
its readings repeat), in both gate legs (f32 pinned; "model", bf16).
Prints one JSON object: per checkpoint, leg, redshift and auto/cross the
readings, their mean and standard deviation (over the seeds, ddof 1), the
committed value, the limit max(3 sigma, 5e-4) and whether the committed
value lies within it of the mean. This is the noise-only part of what
``scripts/gate_variance.py`` bootstraps: the tiles are the committed ones
(the synthetic stacks are a numpy copy), the noise cannot be (the JAX
package draws it with ``jax.random``).

    python3 scripts/fidelity_spread_torch.py \\
        --checkpoint trained_models/CVAE/fiducial-512/model \\
        --dataset '{"tile": 512, "redshifts":
                    "0,0.125,0.25,0.375,0.5,0.75,1,1.25,1.5,1.75,2"}' \\
        --seeds 8 --out spread.json

Runs on the card unless ``--device cpu``, painting through K1 and K3.
Imports only torch, numpy and the port.
"""
import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

import fidelity_check_torch as gate

SIGMA_LIMIT = 3.0
FLOOR = 5e-4
DATASET_KEYS = ("tile", "redshifts", "n_stack", "physical",
                "pressure_noise", "seed")


def dataset_flags(ckpt_base, fallback=None):
    """The gate twin's dataset flags of a checkpoint's committed evaluation:
    the meta's ``fidelity_dataset``, else ``fallback`` (the same keys; the
    JAX script's defaults fill what it leaves out)."""
    with open(ckpt_base + "_meta.json") as f:
        meta = json.load(f)
    geometry = dict(meta.get("fidelity_dataset") or fallback or {})
    if "tile" not in geometry:
        raise SystemExit(f"{ckpt_base}: the meta has no fidelity_dataset; "
                         f"pass --dataset")
    flags = ["--model", meta.get("model_kind", "cvae"),
             "--tile", str(geometry["tile"])]
    for key, flag in (("redshifts", "--redshifts"), ("n_stack", "--n-stack"),
                      ("pressure_noise", "--pressure-noise"),
                      ("seed", "--seed")):
        if key in geometry:
            flags += [flag, str(geometry[key])]
    if geometry.get("physical"):
        flags.append("--physical")
    return flags


def readings(g, zs, eps_seeds, n_tiles, seed=0):
    """{leg: {z: {"auto": [...], "cross": [...]}}} over ``eps_seeds`` at the
    validation tiles of (``seed``, ``n_tiles``) of each z in ``zs``."""
    out = {}
    for label, dtype in g.legs:
        painter = g.make_painter(dtype)
        leg = out.setdefault(label, {})
        for z in zs:
            vals = [gate.pk_errors(painter, g.val_ds, n_sample=n_tiles,
                                   seed=seed, z=z, eps_seed=s)[:2]
                    for s in eps_seeds]
            leg[f"{z:g}"] = {"auto": [v[0] for v in vals],
                             "cross": [v[1] for v in vals]}
    return out


def summarise(reads, committed, sigma_limit=SIGMA_LIMIT, floor=FLOOR):
    """Mean, standard deviation, the committed value, the limit
    max(sigma_limit * sigma, floor) and whether |committed - mean| is
    within it, per leg, z and kind."""
    out = {}
    for leg, per_z in reads.items():
        for z, kinds in per_z.items():
            for kind, vals in kinds.items():
                v = np.asarray(vals, np.float64)
                std = float(v.std(ddof=1)) if len(v) > 1 else 0.0
                mean = float(v.mean())
                want = committed.get(leg, {}).get(z, {}).get(kind)
                limit = max(sigma_limit * std, floor)
                out.setdefault(leg, {}).setdefault(z, {})[kind] = {
                    "values": [float(x) for x in v], "mean": mean,
                    "std": std, "committed": want, "limit": limit,
                    "within": (None if want is None
                               else bool(abs(want - mean) <= limit))}
    return out


def committed_report(ckpt_base):
    path = os.path.join(os.path.dirname(ckpt_base), "fidelity_report.json")
    with open(path) as f:
        report = json.load(f)
    return report.get("per_z_by_dtype") or {"f32": report["per_z"]}


def spread(ckpt_base, n_seeds, device=None, fallback=None, n_tiles=48):
    """The spread of one checkpoint's gate (see the module docstring)."""
    with tempfile.TemporaryDirectory() as tmp:
        argv = dataset_flags(ckpt_base, fallback) + [
            "--eval-only", "--checkpoint", ckpt_base, "--eval-tiles",
            str(n_tiles), "--workdir", tmp]
        if device is not None:
            argv += ["--device", str(device)]
        args = gate.parse_args(argv)
        t0 = time.perf_counter()
        g = gate.setup(args)
        t1 = time.perf_counter()
        reads = readings(g, g.val_ds.redshifts, range(n_seeds), n_tiles,
                         seed=args.seed)
        t2 = time.perf_counter()
    return {"checkpoint": ckpt_base, "model": args.model,
            "dataset": {k: getattr(args, k) for k in DATASET_KEYS},
            "eps_seeds": n_seeds, "eval_tiles": n_tiles,
            "setup_s": t1 - t0, "readings_s": t2 - t1,
            "legs": summarise(reads, committed_report(ckpt_base))}


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--checkpoint", action="append", required=True)
    p.add_argument("--dataset", default=None,
                   help="JSON of the dataset flags for checkpoints whose "
                        "meta has no fidelity_dataset")
    p.add_argument("--seeds", type=int, default=8)
    p.add_argument("--eval-tiles", type=int, default=48)
    p.add_argument("--device", default=None)
    p.add_argument("--out", default=None, help="also write the JSON here")
    args = p.parse_args(argv)
    fallback = json.loads(args.dataset) if args.dataset else None
    card = None
    import torch
    if torch.cuda.is_available() and args.device != "cpu":
        import subprocess
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    result = {"card": card, "sigma_limit": SIGMA_LIMIT, "floor": FLOOR,
              "checkpoints": [spread(c, args.seeds, args.device, fallback,
                                     args.eval_tiles)
                              for c in args.checkpoint]}
    text = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(text)
    print(text)
    return result


if __name__ == "__main__":
    main()
