#!/usr/bin/env python
"""Per-bin P(k) diagnostic for a fidelity checkpoint, in the PyTorch port.

The twin of ``scripts/pk_diagnose.py``, with its flags (and ``--device``),
its table and its JSON line. Reads the workdir layout that
``scripts/fidelity_check_torch.py`` (or ``scripts/fidelity_check.py``)
writes: the synthetic stacks' ``fid_files_info.pickle`` and the trainer
checkpoint ``fidelity_model_cvae``, restored into a bf16 ``CVAETrainer``.
The validation tiles (stack 0) are painted on the card through
``CVAEPainter.from_trainer(trainer, fused_inference=True)`` with the
model's fused heads: K1 (the fused residual blocks, 4 launches a call) and
K3-fwd (the fused heads, 1). Per redshift and k bin it prints the
painted/truth auto-P(k) ratio, the cross-P(k) ratio with the DM and the
correlation coefficient r(k) = P_xd / sqrt(P_xx P_dd) of painted against
truth: "uncorrelated extra power" (auto high, r low) against
"miscalibrated amplitude" (auto off, r ~ 1).

    python scripts/pk_diagnose_torch.py --workdir <gate workdir> \\
        --tile 512 [--upsample resize] [--device cpu]

The JAX script paints every redshift with ``PRNGKey(seed)``; the twin
draws each redshift's noise from a ``torch.Generator`` seeded ``--seed``
afresh (``diagnose(..., eps=)`` takes a given noise). ``--model cgan`` is
refused: the JAX script restores a CGAN checkpoint into a CVAE trainer,
which fails. Imports only torch, numpy and the port.
"""
import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

N_K_BIN = 12


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workdir",
                   default=os.path.join(tempfile.gettempdir(),
                                        "bpt_fidelity"))
    p.add_argument("--model", default="cvae", choices=["cvae", "cgan"])
    p.add_argument("--tile", type=int, default=256)
    p.add_argument("--upsample", default="transpose",
                   choices=["transpose", "resize"])
    p.add_argument("--n-sample", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default=None,
                   help="torch device (default: cuda)")
    args = p.parse_args(argv)
    if args.model == "cgan":
        raise SystemExit("--model cgan: the diagnostic restores the "
                         "checkpoint into a CVAE trainer (as "
                         "scripts/pk_diagnose.py does, which fails on a "
                         "CGAN checkpoint); only --model cvae is supported")
    return args


def dataset(workdir: str):
    """The gate's validation split (stack 0) of the workdir's stacks,
    through the gate's default transforms (shift-log 4, eps 1e-4)."""
    from baryon_painter_tpu_torch.data.dataset import (BahamasTileDataset,
                                                       load_file_info)
    from baryon_painter_tpu_torch.transforms import RangeCompress
    transforms = {"dm": RangeCompress("shift-log", 4.0, eps=1e-4),
                  "pressure": RangeCompress("shift-log", 4.0, eps=1e-4)}
    info_path = os.path.join(workdir, "fid_files_info.pickle")
    return BahamasTileDataset(files=load_file_info(info_path),
                              root_path=workdir, n_tile=2, n_stack=1,
                              stack_offset=0, tile_permutations=True,
                              transforms=transforms)


def restore_painter(args, ds, device=None, fused: bool = True,
                    dtype="keep"):
    """The bf16 trainer of the workdir's checkpoint and its painter: the
    fused residual blocks (K1) and fused heads (K3-fwd), or cuDNN's with
    ``fused=False``; in the trainer's bf16, or ``dtype`` (None: f32)."""
    import torch

    from baryon_painter_tpu_torch.models.cvae import (
        CVAE, fiducial_cvae_architecture)
    from baryon_painter_tpu_torch.painter import CVAEPainter
    from baryon_painter_tpu_torch.train.trainer import (CVAETrainer,
                                                        TrainConfig)
    arch = fiducial_cvae_architecture(tile_size=args.tile, n_res_blocks=4,
                                      upsample=args.upsample)
    trainer = CVAETrainer(CVAE(arch, dtype=torch.bfloat16, fused_heads=fused),
                          ds, config=TrainConfig(seed=args.seed),
                          device=device)
    trainer.restore(os.path.join(args.workdir,
                                 f"fidelity_model_{args.model}"))
    return CVAEPainter.from_trainer(trainer, fused_inference=fused,
                                    dtype=dtype)


def diagnose(painter, ds, n_sample: int = 16, seed: int = 0, eps=None,
             out=None):
    """``per_z`` of the JSON line: for each redshift of ``ds``, the
    ``n_sample`` tiles drawn from one ``default_rng(seed)`` painted in one
    call (noise ``eps`` when given, else a generator seeded ``seed``), and
    per occupied k bin the auto ratio, the cross ratio with the DM and
    r(k), from per-tile spectra on the painter's device averaged over the
    tiles. Prints the table to ``out``."""
    import torch

    from baryon_painter_tpu_torch.power_spectrum import pseudo_pofk_2d
    device = painter.device
    rng = np.random.default_rng(seed)
    report = {}
    for z in ds.redshifts:
        idx = ds.sample_indices(rng, n_sample, z=z)
        batch = ds.get_raw_batch(idx)
        truth = torch.as_tensor(batch["labels"][0], dtype=torch.float32,
                                device=device)
        dm = torch.as_tensor(batch["input"], dtype=torch.float32,
                             device=device)
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        painted = painter.paint_batch(dm, batch["z"], generator=gen,
                                      eps=eps).float()
        pk = lambda a, b=None: pseudo_pofk_2d(a, b, L=ds.tile_L,
                                              n_k_bin=N_K_BIN)
        pk_t, k, _, nm = pk(truth)
        occ = (nm > 0).cpu().numpy()
        mean = lambda s: s.mean(0).cpu().numpy()[occ]
        k = k.cpu().numpy()[occ]
        a_t, a_p = mean(pk_t), mean(pk(painted)[0])
        c_t, c_p = mean(pk(truth, dm)[0]), mean(pk(painted, dm)[0])
        # correlation of painted against the truth field itself
        x = mean(pk(painted, truth)[0])
        r = x / np.sqrt(a_p * a_t)
        rows = []
        print(f"z={z:g}   k [h/Mpc]   auto_p/auto_t   cross_p/cross_t   r(k)",
              file=out)
        for i in range(len(k)):
            print(f"  {k[i]:10.3f}   {a_p[i] / a_t[i]:10.4f}   "
                  f"{c_p[i] / c_t[i]:12.4f}   {r[i]:7.4f}", file=out)
            rows.append({"k": float(k[i]),
                         "auto_ratio": float(a_p[i] / a_t[i]),
                         "cross_ratio": float(c_p[i] / c_t[i]),
                         "r": float(r[i])})
        report[f"{z:g}"] = rows
        painted_np = painted.cpu().numpy()
        truth_np = np.asarray(batch["labels"][0], np.float32)
        print(f"  mean_ratio={painted_np.mean() / truth_np.mean():.4f} "
              f"std_ratio={painted_np.std() / truth_np.std():.4f}", file=out)
    return report


def main(argv=None):
    """Run the twin; returns the JSON line's record (also printed)."""
    args = parse_args(argv)
    ds = dataset(args.workdir)
    painter = restore_painter(args, ds, device=args.device)
    rec = {"metric": "pk_per_bin",
           "per_z": diagnose(painter, ds, n_sample=args.n_sample,
                             seed=args.seed)}
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
