#!/usr/bin/env python3
"""How far the f32 training step lies from the same step in f64: the
readings behind the whole-model f64 reference of chip_smoke.py's phases 8b
and 11b, with the convolution library switched off and on.

    python3 scripts/step_f64_witness_torch.py [--tile 512] [--batch 24]
        [--n-res-blocks 4] [--cpu]

One step of the fiducial CVAE from the seeded initialisation on the same
batch and latent noise (``smoke.parity_inputs``) in each of:

    f64            every module in f64 (``smoke.step_gradients_f64``), the
                   reference
    f64_native     the same with cuDNN off (PyTorch's own convolutions)
    kernels        f32 with K2 and K3 (phase 8b's kernels step)
    plain          f32, the plain gather and cuDNN's heads and trunk
    plain_native   the plain f32 step with cuDNN off

Prints, for each step against f64, the loss's relative difference, the
worst parameters' max|a - f64| over the f64 gradient's own largest entry
(``smoke.step_grad_errors``), how many lie over ``smoke.STEP_GRAD_TOL``,
and each of those leaves' largest entry against the largest of all; last
the readings as JSON with the card's name and power limit. On the card
unless ``--cpu``.
"""
import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from baryon_painter_tpu_torch import smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tile", type=int, default=smoke.TRAIN_TILE)
    ap.add_argument("--batch", type=int, default=smoke.TRAIN_BATCH)
    ap.add_argument("--n-res-blocks", type=int, default=smoke.N_RES_BLOCKS)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("step_f64_witness: needs a CUDA device (or --cpu)")
    device = torch.device("cpu" if args.cpu else "cuda")
    env = smoke.environment(device)
    ds = smoke.training_data(tile=args.tile)
    idx, eps = smoke.parity_inputs(ds, args.batch)
    n = args.n_res_blocks
    runs = {"f64": smoke.step_gradients_f64(device, ds, idx, eps, n)}
    with smoke._cudnn(False):
        runs["f64_native"] = smoke.step_gradients_f64(device, ds, idx, eps,
                                                      n)
    runs["kernels"] = smoke.step_gradients(device, ds, idx, eps, True,
                                           False, None, n)
    runs["plain"] = smoke.step_gradients(device, ds, idx, eps, False, False,
                                         None, n)
    with smoke._cudnn(False):
        runs["plain_native"] = smoke.step_gradients(device, ds, idx, eps,
                                                    False, False, None, n)
    loss64, g64 = runs["f64"]
    top = max(g.abs().max().item() for g in g64.values())
    readings = {}
    for label, (loss, grads) in runs.items():
        if label == "f64":
            continue
        errs = smoke.step_grad_errors(grads, g64)[0]
        over = {k: v for k, v in errs.items() if v > smoke.STEP_GRAD_TOL}
        worst = max(errs, key=errs.get)
        readings[label] = {
            "loss_rel_err": abs(loss - loss64) / abs(loss64),
            "worst_grad": worst, "worst_grad_rel_err": errs[worst],
            "over_tol": {k: {"rel_err": v, "own_max_over_all": (
                g64[k].abs().max().item() / top)} for k, v in over.items()}}
        loss_err = readings[label]["loss_rel_err"]
        print(f"{label} against f64: loss {loss_err:.3e}, worst "
              f"{errs[worst]:.3e} ({worst}), {len(over)} leaves over "
              f"{smoke.STEP_GRAD_TOL:g}", flush=True)
        for k, v in sorted(over.items(), key=lambda kv: -kv[1]):
            print(f"  {k}: {v:.3e}, its max|g| "
                  f"{readings[label]['over_tol'][k]['own_max_over_all']:.3e}"
                  f" of all", flush=True)
    print(json.dumps({"tile": args.tile, "batch": args.batch,
                      "n_res_blocks": n, "card": env["nvidia_smi"],
                      "max_abs_grad": top, "readings": readings}))


if __name__ == "__main__":
    main()
