#!/usr/bin/env python3
"""How far the rounding of K4's four sites moves the training step's
gradients: the comparisons behind the reference of chip_smoke.py's phase
11b, run on demand.

    python3 scripts/step_parity_witness.py [--tile 512] [--batch 24]
        [--n-res-blocks 4] [--cpu]

One step of the fiducial CVAE with every kernel (``fused_train_conv``, K4
at the four sites) and plain steps from the same initialisation, batch and
latent noise (``smoke.step_gradients``, ``smoke.parity_inputs``), whose
sites run in plain PyTorch (``smoke.plain_k4``) with the forward:

    plain_sites      the plain forward (``conv_bn_relu_ref``: the library's
                     f32 conv, the batch statistics summed in f32)
    sites_stats_f64  the same u, the sums of u and u^2 and the statistics
                     in f64, rounded to f32
    sites_f64        the whole forward in f64, rounded to f32 (phase 11b's
                     reference)
    plain_k4_active  the plain forward with the ReLU's active sets of the
                     kernels step (the earlier reference of phase 11b)

Prints, for each pair, the worst of the parameters' max|a - b| over b's
largest entry (``smoke.step_grad_errors``), and last the readings as JSON
with the card's name and power limit. On the card unless ``--cpu``.
"""
import argparse
import json
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from baryon_painter_tpu_torch import smoke  # noqa: E402
from baryon_painter_tpu_torch.ops.conv_bn import (  # noqa: E402
    batch_stats, bn_affine, conv_bn_fwd_ref, conv_bn_relu, conv_bn_stats_ref)

PAIRS = (("kernels", "plain_k4_active"), ("plain_sites", "sites_stats_f64"),
         ("plain_sites", "sites_f64"), ("kernels", "sites_f64"),
         ("kernels", "plain_sites"))


def _stats_f64(x, w, gamma, beta, *, transposed, stride, padding, eps):
    """The plain forward with the statistics summed and taken in f64."""
    u = conv_bn_stats_ref(x, w, transposed=transposed, stride=stride,
                          padding=padding)[2]
    ud = u.double()
    mean, var = (t.float() for t in batch_stats(
        ud.sum((0, 2, 3)), (ud * ud).sum((0, 2, 3)),
        ud.shape[0] * ud.shape[2] * ud.shape[3]))
    _, a, b = bn_affine(gamma, beta, mean, var, eps)
    return conv_bn_fwd_ref(u, a, b), mean, var


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tile", type=int, default=smoke.TRAIN_TILE)
    ap.add_argument("--batch", type=int, default=smoke.TRAIN_BATCH)
    ap.add_argument("--n-res-blocks", type=int, default=smoke.N_RES_BLOCKS)
    ap.add_argument("--cpu", action="store_true")
    args = ap.parse_args()
    if not args.cpu and not torch.cuda.is_available():
        raise SystemExit("step_parity_witness: needs a CUDA device "
                         "(or --cpu)")
    device = torch.device("cpu" if args.cpu else "cuda")
    env = smoke.environment(device)
    ds = smoke.training_data(tile=args.tile)
    idx, eps = smoke.parity_inputs(ds, args.batch)
    masks = []

    def recording(x, w, gamma, beta, **kw):
        y, mean, var = conv_bn_relu(x, w, gamma, beta, **kw)
        masks.append(y.detach() > 0)
        return y, mean, var

    sites = {"kernels": recording,
             "plain_k4_active": smoke.plain_k4(masks=masks),
             "plain_sites": smoke.plain_k4(),
             "sites_stats_f64": smoke.plain_k4(_stats_f64),
             "sites_f64": smoke.plain_k4(smoke._site_forward_f64)}
    grads = {}
    for label, site in sites.items():
        grads[label] = smoke.step_gradients(
            device, ds, idx, eps, label == "kernels", True, site,
            args.n_res_blocks)[1]
    if masks:
        raise SystemExit(f"{len(masks)} recorded active sets left unused: "
                         f"the steps fused different sites")
    readings = {}
    for a, b in PAIRS:
        errs = smoke.step_grad_errors(grads[a], grads[b])[0]
        worst = max(errs, key=errs.get)
        readings[f"{a}_vs_{b}"] = errs[worst]
        print(f"{a} against {b}: {errs[worst]:.3e} ({worst})", flush=True)
    print(json.dumps({"tile": args.tile, "batch": args.batch,
                      "n_res_blocks": args.n_res_blocks,
                      "card": env["nvidia_smi"], "readings": readings}))


if __name__ == "__main__":
    main()
