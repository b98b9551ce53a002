#!/usr/bin/env python
"""Halo readings of the PyTorch port's whole-plane paint, in f32 and f64.

For the fiducial-512 CVAE (z_mode 'mean') and the CGAN, paints the
``chip_smoke.py`` phase 18a probe plane (n^2 golden-style tiles) with
``parallel.spatial.paint_plane`` and prints, per model, in units of the
JAX package's halo tolerance (|a - b| / (1e-6 + 1e-5 |b|), worst pixel):

- ``f32_h``: each of ``--repeats`` f32 paints at ``required_halo`` against
  the f64 paint at twice it (the reference);
- ``f32_2h``: the f32 paint at twice the halo against that reference;
- ``f32_h_vs_f32_2h``: f32 at the halo against f32 at twice it;
- ``repeat_spread``: the f32 paints at the halo against their first;
- ``f64_h``: the f64 paint at the halo against the reference;
- ``short_f32`` / ``short_f64``: the paints at one alignment step below
  ``calibrate_halo``'s result against the reference: a halo known to be
  too short.

Each reading is taken with cuDNN's default (``deterministic`` off) and with
``torch.backends.cudnn.deterministic`` on. Prints one JSON object.

    python3 scripts/halo_readings_torch.py [--n 512] [--repeats 4]
        [--device cuda] [--out readings.json]
"""
import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def readings(device, n: int, repeats: int) -> dict:
    import torch
    from baryon_painter_tpu_torch import smoke
    from baryon_painter_tpu_torch.parallel import spatial

    plane = smoke.golden_inputs(n, 1)[0]
    f64 = {label: p for label, p, _, _ in smoke._spatial_painters(
        device, torch.float64)}
    out = {}
    for label, painter, kind, z_mode in smoke._spatial_painters(device):
        arch = painter.meta["model_architecture"]
        h = spatial.required_halo(arch, kind)
        f = spatial.latent_downsample(arch)

        def paint(p, halo):
            return spatial.paint_plane(p, plane, 0.5, halo=halo,
                                       z_mode=z_mode).double().cpu()

        ref = paint(f64[label], 2 * h)
        calibrated = spatial.calibrate_halo(painter, z=0.5)
        rec = {"halo": h, "calibrated": calibrated,
               "short_halo": calibrated - f,
               "f64_h": smoke._halo_ratio(paint(f64[label], h), ref),
               "short_f64": smoke._halo_ratio(
                   paint(f64[label], calibrated - f), ref)}
        for deterministic in (False, True):
            prev = torch.backends.cudnn.deterministic
            torch.backends.cudnn.deterministic = deterministic
            try:
                at_h = [paint(painter, h) for _ in range(repeats)]
                at_2h = paint(painter, 2 * h)
                short = paint(painter, calibrated - f)
            finally:
                torch.backends.cudnn.deterministic = prev
            key = "deterministic" if deterministic else "default"
            rec[key] = {
                "f32_h": [smoke._halo_ratio(a, ref) for a in at_h],
                "f32_2h": smoke._halo_ratio(at_2h, ref),
                "f32_h_vs_f32_2h": smoke._halo_ratio(at_h[0], at_2h),
                "repeat_spread": [smoke._halo_ratio(a, at_h[0])
                                  for a in at_h[1:]],
                "short_f32": smoke._halo_ratio(short, ref)}
        print(f"  {label}: {json.dumps(rec)}", flush=True)
        out[label] = rec
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--n", type=int, default=512)
    parser.add_argument("--repeats", type=int, default=4)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--out", default=None)
    args = parser.parse_args(argv)
    import torch
    from baryon_painter_tpu_torch import smoke
    from baryon_painter_tpu_torch.utils.platform import resolve_device

    device = resolve_device(args.device)
    card = (smoke.environment(device)["nvidia_smi"]
            if device.type == "cuda" else None)
    res = {"card": card, "n": args.n, "repeats": args.repeats,
           "torch": torch.__version__,
           "cudnn": (torch.backends.cudnn.version()
                     if device.type == "cuda" else None),
           "models": readings(device, args.n, args.repeats)}
    if args.out:
        with open(args.out, "w") as fh:
            json.dump(res, fh)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
