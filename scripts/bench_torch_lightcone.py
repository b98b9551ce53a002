#!/usr/bin/env python
"""Lightcone benchmark of the PyTorch port: one full SLICS line of sight.

The twin of ``scripts/bench_lightcone.py``. Writes a synthetic line of sight
at the real SLICS sizes (15 shells of 7745^2 delta planes, the two low-z
shells from 12288^2 massplanes, a 7745^2 convergence map; about 4.8 GB,
made on the card) to a temporary directory, then paints it through the
lightcone CLI's own code (``scripts/create_lightcone_torch.py``) as users
run it: bf16, ``--fused-paint`` and ``BPT_FUSED_HEADS=1`` (K1 and K3),
overlap 0.2 (370 tiles of 512^2 in the 13 delta shells, 1 in each massplane
shell), the 1549^2 Compton-y map and its cross-Cl with kappa. One warm-up
line of sight, then ``--repeats`` timed ones: the whole call by the host
clock, each shell's stages by CUDA events. Prints one line per run and, last,
one JSON object with the card's name and power limit.

    python3 scripts/bench_torch_lightcone.py [--shells 15] [--repeats 2]

Needs one CUDA device; imports only torch, numpy and the port.
"""
import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

Z_SLICS = (0.042, 0.130, 0.221, 0.317, 0.418, 0.525, 0.640, 0.764, 0.897,
           1.041, 1.199, 1.372, 1.562, 1.772, 2.007)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--shells", type=int, default=len(Z_SLICS))
    parser.add_argument("--repeats", type=int, default=2)
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("bench_torch_lightcone: needs a CUDA device", file=sys.stderr)
        return 2
    from baryon_painter_tpu_torch import smoke
    from baryon_painter_tpu_torch.lightcone.synthetic import \
        write_synthetic_los

    device = torch.device("cuda", 0)
    card = smoke.environment(device)["nvidia_smi"]
    z = Z_SLICS[:args.shells]
    shells = smoke.lightcone_geometry(z)
    with tempfile.TemporaryDirectory(prefix="bpt_lightcone_bench_") as base:
        los = write_synthetic_los(base, z, smoke.LC_LOS, device=device)
        smoke.run_lightcone_cli(device, los, "bf16", True, kappa=True)
        runs = [smoke.time_lightcone(device, los, card=card)
                for _ in range(args.repeats)]
    print(json.dumps({
        "card": card, "shells": len(z), "kinds": los["kinds"],
        "tiles": runs[0]["tiles"],
        "paint_calls": sum(s["calls"] for s in shells),
        "los_s": [r["los_s"] for r in runs],
        "shells_device_ms": [r["shells_device_ms"] for r in runs],
        "lightcone_tiles_per_s": [r["tiles_per_s"] for r in runs],
        "stages_ms": [r["stages"] for r in runs],
        "per_shell_ms": runs[-1]["shells"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
