#!/usr/bin/env python
"""Lightcone fan-out over processes, the PyTorch port's twin of
``scripts/lightcone_fanout.py``.

Each process paints the lines of sight congruent to its process index,
one ``scripts/create_lightcone_torch.py`` subprocess a line of sight, in
place of the reference's SLURM array of independent jobs:

    python scripts/lightcone_fanout_torch.py --los 74 75 76 77 ... \
        --coordinator host0:1234 --num-processes 4 --process-id $RANK ...

The coordinates come from ``parallel.mesh.initialize_multihost`` (with
``--coordinator``, or torchrun's environment with ``--torchrun``; gloo, as
the processes only agree on their indices) or from ``--process-id`` /
``--num-processes`` alone. Unknown arguments pass through to
``create_lightcone_torch.py`` verbatim. Imports only torch and the port.
"""
import argparse
import os
import subprocess
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--los", nargs="+", type=int, required=True)
    p.add_argument("--coordinator", default=None,
                   help="init method of process 0: host:port (tcp) or a "
                        "file:// path (torch.distributed)")
    p.add_argument("--torchrun", action="store_true",
                   help="take the coordinates from torchrun's environment")
    p.add_argument("--num-processes", type=int, default=None)
    p.add_argument("--process-id", type=int, default=None)
    p.add_argument("--output-base", default="y_map")
    args, passthrough = p.parse_known_args()

    if args.coordinator is not None or args.torchrun:
        from baryon_painter_tpu_torch.parallel.mesh import \
            initialize_multihost
        # the group only agrees on the process indices: the painting runs
        # in each line of sight's own create_lightcone_torch.py
        mesh = initialize_multihost("gloo", args.coordinator,
                                    args.num_processes, args.process_id,
                                    device="cpu")
        if mesh is None:
            raise RuntimeError("--torchrun: no torchrun environment found")
        pid, nproc = mesh.rank, mesh.size
    else:
        pid = args.process_id or 0
        nproc = args.num_processes or 1

    mine = args.los[pid::nproc]
    print(f"process {pid}/{nproc}: painting LOS {mine}")
    for los in mine:
        cmd = [sys.executable,
               os.path.join(os.path.dirname(__file__),
                            "create_lightcone_torch.py"),
               "--SLICS-LOS", str(los),
               "--output-file", f"{args.output_base}_LOS{los}",
               *passthrough]
        subprocess.run(cmd, check=True)


if __name__ == "__main__":
    main()
