#!/usr/bin/env python
"""Gate a training run's loss trajectory against a reference-published log.

The PyTorch port's twin of ``scripts/compare_reference_stats.py``, with its
flags, its JSON report and its exit status. The reference publishes its
fiducial training history (format painter.py:462-463) and the port's
``TrainingStats`` writes the identical format, so convergence can be
diffed directly. Imports only numpy and the port (matplotlib for
``--plot`` alone); runs anywhere, no device.

Examples
--------
Shape-mode report of our flagship vs the published reference log (works
across datasets — compares normalized convergence profiles)::

    python scripts/compare_reference_stats_torch.py \
        --reference trained_models/CVAE/fiducial-512/training_stats.txt \
        --ours run/training_stats.txt

Absolute-mode regression gate between two of our own runs (same data,
fail if the smoothed ELBO deviates more than 10% anywhere)::

    python scripts/compare_reference_stats_torch.py --mode absolute --band 0.10 \
        --reference runs/r2/training_stats.txt --ours runs/r3/training_stats.txt

Exit status is 1 when ``--band`` is given and max deviation exceeds it.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from baryon_painter_tpu_torch.train.stats_compare import \
    compare_trajectories  # noqa: E402


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reference", required=True,
                   help="reference-format stats file to compare against")
    p.add_argument("--ours", required=True,
                   help="this framework's stats file (same format)")
    p.add_argument("--term", default="ELBO",
                   help="loss column to compare (prefix-matched; default ELBO)")
    p.add_argument("--our-term", default=None,
                   help="column name in --ours when it differs from --term")
    p.add_argument("--mode", choices=("shape", "absolute"), default="shape",
                   help="shape: scale-free convergence profiles (cross-"
                        "dataset); absolute: fractional value difference "
                        "(same-data regression gate)")
    p.add_argument("--checkpoints", type=int, default=20,
                   help="log-spaced sample-count checkpoints (default 20)")
    p.add_argument("--smooth", type=int, default=100,
                   help="moving-average window in batches (default 100, "
                        "matching TrainingStats)")
    p.add_argument("--per-sample", action="store_true",
                   help="divide by the batch_size column before comparing "
                        "(requires it in both logs)")
    p.add_argument("--band", type=float, default=None,
                   help="pass/fail threshold on max deviation; exit 1 beyond")
    p.add_argument("--out", default=None, help="write the report JSON here")
    p.add_argument("--plot", default=None,
                   help="write a trajectory-comparison PNG here")
    args = p.parse_args(argv)

    report = compare_trajectories(
        args.reference, args.ours, term=args.term, our_term=args.our_term,
        mode=args.mode, n_checkpoints=args.checkpoints,
        smooth_window=args.smooth, per_sample=args.per_sample)
    if args.band is not None:
        report["band"] = args.band
        report["pass"] = report["max_deviation"] <= args.band

    print(json.dumps(report))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        fig, (ax0, ax1) = plt.subplots(2, 1, sharex=True, figsize=(7, 6))
        ax0.plot(report["samples"], report["reference"], label="reference")
        ax0.plot(report["samples"], report["ours"], label="ours")
        ax0.set_xscale("log")
        ax0.set_ylabel(args.term)
        ax0.legend()
        ax1.plot(report["samples"], report["deviation"])
        if args.band is not None:
            ax1.axhline(args.band, color="r", ls="--", label=f"band {args.band}")
            ax1.legend()
        ax1.set_xlabel("samples")
        ax1.set_ylabel(f"{report['mode']} deviation")
        fig.tight_layout()
        fig.savefig(args.plot, dpi=120)

    if args.band is not None and not report["pass"]:
        print(f"FAIL: max deviation {report['max_deviation']:.4f} "
              f"> band {args.band}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
