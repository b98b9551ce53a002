#!/usr/bin/env python3
"""A/B of the port's training step between checkouts, on one CUDA card.

    python3 scripts/ab_train_step.py ROOT_A ROOT_B [--iters 10] [--warmup 3]
        [--fused-train-conv]

Times ``CVAETrainer.step_indices`` of the fiducial CVAE at batch 24 and
512^2 (``smoke.training_data``, ``smoke.make_trainer`` with K3's heads, K2's
gather, and ``fused_train_conv`` (K4) off, or on with
``--fused-train-conv``) as the ``baryon_painter_tpu_torch`` found
under each ROOT computes it, and the peak device memory allocated over the
timed steps. Each run is a process of its own that imports the package from
its ROOT (and builds that checkout's kernels there), in turns: A, B, B, A.
Host clock around ``iters`` steps that end in a synchronise, after
``warmup``; TF32 off. Prints one line per run and, last, the runs as JSON,
with the card's name and power limit. Needs a CUDA device.
"""
import argparse
import json
import subprocess
import sys
from pathlib import Path

_RUN = r"""
import json, sys, time
import numpy as np
import torch
sys.path.insert(0, sys.argv[1])
from baryon_painter_tpu_torch import smoke
iters, warmup = int(sys.argv[2]), int(sys.argv[3])
fused_train_conv = sys.argv[4] == "1"
if not torch.cuda.is_available():
    raise SystemExit("ab_train_step: needs a CUDA device")
assert smoke.__file__.startswith(sys.argv[1]), smoke.__file__
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
device = torch.device("cuda", 0)
ds = smoke.training_data()
trainer = smoke.make_trainer(device, ds, True,
                             fused_train_conv=fused_train_conv)
rng = np.random.default_rng(1)
idx = [ds.sample_indices(rng, smoke.TRAIN_BATCH)
       for _ in range(warmup + iters)]
for i in range(warmup):
    trainer.step_indices(idx[i], 1e-4)
torch.cuda.synchronize()
torch.cuda.reset_peak_memory_stats(device)
t0 = time.perf_counter()
for i in range(iters):
    trainer.step_indices(idx[warmup + i], 1e-4)
torch.cuda.synchronize()
ms = (time.perf_counter() - t0) * 1e3 / iters
print(json.dumps({"step_ms": ms, "batch": smoke.TRAIN_BATCH,
                  "fused_train_conv": fused_train_conv,
                  "peak_memory_gb": torch.cuda.max_memory_allocated(device)
                  / 1e9}))
"""


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs=2, type=Path)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--fused-train-conv", action="store_true",
                    help="train with K4 (the fused conv + BN + ReLU)")
    args = ap.parse_args()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "--id=0"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip()
    a, b = (str(r.resolve()) for r in args.roots)
    runs = []
    for label, root in (("A", a), ("B", b), ("B", b), ("A", a)):
        out = subprocess.run(
            [sys.executable, "-c", _RUN, root, str(args.iters),
             str(args.warmup), str(int(args.fused_train_conv))],
            capture_output=True, text=True,
            timeout=1200, cwd=root)
        if out.returncode != 0:
            raise SystemExit(f"ab_train_step: run {label} ({root}) failed:\n"
                             f"{out.stdout}{out.stderr}")
        rec = {"label": label, "root": root,
               **json.loads(out.stdout.strip().splitlines()[-1])}
        runs.append(rec)
        print(f"{label} {root}: {rec['step_ms']:.3f} ms per step of batch "
              f"{rec['batch']}, K4 "
              f"{'on' if args.fused_train_conv else 'off'}, peak device "
              f"memory "
              f"{rec['peak_memory_gb']:.3f} GB ({card})", flush=True)
    print(json.dumps({"card": card, "iters": args.iters,
                      "fused_train_conv": args.fused_train_conv,
                      "runs": runs}))


if __name__ == "__main__":
    main()
