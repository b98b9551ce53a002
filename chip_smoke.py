#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card (an H100 is the target).

    python3 chip_smoke.py

Builds K1 (the fused residual-block kernel, csrc/res_block.cu) with nvcc,
holds it against its plain PyTorch version, paints the committed 512^2
golden through ``CVAEPainter(fused_inference=True)`` on the card (K1 must
launch exactly 4 times), and times the painter and the kernel. The phases
live in ``baryon_painter_tpu_torch/smoke.py``; each prints one line with its
seconds. The last lines are the kernels record (JSON), the card's name and
power limit as nvidia-smi gives them, and the result (JSON). Any failed phase
raises and the script exits non-zero; without a CUDA device, or without the
package beside it, it exits non-zero and prints no result.

Imports only torch, numpy and the port.
"""
import json
import sys
import time


def main() -> int:
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA device", file=sys.stderr)
        return 2
    try:
        from baryon_painter_tpu_torch import smoke
    except ImportError as e:
        print(f"chip_smoke: the baryon_painter_tpu_torch package is not "
              f"importable here ({e}); run from the repository root",
              file=sys.stderr)
        return 2

    device = torch.device("cuda", 0)
    env = smoke.environment(device)
    smoke.build_kernels(device)
    checks = smoke.check_kernels(device)
    paint = smoke.paint_golden(device)
    timing = smoke.time_main_path(device, paint["painter"],
                                  card=env["nvidia_smi"])
    print(f"total {time.perf_counter() - t_start:.3f} s "
          f"(card: {env['nvidia_smi']})", flush=True)
    print(json.dumps(smoke.kernels_record(checks, paint, timing)))
    print(env["nvidia_smi"])
    print(json.dumps({"ok": True,
                      "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
