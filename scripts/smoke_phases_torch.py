#!/usr/bin/env python
"""Phases 13, 14 and 15 of ``chip_smoke.py`` (the bf16 training step, the
bf16 paint, the bf16 step with K4) from one checkout, under one routing
rule for the bf16 convolutions, to compare commits or rules in one call:

    python3 scripts/smoke_phases_torch.py ROOT RULE

ROOT is the root of a checkout whose ``baryon_painter_tpu_torch`` is
imported (for another commit, unpack ``git archive`` of it into a
directory that ``.gitignore`` lists). RULE is ``tree`` (the checkout's own
``models/layers.py``), ``align8`` (every bf16 conv whose channel counts
are not multiples of 8 runs in f32 on the rounded operands) or ``both11``
(every 1 -> 1 channel conv, plain and transposed). Reuses a kernel library
already built for the same sources. Prints the phases' lines and, last, a
line ``PHASES {json}`` with their times.

    python3 scripts/smoke_phases_torch.py ROOT mesh

runs phase 23 alone instead (``baryon_painter_tpu_torch/smoke_mesh.py``:
23c on a synthetic line of sight at the real sizes, 23d, 23a, 23b), and
builds the kernels first if they are not built.

    python3 scripts/smoke_phases_torch.py ROOT scripts

runs phase 24 alone (``baryon_painter_tpu_torch/smoke_scripts.py``: the
script twins, 24a-24d, on stacks it writes itself, since phase 20d's are
not there), building the kernels first.

Needs a CUDA device. Imports only torch and the port.
"""
import json
import os
import sys

root, rule = sys.argv[1], sys.argv[2]
sys.path.insert(0, os.path.abspath(root))

import torch  # noqa: E402

from baryon_painter_tpu_torch import (smoke, smoke_mesh,  # noqa: E402
                                      smoke_scripts)
from baryon_painter_tpu_torch.models import layers  # noqa: E402
from baryon_painter_tpu_torch.ops import _build  # noqa: E402

assert smoke.__file__.startswith(os.path.abspath(root)), smoke.__file__
if rule == "align8":
    layers._low_precision_in_f32 = lambda fn, x, w: (
        x.device.type == "cpu" or w.shape[0] % 8 != 0 or w.shape[1] % 8 != 0)
elif rule == "both11":
    layers._low_precision_in_f32 = lambda fn, x, w: (
        x.device.type == "cpu" or w.shape[0] == w.shape[1] == 1)
elif rule not in ("tree", "mesh", "scripts"):
    raise SystemExit(f"unknown rule {rule!r}")
dev = torch.device("cuda", 0)
card = smoke.environment(dev)["nvidia_smi"]
print("BUILD", _build.build_library()["path"], flush=True)
_build.load_library()
if rule == "scripts":
    out = smoke_scripts.scripts(dev, card=card)
    print("PHASES", json.dumps({
        "root": root, "rule": rule, "card": card,
        "24a": out["gate_variance"]["record"],
        "24a_peak_bytes": out["gate_variance"]["peak_bytes"],
        "24b": out["pk_diagnose"]["diff"],
        "24d": out["promote"]["files"]}), flush=True)
    sys.exit(0)
ds = smoke.training_data()
if rule == "mesh":
    with smoke.synthetic_lightcone(dev) as data:
        c = smoke_mesh.lightcone_sharded(dev, data)
    d = smoke_mesh.planes_sharded(dev)
    a = smoke_mesh.world_of_one(dev, ds)
    b = smoke_mesh.two_ranks(dev, ds, card=card)
    print("PHASES", json.dumps({"root": root, "rule": rule, "card": card,
          "23a": a["launches"], "23b": b["ranks"],
          "23c": c["launches"], "23d": d}), flush=True)
    sys.exit(0)
t13 = smoke.train(dev, ds, card=card, dtype=torch.bfloat16)
p14 = smoke.paint_bf16(dev, card=card)
t15 = smoke.train(dev, ds, card=card, dtype=torch.bfloat16,
                  fused_train_conv=True, k4_off_ms=t13["step_ms"])
print("PHASES", json.dumps({"root": root, "rule": rule, "card": card,
      "step13_ms": t13["step_ms"], "paint14_ms": p14["paint_ms"],
      "step15_ms": t15["step_ms"]}), flush=True)
