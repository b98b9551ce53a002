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

    python3 scripts/smoke_phases_torch.py ROOT k1

runs K1's phases alone: 2 (K1 against its plain version at the main
path's shape and the design's edges), 3 and 4 (the golden paint, then the
paint and K1 timed beside cuDNN's block and the bound), 17a and 17d (the
CGAN's shapes, its paint and K1 timed), building the kernels first; the
checkout's own functions, so a parent's checkout runs its own kernel.

    python3 scripts/smoke_phases_torch.py ROOT k4

runs K4's phases alone: 10 and 10b (K4 against its plain version at the
four sites, f32 and bf16, each kernel timed with bwd2's launches apart,
beside cuDNN's backward and its adjoints from a given du), 8 and 11 (the
f32 step without and with K4), 11b, 13 and 15 (bf16 without and with
K4), 15b and 23b; the checkout's own functions, so a parent's checkout
runs its own kernels (its record may lack bwd2's launches apart).

    python3 scripts/smoke_phases_torch.py ROOT k3

runs K3's phases alone: 7 and 7b (K3-fwd and K3-bwd against their plain
versions at the training shape, f32 and bf16, each timed beside cuDNN's
heads), K3-fwd timed at the paint shape (16, 512, 512) without u1 in both
dtypes, 8 and 8b (the f32 step and its parity), 9 (the golden painted with
K3's heads, timed), 13 and 13b (the bf16 step and its parity) and 14 (the
bf16 paint, timed), building the kernels first; the checkout's own
functions, so a parent's checkout runs its own kernels.

    python3 scripts/smoke_phases_torch.py ROOT f64

runs phase 15c alone (the f32 and bf16 kernels steps against the
whole-model f64 step under cuDNN's default algorithms, K4 off and on),
building the kernels first.

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
elif rule not in ("tree", "mesh", "scripts", "k1", "k3", "k4", "f64"):
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
if rule == "k1":
    checks = smoke.check_kernels(dev)
    paint = smoke.paint_golden(dev)
    timing = smoke.time_main_path(dev, paint["painter"], card=card)
    cgan_checks = smoke.check_k1_cgan(dev)
    cgan_timing = smoke.time_cgan(dev, card=card)
    print("PHASES", json.dumps({
        "root": root, "rule": rule, "card": card,
        "2": [{k: c[k] for k in ("shape", "dtype", "slope", "max_abs_err",
                                 "tol")} for c in checks + cgan_checks],
        "4": {k: v for k, v in timing.items() if k.endswith("_ms")
              or k.startswith(("k1_", "plain_ms_", "library_ms_"))
              or k == "tiles_per_s"},
        "17d": {k: v for k, v in cgan_timing.items()
                if not k.startswith("bound")}}), flush=True)
    sys.exit(0)
ds = smoke.training_data()
if rule == "k3":
    from baryon_painter_tpu_torch.ops.head_stack import head_stack_fwd
    bf16 = torch.bfloat16
    keys = ("errors", "fwd_ms", "fwd_without_u1_ms", "fwd_plain_ms",
            "fwd_library_ms", "bwd_ms", "bwd_plain_ms", "bwd_library_ms")
    h7 = smoke.check_heads(dev)
    h7b = smoke.check_heads(dev, dtype=bf16)
    paint_fwd = {}
    for dt in (torch.float32, bf16):
        x, w1, w2, w3, al, _ = smoke.head_inputs(16, 512, 512, dev)
        x = x.to(dt)
        paint_fwd[str(dt)] = smoke._time_ms(
            lambda: head_stack_fwd(x, w1, w2, w3, al), dev, 2, 10)
        del x
    t8 = smoke.train(dev, ds, card=card)
    p8b = smoke.train_parity(dev, ds)
    p9 = smoke.paint_fused_heads(dev, card=card)
    t13 = smoke.train(dev, ds, card=card, dtype=bf16, f32_ms=t8["step_ms"])
    p13b = smoke.train_parity_bf16(dev, ds)
    p14 = smoke.paint_bf16(dev, card=card, f32_ms=p9["paint_ms"])
    print("PHASES", json.dumps({
        "root": root, "rule": rule, "card": card,
        "7": {k: h7[k] for k in keys}, "7b": {k: h7b[k] for k in keys},
        "k3_fwd_paint16_ms": paint_fwd,
        "step8_ms": t8["step_ms"], "step8_peak_bytes": t8.get("peak_bytes"),
        "8b": p8b, "paint9_ms": p9["paint_ms"],
        "step13_ms": t13["step_ms"],
        "step13_peak_bytes": t13.get("peak_bytes"), "13b": p13b,
        "paint14_ms": p14["paint_ms"]}, default=str), flush=True)
    sys.exit(0)
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
if rule == "f64":
    p15c = smoke.train_parity_f64(dev, ds, card=card)
    print("PHASES", json.dumps({"root": root, "rule": rule, "card": card,
                                "15c": p15c}, default=str), flush=True)
    sys.exit(0)
if rule == "k4":
    bf16 = torch.bfloat16

    def sites(rec):
        keys = ("ms", "bwd2_parts_ms", "library_bwd_ms",
                "library_adjoints_ms", "library_fwd_ms", "errors",
                "u_stats_vs_bwd1")
        return {n: {k: r.get(k) for k in keys}
                for n, r in rec["sites"].items()}

    c10 = smoke.check_conv_bn(dev, card=card)
    c10b = smoke.check_conv_bn(dev, card=card, dtype=bf16)
    t8 = smoke.train(dev, ds, card=card)
    t11 = smoke.train(dev, ds, card=card, fused_train_conv=True,
                      k4_off_ms=t8["step_ms"])
    p11b = smoke.train_parity(dev, ds, fused_train_conv=True)
    t13 = smoke.train(dev, ds, card=card, dtype=bf16, f32_ms=t8["step_ms"])
    t15 = smoke.train(dev, ds, card=card, dtype=bf16, fused_train_conv=True,
                      k4_off_ms=t13["step_ms"], f32_ms=t11["step_ms"])
    p15b = smoke.train_parity_bf16(dev, ds, fused_train_conv=True)
    b23 = smoke_mesh.two_ranks(dev, ds, card=card)
    print("PHASES", json.dumps({
        "root": root, "rule": rule, "card": card,
        "10": sites(c10), "10b": sites(c10b),
        "step8_ms": t8["step_ms"], "step11_ms": t11["step_ms"],
        "step13_ms": t13["step_ms"], "step15_ms": t15["step_ms"],
        "11b": p11b, "15b": p15b, "23b": b23["ranks"]}, default=str),
        flush=True)
    sys.exit(0)
t13 = smoke.train(dev, ds, card=card, dtype=torch.bfloat16)
p14 = smoke.paint_bf16(dev, card=card)
t15 = smoke.train(dev, ds, card=card, dtype=torch.bfloat16,
                  fused_train_conv=True, k4_off_ms=t13["step_ms"])
print("PHASES", json.dumps({"root": root, "rule": rule, "card": card,
      "step13_ms": t13["step_ms"], "paint14_ms": p14["paint_ms"],
      "step15_ms": t15["step_ms"]}), flush=True)
