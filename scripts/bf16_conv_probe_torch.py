#!/usr/bin/env python
"""Which of the painters' bf16 convolutions cuDNN gets wrong on the card,
and whether ``models/layers.py``'s f32 route covers them.

1. Captures every distinct convolution (function, input and weight shape,
   stride, padding) that ``layers._conv`` runs in the bf16 paints (heads
   unfused) of fiducial-512, fiducial-resize and physical-512-resize-wip
   (48 tiles) and of the CGAN (48 tiles of 256^2).
2. Runs each shape through cuDNN in bf16 on random operands against the
   f64 conv of the same rounded operands (error relative to the largest
   entry; NaN if any output is not finite): with the caching allocator's
   free memory zeroed (``zero_cache``) or filled with NaN (``nan_cache``),
   the weight or the input copied into NaN-filled memory, NaN in the free
   memory that the output and workspace take, and a channels_last input;
   for shapes with one channel on either side also the backward (grad
   input, grad weight).
3. Paints each model in bf16 after filling the free memory with NaN,
   twice under each routing rule (``none``: no f32 route on the card;
   ``tree``: the package's own; ``align8``: every conv whose channel
   counts are not multiples of 8), against the paint that runs every conv
   in f32 on the rounded operands (rel. L2; NaN if not finite).
4. ``chip_smoke.py``'s gate (phase 20a once; 20b four times at cuDNN's
   default algorithms and twice under its deterministic ones): each bf16
   reading's distance from the JAX package's CPU bf16 over its limit.

Prints its findings as it goes and writes them as JSON to ``--out``.

    python3 scripts/bf16_conv_probe_torch.py --out probe.json

Needs a CUDA device. Imports only torch, numpy and the port.
"""
import argparse
import json
import os
import subprocess
import sys
import traceback

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from baryon_painter_tpu_torch import smoke  # noqa: E402
from baryon_painter_tpu_torch.models import layers  # noqa: E402

ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
ap.add_argument("--out", default="bf16_conv_probe.json")
out_path = ap.parse_args().out
os.chdir(os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

dev = torch.device("cuda", 0)
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
BF = torch.bfloat16
OUT = {}

def log(*a):
    print(*a, flush=True)

tree_rule = layers._low_precision_in_f32
RULES = {
    "none": lambda fn, x, w: x.device.type == "cpu",
    "tree": tree_rule,
    "align8": lambda fn, x, w: x.device.type == "cpu" or w.shape[0] % 8 != 0 or w.shape[1] % 8 != 0,
    "always": lambda fn, x, w: True,
}

def set_rule(name):
    layers._low_precision_in_f32 = RULES[name]

def fill_cache(value, small_mb=64, large_gb=6):
    """Leave the caching allocator's free blocks filled with ``value``."""
    torch.cuda.synchronize()
    keep = []
    for _ in range(small_mb):  # small pool: <= 1 MB blocks in 2 MB segments
        keep.append(torch.full((1 << 19,), value, dtype=BF, device=dev))
    for _ in range(4 * small_mb):
        keep.append(torch.full((4096,), value, dtype=BF, device=dev))
    for _ in range(4 * small_mb):
        keep.append(torch.full((64,), value, dtype=BF, device=dev))
    big = torch.full((large_gb << 29,), value, dtype=BF, device=dev)
    torch.cuda.synchronize()
    del keep, big

nvsmi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                       capture_output=True, text=True).stdout.strip()
log("card", nvsmi, "torch", torch.__version__, "cudnn", torch.backends.cudnn.version())
smoke.build_kernels(dev)

# 1. capture every conv call of the bf16 paints (unfused heads) -------------
from baryon_painter_tpu_torch.painter import load_painter
CKPTS = {"fiducial-512": ("trained_models/CVAE/fiducial-512/model", 512, 48),
         "fiducial-resize": ("trained_models/CVAE/fiducial-resize/model", 256, 48),
         "physical-512-resize-wip": ("trained_models/CVAE/physical-512-resize-wip/model", 512, 48),
         "cgan": ("trained_models/CGAN/fiducial/model", 256, 48)}
configs = {}
orig_conv = layers._conv
def capturing(fn, x, weight, bias, dtype, **kw):
    key = (fn.__name__, tuple(x.shape), tuple(weight.shape), tuple(sorted(kw.items())))
    configs.setdefault(key, tuple(x.stride()))
    return orig_conv(fn, x, weight, bias, dtype, **kw)

def paint(name, rule, fused=False, dtype=BF, seed=0):
    base, tile, n = CKPTS[name]
    set_rule(rule)
    kw = dict(dtype=dtype, device=dev)
    if name != "cgan":
        kw["fused_heads"] = fused
    p = load_painter(base, **kw)
    x = smoke.golden_inputs(tile, n, seed=seed)
    zs = np.zeros(n, np.float32)
    g = torch.Generator(device=dev).manual_seed(0)
    if name == "cgan":
        out = p.paint_batch(x, zs)
    else:
        out = p.paint_batch(x, zs, generator=g)
    torch.cuda.synchronize()
    return out.float()

layers._conv = capturing
for name in CKPTS:
    try:
        paint(name, "tree")
    except Exception:
        traceback.print_exc()
layers._conv = orig_conv
log("captured", len(configs), "conv configs")

# 2. poison sweep over the captured configs ---------------------------------
def conv_call(fnname, x, w, kw):
    fn = getattr(F, fnname)
    return fn(x, w, None, **dict(kw))

def reference(fnname, x16, w16, kw):
    return conv_call(fnname, x16.double(), w16.double(), kw)

def err(out, ref):
    out = out.double()
    if not torch.isfinite(out).all():
        return float("nan")
    scale = ref.abs().max().item()
    return (out - ref).abs().max().item() / max(scale, 1e-30)

def in_buffer(t, value, pad=4096):
    """t copied into the middle of a buffer filled with ``value``."""
    n = t.numel()
    buf = torch.full((n + 2 * pad,), value, dtype=t.dtype, device=dev)
    buf[pad:pad + n].copy_(t.reshape(-1))
    return buf[pad:pad + n].view(t.shape)

sweep = []
torch.manual_seed(0)
for (fnname, xs, ws, kw), xstride in sorted(configs.items()):
    row = {"fn": fnname, "x": xs, "w": ws, "kw": dict(kw), "x_stride": xstride}
    try:
        x16 = torch.randn(xs, device=dev).to(BF)
        w16 = (0.3 * torch.randn(ws, device=dev)).to(BF)
        ref = reference(fnname, x16, w16, kw)
        fill_cache(0.0)
        row["zero_cache"] = err(conv_call(fnname, x16, w16, kw), ref)
        fill_cache(float("nan"))
        xa, wa = x16.clone(), w16.clone()       # in NaN-tailed memory
        row["nan_cache"] = err(conv_call(fnname, xa, wa, kw), ref)
        del xa, wa
        fill_cache(0.0)
        row["nan_tail_weight"] = err(conv_call(fnname, x16, in_buffer(w16, float("nan")), kw), ref)
        fill_cache(0.0)
        row["nan_around_input"] = err(conv_call(fnname, in_buffer(x16, float("nan")), w16, kw), ref)
        fill_cache(float("nan"))                 # output and workspace only
        row["nan_out_workspace"] = err(conv_call(fnname, x16, w16, kw), ref)
        fill_cache(0.0)
        # channels_last input (the painter's layout)
        row["nan_tail_weight_cl"] = err(conv_call(
            fnname, x16.contiguous(memory_format=torch.channels_last),
            in_buffer(w16, float("nan")), kw), ref)
        if ws[0] == 1 or ws[1] == 1:
            # the backward (grad input, grad weight) with NaN-tailed weight / cache
            gy = torch.randn(ref.shape, device=dev).to(BF)
            transposed = fnname == "conv_transpose2d"
            kwd = dict(kw)
            stride = [kwd.get("stride", 1)] * 2
            padding = [kwd.get("padding", 0)] * 2
            opad = [kwd.get("output_padding", 0)] * 2
            def bwd(x, w, g):
                return torch.ops.aten.convolution_backward(
                    g, x, w, None, stride, padding, [1, 1], transposed,
                    opad, 1, [True, True, False])[:2]
            gx_ref, gw_ref = bwd(x16.double(), w16.double(), gy.double())
            fill_cache(float("nan"))
            gx, gw = bwd(x16.clone(), w16.clone(), gy.clone())
            row["bwd_nan_cache"] = [err(gx, gx_ref), err(gw, gw_ref)]
            fill_cache(0.0)
            gx, gw = bwd(x16, in_buffer(w16, float("nan")), gy)
            row["bwd_nan_tail_weight"] = [err(gx, gx_ref), err(gw, gw_ref)]
    except Exception as e:
        row["error"] = repr(e)[:300]
    sweep.append(row)
    log("SWEEP", json.dumps(row))
    torch.cuda.empty_cache()
OUT["sweep"] = sweep

# 3. model level: each rule, after a NaN-filled cache, 2 repeats -------------
model = {}
for name in ("fiducial-512", "fiducial-resize", "physical-512-resize-wip", "cgan"):
    try:
        fill_cache(0.0)
        want = paint(name, "always")
        for rule in ("none", "tree", "align8"):
            for rep in range(2):
                fill_cache(float("nan"))
                got = paint(name, rule)
                fin = bool(torch.isfinite(got).all())
                d = float(((got - want).norm() / want.norm()).item()) if fin else float("nan")
                model.setdefault(name, {}).setdefault(rule, []).append(d)
                log("MODEL", name, rule, rep, "finite", fin, "rel_l2_vs_always_f32", d)
    except Exception:
        traceback.print_exc()
OUT["model"] = model
set_rule("tree")

# 4. 20a once, 20b four times at the defaults and twice deterministic -------
card = smoke.environment(dev)["nvidia_smi"]
g20 = {"20b_default": [], "20b_deterministic": [], "20a": []}
def gate_rows(kind):
    try:
        if kind == "cvae":
            r = smoke.gate_check(dev, smoke.CHECKPOINT, {"k1": 4, "k3_fwd": 1}, "cvae",
                                 fallback=smoke.GATE_CVAE_DATASET, redshifts=smoke.GATE_CVAE_Z,
                                 card=card)
        else:
            r = smoke.gate_check(dev, smoke.CGAN_PATH, {"k1": 9}, "cgan", seeds=1,
                                 card=card, phase="20b")
        return {"fails": [list(map(str, f)) for f in r["fails"]],
                "bf16_over_limit": {k: v["bf16_vs_jax"] / v["bf16_limit"] for k, v in r["rows"].items()},
                "bf16_vs_jax": {k: v["bf16_vs_jax"] for k, v in r["rows"].items()}}
    except Exception as e:
        traceback.print_exc()
        return {"error": repr(e)[:300]}
g20["20a"].append(gate_rows("cvae"))
for _ in range(4):
    g20["20b_default"].append(gate_rows("cgan"))
with smoke._cudnn_algorithms(True):
    for _ in range(2):
        g20["20b_deterministic"].append(gate_rows("cgan"))
for k, v in g20.items():
    for r in v:
        log("GATE", k, json.dumps(r))
OUT["gate"] = g20
os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
with open(out_path, "w") as f:
    json.dump({"card": nvsmi, **OUT}, f)
log("probe done")
