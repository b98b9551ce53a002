#!/usr/bin/env python
"""Which cuDNN kernels run the layers behind two readings of the port on
the card, from ``torch.profiler`` traces (``utils/profiling.device_trace``;
the H100 machine has no ``nsys``):

1. The f32 training step's gradient leaf furthest from the whole-model f64
   step. Phase 8b's plain step (``chip_smoke.py``: the fiducial CVAE at
   batch 24, 512^2, the plain gather, cuDNN's heads and trunk, cuDNN's
   deterministic algorithms) runs once in a trace, with the forward and
   the backward of every convolution in ``p_y_z_in``'s residual blocks
   marked by a range; then ``smoke.step_gradients_f64``. Prints each
   marked layer's weight-gradient distance from f64 (to its largest entry)
   beside the kernels launched inside its ranges, the worst first.
2. cuDNN's bf16 1 -> 1 channel ``conv2d``, which is wrong on the H100
   (``models/layers.py`` ``_conv`` runs that shape in f32 on the rounded
   operands): the shapes of those calls in the bf16 paints of three CVAE
   checkpoints (48 golden tiles, heads unfused, as
   ``scripts/bf16_conv_probe_torch.py`` captures them), each run by
   ``F.conv2d`` in bf16 straight through cuDNN on random operands, traced,
   under cuDNN's default and deterministic algorithms, against the f64
   conv of the same bf16 operands (relative to the largest entry; NaN if
   any output is not finite), with the kernels it launched.

Writes its findings as JSON to ``--out``; the traces stay under
``--trace-dir``.

    python3 scripts/cudnn_engines_torch.py --out engines.json

Needs a CUDA device; ``--cpu`` runs the same code on the CPU at a small
size (no device kernels there). Imports only torch, numpy and the port.
"""
import argparse
import json
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from baryon_painter_tpu_torch import smoke  # noqa: E402
from baryon_painter_tpu_torch.models.layers import Conv2d  # noqa: E402
from baryon_painter_tpu_torch.utils.profiling import (  # noqa: E402
    TRACE_FILE, device_trace, trace_kernels_in_ranges)

MARK = "layer "


def mark(module, name: str) -> list:
    """Ranges ``layer fwd NAME`` and ``layer bwd NAME`` around the
    module's forward and backward; returns the hook handles."""
    open_ = {}

    def enter(key):
        def hook(*_):
            rf = torch.profiler.record_function(f"{MARK}{key} {name}")
            rf.__enter__()
            open_[key] = rf
        return hook

    def leave(key):
        def hook(*_):
            open_.pop(key).__exit__(None, None, None)
        return hook

    return [module.register_forward_pre_hook(enter("fwd")),
            module.register_forward_hook(leave("fwd")),
            module.register_full_backward_pre_hook(enter("bwd")),
            module.register_full_backward_hook(leave("bwd"))]


def step_layers(device, dataset, trace_dir: str, batch: int,
                n_res_blocks: int) -> dict:
    """Finding 1 (module docstring): {layer: {"grad_err", "fwd", "bwd"}},
    the worst leaf first."""
    idx, eps = smoke.parity_inputs(dataset, batch)
    trainer = smoke.make_trainer(device, dataset, False, use_kernel=False,
                                 n_res_blocks=n_res_blocks)
    layers = {n: m for n, m in trainer.model.named_modules()
              if isinstance(m, Conv2d) and n.startswith("p_y_z_in.")
              and "ResidualBlock_" in n}
    handles = [h for n, m in layers.items() for h in mark(m, n)]
    try:
        with smoke._cudnn_algorithms(True), device_trace(trace_dir):
            trainer.step_indices(idx, 1e-4, eps=eps)
    finally:
        for h in handles:
            h.remove()
    grads = {n: p.grad.detach().clone()
             for n, p in trainer.model.named_parameters() if p.requires_grad}
    del trainer
    _, grads64 = smoke.step_gradients_f64(device, dataset, idx, eps,
                                          n_res_blocks)
    errs = smoke.step_grad_errors(grads, grads64)[0]
    ranges = trace_kernels_in_ranges(os.path.join(trace_dir, TRACE_FILE),
                                     MARK)
    out = {n: {"grad_err": errs[f"{n}.weight"],
               "fwd": ranges.get(f"{MARK}fwd {n}", []),
               "bwd": ranges.get(f"{MARK}bwd {n}", [])} for n in layers}
    worst = max(errs, key=errs.get)
    return {"worst_leaf": worst, "worst_leaf_err": errs[worst],
            "layers": dict(sorted(out.items(),
                                  key=lambda kv: -kv[1]["grad_err"]))}


PAINTERS = {"fiducial-512": ("trained_models/CVAE/fiducial-512/model", 512),
            "fiducial-resize": ("trained_models/CVAE/fiducial-resize/model",
                                256),
            "physical-512-resize-wip": (
                "trained_models/CVAE/physical-512-resize-wip/model", 512)}


def conv_1to1_configs(device, n: int, tile: int = None) -> dict:
    """The bf16 1 -> 1 channel ``conv2d`` calls of the CVAE painters' bf16
    paints (heads unfused; ``n`` golden tiles, at ``tile`` or each
    checkpoint's own): {(input shape, weight shape, keywords): painters}."""
    from baryon_painter_tpu_torch.models import layers
    from baryon_painter_tpu_torch.painter import load_painter
    found, real = {}, layers._conv

    def capture(fn, x, weight, bias, dtype, **kw):
        if (fn is F.conv2d and weight.shape[0] == weight.shape[1] == 1
                and (dtype or x.dtype) == torch.bfloat16):
            key = (tuple(x.shape), tuple(weight.shape),
                   tuple(sorted(kw.items())))
            found.setdefault(key, []).append(name)
        return real(fn, x, weight, bias, dtype, **kw)

    layers._conv = capture
    try:
        for name, (base, own) in PAINTERS.items():
            t = tile or own
            p = load_painter(os.path.join(smoke.REPO, base),
                             dtype=torch.bfloat16, device=device,
                             fused_heads=False)
            g = torch.Generator(device=device).manual_seed(0)
            p.paint_batch(smoke.golden_inputs(t, n), np.zeros(n, np.float32),
                          generator=g)
    finally:
        layers._conv = real
    return {k: sorted(set(v)) for k, v in found.items()}


def conv_1to1(device, trace_dir: str, n: int, tile: int = None) -> list:
    """Finding 2 (module docstring): each captured shape through cuDNN in
    bf16 under its default and deterministic algorithms: [{"x", "w",
    "kw", "painters", algorithms: {"err", "kernels"}}]."""
    out = []
    torch.manual_seed(0)
    for i, ((xs, ws, kw), painters) in enumerate(
            sorted(conv_1to1_configs(device, n, tile).items())):
        x = torch.randn(xs, device=device).to(torch.bfloat16)
        w = (0.3 * torch.randn(ws, device=device)).to(torch.bfloat16)
        ref = F.conv2d(x.double(), w.double(), **dict(kw))
        row = {"x": xs, "w": ws, "kw": dict(kw), "painters": painters}
        for label, deterministic in (("default", False),
                                     ("deterministic", True)):
            sub = os.path.join(trace_dir, f"conv_{i}_{label}")
            with smoke._cudnn_algorithms(deterministic), device_trace(sub):
                with torch.profiler.record_function(f"{MARK}conv"):
                    y = F.conv2d(x, w, **dict(kw))
            finite = bool(torch.isfinite(y).all())
            err = ((y.double() - ref).abs().max()
                   / ref.abs().max()).item()
            kernels = trace_kernels_in_ranges(os.path.join(sub, TRACE_FILE),
                                              MARK)
            row[label] = {"err": err if finite else float("nan"),
                          "kernels": kernels.get(f"{MARK}conv", [])}
        out.append(row)
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="cudnn_engines.json")
    ap.add_argument("--trace-dir", default=None,
                    help="where the traces go (default: a temporary "
                         "directory, removed at the end)")
    ap.add_argument("--cpu", action="store_true",
                    help="the same code on the CPU at a small size")
    a = ap.parse_args(argv)
    device = torch.device("cpu" if a.cpu else "cuda")
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    tile, batch, blocks = (32, 2, 1) if a.cpu else (
        smoke.TRAIN_TILE, smoke.TRAIN_BATCH, smoke.N_RES_BLOCKS)
    with tempfile.TemporaryDirectory() as tmp:
        trace_dir = a.trace_dir or tmp
        dataset = smoke.training_data(tile=tile)
        res = {"card": (smoke.environment(device)["nvidia_smi"]
                        if device.type == "cuda" else None),
               "step": step_layers(device, dataset,
                                   os.path.join(trace_dir, "step"), batch,
                                   blocks),
               "conv_1to1_bf16": conv_1to1(device, trace_dir,
                                           2 if a.cpu else 48,
                                           tile if a.cpu else None)}
    step = res["step"]
    print(f"worst leaf against f64: {step['worst_leaf']} "
          f"{step['worst_leaf_err']:.3e}", flush=True)
    for name, r in list(step["layers"].items())[:4]:
        print(f"  {name}: {r['grad_err']:.3e}; fwd {r['fwd']}; bwd "
              f"{r['bwd']}", flush=True)
    for r in res["conv_1to1_bf16"]:
        for label in ("default", "deterministic"):
            print(f"bf16 1 -> 1 conv2d {r['x']} {r['w']} {r['kw']} "
                  f"({', '.join(r['painters'])}), cuDNN {label} "
                  f"algorithms: err {r[label]['err']:.3e}; kernels "
                  f"{r[label]['kernels']}", flush=True)
    with open(a.out, "w") as f:
        json.dump(res, f, indent=1, default=float)
    return res


if __name__ == "__main__":
    main()
