"""Where the time of the port's training step goes, on one CUDA card.

    python -m baryon_painter_tpu_torch.profile_train [--batch 24] [--iters 10]
        [--fused-train-conv]

Trains the fiducial CVAE (512^2 tiles, 4 residual blocks, the synthetic
stacks and transforms of ``smoke.training_data``) with ``step_indices``:
the batch gathered on the card through K2, and two variants in turns (the
first, the second, the second, the first), each ``iters`` steps after
``warmup``: the output heads through cuDNN (``fused_heads=False``) and
through K3 (``fused_heads=True``); or, with ``--fused-train-conv``, both
with K3's heads, the train-mode conv + batch norm + ReLU triples through
cuDNN and the port's BatchNorm (``fused_train_conv=False``) and through K4
(``fused_train_conv=True``). For
each it prints ms per step (host clock around steps that end in a
synchronise) and samples/s; then, per variant, from one torch.profiler
window (CUDA activity only) over ``iters`` steps, the device time by kernel
and the device's idle share, 1 - (union of device intervals per step) /
(ms per step); and the device time of each stage (CUDA events: batch
assembly and transforms before the model, the forward, the backward and
Adam after it) and of each subnet's forward (CUDA events in forward
hooks), with the K4 kernels' device time per step by name. TF32 is off.
The full record is printed as the last line (JSON).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from baryon_painter_tpu_torch import smoke


def _steps(trainer, idx, lr):
    for i in idx:
        trainer.step_indices(i, lr)


def _device_profile(fn, iters: int, top: int, step_ms: float) -> dict:
    """Device kernels over ``fn()`` (``iters`` steps): time by kernel name
    and the union of device intervals per step, against ``step_ms``."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    spans, by_name = [], {}
    for ev in prof.events():
        if ev.device_type != DeviceType.CUDA:
            continue
        start, end = ev.time_range.start, ev.time_range.end
        spans.append((start, end))
        row = by_name.setdefault(ev.name[:120], [0, 0.0])
        row[0] += 1
        row[1] += end - start
    busy_us, cur_start, cur_end = 0.0, None, None
    for start, end in sorted(spans):
        if cur_end is None or start > cur_end:
            if cur_end is not None:
                busy_us += cur_end - cur_start
            cur_start, cur_end = start, end
        else:
            cur_end = max(cur_end, end)
    if cur_end is not None:
        busy_us += cur_end - cur_start
    busy_ms = busy_us / 1e3 / iters
    rows = sorted(({"name": k, "calls_per_step": n / iters,
                    "device_ms_per_step": us / 1e3 / iters}
                   for k, (n, us) in by_name.items()),
                  key=lambda r: -r["device_ms_per_step"])
    return {"device_busy_ms_per_step": busy_ms,
            "idle_share": 1.0 - busy_ms / step_ms, "top_kernels": rows[:top],
            "all_kernels": rows}


def _stage_times(trainer, idx, lr) -> dict:
    """Device ms per step of each stage and of each subnet's forward, from
    CUDA events: the step's start and end, and forward hooks on the model
    and its subnets."""
    model = trainer.model
    marks, handles = {}, []

    def mark(key):
        def hook(*_):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            marks.setdefault(key, []).append(ev)
        return hook

    subnets = {name: m for name, m in model.named_children()
               if m is not None and len(list(m.parameters()))}
    for name, m in [("model", model), *subnets.items()]:
        handles.append(m.register_forward_pre_hook(mark(name + ":start")))
        handles.append(m.register_forward_hook(mark(name + ":end")))
    step_start, step_end = [], []
    try:
        for i in idx:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            step_start.append(ev)
            trainer.step_indices(i, lr)
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            step_end.append(ev)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    n = len(idx)
    span = lambda a, b: sum(x.elapsed_time(y) for x, y in zip(a, b)) / n
    out = {"step": span(step_start, step_end),
           "data_and_transforms": span(step_start, marks["model:start"]),
           "forward": span(marks["model:start"], marks["model:end"]),
           "backward_and_adam": span(marks["model:end"], step_end)}
    out["forward_by_subnet"] = {
        name: span(marks[name + ":start"], marks[name + ":end"])
        for name in subnets if name + ":start" in marks}
    return out


# device kernel names of K4 (csrc/conv_bn.cu)
_K4_KERNEL_NAMES = ("fwd_type_kernel", "bwd2_kernel")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=smoke.TRAIN_BATCH)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--lr", type=float, default=1e-4)
    ap.add_argument("--fused-train-conv", action="store_true",
                    help="compare K4 off and on (both with K3's heads)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_train: needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "--id=0"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip()
    device = torch.device("cuda")
    ds = smoke.training_data()
    # label -> (fused_heads, fused_train_conv)
    variants = ({"k4_off": (True, False), "k4_on": (True, True)}
                if args.fused_train_conv else
                {"cudnn_heads": (False, False), "k3_heads": (True, False)})
    trainers = {label: smoke.make_trainer(device, ds, heads,
                                          fused_train_conv=k4)
                for label, (heads, k4) in variants.items()}
    rng = np.random.default_rng(1)
    draw = lambda k: [ds.sample_indices(rng, args.batch) for _ in range(k)]
    for trainer in trainers.values():
        _steps(trainer, draw(args.warmup), args.lr)
    torch.cuda.synchronize()
    record = {"card": card, "batch": args.batch, "iters": args.iters,
              "torch": torch.__version__, "runs": []}
    first, second = variants
    for label in (first, second, second, first):
        idx = draw(args.iters)
        t0 = time.perf_counter()
        _steps(trainers[label], idx, args.lr)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3 / args.iters
        heads, k4 = variants[label]
        run = {"variant": label, "fused_heads": heads,
               "fused_train_conv": k4, "step_ms": ms,
               "samples_per_s": args.batch / ms * 1e3}
        print(f"{label} (fused_heads={heads}, fused_train_conv={k4}): "
              f"{ms:.3f} ms per step of batch {args.batch}, "
              f"{run['samples_per_s']:.2f} samples/s ({card})", flush=True)
        record["runs"].append(run)
    for label in variants:
        step_ms = min(r["step_ms"] for r in record["runs"]
                      if r["variant"] == label)
        idx = draw(args.iters)
        prof = _device_profile(
            lambda: _steps(trainers[label], idx, args.lr), args.iters,
            args.top, step_ms)
        stages = _stage_times(trainers[label], draw(args.iters), args.lr)
        record[f"profile_{label}"] = prof
        record[f"stages_{label}"] = stages
        print(f"profile {label}: device busy "
              f"{prof['device_busy_ms_per_step']:.3f} ms of {step_ms:.3f} "
              f"ms per step, idle share {prof['idle_share']:.3f}",
              flush=True)
        for r in prof["top_kernels"]:
            print(f"  {r['device_ms_per_step']:8.3f} ms  "
                  f"{r['calls_per_step']:5.1f}/step  {r['name']}",
                  flush=True)
        k4_rows = [r for r in prof["all_kernels"]
                   if any(n in r["name"] for n in _K4_KERNEL_NAMES)]
        if k4_rows:
            k4_ms = sum(r["device_ms_per_step"] for r in k4_rows)
            print(f"  K4 kernels, {k4_ms:.3f} ms per step:", flush=True)
            for r in k4_rows:
                print(f"  {r['device_ms_per_step']:8.3f} ms  "
                      f"{r['calls_per_step']:5.1f}/step  {r['name']}",
                      flush=True)
        print(f"stages {label} (device ms per step, CUDA events):",
              flush=True)
        for k, v in stages.items():
            if k != "forward_by_subnet":
                print(f"  {v:8.3f} ms  {k}", flush=True)
        for k, v in sorted(stages["forward_by_subnet"].items(),
                           key=lambda kv: -kv[1]):
            print(f"  {v:8.3f} ms  forward {k}", flush=True)
    for label in variants:
        record[f"profile_{label}"].pop("all_kernels")
    print(json.dumps(record))


if __name__ == "__main__":
    main()
