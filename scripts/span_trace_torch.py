#!/usr/bin/env python3
"""The port's spans on one CUDA card: a Chrome trace of the painter and the
trainer, read by span.

    python3 scripts/span_trace_torch.py [--calls 24] [--steps 12]
                                        [--seed 2718281828] [--trace-dir d]

Builds ``CVAEPainter(trained_models/CVAE/fiducial-512/model,
fused_inference=True, fused_heads=True)`` in bf16 and a fiducial
``CVAETrainer`` at 512^2 in f32 (``fused_heads``, ``fused_train_conv``,
``device_data``: K2 gathers from synthetic 1024^2 stacks of the 11
fiducial redshifts on the card), warms each up, and runs ``--calls``
paint calls of 16 tiles and ``--steps`` ``step_indices`` steps at batch
24, each phase under ``utils/profiling.device_trace`` (the host's and the
card's activity, each span a range of the trace). For each phase it
prints the worst distance between a span's own stamps and its range in
the trace (the recorder stamps the profiler's clock), the device's idle
gaps named by the innermost span open when each began
(``trace_idle_by_range``), the device and host milliseconds of each span
name a call or step, and the device milliseconds a call or step of each
kind of operation by the innermost span open when the host launched it
(the port's kernels by family, cuDNN's and cuBLAS's convolutions and
GEMMs, cuDNN's layout copies, PyTorch's elementwise kernels, copies and
casts). First it prints whether the profiler's state reads on under a
CUDA-only profile, which turns the spans on. The record is the last line
(JSON).
"""
import argparse
import json
import os
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

CHECKPOINT = os.path.join(REPO, "trained_models", "CVAE", "fiducial-512",
                          "model")
TILE = 512
PAINT_TILES = 16
TRAIN_BATCH = 24
REDSHIFTS = (0.0, 0.125, 0.25, 0.375, 0.5, 0.75, 1.0, 1.25, 1.5, 1.75, 2.0)
# the port's kernels by family (``csrc/``)
PORT_KERNELS = {
    "k1": ("res_block_kernel",),
    "k2": ("gather_tiles_kernel",),
    "k3": ("head_gemm_kernel", "head_chain_fwd_kernel",
           "head_chain_bwd_kernel", "head_dw1_kernel"),
    "k4": ("u_gemm_kernel", "bn_relu_kernel", "bn_relu_bf16_kernel",
           "du_kernel", "dx_kernel", "dw_kernel")}


def _by_span(recs, root: str) -> dict:
    """{name: {"count", "device_ms", "host_ms"}} a ``root`` span, over the
    recorded ``root`` spans."""
    calls = {r.call for r in recs if r.name == root and r.parent is None}
    out = {}
    for r in recs:
        if r.call not in calls:
            continue
        row = out.setdefault(r.name, {"count": 0, "device_ms": 0.0,
                                      "host_ms": 0.0})
        row["count"] += 1
        row["device_ms"] += (r.device_ms or 0.0) / len(calls)
        row["host_ms"] += r.host_ms / len(calls)
    return out


def _stamps_against_ranges(path: str, recs) -> dict:
    """The largest distances in microseconds between each span's host
    stamps and its range in the trace, matched by name in start order:
    over all spans, and over all but each name's first (whose range pays
    the profiler's first use)."""
    with open(path) as f:
        trace = json.load(f)
    base_us = trace.get("baseTimeNanoseconds", 0) / 1e3
    names = {r.name for r in recs}
    ranges = {}
    for ev in sorted((ev for ev in trace["traceEvents"]
                      if ev.get("cat") == "user_annotation"
                      and ev.get("name") in names), key=lambda e: e["ts"]):
        ranges.setdefault(ev["name"], []).append(ev)
    seen, worst, later = {}, [0.0, 0.0], [0.0, 0.0]
    for r in recs:
        k = seen.get(r.name, 0)
        seen[r.name] = k + 1
        if k >= len(ranges.get(r.name, ())):
            continue
        ev = ranges[r.name][k]
        d = (abs(r.host_start_ns / 1e3 - ev["ts"] - base_us),
             abs(r.host_end_ns / 1e3 - ev["ts"] - ev["dur"] - base_us))
        worst = [max(a, b) for a, b in zip(worst, d)]
        if k:
            later = [max(a, b) for a, b in zip(later, d)]
    return {"start_us": worst[0], "end_us": worst[1],
            "start_us_after_first": later[0], "end_us_after_first": later[1],
            "matched": sum(min(seen[n], len(ranges.get(n, ())))
                           for n in seen), "spans": len(recs)}


def _kind(name: str) -> str:
    """The kind of a device operation, by its name."""
    fn = name.replace("void ", "").replace("(anonymous namespace)::", "")
    fn = fn.split("<")[0].split("(")[0].strip()
    for family, kernels in PORT_KERNELS.items():
        if fn in kernels:
            return family
    if name.startswith(("Memcpy", "Memset")):
        return "memcpy/memset"
    if "nchwToNhwc" in name or "nhwcToNchw" in name:
        return "layout copy"
    if name.startswith(("at::native::", "void at::native::")):
        return "elementwise/copy/cast"
    return "conv/gemm library"


def _operations_by_span(path: str, names, calls: int) -> dict:
    """{span: {kind: device ms a call}}: each device operation of the
    trace charged to the innermost span whose range was open on the
    launching thread when its runtime call began ("" outside every
    span; autograd's device threads, which open none, take the caller's)."""
    from baryon_painter_tpu_torch.utils import profiling
    with open(path) as f:
        events = [ev for ev in json.load(f)["traceEvents"]
                  if ev.get("ph") == "X" and (
                      ev.get("cat") != "user_annotation"
                      or ev.get("name") in names)]
    innermost = profiling.innermost_range(events)
    launch = {ev["args"]["correlation"]: ev for ev in events
              if ev.get("cat") in ("cuda_runtime", "cuda_driver")
              and "correlation" in ev.get("args", {})}
    out = {}
    for op in events:
        if op.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        call = launch.get(op.get("args", {}).get("correlation"))
        span = "" if call is None else innermost(call.get("tid"), call["ts"])
        row = out.setdefault(span, {})
        kind = _kind(op["name"])
        row[kind] = row.get(kind, 0.0) + op.get("dur", 0) / 1e3 / calls
    return out


def _phase(name: str, root: str, run_one, n: int, trace_dir: str) -> dict:
    import torch
    from baryon_painter_tpu_torch.utils import profiling
    profiling.clear()
    log_dir = os.path.join(trace_dir, name)
    t0 = time.perf_counter()
    with profiling.device_trace(log_dir):
        for i in range(n):
            run_one(i)
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    recs = profiling.spans()
    path = os.path.join(log_dir, profiling.TRACE_FILE)
    idle = profiling.trace_idle_by_range(path)
    idle_s = sum(row["idle_s"] for row in idle.values())
    out = {"phase": name, "calls": n, "seconds": seconds,
           "clock": _stamps_against_ranges(path, recs),
           "idle_s": idle_s, "idle_by_span": idle,
           "by_span": _by_span(recs, root),
           "operations_by_span": _operations_by_span(
               path, {r.name for r in recs}, n)}
    print(f"{name}: {n} calls in {seconds:.3f} s; device idle "
          f"{idle_s:.4f} s between its first and last operation",
          flush=True)
    for span, row in idle.items():
        print(f"  idle in {span or '(no span)':18s} {row['gaps']:6d} gaps "
              f"{row['idle_s'] * 1e3:10.3f} ms", flush=True)
    for span, row in out["by_span"].items():
        print(f"  {span:18s} x{row['count']:5d}  device "
              f"{row['device_ms']:9.4f} ms  host {row['host_ms']:9.4f} ms "
              f"a call", flush=True)
    for span, row in out["operations_by_span"].items():
        kinds = ", ".join(f"{k} {v:.4f}" for k, v in sorted(
            row.items(), key=lambda kv: -kv[1]))
        print(f"  ops in {span or '(no span)':18s} ms a call: {kinds}",
              flush=True)
    print(f"  clock: {out['clock']}", flush=True)
    return out


def trace(args) -> dict:
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from baryon_painter_tpu_torch.data.dataset import (BahamasTileDataset,
                                                       load_file_info)
    from baryon_painter_tpu_torch.data.synthetic import make_synthetic_stacks
    from baryon_painter_tpu_torch.models.cvae import (
        CVAE, fiducial_cvae_architecture)
    from baryon_painter_tpu_torch.painter import CVAEPainter
    from baryon_painter_tpu_torch.train.trainer import (CVAETrainer,
                                                        TrainConfig)
    from baryon_painter_tpu_torch.transforms import RangeCompress
    device = torch.device("cuda:0")
    with profile(activities=[ProfilerActivity.CUDA]):
        gate = bool(torch._C._autograd._profiler_enabled())
    print(f"profiler state under a CUDA-only profile: {gate}", flush=True)
    out = {"device": torch.cuda.get_device_name(device),
           "cuda_only_gate": gate}
    trace_dir = args.trace_dir or tempfile.mkdtemp(prefix="span_trace_")
    rng = np.random.default_rng(args.seed)

    painter = CVAEPainter(CHECKPOINT, dtype=torch.bfloat16, device=device,
                          fused_inference=True, fused_heads=True)
    tiles = torch.from_numpy(rng.lognormal(
        0.0, 1.0, (PAINT_TILES, TILE, TILE)).astype(np.float32)).to(device)
    zs = torch.from_numpy(rng.choice(REDSHIFTS, PAINT_TILES).astype(
        np.float32)).to(device)
    for _ in range(3):
        painter.paint_batch(tiles, zs)
    out["paint"] = _phase("paint", "paint",
                          lambda i: painter.paint_batch(tiles, zs),
                          args.calls, trace_dir)
    del painter
    torch.cuda.empty_cache()

    root = os.path.join(trace_dir, "stacks")
    info = make_synthetic_stacks(root, n_stack=1, n_grid=2 * TILE,
                                 redshifts=REDSHIFTS, seed=args.seed % 2**32)
    data = BahamasTileDataset(
        files=load_file_info(info), root_path=root, redshifts=REDSHIFTS,
        label_fields=["pressure"], n_tile=2, tile_permutations=True,
        scale_to_SLICS=True,
        transforms={f: RangeCompress("shift-log", 4.0, eps=1e-4)
                    for f in ("dm", "pressure")})
    model = CVAE(fiducial_cvae_architecture(TILE), fused_heads=True,
                 fused_train_conv=True)
    trainer = CVAETrainer(model, data, config=TrainConfig(
        seed=args.seed, batch_size=TRAIN_BATCH), device_data=True,
        device=device)
    idx = [data.sample_indices(rng, TRAIN_BATCH)
           for _ in range(3 + args.steps)]
    for i in range(3):
        trainer.step_indices(idx[i], 1e-3)
    out["train"] = _phase("train", "train.step",
                          lambda i: trainer.step_indices(idx[3 + i], 1e-3),
                          args.steps, trace_dir)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--calls", type=int, default=24)
    p.add_argument("--steps", type=int, default=12)
    p.add_argument("--seed", type=int, default=2718281828)
    p.add_argument("--trace-dir", default=None,
                   help="where the Chrome traces and the stacks go "
                        "(default: a new temporary directory)")
    rec = trace(p.parse_args(argv))
    print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
