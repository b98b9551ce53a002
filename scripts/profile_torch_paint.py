#!/usr/bin/env python3
"""Where the time of the port's paint path goes, on one CUDA card.

    python3 scripts/profile_torch_paint.py [--n-tiles 16] [--iters 10]
                                           [--fused-heads] [--dtype bf16]

Paints n 512^2 tiles (redshifts over the checkpoint's 11-point grid) with
``CVAEPainter(trained_models/CVAE/fiducial-512/model)`` of the PyTorch port,
fused (residual blocks through K1) and unfused (residual blocks as cuDNN
convolutions plus elementwise ops), in turns: unfused, fused, fused,
unfused. For each it prints ms per paint_batch call (CUDA events) and, from
one torch.profiler window (CUDA activity only) over ``iters`` calls, the
device time by kernel and the device's idle share: 1 - (union of device
intervals per call) / (ms per call from the CUDA events); then the device
time of each layer module, from CUDA events in forward hooks. With
``--fused-heads`` both painters run the two output heads as one K3-fwd
call (``fused_heads=True``); the heads are then no layer module, and
their time is that of K3-fwd's two launches, ``head_gemm_kernel`` (the u1
GEMM) and ``head_chain_fwd_kernel``, in the table by kernel. ``--dtype
bf16`` paints with both painters in bf16 (``CVAEPainter(...,
dtype=torch.bfloat16)``, the JAX package's default compute dtype). TF32 is
off.
The full record is printed as the last line (JSON).
"""
import argparse
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _events_ms(fn, iters):
    import torch
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _profile(fn, iters, top, paint_ms):
    """Device activity over ``iters`` calls, from a CUDA-only profiler window:
    time by kernel name, and the union of all device intervals per call
    (busy). The idle share is taken against ``paint_ms``, the same call timed
    with CUDA events outside the profiler, whose own overhead would
    otherwise count as idle time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
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
    rows = sorted(({"name": k, "calls_per_paint": n / iters,
                    "device_ms_per_paint": us / 1e3 / iters}
                   for k, (n, us) in by_name.items()),
                  key=lambda r: -r["device_ms_per_paint"])
    return {"device_busy_ms_per_paint": busy_ms,
            "idle_share": 1.0 - busy_ms / paint_ms,
            "top_kernels": rows[:top]}


def _layer_times(painter, tiles, zs, iters, top):
    """Device ms per call of each layer module of the painter's model (conv,
    transposed conv, batch norm, PReLU, residual block), from CUDA events
    recorded in forward hooks around it; elementwise steps between modules
    are not attributed."""
    import torch
    from baryon_painter_tpu_torch.models import layers
    kinds = (layers.Conv2d, layers.ConvTranspose2d, layers.BatchNorm,
             layers.PReLU, layers.FusedResBlock, layers.ResidualBlock)
    pending, spans, shapes, handles = {}, [], {}, []

    def pre(name):
        def hook(module, inputs):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            pending[name] = ev
            shapes[name] = tuple(inputs[0].shape)
        return hook

    def post(name):
        def hook(module, inputs, output):
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            spans.append((name, pending.pop(name), ev))
        return hook

    for name, m in painter.model.named_modules():
        if isinstance(m, kinds):
            handles.append(m.register_forward_pre_hook(pre(name)))
            handles.append(m.register_forward_hook(post(name)))
    try:
        for _ in range(iters):
            painter.paint_batch(tiles, zs)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    totals = {}
    for name, start, end in spans:
        totals[name] = totals.get(name, 0.0) + start.elapsed_time(end)
    rows = sorted(({"layer": k, "input_shape": list(shapes[k]),
                    "device_ms_per_paint": v / iters}
                   for k, v in totals.items()),
                  key=lambda r: -r["device_ms_per_paint"])
    return rows[:top]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--n-tiles", type=int, default=16)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--top", type=int, default=15)
    ap.add_argument("--fused-heads", action="store_true",
                    help="run the output heads through K3 (fused_heads)")
    ap.add_argument("--dtype", choices=("f32", "bf16"), default="f32",
                    help="the painters' compute dtype")
    args = ap.parse_args()

    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_paint: needs a CUDA device")
    from baryon_painter_tpu_torch import smoke
    from baryon_painter_tpu_torch.ops.res_block import res_block_infer
    from baryon_painter_tpu_torch.painter import CVAEPainter

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader", "--id=0"],
                          capture_output=True, text=True, timeout=60,
                          check=True).stdout.strip()
    device = torch.device("cuda")
    base = os.path.join(REPO, smoke.CHECKPOINT)
    dtype = torch.bfloat16 if args.dtype == "bf16" else None
    painters = {f: CVAEPainter(base, fused_inference=f,
                               fused_heads=args.fused_heads, dtype=dtype,
                               device=device)
                for f in (False, True)}
    z_grid = np.asarray(painters[True].meta["stats"]["dm"]["z_grid"],
                        np.float32)
    tiles = torch.as_tensor(smoke.golden_inputs(512, args.n_tiles),
                            device=device)
    zs = torch.as_tensor(z_grid[np.arange(args.n_tiles) % len(z_grid)],
                         device=device)
    record = {"card": card, "n_tiles": args.n_tiles, "iters": args.iters,
              "fused_heads": args.fused_heads, "dtype": args.dtype,
              "torch": torch.__version__,
              "runs": []}
    for fused in (False, True, True, False):
        paint = lambda: painters[fused].paint_batch(tiles, zs)
        for _ in range(2):
            paint()
        torch.cuda.synchronize()
        before = res_block_infer.launches
        ms = _events_ms(paint, args.iters)
        launches = (res_block_infer.launches - before) / args.iters
        run = {"fused": fused, "paint_ms": ms,
               "tiles_per_s": args.n_tiles / ms * 1e3,
               "k1_launches_per_paint": launches}
        print(f"fused={fused} ({args.dtype}): {ms:.3f} ms per paint_batch of "
              f"{args.n_tiles} tiles, {run['tiles_per_s']:.1f} tiles/s, "
              f"{launches:.0f} K1 launches per call ({card})", flush=True)
        record["runs"].append(run)
    for fused in (False, True):
        paint_ms = min(r["paint_ms"] for r in record["runs"]
                       if r["fused"] == fused)
        prof = _profile(lambda: painters[fused].paint_batch(tiles, zs),
                        args.iters, args.top, paint_ms)
        record[f"profile_fused_{fused}"] = prof
        print(f"profile fused={fused}: device busy "
              f"{prof['device_busy_ms_per_paint']:.3f} ms of "
              f"{paint_ms:.3f} ms per call, idle share "
              f"{prof['idle_share']:.3f}", flush=True)
        for r in prof["top_kernels"]:
            print(f"  {r['device_ms_per_paint']:8.3f} ms  "
                  f"{r['calls_per_paint']:5.1f}/call  {r['name']}",
                  flush=True)
    for fused in (False, True):
        rows = _layer_times(painters[fused], tiles, zs, args.iters, args.top)
        record[f"layers_fused_{fused}"] = rows
        print(f"layers fused={fused} (device ms per call, CUDA events in "
              f"forward hooks):", flush=True)
        for r in rows:
            print(f"  {r['device_ms_per_paint']:8.3f} ms  {r['layer']}  "
                  f"in {tuple(r['input_shape'])}", flush=True)
    print(json.dumps(record))


if __name__ == "__main__":
    main()
