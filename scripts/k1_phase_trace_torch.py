#!/usr/bin/env python3
"""Where one K1 block's time goes, on the card: K1's source
(baryon_painter_tpu_torch/csrc/res_block.cu) built once more with
``clock64()`` stamps at its phase boundaries, then launched at the main
paths' shapes.

    python3 scripts/k1_phase_trace_torch.py [--out k1_trace.json]

The stamps go into a copy of the source in a temporary directory (the
package's own library is not touched): warp 0's first thread of each block
records the global timer and its SM at the start, the cycles to x's TMA
load landing, to the end of conv1's products, past h's epilogue and the
barrier after it, to the end of conv2's products and to the end of the out
epilogue, and the global timer at the end. Each stamp is inserted before or
after an anchor, a line of the source's code (never a comment); a source
without one of them raises (``tests/test_torch_kernel_report.py`` checks
the anchors on the CPU). The tile's shape, and so the count of blocks, is
read from the source's ``Elt<T>`` and ``kTW``.

Prints one JSON line per (dtype, shape): the launch's ms (CUDA events),
the blocks, the SM clock (from the stamps), the mean and 90th percentile of
each phase in microseconds, and the blocks' start times. Needs nvcc and a
CUDA device; imports only torch, numpy and the port.
"""
import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

SOURCE = REPO / "baryon_painter_tpu_torch" / "csrc" / "res_block.cu"
PHASES = ["start_to_x_ready", "conv1", "h_epilogue_and_barrier", "conv2",
          "out_epilogue"]
_STAMP = "if (threadIdx.x == 0) bpt_trace[bid * 8 + {k}] = clock64() - c_start;"
# (anchor, text put before it or after it, where)
ANCHORS = [
    ("namespace {\n",
     "__device__ unsigned long long bpt_trace[65536 * 8];\n", "before"),
    ("  float* sbs = reinterpret_cast<float*>(sm + L.sb);\n",
     "  const unsigned long long bid = blockIdx.x + gridDim.x * (blockIdx.y"
     " + (unsigned long long)gridDim.y * blockIdx.z);\n"
     "  const long long c_start = clock64();\n"
     "  if (threadIdx.x == 0) {\n"
     "    unsigned long long g;\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g));\n"
     "    unsigned int smid;\n"
     "    asm volatile(\"mov.u32 %0, %%smid;\" : \"=r\"(smid));\n"
     "    bpt_trace[bid * 8 + 0] = g;\n"
     "    bpt_trace[bid * 8 + 1] = smid;\n"
     "  }\n", "before"),
    ("    mbar_wait(xfull, 0);\n", "    " + _STAMP.format(k=2) + "\n",
     "after"),
    ("  if (E::ALIAS) named_barrier(1, Gm::CONSUMERS);\n",
     "  " + _STAMP.format(k=3) + "\n", "before"),
    ("  const bool active = wg < Gm::M2;\n",
     "  " + _STAMP.format(k=4) + "\n", "before"),
    ("  if (!active) return;\n", "  " + _STAMP.format(k=5) + "\n", "before"),
    ("    tma_store_commit_and_wait_read();\n  }\n",
     "  if (threadIdx.x == 0) {\n"
     "    bpt_trace[bid * 8 + 6] = clock64() - c_start;\n"
     "    unsigned long long g;\n"
     "    asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(g));\n"
     "    bpt_trace[bid * 8 + 7] = g;\n"
     "  }\n", "after"),
    ('extern "C" {\n',
     "int bpt_trace_read(void* host, int n) {\n"
     "  return (int)cudaMemcpyFromSymbol(host, bpt_trace, (size_t)n * 8);\n"
     "}\n", "after"),
]
CASES = (("bfloat16", (16, 64, 64, 128), 0.0),
         ("float32", (16, 64, 64, 128), 0.0),
         ("bfloat16", (16, 128, 128, 128), 0.2),
         ("float32", (16, 128, 128, 128), 0.2))


def instrumented(src: str) -> str:
    """The source with the stamps; raises if an anchor is missing or not
    unique."""
    for anchor, text, where in ANCHORS:
        if src.count(anchor) != 1:
            raise ValueError(f"K1's source has {src.count(anchor)} copies "
                             f"of the anchor {anchor!r}, not 1")
        src = src.replace(anchor, text + anchor if where == "before"
                          else anchor + text)
    return src


def tile(src: str, dtype_name: str) -> tuple[int, int]:
    """K1's output tile (rows, columns) for a type: ``Elt<T>::TH`` and
    ``kTW`` of the source."""
    name = "float" if dtype_name == "float32" else "__nv_bfloat16"
    th = re.search(rf"struct Elt<{name}> {{[^}}]*?\bTH = (\d+)", src)
    tw = re.search(r"constexpr int kTW = (\d+);", src)
    if th is None or tw is None:
        raise ValueError(f"K1's source has no tile shape for {dtype_name}")
    return int(th.group(1)), int(tw.group(1))


def build(tmp: Path) -> ctypes.CDLL:
    from baryon_painter_tpu_torch.ops import _build
    (tmp / "res_block_trace.cu").write_text(
        instrumented(SOURCE.read_text()))
    for header in SOURCE.parent.glob("*.cuh"):   # ptx.cuh, hopper.cuh
        (tmp / header.name).write_text(header.read_text())
    so = tmp / "libk1trace.so"
    subprocess.run([_build.find_nvcc(), *_build.ARCH_FLAGS, "-std=c++17",
                    "-O3", "-Xcompiler", "-fPIC", "-shared", "-o", str(so),
                    str(tmp / "res_block_trace.cu")], check=True,
                   timeout=_build.BUILD_TIMEOUT_S)
    lib = ctypes.CDLL(str(so))
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.bpt_res_block_infer.argtypes = [p] * 7 + [i, i, i, i, f, f, i, p]
    lib.bpt_trace_read.argtypes = [p, i]
    return lib


def trace(lib, dtype_name, shape, slope) -> dict:
    import torch
    from baryon_painter_tpu_torch import smoke
    from baryon_painter_tpu_torch.ops import res_block as k1
    dtype = getattr(torch, dtype_name)
    x, w1, s1, b1, w2, s2, b2 = smoke.k1_inputs(shape, dtype, "cuda")
    ops = k1.res_block_operands(w1, s1, b1, w2, s2, b2, dtype)
    out = torch.empty_like(x)
    n, h, w, c = shape
    code = 0 if dtype == torch.float32 else 1

    def launch():
        err = lib.bpt_res_block_infer(
            x.data_ptr(), ops.weights.data_ptr(), ops.scale1.data_ptr(),
            ops.bias1.data_ptr(), ops.scale2.data_ptr(),
            ops.bias2.data_ptr(), out.data_ptr(), n, h, w, c, slope, slope,
            code, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"K1 launch failed ({err})")

    for _ in range(5):
        launch()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    launch()
    end.record()
    torch.cuda.synchronize()
    th, tw = tile(SOURCE.read_text(), dtype_name)
    blocks = -(-w // tw) * -(-h // th) * n
    buf = np.zeros(blocks * 8, np.uint64)
    if lib.bpt_trace_read(buf.ctypes.data, blocks * 8):
        raise RuntimeError("reading the stamps failed")
    t = buf.reshape(blocks, 8).astype(np.float64)
    ns = t[:, 7] - t[:, 0]
    ghz = float(np.median(t[:, 6] / ns))
    cycles = np.concatenate([np.zeros((blocks, 1)), t[:, 2:7]], axis=1)
    us = np.diff(cycles, axis=1) / ghz / 1e3
    starts = (t[:, 0] - t[:, 0].min()) / 1e3
    return {"dtype": dtype_name, "shape": list(shape), "slope": slope,
            "launch_ms": start.elapsed_time(end), "blocks": blocks,
            "sms": int(len(np.unique(t[:, 1]))), "sm_clock_ghz": ghz,
            "block_us_mean": float(ns.mean() / 1e3),
            "phase_us_mean": dict(zip(PHASES, map(float, us.mean(0)))),
            "phase_us_p90": dict(zip(PHASES, map(
                float, np.percentile(us, 90, axis=0)))),
            "block_start_us_quartiles": list(map(
                float, np.percentile(starts, [0, 25, 50, 75, 100])))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None,
                    help="also write the records to this JSON file")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("k1_phase_trace_torch: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    records = []
    with tempfile.TemporaryDirectory() as tmp:
        lib = build(Path(tmp))
        for case in CASES:
            rec = dict(trace(lib, *case), card=card)
            records.append(rec)
            print(json.dumps(rec), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(records, indent=1))


if __name__ == "__main__":
    main()
