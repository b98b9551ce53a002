"""Run one cell of the port's benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout. The cell is an entry of ``BENCHMARK.json``'s
``workloads``; its files are found by name (``benchmark/README.md``).
``--trace 0`` measures the end-to-end metrics over a ``--seconds`` window;
``--trace 1`` spends the window's first part untraced and profiles the
last ``traced_seconds`` (the traffic file's), and reports the per-layer
metrics. Either way the run checks what its window produced against the
plain reference and prints each compared number beside its limit, as the
last lines of standard error and under ``checks``, the last key of the
result line: the last line of standard output, one JSON object. Exits 2
without a result where the cell's CUDA devices are missing, 3 where a
module of the JAX package or of JAX itself is loaded once the window has
closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
# the build and kernel caches of the program, at fixed paths inside the
# checkout (the port's own CUDA build lives in its package's _build/)
CACHE = ROOT / "benchmark" / ".cache"
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(CACHE / "torch_kernels")
sys.path.insert(0, str(ROOT))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def result_line(cell, out: dict) -> dict:
    """The result's JSON object (``checks`` last)."""
    import torch
    from benchmark.harness.core import device_kind, read_per_layer
    device = torch.device(cell.device)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": device_kind(device),
           "count": int(cell.entry["chips"]),
           "memory_peak_bytes": int(out["memory_peak_bytes"])}
    line = {"correct": out["checks"].correct, "attempted": out["attempted"],
            "failed": out["failed"]}
    if cell.trace:
        run = out["run"]
        metrics = read_per_layer(cell, run)
        dev.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
        line["breakdown"] = {"device_ops": run.trace.top_ops(10),
                             "idle_gaps": run.trace.gaps[:10]}
    else:
        units = {m["name"]: m["unit"] for m in cell.end_to_end}
        metrics = {name: {"value": float(out["end_to_end"][name]),
                          "unit": unit} for name, unit in units.items()}
    line["metrics"] = metrics
    line["device"] = dev
    line["checks"] = out["checks"].record()
    return line


def main(argv=None) -> int:
    args = parse_args(argv)
    os.chdir(ROOT)
    from benchmark.harness.core import (BENCH_DIR, forbidden_modules,
                                        load_cell, load_module)
    cell = load_cell(args.workload)
    import torch
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: cell {cell.name} needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    cell.seed, cell.seconds = args.seed, args.seconds
    cell.trace, cell.device, cell.t_start = bool(args.trace), "cuda:0", T_START
    entry = load_module(BENCH_DIR / "entries"
                        / f"{cell.workload['entry']}.py",
                        "bench_entry_" + cell.workload["entry"])
    out = entry.run(cell)
    loaded = forbidden_modules()
    if loaded:
        print(f"benchmark: the run loaded {', '.join(loaded)}",
              file=sys.stderr)
        return 3
    line = result_line(cell, out)
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
