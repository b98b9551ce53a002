"""The readings a cell's limits are set from: the program's compared
numbers over many seeds, and the control's (the reference computed in the
precision below the cell's, put in the program's place).

    python3 benchmark/tools/readings.py --workload <cell> \\
        --seeds 11,12,... [--control-seeds 21,22,23] \\
        [--fault NAME --fault-seeds 31,32,33] [--reference f64] [--out FILE]

One process sets the program up once and reads each seed as a run reads
it: a paint cell paints the seed's first ``check_calls`` calls (two ahead,
as the window does) and compares them with the reference; a training cell
builds a trainer from the seed and compares its first steps. The control
takes the same inputs through the reference in the workload's ``control``
precision (``reference/nets.Numerics``) and compares it with the f32
reference. ``--fault`` reads the program with a fault of ``faults.py``
planted. ``--reference f64`` compares a training cell's readings with the
reference in float64 as well. Prints one JSON line per seed and writes
them all to ``--out``.
Needs the card, as the benchmark does; ``--device cpu`` runs it on the
CPU at whatever sizes the cell's files give.
"""
import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))


def _program(cell, fault):
    from benchmark.tools.faults import planted
    if fault is None:
        return contextlib.nullcontext()
    return planted(cell.workload["entry"], fault,
                   cell.workload.get("painter", ""))


def paint_readings(cell, seeds, device, control: bool, fault=None,
                   also=None) -> list:
    import torch
    from benchmark.entries.paint import PaintSystem
    from benchmark.harness import compare
    from benchmark.reference.painting import ReferencePainter
    out = []
    if control:
        ref = ReferencePainter(cell.config, device)
        low = ReferencePainter(cell.config, device,
                               cell.workload["control"])
    for seed in seeds:
        t0 = time.perf_counter()
        system = PaintSystem(cell, seed, device, program=not control)
        if control:
            errs = []
            for i in range(cell.traffic["check_calls"]):
                tiles, zs, eps = system.inputs(i)
                errs.append(float(compare.tile_errors(
                    low.paint(tiles, zs, eps), ref.paint(tiles, zs, eps))
                    .max()))
        else:
            with _program(cell, fault):
                for i in range(cell.traffic["check_calls"]):
                    system.issue(i)
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            system.free_program()
            errs = [float(e.max()) for e in system.check(cell.config)]
        out.append({"seed": seed, "control": control, "fault": fault,
                    "tile_rel_l2": max(errs), "calls": errs,
                    "seconds": time.perf_counter() - t0})
        print(json.dumps(out[-1]), flush=True)
    return out


def _detail(got: dict, ref: dict) -> dict:
    """Each step's loss gap and the worst parameters."""
    import numpy as np
    med = lambda d: float(np.median(list(d.values())))
    worst = lambda key: max(ref[key], key=lambda n: abs(
        got[key][n] - ref[key][n]) / max(ref[key][n], med(ref[key])))
    return {"loss_steps": [abs(a - b) / abs(b) for a, b in
                           zip(got["loss"], ref["loss"])],
            "worst_grad": worst("grad"), "worst_change": worst("change")}


def train_readings(cell, seeds, device, control: bool, fault=None,
                   also=None) -> list:
    from benchmark.entries.train import TrainSystem
    from benchmark.harness import compare, traffic
    data = traffic.train_stacks(cell.traffic, device)
    out = []
    for seed in seeds:
        t0 = time.perf_counter()
        system = TrainSystem(cell, seed, device, data=data)
        if control:
            system.free_program()
            got = system.reference(cell.workload["control"])
        else:
            with _program(cell, fault):
                got = system.first_steps()
            system.free_program()
        ref = system.reference()
        row = {"seed": seed, "control": control, "fault": fault,
               **compare.train_gaps(got, ref), **_detail(got, ref)}
        if also:
            ref2 = system.reference(also)
            row[also] = {**compare.train_gaps(got, ref2),
                         **_detail(got, ref2)}
        row["seconds"] = time.perf_counter() - t0
        out.append(row)
        print(json.dumps(out[-1]), flush=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--control-seeds", default="")
    p.add_argument("--fault")
    p.add_argument("--fault-seeds", default="")
    p.add_argument("--reference", help="a second reference precision")
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch
    from benchmark.harness.core import load_cell
    cell = load_cell(args.workload)
    device = torch.device(args.device)
    read = (train_readings if cell.workload["entry"] == "train"
            else paint_readings)
    ints = lambda s: [int(x) for x in s.split(",") if x]
    rows = (read(cell, ints(args.seeds), device, False,
                 also=args.reference)
            + read(cell, ints(args.control_seeds), device, True,
                   also=args.reference))
    if args.fault:
        rows += read(cell, ints(args.fault_seeds), device, False,
                     fault=args.fault)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(r) for r in rows)
                                  + "\n")


if __name__ == "__main__":
    main()
