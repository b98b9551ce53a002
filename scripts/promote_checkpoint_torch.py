#!/usr/bin/env python
"""Promote a fidelity-run checkpoint from its workdir into trained_models/,
in the PyTorch port.

The twin of ``scripts/promote_checkpoint.py``, with its flags (and
``--device``), its choice of checkpoint, its clobber guard, its
cross-checks between the checkpoint's metadata and ``--eval-args``, and
its stdout manifest line. It collects the artifact set every committed
model directory carries (checkpoint pair, reference-format stats streams,
figures, fidelity report), re-evaluates the gate from the copied
checkpoint with ``scripts/fidelity_check_torch.py --eval-only`` (on the
card unless ``--device cpu``), and regenerates ``report.md`` with
``scripts/make_model_report_torch.py``:

    python scripts/promote_checkpoint_torch.py --workdir <gate workdir> \\
        --model cvae --dest trained_models/CVAE/<name> \\
        --eval-args "--redshifts 0,0.5,1 --n-stack 4"

The promoted ``model_state.msgpack`` is stripped to inference state
(params / batch stats / step: no optimizer moments, progress counters or
data RNG) with the port's msgpack reader and writer: the bytes flax writes
for the same stripped tree. ``tests/goldens/paint_goldens.npz`` is the JAX
package's output: for a destination inside ``trained_models/`` (without
``--skip-goldens``) the twin runs ``scripts/make_paint_goldens.py`` as the
JAX script does, and prints the JAX script's warning when that fails (it
needs JAX). Imports only the standard library and the port.
"""
from __future__ import annotations

import argparse
import json
import os
import shlex
import shutil
import subprocess
import sys

SCRIPTS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(SCRIPTS))

# training-only keys stripped from promoted checkpoints; the committed
# artifacts carry inference state only (see trained_models/README.md)
_TRAIN_ONLY_KEYS = ("opt_state", "g_opt", "d_opt", "progress", "data_rng")


def _strip_train_state(src: str, dst: str) -> list:
    """Copy a _state.msgpack, dropping optimizer/progress/RNG entries."""
    from baryon_painter_tpu_torch.train.msgpack_reader import msgpack_restore
    from baryon_painter_tpu_torch.train.msgpack_writer import \
        msgpack_serialize
    with open(src, "rb") as f:
        raw = msgpack_restore(f.read(), numpy_scalars=True)
    dropped = [k for k in _TRAIN_ONLY_KEYS if k in raw]
    for k in dropped:
        del raw[k]
    with open(dst, "wb") as f:
        f.write(msgpack_serialize(raw, numpy_scalars=True))
    return dropped


def _pick_base(workdir: str, model: str) -> str:
    """Choose the checkpoint base to promote.

    The gate persists the best-gate state to ``<base>_best`` mid-run and
    only rewrites ``<base>`` at normal completion: after a crashed
    refinement run the plain base is stale. Prefer whichever exists; when
    both do, prefer the newer file and say so.
    """
    base = os.path.join(workdir, f"fidelity_model_{model}")
    cands = [b for b in (base, base + "_best")
             if os.path.exists(b + "_state.msgpack")]
    if not cands:
        raise SystemExit(f"no checkpoint at {base}_state.msgpack")
    chosen = max(cands, key=lambda b: os.path.getmtime(b + "_state.msgpack"))
    if len(cands) == 2:
        other = next(b for b in cands if b != chosen)
        print(f"promoting {chosen} (newer than {other})",
              file=sys.stderr, flush=True)
    return chosen


def eval_flags(meta: dict, model: str, eval_args: list) -> list:
    """``eval_args`` completed from the checkpoint's metadata: ``--tile``
    from ``tile_size`` and, for a checkpoint that records its gate
    geometry (``fidelity_dataset``), every geometry flag; a contradiction
    raises SystemExit, so a forgotten flag cannot commit a fidelity report
    scored on other validation statistics."""
    eval_args = list(eval_args)
    if meta.get("model_kind", model) != model:
        raise SystemExit(f"--model {model} but the checkpoint's "
                         f"metadata says {meta['model_kind']!r}")
    tile = int(meta["tile_size"])
    if "--tile" in eval_args:
        given = int(eval_args[eval_args.index("--tile") + 1])
        if given != tile:
            raise SystemExit(f"--eval-args says --tile {given} but the "
                             f"checkpoint was trained at tile {tile}")
    else:
        eval_args += ["--tile", str(tile)]
    geom = meta.get("fidelity_dataset")
    if geom:
        if int(geom["tile"]) != tile:
            raise SystemExit(f"metadata disagrees with itself: tile_size "
                             f"{tile} vs fidelity_dataset tile {geom['tile']}")
        flag_map = [("--redshifts", str(geom["redshifts"]), str),
                    ("--n-stack", str(geom["n_stack"]), int),
                    ("--pressure-noise", str(geom["pressure_noise"]), float),
                    ("--seed", str(geom["seed"]), int)]
        for flag, want, cast in flag_map:
            if flag in eval_args:
                given = eval_args[eval_args.index(flag) + 1]
                if cast(given) != cast(want):
                    raise SystemExit(
                        f"--eval-args says {flag} {given} but the checkpoint "
                        f"was trained with {flag} {want} (fidelity_dataset)")
            else:
                eval_args += [flag, want]
        if geom.get("physical") and "--physical" not in eval_args:
            eval_args += ["--physical"]
        if not geom.get("physical") and "--physical" in eval_args:
            raise SystemExit("--eval-args says --physical but the checkpoint "
                             "was trained on the default fixture "
                             "(fidelity_dataset.physical = false)")
    return eval_args


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workdir", required=True)
    p.add_argument("--model", required=True, choices=["cvae", "cgan"])
    p.add_argument("--dest", required=True,
                   help="target directory under trained_models/")
    p.add_argument("--eval-args", default="",
                   help="extra fidelity_check_torch.py flags reproducing "
                        "the run's dataset geometry for the --eval-only "
                        "pass")
    p.add_argument("--skip-eval", action="store_true",
                   help="copy artifacts without the re-evaluation pass "
                        "(no fidelity_report.json provenance)")
    p.add_argument("--skip-goldens", action="store_true",
                   help="do not regenerate tests/goldens/paint_goldens.npz "
                        "(it pins the committed checkpoints' painted "
                        "output, so promotion normally refreshes it)")
    p.add_argument("--checkpoint", choices=["auto", "base", "best"],
                   default="auto",
                   help="which workdir checkpoint to promote: the final "
                        "save, the mid-run best-gate save, or whichever "
                        "is newer (default)")
    p.add_argument("--force", action="store_true",
                   help="allow overwriting an existing promoted model "
                        "directory")
    p.add_argument("--device", default=None,
                   help="torch device of the re-evaluation (default: cuda)")
    args = p.parse_args(argv)

    if args.checkpoint == "auto":
        ckpt = _pick_base(args.workdir, args.model)
    else:
        suffix = "" if args.checkpoint == "base" else "_best"
        ckpt = os.path.join(args.workdir,
                            f"fidelity_model_{args.model}{suffix}")
        if not os.path.exists(ckpt + "_state.msgpack"):
            raise SystemExit(f"no checkpoint at {ckpt}_state.msgpack")

    dest_state = os.path.join(args.dest, "model_state.msgpack")
    if os.path.exists(dest_state) and not args.force:
        raise SystemExit(
            f"{args.dest} already holds a promoted model; pass --force to "
            "overwrite it (refusing to clobber committed artifacts)")
    os.makedirs(args.dest, exist_ok=True)

    copied = []

    def take(src, dst_name):
        if os.path.exists(src):
            shutil.copy2(src, os.path.join(args.dest, dst_name))
            copied.append(dst_name)

    dropped = _strip_train_state(ckpt + "_state.msgpack", dest_state)
    copied.append("model_state.msgpack")
    if dropped:
        print(f"stripped training-only state: {', '.join(dropped)}",
              file=sys.stderr, flush=True)
    take(ckpt + "_meta.json", "model_meta.json")
    take(os.path.join(args.workdir, f"training_stats_{args.model}.txt"),
         "training_stats.txt")
    take(os.path.join(args.workdir, f"training_stats_{args.model}_pkft.txt"),
         "training_stats_pkft.txt")
    for fig in ("sample", "auto_power_spectrum", "log_histogram"):
        take(os.path.join(args.workdir, f"{args.model}_{fig}.png"),
             f"{args.model}_{fig}.png")

    with open(os.path.join(args.dest, "model_meta.json")) as f:
        meta = json.load(f)
    eval_args = eval_flags(meta, args.model, shlex.split(args.eval_args))

    if not args.skip_eval:
        cmd = [sys.executable, os.path.join(SCRIPTS,
                                            "fidelity_check_torch.py"),
               "--model", args.model, "--eval-only",
               "--checkpoint", os.path.join(args.dest, "model"),
               "--workdir", args.workdir, *eval_args]
        if args.device is not None:
            cmd += ["--device", args.device]
        print("re-evaluating:", " ".join(cmd), file=sys.stderr, flush=True)
        # capture stdout (the JSON report) only; let stderr stream so eval
        # progress and any failure diagnostics stay visible
        out = subprocess.run(cmd, check=True, stdout=subprocess.PIPE,
                             text=True)
        report = json.loads(out.stdout.strip().splitlines()[-1])
        with open(os.path.join(args.dest, "fidelity_report.json"), "w") as f:
            json.dump(report, f, indent=1)
        copied.append("fidelity_report.json")
        print(f"gate: pass_5pct={report['pass_5pct']} "
              f"(auto={report['auto']}, cross={report['cross']})",
              file=sys.stderr, flush=True)

    # report.md from whatever now sits in the directory
    subprocess.run([sys.executable,
                    os.path.join(SCRIPTS, "make_model_report_torch.py"),
                    args.dest], check=True)

    # the golden paint pin (tests/test_paint_goldens.py) freezes the
    # committed checkpoints' products; a promotion changes them, so refresh
    # the goldens (the JAX package's own script) or the pin test fails on
    # the next run
    repo_models = os.path.realpath(
        os.path.join(os.path.dirname(SCRIPTS), "trained_models"))
    in_repo = os.path.realpath(args.dest).startswith(repo_models + os.sep)
    if not args.skip_goldens and in_repo:
        env = dict(os.environ, JAX_PLATFORMS="cpu")
        r = subprocess.run([sys.executable,
                            os.path.join(SCRIPTS, "make_paint_goldens.py")],
                           env=env, check=False)
        if r.returncode:
            print("warning: golden regeneration failed — run "
                  "scripts/make_paint_goldens.py manually or the pin test "
                  "will fail", file=sys.stderr, flush=True)
        else:
            copied.append("tests/goldens/paint_goldens.npz (refreshed)")
    for generated in ("report.md", "loss_curves.png"):
        if os.path.exists(os.path.join(args.dest, generated)):
            copied.append(generated)
    print(json.dumps({"dest": args.dest, "files": copied}))


if __name__ == "__main__":
    main()
