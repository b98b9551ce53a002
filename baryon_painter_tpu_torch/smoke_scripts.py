"""Phase 24 of ``chip_smoke.py``: the last user-facing script twins on the
card, each through its own code (``scripts/*_torch.py``).

* 24a -- ``gate_variance_torch``: the gate's eval-noise floor of the
  committed ``physical-512-lt-wip`` CVAE at 512^2, bf16, 192 tiles a
  redshift painted in one call and bootstrapped 400 times at 48, at 3 of
  its 11 redshifts (0, 1, 2; depth cut for time) on phase 20d's stacks of
  the same geometry when they are kept (``gate_stacks``), else written
  here. Each redshift's paint call launches exactly 4 K1 and 1 K3-fwd
  (bf16); each ``auto_full`` / ``cross_full`` within ``GV_KERNEL_TOL`` of
  the same call with the kernels off (cuDNN's blocks and heads) at the
  same prior noise (20a's rule). Prints the peak device memory, the
  seconds of set-up, paint, spectra and bootstrap, and
  ``binding_sigma_at_eval_n``.
* 24b -- ``pk_diagnose_torch`` on a workdir written here: 512^2
  synthetic stacks of the fiducial CVAE's committed evaluation
  (``smoke.GATE_CVAE_DATASET``'s fixture, one stack, at 20a's redshifts)
  and the committed fiducial CVAE's weights saved as a bf16 trainer
  checkpoint (``fidelity_model_cvae``). Each paint call (16 tiles, 3
  redshifts) launches exactly 4 K1 and 1 K3-fwd; every ratio and r(k) is
  finite, r <= 1 + ``R_SLACK``; each auto and cross ratio within
  max(``PK_KERNEL_TOL``, the largest |bf16 - f32| of the kernels-off
  diagnostic's ratios at that redshift) of the same diagnostic with the
  kernels off (bf16 is chaotic: no further than bf16 lies from f32
  there); the bins beyond ``PK_KERNEL_TOL`` alone are counted and
  printed.
* 24c -- ``transform_examples_torch`` on the card: round trip under
  1e-3, split-scale recomposition under 1e-5 (the JAX test's limits),
  each mode's forward range within rtol 1e-5 of the same twin on the CPU.
* 24d -- ``promote_checkpoint_torch --skip-goldens`` of 24b's workdir
  into a temporary directory, its ``fidelity_check_torch.py --eval-only``
  on the card (at one redshift of 24b's fixture, which it writes again
  with two stacks): the stripped state re-reads without training keys,
  ``report.md`` is written, the manifest lists exactly the files there.

Any failed rule raises. Imports only torch, numpy and the port.
"""
from __future__ import annotations

import contextlib
import io
import json
import os
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from baryon_painter_tpu_torch import smoke

SCRIPTS = smoke.REPO / "scripts"
GV_CHECKPOINT = "trained_models/CVAE/physical-512-lt-wip/model"
# 20d's case whose stacks (the checkpoint's fidelity_dataset) 24a reads
GV_PREFIX = "cvae_lt"
GV_REDSHIFTS = "0,1,2"
GV_KERNEL_TOL = smoke.GATE_KERNEL_TOL
PK_TILE = 512
PK_REDSHIFTS = smoke.GATE_CVAE_Z
PK_KERNEL_TOL = 2e-3
R_SLACK = 1e-6
TRANSFORM_N = 256
ROUNDTRIP_LIMIT = 1e-3
SPLIT_LIMIT = 1e-5
TRANSFORM_RTOL = 1e-5
# 24b's fixture at one redshift (the re-evaluation writes the stacks of
# its flags; its training split needs a second stack)
PROMOTE_EVAL_ARGS = "--redshifts 0 --n-stack 2"


@contextlib.contextmanager
def gate_stacks():
    """A directory for phase 20d to keep ``GV_PREFIX``'s synthetic stacks
    in for phase 24 (``smoke.gate(keep=...)``), removed on exit."""
    with tempfile.TemporaryDirectory() as root:
        yield {GV_PREFIX: Path(root)}


class _Counted:
    """A painter whose ``paint_batch`` calls record the kernels' launches
    of each call (all, and bf16)."""

    def __init__(self, painter):
        self.painter, self.device, self.calls = painter, painter.device, []

    def paint_batch(self, *a, **kw):
        smoke._sync(self.device)
        before, before16 = smoke._launches(), smoke._bf16_launches()
        out = self.painter.paint_batch(*a, **kw)
        smoke._sync(self.device)
        self.calls.append(
            ({k: v - before[k] for k, v in smoke._launches().items()},
             {k: v - before16[k] for k, v in smoke._bf16_launches().items()}))
        return out


def _expect_calls(path: str, counted: _Counted, want: dict):
    """Each paint call launched exactly ``want`` (in bf16, as the painter
    computes) on the card; none on the CPU."""
    want = want if counted.device.type == "cuda" else {}
    for i, (launches, bf16) in enumerate(counted.calls):
        smoke._expect_launches(f"{path} call {i}", launches, want)
        smoke._expect_launches(f"{path} call {i} (bf16)", bf16, want)


def _quiet(fn, *a, **kw):
    """``fn`` with its stdout captured (the twins print their JSON lines;
    the smoke's own JSON lines stay the last ones); returns (result, the
    captured text)."""
    with contextlib.redirect_stdout(io.StringIO()) as out:
        result = fn(*a, **kw)
    return result, out.getvalue()


def gate_variance(device, workdir: Path, card=None,
                  checkpoint: str = GV_CHECKPOINT,
                  redshifts: str = GV_REDSHIFTS, flags=()) -> dict:
    """Phase 24a (module docstring); ``flags``: more of the twin's flags
    (the CPU test's smaller sizes)."""
    twin = smoke._load_cli(SCRIPTS / "gate_variance_torch.py")
    t0 = time.perf_counter()
    device = torch.device(device)
    base = str(smoke.REPO / checkpoint)
    args = twin.parse_args(["--checkpoint", base, "--workdir", str(workdir),
                            "--redshifts", redshifts, "--device",
                            str(device), *flags])
    meta, geom = twin.read_meta(base)
    info = workdir / "fid_files_info.pickle"
    reused = info.exists()
    if not reused:
        twin.write_stacks(str(workdir), geom)
    ds = twin.validation_split(str(info), str(workdir), meta)
    zs = tuple(float(z) for z in redshifts.split(","))
    run = dict(n_tiles=args.n_tiles, eval_n=args.eval_n, n_boot=args.n_boot,
               seed=args.seed, gate=args.gate)
    kernels = _Counted(twin.make_painter(base, meta, args.dtype, device))
    setup_s = time.perf_counter() - t0
    times = {}
    base_mem = smoke._peak_start(device)
    smoke._reset_launches()
    per_z = twin.gate_variance(kernels, ds, zs, times=times, **run)
    peak = smoke._peak_since(device, base_mem)
    _expect_calls("24a gate_variance", kernels,
                  {"k1": smoke.N_RES_BLOCKS, "k3_fwd": 1})
    rec = twin.record(args, per_z)
    kernels_calls = kernels.calls
    del kernels
    plain = _Counted(twin.make_painter(base, meta, args.dtype, device,
                                       fused=False))
    plain_times = {}
    base_mem = smoke._peak_start(device)
    plain_z = twin.gate_variance(plain, ds, zs, times=plain_times, **run)
    plain_peak = smoke._peak_since(device, base_mem)
    _expect_calls("24a gate_variance, kernels off", plain, {})
    del plain
    diffs = {}
    for z in per_z:
        for k in ("auto_full", "cross_full"):
            diffs[f"{z}/{k}"] = abs(per_z[z][k] - plain_z[z][k])
            print(f"  24a z={z} {k}: kernels {per_z[z][k]} / off "
                  f"{plain_z[z][k]} ({diffs[f'{z}/{k}']:.1e})", flush=True)
    per_call = kernels_calls[0][1]
    fails = {k: d for k, d in diffs.items() if d > GV_KERNEL_TOL}
    join = lambda xs: ",".join(f"{x:.3f}" for x in xs)
    smoke._line("24a", "gate_variance", t0, checkpoint=checkpoint,
                card=json.dumps(card), redshifts=redshifts,
                tiles=args.n_tiles, n_boot=args.n_boot, eval_n=args.eval_n,
                stacks="20d" if reused else "written",
                calls=len(kernels_calls),
                bf16_launches_per_call=json.dumps(per_call),
                peak_gb=f"{peak / 1e9:.3f}",
                plain_peak_gb=f"{plain_peak / 1e9:.3f}",
                setup_s=f"{setup_s:.3f}", paint_s=join(times["paint_s"]),
                spectra_s=join(times["spectra_s"]),
                boot_s=join(times["boot_s"]),
                plain_paint_s=join(plain_times["paint_s"]),
                binding_z=rec["binding_z"],
                binding_full=rec["binding_full"],
                binding_sigma_at_eval_n=rec["binding_sigma_at_eval_n"],
                kernels_vs_off_max=f"{max(diffs.values()):.1e}")
    if fails:
        raise AssertionError(f"24a: kernels against kernels off beyond "
                             f"{GV_KERNEL_TOL}: {fails}")
    return {"record": rec, "times": times, "peak_bytes": peak,
            "launches_per_call": per_call, "calls": len(kernels_calls),
            "diffs": diffs}


def _rows(per_z: dict) -> dict:
    return {z: {k: np.array([r[k] for r in rows])
                for k in ("k", "auto_ratio", "cross_ratio", "r")}
            for z, rows in per_z.items()}


def pk_diagnose(device, workdir: Path, card=None, tile: int = PK_TILE,
                n_sample: int = 16, redshifts: str = PK_REDSHIFTS) -> dict:
    """Phase 24b (module docstring): stacks of ``tile`` at ``redshifts``
    written into ``workdir``, ``n_sample`` tiles a redshift."""
    from baryon_painter_tpu_torch.data.synthetic import make_synthetic_stacks
    from baryon_painter_tpu_torch.models.cvae import (
        CVAE, fiducial_cvae_architecture)
    from baryon_painter_tpu_torch.train.trainer import (CVAETrainer,
                                                        TrainConfig)
    twin = smoke._load_cli(SCRIPTS / "pk_diagnose_torch.py")
    t0 = time.perf_counter()
    device = torch.device(device)
    args = twin.parse_args(["--workdir", str(workdir), "--tile", str(tile),
                            "--n-sample", str(n_sample), "--device",
                            str(device)])
    geom = smoke.GATE_CVAE_DATASET
    make_synthetic_stacks(str(workdir), n_stack=1, n_grid=2 * tile,
                          redshifts=tuple(float(z) for z in
                                          redshifts.split(",")),
                          seed=geom["seed"], name="fid",
                          pressure_noise=geom["pressure_noise"])
    ds = twin.dataset(str(workdir))
    arch = fiducial_cvae_architecture(tile_size=tile, n_res_blocks=4)
    trainer = CVAETrainer(CVAE(arch, dtype=torch.bfloat16, fused_heads=True),
                          ds, config=TrainConfig(seed=args.seed),
                          variables=smoke._fiducial_variables(),
                          device=device)
    trainer.save(str(workdir / "fidelity_model_cvae"))
    del trainer
    kernels = _Counted(twin.restore_painter(args, ds, device=device))
    plain = _Counted(twin.restore_painter(args, ds, device=device,
                                          fused=False))
    setup_s = time.perf_counter() - t0
    t = time.perf_counter()
    got, table = _quiet(twin.diagnose, kernels, ds, n_sample=args.n_sample,
                        seed=args.seed)
    smoke._sync(device)
    diagnose_s = time.perf_counter() - t
    _expect_calls("24b pk_diagnose", kernels,
                  {"k1": smoke.N_RES_BLOCKS, "k3_fwd": 1})
    want, _ = _quiet(twin.diagnose, plain, ds, n_sample=args.n_sample,
                     seed=args.seed)
    _expect_calls("24b pk_diagnose, kernels off", plain, {})
    del plain
    # the same diagnostic in f32 (kernels off): bf16's own distance
    plain32 = twin.restore_painter(args, ds, device=device, fused=False,
                                   dtype=None)
    want32, _ = _quiet(twin.diagnose, plain32, ds, n_sample=args.n_sample,
                       seed=args.seed)
    del plain32
    g, w, w32 = _rows(got), _rows(want), _rows(want32)
    bad, diff, share, flat_over = [], {}, {}, 0
    kinds = ("auto_ratio", "cross_ratio")
    for z in g:
        for k in kinds + ("r",):
            if not np.all(np.isfinite(g[z][k])):
                bad.append((z, k, "not finite"))
        if np.any(g[z]["r"] > 1 + R_SLACK):
            bad.append((z, "r", float(g[z]["r"].max())))
        # bf16's own distance from f32 at this redshift, over its bins
        limit = max(PK_KERNEL_TOL, max(float(np.abs(w[z][k] - w32[z][k])
                                             .max()) for k in kinds))
        for k in kinds:
            d = np.abs(g[z][k] - w[z][k])
            diff[z, k] = float(d.max())
            share[z, k] = diff[z, k] / limit
            flat_over += int(np.sum(d > PK_KERNEL_TOL))
            if share[z, k] > 1:
                bad.append((z, k, diff[z, k], share[z, k]))
    r_diff = max(float(np.abs(g[z]["r"] - w[z]["r"]).max()) for z in g)
    smoke._line("24b", "pk_diagnose", t0, card=json.dumps(card),
                tile=tile, redshifts=len(g), tiles=args.n_sample,
                calls=len(kernels.calls),
                bf16_launches_per_call=json.dumps(kernels.calls[0][1]),
                setup_s=f"{setup_s:.3f}", diagnose_s=f"{diagnose_s:.3f}",
                r_max=f"{max(float(g[z]['r'].max()) for z in g):.6f}",
                kernels_vs_off_max=f"{max(diff.values()):.1e}",
                share_of_limit_max=f"{max(share.values()):.3f}",
                bins_over_flat_tol=flat_over,
                r_kernels_vs_off_max=f"{r_diff:.1e}",
                table_lines=len(table.splitlines()))
    if bad:
        raise AssertionError(f"24b: {bad}")
    return {"per_z": got, "calls": len(kernels.calls),
            "launches_per_call": kernels.calls[0][1],
            "diff": {f"{z}/{k}": v for (z, k), v in diff.items()},
            "share": {f"{z}/{k}": v for (z, k), v in share.items()}}


def transform_examples(device, card=None, n: int = TRANSFORM_N) -> dict:
    """Phase 24c (module docstring)."""
    twin = smoke._load_cli(SCRIPTS / "transform_examples_torch.py")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        report, _ = _quiet(twin.main, ["--out", tmp, "--n", str(n),
                                       "--device", str(device)])
        written = json.loads(Path(tmp, "report.json").read_text())
    cpu = twin.examples(n, 0, "cpu")[1]
    bad = []
    if written != report:
        bad.append("report.json")
    for mode, r in report["modes"].items():
        if mode == "split-scale":
            if not r["recompose_max_rel_err"] < SPLIT_LIMIT:
                bad.append((mode, r["recompose_max_rel_err"]))
            continue
        if not r["roundtrip_max_rel_err"] < ROUNDTRIP_LIMIT:
            bad.append((mode, r["roundtrip_max_rel_err"]))
        want = np.asarray(cpu[mode]["fwd_range"])
        if not np.allclose(r["fwd_range"], want, rtol=TRANSFORM_RTOL,
                           atol=0):
            bad.append((mode, r["fwd_range"], want.tolist()))
    worst = max(r.get("roundtrip_max_rel_err", 0)
                for r in report["modes"].values())
    split = report["modes"]["split-scale"]["recompose_max_rel_err"]
    smoke._line("24c", "transform_examples", t0, card=json.dumps(card),
                n=n, modes=len(report["modes"]),
                figures=len(report["figures"]),
                roundtrip_max=f"{worst:.2e}", recompose=f"{split:.2e}")
    if bad:
        raise AssertionError(f"24c: {bad}")
    return {"report": report}


def promote(device, workdir: Path, card=None,
            eval_args: str = PROMOTE_EVAL_ARGS) -> dict:
    """Phase 24d (module docstring); ``eval_args`` reproduce the workdir's
    stacks for the re-evaluation."""
    from baryon_painter_tpu_torch.train.msgpack_reader import msgpack_restore
    twin = smoke._load_cli(SCRIPTS / "promote_checkpoint_torch.py")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        dest = Path(tmp) / "promoted"
        _, out = _quiet(twin.main, [
            "--workdir", str(workdir), "--model", "cvae", "--dest",
            str(dest), "--skip-goldens", "--eval-args", eval_args,
            "--device", str(device)])
        manifest = json.loads(out.strip().splitlines()[-1])
        with open(dest / "model_state.msgpack", "rb") as f:
            state = msgpack_restore(f.read(), numpy_scalars=True)
        present = sorted(os.listdir(dest))
        report = json.loads((dest / "fidelity_report.json").read_text())
        report_md = (dest / "report.md").exists()
    bad = []
    if (set(state) & set(twin._TRAIN_ONLY_KEYS)
            or not {"params", "batch_stats"} <= set(state)):
        bad.append(("state keys", sorted(state)))
    if not report_md:
        bad.append("no report.md")
    if sorted(manifest["files"]) != present:
        bad.append(("manifest", manifest["files"], present))
    smoke._line("24d", "promote_checkpoint", t0, card=json.dumps(card),
                files=",".join(present), state_keys=",".join(sorted(state)),
                gate=json.dumps({"auto": report["auto"],
                                 "cross": report["cross"],
                                 "pass_5pct": report["pass_5pct"]}))
    if bad:
        raise AssertionError(f"24d: {bad}")
    return {"manifest": manifest, "files": present, "report": report}


def scripts(device, keep: dict = None, card=None,
            sizes: dict = None) -> dict:
    """Phase 24: 24a on ``keep[GV_PREFIX]`` (20d's stacks) when given,
    else on stacks written into a temporary directory; 24b and 24d on a
    workdir of their own. ``sizes`` maps a part's name to keyword
    arguments of its function (the CPU test's smaller sizes)."""
    t0 = time.perf_counter()
    sizes = sizes or {}
    with contextlib.ExitStack() as stack:
        temp = lambda: Path(stack.enter_context(
            tempfile.TemporaryDirectory()))
        stacks = (keep or {}).get(GV_PREFIX) or temp()
        workdir = temp()
        out = {}
        for name, fn, kw in (
                ("gate_variance", gate_variance, {"workdir": stacks}),
                ("pk_diagnose", pk_diagnose, {"workdir": workdir}),
                ("transform_examples", transform_examples, {}),
                ("promote", promote, {"workdir": workdir})):
            out[name] = fn(device, card=card, **kw, **sizes.get(name, {}))
    smoke._line("24", "scripts", t0, card=json.dumps(card))
    return out


def add_launches(record: dict, result: dict):
    """Phase 24's launches on the bf16 K1 and K3-fwd entries of the
    kernels record: a paint call of 24a (192 tiles) and of 24b (16), and
    the calls of each."""
    keys = {"res_block_infer": "k1", "head_stack_fwd": "k3_fwd"}
    for entry in record["kernels"]:
        key = keys.get(entry["name"])
        if key is None or entry["dtype"] != "bfloat16":
            continue
        for phase, name in (("gate_variance", "gate_variance"),
                            ("pk_diagnose", "pk_diagnose")):
            r = result[phase]
            entry[f"{name}_launches_per_call"] = r["launches_per_call"][key]
            entry[f"{name}_calls"] = r["calls"]
