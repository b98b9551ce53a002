"""Phase 23 of ``chip_smoke.py``: the port's meshes (``parallel/mesh.py``)
on one card.

One card cannot show a speed across cards; it can run every multi-device
path for real:

* 23a -- a world of one rank over NCCL: the fiducial CVAE's f32 training
  step (batch 24, 512^2, K2 + K3 + K4) under a ``ProcessMesh`` equals the
  same step without a mesh bit for bit (a one-rank all-reduce is the
  identity), with phase 11's launches.
* 23b -- two ranks on the one card over gloo (NCCL will not put two ranks
  on one device; gloo carries the all-reduces and broadcasts of CUDA
  tensors; each rank's mesh made with no device, so on the card by
  default): the same step, 12 rows a rank, through the z-sharded stack
  cache, held to the whole-model f64 step on the same device-grouped
  batch: the loss to 1e-5, the worst gradient leaf's distance within
  max(1e-3, ``smoke.STEP_F64_FACTOR`` times the one-process K4 step's
  worst leaf's), and each leaf's within max(1e-3, ``STEP_F64_FACTOR``
  times the largest of the one-process kernels, one-process plain and
  two-rank plain steps' distances for that leaf); each rank with 23a's
  launches; each rank's samples/s (two processes sharing one card, not a
  multi-card speed).
* 23c -- the lightcone CLI's tiled paint (f32, K1 + K3, phase 16's
  synthetic line of sight) sharded over ``DeviceMesh([card] * 2)`` against
  the same run without a mesh, golden tolerance on every plane and the y
  map; K1 launches 4 times a shard, 8 times a paint call of 16 tiles.
* 23d -- ``paint_plane`` of a 1024^2 plane over meshes of 2 (equal
  slabs) and 3 (unequal, the last one wrapping) against ``mesh=None``,
  both painters, golden tolerance.

A collective that fails or a rank that does not finish in time fails the
phase. The ranks of 23b are processes of their own:

    python -m baryon_painter_tpu_torch.smoke_mesh RANK WORLD PORT DIR

(``DIR`` holds the parent's ``inputs.pt``; each rank writes its result
there.) Imports only torch, numpy and the port.
"""
from __future__ import annotations

import contextlib
import datetime
import json
import os
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

from baryon_painter_tpu_torch import smoke
from baryon_painter_tpu_torch.parallel.mesh import (DeviceMesh,
                                                    initialize_multihost)

MESH_RANKS = 2
GROUP_TIMEOUT = datetime.timedelta(seconds=120)
RANKS_TIMEOUT_S = 240
STEP_LR = 1e-4
TIMED_STEPS = 3
MESH_PLANE = 1024
PLANE_MESHES = (2, 3)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def process_group(backend: str, device, rank: int = 0, world: int = 1,
                  port: int = None):
    """A process group over ``tcp://localhost:port`` (a free port for a
    world of one) and this rank's ``ProcessMesh`` on ``device``, made by
    ``initialize_multihost`` with no device where ``device`` is the card
    (its default); destroyed on exit."""
    port = _free_port() if port is None else port
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", 0)
    mesh = initialize_multihost(
        backend, f"tcp://localhost:{port}", world, rank,
        device=None if device.type == "cuda" else device,
        timeout=GROUP_TIMEOUT)
    try:
        if mesh.device != device:
            raise AssertionError(f"rank {rank}'s mesh is on {mesh.device}, "
                                 f"not {device}")
        yield mesh
    finally:
        dist.destroy_process_group()


def _expected_step_launches(device, tile: int) -> dict:
    if torch.device(device).type != "cuda":
        return {}
    sites = smoke.k4_sites_per_step(tile)
    return {"k2": 1, "k3_fwd": 1, "k3_bwd": 1, "k4_stats": sites,
            "k4_fwd": sites, "k4_bwd1": sites, "k4_bwd2": sites}


def mesh_step(device, dataset, idx, eps, mesh=None,
              n_res_blocks: int = smoke.N_RES_BLOCKS, kernels: bool = True):
    """The phase-11 step (K2, K3, K4; with ``kernels=False`` the plain
    step: the plain gather, cuDNN's heads, cuDNN's convolutions and
    ``BatchNorm`` at K4's sites; cuDNN's deterministic algorithms) from
    the seeded initialisation on the global batch ``idx`` with the latent
    noise ``eps``: (trainer, loss, gradients, parameters, buffers), the
    tensors cloned."""
    trainer = smoke.make_trainer(
        device, dataset, kernels, use_kernel=kernels,
        fused_train_conv=kernels, n_res_blocks=n_res_blocks, mesh=mesh)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        m = trainer.step_indices(idx, STEP_LR, eps=eps)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    model = trainer.model
    return (trainer, m["elbo"].detach().clone(),
            {n: p.grad.detach().clone() for n, p in model.named_parameters()
             if p.grad is not None},
            {n: p.detach().clone() for n, p in model.named_parameters()},
            {n: b.detach().clone() for n, b in model.named_buffers()})


def world_of_one(device, dataset, batch: int = smoke.TRAIN_BATCH,
                 n_res_blocks: int = smoke.N_RES_BLOCKS,
                 backend: str = "nccl") -> dict:
    """Phase 23a (module docstring). ``backend`` gloo runs it on the
    CPU."""
    t0 = time.perf_counter()
    device = torch.device(device)
    idx, eps = smoke.parity_inputs(dataset, batch)
    plain = mesh_step(device, dataset, idx, eps, None, n_res_blocks)[1:]
    with process_group(backend, device) as mesh:
        smoke._reset_launches()
        got = mesh_step(device, dataset, idx, eps, mesh, n_res_blocks)[1:]
        smoke._sync(device)
        launches = smoke._launches()
    smoke._expect_launches("23a step under a one-rank mesh", launches,
                           _expected_step_launches(device,
                                                   dataset.tile_size))
    differ = [f"{part}:{name}"
              for part, a, b in zip(("grads", "params", "buffers"), got[1:],
                                    plain[1:])
              for name in b if not torch.equal(a[name], b[name])]
    if not torch.equal(got[0], plain[0]):
        differ.insert(0, "loss")
    if differ:
        raise AssertionError(f"23a: the one-rank mesh step differs from the "
                             f"step without a mesh at {differ[:8]} "
                             f"({len(differ)} tensors)")
    smoke._line("23a", "mesh_world_of_one", t0, backend=backend,
                batch=batch, launches=json.dumps(launches),
                bit_equal_tensors=sum(len(t) for t in plain[1:]) + 1)
    return {"launches": launches, "backend": backend}


def mesh_batch(dataset, batch: int, ranks: int = MESH_RANKS):
    """23b's global batch: device-grouped for the z-sharded cache over
    ``ranks`` (``sample_mesh_indices``, numpy seed 2), and its latent noise
    (torch seed 3), as ``smoke.parity_inputs`` seeds 8b's."""
    from baryon_painter_tpu_torch.data.device_cache import \
        sample_mesh_indices
    idx = sample_mesh_indices(dataset, ranks, np.random.default_rng(2),
                              batch)
    hz = dataset.tile_size // 32
    return idx, torch.randn((1, batch, 1, hz, hz),
                            generator=torch.Generator().manual_seed(3))


def rank_main(argv):
    """One rank of 23b: the data-parallel step (its launches counted),
    then TIMED_STEPS more steps timed, then the plain data-parallel step;
    rank 0 saves both steps' losses and gradients."""
    rank, world, port, work = int(argv[0]), int(argv[1]), int(argv[2]), \
        argv[3]
    inputs = torch.load(os.path.join(work, "inputs.pt"), weights_only=False)
    device = torch.device(inputs["device"])
    if device.type == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(1)
    dataset = smoke.training_data(inputs["tile"])
    with process_group("gloo", device, rank, world, port) as mesh:
        smoke._reset_launches()
        trainer, loss, grads, _, _ = mesh_step(
            device, dataset, inputs["idx"], inputs["eps"], mesh,
            inputs["n_res_blocks"])
        smoke._sync(device)
        launches = smoke._launches()
        steps = []
        for i in range(TIMED_STEPS + 1):
            idx = trainer.device_cache.sample_mesh_indices(
                np.random.default_rng(100 + i), len(inputs["idx"]))
            mesh.barrier()
            smoke._sync(device)
            t = time.perf_counter()
            trainer.step_indices(idx, STEP_LR)
            smoke._sync(device)
            steps.append(time.perf_counter() - t)
        plain = mesh_step(device, dataset, inputs["idx"], inputs["eps"],
                          mesh, inputs["n_res_blocks"], kernels=False)
        mesh.barrier()
    step_s = float(np.mean(steps[1:]))
    rows = len(inputs["idx"]) // world
    result = {"rank": rank, "launches": launches, "step_s": step_s,
              "rank_samples_per_s": rows / step_s,
              "samples_per_s": len(inputs["idx"]) / step_s,
              "device": str(device)}
    if rank == 0:
        torch.save({label: {"loss": l.cpu(),
                            "grads": {n: g.cpu() for n, g in gs.items()}}
                    for label, l, gs in (("kernels", loss, grads),
                                         ("plain", plain[1], plain[2]))},
                   os.path.join(work, "grads.pt"))
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


def _run_ranks(work: str, world: int) -> list:
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(smoke.REPO))
    procs = [subprocess.Popen(
        [sys.executable, "-m", "baryon_painter_tpu_torch.smoke_mesh",
         str(r), str(world), str(port), work], cwd=str(smoke.REPO), env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    deadline = time.perf_counter() + RANKS_TIMEOUT_S
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.perf_counter()))[0])
    except subprocess.TimeoutExpired:
        raise AssertionError(f"23b: the ranks did not finish within "
                             f"{RANKS_TIMEOUT_S} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        if p.returncode != 0:
            raise AssertionError(f"23b: rank {r} exited {p.returncode}:\n"
                                 f"{log[-6000:]}")
    out = []
    for r in range(world):
        with open(os.path.join(work, f"rank{r}.json")) as f:
            out.append(json.load(f))
    return out


def two_ranks(device, dataset, batch: int = smoke.TRAIN_BATCH,
              n_res_blocks: int = smoke.N_RES_BLOCKS, card=None) -> dict:
    """Phase 23b (module docstring). Beside the kernels' data-parallel
    step the ranks run the plain data-parallel step (the plain gather,
    cuDNN's heads and convolutions), and this process the one-process
    kernels and plain steps and the f64 step on the same batch. Held: the
    kernels' data-parallel loss within STEP_LOSS_RTOL of f64, and its
    gradient no further from f64 than the f32 steps are: its worst leaf's
    distance within max(STEP_GRAD_TOL, STEP_F64_FACTOR times the
    one-process kernels step's worst leaf's), and each leaf's within
    max(STEP_GRAD_TOL, STEP_F64_FACTOR times the largest distance of the
    three other f32 steps for that leaf: one-process kernels, one-process
    plain, data-parallel plain). A leaf's f32 distance from f64 moves by
    up to 4x between equally valid f32 executions of the step
    (``PERF.md`` §6), so each leaf is held to the spread of those
    executions, not to the one-process kernels step's alone; that share
    is printed beside."""
    t0 = time.perf_counter()
    device = torch.device(device)
    idx, eps = mesh_batch(dataset, batch)
    one = {label: smoke.step_gradients(device, dataset, idx, eps, k, k,
                                       n_res_blocks=n_res_blocks)
           for label, k in (("kernels", True), ("plain", False))}
    loss64, grads64 = smoke.step_gradients_f64(device, dataset, idx, eps,
                                               n_res_blocks)
    with tempfile.TemporaryDirectory(prefix="bpt_mesh_") as work:
        torch.save({"idx": idx, "eps": eps, "device": str(device),
                    "tile": dataset.tile_size,
                    "n_res_blocks": n_res_blocks},
                   os.path.join(work, "inputs.pt"))
        ranks = _run_ranks(work, MESH_RANKS)
        saved = torch.load(os.path.join(work, "grads.pt"))
    dp = {label: (float(v["loss"]),
                  {n: g.to(device) for n, g in v["grads"].items()})
          for label, v in saved.items()}
    errs = {f"{kind}_{label}": smoke.step_grad_errors(run[1], grads64)[0]
            for kind, runs in (("dp", dp), ("one", one))
            for label, run in runs.items()}
    worst = {k: max(v.values()) for k, v in errs.items()}
    loss_err = abs(dp["kernels"][0] - loss64) / abs(loss64)
    share = worst["dp_kernels"] / max(smoke.STEP_GRAD_TOL,
                                      smoke.STEP_F64_FACTOR
                                      * worst["one_kernels"])
    limit = lambda n, refs: max(smoke.STEP_GRAD_TOL, smoke.STEP_F64_FACTOR
                                * max(errs[r][n] for r in refs))
    leaf_one = {n: e / limit(n, ("one_kernels",))
                for n, e in errs["dp_kernels"].items()}
    leaf_all = {n: e / limit(n, ("one_kernels", "one_plain", "dp_plain"))
                for n, e in errs["dp_kernels"].items()}
    for n in sorted(leaf_one, key=leaf_one.get)[-3:]:
        print(f"  {n}: from f64, data-parallel kernels "
              f"{errs['dp_kernels'][n]:.3e}, data-parallel plain "
              f"{errs['dp_plain'][n]:.3e}, one-process kernels "
              f"{errs['one_kernels'][n]:.3e}, one-process plain "
              f"{errs['one_plain'][n]:.3e}", flush=True)
    want = _expected_step_launches(device, dataset.tile_size)
    for r in ranks:
        smoke._expect_launches(f"23b rank {r['rank']}", r["launches"], want)
    for r in ranks:
        print(f"  rank {r['rank']}: {r['rank_samples_per_s']:.2f} samples/s "
              f"of its {batch // MESH_RANKS} rows ({r['samples_per_s']:.2f} "
              f"of the global batch; {MESH_RANKS} processes sharing one "
              f"card, not a multi-card speed)", flush=True)
    top_one = max(leaf_one, key=leaf_one.get)
    top_all = max(leaf_all, key=leaf_all.get)
    if not (loss_err <= smoke.STEP_LOSS_RTOL and share <= 1.0
            and leaf_all[top_all] <= 1.0):
        raise AssertionError(f"23b: against f64 the loss {loss_err:.3e}, "
                             f"the worst gradient leaf {worst} at "
                             f"{share:.3f} of its limit, leaf {top_all} at "
                             f"{leaf_all[top_all]:.3f} of its own")
    smoke._line(
        "23b", "mesh_two_ranks_one_card", t0, backend="gloo",
        card=json.dumps(card), ranks=MESH_RANKS, batch=batch,
        rows_per_rank=batch // MESH_RANKS, cache="z_sharded",
        f64_loss_rel_err=f"{loss_err:.3e}",
        one_process_f64_loss_rel_err=(
            f"{abs(one['kernels'][0] - loss64) / abs(loss64):.3e}"),
        **{f"f64_worst_leaf_{k}": f"{v:.3e}" for k, v in worst.items()},
        f64_worst_leaf_share=f"{share:.3f}",
        leaf_share_one_process=f"{leaf_one[top_one]:.3f}",
        leaf_share_one_process_leaf=top_one,
        leaf_share_envelope=f"{leaf_all[top_all]:.3f}",
        leaf_share_envelope_leaf=top_all,
        launches_per_rank=json.dumps([r["launches"] for r in ranks]),
        rank_samples_per_s=json.dumps(
            [round(r["rank_samples_per_s"], 2) for r in ranks]),
        step_s=json.dumps([round(r["step_s"], 4) for r in ranks]),
        note="two processes sharing one card, not a multi-card speed")
    return {"launches": ranks[0]["launches"], "ranks": ranks,
            "loss_rel_err": loss_err, "limit_share": share,
            "leaf_share_one_process": leaf_one[top_one],
            "leaf_share_envelope": leaf_all[top_all]}


def lightcone_sharded(device, data: dict, ranks: int = MESH_RANKS) -> dict:
    """Phase 23c (module docstring)."""
    t0 = time.perf_counter()
    device = torch.device(device)
    los, shells, size = data["los"], data["shells"], data["size"]
    mesh = DeviceMesh([device] * ranks)
    runs, counts = {}, {}
    for label, m in (("plain", None), ("mesh", mesh)):
        smoke._reset_launches()
        runs[label] = smoke.run_lightcone_cli(device, los, "f32", True,
                                              mesh=m, **size)
        counts[label] = smoke._launches()
    if device.type == "cuda":
        calls = {k: sum(s["calls"] for s in shells if s["kind"] == k)
                 for k in ("massplane", "delta")}
        # the massplane shell's one tile paints unsharded
        smoke._expect_launches("23c sharded lightcone", counts["mesh"], {
            "k1": 4 * calls["massplane"] + 4 * ranks * calls["delta"],
            "k3_fwd": calls["massplane"] + ranks * calls["delta"]})
    planes = [smoke._golden_ratio(p, q) for p, q in
              zip(runs["mesh"]["planes"], runs["plain"]["planes"])]
    y = smoke._golden_ratio(runs["mesh"]["y_map"], runs["plain"]["y_map"])
    if not (max(planes) <= 1.0 and y <= 1.0):
        raise AssertionError(f"23c: the sharded lightcone against the "
                             f"unsharded: planes {planes}, y map {y} of "
                             f"the golden tolerance")
    smoke._line("23c", "mesh_lightcone_tiles", t0, mesh=ranks,
                launches=json.dumps(counts["mesh"]),
                unsharded_launches=json.dumps(counts["plain"]),
                planes_err_over_tol=json.dumps([round(v, 4)
                                                for v in planes]),
                y_map_err_over_tol=f"{y:.4f}")
    return {"launches": counts["mesh"], "planes_err_over_tol": planes,
            "y_map_err_over_tol": y}


def planes_sharded(device, n: int = MESH_PLANE,
                   meshes=PLANE_MESHES) -> dict:
    """Phase 23d (module docstring)."""
    from baryon_painter_tpu_torch.parallel import spatial
    t0 = time.perf_counter()
    device = torch.device(device)
    plane = smoke.golden_inputs(n, 1)[0]
    out = {}
    for label, painter, kind, _ in smoke._spatial_painters(device):
        eps = None
        if kind == "cvae":
            gen = torch.Generator(device=device).manual_seed(0)
            eps = torch.randn(spatial.latent_noise_shape(painter,
                                                         plane.shape),
                              generator=gen, device=device)
        ref = spatial.paint_plane(painter, plane, 0.5, eps=eps).cpu()
        for m in meshes:
            got = spatial.paint_plane(painter, plane, 0.5, eps=eps,
                                      mesh=DeviceMesh([device] * m)).cpu()
            ratio = smoke._golden_ratio(got, ref)
            out[f"{label}_{m}"] = {"err_over_tol": ratio}
            if not (ratio <= 1.0 and torch.isfinite(got).all()):
                raise AssertionError(f"23d: {label} over {m} devices "
                                     f"against mesh=None: {ratio} of the "
                                     f"golden tolerance")
    smoke._line("23d", "mesh_paint_plane", t0, plane=n,
                err_over_tol=json.dumps({k: round(v["err_over_tol"], 4)
                                         for k, v in out.items()}))
    return out


if __name__ == "__main__":
    rank_main(sys.argv[1:])
