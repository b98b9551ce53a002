"""Rank processes of the port's data-parallel CPU tests
(``tests/test_torch_mesh*.py``), and the launcher that starts them.

Each rank is a process of its own, gloo over a ``file://`` rendezvous in
the test's temporary directory, one PyTorch thread, importing torch, numpy
and the port only (never JAX):

    python tests/torch_mesh_workers.py CASE RANK WORLD RENDEZVOUS OUT ARGS

``ARGS`` is a pickle of the case's inputs; each rank pickles its result to
``OUT/<rank>.pkl``. ``run_ranks`` starts the ranks, waits for them with a
timeout (a hung collective fails its test instead of stalling the suite)
and returns the ranks' results in rank order.
"""
import datetime
import os
import pickle
import subprocess
import sys
import time

import numpy as np

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
# the rendezvous and every collective fail after this long
GROUP_TIMEOUT_S = 60
TILE, LR = 32, 1e-3


def run_ranks(case: str, world: int, tmp_path, args: dict,
              timeout: float = 90.0) -> list:
    """Run ``case`` on ``world`` ranks; returns their results by rank.
    Any rank that fails, or does not finish within ``timeout`` seconds,
    fails the call (every rank is then killed)."""
    tmp = str(tmp_path)
    out = os.path.join(tmp, f"{case}_{world}_out")
    os.makedirs(out, exist_ok=True)
    rdv = os.path.join(tmp, f"{case}_{world}_{time.monotonic_ns()}.rdv")
    arg_file = os.path.join(out, "args.pkl")
    with open(arg_file, "wb") as f:
        pickle.dump(args, f)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), case, str(r), str(world),
         rdv, out, arg_file], cwd=REPO, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            left = max(1.0, deadline - time.monotonic())
            logs.append(p.communicate(timeout=left)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"{case} on {world} ranks did not finish in "
                             f"{timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {case}:\n{log[-4000:]}"
    results = []
    for r in range(world):
        with open(os.path.join(out, f"{r}.pkl"), "rb") as f:
            results.append(pickle.load(f))
    return results


# --------------------------------------------------------------------- #
# shared by the ranks and the tests

class Layout:
    """What the stack cache reads of a ``ProcessMesh`` (size, rank, device,
    ``rows``), to build rank ``rank``'s z-sharded cache without a process
    group."""

    def __init__(self, size: int, rank: int = 0):
        import torch
        self.size, self.rank, self.device = size, rank, torch.device("cpu")

    def rows(self, n: int):
        per = n // self.size
        return self.rank * per, (self.rank + 1) * per


def make_dataset(root: str, info: str):
    """The tests' synthetic training set (tests/test_torch_trainer.py's):
    2 x 2 tiles a side, dihedral permutations, shift-log(4) transforms."""
    from baryon_painter_tpu_torch.data.dataset import (BahamasTileDataset,
                                                       load_file_info)
    from baryon_painter_tpu_torch.transforms import RangeCompress
    return BahamasTileDataset(
        files=load_file_info(info), root_path=root, n_tile=2,
        tile_permutations=True,
        transforms={"dm": RangeCompress("shift-log", 4.0),
                    "pressure": RangeCompress("shift-log", 4.0)})


def cvae_arch():
    from baryon_painter_tpu_torch.models.cvae import \
        fiducial_cvae_architecture
    return fiducial_cvae_architecture(TILE, n_res_blocks=1)


def cvae_step(ds, variables, idx, eps, mesh=None, cache=False,
              fused_train_conv=False, lr=LR, config=None):
    """One CVAE step from ``variables`` on the global batch ``idx`` with
    the latent noise ``eps``: through the stack cache (z-sharded under a
    mesh) or on a host batch; ``config`` adds ``TrainConfig`` fields.
    Returns the metrics, parameters, gradients and running statistics as
    numpy, by name."""
    from baryon_painter_tpu_torch.models.cvae import CVAE
    from baryon_painter_tpu_torch.train.trainer import (CVAETrainer,
                                                        TrainConfig)
    model = CVAE(cvae_arch(), fused_train_conv=fused_train_conv)
    tr = CVAETrainer(model, ds, config=TrainConfig(seed=0, **(config or {})),
                     device="cpu", variables=variables, mesh=mesh,
                     device_data=cache)
    if cache:
        m = tr.step_indices(idx, lr, eps=eps)
    else:
        m = tr.step(ds.get_raw_batch(idx), lr, eps=eps)
    return module_state(tr.model, m)


def module_state(model, metrics=None) -> dict:
    out = {"params": {n: p.detach().numpy().copy()
                      for n, p in model.named_parameters()},
           "grads": {n: p.grad.numpy().copy()
                     for n, p in model.named_parameters()
                     if p.grad is not None},
           "buffers": {n: b.numpy().copy()
                       for n, b in model.named_buffers()}}
    if metrics is not None:
        out["metrics"] = {k: np.asarray(v.detach().float().numpy())
                          for k, v in metrics.items()}
    return out


def cgan_trainer(ds, state, mesh=None, cache=True, **cfg):
    from baryon_painter_tpu_torch.models.cgan import CGANGenerator
    from baryon_painter_tpu_torch.train.cgan import (CGANTrainConfig,
                                                     CGANTrainer)
    return CGANTrainer(ds, generator=CGANGenerator(n_res_blocks=1,
                                                   spectral_norm=True),
                       config=CGANTrainConfig(seed=0, **cfg),
                       device_data=cache, device="cpu", state=state,
                       mesh=mesh)


def cgan_result(tr, metrics) -> dict:
    return {"metrics": {k: float(v) for k, v in metrics.items()},
            "g": module_state(tr.generator),
            "d": module_state(tr.discriminator)}


# --------------------------------------------------------------------- #
# the cases (run on each rank)

def case_collectives(mesh, a):
    """The mesh's own collectives: sums, min, max, broadcast, the
    differentiable sum's gradient, the flat all-reduce."""
    import torch
    r = mesh.rank
    x = torch.arange(3.0) + r
    out = {"rank": mesh.rank, "size": mesh.size,
           "sum": mesh.all_reduce(x).numpy(),
           "min": mesh.all_reduce(x, "min").numpy(),
           "max": mesh.all_reduce(x, "max").numpy()}
    b = torch.full((2,), float(r))
    mesh.broadcast_([b])
    out["broadcast"] = b.numpy()
    t = (torch.arange(3.0) * (r + 1)).requires_grad_()
    (mesh.sum(t) * torch.tensor([1.0, 2.0, 3.0])).sum().backward()
    out["sum_grad"] = t.grad.numpy()
    a1, a2 = torch.ones(2) * r, torch.ones(3, dtype=torch.float64) * 2 * r
    mesh.all_reduce_flat_([a1, a2])
    out["flat"] = (a1.numpy(), a2.numpy())
    return out


def case_batchnorm(mesh, a):
    """Sync batch norm on this rank's rows of a global batch: its output
    and input gradient rows, its parameters' gradients summed over the
    ranks, and its running statistics."""
    import torch
    from baryon_painter_tpu_torch.models.layers import BatchNorm
    bn = BatchNorm(a["x"].shape[1]).train()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(a["weight"]))
        bn.bias.copy_(torch.from_numpy(a["bias"]))
    lo, hi = mesh.rows(a["x"].shape[0])
    x = torch.from_numpy(a["x"][lo:hi]).requires_grad_()
    with mesh.active():
        y = bn(x)
    (y * torch.from_numpy(a["dy"][lo:hi])).sum().backward()
    grads = [bn.weight.grad, bn.bias.grad]
    mesh.all_reduce_flat_(grads)
    out = {"y": y.detach().numpy(), "dx": x.grad.numpy(),
           "dweight": grads[0].numpy(), "dbias": grads[1].numpy(),
           "running_mean": bn.running_mean.numpy(),
           "running_var": bn.running_var.numpy()}
    if mesh.size == 1:
        # the same module without a mesh: a one-rank all-reduce is the
        # identity, bit for bit
        bn2 = BatchNorm(a["x"].shape[1]).train()
        bn2.load_state_dict({**bn.state_dict(),
                             "running_mean": torch.zeros_like(bn.weight),
                             "running_var": torch.ones_like(bn.weight)})
        x2 = torch.from_numpy(a["x"]).requires_grad_()
        y2 = bn2(x2)
        (y2 * torch.from_numpy(a["dy"])).sum().backward()
        out["plain"] = {"y": y2.detach().numpy(), "dx": x2.grad.numpy(),
                        "dweight": bn2.weight.grad.numpy(),
                        "dbias": bn2.bias.grad.numpy(),
                        "running_mean": bn2.running_mean.numpy(),
                        "running_var": bn2.running_var.numpy()}
    return out


def case_k4(mesh, a):
    """K4's autograd function (its plain versions on the CPU) on this
    rank's rows, inside the mesh: y, the batch statistics, dx rows and the
    weight, scale and shift gradients summed over the ranks."""
    import torch
    from baryon_painter_tpu_torch.ops.conv_bn import conv_bn_relu
    lo, hi = mesh.rows(a["x"].shape[0])
    x = torch.from_numpy(a["x"][lo:hi]).requires_grad_()
    w, g, b = (torch.from_numpy(a[k]).requires_grad_()
               for k in ("w", "gamma", "beta"))
    with mesh.active():
        y, mean, var = conv_bn_relu(x, w, g, b, **a["kw"])
    (y * torch.from_numpy(a["dy"][lo:hi])).sum().backward()
    grads = [w.grad, g.grad, b.grad]
    mesh.all_reduce_flat_(grads)
    return {"y": y.detach().numpy(), "mean": mean.numpy(),
            "var": var.numpy(), "dx": x.grad.numpy(),
            "dw": grads[0].numpy(), "dgamma": grads[1].numpy(),
            "dbeta": grads[2].numpy()}


def case_cvae(mesh, a):
    """One CVAE step on the host batch and one through the z-sharded
    cache; on one rank also both without a mesh, to compare bit for
    bit."""
    ds = make_dataset(a["root"], a["info"])
    out = {}
    kw = dict(fused_train_conv=a.get("fused_train_conv", False),
              config=a.get("config"))
    for cache, idx in ((False, a["idx"]), (True, a["idx_cache"])):
        out[cache] = cvae_step(ds, a["variables"], idx, a["eps"], mesh,
                               cache, **kw)
        if mesh.size == 1:
            out[("plain", cache)] = cvae_step(
                ds, a["variables"], idx, a["eps"], None, cache, **kw)
    return out


def case_cgan(mesh, a):
    """One CGAN step through the (z-sharded) stack cache and one on the
    host batch, from the given state."""
    ds = make_dataset(a["root"], a["info"])
    out = {}
    for cache, idx in ((False, a["idx"]), (True, a["idx_cache"])):
        tr = cgan_trainer(ds, a["state"], mesh, cache,
                          batch_size=len(idx), **a.get("config", {}))
        m = (tr.step_indices(idx, a["lr"]) if cache
             else tr.step(ds.get_raw_batch(idx), a["lr"]))
        out[cache] = cgan_result(tr, m)
        out[cache]["uniform_z"] = (tr.device_cache.uniform_z if cache
                                   else None)
    return out


def resume_config(out):
    """tests/test_torch_train_loop.py's resume run (batches of 2 then 4,
    the reactive schedule, validation, a checkpoint every 8 samples)."""
    from baryon_painter_tpu_torch.train import schedules
    from baryon_painter_tpu_torch.train.trainer import TrainConfig
    return TrainConfig(
        learning_rate=1e-3, batch_size=2, n_pepoch=3, pepoch_size=8,
        adaptive_batch_size=lambda p: 2 if p < 1 else 4,
        adaptive_learning_rate=schedules.ReduceLROnPlateau(patience=0),
        var_anneal_fn=lambda p: min(1.0, 0.5 * (p + 1)),
        validation_loss_frequency=8, validation_loss_batch_size=2,
        checkpoint_frequency=8, statistics_report_frequency=4,
        stats_sync_every=4, seed=7, output_path=str(out))


def case_cvae_resume(mesh, a):
    """A data-parallel ``train()`` run, and the same run resumed from its
    first checkpoint (rank 0 copies it and the statistics files into a new
    directory); every rank's final state, and what ``save`` returns on
    each rank."""
    import shutil
    from baryon_painter_tpu_torch.models.cvae import CVAE
    from baryon_painter_tpu_torch.train.trainer import CVAETrainer
    ds = make_dataset(a["root"], a["info"])

    def build(out):
        return CVAETrainer(CVAE(cvae_arch()), ds, test_data=ds,
                           config=resume_config(out), device="cpu",
                           variables=a["variables"], mesh=mesh,
                           device_data=a["cache"])

    full, resumed = a["full"], a["resumed"]
    first = "checkpoint_sample0000000008"
    whole = build(full)
    whole.train()
    if mesh.rank == 0:
        os.makedirs(resumed)
        for f in os.listdir(full):
            if f.startswith(first) or f.endswith(".txt"):
                shutil.copy(os.path.join(full, f), os.path.join(resumed, f))
    mesh.barrier()
    again = build(resumed)
    again.restore(os.path.join(resumed, first))
    progress = dict(again._progress)
    again.train()
    return {"whole": whole.state_tree(), "resumed": again.state_tree(),
            "progress": progress,
            "save_bytes": whole.save(os.path.join(a["extra"], "model"))}


CASES = {"collectives": case_collectives, "batchnorm": case_batchnorm,
         "k4": case_k4, "cvae": case_cvae, "cgan": case_cgan,
         "cvae_resume": case_cvae_resume}


def main(argv):
    case, rank, world, rdv, out, arg_file = argv
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    sys.path.insert(0, REPO)
    from baryon_painter_tpu_torch.parallel.mesh import initialize_multihost
    with open(arg_file, "rb") as f:
        args = pickle.load(f)
    mesh = initialize_multihost(
        "gloo", "file://" + rdv, int(world), int(rank), device="cpu",
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        result = CASES[case](mesh, args)
    finally:
        dist.destroy_process_group()
    with open(os.path.join(out, f"{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


if __name__ == "__main__":
    main(sys.argv[1:])
