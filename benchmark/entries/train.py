"""Training cells: the port's ``CVAETrainer.step_indices`` trains a CVAE of
the configuration's architecture on stacks kept on the card.

The traffic (``train_stacks``, ``harness/traffic.py``) makes the stacks
from its fixed data seed; the workload file names the model's switches
(``fused_heads``, ``fused_train_conv``), its dtype and the trainer's
``device_data``. ``--seed`` draws the initial state (on the card, in one
uniform and one normal draw, from the distributions of
``reference.models.cvae_param_specs``), the sample indices (the first
``check_steps`` batches' rows all distinct) and the latent noise of every
step, which the benchmark passes to ``step_indices`` as ``eps``.

Set-up builds one trainer and drives it through the first
``check_steps`` steps with the window's own call, reading each step's
loss, the first gradient from Adam's first moment after one step (m =
(1 - b1) g) and each parameter's change after the steps; the window then
goes on stepping the same trainer. Once the window has closed and the
trainer is freed, the reference runs the same steps from the same state
(``reference/training.py``, in the workload's ``reference`` precision:
float64, so that the comparison sees the program's f32 rounding and not
the reference's own) and ``compare.train_gaps`` is held to the workload's
limits.
"""
from __future__ import annotations

import gc
import time

import torch

from benchmark.harness import compare, measure, traffic
from benchmark.harness.core import (Cell, Checks, device_kind,
                                    port_dtype)
from benchmark.harness.record import Run
from benchmark.reference import models, training

__all__ = ["TrainSystem", "initial_state", "run"]

MAX_STEPS = 2000


def initial_state(arch: dict, seed: int, device) -> dict:
    """name -> f32 tensor of every CVAE parameter and buffer, drawn on
    ``device`` from (seed, 4): one uniform draw for all U(-b, b) leaves,
    one normal draw for all N(0, s^2) leaves."""
    specs = models.cvae_param_specs(arch)
    size = lambda shape: int(torch.Size(shape).numel())
    n_u = sum(size(s) for _, s, i in specs if i[0] == "uniform")
    n_n = sum(size(s) for _, s, i in specs if i[0] == "normal")
    gen = traffic.cuda_generator(seed, 4, device)
    uni = torch.rand(n_u, generator=gen, device=device)
    nor = torch.randn(n_n, generator=gen, device=device)
    out, iu, jn = {}, 0, 0
    for name, shape, (kind, *arg) in specs:
        k = size(shape)
        if kind == "uniform":
            out[name] = (uni[iu:iu + k] * 2 - 1).mul_(arg[0]).reshape(shape)
            iu += k
        elif kind == "normal":
            out[name] = (nor[jn:jn + k] * arg[0]).reshape(shape)
            jn += k
        else:
            out[name] = torch.full(shape, float(arg[0]), device=device)
    return out


class TrainSystem:
    """The trainer under test with its data, state and inputs."""

    def __init__(self, cell: Cell, seed: int, device, data: dict = None):
        """``data``: the traffic's stacks when the caller made them
        already (``traffic.train_stacks``)."""
        from baryon_painter_tpu_torch.data.dataset import BahamasTileDataset
        from baryon_painter_tpu_torch.models.cvae import CVAE
        from baryon_painter_tpu_torch.train.trainer import (CVAETrainer,
                                                            TrainConfig)
        from baryon_painter_tpu_torch.transforms import transform_from_dict
        wl, tr, cfg = cell.workload, cell.traffic, cell.config
        self.device, self.tr, self.cfg = device, tr, cfg
        self.dtype = wl["dtype"]
        self.reference_numerics = wl["reference"]
        arch = cfg["architecture"]
        self.data = data or traffic.train_stacks(tr, device)
        transforms = {f: transform_from_dict(d)
                      for f, d in cfg["transforms"].items()}
        ds = BahamasTileDataset(
            data=self.data, redshifts=tr["redshifts"],
            label_fields=["pressure"], n_tile=tr["n_tile"],
            n_stack=tr["n_stack"], transforms=transforms,
            tile_permutations=True, scale_to_SLICS=True)
        model = CVAE(arch, dtype=port_dtype(self.dtype),
                     **wl.get("model_kwargs", {}))
        self.trainer = CVAETrainer(
            model, ds, config=TrainConfig(seed=seed % 2 ** 63,
                                          learning_rate=tr["lr"],
                                          batch_size=tr["batch"]),
            device_data=wl["device_data"], device=device)
        self.init = initial_state(arch, seed, device)
        self._load(self.trainer.model, self.init)
        ids = {id(p): n for n, p in self.trainer.model.named_parameters()}
        self.names = [ids[id(p)] for p in self.trainer.params]
        self.idx = traffic.sample_batches(len(ds), tr["batch"], seed,
                                          tr["check_steps"], MAX_STEPS)
        f = arch["dim_y"][1] // arch["dim_z"][1]
        h = tr["tile"] // f
        gen = traffic.cuda_generator(seed, 5, device)
        self.eps = torch.randn((MAX_STEPS, tr["batch"], arch["dim_z"][0],
                                h, h), generator=gen, device=device)

    @staticmethod
    @torch.no_grad()
    def _load(model, state: dict):
        tensors = dict(model.named_parameters())
        tensors.update(model.named_buffers())
        if set(tensors) != set(state):
            raise ValueError(f"the model's tensors and the benchmark's "
                             f"state differ: "
                             f"{sorted(set(tensors) ^ set(state))[:6]}")
        for name, t in tensors.items():
            if tuple(t.shape) != tuple(state[name].shape):
                raise ValueError(f"{name}: {tuple(t.shape)} against "
                                 f"{tuple(state[name].shape)}")
            t.copy_(state[name])

    def issue(self, i: int) -> int:
        self.last = self.trainer.step_indices(self.idx[i], self.tr["lr"],
                                              eps=self.eps[i])
        return self.tr["batch"]

    def first_steps(self) -> dict:
        """The first ``check_steps`` steps, read as the reference reads
        its own (``reference.training.steps``)."""
        opt = self.trainer.optimizer
        out = {"loss": [], "grad": None}
        for i in range(self.tr["check_steps"]):
            self.issue(i)
            out["loss"].append(-self.last["elbo"].detach().clone())
            if i == 0:
                out["grad"] = {n: (m / (1 - opt.b1)).norm()
                               for n, m in zip(self.names, opt.mu)}
        out["change"] = {n: (p.detach() - self.init[n]).norm()
                         for n, p in zip(self.names, self.trainer.params)}
        return {"loss": [float(x) for x in out["loss"]],
                "grad": {n: float(v) for n, v in out["grad"].items()},
                "change": {n: float(v) for n, v in out["change"].items()}}

    def free_program(self):
        self.trainer = self.last = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, numerics: str = None) -> dict:
        """The reference's first steps, in ``numerics`` (by default the
        workload's ``reference`` precision)."""
        k = self.tr["check_steps"]
        numerics = numerics or self.reference_numerics
        return training.steps(self.cfg, self.data, self.tr, self.init,
                              self.idx[:k], self.eps[:k], self.device,
                              numerics)


def run(cell: Cell) -> dict:
    device = torch.device(cell.device)
    tr = cell.traffic
    system = TrainSystem(cell, cell.seed, device)
    got = system.first_steps()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - cell.t_start
    traced_s = tr["traced_seconds"] if cell.trace else 0.0
    first = tr["check_steps"]
    loop = lambda start, seconds: measure.closed_loop(
        system.issue, start, seconds, tr["in_flight"], device)
    window = loop(first, max(cell.seconds - traced_s, 1e-3))
    trace = None
    if cell.trace:
        trace = measure.traced(lambda: loop(first + window.calls, traced_s))
    steps = window.calls + (trace.calls if trace else 0)
    if first + steps > MAX_STEPS:
        raise RuntimeError(f"{first + steps} steps outran the {MAX_STEPS} "
                           f"batches drawn")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    system.free_program()
    gaps = compare.train_gaps(got, system.reference())
    checks = Checks(cell.workload["checks"])
    for name, value in gaps.items():
        checks.add(name, value)
    return {"end_to_end": {
                "train_samples_per_s": window.units / window.seconds,
                "train_step_p95_ms": measure.percentile(window.call_ms, 95),
                "setup_s": setup_s},
            "run": (Run(cell, device_kind(device), system.dtype, window, trace,
                        tr["batch"]) if trace else None),
            "attempted": steps, "failed": 0 if checks.correct else 1,
            "checks": checks, "memory_peak_bytes": peak}
