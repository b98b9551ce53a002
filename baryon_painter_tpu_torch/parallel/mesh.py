"""Device meshes: several devices driven by one process, or one process a
device.

Port of ``baryon_painter_tpu/parallel/mesh.py``. JAX gets both kinds of
parallelism from one global-view ``Mesh``; the port has two objects:

* ``DeviceMesh`` -- one process driving a list of devices, for painting
  (``lightcone/pipeline.py``: a tile batch split over the devices;
  ``parallel/spatial.py``: a plane split into halo-extended row slabs).
  ``data_parallel_mesh`` builds one; devices may repeat (``["cpu"] * 4``,
  ``["cuda:0"] * 2``), so the split, halo and merge logic runs on one card
  or on the CPU. ``replicate`` places one copy of a painter on each
  distinct device.
* ``ProcessMesh`` -- one process a device over ``torch.distributed``, for
  training (``train/trainer.py``, ``train/cgan.py``). One Python thread
  launching every kernel of a step for several cards would hold them back,
  so each card gets its own process, as in PyTorch's own data parallelism.
  ``initialize_multihost`` starts the process group from explicit
  coordinates or torchrun's environment. The backend is always the
  caller's: NCCL between cards, gloo on the CPU (gloo also carries
  ``all_reduce`` and ``broadcast`` of CUDA tensors, which lets two ranks
  share one card).

Inside ``with mesh.active():`` the train-mode layers take their batch
statistics over the global batch: ``models/layers.BatchNorm`` and K4's
``ops/conv_bn.conv_bn_relu`` all-reduce their per-channel sums, so a
step on n ranks computes what the step on the concatenated batch computes
(the JAX trainer's jit is global-view). Every rank holds an equal share of
the batch; the trainers raise otherwise.

    mesh = initialize_multihost("nccl")          # under torchrun
    trainer = CVAETrainer(model, dataset, mesh=mesh, device_data=True)
"""
from __future__ import annotations

import contextlib
import datetime
import os
from typing import List, Optional, Sequence

import torch
import torch.distributed as dist
from torch import nn

__all__ = ["DeviceMesh", "ProcessMesh", "data_parallel_mesh", "replicate",
           "initialize_multihost", "active_mesh", "DEFAULT_TIMEOUT"]

# how long a collective may wait for the other ranks before it raises
DEFAULT_TIMEOUT = datetime.timedelta(minutes=10)


def _device(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        d = torch.device("cuda", 0)
    return d


# --------------------------------------------------------------------- #
# one process, several devices (painting)

class DeviceMesh:
    """A list of devices one process paints on, in order; devices may
    repeat. The shards' results are gathered on the painter's own
    device."""

    def __init__(self, devices: Sequence):
        self.devices: List[torch.device] = [_device(d) for d in devices]
        if not self.devices:
            raise ValueError("a DeviceMesh needs at least one device")
        self._replicas = []  # (object, {device: copy}) pairs, see replicate

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> List[torch.device]:
        out = []
        for d in self.devices:
            if d not in out:
                out.append(d)
        return out

    def split(self, n: int) -> list:
        """(lo, hi) row ranges of ``n`` rows over the devices, in order,
        as equal as they can be (the first ``n % size`` get one more)."""
        per, extra = divmod(n, self.size)
        out, lo = [], 0
        for j in range(self.size):
            hi = lo + per + (j < extra)
            out.append((lo, hi))
            lo = hi
        return out

    def __repr__(self):
        return f"DeviceMesh({[str(d) for d in self.devices]})"


def data_parallel_mesh(n_devices: Optional[int] = None,
                       devices: Optional[Sequence] = None) -> DeviceMesh:
    """A ``DeviceMesh`` over ``devices``, or over the first ``n_devices``
    cards (all of them by default). Asking for more cards than there are
    raises: a mesh never reuses a card it was not given."""
    if devices is None:
        count = torch.cuda.device_count()
        n = count if n_devices is None else int(n_devices)
        if n < 1 or count < n:
            raise RuntimeError(f"a mesh of {n} cards needs {n} CUDA devices; "
                               f"torch.cuda.device_count() is {count}")
        devices = [f"cuda:{i}" for i in range(n)]
    else:
        devices = list(devices)
        if n_devices is not None:
            if n_devices > len(devices):
                raise ValueError(f"n_devices {n_devices} exceeds the "
                                 f"{len(devices)} devices given")
            devices = devices[:n_devices]
    return DeviceMesh(devices)


def replicate(painter, mesh: DeviceMesh) -> dict:
    """One copy of ``painter`` on each distinct device of ``mesh``
    (``painter.replica(device)``): ``{device: copy}``, with ``painter``
    itself on its own device. The copies are made once per mesh and
    painter and kept on the mesh."""
    for held, copies in mesh._replicas:
        if held is painter:
            return copies
    home = _device(painter.device)
    copies = {d: painter if d == home else painter.replica(d)
              for d in mesh.distinct}
    mesh._replicas.append((painter, copies))
    return copies


# --------------------------------------------------------------------- #
# one process a device (training)

_ACTIVE: list = []


def active_mesh() -> Optional["ProcessMesh"]:
    """The ``ProcessMesh`` whose ``active()`` block the caller is in, or
    None: the train-mode layers read it to take global batch statistics."""
    return _ACTIVE[-1] if _ACTIVE else None


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks, differentiable: every rank's output is the same
    sum, so the gradient reaching each rank's input is the sum of the
    gradients of every rank's output."""

    @staticmethod
    def forward(ctx, t, mesh):
        ctx.mesh = mesh
        return mesh.all_reduce(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce(g), None


class ProcessMesh:
    """This process's place in a data-parallel group: the group, its rank
    and size, the backend (named by the caller, never chosen here) and the
    device this rank computes on.

    The trainers split each global batch of B rows into equal blocks, rank r
    taking rows ``rows(B)``; collectives are issued by every rank in the
    same order. ``torch.distributed`` must be initialised
    (``initialize_multihost``, or ``init_process_group`` by the caller)."""

    def __init__(self, backend: str, device, group=None):
        if not dist.is_available() or not dist.is_initialized():
            raise RuntimeError("ProcessMesh needs an initialised "
                               "torch.distributed process group "
                               "(initialize_multihost)")
        got = dist.get_backend(group)
        if str(got).lower() != str(backend).lower():
            raise ValueError(f"the process group's backend is {got!r}, "
                             f"not {backend!r}")
        self.backend = str(backend).lower()
        self.group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)
        self.device = _device(device)
        if self.backend == "nccl":
            if self.device.type != "cuda":
                raise ValueError("the NCCL backend needs a CUDA device, got "
                                 f"{self.device}")
            # NCCL's collectives run on the current device
            torch.cuda.set_device(self.device)

    def __repr__(self):
        return (f"ProcessMesh(backend={self.backend!r}, rank={self.rank}, "
                f"size={self.size}, device={self.device})")

    def rows(self, n: int) -> tuple:
        """(lo, hi): this rank's block of a global batch of ``n`` rows."""
        if n % self.size:
            raise ValueError(f"batch {n} is not divisible by the "
                             f"{self.size}-rank mesh")
        per = n // self.size
        return self.rank * per, (self.rank + 1) * per

    @contextlib.contextmanager
    def active(self):
        """Batch statistics over the global batch inside this block."""
        _ACTIVE.append(self)
        try:
            yield self
        finally:
            _ACTIVE.pop()

    # -- collectives ---------------------------------------------------- #

    def all_reduce(self, t, op: str = "sum"):
        """A new tensor: ``t`` reduced over the ranks (``sum``, ``min`` or
        ``max``); no gradient."""
        ops = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
               "max": dist.ReduceOp.MAX}
        out = t.detach().clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=ops[op], group=self.group)
        return out

    def sum(self, t):
        """Differentiable sum of ``t`` over the ranks."""
        return _AllReduceSum.apply(t, self)

    def mean(self, t):
        """Differentiable mean over the ranks of per-rank means of equal
        shares: the mean over the global batch. On one rank, ``t``'s
        values."""
        return self.sum(t * (1.0 / self.size))

    def all_reduce_flat_(self, tensors: Sequence[torch.Tensor]):
        """Sum every tensor of ``tensors`` over the ranks in place, as one
        collective over one flat buffer in the first tensor's dtype."""
        if not tensors:
            return
        flat = torch.cat([t.reshape(-1).to(tensors[0].dtype)
                          for t in tensors])
        dist.all_reduce(flat, group=self.group)
        pos = 0
        for t in tensors:
            n = t.numel()
            t.copy_(flat[pos:pos + n].view_as(t))
            pos += n

    @torch.no_grad()
    def broadcast_(self, tensors: Sequence[torch.Tensor], src: int = 0):
        """Overwrite ``tensors`` with rank ``src``'s values, in place."""
        for t in tensors:
            buf = t.detach().contiguous()
            dist.broadcast(buf, src=src, group=self.group)
            if buf.data_ptr() != t.data_ptr():
                t.copy_(buf)

    def broadcast_module_(self, module: nn.Module, src: int = 0):
        """Every parameter and buffer of ``module`` set to rank ``src``'s."""
        self.broadcast_(list(module.parameters()) + list(module.buffers()),
                        src=src)

    def barrier(self):
        """Wait for every rank (a small all-reduce on this rank's device,
        so that it works on every backend and device)."""
        self.all_reduce(torch.zeros(1, device=self.device))


def _env_coordinates():
    env = os.environ
    keys = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")
    if all(k in env for k in keys):
        return int(env["RANK"]), int(env["WORLD_SIZE"])
    return None


def initialize_multihost(backend: str,
                         coordinator_address: Optional[str] = None,
                         num_processes: Optional[int] = None,
                         process_id: Optional[int] = None, device=None,
                         timeout: datetime.timedelta = DEFAULT_TIMEOUT
                         ) -> Optional[ProcessMesh]:
    """Join (or start) the process group and return this process's
    ``ProcessMesh``; the counterpart of the JAX package's
    ``jax.distributed.initialize`` wrapper.

    ``backend``: ``"nccl"`` (cards) or ``"gloo"`` (CPU, or CUDA tensors
    staged by gloo), always given. ``coordinator_address``: an init method
    (``tcp://host:port``, ``file:///path``; a bare ``host:port`` means
    tcp), with ``num_processes`` and ``process_id``. Without it the
    coordinates come from torchrun's environment (``MASTER_ADDR``,
    ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``). ``device``: this rank's
    device; by default ``cuda:LOCAL_RANK`` whatever the backend, and
    without a card that raises: a rank computes on the CPU only when the
    caller passes ``device="cpu"``.

    Returns the mesh of an already initialised group unchanged; returns
    None for a plain single-process run (no arguments, no torchrun
    environment). Explicit arguments that fail raise, as a rendezvous that
    does not complete within ``timeout`` does: nothing falls back to a
    single process."""
    if dist.is_initialized():
        return ProcessMesh(backend, device or _default_device())
    explicit = any(a is not None for a in
                   (coordinator_address, num_processes, process_id))
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and "
                             "process_id")
        init = (coordinator_address if "://" in coordinator_address
                else f"tcp://{coordinator_address}")
        rank, world = int(process_id), int(num_processes)
    elif explicit:
        raise ValueError("num_processes / process_id need a "
                         "coordinator_address (or torchrun's environment)")
    else:
        coords = _env_coordinates()
        if coords is None:
            return None
        init = "env://"
        rank, world = coords
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} outside [0, {world})")
    device = device or _default_device()
    dist.init_process_group(backend=backend, init_method=init,
                            world_size=world, rank=rank, timeout=timeout)
    return ProcessMesh(backend, device)


def _default_device() -> torch.device:
    """``cuda:LOCAL_RANK``; raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device for this rank: pass device='cpu' "
                           "to compute on the CPU")
    return torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
