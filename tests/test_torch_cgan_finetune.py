"""The port's CGAN spectral fine-tune from a restored checkpoint against the
JAX package's ``CGANTrainer`` on the CPU: the gate's CGAN training leg
(``scripts/fidelity_check.py --model cgan --resume --pk-loss-weight 1e4``:
lr 5e-5 without the pepoch decay, the spectral term per redshift, the
adversarial and perceptual weights at their defaults), with and without
``--reinit-d 7``.

Both trainers restore the committed ``trained_models/CGAN/fiducial-adv``
(the full-width generator, 9 residual blocks, and the discriminator, their
batch-norm and spectral-norm state and both Adams with their moments and
count) through their own ``restore``. With ``reinit_d7`` the JAX trainer's
``reinit_discriminator(7)`` draws a fresh D (flax's initialiser, which torch
cannot reproduce): the port calls its own ``reinit_discriminator`` and then
takes JAX's fresh D parameters and state through ``convert``; its fresh Adam
must equal JAX's. Each trainer takes two steps on the same sample indices
(64^2 tiles, batch 2). The second starts from the state the JAX step wrote,
its Adam moments and count included, loaded into a port trainer through its
``state=``: each step is compared from one state. Beside each runs the
port's f64 step from the same state (both networks in f64), the arbiter of
what f32 rounding moves. The port's convolutions run PyTorch's own CPU
code, not oneDNN's, whose f32 sums put a residual block's gradient 3.1e-3
of its largest entry from the f64 step here.

Held, after each step:

- the restored state equal to JAX's, bit for bit, and Adam's count equal;
- the metrics (D_real and D_fake in their logarithm) and each gradient leaf
  that Adam was given (to its own largest entry; a bias ahead of a
  train-mode batch norm, whose gradient is 0 analytically
  (``zero_gradient_leaves``), to the network's largest): the port within
  max(tol, F64_FACTOR x JAX's f32 distance from the f64 step) of JAX and of
  the f64 step, tol 1e-5 for the metrics and 1e-4 for the gradients, and
  JAX's f32 step within METRIC_CAP / GRAD_CAP of the f64 step, which holds
  the arbiter to JAX's function. The spectral term at weight 1e4 puts the
  JAX package's own f32 generator gradient up to 3.4e-4 of a leaf's largest
  entry, and its gradient norm 2.1e-5, from the f64 step at the first step;
- each leaf's Adam moments to 1e-5 of their largest entry, and its update
  (new minus restored) to 1e-4 of its largest entry, against optax's Adam
  applied to the port's gradient from the moments and count the port held
  before the step (JAX's arithmetic on the gradient held above). Adam
  divides each entry by its own moments, so an f32 gradient error that is
  1e-4 of a leaf's largest entry can move an entry's update by all of it
  (a fresh D's first update is lr times the gradient's sign);
- the new batch-norm and spectral-norm state to 1e-5 of each leaf's largest
  entry, against JAX's.
"""
import contextlib
import json
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from baryon_painter_tpu.data.dataset import BahamasTileDataset as JaxDataset
from baryon_painter_tpu.data.dataset import load_file_info
from baryon_painter_tpu.models.cgan import CGANDiscriminator as JaxD
from baryon_painter_tpu.models.cgan import CGANGenerator as JaxG
from baryon_painter_tpu.train import cgan as jcgan
from baryon_painter_tpu.transforms import \
    transform_from_dict as jax_transform
from baryon_painter_tpu_torch.convert import (load_jax_variables,
                                              to_jax_variables)
from baryon_painter_tpu_torch.data.dataset import BahamasTileDataset
from baryon_painter_tpu_torch.data.synthetic import make_synthetic_stacks
from baryon_painter_tpu_torch.models.cgan import (CGANDiscriminator,
                                                  CGANGenerator)
from baryon_painter_tpu_torch.train.cgan import (CGANTrainConfig,
                                                 CGANTrainer,
                                                 zero_gradient_leaves)
from baryon_painter_tpu_torch.transforms import transform_from_dict
from golden_utils import REPO

BASE = os.path.join(REPO, "trained_models", "CGAN", "fiducial-adv", "model")
# the gate leg's configuration (scripts/fidelity_check.py:346-349, 707-713)
TILE, BATCH, LR, PK_WEIGHT, N_RES_BLOCKS = 64, 2, 5e-5, 1e4, 9
CONFIG = dict(seed=0, batch_size=BATCH, pk_loss_weight=PK_WEIGHT,
              pk_loss_per_z=True)
REDSHIFTS = (0.0, 0.5, 1.0)
STEPS = 2
METRIC_RTOL, GRAD_TOL, UPDATE_TOL, ADAM_TOL, STATS_TOL = (1e-5, 1e-4, 1e-4,
                                                          1e-5, 1e-5)
# JAX's f32 step against the port's f64 step: the metrics relative, the
# gradients to a leaf's largest entry (chip_smoke.py's f32-against-f64 rule
# for a training step's gradients, smoke.STEP_GRAD_TOL)
METRIC_CAP, GRAD_CAP = 1e-4, 1e-3
F64_FACTOR = 1.5
CASES = {"resume": None, "reinit_d7": 7}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread a process: the suite's other workers load every
    core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _np(tree):
    return jax.tree.map(np.asarray, tree)


class _Recorder:
    """The JAX trainer's optimizer, recording the gradients of each
    ``update`` (D's first, then G's) from inside the jitted step."""

    def __init__(self, opt):
        self.opt, self.grads = opt, []

    def init(self, params):
        return self.opt.init(params)

    def update(self, grads, state, params):
        jax.debug.callback(lambda g: self.grads.append(_np(g)), grads)
        return self.opt.update(grads, state, params)


def _jax_state(jt) -> dict:
    """The JAX trainer's state as numpy: both networks' params and stats
    and their Adam states in the checkpoint's layout."""
    s = jt.state
    out = {k: _np(getattr(s, k))
           for k in ("g_params", "g_stats", "d_params", "d_stats")}
    for net in "gd":
        out[f"{net}_opt"] = _np(flax.serialization.to_state_dict(
            getattr(s, f"{net}_opt")))
    return out


def _port_state(tr) -> dict:
    tree = tr.state_tree()
    return {k: tree[k] for k in ("g_params", "g_stats", "d_params",
                                 "d_stats", "g_opt", "d_opt")}


@contextlib.contextmanager
def _native_convolutions():
    """PyTorch's own CPU convolutions for the block (oneDNN off)."""
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        yield
    finally:
        torch.backends.mkldnn.enabled = prev


def _zeros_init(init):
    """A flax ``init`` that returns zeros of the variables' shapes."""
    def zeros(self, *args, **kw):
        shapes = jax.eval_shape(lambda *a: init(self, *a, **kw), *args)
        return jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), shapes)
    return zeros


def _jax_tree(jt) -> dict:
    """The JAX trainer's state as a checkpoint tree, its step included (a
    port trainer's ``state=``)."""
    return {**_jax_state(jt), "step": np.asarray(jt.state.step)}


def _port_trainer(td, dtype=None, state=None):
    """A port trainer at fiducial-adv's width on the CPU; ``dtype`` builds
    both networks in it first (f64: the arbiter)."""
    g = CGANGenerator(n_res_blocks=N_RES_BLOCKS, spectral_norm=True)
    d = CGANDiscriminator()
    if dtype is not None:
        g, d = g.to(dtype), d.to(dtype)
    return CGANTrainer(td, generator=g, discriminator=d,
                       config=CGANTrainConfig(**CONFIG), device_data=True,
                       device="cpu", state=state)


def _grads(tr) -> dict:
    return {net: _flat(to_jax_variables(m, grads=True)["params"])
            for net, m in (("g", tr.generator), ("d", tr.discriminator))}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both trainers restored from fiducial-adv (and, per case, D
    re-initialised), then two steps, each from the JAX trainer's state
    before it (the port's own restored state for the first), beside the
    port's f64 step from the same state: {case: record}."""
    root = str(tmp_path_factory.mktemp("stacks"))
    info = make_synthetic_stacks(root, n_stack=2, n_grid=2 * TILE,
                                 redshifts=REDSHIFTS, seed=0,
                                 pressure_noise=0.1)
    with open(BASE + "_meta.json") as f:
        meta = json.load(f)
    kw = dict(files=load_file_info(info), root_path=root, n_tile=2,
              tile_permutations=True)
    jd = JaxDataset(**kw, transforms={k: jax_transform(d) for k, d in
                                      meta["transforms"].items()})
    td = BahamasTileDataset(**kw, transforms={
        k: transform_from_dict(d) for k, d in meta["transforms"].items()})
    with pytest.MonkeyPatch.context() as mp:
        # the restore replaces every initial value: build them as zeros of
        # their shapes, without compiling the networks' init
        for cls in (JaxG, JaxD):
            mp.setattr(cls, "init", _zeros_init(cls.init))
        jt = jcgan.CGANTrainer(jd,
                               generator=JaxG(n_res_blocks=N_RES_BLOCKS),
                               discriminator=JaxD(),
                               config=jcgan.CGANTrainConfig(**CONFIG),
                               device_data=True)
    jt.optimizer = _Recorder(jt.optimizer)
    idx = [jd.sample_indices(np.random.default_rng(10 + i), BATCH)
           for i in range(STEPS)]
    out = {}
    with _native_convolutions():
        for case, reinit in CASES.items():
            jt.restore(BASE)
            if reinit is not None:
                jt.reinit_discriminator(reinit)
            tr = _port_trainer(td)
            tr.restore(BASE)
            if reinit is not None:
                tr.reinit_discriminator(reinit)
                fresh = _jax_state(jt)
                load_jax_variables(tr.discriminator,
                                   {"params": fresh["d_params"],
                                    "batch_stats": fresh["d_stats"]})
            rec = {"start": _jax_state(jt), "port_start": _port_state(tr),
                   "steps": []}
            for i in range(STEPS):
                before = _jax_tree(jt)
                if i > 0:
                    # the second step from the state the JAX step wrote,
                    # its Adam moments and count included
                    tr = _port_trainer(td, state=before)
                f64 = _port_trainer(td, torch.float64, state=before)
                port_before = _port_state(tr)
                jt.optimizer.grads = []
                jm = _np(jt.step_indices(idx[i], lr=LR))
                grads = jt.optimizer.grads
                pm = tr.step_indices(idx[i], LR)
                m64 = f64.step_indices(idx[i], LR)
                rec["steps"].append({
                    "port_before": port_before,
                    "jax_metrics": {k: float(v) for k, v in jm.items()},
                    "port_metrics": {k: float(v) for k, v in pm.items()},
                    "f64_metrics": {k: float(v) for k, v in m64.items()},
                    "jax": _jax_state(jt), "port": _port_state(tr),
                    "jax_grads": {net: _flat(g) for net, g in
                                  zip("dg", grads)},
                    "port_grads": _grads(tr), "f64_grads": _grads(f64)})
            rec["zero"] = set(zero_gradient_leaves(tr.generator))
            out[case] = rec
    return out


STEP_CASES = [(c, i) for c in CASES for i in range(STEPS)]


def _ids(p):
    return f"{p[0]}-step{p[1] + 1}"


def _arbitrated(port_jax, jax_f64, port_f64, tol, cap):
    """The rule for what f32 rounding moves (module docstring), on three
    distances: port-JAX and port-f64 within max(tol, F64_FACTOR x
    JAX-f64), and JAX-f64 within cap. Returns the failed parts."""
    limit = max(tol, F64_FACTOR * jax_f64)
    return [name for name, got, lim in (("port-jax", port_jax, limit),
                                        ("port-f64", port_f64, limit),
                                        ("jax-f64", jax_f64, cap))
            if not got <= lim]


def test_restored_state_is_jax_state(runs):
    """Before any step: both trainers hold the same restored (or, for D,
    fresh) state, Adam's count included."""
    for case, rec in runs.items():
        want, got = rec["start"], rec["port_start"]
        for key in want:
            w, g = _flat(want[key]), _flat(got[key])
            assert set(w) == set(g), (case, key)
            for leaf, a in w.items():
                assert np.array_equal(g[leaf], a), (case, key, leaf)
        if CASES[case] is not None:
            opt = _flat(want["d_opt"])
            assert int(opt["0/count"]) == 0
            assert all(np.all(v == 0) for k, v in opt.items())


def _metric(key, v):
    # a mean probability in its logarithm: a saturated D carries its
    # logits' absolute f32 error as the probability's relative error
    return np.log(v) if key in ("D_real", "D_fake") else v


@pytest.mark.parametrize("case_step", STEP_CASES, ids=_ids)
def test_finetune_metrics_against_jax(runs, case_step):
    case, i = case_step
    step = runs[case]["steps"][i]
    jm, pm, rm = (step[k] for k in ("jax_metrics", "port_metrics",
                                    "f64_metrics"))
    assert set(jm) == set(pm) == set(rm)
    for key in jm:
        j, p, r = (_metric(key, m[key]) for m in (jm, pm, rm))
        scale = abs(r)
        failed = _arbitrated(abs(p - j) / scale, abs(j - r) / scale,
                             abs(p - r) / scale, METRIC_RTOL, METRIC_CAP)
        assert not failed, (case, i, key, failed, p, j, r)


@pytest.mark.parametrize("case_step", STEP_CASES, ids=_ids)
def test_finetune_gradients_against_jax(runs, case_step):
    """Each gradient leaf that Adam was given, to its own largest entry (a
    bias ahead of a train-mode batch norm: to the network's largest)."""
    case, i = case_step
    rec = runs[case]
    step = rec["steps"][i]
    for net in "gd":
        zero = rec["zero"] if net == "g" else set()
        want, got, ref = (step[k][net] for k in ("jax_grads", "port_grads",
                                                 "f64_grads"))
        assert set(got) == set(want) == set(ref)
        top = max(np.abs(v).max() for v in ref.values())
        for key, r in ref.items():
            scale = top if key in zero else np.abs(r).max()
            d = lambda a, b: np.abs(a - b).max() / scale
            failed = _arbitrated(d(got[key], want[key]), d(want[key], r),
                                 d(got[key], r), GRAD_TOL, GRAD_CAP)
            assert not failed, (case, i, net, key, failed)


def _adam(grads, opt):
    """optax's Adam (the JAX trainer's: b1 0.5, b2 0.999) from the flat
    state ``opt`` ({"0/count", "0/mu/...", "0/nu/..."}) on the flat
    gradients: (new flat state, direction)."""
    tx = optax.scale_by_adam(b1=0.5, b2=0.999)
    part = lambda prefix: {k[len(prefix):]: v for k, v in opt.items()
                           if k.startswith(prefix)}
    state = optax.ScaleByAdamState(count=opt["0/count"], mu=part("0/mu/"),
                                   nu=part("0/nu/"))
    upd, new = tx.update(grads, state)
    flat = {"0/count": np.asarray(new.count)}
    flat.update({f"0/mu/{k}": np.asarray(v) for k, v in new.mu.items()})
    flat.update({f"0/nu/{k}": np.asarray(v) for k, v in new.nu.items()})
    return flat, {k: -np.asarray(v) for k, v in upd.items()}


@pytest.mark.parametrize("case_step", STEP_CASES, ids=_ids)
def test_finetune_adam_against_optax(runs, case_step):
    """Adam's count equal to JAX's, and each leaf's moments and update
    (new minus restored) equal to what optax's Adam makes of the port's
    gradient from the moments and count the port held before the step."""
    case, i = case_step
    step = runs[case]["steps"][i]
    for net in "gd":
        got_o = _flat(step["port"][f"{net}_opt"])
        want_o = _flat(step["jax"][f"{net}_opt"])
        assert set(got_o) == set(want_o)
        assert int(got_o["0/count"]) == int(want_o["0/count"]), (case, net)
        before_p = _flat(step["port_before"][f"{net}_params"])
        start = _flat(runs[case]["start"][f"{net}_params"])
        got_p = _flat(step["port"][f"{net}_params"])
        ref_o, ref_d = _adam(step["port_grads"][net],
                             _flat(step["port_before"][f"{net}_opt"]))
        assert int(ref_o["0/count"]) == int(got_o["0/count"])
        for key in got_p:
            ref_u = before_p[key] + np.float32(LR) * ref_d[key] - start[key]
            err = np.abs(got_p[key] - start[key] - ref_u).max()
            assert err <= UPDATE_TOL * np.abs(ref_u).max(), (
                case, i, net, "update", key, err / np.abs(ref_u).max())
            for m in ("mu", "nu"):
                k = f"0/{m}/{key}"
                err = np.abs(got_o[k] - ref_o[k]).max()
                assert err <= ADAM_TOL * max(np.abs(ref_o[k]).max(),
                                             1e-38), (
                    case, i, net, m, key, err / np.abs(ref_o[k]).max())


@pytest.mark.parametrize("case_step", STEP_CASES, ids=_ids)
def test_finetune_state_against_jax(runs, case_step):
    """The new batch-norm and spectral-norm state of both networks."""
    case, i = case_step
    step = runs[case]["steps"][i]
    for net in "gd":
        want = _flat(step["jax"][f"{net}_stats"])
        got = _flat(step["port"][f"{net}_stats"])
        assert set(got) == set(want), (case, net)
        for key, w in want.items():
            err = np.abs(got[key] - w).max()
            assert err <= STATS_TOL * max(np.abs(w).max(), 1e-30), (
                case, i, net, key, err)
