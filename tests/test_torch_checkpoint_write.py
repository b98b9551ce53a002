"""The port's checkpoint writing against flax and the JAX package, both ways.

The machine with the card has neither msgpack nor flax, so the port writes
flax's msgpack format with its own encoder
(baryon_painter_tpu_torch/train/msgpack_writer.py). Its bytes must be
flax.serialization.msgpack_serialize's, exactly, for generated trees of
every leaf the reader accepts and for the state tree of every committed
checkpoint. The metadata must be the JAX package's key for key.

Checkpoints cross both ways, from one real training run of each trainer at
32^2 (a module fixture each): the JAX trainer restores the port's
checkpoint to the same state (exactly, after the layout conversion; it
re-saves the same bytes) and the JAX painter paints it as the port's
painter does, with the same injected latent noise, at the golden tolerance
(rtol 5e-3, atol 5e-3 of the largest value); the port restores the JAX
trainer's checkpoint and the committed fiducial-512 one, Adam state
included, exactly (re-saving the same bytes), and one further step from
the JAX checkpoint agrees with the JAX trainer's step, metrics and Adam's
updated moments, at tests/test_torch_trainer.py's tolerance (rtol 1e-3,
atol 1e-4 of the largest entry).
"""
import glob
import json
import os

import flax.serialization
import hypothesis.extra.numpy as hnp
import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from baryon_painter_tpu import painter as jpainter
from baryon_painter_tpu import transforms as jtransforms
from baryon_painter_tpu.data.dataset import BahamasTileDataset as JaxDataset
from baryon_painter_tpu.data.dataset import load_file_info
from baryon_painter_tpu.models import cvae as jcvae
from baryon_painter_tpu.train import checkpoint as jckpt
from baryon_painter_tpu.train import schedules as jsched
from baryon_painter_tpu.train import trainer as jtrainer
from baryon_painter_tpu_torch import painter as tpainter
from baryon_painter_tpu_torch import transforms as ttransforms
from baryon_painter_tpu_torch.convert import to_jax_variables
from baryon_painter_tpu_torch.data.dataset import BahamasTileDataset
from baryon_painter_tpu_torch.data.synthetic import make_synthetic_stacks
from baryon_painter_tpu_torch.models.cvae import (CVAE,
                                                  fiducial_cvae_architecture)
from baryon_painter_tpu_torch.train import checkpoint as ckpt
from baryon_painter_tpu_torch.train import schedules as tsched
from baryon_painter_tpu_torch.train import trainer as ttrainer
from baryon_painter_tpu_torch.train.msgpack_reader import msgpack_restore
from baryon_painter_tpu_torch.train.msgpack_writer import msgpack_serialize
from golden_utils import REPO

TILE, BATCH = 32, 2
STATE_FILES = sorted(
    os.path.relpath(p, REPO) for p in glob.glob(
        os.path.join(REPO, "trained_models", "**", "*_state.msgpack"),
        recursive=True))


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread a process: the port's small CPU steps slow down
    many times over in PyTorch's thread pool when the suite's other
    workers load every core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
            if not v:
                out[prefix + k] = "{}"
        else:
            out[prefix + k] = v
    return out


def _assert_trees_equal(got, want):
    """The same keys, and every leaf the same dtype, shape and bits."""
    got, want = _flat(got), _flat(want)
    assert sorted(got) == sorted(want)
    for k in want:
        if isinstance(want[k], str):
            assert got[k] == want[k], k
            continue
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


# --------------------------------------------------------------------- #
# the writer against flax

_DTYPES = ["bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
           "uint32", "uint64", "float16", "float32", "float64",
           "complex64", "complex128"]
_KEYS = st.text(min_size=0, max_size=40)
_ARRAYS = st.sampled_from(_DTYPES).flatmap(
    lambda d: hnp.arrays(np.dtype(d), hnp.array_shapes(
        min_dims=0, max_dims=3, min_side=0, max_side=6)))
_SCALARS = (st.integers(min_value=-2 ** 63, max_value=2 ** 64 - 1)
            | st.floats(allow_nan=False) | st.booleans() | st.none()
            | st.text(max_size=300) | st.binary(max_size=300))
_TREES = st.recursive(
    _ARRAYS | _SCALARS,
    lambda inner: st.dictionaries(_KEYS, inner, max_size=20),
    max_leaves=40).filter(lambda t: isinstance(t, dict))


@settings(max_examples=60, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(_TREES)
def test_writer_matches_flax_on_generated_trees(tree):
    assert msgpack_serialize(tree) == flax.serialization.msgpack_serialize(
        tree)


@pytest.mark.parametrize("n", [0, 15, 16, 65535, 65536])
def test_writer_header_widths_match_flax(n):
    """Map, string, binary and ext headers at each width boundary."""
    tree = {"m": {f"k{i:05d}": np.zeros((), np.uint8) for i in range(
        min(n, 17))},
            "s": "x" * n, "b": b"y" * n,
            "a": np.zeros(n, np.uint8), "i": n, "j": -n - 1}
    assert msgpack_serialize(tree) == flax.serialization.msgpack_serialize(
        tree)


@pytest.mark.parametrize("rel", STATE_FILES)
def test_writer_reproduces_committed_checkpoint(rel):
    with open(os.path.join(REPO, rel), "rb") as f:
        data = f.read()
    tree = msgpack_restore(data)
    out = msgpack_serialize(tree)
    assert out == data
    assert out == flax.serialization.msgpack_serialize(tree)


@pytest.mark.parametrize("leaf", [
    np.float32(0.5), 1.0 + 2.0j, (1, 2),
    np.zeros(3, ml_dtypes.bfloat16),
    np.broadcast_to(np.zeros(1, np.uint8), (2 ** 30 + 1,))],
    ids=["numpy_scalar", "complex", "tuple", "bfloat16", "chunked"])
def test_writer_refuses_what_the_reader_refuses(leaf):
    with pytest.raises((TypeError, ValueError)):
        msgpack_serialize({"leaf": leaf})


# --------------------------------------------------------------------- #
# metadata

@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stacks"))
    info = make_synthetic_stacks(root, n_stack=3, n_grid=2 * TILE,
                                 redshifts=(0.0, 1.0), seed=0)
    kw = dict(files=load_file_info(info), root_path=root, n_tile=2,
              tile_permutations=True)
    jd = JaxDataset(**kw, n_stack=2, stack_offset=1,
                    transforms={"dm": jtransforms.RangeCompress(
                        "shift-log", 4.0, eps=1e-4),
                        "pressure": jtransforms.RangeCompress(
                            "shift-log", 4.0, eps=1e-4)})
    td = BahamasTileDataset(**kw, n_stack=2, stack_offset=1,
                            transforms={"dm": ttransforms.RangeCompress(
                                "shift-log", 4.0, eps=1e-4),
                                "pressure": ttransforms.RangeCompress(
                                    "shift-log", 4.0, eps=1e-4)})
    jtest = JaxDataset(data=jd.data, n_stack=1, n_tile=2,
                       tile_permutations=True, transforms=jd.transforms)
    ttest = BahamasTileDataset(data=td.data, n_stack=1, n_tile=2,
                               tile_permutations=True,
                               transforms=td.transforms)
    return jd, td, jtest, ttest


def _arch():
    return fiducial_cvae_architecture(TILE, n_res_blocks=1)


def test_meta_from_dataset_matches_jax(data):
    jd, td, _, _ = data
    got = ckpt.meta_from_dataset(td, _arch())
    want = jckpt.meta_from_dataset(jd, _arch())
    assert list(got) == list(want)
    for key in want:
        assert got[key] == want[key], key
    assert json.dumps(ckpt._jsonify(got)) == json.dumps(jckpt._jsonify(want))


@pytest.mark.parametrize("spec", [
    {"type": "range_compress", "mode": "shift-log", "k": 4.0, "eps": 1e-4},
    {"type": "range_compress", "mode": "x/(1+x)", "k": [2.0, 1.0]},
    {"type": "range_compress", "mode": "log", "k": 3.0,
     "sqrt_of_mean": True},
    {"type": "to_delta"}, {"type": "identity"}])
def test_transform_to_dict_matches_jax(spec):
    got = ttransforms.transform_from_dict(spec).to_dict()
    assert got == jtransforms.transform_from_dict(spec).to_dict()
    assert ttransforms.transform_from_dict(got).to_dict() == got


# --------------------------------------------------------------------- #
# one real training run of each trainer

def _config(out, sched):
    return dict(learning_rate=1e-3, batch_size=BATCH, n_pepoch=2,
                pepoch_size=4, validation_loss_frequency=4,
                validation_loss_batch_size=BATCH, checkpoint_frequency=4,
                statistics_report_frequency=0, stats_sync_every=2, seed=3,
                adaptive_learning_rate=sched, output_path=str(out))


@pytest.fixture(scope="module")
def port_run(data, tmp_path_factory):
    """The port's train(): 4 steps with the stack cache, a validation loss
    and a periodic checkpoint, ReduceLROnPlateau."""
    _, td, _, ttest = data
    out = tmp_path_factory.mktemp("port_run")
    tr = ttrainer.CVAETrainer(
        CVAE(_arch()), td, test_data=ttest, device_data=True, device="cpu",
        config=ttrainer.TrainConfig(**_config(
            out, tsched.ReduceLROnPlateau(patience=0))))
    tr.train()
    return tr, str(out / "model")


@pytest.fixture(scope="module")
def jax_run(data, tmp_path_factory):
    """The JAX trainer's train() on the same plan (host batches: one
    compiled step), and its checkpoints."""
    jd, _, jtest, _ = data
    out = tmp_path_factory.mktemp("jax_run")
    tr = jtrainer.CVAETrainer(
        jcvae.CVAE(_arch()), jd, test_data=jtest,
        config=jtrainer.TrainConfig(**_config(
            out, jsched.ReduceLROnPlateau(patience=0))))
    tr.train()
    return tr, str(out / "model")


def _jax_state(tr) -> dict:
    """A JAX trainer's state as its own save writes it."""
    state = {"params": tr.state.params, "batch_stats": tr.state.batch_stats,
             "step": tr.state.step, "opt_state": tr.state.opt_state}
    return flax.serialization.to_state_dict(jax.device_get(state))


def test_jax_reads_the_ports_checkpoint(data, port_run, tmp_path):
    jd, _, jtest, _ = data
    tr, base = port_run
    raw, meta = jckpt.load_checkpoint(base)
    _assert_trees_equal(raw, tr.state_tree())
    assert meta == jckpt.meta_from_dataset(jd, _arch())

    sched = jsched.ReduceLROnPlateau(patience=0)
    jt = jtrainer.CVAETrainer(
        jcvae.CVAE(_arch()), jd, test_data=jtest,
        config=jtrainer.TrainConfig(**_config(tmp_path, sched)))
    jt.restore(base)
    want = tr.state_tree()
    _assert_trees_equal(_jax_state(jt), {k: want[k] for k in (
        "params", "batch_stats", "step", "opt_state")})
    assert jt._host_step == tr.steps == 4
    assert jt._progress == tr._progress
    assert (jt._data_rng.bit_generator.state
            == tr._data_rng.bit_generator.state)
    np.testing.assert_array_equal(sched.state_array(), want["lr_sched"])
    jt.save(str(tmp_path / "again"))
    with open(base + "_state.msgpack", "rb") as f, \
            open(str(tmp_path / "again") + "_state.msgpack", "rb") as g:
        assert f.read() == g.read()


def _patched_sample_z(eps):
    """The JAX CVAE's sample_z drawing ``eps`` (N, 1, h, w) instead."""
    def sample_z(self, rng, z_mu, z_log_var, L=1):
        e = jnp.asarray(eps)[None].transpose(0, 1, 3, 4, 2)[
            :, :z_mu.shape[0]]
        z = z_mu[None] + e * (jnp.exp(z_log_var[None] / 2) + self.min_z_var)
        return z.reshape(-1, *z_mu.shape[1:])
    return sample_z


def test_jax_painter_paints_the_ports_checkpoint(data, port_run, tmp_path):
    _, td, _, _ = data
    tr, base = port_run
    tiles = td.get_raw_batch(np.arange(3))["input"]
    zs = np.array([0.0, 1.0, 0.5], np.float32)
    eps = np.random.default_rng(2).standard_normal(
        (3, 1, TILE // 32, TILE // 32)).astype(np.float32)
    port = tpainter.CVAEPainter(base, device="cpu")
    got = port.paint_batch(tiles, zs, eps=eps).numpy()
    # the painter's own checkpoint (weights only) paints the same
    port.save_state_to_file(str(tmp_path / "painter"))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcvae.CVAE, "sample_z", _patched_sample_z(eps))
        for path in (base, str(tmp_path / "painter")):
            want = np.asarray(jpainter.CVAEPainter(path).paint_batch(tiles,
                                                                     zs))
            scale = np.abs(want).max()
            np.testing.assert_allclose(got, want, rtol=5e-3,
                                       atol=5e-3 * scale)
    from_trainer = tpainter.CVAEPainter.from_trainer(tr)
    np.testing.assert_array_equal(
        from_trainer.paint_batch(tiles, zs, eps=eps).numpy(), got)


def test_port_restores_the_jax_checkpoint(data, jax_run, tmp_path):
    _, td, _, ttest = data
    jt, base = jax_run
    sched = tsched.ReduceLROnPlateau(patience=0)
    tr = ttrainer.CVAETrainer(
        CVAE(_arch()), td, test_data=ttest, device="cpu",
        config=ttrainer.TrainConfig(**_config(tmp_path, sched)))
    tr.restore(base)
    raw, _ = jckpt.load_checkpoint(base)
    _assert_trees_equal(tr.state_tree(), raw)
    assert tr._progress == jt._progress
    with open(base + "_state.msgpack", "rb") as f:
        assert msgpack_serialize(tr.state_tree()) == f.read()


def test_port_restores_fiducial_512_with_its_adam_state(data):
    _, td, _, _ = data
    base = os.path.join(REPO, "trained_models/CVAE/fiducial-512/model")
    _, meta = ckpt.load_checkpoint(base)
    tr = ttrainer.CVAETrainer(CVAE(meta["model_architecture"]), td,
                              device="cpu")
    tr.restore(base)
    assert tr.steps == tr.optimizer.count == 19166
    with open(base + "_state.msgpack", "rb") as f:
        assert msgpack_serialize(tr.state_tree()) == f.read()


def test_one_step_after_restoring_the_jax_checkpoint_matches_jax(data,
                                                                  jax_run):
    """The further step at batch 4: at batch 2 the step is ill conditioned,
    and the JAX f32 gradient itself lies 1.158e-3 (relative, past 1e-4 of
    the largest entry) from the JAX f64 gradient (the port's 7.658e-4, the
    two f32 gradients 1.565e-3 apart); at batch 4 all three agree within
    9.3e-7 of the largest entry (scripts/restored_step_conditioning.py)."""
    jd, td, _, _ = data
    _, base = jax_run
    idx = td.sample_indices(np.random.default_rng(11), 4)
    eps = np.random.default_rng(12).standard_normal(
        (4, 1, TILE // 32, TILE // 32)).astype(np.float32)
    tr = ttrainer.CVAETrainer(CVAE(_arch()), td, device="cpu")
    tr.restore(base)
    got = tr.step(td.get_raw_batch(idx), 1e-3, eps=eps)
    got_grads = _flat(to_jax_variables(tr.model, grads=True)["params"])
    got_adam = tr.state_tree()["opt_state"]["0"]
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jcvae.CVAE, "sample_z", _patched_sample_z(eps))
        jt = jtrainer.CVAETrainer(jcvae.CVAE(_arch()), jd,
                                  config=jtrainer.TrainConfig())
        jt.restore(base)
        batch = jt._put_batch(jd.get_raw_batch(idx))

        def loss(params):
            out, _ = jt._forward(params, jt.state.batch_stats, *batch,
                                 jax.random.PRNGKey(0), 1.0, 1.0, True)
            return -out["elbo"]

        want_grads = _flat(jax.device_get(
            jax.jit(jax.grad(loss))(jt.state.params)))
        want = jax.device_get(jt.step(jd.get_raw_batch(idx), 1e-3))
        want_adam = _jax_state(jt)["opt_state"]["0"]
    for k in want:
        np.testing.assert_allclose(got[k].numpy(), want[k], rtol=1e-3,
                                   atol=1e-4, err_msg=k)
    top = max(np.abs(g).max() for g in want_grads.values())
    for k in want_grads:
        np.testing.assert_allclose(got_grads[k], want_grads[k], rtol=1e-3,
                                   atol=1e-4 * top, err_msg=k)
    assert int(got_adam["count"]) == int(want_adam["count"]) == 5
    for key in ("mu", "nu"):
        a, b = _flat(got_adam[key]), _flat(want_adam[key])
        top = max(np.abs(v).max() for v in b.values())
        for k in b:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-3,
                                       atol=1e-4 * top, err_msg=f"{key}/{k}")


def test_cgan_painter_saves_what_the_jax_painter_saves(tmp_path):
    base = os.path.join(REPO, "trained_models/CGAN/fiducial/model")
    tpainter.CGANPainter(base, device="cpu").save_state_to_file(
        str(tmp_path / "port"))
    jpainter.CGANPainter(base).save_state_to_file(str(tmp_path / "jax"))
    for suffix in ("_state.msgpack", "_meta.json"):
        with open(str(tmp_path / "port") + suffix, "rb") as f, \
                open(str(tmp_path / "jax") + suffix, "rb") as g:
            assert f.read() == g.read(), suffix
