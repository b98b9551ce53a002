"""``scripts/pk_diagnose_torch.py`` against ``scripts/pk_diagnose.py``.

A JAX bf16 trainer at tile 64 carrying the committed fiducial CVAE's
weights (fully convolutional; an untrained decoder paints round-off)
saves ``fidelity_model_cvae`` into a synthetic workdir (two redshifts, the
gate's stacks), and both scripts read it:

* the keys of the JSON lines are equal, and the k grid to f32 rounding;
* through the twin's ``diagnose`` in f32 at the JAX package's prior noise,
  each ratio and r(k) within 1e-4 relative of the same arithmetic done
  with the JAX package's ``CVAEPainter`` and ``pseudo_pofk_2d``;
* the scripts' own bf16 lines (the port through K1 and K3's plain
  versions here, at the JAX script's bf16 noise) within max(5e-3, 2 x the
  JAX package's own |f32 - bf16| for that bin): bf16 is chaotic
  (ROADMAP.md section 3);
* ``--model cgan`` (which the JAX script restores into a CVAE trainer and
  fails on) is refused before any work.
"""
import contextlib
import importlib.util
import io
import json
import os
import sys

import numpy as np
import pytest

from golden_utils import REPO

TILE, N_SAMPLE = 64, 16
F32_RTOL = 1e-4
BF16_FLOOR = 5e-3
KINDS = ("auto_ratio", "cross_ratio", "r")


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def twin():
    return _load("pk_diagnose_torch")


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The synthetic workdir and the JAX trainer whose checkpoint is in it
    (bf16, the fiducial weights)."""
    import jax
    import jax.numpy as jnp

    from baryon_painter_tpu.data.dataset import (BahamasTileDataset,
                                                 load_file_info)
    from baryon_painter_tpu.data.synthetic import make_synthetic_stacks
    from baryon_painter_tpu.models.cvae import (CVAE,
                                                fiducial_cvae_architecture)
    from baryon_painter_tpu.train import checkpoint as jckpt
    from baryon_painter_tpu.train.trainer import CVAETrainer, TrainConfig
    from baryon_painter_tpu.transforms import RangeCompress
    root = str(tmp_path_factory.mktemp("pk_diagnose"))
    info = make_synthetic_stacks(root, n_stack=2, n_grid=2 * TILE,
                                 redshifts=(0.0, 1.0), seed=0, name="fid")
    tf = {f: RangeCompress("shift-log", 4.0, eps=1e-4)
          for f in ("dm", "pressure")}
    ds = BahamasTileDataset(files=load_file_info(info), root_path=root,
                            n_tile=2, n_stack=1, stack_offset=0,
                            tile_permutations=True, transforms=tf)
    state, _ = jckpt.load_checkpoint(
        os.path.join(REPO, "trained_models/CVAE/fiducial-512/model"))
    arch = fiducial_cvae_architecture(tile_size=TILE, n_res_blocks=4)
    jt = CVAETrainer(CVAE(arch, dtype=jnp.bfloat16), ds,
                     config=TrainConfig(seed=0))
    jt.state = jt.state.replace(
        params=jax.tree.map(jnp.asarray, state["params"]),
        batch_stats=jax.tree.map(jnp.asarray, state["batch_stats"]))
    jt.save(os.path.join(root, "fidelity_model_cvae"))
    return {"root": root, "ds": ds, "trainer": jt}


def _jax_diagnose(painter, ds, seed=0):
    """The JAX script's arithmetic with ``painter`` (any dtype): per
    redshift, the k grid and the auto ratio, cross ratio and r(k) by
    bin."""
    import jax

    from baryon_painter_tpu.power_spectrum import pseudo_pofk_2d
    rng = np.random.default_rng(seed)
    out = {}
    for z in ds.redshifts:
        batch = ds.get_raw_batch(ds.sample_indices(rng, N_SAMPLE, z=z))
        truth, dm = batch["labels"][0], batch["input"]
        painted = np.asarray(painter.paint_batch(
            dm, batch["z"], rng=jax.random.PRNGKey(seed)))
        pk = lambda a, b=None: pseudo_pofk_2d(a, b, L=ds.tile_L, n_k_bin=12)
        pk_t, k, _, nm = pk(truth)
        occ = np.asarray(nm) > 0
        m = lambda s: np.asarray(s).mean(0)[occ]
        a_t, a_p = m(pk_t), m(pk(painted)[0])
        c_t, c_p = m(pk(truth, dm)[0]), m(pk(painted, dm)[0])
        x = m(pk(painted, truth)[0])
        out[f"{z:g}"] = {"k": np.asarray(k)[occ], "auto_ratio": a_p / a_t,
                         "cross_ratio": c_p / c_t,
                         "r": x / np.sqrt(a_p * a_t)}
    return out


def _jax_noise(painter, dtype):
    """The noise the JAX painter draws under PRNGKey(0) for a call of
    ``N_SAMPLE`` tiles, (N_SAMPLE, h, w)."""
    import jax
    cz, h, w = painter.architecture["dim_z"]
    key = painter.model.apply(
        painter.variables, method=lambda m: m.make_rng("sample"),
        rngs={"sample": jax.random.PRNGKey(0)})
    eps = jax.random.normal(key, (1, N_SAMPLE, h, w, cz), dtype)
    return np.array(eps[0, ..., 0], np.float32)


def _rows(per_z):
    return {z: {kind: np.array([r[kind] for r in rows]) for kind in
                ("k",) + KINDS} for z, rows in per_z.items()}


@pytest.fixture(scope="module")
def lines(twin, workdir):
    """Both scripts' JSON lines (bf16, the trainer's dtype), the twin's
    at the JAX script's bf16 noise (PRNGKey(0) at each redshift)."""
    import functools

    import jax.numpy as jnp

    from baryon_painter_tpu.painter import CVAEPainter
    argv = ["--workdir", workdir["root"], "--tile", str(TILE)]
    jax_script = _load("pk_diagnose")
    eps = _jax_noise(CVAEPainter.from_trainer(workdir["trainer"]),
                     jnp.bfloat16)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(sys, "argv", ["pk_diagnose.py"] + argv)
        with contextlib.redirect_stdout(io.StringIO()) as out:
            jax_script.main()
        want = json.loads(out.getvalue().strip().splitlines()[-1])
        mp.setattr(twin, "diagnose", functools.partial(twin.diagnose,
                                                       eps=eps))
        with contextlib.redirect_stdout(io.StringIO()) as out:
            got = twin.main(argv + ["--device", "cpu"])
    text = out.getvalue()
    assert json.loads(text.strip().splitlines()[-1]) == got
    assert "auto_p/auto_t" in text and "mean_ratio=" in text
    return got, want


def test_keys_and_k_grid_equal(lines):
    got, want = lines
    assert got["metric"] == want["metric"] == "pk_per_bin"
    assert list(got["per_z"]) == list(want["per_z"]) == ["0", "1"]
    for z, rows in want["per_z"].items():
        assert len(got["per_z"][z]) == len(rows)
        for g, w in zip(got["per_z"][z], rows):
            assert set(g) == set(w)
            # the bins' mean k, summed in f32 in another order
            assert g["k"] == pytest.approx(w["k"], rel=1e-5)


def test_diagnose_f32_at_jax_noise_matches_jax_arithmetic(twin, workdir):
    from baryon_painter_tpu.painter import CVAEPainter
    args = twin.parse_args(["--workdir", workdir["root"], "--tile",
                            str(TILE), "--device", "cpu"])
    painter = twin.restore_painter(args, twin.dataset(workdir["root"]),
                                   device="cpu", dtype=None)
    jpainter = CVAEPainter.from_trainer(workdir["trainer"], dtype=None)
    want = _jax_diagnose(jpainter, workdir["ds"])
    eps = _jax_noise(jpainter, np.float32)
    with contextlib.redirect_stdout(io.StringIO()):
        got = _rows(twin.diagnose(painter, twin.dataset(workdir["root"]),
                                  n_sample=N_SAMPLE, eps=eps))
    assert list(got) == list(want)
    for z in want:
        np.testing.assert_allclose(got[z]["k"], want[z]["k"], rtol=1e-5)
        for kind in KINDS:
            np.testing.assert_allclose(got[z][kind], want[z][kind],
                                       rtol=F32_RTOL, err_msg=(z, kind))


def test_bf16_lines_within_jax_own_distance(lines, workdir):
    from baryon_painter_tpu.painter import CVAEPainter
    got, want = _rows(lines[0]["per_z"]), _rows(lines[1]["per_z"])
    # the JAX package's own f32 -> bf16 distance, by bin
    jax32 = _jax_diagnose(
        CVAEPainter.from_trainer(workdir["trainer"], dtype=None),
        workdir["ds"])
    for z in want:
        for kind in KINDS:
            limit = np.maximum(BF16_FLOOR,
                               2 * np.abs(jax32[z][kind] - want[z][kind]))
            diff = np.abs(got[z][kind] - want[z][kind])
            assert np.all(diff <= limit), (z, kind, diff, limit)


def test_cgan_is_refused(twin, tmp_path):
    with pytest.raises(SystemExit, match="cgan"):
        twin.main(["--workdir", str(tmp_path), "--model", "cgan",
                   "--device", "cpu"])
