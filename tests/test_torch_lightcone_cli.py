"""The port's lightcone CLI (scripts/create_lightcone_torch.py), its
synthetic line of sight, and chip_smoke.py's phase 16 on the CPU.

* The new modules and the CLI run with jax, flax, msgpack and the JAX
  package unimportable, as on the machine with the card: a cut-down
  synthetic line of sight (a massplane shell, a 4-tile delta shell) painted
  through the CLI's ``run`` in its default bf16 with ``--fused-paint`` and
  ``BPT_FUSED_HEADS=1``, the y map and the kappa cross-Cl.
  The same run paints with the CGAN, whole-plane (``--model-type CGAN
  --seamless``).
* ``--model-type CGAN`` (tiled with ``--fused-paint``, and ``--seamless``)
  on the committed tests/fixtures/slics line of sight against the JAX
  package's pipeline with the same arguments (its CLI's tile size, 512^2
  tiles, redshifts and shell sizes): every plane and the y map within the
  golden's tolerance (rtol 5e-3, atol 5e-3 * mean|JAX|). The CGAN paints
  in f32 by default, the CVAE in bf16, as the JAX CLI.
* ``--mesh-devices N`` asks for N cards and raises when there are fewer
  (here: none), whichever painter and mode;
  ``--seamless --fused-paint`` raises ``ValueError``, as JAX's pipeline.
* Phase 16 (``smoke.lightcone``) runs its control flow on the CPU at 300^2
  delta planes (the kernels' plain versions: no launches), and its
  geometry at the real sizes is the one the card run checks: 6 paint calls
  over 69 tiles, the 16a cases 1211^2 and 7050^2 to 512^2 and 3273^2 to
  1549^2.
"""
import os
import shutil
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from baryon_painter_tpu_torch import smoke
from baryon_painter_tpu_torch.lightcone import io as slics_io
from baryon_painter_tpu_torch.lightcone.synthetic import (shell_sizes,
                                                          write_synthetic_los)
from golden_utils import REPO

_BLOCKED_RUN = textwrap.dedent("""
    import importlib.abc, os, sys, tempfile
    BLOCKED = ("jax", "jaxlib", "flax", "msgpack", "baryon_painter_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, Block())
    import numpy as np
    import baryon_painter_tpu_torch.angular_power
    import baryon_painter_tpu_torch.cosmology
    import baryon_painter_tpu_torch.lightcone.pipeline
    import baryon_painter_tpu_torch.models.cgan
    import baryon_painter_tpu_torch.ops.resample
    import baryon_painter_tpu_torch.parallel.spatial
    import baryon_painter_tpu_torch.power_spectrum
    import baryon_painter_tpu_torch.utils.constants
    from baryon_painter_tpu_torch.lightcone.synthetic import (
        write_synthetic_los)
    sys.path.insert(0, "scripts")
    import create_lightcone_torch
    with tempfile.TemporaryDirectory() as base:
        los = write_synthetic_los(base, (0.042, 0.221), 74,
                                  n_pixel_delta=200, n_pixel_massplane=300,
                                  device="cpu")
        os.environ["BPT_FUSED_HEADS"] = "1"
        out = create_lightcone_torch.run([
            "--CVAE-path", "trained_models/CVAE/fiducial-512",
            "--SLICS-base-path", base, "--SLICS-LOS", "74",
            "--output-file", os.path.join(base, "y"), "--fused-paint",
            "--kappa-path", los["kappa"], "--output-resolution", "96",
            "--n-pixel-delta", "200", "--n-pixel-massplane", "300",
            "--device", "cpu"])
        y = np.load(os.path.join(base, "y.npy"))
        cl = np.load(os.path.join(base, "y_y_x_kappa.npz"))["cl"]
        gan = create_lightcone_torch.run([
            "--model-type", "CGAN", "--CGAN-path",
            "trained_models/CGAN/fiducial", "--seamless",
            "--SLICS-base-path", base, "--SLICS-LOS", "74",
            "--output-file", os.path.join(base, "y_gan"),
            "--output-resolution", "96", "--n-pixel-delta", "200",
            "--n-pixel-massplane", "300", "--device", "cpu"])
    assert [tuple(p.shape) for p in gan["planes"]] == [(111, 111),
                                                       (562, 562)]
    assert np.isfinite(gan["y_map"]).all()
    assert y.shape == (96, 96) and np.isfinite(y).all()
    assert np.array_equal(y, out["y_map"])
    assert list(out["z_SLICS"]) == [0.042, 0.221]
    assert np.isfinite(cl).any()
    assert [str(p.dtype) for p in out["planes"]] == ["torch.float32"] * 2
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("LIGHTCONE", y.shape)
""")


def test_lightcone_cli_runs_without_jax_flax_msgpack_or_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LIGHTCONE (96, 96)" in proc.stdout


@pytest.fixture(scope="module")
def cli():
    return smoke._load_cli()


@pytest.mark.parametrize("flags", [
    ["--model-type", "CGAN"], [], ["--seamless"]],
    ids=["cgan", "mesh", "seamless"])
def test_cli_raises_for_what_is_not_ported(cli, tmp_path, flags):
    """``--mesh-devices 2`` needs two cards, with either painter or mode:
    it never quietly paints on fewer."""
    with pytest.raises(RuntimeError, match="needs 2 CUDA devices"):
        cli.run(["--CVAE-path", "x", "--SLICS-base-path", str(tmp_path),
                 "--SLICS-LOS", "1", "--output-file", str(tmp_path / "y"),
                 "--mesh-devices", "2"] + flags)


def _fixture_los(tmp_path):
    """tests/fixtures/slics's delta plane (z = 0.5, 5^2) laid out as the
    SLICS release lays it out."""
    name = "0.500delta.dat_bicubic_LOS9"
    os.makedirs(tmp_path / "delta")
    shutil.copy(os.path.join(REPO, "tests", "fixtures", "slics", name),
                tmp_path / "delta" / name)
    return ["--SLICS-base-path", str(tmp_path), "--SLICS-LOS", "9",
            "--n-pixel-delta", "5", "--output-resolution", "64",
            "--output-file", str(tmp_path / "y"), "--device", "cpu"]


@pytest.mark.parametrize("model_type", ["CVAE", "CGAN"])
def test_cli_seamless_with_fused_paint_raises(cli, tmp_path, model_type):
    path = ("trained_models/CVAE/fiducial-512" if model_type == "CVAE"
            else "trained_models/CGAN/fiducial")
    with pytest.raises(ValueError, match="fused"):
        cli.run(_fixture_los(tmp_path) + [
            "--model-type", model_type, f"--{model_type}-path", path,
            "--seamless", "--fused-paint"])


@pytest.mark.parametrize("mode", ["fused", "seamless"])
def test_cli_cgan_matches_the_jax_pipeline(cli, tmp_path, mode):
    import jax.numpy as jnp
    from baryon_painter_tpu.cosmology import SLICS_COSMOLOGY
    from baryon_painter_tpu.lightcone import create_y_map, process_slics
    from baryon_painter_tpu.painter import CGANPainter

    path = "trained_models/CGAN/fiducial"
    argv = _fixture_los(tmp_path) + ["--model-type", "CGAN", "--CGAN-path",
                                     path, f"--{mode}-paint" if mode ==
                                     "fused" else "--seamless"]
    got = cli.run(argv)
    cosmo = SLICS_COSMOLOGY()
    z = np.array([0.5])
    painter = CGANPainter(os.path.join(REPO, path, "model"),
                          fused_inference=mode == "fused")
    want = process_slics(
        painter, tile_size=100.0, n_pixel_tile=512, LOS=9, z_SLICS=z,
        delta_size=cosmo.comoving_angular_distance(z) * cosmo.h * 10 / 180
        * np.pi, delta_path=str(tmp_path / "delta"), massplane_path="",
        shifts_path="", z_slice=[cosmo.redshift_of_chi(0.0)],
        min_tiling_overlap=0.2, verbose=False, n_pixel_delta=5,
        seamless=mode == "seamless")
    y_want = create_y_map(want, z, resolution=64, map_size=10.0,
                          cosmo=cosmo, order=5)
    assert [tuple(p.shape) for p in got["planes"]] == [
        np.shape(p) for p in want]
    for g, w in zip(got["planes"] + [got["y_map"]], list(want) + [y_want]):
        g = np.asarray(torch.as_tensor(g).cpu(), np.float64)
        w = np.asarray(w, np.float64)
        assert np.all(np.isfinite(g))
        np.testing.assert_allclose(g, w, rtol=5e-3,
                                   atol=5e-3 * np.abs(w).mean())
    assert all(torch.as_tensor(p).dtype == torch.float32
               for p in got["planes"])
    assert jnp.asarray(want[0]).dtype == jnp.float32


@pytest.mark.parametrize("model_type,dtype", [("CVAE", torch.bfloat16),
                                              ("CGAN", None)])
def test_cli_paint_dtype_defaults_per_model(cli, tmp_path, monkeypatch,
                                            model_type, dtype):
    import baryon_painter_tpu_torch.painter as painter_mod

    seen = {}

    class Stop(Exception):
        pass

    def record(path, **kw):
        seen.update(kw)
        raise Stop

    monkeypatch.setattr(painter_mod, f"{model_type}Painter", record)
    with pytest.raises(Stop):
        cli.run(_fixture_los(tmp_path) + ["--model-type", model_type,
                                          f"--{model_type}-path", "x"])
    assert seen["dtype"] == dtype and seen["fused_inference"] is False


def test_cli_defaults_are_the_jax_clis(cli):
    args = cli.parse_args(["--SLICS-base-path", "b", "--SLICS-LOS", "3",
                           "--output-file", "o"])
    assert (args.model_type, args.n_plane, args.tile_overlap,
            args.output_resolution, args.paint_batch_size, args.paint_dtype,
            args.fused_paint, args.bf16_transfer, args.kappa_survey,
            args.kappa_tomo, args.device) == (
        "CVAE", 15, 0.2, 1549, 16, None, False, False, "KiDS450", 0, None)
    assert (args.n_pixel_delta, args.n_pixel_massplane) == (
        slics_io.N_PIXEL_DELTA, slics_io.N_PIXEL_MASSPLANE)


def test_synthetic_los_layout(tmp_path):
    """The SLICS layout process_slics reads; prepared planes of mean ~1."""
    z = (0.042, 0.221)
    los = write_synthetic_los(str(tmp_path), z, 74, n_pixel_delta=64,
                              n_pixel_massplane=48, device="cpu")
    assert los["kinds"] == ["massplane", "delta"]
    assert list(shell_sizes(z) < 100.0) == [True, False]
    plane = slics_io.load_delta_plane(
        slics_io.delta_filename(los["delta"], 0.221, 74), n_pixel=64)
    mp = slics_io.load_massplane(
        slics_io.massplane_filename(los["massplanes"], 0.042, 74, 0),
        n_pixel=48)
    assert plane.shape == (64, 64) and mp.shape == (48, 48)
    assert abs(plane.mean() - 1) < 0.05 and abs(mp.mean() - 1) < 0.05
    assert slics_io.load_random_shifts(los["random_shifts"], 74).shape == (
        2, 2)
    kappa = slics_io.load_kappa_map(slics_io.kappa_filename(los["kappa"], 74),
                                    n_pixel=64)
    assert abs(kappa.std() - 0.02) < 0.002


def test_phase16_geometry_at_the_real_sizes():
    shells = smoke.lightcone_geometry()
    assert [s["kind"] for s in shells] == ["massplane", "delta", "delta"]
    assert [s["tiles"] for s in shells] == [1, 4, 64]
    assert sum(s["calls"] for s in shells) == 6
    assert [s.get("n_nat") for s in shells] == [None, 7050, 1211]
    assert smoke.lightcone_resample_cases(shells) == [
        (1211, 512, 3, "reflect"), (7050, 512, 3, "reflect"),
        (3273, 1549, 5, "mirror")]


@pytest.fixture(scope="module")
def phase16():
    before = (torch.backends.cudnn.allow_tf32,
              torch.backends.cuda.matmul.allow_tf32)
    cpu = torch.device("cpu")
    with smoke.synthetic_lightcone(cpu, z=(0.042, 0.221), n_pixel_delta=300,
                                   n_pixel_massplane=400,
                                   resolution=128) as data:
        out = smoke.lightcone(cpu, data)
    out["tf32_restored"] = before == (torch.backends.cudnn.allow_tf32,
                                      torch.backends.cuda.matmul.allow_tf32)
    return out


def test_phase16_on_cpu(phase16):
    """On the CPU every wrapper computes its plain version: no launches;
    the bf16 check and the cross-Cl hold, and the timed run's stages come
    back per shell."""
    assert [r["err_over_tol"] <= 1.0 for r in phase16["resample"]] == [
        True] * 3
    assert max(phase16["f32"]["planes_err_over_tol"]) <= 1.0
    bf16 = phase16["bf16"]
    assert bf16["ratio"] <= smoke.LC_BF16_RATIO and bf16["cross_cl_finite"]
    assert set(bf16["launches"].values()) == {0}
    assert (bf16["tiles"], bf16["paint_calls"]) == (5, 2)
    timing = phase16["timing"]
    assert len(timing["shells"]) == 2 and timing["tiles"] == 5
    assert all(set(s) == {"upload", "zoom", "paint", "blend", "k1",
                          "k3_fwd"} for s in timing["shells"])
    assert set(timing["stages"]) == {"setup", "ymap", "cl"}
    assert timing["tiles_per_s"] > 0
    assert "BPT_FUSED_HEADS" not in os.environ
    assert phase16["tf32_restored"]


def test_phase16_in_the_kernels_record(phase16):
    """The bf16 K1 and K3-fwd entries carry the lightcone's launches."""
    entries = [{"name": "res_block_infer"}, {"name": "head_stack_fwd"},
               {"name": "head_stack_bwd"}]
    lc = {"bf16": {"bf16_launches": {"k1": 24, "k3_fwd": 6}},
          "timing": {"shells": [{"k1": 4, "k3_fwd": 1}, {"k1": 4,
                                                          "k3_fwd": 1},
                                {"k1": 16, "k3_fwd": 4}]}}
    smoke._add_lightcone_launches(entries, lc)
    assert [e.get("lightcone_launches") for e in entries] == [24, 6, None]
    assert entries[0]["lightcone_launches_per_shell"] == [4, 4, 16]
    assert entries[1]["lightcone_launches_per_shell"] == [1, 1, 4]
    smoke._add_lightcone_launches(entries[:1], phase16)
    assert entries[0]["lightcone_launches_per_shell"] == [0, 0]


@pytest.fixture(scope="module")
def phases17e_18():
    """Phase 17e and phase 18 on the CPU: a massplane shell and a 4-tile
    delta shell, small planes."""
    cpu = torch.device("cpu")
    with smoke.synthetic_lightcone(cpu, z=(0.042, 0.221), n_pixel_delta=200,
                                   n_pixel_massplane=300,
                                   resolution=96) as data:
        tiled = smoke.run_lightcone_cli(cpu, data["los"], "bf16", False,
                                        **data["size"])
        return {"cgan": smoke.lightcone_cgan(cpu, data),
                "halo": smoke.check_halo(cpu, n=64, calibrate=False),
                "plain": smoke.seamless_vs_plain(cpu, n=64),
                "seamless": smoke.lightcone_seamless(cpu, data, tiled)}


def test_phase17e_cgan_lightcone_on_cpu(phases17e_18):
    lc = phases17e_18["cgan"]
    assert lc["paint_calls"] == 2 and set(lc["launches"].values()) == {0}
    assert max(lc["planes_err_over_tol"]) <= 1.0
    assert lc["y_map_err_over_tol"] <= 1.0
    assert [sorted(s) for s in lc["shells"]] == [
        ["blend", "k1", "paint", "upload", "zoom"]] * 2
    assert "BPT_FUSED_HEADS" not in os.environ


def test_phase18_seamless_on_cpu(phases17e_18):
    assert [(r["model"], r["halo"]) for r in phases17e_18["halo"]] == [
        ("cvae", 288), ("cgan", 92)]
    assert all(r["err_over_tol"] <= 1.0 for r in phases17e_18["halo"])
    assert all(r["f32_err_over_tol"] <= r["limit"]
               for r in phases17e_18["halo"])
    assert all(r["err_over_tol"] <= 1.0 for r in phases17e_18["plain"])
    sl = phases17e_18["seamless"]
    # the 0.221 shell: a 562^2 plane, padded to 576 and extended by 2 x 288
    assert (sl["planes"], sl["extended"]) == ([562], [1152])
    assert set(sl["launches"].values()) == {0}
    assert [sorted(s) for s in sl["shells"]] == [
        ["blend", "k1", "paint", "upload", "zoom"],
        ["k1", "paint", "upload", "zoom"]]
    assert np.isfinite(sl["e_seamless_tiled"])
    assert [len(v) for v in sl["p9999"].values()] == [1, 1]


def test_phase18_geometry_at_the_real_sizes():
    """The z = 2.007 shell is one 3273^2 plane, padded to 3296 and extended
    by 2 x 288: 3872^2."""
    from baryon_painter_tpu_torch.parallel import spatial
    shells = smoke.lightcone_geometry()
    plane = shells[2]["n_plane"]
    halo = spatial.required_halo(smoke._load_meta(
        smoke.REPO / smoke.CHECKPOINT)["model_architecture"])
    assert (plane, -(-plane // 32) * 32 + 2 * halo) == (3273, 3872)
