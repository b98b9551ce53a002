"""The port's lightcone CLI (scripts/create_lightcone_torch.py), its
synthetic line of sight, and chip_smoke.py's phase 16 on the CPU.

* The new modules and the CLI run with jax, flax, msgpack and the JAX
  package unimportable, as on the machine with the card: a cut-down
  synthetic line of sight (a massplane shell, a 4-tile delta shell) painted
  through the CLI's ``run`` in its default bf16 with ``--fused-paint`` and
  ``BPT_FUSED_HEADS=1``, the y map and the kappa cross-Cl.
* What is not ported raises ``NotImplementedError`` naming its ROADMAP.md
  item: ``--model-type CGAN`` (§1 item 3), ``--mesh-devices`` (item 10),
  ``--seamless`` (item 4).
* Phase 16 (``smoke.lightcone``) runs its control flow on the CPU at 300^2
  delta planes (the kernels' plain versions: no launches), and its
  geometry at the real sizes is the one the card run checks: 6 paint calls
  over 69 tiles, the 16a cases 1211^2 and 7050^2 to 512^2 and 3273^2 to
  1549^2.
"""
import os
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
    import baryon_painter_tpu_torch.ops.resample
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


@pytest.mark.parametrize("flags,item", [
    (["--model-type", "CGAN"], "item 3"), (["--mesh-devices", "2"], "item 10"),
    (["--seamless"], "item 4")], ids=["cgan", "mesh", "seamless"])
def test_cli_raises_for_what_is_not_ported(cli, tmp_path, flags, item):
    with pytest.raises(NotImplementedError, match=item):
        cli.run(["--CVAE-path", "x", "--SLICS-base-path", str(tmp_path),
                 "--SLICS-LOS", "1", "--output-file",
                 str(tmp_path / "y")] + flags)


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
    out = smoke.lightcone(torch.device("cpu"), z=(0.042, 0.221),
                          n_pixel_delta=300, n_pixel_massplane=400,
                          resolution=128)
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
