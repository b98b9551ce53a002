"""Phase 21 of ``chip_smoke.py`` (CGAN training) and phase 20b's
fiducial-adv gate on the CPU, at small sizes: the committed fiducial-adv
state (G, D, both Adams; fully convolutional) on 32^2 tiles at batch 2,
the run of two pepochs of 4 samples, the gate leg on 20b's 256^2 stacks
at one step of 3 samples and 2 tiles a redshift. The kernels are their
plain versions here: 0 launches, and the K2 step equals the plain-gather
step trivially."""
import numpy as np
import pytest
import torch

from baryon_painter_tpu_torch import smoke

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread a process: the suite's other workers load every
    core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gate_adv():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(smoke, "GATE_TILES", 2)
        return smoke.gate_check(CPU, smoke.CGAN_ADV_PATH, {"k1": 9},
                                "cgan_adv", seeds=1, phase="20b")


@pytest.fixture(scope="module")
def cgan_run(gate_adv):
    ds = smoke.training_data(tile=32)
    return smoke.cgan_train(
        CPU, ds, {"cgan_adv": gate_adv}, batch=2, step_iters=2,
        loop={"pepoch": 4, "validation": 4}, paint_tiles=2,
        gate_args=("--model", "cgan", "--n-samples", "3", "--batch", "3",
                   "--adv-weight", "1", "--pk-loss-weight", "1e4",
                   "--freeze-bn", "--eval-tiles", "2"))


def test_fiducial_adv_gate_phase_on_cpu(gate_adv):
    assert set(gate_adv["launches"].values()) == {0}
    assert set(gate_adv["rows"]) == {f"{z}/{k}" for z in ("0", "0.5", "1")
                                     for k in ("auto", "cross")}
    row = gate_adv["rows"]["1/auto"]
    assert row["committed_f32"] == 0.0536
    assert row["bf16_limit"] == max(
        smoke.GATE_FLOOR, abs(row["jax_f32"] - row["jax_bf16_pinned"]),
        abs(row["jax_bf16_jit"] - row["jax_bf16_pinned"]))
    train_ds, val_ds = gate_adv["data"]
    assert val_ds.tile_size == 256 and len(train_ds.redshifts) == 3


def test_cgan_step_phase_on_cpu(cgan_run):
    step = cgan_run["step"]
    assert set(step["launches"].values()) == {0}
    assert step["step_ms"] > 0 and step["peak_bytes"] is None


def test_cgan_f64_and_gather_phase_on_cpu(cgan_run):
    parity = cgan_run["parity"]
    assert parity["k2_vs_plain_equal"]
    for regime in ("committed", "reinit_d"):
        worst = parity["regimes"][regime]["worst"]
        assert worst["metrics"][1] <= smoke.CGAN_F64_RTOL
        assert worst["grads"][1] <= smoke.STEP_GRAD_TOL
        assert worst["stats"][1] <= smoke.CGAN_F64_RTOL
        grads = parity["regimes"][regime]["errors"]["grads"]
        assert any(k.startswith("g/") for k in grads)
        assert any(k.startswith("d/") for k in grads)


def test_cgan_modes_phase_on_cpu(cgan_run):
    modes = cgan_run["modes"]
    assert set(modes) == set(smoke.CGAN_MODES)
    assert not modes["calibration"]["moved"]["d_params"]
    assert not modes["calibration"]["moved"]["g_state"]
    assert modes["calibration"]["metrics"]["loss_D"] == 0.0
    assert not modes["freeze_bn_stats"]["moved"]["g_state"]
    assert modes["freeze_bn_stats"]["moved"]["d_state"]
    assert modes["pk_per_z"]["metrics"]["pk_loss"] > 0
    assert modes["reinit_d"]["moved"]["d_params"]


def test_cgan_train_loop_and_paint_phases_on_cpu(cgan_run):
    loop, paint = cgan_run["loop"], cgan_run["paint"]
    assert loop["steps"] == 4 and loop["evals"] == 2
    assert loop["resumed_distance"] == 0 and loop["stats_files_equal"]
    assert loop["replay_distance"] == 0
    assert set(loop["launches"].values()) == {0}
    assert paint["ratio"] <= 1.0 and paint["load_painter_equal"]
    assert set(paint["launches"].values()) == {0}


def test_cgan_gate_leg_phase_on_cpu(cgan_run):
    gate = cgan_run["gate"]
    assert gate["steps"] == 1 and set(gate["launches"].values()) == {0}
    report = gate["report"]
    assert report["model"] == "cgan" and report["n_samples"] == 3
    assert set(report["per_z_by_dtype"]) == {"f32", "model"}
    values = [v for d in report["per_z_by_dtype"].values()
              for r in d.values() for v in r.values()]
    assert all(np.isfinite(values))


def test_cgan_train_launches_on_the_kernels_record(cgan_run):
    entries = [{"name": n, "dtype": d} for n in (
        "res_block_infer", "gather_tiles") for d in ("float32", "bfloat16")]
    smoke._add_cgan_train_launches(entries, cgan_run)
    by = {(e["name"], e["dtype"]): e for e in entries}
    assert by["gather_tiles", "float32"]["cgan_step_launches"] == 0
    assert by["gather_tiles", "float32"]["cgan_train_loop_launches"] == 0
    assert by["res_block_infer", "float32"][
        "cgan_from_trainer_launches"] == 0
    assert "cgan_step_launches" not in by["gather_tiles", "bfloat16"]
