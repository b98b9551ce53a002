"""Phase 24 of chip_smoke.py (``baryon_painter_tpu_torch/smoke_scripts.py``)
run on the CPU at a small size, so that its control flow and its checks
are exercised before the card runs them: the kernels' plain versions (no
launches), the committed fiducial-resize CVAE (256^2) at 4 tiles and 2
redshifts for 24a, 2 tiles a redshift for 24b on the same stacks, a 64^2
field for 24c, and a re-evaluation of 2 tiles at one redshift for 24d."""
import pytest
import torch

from baryon_painter_tpu_torch import smoke_scripts

CPU = torch.device("cpu")
SIZES = {"gate_variance": {"checkpoint":
                           "trained_models/CVAE/fiducial-resize/model",
                           "redshifts": "0,1",
                           "flags": ["--n-tiles", "4", "--n-boot", "5"]},
         "pk_diagnose": {"tile": 64, "n_sample": 2},
         "transform_examples": {"n": 64},
         "promote": {"eval_args": "--redshifts 0 --n-stack 2 "
                                  "--eval-tiles 2"}}


@pytest.fixture(scope="module")
def phase():
    return smoke_scripts.scripts(CPU, sizes=SIZES)


def test_24a_gate_variance(phase):
    out = phase["gate_variance"]
    rec = out["record"]
    assert rec["metric"] == "gate_eval_variance"
    assert rec["n_tiles_full"] == 4 and set(rec["per_z"]) == {"0.0", "1.0"}
    assert out["calls"] == 2
    assert all(v == 0 for v in out["launches_per_call"].values())
    assert max(out["diffs"].values()) <= smoke_scripts.GV_KERNEL_TOL
    assert set(out["times"]) == {"paint_s", "spectra_s", "boot_s"}
    assert out["peak_bytes"] == 0


def test_24b_pk_diagnose(phase):
    out = phase["pk_diagnose"]
    assert out["calls"] == 3
    assert set(out["per_z"]) == {"0", "0.125", "0.25"}
    assert max(out["share"].values()) <= 1.0
    for rows in out["per_z"].values():
        assert all(r["r"] <= 1 + smoke_scripts.R_SLACK for r in rows)


def test_24c_transform_examples(phase):
    modes = phase["transform_examples"]["report"]["modes"]
    assert len(modes) == 7


def test_24d_promote(phase):
    out = phase["promote"]
    assert sorted(out["manifest"]["files"]) == out["files"]
    assert {"model_state.msgpack", "model_meta.json", "report.md",
            "fidelity_report.json"} <= set(out["files"])


def test_launches_join_the_kernels_record(phase):
    record = {"kernels": [{"name": n, "dtype": d} for n in (
        "res_block_infer", "head_stack_fwd", "gather_tiles")
        for d in ("float32", "bfloat16")]}
    smoke_scripts.add_launches(record, phase)
    added = {(e["name"], e["dtype"]): e for e in record["kernels"]}
    k1 = added["res_block_infer", "bfloat16"]
    assert k1["gate_variance_calls"] == 2 and k1["pk_diagnose_calls"] == 3
    assert k1["gate_variance_launches_per_call"] == 0
    assert "gate_variance_calls" not in added["res_block_infer", "float32"]
    assert "gate_variance_calls" not in added["gather_tiles", "bfloat16"]
