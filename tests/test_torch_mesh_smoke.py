"""Phase 23 of chip_smoke.py (``baryon_painter_tpu_torch/smoke_mesh.py``)
run on the CPU at a small size, so that its control flow, its rank
processes and its checks are exercised before the card runs them: the
kernels' plain versions (no launches), gloo in place of NCCL for 23a,
tiles of 32^2 and one residual block for 23a and 23b, a cut-down synthetic
line of sight for 23c (tests/test_torch_lightcone_cli.py's) and a 128^2
plane for 23d."""
import pytest
import torch

from baryon_painter_tpu_torch import smoke, smoke_mesh

CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def dataset():
    return smoke.training_data(32)


def test_23a_world_of_one_is_bit_exact(dataset):
    out = smoke_mesh.world_of_one(CPU, dataset, batch=4, n_res_blocks=1,
                                  backend="gloo")
    assert out["launches"] == {k: 0 for k in out["launches"]}


def test_23b_two_ranks_against_f64(dataset):
    out = smoke_mesh.two_ranks(CPU, dataset, batch=4, n_res_blocks=1)
    assert len(out["ranks"]) == 2
    assert out["loss_rel_err"] <= smoke.STEP_LOSS_RTOL
    assert out["limit_share"] <= 1.0
    assert out["leaf_share_envelope"] <= 1.0
    assert all(r["samples_per_s"] > 0 for r in out["ranks"])


def test_23c_sharded_lightcone():
    with smoke.synthetic_lightcone(CPU, z=(0.042, 0.221), n_pixel_delta=300,
                                   n_pixel_massplane=400,
                                   resolution=96) as data:
        out = smoke_mesh.lightcone_sharded(CPU, data)
    assert max(out["planes_err_over_tol"]) <= 1.0


def test_23d_sharded_planes():
    out = smoke_mesh.planes_sharded(CPU, n=128)
    assert set(out) == {"cvae_2", "cvae_3", "cgan_2", "cgan_3"}
    assert all(v["err_over_tol"] <= 1.0 for v in out.values())
