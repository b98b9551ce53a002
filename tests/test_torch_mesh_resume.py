"""A data-parallel ``CVAETrainer.train()`` resumed from rank 0's checkpoint
equals the uninterrupted data-parallel run, on 2 gloo ranks on the CPU.

tests/test_torch_train_loop.py's resume run (batches of 2 then 4, the
reactive learning-rate schedule fed the training ELBO's moving average,
validation, a checkpoint every 8 samples) under a ``ProcessMesh``, through
the z-sharded stack cache and on host batches. Held: the resumed run's
statistics files equal the uninterrupted run's byte for byte and every
rank's final state (parameters, batch statistics, Adam, step, data RNG,
the schedule's state) equals the uninterrupted run's bit for bit, on every
rank alike. Only rank 0 writes (``save`` returns the bytes it wrote there,
0 on the other rank), and the JAX package's reader loads the checkpoint.
"""

import jax
import numpy as np
import pytest

from baryon_painter_tpu.train import checkpoint as jckpt
from baryon_painter_tpu_torch.convert import init_cvae, to_jax_variables
from baryon_painter_tpu_torch.data.synthetic import make_synthetic_stacks
from baryon_painter_tpu_torch.models.cvae import CVAE
from torch_mesh_workers import TILE, cvae_arch, run_ranks

STATE_KEYS = ("params", "batch_stats", "opt_state", "step", "data_rng",
              "lr_sched")


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("stacks"))
    info = make_synthetic_stacks(root, n_stack=2, n_grid=2 * TILE,
                                 redshifts=(0.0, 1.0), seed=0)
    model = CVAE(cvae_arch())
    init_cvae(model, 7)
    return root, info, to_jax_variables(model)


@pytest.mark.parametrize("cache", [True, False],
                         ids=["z_sharded_cache", "host_data"])
def test_dp_resume_equals_the_uninterrupted_run(data, tmp_path, cache):
    root, info, variables = data
    full, resumed = tmp_path / "full", tmp_path / "resumed"
    ranks = run_ranks("cvae_resume", 2, tmp_path, dict(
        root=root, info=info, variables=variables, cache=cache,
        full=str(full), resumed=str(resumed), extra=str(tmp_path)),
        timeout=150)
    assert ranks[0]["progress"]["n_samples"] == 8
    for fn in ("training_stats.txt", "validation_stats.txt"):
        assert (resumed / fn).read_bytes() == (full / fn).read_bytes(), fn
    for r in ranks:
        for key in STATE_KEYS:
            jax.tree.map(np.testing.assert_array_equal, r["resumed"][key],
                         r["whole"][key])
            jax.tree.map(np.testing.assert_array_equal, r["whole"][key],
                         ranks[0]["whole"][key])
    # written once, by rank 0, and the JAX package reads it
    assert ranks[0]["save_bytes"] > 0 and ranks[1]["save_bytes"] == 0
    raw, meta = jckpt.load_checkpoint(str(full / "model"))
    jax.tree.map(np.testing.assert_array_equal, dict(raw["params"]),
                 ranks[0]["whole"]["params"])
    assert int(raw["step"]) == int(ranks[0]["whole"]["step"])
    assert meta["model_architecture"]["n_x_features"] == 1
