"""Phase 20 of ``chip_smoke.py`` on the CPU, at small sizes: the gate on the
committed CGANs (fiducial and fiducial-adv) and fiducial CVAE (2 tiles a
redshift; the kernels are
their plain versions here, so the kernels-against-plain distance is the
plain convolutions' against themselves with cuDNN's switch off), the
spectral step at 32^2 from the fiducial weights with its parity rules,
and their launches on the kernels record (0 on the CPU)."""
import numpy as np
import pytest
import torch

from baryon_painter_tpu_torch import smoke

CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One PyTorch thread a process: the suite's other workers load every
    core, and a thread pool per process then runs this file's many small
    CPU ops many times slower than it does alone."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def gate_run():
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(smoke, "GATE_TILES", 2)
        return {"cvae": smoke.gate_check(
                    CPU, smoke.CHECKPOINT, {"k1": 4, "k3_fwd": 1}, "cvae",
                    fallback=smoke.GATE_CVAE_DATASET, redshifts="0",
                    seeds=2),
                "cgan": smoke.gate_check(CPU, smoke.CGAN_PATH, {"k1": 9},
                                         "cgan", seeds=1, phase="20b"),
                "cgan_adv": smoke.gate_check(CPU, smoke.CGAN_ADV_PATH,
                                             {"k1": 9}, "cgan_adv", seeds=1,
                                             phase="20b")}


def test_gate_phase_on_cpu(gate_run):
    cvae, cgan = gate_run["cvae"], gate_run["cgan"]
    assert set(cvae["launches"].values()) == {0}
    row = cvae["rows"]["0/auto"]
    assert row["kernels_vs_plain"] <= smoke.GATE_KERNEL_TOL
    assert row["committed_f32"] == 0.0359
    assert row["bf16_limit"] == max(
        smoke.GATE_FLOOR, abs(row["jax_f32"] - row["jax_bf16_pinned"]),
        abs(row["jax_bf16_jit"] - row["jax_bf16_pinned"]))
    assert set(cvae["summary"]) == {"f32", "model"}
    z0 = cvae["summary"]["f32"]["0"]["auto"]
    assert len(z0["values"]) == 2 and z0["committed"] == 0.0359
    assert z0["limit"] == max(smoke.GATE_SIGMA * z0["std"], smoke.GATE_FLOOR)
    assert set(cgan["summary"]["model"]) == {"0", "0.5", "1"}
    assert cgan["summary"]["f32"]["1"]["cross"]["std"] == 0.0
    assert set(cgan["rows"]) == {f"{z}/{k}" for z in ("0", "0.5", "1")
                                 for k in ("auto", "cross")}
    assert all(v > 0 for v in cvae["eval_s"].values())


def test_gate_reference_is_the_jax_noise_and_the_committed_f32():
    """The reference's noise is each CVAE's JAX painter's draw of
    PRNGKey(0) (f32 and bf16) at its latent's shape, and its f32 readings
    are the committed reports': to their 4 decimals (1e-4) for the
    fiducial CVAE (all 11 redshifts) and both CGANs (3 each); within the
    gate's own f32 floor (``smoke.GATE_FLOOR``, 20a's rule) for the three
    CVAEs that phase 20d adds, whose heavy-tailed physical statistics the
    CPU's f32 reads up to 3.2e-4 from the TPU's."""
    import json
    import os

    import jax
    import jax.numpy as jnp

    from baryon_painter_tpu.painter import CVAEPainter
    from golden_utils import REPO
    ref = smoke._gate_reference()
    for prefix, path, _, _ in smoke.GATE_BF16_CASES:
        p = CVAEPainter(os.path.join(REPO, path), dtype=None)
        key = p.model.apply(p.variables,
                            method=lambda m: m.make_rng("sample"),
                            rngs={"sample": jax.random.PRNGKey(0)})
        h = p.meta["tile_size"] // 32
        for dtype, name in ((jnp.float32, "f32"), (jnp.bfloat16, "bf16")):
            want = jax.random.normal(key, (1, 48, h, h, 1), dtype)
            np.testing.assert_array_equal(
                ref[f"{prefix}_eps_{name}"],
                np.asarray(want[0, ..., 0], np.float32))
    cases = [("cvae", smoke.CHECKPOINT, 11, 1e-4),
             ("cgan", smoke.CGAN_PATH, 3, 1e-4),
             ("cgan_adv", smoke.CGAN_ADV_PATH, 3, 1e-4)]
    cases += [(prefix, path, len(zs), smoke.GATE_FLOOR)
              for prefix, path, _, zs in smoke.GATE_BF16_CASES[1:]]
    for kind, path, n, atol in cases:
        with open(os.path.join(REPO, os.path.dirname(path),
                               "fidelity_report.json")) as f:
            committed = json.load(f)["per_z_by_dtype"]["f32"]
        zs = [k.split("_z")[1] for k in ref if k.startswith(f"{kind}_f32_z")]
        assert len(zs) == n
        for z in zs:
            got = ref[f"{kind}_f32_z{z}"]
            want = [committed[z]["auto"], committed[z]["cross"]]
            np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.fixture(scope="module")
def pk_run():
    ds = smoke.training_data(tile=32)
    return smoke.pk_step(CPU, ds, batch=4, warmup=1, iters=2)


def test_pk_step_phase_on_cpu(pk_run):
    for dtype in ("float32", "bfloat16"):
        run = pk_run[dtype]
        assert set(run["launches"].values()) == {0}
        assert len(run["pk_loss"]) == 2
        assert all(np.isfinite(v) and v > 0 for v in run["pk_loss"])
    parity = pk_run["parity"]
    # on the CPU both sides are the plain versions
    assert parity["loss_rel_err"] <= smoke.PK_LOSS_RTOL
    assert parity["worst_grad_rel_err"] <= smoke.STEP_GRAD_TOL
    assert parity["bf16_ratio"] <= smoke.BF16_STEP_RATIO
    assert parity["bf16_d_plain_bf16_f32"] > 0


def test_gate_and_pk_launches_on_the_kernels_record(gate_run, pk_run):
    entries = [{"name": n, "dtype": d} for n in (
        "res_block_infer", "gather_tiles", "head_stack_fwd", "head_stack_bwd",
        "conv_bn_fwd") for d in ("float32", "bfloat16")]
    smoke._add_gate_launches(entries, gate_run, pk_run)
    by_name = {(k["name"], k["dtype"]): k for k in entries}
    assert by_name["res_block_infer", "float32"]["gate_launches"] == 0
    assert by_name["res_block_infer", "float32"]["gate_cgan_launches"] == 0
    assert by_name["res_block_infer", "float32"][
        "gate_cgan_adv_launches"] == 0
    assert by_name["head_stack_fwd", "float32"]["gate_launches"] == 0
    for name in ("gather_tiles", "head_stack_fwd", "head_stack_bwd"):
        for dtype in ("float32", "bfloat16"):
            assert by_name[name, dtype]["pk_step_launches"] == 0
    assert "pk_step_launches" not in by_name["conv_bn_fwd", "float32"]
    assert "gate_launches" not in by_name["res_block_infer", "bfloat16"]
