"""chip_smoke.py's phases (baryon_painter_tpu_torch/smoke.py) on the CPU, and
the rules the smoke script and the port keep.

On the CPU the phases run the same control flow as on the card with the
kernels' plain versions: no build, each kernel compared with itself (error
0), the golden painted and the CVAE trained with 0 launches, host times. chip_smoke.py itself must fail,
printing no result, without a CUDA device or without the package beside it.
"""
import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from baryon_painter_tpu_torch import smoke
from golden_utils import REPO, golden_inputs

PORT = Path(REPO) / "baryon_painter_tpu_torch"
CHIP_SMOKE = Path(REPO) / "chip_smoke.py"
FORBIDDEN = ("jax", "jaxlib", "flax", "msgpack", "baryon_painter_tpu")


@pytest.fixture(scope="module")
def cpu_run():
    d = torch.device("cpu")
    env = smoke.environment(d)
    build = smoke.build_kernels(d)
    checks = smoke.check_kernels(d, shape=(2, 16, 16, 8))
    paint = smoke.paint_golden(d)
    timing = smoke.time_main_path(d, paint["painter"], n_tiles=2, warmup=0,
                                  iters=1, k1_shape=(2, 16, 16, 8),
                                  k1_iters=1)
    return env, build, checks, paint, timing


@pytest.fixture(scope="module")
def cpu_train_run():
    d = torch.device("cpu")
    ds = smoke.training_data(tile=32)
    gather = smoke.check_gather(d, ds, batch=4, iters=1)
    heads = smoke.check_heads(d, shape=(2, 32, 32), iters=1)
    training = smoke.train(d, ds, batch=2, warmup=1, iters=2,
                           n_res_blocks=1)
    parity = smoke.train_parity(d, ds, batch=2, n_res_blocks=1)
    fused_paint = smoke.paint_fused_heads(d, n_tiles=2, warmup=0, iters=1)
    return ds, gather, heads, training, parity, fused_paint


@pytest.fixture(scope="module")
def cpu_k4_run(cpu_train_run):
    d = torch.device("cpu")
    ds, _, _, training, _, _ = cpu_train_run
    conv_bn = smoke.check_conv_bn(d, batch=2, tile=32, iters=1)
    training_k4 = smoke.train(d, ds, batch=2, warmup=1, iters=2,
                              n_res_blocks=1, fused_train_conv=True,
                              k4_off_ms=training["step_ms"])
    parity_k4 = smoke.train_parity(d, ds, batch=2, n_res_blocks=1,
                                   fused_train_conv=True)
    return conv_bn, training_k4, parity_k4


def test_environment_and_build_phases_on_cpu(cpu_run):
    env, build, *_ = cpu_run
    assert env["nvidia_smi"] is None and env["kind"] == "cpu"
    assert env["cudnn_allow_tf32"] is False
    assert env["matmul_allow_tf32"] is False
    assert build["seconds"] is None


def test_kernel_check_phase_on_cpu(cpu_run):
    checks = cpu_run[2]
    assert [(c["dtype"], c["slope"]) for c in checks] == [
        ("float32", 0.0), ("float32", 0.2), ("bfloat16", 0.0)]
    assert all(c["max_abs_err"] == 0.0 for c in checks)


def test_golden_paint_phase_on_cpu(cpu_run):
    paint = cpu_run[3]
    assert paint["launches"] == 0  # the plain version launches nothing
    assert paint["worst_err_over_tol"] <= 1.0


def test_timing_phase_and_kernels_record(cpu_run, cpu_train_run,
                                         cpu_k4_run):
    _, _, checks, paint, timing = cpu_run
    _, gather, heads, training, _, _ = cpu_train_run
    conv_bn, training_k4, _ = cpu_k4_run
    assert timing["n_tiles"] == 2 and timing["paint_ms"] > 0
    rec = smoke.kernels_record(checks, paint, timing, gather, heads,
                               training, conv_bn, training_k4)
    json.dumps(rec)
    assert [k["name"] for k in rec["kernels"]] == [
        "res_block_infer", "gather_tiles", "head_stack_fwd",
        "head_stack_bwd", "conv_bn_stats", "conv_bn_fwd", "conv_bn_bwd1",
        "conv_bn_bwd2"]
    defs = {"res_block_infer": "def res_block_infer(",
            "gather_tiles": "def gather_tiles_pallas(",
            "head_stack_fwd": "def head_stack(",
            "head_stack_bwd": "def _head_stack_bwd(",
            "conv_bn_stats": "def _stats_kernel(",
            "conv_bn_fwd": "def _fwd_kernel(",
            "conv_bn_bwd1": "def _bwd1_kernel(",
            "conv_bn_bwd2": "def _bwd2_kernel("}
    for k in rec["kernels"]:
        for key in ("name", "route", "source", "replaces", "launches",
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms"):
            assert key in k, (k["name"], key)
        assert k["route"] == "cuda"
        assert k["bound_by"] in ("bytes", "operations")
        assert k["launches"] == 0 and k["max_abs_err"] == 0.0
        assert (Path(REPO) / k["source"]).is_file()
        path, line = k["replaces"].split(":")
        src = (Path(REPO) / path).read_text().splitlines()
        assert src[int(line) - 1].startswith(defs[k["name"]]), k["name"]


def test_training_phases_on_cpu(cpu_train_run):
    ds, gather, heads, training, parity, fused_paint = cpu_train_run
    # n_z * n_stack^2 * n_tile^4 * n_perm^2
    assert ds.tile_size == 32 and len(ds) == 2 * 2**2 * 2**4 * 8**2
    assert gather["shape"] == [4, 2, 2, 32, 32]
    assert set(heads["errors"]) == set(smoke.K3_TOL)
    assert all(v == 0.0 for v in heads["errors"].values())
    assert training["launches"] == {
        k: 0 for k in ("k1", "k2", "k3_fwd", "k3_bwd", "k4_stats", "k4_fwd",
                       "k4_bwd1", "k4_bwd2")}
    assert training["step_ms"] > 0 and len(training["elbo"]) == 2
    assert parity["loss_rel_err"] <= smoke.STEP_LOSS_RTOL
    assert parity["worst_grad_rel_err"] <= smoke.STEP_GRAD_TOL
    assert fused_paint["launches"] == fused_paint["k3_fwd_launches"] == 0
    assert fused_paint["worst_err_over_tol"] <= 1.0


def test_k4_phases_on_cpu(cpu_k4_run):
    """Phase 10 at every site (the plain pieces against the whole plain
    version: equal), phase 11 with K4 on (no launches on the CPU), phase
    11b within its tolerances, with the parameters under the gradient floor
    reported and the analytically zero ones among them."""
    conv_bn, training_k4, parity_k4 = cpu_k4_run
    assert list(conv_bn["sites"]) == ["A", "B", "C", "D"]
    for rec in conv_bn["sites"].values():
        assert set(rec["errors"]) == set(smoke.K4_TOL)
        assert all(v == 0.0 for v in rec["errors"].values())
        assert set(rec["ms"]) == set(smoke.K4_KERNELS)
        assert rec["library_fwd_ms"] > 0 and rec["library_bwd_ms"] > 0
    assert set(training_k4["launches"].values()) == {0}
    assert parity_k4["loss_rel_err"] <= smoke.STEP_LOSS_RTOL
    assert parity_k4["worst_grad_rel_err"] <= smoke.STEP_GRAD_TOL
    assert set(smoke.STEP_GRAD_ZERO) <= set(parity_k4["under_floor"])
    assert set(parity_k4["witness"]) == {"kernels_vs_plain",
                                         "plain_sites_vs_sites_f64",
                                         "kernels_vs_sites_f64"}


@pytest.mark.parametrize("site,gflop", [("A", 15.1), ("B", 25.8),
                                        ("C", 25.8), ("D", 25.8)])
def test_k4_sites_and_bounds_at_the_training_shape(site, gflop):
    """The four sites of the fiducial step at batch 24: one
    conv pass's logical GFLOP; each kernel bound by operations."""
    b = smoke.k4_bounds(smoke.K4_SITES[site], smoke.TRAIN_BATCH,
                        smoke.TRAIN_TILE)
    assert b["conv_flops"] / 1e9 == pytest.approx(gflop, abs=0.05)
    for k in smoke.K4_KERNELS:
        assert b[k]["bound_by"] == "operations"
    assert b["bwd2"]["flops"] > 3 * b["conv_flops"]
    # the fused op as a whole: one conv pass forward, two backward
    assert b["logical_fwd"]["bound_ms"] == b["fwd"]["bound_ms"]
    assert 2 * b["conv_flops"] < b["logical_bwd"]["flops"] \
        < b["bwd2"]["flops"]
    assert smoke.k4_sites_per_step(512) == 4
    assert smoke.k4_sites_per_step(32) == 3


def test_tf32_phase_on_cpu():
    before = torch.backends.cudnn.allow_tf32
    out = smoke.paint_tf32(torch.device("cpu"))
    assert out["pinned"] <= 1.0 and out["library_default"] <= 1.0
    assert torch.backends.cudnn.allow_tf32 is before


def test_step_gradient_floor_covers_only_the_named_parameters():
    grads_p = {"big": torch.tensor([10.0]), "small": torch.tensor([1e-3]),
               smoke.STEP_GRAD_ZERO[0]: torch.tensor([1e-6])}
    grads_k = {"big": torch.tensor([10.0]), "small": torch.tensor([1.1e-3]),
               smoke.STEP_GRAD_ZERO[0]: torch.tensor([2e-6])}
    errs, under, top = smoke.step_grad_errors(grads_k, grads_p)
    assert top == 10.0 and set(under) == {"small", smoke.STEP_GRAD_ZERO[0]}
    # the small gradient is held to its own largest entry, not the floor
    assert errs["small"] == pytest.approx(0.1)
    assert errs[smoke.STEP_GRAD_ZERO[0]] == pytest.approx(1e-6 / 1e-2)


def test_training_data_is_the_bench_configuration():
    """bench.py:100-108: 2 stacks of 1024^2 at z = 0 and 1, 2 x 2 tiles of
    512^2 a side, dihedral permutations, shift-log(4) on both fields."""
    import inspect
    src = inspect.getsource(smoke.training_data)
    for text in ("n_stack=2", "n_grid=2 * tile", "redshifts=(0.0, 1.0)",
                 "seed=0", "n_tile=2", "tile_permutations=True",
                 'RangeCompress("shift-log", 4.0)'):
        assert text in src, text
    assert smoke.TRAIN_TILE == 512 and smoke.TRAIN_BATCH == 24
    assert smoke.N_RES_BLOCKS == 4


def test_launch_counts_are_checked_on_every_path():
    with pytest.raises(AssertionError, match="kernel launches"):
        smoke._expect_launches("train", {"k1": 0, "k2": 1},
                               {"k1": 0, "k2": 2})


def test_k1_bound_at_the_main_path_shape():
    """38.7 GFLOP per launch at (16, 64, 64, 128): >= 0.58 ms in f32 on the
    CUDA cores, >= 39 us in bf16 on the tensor cores; bound by operations."""
    f32 = smoke.k1_bound(smoke.K1_SHAPE, torch.float32)
    bf16 = smoke.k1_bound(smoke.K1_SHAPE, torch.bfloat16)
    assert f32["flops"] == 2 * 2 * 16 * 64 * 64 * 128 * 128 * 9
    assert f32["bound_by"] == bf16["bound_by"] == "operations"
    assert f32["bound_ms"] == pytest.approx(0.5769, rel=1e-3)
    assert bf16["bound_ms"] == pytest.approx(0.0391, rel=1e-2)


def test_library_block_is_the_same_function():
    args = smoke.k1_inputs((2, 8, 8, 8), torch.float32, "cpu")
    x, w1, s1, b1, w2, s2, b2 = args
    lib = smoke.library_block(x.permute(0, 3, 1, 2), w1.permute(3, 2, 0, 1),
                              s1, b1, w2.permute(3, 2, 0, 1), s2, b2)
    from baryon_painter_tpu_torch.ops.res_block import res_block_infer_ref
    ref = res_block_infer_ref(*args)
    torch.testing.assert_close(lib.permute(0, 2, 3, 1), ref, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("tile,n", [(64, 2), (512, 1)])
def test_port_copy_of_golden_inputs(tile, n):
    np.testing.assert_array_equal(smoke.golden_inputs(tile, n),
                                  golden_inputs(tile, n))


def _run_chip_smoke(cwd):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=120)


def test_chip_smoke_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    proc = _run_chip_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(CHIP_SMOKE, tmp_path / "chip_smoke.py")
    proc = _run_chip_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize(
    "path", sorted(PORT.rglob("*.py")) + [CHIP_SMOKE],
    ids=lambda p: str(Path(p).relative_to(REPO)))
def test_port_imports_nothing_of_jax(path):
    for name in _imports(path):
        assert name.split(".")[0] not in FORBIDDEN, (path, name)
        assert not name.startswith(("tests", "golden_utils")), (path, name)


def test_chip_smoke_imports_only_torch_numpy_and_the_port():
    allowed = {"json", "sys", "time", "torch", "numpy",
               "baryon_painter_tpu_torch"}
    for name in _imports(CHIP_SMOKE):
        assert name.split(".")[0] in allowed, name


def test_painter_and_trainer_pin_f32_convolutions(monkeypatch):
    """On the card PyTorch runs cuDNN convolutions in TF32 unless told
    otherwise; painted at that setting the 512^2 golden misses its
    tolerance (chip_smoke.py phase 12), so the painter and the trainer set
    cuDNN's TF32 switch off inside their own calls and restore the
    caller's. The painter's inner ``_paint_batch``, which phase 12 calls
    for the record, runs under the caller's setting."""
    from baryon_painter_tpu_torch.painter import CVAEPainter
    from baryon_painter_tpu_torch.utils.platform import f32_convolutions
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    with f32_convolutions():
        assert torch.backends.cudnn.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is True
    seen = []
    painter = CVAEPainter(str(Path(REPO) / smoke.CHECKPOINT), device="cpu")
    decode = painter.model.sample_P
    monkeypatch.setattr(painter.model, "sample_P", lambda *a, **k: (
        seen.append(torch.backends.cudnn.allow_tf32), decode(*a, **k))[1])
    tiles, zs = golden_inputs(512, 1), np.zeros(1, np.float32)
    painter.paint_batch(tiles, zs)
    assert torch.backends.cudnn.allow_tf32 is True
    with torch.inference_mode():
        painter._paint_batch(tiles, zs, True, True, False, None, "sample",
                             None)
    ds = smoke.training_data(tile=32)
    trainer = smoke.make_trainer("cpu", ds, False, n_res_blocks=1)
    forward = trainer.model.forward
    monkeypatch.setattr(trainer.model, "forward", lambda *a, **k: (
        seen.append(torch.backends.cudnn.allow_tf32), forward(*a, **k))[1])
    trainer.step_indices(ds.sample_indices(np.random.default_rng(0), 2),
                         1e-3)
    assert seen == [False, True, False]
    assert torch.backends.cudnn.allow_tf32 is True
