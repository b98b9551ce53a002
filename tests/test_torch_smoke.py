"""chip_smoke.py's phases (baryon_painter_tpu_torch/smoke.py) on the CPU, and
the rules the smoke script and the port keep.

On the CPU the phases run the same control flow as on the card with the
kernel's plain version: no build, K1 compared with itself (error 0), the
golden painted with 0 launches, host times. chip_smoke.py itself must fail,
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


def test_timing_phase_and_kernels_record(cpu_run):
    _, _, checks, paint, timing = cpu_run
    assert timing["n_tiles"] == 2 and timing["paint_ms"] > 0
    rec = smoke.kernels_record(checks, paint, timing)
    json.dumps(rec)
    (k,) = rec["kernels"]
    for key in ("name", "route", "source", "replaces", "launches",
                "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                "library_ms"):
        assert key in k, key
    assert k["route"] == "cuda" and k["bound_by"] in ("bytes", "operations")
    assert (Path(REPO) / k["source"]).is_file()
    path, line = k["replaces"].split(":")
    src = (Path(REPO) / path).read_text().splitlines()
    assert src[int(line) - 1].startswith("def res_block_infer(")


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
