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
def cpu_run():
    d = torch.device("cpu")
    env = smoke.environment(d)
    build = smoke.build_kernels(d)
    checks = smoke.check_kernels(d, shape=(2, 16, 16, 8),
                                 edges=((1, 13, 21, 4), (1, 3, 5, 12)))
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


@pytest.fixture(scope="module")
def cpu_bf16_run(cpu_train_run):
    d = torch.device("cpu")
    ds, _, _, training, _, fused_paint = cpu_train_run
    heads = smoke.check_heads(d, shape=(2, 32, 32), iters=1,
                              dtype=torch.bfloat16)
    training_bf16 = smoke.train(d, ds, batch=2, warmup=1, iters=2,
                                n_res_blocks=1, dtype=torch.bfloat16,
                                f32_ms=training["step_ms"])
    parity = smoke.train_parity_bf16(d, ds, batch=2, n_res_blocks=1)
    paint = smoke.paint_bf16(d, n_tiles=1, warmup=0, iters=1,
                             f32_ms=fused_paint["paint_ms"])
    return heads, training_bf16, parity, paint


@pytest.fixture(scope="module")
def cpu_bf16_k4_run(cpu_train_run, cpu_k4_run, cpu_bf16_run):
    """Phases 10b, 15 and 15b at 32^2 (three fused sites a step)."""
    d = torch.device("cpu")
    ds = cpu_train_run[0]
    training_k4 = cpu_k4_run[1]
    training_bf16 = cpu_bf16_run[1]
    conv_bn = smoke.check_conv_bn(d, batch=2, tile=32, iters=1,
                                  dtype=torch.bfloat16)
    training = smoke.train(d, ds, batch=2, warmup=1, iters=2,
                           n_res_blocks=1, dtype=torch.bfloat16,
                           fused_train_conv=True,
                           k4_off_ms=training_bf16["step_ms"],
                           f32_ms=training_k4["step_ms"])
    parity = smoke.train_parity_bf16(d, ds, batch=2, n_res_blocks=1,
                                     fused_train_conv=True)
    return conv_bn, training, parity


def test_environment_and_build_phases_on_cpu(cpu_run):
    env, build, *_ = cpu_run
    assert env["nvidia_smi"] is None and env["kind"] == "cpu"
    assert env["cudnn_allow_tf32"] is False
    assert env["matmul_allow_tf32"] is False
    assert build["seconds"] is None


def test_kernel_check_phase_on_cpu(cpu_run):
    """Phase 2: the main path's shape first, then each edge shape, each in
    K1_CASES' four (dtype, slope) cases; on the card the edges are the
    design's (N = 1 and the gate's 192, ragged tiles, C = 4, 12, 124,
    128)."""
    checks = cpu_run[2]
    cases = [("float32", 0.0), ("float32", 0.2), ("bfloat16", 0.0),
             ("bfloat16", 0.2)]
    assert [(c["dtype"], c["slope"]) for c in checks] == cases * 3
    assert [tuple(c["shape"]) for c in checks[::4]] == [
        (2, 16, 16, 8), (1, 13, 21, 4), (1, 3, 5, 12)]
    assert all(c["max_abs_err"] == 0.0 for c in checks)
    assert smoke.K1_EDGE_SHAPES == ((1, 13, 21, 4), (1, 13, 21, 12),
                                    (1, 13, 21, 124), (1, 13, 21, 128),
                                    (192, 64, 64, 128))


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
    # K1 timed with its operands made ahead and made on every call
    for key in ("float32", "bfloat16"):
        assert timing[f"k1_ms_{key}"] > 0
        assert timing[f"k1_per_call_ms_{key}"] > 0
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
    by_name = {k["name"]: k for k in rec["kernels"]}
    assert by_name["res_block_infer"]["bf16_library_ms"] > 0
    for name in ("res_block_infer", "head_stack_fwd", "head_stack_bwd",
                 "conv_bn_stats", "conv_bn_fwd", "conv_bn_bwd1",
                 "conv_bn_bwd2"):
        # the bound of the kernel's design (the tensor cores; K4-fwd:
        # memory), the f32 CUDA-core one beside it
        k = by_name[name]
        assert k["bound_ms"] > 0 and k["bound_ms_f32_cuda_cores"] > 0, name
    # K3-fwd is timed keeping u1, as the training steps run it; painting's
    # variant (no u1) beside it
    fwd = by_name["head_stack_fwd"]
    assert fwd["ms_without_u1"] > 0 and fwd["u1_max_abs_err"] == 0.0
    # K4's record: the sums of the design bounds of phase 10's sites
    sites = conv_bn["sites"].values()
    for k in smoke.K4_KERNELS:
        entry = by_name[f"conv_bn_{k}"]
        assert entry["bound_ms"] == pytest.approx(sum(
            r["bounds"][smoke.K4_BOUND[k]]["bound_ms"] for r in sites))
        assert entry["bound_ms_f32_cuda_cores"] == pytest.approx(sum(
            r["bounds"][k]["bound_ms"] for r in sites))
    assert by_name["conv_bn_stats"]["u_vs_bwd1_max_abs"] == 0.0
    assert by_name["conv_bn_fwd"]["library_covers"] == "stats+fwd"


def test_bf16_phases_and_kernels_record_on_cpu(cpu_run, cpu_train_run,
                                               cpu_k4_run, cpu_bf16_run):
    """Phases 7b, 13, 13b and 14 on the CPU (the plain versions: K3 against
    itself, no launches, the kernels and plain bf16 steps equal, the
    committed JAX bf16 reference met) and the kernels record with the bf16
    entries: K1 with its bf16 paint launches, K3-fwd and K3-bwd with their
    bf16 training launches, every entry with its dtype and the keys of the
    record."""
    _, _, checks, paint, timing = cpu_run
    _, gather, heads, training, _, _ = cpu_train_run
    conv_bn, training_k4, _ = cpu_k4_run
    heads_bf16, training_bf16, parity, paint_bf16 = cpu_bf16_run
    assert heads_bf16["dtype"] == "bfloat16"
    assert set(heads_bf16["errors"]) == set(smoke.K3_TOL_BF16)
    assert all(v == 0.0 for v in heads_bf16["errors"].values())
    assert heads_bf16["fwd_tc_bound"] == smoke.k3_bounds(
        2, 32, 32, dtype=torch.bfloat16)["fwd_tc"]
    assert training_bf16["dtype"] == "bfloat16"
    assert all(v == 0 for v in training_bf16["launches"].values())
    assert set(training_bf16["bf16_launches"]) == {
        "k1", "k3_fwd", "k3_bwd", "k4_stats", "k4_fwd", "k4_bwd1",
        "k4_bwd2"}
    assert set(training_bf16["bf16_launches"].values()) == {0}
    assert parity["d_kernels_plain"] == 0.0 and parity["ratio"] == 0.0
    assert parity["d_plain_bf16_f32"] > 1e-3
    assert paint_bf16["d_jax_bf16"] <= paint_bf16["limit"]
    rec = smoke.kernels_record(checks, paint, timing, gather, heads,
                               training, conv_bn, training_k4,
                               heads_bf16=heads_bf16, paint_bf16=paint_bf16,
                               training_bf16=training_bf16)
    json.dumps(rec)
    names = [(k["name"], k["dtype"]) for k in rec["kernels"]]
    assert names[-3:] == [("res_block_infer", "bfloat16"),
                          ("head_stack_fwd", "bfloat16"),
                          ("head_stack_bwd", "bfloat16")]
    assert all(d == "float32" for _, d in names[:-3])
    for k in rec["kernels"]:
        for key in ("name", "route", "source", "replaces", "launches",
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms"):
            assert key in k, (k["name"], key)
    k1 = rec["kernels"][-3]
    assert k1["bound_ms"] == timing["bound_bfloat16"]["tc"]["bound_ms"]
    assert k1["plain_ms"] == timing["plain_ms_bfloat16"] > 0
    for k in rec["kernels"][-2:]:
        assert k["bound_ms"] > 0 and k["launches"] == 0


def test_bf16_k4_phases_and_kernels_record_on_cpu(cpu_run, cpu_train_run,
                                                  cpu_k4_run, cpu_bf16_run,
                                                  cpu_bf16_k4_run):
    """Phases 10b, 15 and 15b on the CPU (the plain bf16 versions against
    themselves, no launches, the kernels and plain bf16 steps with K4
    equal) and the kernels record with K4's four bf16 entries last, each
    with its dtype, its bound on the bf16 tensor cores (fwd: memory) and
    the library yardstick on fwd and bwd2."""
    _, _, checks, paint, timing = cpu_run
    _, gather, heads, training, _, _ = cpu_train_run
    conv_bn, training_k4, _ = cpu_k4_run
    heads_bf16, training_bf16, _, paint_bf16 = cpu_bf16_run
    conv_bn_bf16, training_bf16_k4, parity = cpu_bf16_k4_run
    assert conv_bn_bf16["dtype"] == "bfloat16"
    for rec in conv_bn_bf16["sites"].values():
        assert set(rec["errors"]) == set(smoke.K4_TOL_BF16)
        assert all(v == 0.0 for v in rec["errors"].values())
        assert rec["u_stats_vs_bwd1"] == 0.0 and rec["y_differs"] == 0.0
        assert rec["library_fwd_ms"] > 0 and rec["library_bwd_ms"] > 0
    assert training_bf16_k4["dtype"] == "bfloat16"
    assert set(training_bf16_k4["launches"].values()) == {0}
    assert set(training_bf16_k4["bf16_launches"].values()) == {0}
    assert parity["d_kernels_plain"] == 0.0 and parity["ratio"] == 0.0
    assert parity["d_plain_bf16_f32"] > 1e-3
    assert parity["d_cudnn_heads_plain"] is None
    # the chaos floor: the sites' sums in another order move the step
    assert 0 < parity["d_order"] < parity["d_plain_bf16_f32"]
    assert parity["order_ratio"] == parity["d_order"] / parity[
        "d_plain_bf16_f32"]
    rec = smoke.kernels_record(
        checks, paint, timing, gather, heads, training, conv_bn, training_k4,
        heads_bf16=heads_bf16, paint_bf16=paint_bf16,
        training_bf16=training_bf16, conv_bn_bf16=conv_bn_bf16,
        training_bf16_k4=training_bf16_k4)
    json.dumps(rec)
    names = [(k["name"], k["dtype"]) for k in rec["kernels"]]
    assert names[-4:] == [(f"conv_bn_{k}", "bfloat16")
                          for k in smoke.K4_KERNELS]
    assert len(names) == 15
    sites = conv_bn_bf16["sites"].values()
    for k in smoke.K4_KERNELS:
        entry = rec["kernels"][-4 + smoke.K4_KERNELS.index(k)]
        for key in ("name", "route", "source", "replaces", "launches",
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "library_ms"):
            assert key in entry, (k, key)
        assert entry["replaces"] == smoke.K4_REPLACES[k]
        assert entry["source"] == smoke.K4_SOURCE
        assert entry["bound_ms"] == pytest.approx(sum(
            r["bounds"][smoke.K4_BOUND[k]]["bound_ms"] for r in sites))
        assert entry["launches"] == 0 and entry["max_abs_err"] == 0.0
        assert (entry["library_ms"] is None) == (k in ("stats", "bwd1"))


@pytest.mark.parametrize("site", ["A", "B", "C", "D"])
def test_k4_bf16_bounds_at_the_training_shape(site):
    """In bf16 the GEMMs are bounded at the bf16 tensor-core rate and x,
    y, dy, dx and w move 2 bytes an element, u and the partials 4: below
    the f32 design bounds, and bound by memory at every site."""
    s = smoke.K4_SITES[site]
    b32 = smoke.k4_bounds(s, smoke.TRAIN_BATCH, smoke.TRAIN_TILE)
    b16 = smoke.k4_bounds(s, smoke.TRAIN_BATCH, smoke.TRAIN_TILE,
                          torch.bfloat16)
    assert b16["conv_flops"] == b32["conv_flops"]
    sh = smoke.k4_site_shape(s, smoke.TRAIN_BATCH, smoke.TRAIN_TILE)
    out = smoke.TRAIN_BATCH * sh["ho"] ** 2 * s["cout"]
    assert b16["fwd_tc"]["bytes"] == 6 * out          # u read, y written
    assert b32["fwd_tc"]["bytes"] == 8 * out
    for k in smoke.K4_KERNELS:
        tc = smoke.K4_BOUND[k]
        assert b16[tc]["bytes"] < b32[tc]["bytes"], k
        assert b16[tc]["bound_ms"] < b32[tc]["bound_ms"], k
        assert b16[tc]["bound_by"] == "bytes", k


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
    assert training["peak_bytes"] is None   # a device number: card only
    assert parity["loss_rel_err"] <= smoke.STEP_LOSS_RTOL
    assert parity["worst_grad_rel_err"] <= smoke.STEP_GRAD_TOL
    assert parity["reference"] == "plain" and parity["witness"] == {}
    assert parity["grad_limit"] == smoke.STEP_GRAD_TOL
    assert parity["f64"]["kernels"]["limit_share"] <= 1.0
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
        assert set(rec["errors_kink_zeroed"]) == {"dx", "dw", "dgamma",
                                                  "dbeta"}
        assert all(v == 0.0 for v in rec["errors_kink_zeroed"].values())
        assert rec["bwd_peak_bytes"] == 0 and rec["u_bytes"] > 0
        # stats' u is bwd1's; the peaks are device numbers (0 on the CPU)
        assert rec["u_stats_vs_bwd1"] == 0.0 and rec["fwd_peak_bytes"] == 0
        assert set(rec["ms"]) == set(smoke.K4_KERNELS)
        assert rec["library_fwd_ms"] > 0 and rec["library_bwd_ms"] > 0
    assert set(training_k4["launches"].values()) == {0}
    assert parity_k4["loss_rel_err"] <= smoke.STEP_LOSS_RTOL
    assert parity_k4["worst_grad_rel_err"] <= smoke.STEP_GRAD_TOL
    assert set(smoke.STEP_GRAD_ZERO) <= set(parity_k4["under_floor"])
    # 11b holds the step to the one whose sites' forward is f64, within
    # STEP_GRAD_TOL or the plain step's own distance from it
    assert parity_k4["reference"] == "sites_f64"
    assert parity_k4["grad_limit"] == max(
        smoke.STEP_GRAD_TOL, parity_k4["witness"]["plain_sites_vs_sites_f64"])
    assert set(parity_k4["witness"]) == {"plain_sites_vs_sites_f64",
                                         "kernels_vs_plain"}
    assert parity_k4["f64"]["kernels"]["limit_share"] <= 1.0


def test_step_parity_witness_script_on_cpu():
    """``scripts/step_parity_witness.py`` at a tiny size on the CPU: every
    comparison read, finite, and (K4 being its plain version here) far
    under STEP_GRAD_TOL."""
    out = subprocess.run(
        [sys.executable, "scripts/step_parity_witness.py", "--cpu", "--tile",
         "32", "--batch", "2", "--n-res-blocks", "1"], cwd=REPO,
        capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["card"] is None and got["tile"] == 32
    assert set(got["readings"]) == {
        "kernels_vs_plain_k4_active", "plain_sites_vs_sites_stats_f64",
        "plain_sites_vs_sites_f64", "kernels_vs_sites_f64",
        "kernels_vs_plain_sites"}
    assert all(0 <= v <= smoke.STEP_GRAD_TOL
               for v in got["readings"].values())


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
    # the forward as its kernels compute it: stats one conv pass at the
    # 3xTF32 rate (x read, u and the partials written), bound by memory at
    # A and D; fwd a pass over u in place, bound by memory everywhere
    want_stats = {"A": 0.143, "B": 0.156, "C": 0.157, "D": 0.181}
    want_fwd = {"A": 0.240, "B": 0.060, "C": 0.120, "D": 0.240}
    assert b["stats_tc"]["bound_ms"] == pytest.approx(want_stats[site],
                                                      abs=1e-3)
    assert b["fwd_tc"]["bound_ms"] == pytest.approx(want_fwd[site], abs=1e-3)
    assert b["stats_tc"]["bound_by"] == ("bytes" if site in ("A", "D")
                                         else "operations")
    assert b["fwd_tc"]["bound_by"] == "bytes"
    assert b["fwd_tc"]["bytes"] == 2 * 4 * b["fwd_tc"]["flops"] / 3
    rows = smoke.k4_stats_rows(smoke.K4_SITES[site], smoke.TRAIN_BATCH,
                               smoke.TRAIN_TILE)
    # a tile of the u GEMM a phase x 16 columns x 24 (Cout <= 16) or 12
    # rows of x's grid
    assert rows == {"A": 16896, "B": 2304, "C": 8448, "D": 16896}[site]
    # the backward as its tensor-core kernels compute it: three conv passes
    # at the 3xTF32 rate, u written by bwd1 and read by bwd2; the pair bound
    # by memory at A and D, by the tensor cores at B and C
    tc = [b["bwd1_tc"], b["bwd2_tc"]]
    assert sum(t["flops"] for t in tc) > 3 * b["conv_flops"]
    t_ops = sum(t["flops"] for t in tc) / smoke.PEAK_3XTF32
    t_bytes = sum(t["bytes"] for t in tc) / smoke.HBM_BYTES_PER_S
    assert (t_bytes > t_ops) == (site in ("A", "D"))
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
    CUDA cores, >= 0.234 ms in f32 as 3xTF32 on the tensor cores, >= 39 us
    in bf16 on the tensor cores; bound by operations."""
    f32 = smoke.k1_bound(smoke.K1_SHAPE, torch.float32)
    bf16 = smoke.k1_bound(smoke.K1_SHAPE, torch.bfloat16)
    assert f32["flops"] == 2 * 2 * 16 * 64 * 64 * 128 * 128 * 9
    assert f32["bound_by"] == bf16["bound_by"] == "operations"
    assert f32["bound_ms"] == pytest.approx(0.5769, rel=1e-3)
    assert bf16["bound_ms"] == pytest.approx(0.0391, rel=1e-2)
    assert f32["tc"]["flops"] == f32["flops"]
    assert f32["tc"]["bound_by"] == "operations"
    assert f32["tc"]["bound_ms"] == pytest.approx(0.2343, rel=1e-3)
    assert bf16["tc"] == {k: bf16[k] for k in bf16 if k != "tc"}


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


def test_train_loop_phase_and_kernels_record_on_cpu(cpu_run, cpu_train_run,
                                                    cpu_k4_run):
    """Phase 19 at 32^2 (batch 2, pepochs of 8 samples): the run, the
    step_indices replay at repeat distance 0, the resume from the first
    periodic checkpoint equal to the uninterrupted run, and the paint of the
    final checkpoint; its launches (0 on the CPU) on the kernels record."""
    _, _, checks, paint, timing = cpu_run
    ds, gather, heads, training, _, _ = cpu_train_run
    conv_bn, training_k4, _ = cpu_k4_run
    out = smoke.train_loop(torch.device("cpu"), ds, batch=2, n_res_blocks=1,
                           pepoch=8, paint_tiles=2, run=dict(
                               validation_loss_frequency=4,
                               validation_loss_batch_size=2,
                               checkpoint_frequency=8,
                               statistics_report_frequency=4,
                               stats_sync_every=4))
    assert (out["steps"], out["evals"]) == (12, 6)
    assert out["repeat_distance"] == out["resumed_distance"] == 0.0
    assert out["stats_files_equal"] and out["checkpoint_bytes"] > 0
    assert out["peak_bytes"] is None
    detail = out["default_repeat_detail"]
    assert detail["distance"] == out["default_repeat_distance"]
    assert detail["leaf"].split("/")[0] in ("params", "batch_stats",
                                            "opt_state", "step")
    # 19e: the bf16 run with K4 and its bit-exact resume
    bf16 = out["bf16_k4"]
    assert (bf16["steps"], bf16["evals"]) == (4, 2)
    assert bf16["resumed_distance"] == 0.0 and bf16["stats_files_equal"]
    rec = smoke.kernels_record(checks, paint, timing, gather, heads,
                               training, conv_bn, training_k4,
                               train_loop=out)
    by_name = {(k["name"], k["dtype"]): k for k in rec["kernels"]}
    for name in ("res_block_infer", "gather_tiles", "head_stack_fwd",
                 "head_stack_bwd"):
        assert by_name[name, "float32"]["train_loop_launches"] == 0
    assert "train_loop_launches" not in by_name["conv_bn_fwd", "float32"]


def test_state_distance_reads_the_model_state():
    a = {"params": {"w": np.ones(3, np.float32)}, "batch_stats": {},
         "opt_state": {"0": {"count": np.int32(2), "mu": {}}, "1": {}},
         "step": np.int32(2), "progress": np.arange(6)}
    b = {**a, "params": {"w": np.array([1, 1.5, 1], np.float32)},
         "progress": np.zeros(6)}
    assert smoke.state_distance(a, a) == 0.0
    assert smoke.state_distance(a, b) == 0.5
    detail = smoke.state_distance_detail(a, b)
    assert detail == {"distance": 0.5, "leaf": "params/w",
                      "leaf_rel": 0.5 / 1.5, "params_worst_leaf": "params/w",
                      "params_worst_rel": 0.5 / 1.5, "params_max_abs": 0.5}
    with pytest.raises(AssertionError, match="keys"):
        smoke.state_distance(a, {**b, "params": {"v": np.ones(3)}})


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
    "path", sorted(PORT.rglob("*.py")) + [CHIP_SMOKE] + [
        Path(REPO) / "scripts" / f for f in ("create_lightcone_torch.py",
                                             "bench_torch_lightcone.py",
                                             "train_cvae_torch.py",
                                             "train_cgan_torch.py",
                                             "fidelity_check_torch.py",
                                             "fidelity_spread_torch.py",
                                             "bf16_conv_probe_torch.py",
                                             "smoke_phases_torch.py",
                                             "compare_reference_stats_torch.py",
                                             "step_f64_witness_torch.py",
                                             "lightcone_fanout_torch.py",
                                             "gate_variance_torch.py",
                                             "pk_diagnose_torch.py",
                                             "make_model_report_torch.py",
                                             "promote_checkpoint_torch.py",
                                             "transform_examples_torch.py")]
    + [Path(REPO) / "tests" / "torch_mesh_workers.py"],
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
