"""The phases of ``chip_smoke.py``, as functions of a device.

``chip_smoke.py`` runs them on ``cuda``; the CPU tests run the same control
flow with ``device="cpu"``, where the kernel wrapper computes its plain
version, nothing is built, and times are host times of no device. Each phase
prints one line with its elapsed seconds and returns what it found; a phase
that fails raises.

  0. environment: card, power limit, versions; TF32 switched off
  1. build K1, K2, K3 and K4 from the sources (one library)
  2. K1 against its plain version (f32 and bf16, each at both slopes)
  3. paint the committed 512^2 golden through the fused painter (4 K1
     launches) and compare
  4. time the painter, K1, its plain version and the library yardstick;
     K1's bounds on the tensor cores (3xTF32 in f32) and the CUDA cores
  5. the training data: synthetic stacks and the tile dataset
  6. K2 against its plain version (bit for bit), timed with a library
     yardstick
  7. K3 forward (y, and the u1 it keeps for the backward) and backward
     (from that u1) against their plain versions, timed with and without
     u1 kept and with cuDNN's heads as the yardstick; both kernels' bounds
     on the tensor cores (3xTF32) beside the CUDA-core ones
  8. train: steps of the CVAE trainer with the batch gathered by K2 and the
     heads through K3 (one launch of each per step, u1 kept between them),
     timed, with the step's peak device memory; a step with the kernels
     against a step with the plain versions from the same start
  9. paint the golden with the heads through K3 (one K3-fwd launch, no u1
     kept), timed
 10. K4 (stats, fwd, bwd1, bwd2) against its plain version at the four
     fused sites of the fiducial training step (the backward on the raw
     cotangent with K4's ReLU mask, and on a kink-zeroed one); stats' u
     against bwd1's (bit for bit: one mainloop); the forward and backward
     pairs' peak memory; timed with cuDNN's conv, the port's BatchNorm and
     ReLU as the yardstick; the bounds of the kernels' design (3xTF32 and
     memory) beside the CUDA-core ones
 11. train with K4 as well (``fused_train_conv=True``: 4 launches of each
     K4 kernel per step at 512^2), timed beside phase 8's step, with its
     peak device memory; 11b a step
     with every kernel against a plain step from the same start whose four
     sites' forward is computed in f64, within STEP_GRAD_TOL or no further
     than the plain step (the sites in f32) lies from it; 8b and 11b hold
     the kernels step to the whole-model f64 step too, each gradient leaf
     within STEP_GRAD_TOL or STEP_F64_FACTOR times the plain step's distance
 12. repaint the golden with PyTorch's default TF32 setting (cuDNN TF32 on)
     for the record, and with the painter's pinned f32, which must pass

and the bf16 configuration (the JAX package's default compute dtype):

 7b. K3-fwd and K3-bwd in bf16 against their plain bf16 versions, as phase
     7 (tolerances K3_TOL_BF16), timed beside cuDNN's bf16 heads; the
     bounds on the bf16 tensor cores
 13. train in bf16 (one K2 and one bf16 K3-fwd and K3-bwd launch a step),
     timed beside phase 8's f32 step, with its peak device memory; 13b a
     bf16 step with the kernels against the bf16 step with their plain
     versions, within BF16_STEP_RATIO of the plain bf16 step's distance
     from the plain f32 step
 14. paint the golden input in bf16 (4 bf16 K1 and 1 bf16 K3-fwd launches)
     at the prior mean against the committed JAX bf16 paint
     (BF16_REFERENCE), then timed beside phase 9's f32 paint
 10b. K4 in bf16 against its plain bf16 version at the four sites, as
     phase 10 (tolerances K4_TOL_BF16; stats' u also against the plain f32
     u of the bf16 values, and bit for bit against bwd1's), timed beside
     cuDNN's bf16 conv, the port's bf16 BatchNorm and ReLU on
     ``channels_last``; the bounds on the bf16 tensor cores
 15. train in bf16 with ``fused_train_conv=True`` (one K2, one bf16 K3-fwd
     and K3-bwd and 4 bf16 launches of each K4 kernel a step), timed beside
     phase 13's bf16 step without K4, with its peak device memory; 15b a
     bf16 step with every kernel against the bf16 step with their plain
     versions, within BF16_STEP_RATIO of the plain bf16 step's distance
     from the plain f32 step (the fused sites in plain PyTorch in both),
     printed beside the chaos floor: how far the plain bf16 step moves
     when only the sites' sums change order

and the paint path's consumer, the SLICS lightcone (``lightcone``), through
the lightcone CLI's own ``run`` (scripts/create_lightcone_torch.py) on a
synthetic line of sight written at real sizes (LC_Z: a 12288^2 massplane
shell, 4 tiles of 7050^2 and 64 tiles of 1211^2; 6 paint calls), under
PyTorch's default TF32 switches:

 16a. ``resize_spline`` against ``scipy.ndimage.zoom`` at the lightcone's
     sizes with cuDNN's and matmul's TF32 on
 16b. the f32 lightcone with K1 and K3 against the plain f32 lightcone
     (PyTorch's own convolutions, cuDNN off), every plane and the y map
     within the golden's tolerance; cuDNN's f32 lightcone's distance from
     the plain one beside it
 16c. the CLI's default, bf16 with K1 and K3 and the kappa cross-Cl:
     exactly 24 bf16 K1 and 6 bf16 K3-fwd launches; e(bf16 kernels, bf16
     cuDNN) <= LC_BF16_RATIO * e(bf16 cuDNN, f32 cuDNN) on the y map's
     pseudo-Cl; then timed by stage (CUDA events) and whole (host clock)

then the CGAN painter (``cgan``), K1's heaviest path (9 LeakyReLU(0.2)
blocks a paint), on the same line of sight:

 17a. K1 against its plain version at the CGAN's shapes, (2, 64, 64, 128)
     (the goldens) and (16, 128, 128, 128) (the CLI's 512^2 tiles), slope
     0.2, f32 and bf16, with K1_CASES' tolerances
 17b. both CGAN goldens through ``CGANPainter(fused_inference=True)``:
     exactly 9 f32 K1 launches a paint call, the golden tolerance; the
     unfused painter's distance printed
 17c. the bf16 CGAN paint (exactly 9 bf16 K1 launches) against the
     committed JAX bf16 paint (BF16_CGAN_REFERENCE), phase 14's rule
 17d. ``paint_batch`` at 16 tiles of 512^2, f32 and bf16, with K1 and with
     cuDNN's blocks, and K1 per launch at (16, 128, 128, 128) beside
     cuDNN's LeakyReLU block and the bound; peak device memory
 17e. the CLI with ``--model-type CGAN --fused-paint`` (exactly 9 K1
     launches a paint call) against the same run with cuDNN off, the
     golden tolerance; then timed by stage

and seamless whole-plane painting (``seamless``):

 18a. both painters' probe plane at ``required_halo`` and at twice it, f32
     printed, held in f64 to rtol 1e-5, atol 1e-6; ``calibrate_halo``
 18b. a 1024^2 plane painted whole with cuDNN against cuDNN off, both
     painters, the golden tolerance
 18c. the CLI with ``--seamless`` (the CVAE in bf16): timed by stage, its
     peak memory and e(seamless, tiled) printed; ``--seamless
     --fused-paint`` raises

and the training run, ``CVAETrainer.train`` (``train_loop``), through the
training CLI's code (scripts/train_cvae_torch.py) at full width, f32, with
``--device-data`` and ``BPT_FUSED_HEADS=1`` on phase 5's stacks:

 19a. with cuDNN's default algorithms, as the CLI runs: 3 pepochs of 96
     samples at batch 24, validation and reports every 48 samples, a
     checkpoint every 96: exactly one K2, one K3-fwd keeping u1 and one
     K3-bwd launch a step (and one K3-fwd per validation loss); timed,
     with its peak device memory and one checkpoint write's seconds and
     bytes
 19b. the same steps through ``step_indices``, timed beside 19a; then the
     run and its replay under cuDNN's deterministic algorithms, timed (the
     deterministic algorithms' cost), the replay's final state's distance
     from that run's (the repeat distance)
 19c. under the deterministic algorithms, ``run(--resume-from`` that run's
     first periodic checkpoint``)``: the final state and the statistics
     files equal to that run's
 19d. ``load_painter`` on the final checkpoint with ``fused_inference``: 16
     tiles in one call, exactly 4 K1 launches, finite

the P(k) fidelity gate (``gate``; 20a the fiducial CVAE, 20b both CGANs,
fiducial and fiducial-adv, bf16 held to the JAX package's CPU bf16, 20d the
bf16 readings of the four committed CVAEs held the same way) and the
spectral step (``pk_step``, 20c), and CGAN training (``cgan_train``) at full
width, f32, from the committed fiducial-adv state (G, D, both Adams) on
phase 5's stacks at batch 6:

 21a. ``step_indices`` timed, its peak memory, exactly one K2 launch a step
 21b. the f32 step against the same step in f64, from the committed state
     and after ``reinit_discriminator(7)`` (CGAN_F64_RTOL, STEP_GRAD_TOL);
     a K2 step against a plain-gather step, equal bit for bit
 21c. one step in each of CGAN_MODES, finite; calibration moves nothing of
     D and none of G's state, ``freeze_bn_stats`` none of G's state
 21d. ``train()`` through the CGAN training CLI's code, timed beside
     ``step_indices`` over the same steps, and resumed from its first
     checkpoint bit for bit (cuDNN's deterministic algorithms)
 21e. ``CGANPainter.from_trainer(..., fused_inference=True)``: exactly 9 K1
     launches a call, the golden tolerance from the unfused paint, equal to
     ``load_painter`` on 21d's final checkpoint
 21f. the gate twin's CGAN training leg on 20b's fiducial-adv stacks

and the run tooling (``tooling``):

 22a. the training CLI's ``run`` with ``--profile`` (2 pepochs of 48
     samples at batch 24, K2 and K3): the trace's kernels by name equal
     the wrappers' counts, one K2, K3-fwd and K3-bwd a step (K3-fwd also
     once a validation loss); the trace's bytes and samples/s with and
     without it
 22b. ``validate`` on the CVAE (K3-fwd once a call) and the CGAN trainer:
     its figures saved with matplotlib, an ImportError naming matplotlib
     without it; the painted batch's P(k) fractional errors on the card
     against the CPU's
 22c. ``scripts/compare_reference_stats_torch.py``: 19c's resumed
     ``training_stats.txt`` against the uninterrupted one in absolute mode,
     exactly 0; 19's run against the committed fiducial log in shape mode
 22d. ``BatchLoader(raw=False)`` equal to ``get_batch``
"""
from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import subprocess
import tempfile
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

from baryon_painter_tpu_torch.angular_power import cl_fractional_error
from baryon_painter_tpu_torch.lightcone import io as slics_io
from baryon_painter_tpu_torch.lightcone.pipeline import StageTimes
from baryon_painter_tpu_torch.lightcone.synthetic import (
    TILE_SIZE, shell_sizes, write_synthetic_los)
from baryon_painter_tpu_torch.lightcone.tiling import generate_tiling
from baryon_painter_tpu_torch.ops.conv_bn import (
    batch_stats, bn_affine, conv_bn_bwd1, conv_bn_bwd1_ref, conv_bn_bwd2,
    conv_bn_bwd2_ref, conv_bn_fwd, conv_bn_fwd_ref, conv_bn_relu_bwd_ref,
    conv_bn_relu, conv_bn_relu_ref, conv_bn_stats, conv_bn_stats_ref)
from baryon_painter_tpu_torch.ops.gather import (gather_tiles,
                                                 gather_tiles_ref)
from baryon_painter_tpu_torch.ops.head_stack import (head_stack_bwd,
                                                     head_stack_bwd_ref,
                                                     head_stack_fwd,
                                                     head_stack_ref, rounder)
from baryon_painter_tpu_torch.ops.res_block import (fold_bn, res_block_infer,
                                                    res_block_infer_ref)
from baryon_painter_tpu_torch.ops.resample import resize_spline
from baryon_painter_tpu_torch.utils import profiling

REPO = Path(__file__).resolve().parent.parent
CHECKPOINT = "trained_models/CVAE/fiducial-512/model"
GOLDENS = "tests/goldens/paint_goldens.npz"
GOLDEN_EPS = Path(__file__).resolve().parent / "data" / "golden_eps.npz"
K1_REPLACES = "baryon_painter_tpu/ops/pallas_conv.py:72"
K1_SOURCE = "baryon_painter_tpu_torch/csrc/res_block.cu"
K2_REPLACES = "baryon_painter_tpu/ops/pallas_gather.py:127"
K2_SOURCE = "baryon_painter_tpu_torch/csrc/gather_tiles.cu"
K3_FWD_REPLACES = "baryon_painter_tpu/ops/pallas_head_stack.py:211"
K3_BWD_REPLACES = "baryon_painter_tpu/ops/pallas_head_stack.py:271"
K3_SOURCE = "baryon_painter_tpu_torch/csrc/head_stack.cu"
K4_SOURCE = "baryon_painter_tpu_torch/csrc/conv_bn.cu"
# the bodies of the four pallas_calls of fused_conv_bn_relu (:380)
K4_REPLACES = {"stats": "baryon_painter_tpu/ops/pallas_conv_bn.py:126",
               "fwd": "baryon_painter_tpu/ops/pallas_conv_bn.py:149",
               "bwd1": "baryon_painter_tpu/ops/pallas_conv_bn.py:166",
               "bwd2": "baryon_painter_tpu/ops/pallas_conv_bn.py:277"}

# one H100 SXM at 700 W (NVIDIA's data sheet, utils/profiling.py): f32 on
# the CUDA cores, dense bf16 on the tensor cores, HBM3
PEAK_FLOPS = {torch.float32: profiling.H100_F32_FLOPS,
              torch.bfloat16: profiling.PEAK_FLOPS[profiling.H100_SXM]}
HBM_BYTES_PER_S = profiling.PEAK_BW[profiling.H100_SXM]
# f32 products as 3xTF32 on the tensor cores: three TF32 products (dense
# 495 TFLOP/s) for each f32 one
PEAK_3XTF32 = 495e12 / 3

# main-path shape of K1: 16 tiles of 512^2 reach the blocks at 64x64x128
K1_SHAPE = (16, 64, 64, 128)
# (dtype, inner/outer slope, tolerance on max|kernel - plain| / max|plain|):
# f32 differs only by summation order; bf16 also by where the intermediate
# rounds to bf16; both slopes, the CVAE's 0 and the CGAN's 0.2, in both types
K1_CASES = ((torch.float32, 0.0, 1e-4), (torch.float32, 0.2, 1e-4),
            (torch.bfloat16, 0.0, 2e-2), (torch.bfloat16, 0.2, 2e-2))
# the golden test's own tolerance (tests/test_paint_goldens.py)
GOLDEN_RTOL = 5e-3


@contextlib.contextmanager
def _tf32(cudnn: bool, matmul: bool):
    """cuDNN's and matmul's TF32 switches set for the block, restored
    after."""
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev


def _golden_ratio(got, want) -> float:
    """max |got - want| / (GOLDEN_RTOL * (mean|want| + |want|))."""
    got = torch.as_tensor(got).double().cpu()
    want = torch.as_tensor(want).double().cpu()
    tol = GOLDEN_RTOL * (want.abs().mean() + want.abs())
    return float(((got - want).abs() / tol).max())


def _line(phase: int, name: str, t0: float, **fields):
    items = " ".join(f"{k}={v}" for k, v in fields.items())
    print(f"phase {phase} {name}: {items} ({time.perf_counter() - t0:.3f} s)",
          flush=True)


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def golden_inputs(tile: int, n: int, seed: int = 1234) -> np.ndarray:
    """Deterministic lognormal 'DM' tiles with plausible amplitude (mean ~1,
    heavy tail); the inputs of the committed paint goldens."""
    rng = np.random.default_rng(seed + tile)
    g = rng.standard_normal((n, tile, tile)).astype(np.float32)
    # mild spatial correlation so the tiles aren't pure white noise
    f = np.fft.rfft2(g)
    ky = np.fft.fftfreq(tile)[:, None]
    kx = np.fft.rfftfreq(tile)[None, :]
    kk = np.sqrt(kx ** 2 + ky ** 2)
    f *= 1.0 / (1.0 + (kk * tile / 8.0) ** 1.1)
    g = np.fft.irfft2(f, s=(tile, tile)).astype(np.float32)
    g *= 1.0 / g.std()
    x = np.exp(g - 0.5).astype(np.float32)
    return x / x.mean(axis=(1, 2), keepdims=True)


def environment(device) -> dict:
    """Phase 0: the card's name and power limit, versions; TF32 off, so
    "f32" convolutions on the card are f32 arithmetic."""
    t0 = time.perf_counter()
    device = torch.device(device)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    env = {"torch": torch.__version__, "cuda": torch.version.cuda,
           "cudnn_allow_tf32": torch.backends.cudnn.allow_tf32,
           "matmul_allow_tf32": torch.backends.cuda.matmul.allow_tf32,
           "kind": "cpu", "count": 0, "nvidia_smi": None}
    if device.type == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", f"--id={device.index or 0}"],
            capture_output=True, text=True, timeout=60, check=True)
        env.update(kind=torch.cuda.get_device_name(device),
                   count=torch.cuda.device_count(),
                   nvidia_smi=smi.stdout.strip())
    _line(0, "environment", t0, card=json.dumps(env["nvidia_smi"]),
          torch=env["torch"], cuda=env["cuda"],
          cudnn_allow_tf32=env["cudnn_allow_tf32"],
          matmul_allow_tf32=env["matmul_allow_tf32"])
    return env


def build_kernels(device) -> dict:
    """Phase 1: build every kernel from the sources, from scratch (cuda
    only)."""
    t0 = time.perf_counter()
    device = torch.device(device)
    if device.type != "cuda":
        _line(1, "build", t0, skipped="no nvcc build for the cpu")
        return {"seconds": None}
    from baryon_painter_tpu_torch.ops import _build
    res = _build.build_library(force=True)
    _build.load_library()
    ptxas = [l.strip() for l in res["log"].splitlines()
             if "registers" in l or "spill" in l]
    for l in ptxas:
        print(f"  ptxas: {l}", flush=True)
    _line(1, "build", t0, build_s=f"{res['seconds']:.3f}",
          library=res["path"].name)
    return {"seconds": res["seconds"], "ptxas": ptxas}


def k1_inputs(shape, dtype, device, seed: int = 0):
    """Seeded random K1 operands: x NHWC, HWIO weights ~0.05, folded BN."""
    n, h, w, c = shape
    rng = np.random.default_rng(seed)
    t = lambda a, dt=torch.float32: torch.as_tensor(
        a.astype(np.float32)).to(device=device, dtype=dt)
    x = t(rng.standard_normal((n, h, w, c)), dtype)
    w1 = t(0.05 * rng.standard_normal((3, 3, c, c)), dtype)
    w2 = t(0.05 * rng.standard_normal((3, 3, c, c)), dtype)
    bn = []
    for _ in range(2):
        scale = t(rng.uniform(0.5, 1.5, c))
        bias = t(0.1 * rng.standard_normal(c))
        mean = t(0.1 * rng.standard_normal(c))
        var = t(rng.uniform(0.5, 1.5, c))
        bn.append(fold_bn(scale, bias, mean, var))
    return x, w1, bn[0][0], bn[0][1], w2, bn[1][0], bn[1][1]


def _check_k1(shape, dtype, slope, rel_tol, device) -> dict:
    """K1 against res_block_infer_ref on seeded inputs of ``shape``; raises
    beyond ``rel_tol`` of the plain version's largest value."""
    args = k1_inputs(shape, dtype, device)
    got = res_block_infer(*args, inner_slope=slope, outer_slope=slope)
    want = res_block_infer_ref(*args, inner_slope=slope, outer_slope=slope)
    _sync(device)
    err = (got.float() - want.float()).abs().max().item()
    scale = want.float().abs().max().item()
    rec = {"shape": list(shape), "dtype": str(dtype).replace("torch.", ""),
           "slope": slope, "max_abs_err": err, "max_abs_ref": scale,
           "tol": rel_tol * scale}
    print(f"  K1 {rec['dtype']} {list(shape)} slope={slope}: "
          f"max|k-ref|={err:.3e} tol={rec['tol']:.3e}", flush=True)
    if not (err <= rel_tol * scale) or not torch.isfinite(got).all():
        raise AssertionError(f"K1 disagrees with its plain version: {rec}")
    return rec


def check_kernels(device, shape=K1_SHAPE, cases=K1_CASES) -> list:
    """Phase 2: K1 against res_block_infer_ref on the same inputs."""
    t0 = time.perf_counter()
    device = torch.device(device)
    results = [_check_k1(shape, dtype, slope, rel_tol, device)
               for dtype, slope, rel_tol in cases]
    _line(2, "k1_vs_plain", t0, shape=list(shape), cases=len(results))
    return results


_COUNTED = {"k1": res_block_infer, "k2": gather_tiles,
            "k3_fwd": head_stack_fwd, "k3_bwd": head_stack_bwd,
            "k4_stats": conv_bn_stats, "k4_fwd": conv_bn_fwd,
            "k4_bwd1": conv_bn_bwd1, "k4_bwd2": conv_bn_bwd2}
# the kernels with a bf16 variant: of their launches, those in bf16
_COUNTED_BF16 = {"k1": res_block_infer, "k3_fwd": head_stack_fwd,
                 "k3_bwd": head_stack_bwd, "k4_stats": conv_bn_stats,
                 "k4_fwd": conv_bn_fwd, "k4_bwd1": conv_bn_bwd1,
                 "k4_bwd2": conv_bn_bwd2}


def _reset_launches():
    for fn in _COUNTED.values():
        fn.launches = 0
    for fn in _COUNTED_BF16.values():
        fn.bf16_launches = 0
    head_stack_fwd.kept_u1 = 0


def _launches() -> dict:
    return {key: fn.launches for key, fn in _COUNTED.items()}


def _bf16_launches() -> dict:
    return {key: fn.bf16_launches for key, fn in _COUNTED_BF16.items()}


def _expect_launches(path: str, got: dict, want: dict):
    """Every kernel's launch count on a path, against what it must be: the
    counts ``want`` names, and 0 for every other kernel."""
    full = {key: want.get(key, 0) for key in got}
    if got != full or set(want) - set(got):
        raise AssertionError(f"{path}: kernel launches {got}, expected "
                             f"{full}")


def paint_golden(device, repo: Path = REPO, fused_heads: bool = False,
                 phase=3, caller_tf32: bool = False,
                 check: bool = True) -> dict:
    """Phase 3 (and 9 with ``fused_heads``): a main path. Paint the
    committed 512^2 golden's inputs with the fused painter and the committed
    prior noise; compare with the golden and count the launches (on the
    card 4 of K1, one per residual block, and with ``fused_heads`` 1 of
    K3-fwd; none on the CPU). ``caller_tf32`` paints through the painter's
    inner ``_paint_batch``, under the caller's TF32 setting instead of the
    f32 that ``paint_batch`` pins; ``check=False`` reports the worst error
    without failing on it."""
    from baryon_painter_tpu_torch.painter import CVAEPainter
    t0 = time.perf_counter()
    device = torch.device(device)
    painter = CVAEPainter(str(repo / CHECKPOINT), fused_inference=True,
                          fused_heads=fused_heads, device=device)
    with np.load(repo / GOLDENS) as g:
        want = g["cvae_512"].astype(np.float32)
    with np.load(GOLDEN_EPS) as e:
        eps = e["eps_512"]
    tiles = golden_inputs(512, 1)
    zs = np.zeros(1, np.float32)
    _reset_launches()
    if caller_tf32:
        with torch.inference_mode():
            out = painter._paint_batch(tiles, zs, True, True, False, None,
                                       "sample", eps)
    else:
        out = painter.paint_batch(tiles, zs, eps=eps)
    _sync(device)
    counts = _launches()
    got = out.cpu().numpy()
    on_card = device.type == "cuda"
    _expect_launches("paint", counts, {
        "k1": 4 if on_card else 0,
        "k3_fwd": 1 if on_card and fused_heads else 0})
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        raise AssertionError(f"painted {got.shape}, finite="
                             f"{np.all(np.isfinite(got))}")
    ratio = _golden_ratio(got, want)
    if check and not ratio <= 1.0:
        raise AssertionError(f"painted tile differs from the golden: worst "
                             f"|diff| / tolerance = {ratio:.3f}")
    _line(phase, "paint_golden_fused_heads" if fused_heads else
          "paint_golden", t0, launches=json.dumps(counts),
          worst_err_over_tol=f"{ratio:.4f}")
    return {"launches": counts["k1"], "k3_fwd_launches": counts["k3_fwd"],
            "worst_err_over_tol": ratio, "painter": painter}


def _time_ms(fn, device, warmup: int, iters: int) -> float:
    """ms per call: CUDA events on the card, the host clock on the CPU."""
    for _ in range(warmup):
        fn()
    _sync(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    t = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t) * 1e3 / iters


def paint_time_ms(device, painter, n_tiles: int, warmup: int,
                  iters: int) -> float:
    """ms per ``paint_batch`` call of ``n_tiles`` 512^2 tiles over the 11
    redshifts of the checkpoint's grid."""
    z_grid = np.asarray(painter.meta["stats"][painter.input_field]["z_grid"],
                        np.float32)
    tiles = torch.as_tensor(golden_inputs(512, n_tiles), device=device)
    zs = torch.as_tensor(z_grid[np.arange(n_tiles) % len(z_grid)],
                         device=device)
    return _time_ms(lambda: painter.paint_batch(tiles, zs), device, warmup,
                    iters)


def _mixed_bound(parts, nbytes: float) -> dict:
    """The least time of work done on several units in turn: ``parts`` is a
    list of (operations, peak rate), whose times add, against ``nbytes``
    over the memory rate."""
    t_ops = sum(f / peak for f, peak in parts)
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"flops": sum(f for f, _ in parts), "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def _bound(flops: float, nbytes: float, peak: float = PEAK_FLOPS[
        torch.float32]) -> dict:
    return _mixed_bound([(flops, peak)], nbytes)


def k1_bound(shape, dtype) -> dict:
    """Least time for one K1 launch: the larger of its operations over the
    peak rate for the type and its bytes (x read, out written, weights and
    folded BN read once) over the memory rate. The rate is f32 on the CUDA
    cores in f32 and the bf16 tensor cores in bf16; ``tc`` is the bound on
    the tensor cores, where K1 runs: 3xTF32 in f32, bf16 in bf16."""
    n, h, w, c = shape
    elt = torch.empty((), dtype=dtype).element_size()
    flops = 2 * 2 * n * h * w * c * c * 9
    nbytes = 2 * n * h * w * c * elt + 2 * 9 * c * c * elt + 4 * c * 4
    tc = PEAK_3XTF32 if dtype == torch.float32 else PEAK_FLOPS[dtype]
    return {**_bound(flops, nbytes, PEAK_FLOPS[dtype]),
            "tc": _bound(flops, nbytes, tc)}


def library_block(x, w1, s1, b1, w2, s2, b2, slope: float = 0.0):
    """The residual block as two library convolutions (cuDNN on the card)
    plus the affine and the (leaky, ``slope``) ReLUs, NCHW; a yardstick
    only."""
    a = lambda v: v[:, None, None]
    act = (torch.relu if slope == 0.0
           else lambda v: F.leaky_relu(v, slope))
    h = act(F.conv2d(x, w1, padding=1) * a(s1) + a(b1))
    return act(F.conv2d(h, w2, padding=1) * a(s2) + a(b2) + x)


def library_block_args(args, dtype):
    """K1's operands (NHWC x, HWIO weights) as ``library_block``'s: x as
    the NCHW view of its channels_last memory, OIHW weights, the folded
    affine in ``dtype``."""
    x, w1, s1, b1, w2, s2, b2 = args
    return (x.permute(0, 3, 1, 2), w1.permute(3, 2, 0, 1).contiguous(),
            s1.to(dtype), b1.to(dtype), w2.permute(3, 2, 0, 1).contiguous(),
            s2.to(dtype), b2.to(dtype))


def time_main_path(device, painter, card=None, n_tiles: int = 16,
                   warmup: int = 2, iters: int = 10, k1_shape=K1_SHAPE,
                   k1_iters: int = 20) -> dict:
    """Phase 4: paint_batch at n_tiles 512^2 tiles over the 11 redshifts of
    the checkpoint's grid; K1 per launch in f32 and bf16; the plain version;
    the library yardstick (cuDNN on channels_last) in f32 and bf16; the
    bound. ``card`` (nvidia-smi's name and power limit) is printed beside
    the times."""
    t0 = time.perf_counter()
    device = torch.device(device)
    paint_ms = paint_time_ms(device, painter, n_tiles, warmup, iters)
    out = {"paint_ms": paint_ms, "n_tiles": n_tiles,
           "tiles_per_s": n_tiles / paint_ms * 1e3}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            key = str(dtype).replace("torch.", "")
            args = k1_inputs(k1_shape, dtype, device)
            out[f"k1_ms_{key}"] = _time_ms(lambda: res_block_infer(*args),
                                           device, 3, k1_iters)
            out[f"bound_{key}"] = k1_bound(k1_shape, dtype)
            # the library yardstick on channels_last (NHWC) memory
            lib_args = library_block_args(args, dtype)
            out[f"library_ms_{key}"] = _time_ms(
                lambda: library_block(*lib_args), device, 3, k1_iters)
            out[f"plain_ms_{key}"] = _time_ms(
                lambda: res_block_infer_ref(*args), device, 3, k1_iters)
        out["plain_ms"] = out["plain_ms_float32"]
        out["library_ms"] = out["library_ms_float32"]
    out["k1_share_of_bound_float32"] = (
        out["bound_float32"]["tc"]["bound_ms"] / out["k1_ms_float32"])
    out["k1_share_of_bound_bfloat16"] = (out["bound_bfloat16"]["bound_ms"]
                                         / out["k1_ms_bfloat16"])
    clock = "cuda_events" if device.type == "cuda" else "host_clock_cpu"
    _line(4, "timing", t0, clock=clock, card=json.dumps(card),
          paint_ms=f"{paint_ms:.3f}", n_tiles=n_tiles,
          tiles_per_s=f"{out['tiles_per_s']:.2f}",
          k1_ms_f32=f"{out['k1_ms_float32']:.4f}",
          k1_ms_bf16=f"{out['k1_ms_bfloat16']:.4f}",
          plain_ms=f"{out['plain_ms']:.4f}",
          library_ms=f"{out['library_ms']:.4f}",
          library_ms_bf16=f"{out['library_ms_bfloat16']:.4f}",
          bound_ms_f32_3xtf32=f"{out['bound_float32']['tc']['bound_ms']:.4f}",
          bound_ms_f32_cuda_cores=f"{out['bound_float32']['bound_ms']:.4f}",
          bound_ms_bf16=f"{out['bound_bfloat16']['bound_ms']:.4f}",
          share_of_bound_f32=f"{out['k1_share_of_bound_float32']:.3f}",
          share_of_bound_bf16=f"{out['k1_share_of_bound_bfloat16']:.3f}")
    return out


# ---------------------------------------------------------------------- #
# training: K2 and K3

# the training configuration of bench.py:100-114: the fiducial CVAE at 512^2
# with 4 residual blocks, batch 24, stacks of 2 x 1024^2 at 2 redshifts
TRAIN_TILE = 512
TRAIN_BATCH = 24
N_RES_BLOCKS = 4
# tolerances on max|kernel - plain| / max|plain|: the outputs, the kept u1
# and dx differ by summation order only; the weight and slope gradients sum
# 6.3 M pixels
K3_TOL = {"y": 1e-4, "u1": 1e-4, "dx": 1e-4, "dw1": 1e-3, "dw2": 1e-3,
          "dw3": 1e-3, "dalphas": 1e-3}
# in bf16: y, dx and the rounded intermediates (a1, a2, du2, du1) are bf16,
# and a sum that lands next to a rounding boundary rounds the other way for
# another summation order, one bf16 step (2^-8 of the value) apart, which
# carries into what is computed from it; u1 is f32 (bf16 products are exact
# in f32, so only the order of its sums differs)
K3_TOL_BF16 = {"y": 2e-2, "u1": 1e-4, "dx": 2e-2, "dw1": 2e-2, "dw2": 2e-2,
               "dw3": 2e-2, "dalphas": 2e-2}
# the kernels-vs-plain training step: the loss, relative; every parameter's
# gradient as the weight gradients above, relative to its own largest entry;
# only the parameters of STEP_GRAD_ZERO are held instead to STEP_GRAD_FLOOR
# of the largest entry of all the gradients. Their gradient is 0
# analytically at the first step from the initialisation: the scale of a
# one-channel batch norm whose bias is 0, followed through a ReLU and a
# bias-free transposed conv by another batch norm, which undoes any positive
# scale; both sides return rounding noise for it.
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_TOL = 1e-3
STEP_GRAD_FLOOR = 1e-3
STEP_GRAD_ZERO = ("p_z_in.layers.BatchNorm_0.weight",
                  "p_z_in.layers.BatchNorm_1.weight")
# against the whole-model f64 step (8b, 11b) each gradient leaf of the
# kernels step lies within STEP_GRAD_TOL of its own largest entry, or no
# further than STEP_F64_FACTOR times the plain f32 step's distance for the
# same leaf: at 512^2 the plain step with cuDNN's f32 convolutions lies
# 1.661e-2 from f64 and the kernels step 1.663e-2 (worst leaves,
# scripts/step_f64_witness_torch.py, H100 SXM 700 W)
STEP_F64_FACTOR = 1.5
# K4 against its plain version, max|kernel - plain| / max|plain|: y, the
# batch statistics and dx differ by summation order only; the weight and
# batch-norm parameter gradients sum over every output pixel
K4_TOL = {"y": 1e-4, "mean": 1e-4, "var": 1e-4, "dx": 1e-4, "dw": 1e-3,
          "dgamma": 1e-3, "dbeta": 1e-3}
# in bf16: y, dx and dW are bf16 and move by one bf16 step (2^-8 of the
# value) where a sum in another order lands next to a rounding boundary, as
# K3_TOL_BF16 allows; u, mean and var are f32 sums of exact bf16 products
# (order only); dgamma and dbeta f32 sums over every output pixel
K4_TOL_BF16 = {"y": 2e-2, "mean": 1e-4, "var": 1e-4, "u": 1e-4, "dx": 2e-2,
               "dw": 2e-2, "dgamma": 1e-3, "dbeta": 1e-3}
# the four sites K4 fuses in the fiducial training step at 512^2: the input
# conv of p_y_z_in and its three up-convs; h is the input's edge at 512^2
K4_SITES = {
    "A": dict(transposed=False, cin=3, cout=16, k=5, stride=1, padding=2,
              h=512),
    "B": dict(transposed=True, cin=128, cout=64, k=4, stride=2, padding=1,
              h=64),
    "C": dict(transposed=True, cin=64, cout=32, k=4, stride=2, padding=1,
              h=128),
    "D": dict(transposed=True, cin=32, cout=16, k=4, stride=2, padding=1,
              h=256),
}
K4_KERNELS = ("stats", "fwd", "bwd1", "bwd2")
# each K4 kernel's bound as it is designed (``k4_bounds``): the u GEMM, dx
# and dW on the tensor cores at the 3xTF32 rate (bf16: the bf16 rate), fwd a
# pass over memory
K4_BOUND = {k: f"{k}_tc" for k in K4_KERNELS}
# operations per pixel and head: forward conv7 16->8, conv5 8->1, conv3 1->1
_HEAD_FWD_OPS = 2 * (7 * 7 * 16 * 8 + 5 * 5 * 8 + 3 * 3)
# backward, from the u1 the forward keeps: u2 recomputed and the input and
# weight gradients of the three convs
_HEAD_BWD_OPS = 2 * 5 * 5 * 8 + 2 * 2 * (7 * 7 * 16 * 8 + 5 * 5 * 8 + 3 * 3)


def training_data(tile: int = TRAIN_TILE):
    """Phase 5: the training data of bench.py: synthetic stacks (2 stacks of
    (2 tile)^2 per field, redshift and depth, seed 0), read into memory,
    2 x 2 tiles a side, dihedral permutations, shift-log(4) transforms."""
    import tempfile
    from baryon_painter_tpu_torch.data.dataset import (BahamasTileDataset,
                                                       load_file_info)
    from baryon_painter_tpu_torch.data.synthetic import make_synthetic_stacks
    from baryon_painter_tpu_torch.transforms import RangeCompress
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as root:
        info = make_synthetic_stacks(root, n_stack=2, n_grid=2 * tile,
                                     redshifts=(0.0, 1.0), seed=0)
        ds = BahamasTileDataset(
            files=load_file_info(info), root_path=root, n_tile=2,
            tile_permutations=True, mmap_mode=None,
            transforms={"dm": RangeCompress("shift-log", 4.0),
                        "pressure": RangeCompress("shift-log", 4.0)})
    _line(5, "training_data", t0, tile=ds.tile_size, n_grid=ds.n_grid,
          samples=len(ds))
    return ds


def k2_bound(batch: int, fields: int, tile: int) -> dict:
    """Least time for one K2 launch: each tile read once and written once."""
    return _bound(0, 2 * batch * 2 * fields * tile * tile * 4)


def _rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def check_gather(device, dataset, batch: int = TRAIN_BATCH, seed: int = 1,
                 iters: int = 20) -> dict:
    """Phase 6: K2 against its plain version and against the library
    yardstick (one advanced-indexing call on the two stacks concatenated
    along the stack axis), bit for bit, at the training batch; timed."""
    from baryon_painter_tpu_torch.data.device_cache import DeviceStackCache
    t0 = time.perf_counter()
    device = torch.device(device)
    cache = DeviceStackCache(dataset, device=device)
    t = cache.tile_size
    digits = cache.digits(dataset.sample_indices(np.random.default_rng(seed),
                                                 batch))
    args = (cache.data100, cache.data150, digits, t)
    got = gather_tiles(*args)
    want = gather_tiles_ref(*args)
    both = torch.cat([cache.data100, cache.data150], dim=2)
    d = torch.as_tensor(digits, device=device).long()
    s100 = cache.data100.shape[2]
    ar = torch.arange(t, device=device)
    zi = d[:, 0].reshape(-1, 1, 1, 1)
    si = torch.stack([d[:, 3], d[:, 6] + s100], 1).reshape(-1, 2, 1, 1)
    ri = (torch.stack([d[:, 4], d[:, 7]], 1)[..., None] * t
          + ar)[..., None]                                     # (B, 2, T, 1)
    ci = (torch.stack([d[:, 5], d[:, 8]], 1)[..., None] * t
          + ar)[:, :, None, :]                                 # (B, 2, 1, T)
    library = lambda: both[:, zi, si, ri, ci]                  # (F, B, 2, T, T)
    lib = library()
    _sync(device)
    exact = bool(torch.equal(got, want))
    lib_exact = bool(torch.equal(got, lib.permute(1, 2, 0, 3, 4)))
    if not (exact and lib_exact):
        raise AssertionError(f"K2 differs from its plain version "
                             f"(equal={exact}) or the library gather "
                             f"(equal={lib_exact})")
    out = {"max_abs_err": (got - want).abs().max().item(),
           "shape": list(got.shape),
           "ms": _time_ms(lambda: gather_tiles(*args), device, 3, iters),
           "plain_ms": _time_ms(lambda: gather_tiles_ref(*args), device, 3,
                                iters),
           "library_ms": _time_ms(library, device, 3, iters),
           **k2_bound(batch, cache.data100.shape[0], t)}
    _line(6, "k2_vs_plain", t0, shape=out["shape"], bit_exact=exact,
          k2_ms=f"{out['ms']:.4f}", plain_ms=f"{out['plain_ms']:.4f}",
          library_ms=f"{out['library_ms']:.4f}",
          bound_ms=f"{out['bound_ms']:.4f}")
    return out


def head_inputs(n: int, h: int, w: int, device, seed: int = 0):
    """Seeded K3 operands at the scale of the fiducial heads: x (N, H, W, 16)
    and dy (N, 2, H, W) standard normal; kernels U(-b, b) with PyTorch's
    default bound b = 1/sqrt(k*k*C_in); PReLU slopes U(0.1, 0.4)."""
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    u = lambda shape, b: t(rng.uniform(-b, b, shape))
    x = t(rng.standard_normal((n, h, w, 16)))
    w1 = u((2, 7, 7, 16, 8), 1 / np.sqrt(7 * 7 * 16))
    w2 = u((2, 5, 5, 8, 1), 1 / np.sqrt(5 * 5 * 8))
    w3 = u((2, 3, 3, 1, 1), 1 / 3)
    alphas = t(rng.uniform(0.1, 0.4, (2, 2)))
    dy = t(rng.standard_normal((n, 2, h, w)))
    return x, w1, w2, w3, alphas, dy


# pre-activations within this fraction of their largest magnitude count as
# at PReLU's kink: f32 sums of 784 products in another order differ by
# about 1e-6 of it, and there the two sides may take different branches
KINK_REL = 1e-5


def kink_free_cotangent(x, w1, w2, w3, alphas, dy, rel: float = KINK_REL,
                        dtype=torch.float32):
    """``dy`` with zeros wherever a cotangent would reach a pre-activation at
    PReLU's kink, and the fraction zeroed; the pre-activations as K3
    computes them in ``dtype`` (each conv's inputs rounded to it).

    PReLU's derivative jumps at 0, so where u1 or u2 is within summation
    noise of 0 the kernel and the plain version, both right to f32, may
    take different branches and their gradients differ by (1 - alpha) times
    the cotangent there. At the training shape some of the 10^8
    pre-activations are that close to 0. u2 at q is reached from dy on
    q +- 1 (conv3) and u1 at r from dy on r +- 3 (conv5, conv3), per head,
    so dy is zeroed on those windows; everything else is compared."""
    r = rounder(dtype)
    xc = r(x.permute(0, 3, 1, 2))
    keep = []
    for h in range(w1.shape[0]):
        u1 = F.conv2d(xc, r(w1[h]).permute(3, 2, 0, 1), padding=3)
        v1 = torch.where(u1 >= 0, u1, alphas[h, 0] * u1)
        u2 = F.conv2d(r(v1), r(w2[h]).permute(3, 2, 0, 1), padding=2)
        near1 = (u1.abs() <= rel * u1.abs().max()).any(1, keepdim=True)
        near2 = u2.abs() <= rel * u2.abs().max()
        reach = (F.max_pool2d(near1.float(), 7, 1, 3)
                 + F.max_pool2d(near2.float(), 3, 1, 1))
        keep.append(reach == 0)
    keep = torch.cat(keep, dim=1)
    return (dy * keep).to(dy.dtype), 1.0 - keep.float().mean().item()


# K3-bwd's blocks: a tile row of 16 x 16 tiles is walked by blocks of up
# to 16 tiles (csrc/head_stack.cu kT, kWalk); each writes one partial of
# every weight gradient
K3_TILE = 16
K3_WALK = 16
# the 7x7 GEMMs per pixel and head: K3-fwd's u1; K3-bwd's dx and dw1
_HEAD_FWD_GEMM_OPS = 2 * 7 * 7 * 16 * 8
_HEAD_BWD_GEMM_OPS = 2 * 2 * 7 * 7 * 16 * 8


def k3_bwd_blocks(n: int, h: int, w: int) -> int:
    """Blocks (and partials of each weight gradient) of a K3-bwd launch."""
    tiles_x = -(-w // K3_TILE)
    return n * -(-h // K3_TILE) * -(-tiles_x // K3_WALK)


def k3_bounds(n: int, h: int, w: int, keep_u1: bool = True,
              dtype=torch.float32) -> dict:
    """Least times of K3-fwd and K3-bwd in ``dtype``: their operations (both
    heads) over the f32 CUDA-core rate, against x, dy, y, dx (in the dtype),
    the kept u1 (f32; written by the forward when ``keep_u1``, as in
    training; read by the backward) and the weights moved once. ``fwd_tc``
    and ``bwd_tc`` bound the kernels as they compute: the 7x7 GEMMs per
    pixel (the forward's u1; the backward's dx and dw1) on the tensor cores
    (3xTF32 in f32, bf16 in bf16) plus the rest (the 5x5 and 3x3 convs,
    their gradients) on the CUDA cores; the backward's bytes also count
    each block's weight-gradient partials."""
    pix = n * h * w
    elt = torch.empty((), dtype=dtype).element_size()
    weights = 2 * (7 * 7 * 16 * 8 + 5 * 5 * 8 + 3 * 3 + 2) * 4
    fwd_bytes = pix * ((16 + 2) * elt + (16 * 4 if keep_u1 else 0)) + weights
    bwd_bytes = pix * ((16 + 16 + 2) * elt + 16 * 4) + weights
    fwd_gemm = 2 * pix * _HEAD_FWD_GEMM_OPS
    bwd_gemm = 2 * pix * _HEAD_BWD_GEMM_OPS
    f32 = PEAK_FLOPS[torch.float32]
    tc = PEAK_3XTF32 if dtype == torch.float32 else PEAK_FLOPS[dtype]
    return {"fwd": _bound(2 * pix * _HEAD_FWD_OPS, fwd_bytes),
            "fwd_tc": _mixed_bound(
                [(fwd_gemm, tc),
                 (2 * pix * _HEAD_FWD_OPS - fwd_gemm, f32)], fwd_bytes),
            "bwd": _bound(2 * pix * _HEAD_BWD_OPS, bwd_bytes + weights),
            "bwd_tc": _mixed_bound(
                [(bwd_gemm, tc),
                 (2 * pix * _HEAD_BWD_OPS - bwd_gemm, f32)],
                bwd_bytes + k3_bwd_blocks(n, h, w) * weights)}


def library_heads(xc, w1, w2, w3, alphas):
    """The two heads as the unfused model runs them: cuDNN convolutions on
    NCHW input (OIHW weights); a yardstick only."""
    out = []
    for h in range(2):
        v = xc
        for w, a in ((w1[h], alphas[h, 0]), (w2[h], alphas[h, 1]),
                     (w3[h], None)):
            v = F.conv2d(v, w, padding=w.shape[-1] // 2)
            if a is not None:
                v = torch.where(v >= 0, v, a * v)
        out.append(v[:, 0])
    return torch.stack(out, dim=1)


def check_heads(device, shape=(TRAIN_BATCH, TRAIN_TILE, TRAIN_TILE),
                iters: int = 5, dtype=torch.float32) -> dict:
    """Phase 7 (7b in bf16): K3-fwd (y and the u1 it keeps) and K3-bwd
    (from that u1) against their plain versions at the training shape, x
    and dy in ``dtype``, with the tolerances of K3_TOL (K3_TOL_BF16): the
    plain backward takes the kernel's u1, so both take PReLU1's branch from
    the same pre-activation; the cotangent is free of u2's kink
    (``kink_free_cotangent``), which both recompute. The forward without u1
    (painting) must give the same y. Each timed, the forward with and
    without u1 kept, beside cuDNN's unfused heads forward and (under
    autograd) backward in the same dtype (bf16: on ``channels_last``)."""
    t0 = time.perf_counter()
    device = torch.device(device)
    bf16 = dtype == torch.bfloat16
    tols = K3_TOL_BF16 if bf16 else K3_TOL
    x, w1, w2, w3, al, dy = head_inputs(*shape, device)
    x, dy = x.to(dtype), dy.to(dtype)
    with torch.no_grad():
        dy_check, zeroed = kink_free_cotangent(x, w1, w2, w3, al, dy,
                                               dtype=dtype)
    y, u1 = head_stack_fwd(x, w1, w2, w3, al, keep_u1=True)
    y_paint = head_stack_fwd(x, w1, w2, w3, al)
    got = dict(zip(tols, (y, u1, *head_stack_bwd(x, w1, w2, w3, al,
                                                 dy_check, u1=u1))))
    y_ref, u1_ref = head_stack_ref(x, w1, w2, w3, al, keep_u1=True)
    want = dict(zip(tols, (y_ref, u1_ref, *head_stack_bwd_ref(
        x, w1, w2, w3, al, dy_check, u1=u1))))
    _sync(device)
    same_y = torch.equal(y_paint, y)
    dtypes = {k: str(v.dtype).replace("torch.", "") for k, v in got.items()}
    errs = {k: _rel_err(got[k], want[k]) for k in tols}
    abs_errs = {k: (got[k].float() - want[k].float()).abs().max().item()
                for k in tols}
    del got, want, y_paint, y_ref, u1_ref
    print(f"  K3 {dtype}: cotangent zeroed near PReLU's kink: {zeroed:.3e} "
          f"of dy; outputs {json.dumps(dtypes)}", flush=True)
    for name, err in errs.items():
        print(f"  K3 {name}: max|k-ref|/max|ref|={err:.3e} "
              f"tol={tols[name]:.0e}", flush=True)
    bad = {k: v for k, v in errs.items() if not v <= tols[k]}
    want_dt = str(dtype).replace("torch.", "")
    bad_dt = {k: v for k, v in dtypes.items()
              if v != (want_dt if k in ("y", "dx") else "float32")}
    if bad or not same_y or bad_dt:
        raise AssertionError(f"K3 ({dtype}) disagrees with its plain "
                             f"version: {bad}; y without u1 kept equals y "
                             f"with: {same_y}; wrong output dtypes {bad_dt}")
    oihw = lambda w: w.permute(0, 4, 3, 1, 2).to(dtype).contiguous()
    xc = x.permute(0, 3, 1, 2)
    xc = xc if bf16 else xc.contiguous()   # bf16: channels_last
    lib_args = [t.clone().requires_grad_() for t in
                (xc, oihw(w1), oihw(w2), oihw(w3), al)]
    if bf16:
        lib_args[0] = x.permute(0, 3, 1, 2).detach().requires_grad_()
    out = {"dtype": want_dt, "errors": errs, "abs_errors": abs_errs,
           "kink_zeroed": zeroed,
           **{f"{k}_bound": v
              for k, v in k3_bounds(*shape, dtype=dtype).items()}}
    with torch.no_grad():
        out["fwd_ms"] = _time_ms(
            lambda: head_stack_fwd(x, w1, w2, w3, al, keep_u1=True), device,
            1, iters)
        out["fwd_without_u1_ms"] = _time_ms(
            lambda: head_stack_fwd(x, w1, w2, w3, al), device, 1, iters)
        out["fwd_plain_ms"] = _time_ms(
            lambda: head_stack_ref(x, w1, w2, w3, al, keep_u1=True), device,
            1, iters)
        out["fwd_library_ms"] = _time_ms(lambda: library_heads(*lib_args),
                                         device, 1, iters)
        out["bwd_ms"] = _time_ms(
            lambda: head_stack_bwd(x, w1, w2, w3, al, dy, u1=u1), device, 1,
            iters)
        out["bwd_plain_ms"] = _time_ms(
            lambda: head_stack_bwd_ref(x, w1, w2, w3, al, dy, u1=u1), device,
            1, iters)
    y = library_heads(*lib_args)
    out["bwd_library_ms"] = _time_ms(
        lambda: torch.autograd.grad(y, lib_args, dy, retain_graph=True),
        device, 1, iters)
    del y
    tc = "bf16" if bf16 else "3xtf32"
    _line("7b" if bf16 else 7, "k3_vs_plain_bf16" if bf16 else "k3_vs_plain",
          t0, shape=list(shape), fwd_ms=f"{out['fwd_ms']:.3f}",
          fwd_without_u1_ms=f"{out['fwd_without_u1_ms']:.3f}",
          fwd_plain_ms=f"{out['fwd_plain_ms']:.3f}",
          fwd_library_ms=f"{out['fwd_library_ms']:.3f}",
          **{f"fwd_bound_ms_{tc}": f"{out['fwd_tc_bound']['bound_ms']:.3f}"},
          fwd_bound_ms_cuda_cores=f"{out['fwd_bound']['bound_ms']:.3f}",
          bwd_ms=f"{out['bwd_ms']:.3f}",
          bwd_plain_ms=f"{out['bwd_plain_ms']:.3f}",
          bwd_library_ms=f"{out['bwd_library_ms']:.3f}",
          **{f"bwd_bound_ms_{tc}": f"{out['bwd_tc_bound']['bound_ms']:.3f}"},
          bwd_bound_ms_cuda_cores=f"{out['bwd_bound']['bound_ms']:.3f}")
    return out


def make_trainer(device, dataset, fused_heads: bool, use_kernel="auto",
                 n_res_blocks: int = N_RES_BLOCKS, seed: int = 0,
                 fused_train_conv: bool = False, dtype=None,
                 config: dict = None, variables: dict = None, mesh=None):
    """The fiducial trainer on ``dataset`` with the stack cache; ``config``
    adds ``TrainConfig`` fields, ``variables`` (JAX layout) replaces the
    seeded initialisation; ``mesh`` (a ``ProcessMesh``) trains data
    parallel, the cache z-sharded."""
    from baryon_painter_tpu_torch.models.cvae import (
        CVAE, fiducial_cvae_architecture)
    from baryon_painter_tpu_torch.train.trainer import (CVAETrainer,
                                                        TrainConfig)
    arch = fiducial_cvae_architecture(dataset.tile_size,
                                      n_res_blocks=n_res_blocks)
    model = CVAE(arch, fused_heads=fused_heads,
                 fused_train_conv=fused_train_conv, dtype=dtype)
    return CVAETrainer(model, dataset,
                       config=TrainConfig(seed=seed, **(config or {})),
                       device_data=True, device=device, use_kernel=use_kernel,
                       variables=variables, mesh=mesh)


def k4_sites_per_step(tile: int) -> int:
    """K4 calls in one fiducial training step: the three up-convs, and the
    input conv where its rows pass the space-to-depth rule (h >= 128)."""
    return 4 if tile >= 128 else 3


def train(device, dataset, batch: int = TRAIN_BATCH, warmup: int = 3,
          iters: int = 10, n_res_blocks: int = N_RES_BLOCKS,
          lr: float = 1e-4, card=None, fused_train_conv: bool = False,
          k4_off_ms=None, dtype=None, f32_ms=None, config: dict = None,
          variables: dict = None, phase=None, extra: dict = None) -> dict:
    """Phase 8 (11 with ``fused_train_conv``, 13 in bf16, 15 in bf16 with
    ``fused_train_conv``), a main path: ``warmup``
    then ``iters`` timed training steps (``step_indices``: batch gathered on
    the device through K2, heads through K3, and with ``fused_train_conv``
    the gated conv + batch norm + ReLU triples through K4) from the port's
    own initialisation, the model computing in ``dtype``. Per timed step
    on the card exactly one K2, K3-fwd (keeping u1) and K3-bwd launch (in
    bf16 both K3 launches in bf16) and, with K4, ``k4_sites_per_step`` of
    each K4 kernel (in bf16 all of them bf16 launches); finite metrics; the
    parameters change. Host clock around steps that end in a synchronise;
    the peak device memory of the timed steps; ``k4_off_ms`` (phase 8's or
    13's step) and ``f32_ms`` are printed beside. ``config`` and
    ``variables`` go to ``make_trainer``; with the spectral term
    (``pk_loss_weight`` > 0, phase 20c) the heads run twice a step, K3-fwd
    and K3-bwd launching twice, both K3-fwd launches keeping u1;
    ``phase`` names the printed line, ``extra`` adds fields to it."""
    t0 = time.perf_counter()
    device = torch.device(device)
    bf16 = dtype == torch.bfloat16
    heads = 2 if (config or {}).get("pk_loss_weight", 0) > 0 else 1
    trainer = make_trainer(device, dataset, True, n_res_blocks=n_res_blocks,
                           fused_train_conv=fused_train_conv, dtype=dtype,
                           config=config, variables=variables)
    rng = np.random.default_rng(1)
    idx = [dataset.sample_indices(rng, batch) for _ in range(warmup + iters)]
    before = [p.detach().clone() for p in trainer.params]
    for i in range(warmup):
        trainer.step_indices(idx[i], lr)
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    _reset_launches()
    t1 = time.perf_counter()
    metrics = [trainer.step_indices(idx[warmup + i], lr)
               for i in range(iters)]
    _sync(device)
    step_ms = (time.perf_counter() - t1) * 1e3 / iters
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else None)
    counts = _launches()
    n = iters if device.type == "cuda" else 0
    want = {"k2": n, "k3_fwd": heads * n, "k3_bwd": heads * n}
    want_bf16 = {"k3_fwd": heads * n, "k3_bwd": heads * n} if bf16 else {}
    if fused_train_conv:
        sites = k4_sites_per_step(dataset.tile_size)
        k4 = {f"k4_{k}": sites * n for k in K4_KERNELS}
        want.update(k4)
        if bf16:
            want_bf16.update(k4)
    bf16_counts = _bf16_launches()
    _expect_launches("train (bf16 launches)", bf16_counts, want_bf16)
    _expect_launches("train", counts, want)
    if head_stack_fwd.kept_u1 != heads * n:
        raise AssertionError(f"train: K3-fwd kept u1 in "
                             f"{head_stack_fwd.kept_u1} of {heads * n} "
                             f"launches")
    finite = all(bool(torch.isfinite(v).all()) for m in metrics
                 for v in m.values())
    changed = any(not torch.equal(a, b) for a, b in zip(before,
                                                        trainer.params))
    if not (finite and changed):
        raise AssertionError(f"training: finite metrics {finite}, "
                             f"parameters changed {changed}")
    out = {"step_ms": step_ms, "samples_per_s": batch / step_ms * 1e3,
           "batch": batch, "launches": counts, "peak_bytes": peak,
           "elbo": [float(m["elbo"]) for m in metrics]}
    out["dtype"] = "bfloat16" if bf16 else "float32"
    out["bf16_launches"] = bf16_counts
    if heads == 2:
        out["pk_loss"] = [float(m["pk_loss"]) for m in metrics]
    extra = dict(extra or {})
    if fused_train_conv and k4_off_ms is not None:
        extra.update(step_ms_k4_off=f"{k4_off_ms:.3f}",
                     samples_per_s_k4_off=f"{batch / k4_off_ms * 1e3:.2f}")
    if f32_ms is not None:
        extra.update(step_ms_f32=f"{f32_ms:.3f}",
                     samples_per_s_f32=f"{batch / f32_ms * 1e3:.2f}")
    phase = phase or {(False, False): (8, "train"),
                      (False, True): (11, "train_k4"),
                      (True, False): (13, "train_bf16"),
                      (True, True): (15, "train_bf16_k4")}[
                          bf16, fused_train_conv]
    _line(*phase, t0,
          clock="host_clock_after_sync", card=json.dumps(card), batch=batch,
          steps=iters, step_ms=f"{step_ms:.3f}",
          samples_per_s=f"{out['samples_per_s']:.2f}", **extra,
          peak_memory_gb=(f"{peak / 1e9:.3f}" if peak is not None
                          else "not_measured_on_cpu"),
          launches=json.dumps(counts),
          bf16_launches=json.dumps(out["bf16_launches"]),
          elbo_first_last=f"{out['elbo'][0]:.4f},{out['elbo'][-1]:.4f}")
    return out


def step_grad_errors(grads_k: dict, grads_p: dict):
    """Each parameter's max|kernel - plain| relative to its own largest
    entry (STEP_GRAD_ZERO's: to STEP_GRAD_FLOOR of the largest entry of
    all), and the parameters whose largest entry lies under that floor with
    their error relative to their own largest entry."""
    top = max(g.abs().max().item() for g in grads_p.values())
    errs, under = {}, {}
    for name, g in grads_p.items():
        diff = (grads_k[name] - g).abs().max().item()
        own = g.abs().max().item()
        scale = max(own, STEP_GRAD_FLOOR * top) if name in STEP_GRAD_ZERO \
            else own
        errs[name] = diff / scale if scale > 0 else diff
        if own < STEP_GRAD_FLOOR * top:
            under[name] = {"max_abs": own,
                           "err_own": diff / own if own > 0 else diff}
    return errs, under, top


def _site_forward_f64(x, w, gamma, beta, transposed, stride, padding,
                      eps):
    """relu(bn_train(conv(x))) in f64, rounded to f32: the site's forward
    as exact as f32 can hold it."""
    conv = F.conv_transpose2d if transposed else F.conv2d
    u = conv(x.double(), w.double(), stride=stride, padding=padding)
    mean = u.mean((0, 2, 3))
    var = (u * u).mean((0, 2, 3)) - mean * mean
    _, a, b = bn_affine(gamma.double(), beta.double(), mean, var, eps)
    y = torch.relu(u * a[:, None, None] + b[:, None, None])
    return y.float(), mean.float(), var.float()


class _PlainSite(torch.autograd.Function):
    """A K4 site in plain PyTorch: the forward ``fwd`` (``conv_bn_relu_ref``'s
    arguments and results), then the plain backward
    (``conv_bn_relu_bwd_ref``) at its statistics, with the ReLU's active set
    ``active`` when given, else the forward's own (y > 0)."""

    @staticmethod
    def forward(ctx, x, w, gamma, beta, transposed, stride, padding, eps,
                fwd, active):
        kw = dict(transposed=transposed, stride=stride, padding=padding)
        y, mean, var = fwd(x, w, gamma, beta, eps=eps, **kw)
        ctx.save_for_backward(x, w, gamma, beta, mean, var,
                              y > 0 if active is None else active)
        ctx.kw = dict(kw, eps=eps)
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, dy, _dmean, _dvar):
        x, w, gamma, beta, mean, var, active = ctx.saved_tensors
        grads = conv_bn_relu_bwd_ref(x, w, gamma, beta, mean, var, dy,
                                     active=active, **ctx.kw)
        return (*grads, None, None, None, None, None, None)


class _k4_sites:
    """Within the block the train-mode triple fusion calls ``site`` in
    place of ``conv_bn_relu`` (same arguments, same results)."""

    def __init__(self, site):
        self._site = site

    def __enter__(self):
        from baryon_painter_tpu_torch.models import layers
        self._layers, self._saved = layers, layers.conv_bn_relu
        layers.conv_bn_relu = self._site

    def __exit__(self, *exc):
        self._layers.conv_bn_relu = self._saved


class _k4_u_in_f64:
    """Within the block K4's plain versions sum u in f64 and round it to
    f32: the same rounding points, the sums in another order."""

    def __enter__(self):
        from baryon_painter_tpu_torch.ops import conv_bn
        self._mod, self._saved = conv_bn, conv_bn._u
        real = self._saved
        conv_bn._u = lambda x, w, *a: real(x.double(), w.double(),
                                           *a).float()

    def __exit__(self, *exc):
        self._mod._u = self._saved


def plain_k4(fwd=conv_bn_relu_ref, masks=None):
    """``_PlainSite`` with the forward ``fwd`` as a ``conv_bn_relu``: with
    ``masks``, each call takes the next active set off the list."""
    def site(x, w, gamma, beta, *, transposed, stride, padding, eps=1e-5):
        active = masks.pop(0) if masks is not None else None
        return _PlainSite.apply(x, w, gamma, beta, transposed, stride,
                                padding, eps, fwd, active)
    return site


class _PlainHeads(torch.autograd.Function):
    """``head_stack`` through K3's plain versions on any device: the
    forward keeps u1 and the backward reads it, as the kernels do."""

    @staticmethod
    def forward(ctx, x, w1, w2, w3, alphas):
        y, u1 = head_stack_ref(x, w1, w2, w3, alphas, keep_u1=True)
        ctx.save_for_backward(x, w1, w2, w3, alphas, u1)
        return y

    @staticmethod
    def backward(ctx, dy):
        x, w1, w2, w3, alphas, u1 = ctx.saved_tensors
        return head_stack_bwd_ref(x, w1, w2, w3, alphas,
                                  dy.to(x.dtype), u1=u1)


class _plain_heads:
    """Within the block the CVAE's fused heads run through ``_PlainHeads``
    in place of K3 (``kernels=False`` leaves them as they are)."""

    def __init__(self, active: bool):
        self._active = active

    def __enter__(self):
        from baryon_painter_tpu_torch.models import cvae
        self._cvae, self._saved = cvae, cvae.head_stack
        if self._active:
            cvae.head_stack = _PlainHeads.apply

    def __exit__(self, *exc):
        self._cvae.head_stack = self._saved


def step_gradients(device, dataset, idx, eps, kernels: bool,
                   fused_train_conv: bool, site=None,
                   n_res_blocks: int = N_RES_BLOCKS, dtype=None,
                   plain_heads: bool = False, config: dict = None,
                   variables: dict = None, pk_eps=None,
                   metrics: dict = None):
    """One training step from the seeded initialisation on the batch
    ``idx`` with the latent noise ``eps``, the model in ``dtype``, cuDNN on
    its deterministic algorithms: (loss, each trainable parameter's
    gradient by name). ``kernels``: K2's gather and K3's heads, else the
    plain versions and cuDNN's heads; ``plain_heads``: the plain gather
    and the fused heads through K3's plain versions; ``site`` runs in place
    of ``conv_bn_relu`` at the sites ``fused_train_conv`` fuses.
    ``config``, ``variables`` go to ``make_trainer``, ``pk_eps`` is the
    spectral term's prior noise; ``metrics`` receives the step's metrics
    as floats."""
    trainer = make_trainer(device, dataset, kernels or plain_heads,
                           use_kernel=kernels, n_res_blocks=n_res_blocks,
                           fused_train_conv=fused_train_conv, dtype=dtype,
                           config=config, variables=variables)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        with _k4_sites(site or conv_bn_relu), _plain_heads(plain_heads):
            m = trainer.step_indices(idx, 1e-4, eps=eps, pk_eps=pk_eps)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if metrics is not None:
        metrics.update({k: float(v.float().sum()) for k, v in m.items()})
    return float(m["elbo"]), {
        n: p.grad.detach().clone()
        for n, p in trainer.model.named_parameters() if p.requires_grad}


def step_gradients_f64(device, dataset, idx, eps,
                       n_res_blocks: int = N_RES_BLOCKS):
    """The whole-model f64 reference of 8b and 11b: the same step (the
    seeded initialisation, the batch ``idx``, the latent noise ``eps``)
    with every module in f64 (``CVAE(dtype=torch.float64)``, its
    parameters ``.double()``): the plain gather, cuDNN's heads and trunk
    (deterministic), the batch norms' statistics and the ELBO in f64; it
    uses none of the code under test. The batch is transformed in f32, as
    every step's is. Returns (loss, each trainable parameter's gradient by
    name), f64."""
    trainer = make_trainer(device, dataset, False, use_kernel=False,
                           n_res_blocks=n_res_blocks, dtype=torch.float64)
    model = trainer.model.double()
    cache = trainer.device_cache
    raw_input, raw_labels, z = cache.gather(cache.digits(idx))
    x, y = trainer._prepare(raw_input, raw_labels, z)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        out = model(x.double(), y.double(), z.double(),
                    eps=torch.as_tensor(eps).double())
        (-out["elbo"]).backward()
    finally:
        torch.backends.cudnn.deterministic = deterministic
    return float(out["elbo"].detach()), {
        n: p.grad.detach().clone()
        for n, p in model.named_parameters() if p.requires_grad}


def parity_inputs(dataset, batch: int):
    """The seeded batch and latent noise of ``train_parity``."""
    idx = dataset.sample_indices(np.random.default_rng(2), batch)
    hz = dataset.tile_size // 32
    return idx, torch.randn((1, batch, 1, hz, hz),
                            generator=torch.Generator().manual_seed(3))


def _worst(errs: dict, ref: dict, n: int = 5) -> str:
    return ", ".join(f"{k}: {errs[k]:.2e} (max|g| {ref[k].abs().max():.2e})"
                     for k in sorted(errs, key=errs.get)[-n:])


def train_parity(device, dataset, batch: int = TRAIN_BATCH,
                 n_res_blocks: int = N_RES_BLOCKS,
                 fused_train_conv: bool = False) -> dict:
    """Phase 8b (11b with ``fused_train_conv``): one step with the kernels
    (K2, K3, and with ``fused_train_conv`` K4) against steps with plain
    versions from the same initialisation, batch and latent noise
    (``step_gradients``). The loss to STEP_LOSS_RTOL of the plain step's
    (``use_kernel=False``, cuDNN heads and trunk). The gradients
    (``step_grad_errors``, worst over the parameters): in 8b against the
    plain step, to STEP_GRAD_TOL. Prints every parameter whose gradient
    lies under STEP_GRAD_FLOOR of the largest entry of all.

    In 11b against the plain step with the four sites' forward computed in
    f64 and rounded to f32 (``_site_forward_f64``) and the plain
    closed-form backward there (``_PlainSite``): the step as exact as f32
    can hold the sites. The gradients move by about STEP_GRAD_TOL under
    the f32 rounding of the sites' batch statistics, so the K4 step is held
    to STEP_GRAD_TOL of that step, or, where the plain step (the sites in
    f32 plain PyTorch) lies further from it, to the plain step's distance:
    K4 may round no worse than the plain version. Both readings and the
    K4 step against the wholly plain step are printed.
    ``scripts/step_parity_witness.py`` prints the other comparisons.

    Both phases also hold the kernels step against the whole-model f64
    step (``step_gradients_f64``): its loss to STEP_LOSS_RTOL, and each
    gradient leaf (STEP_GRAD_ZERO's to the floor, as above) to
    max(STEP_GRAD_TOL, STEP_F64_FACTOR times the plain step's distance
    from f64 for the same leaf). The plain f32 step itself lies 1.66e-2
    from f64 at full size, with cuDNN's f32 convolutions (1.04e-3 with
    PyTorch's own, ``scripts/step_f64_witness_torch.py``; ROADMAP.md
    section 3): the kernels may round no worse than the plain version."""
    t0 = time.perf_counter()
    device = torch.device(device)
    idx, eps = parity_inputs(dataset, batch)
    # label: (fused heads and gather kernel, fused sites, their function)
    plans = {"kernels": (True, fused_train_conv, None),
             "plain": (False, False, None)}
    if fused_train_conv:
        plans["plain_sites"] = (False, True, plain_k4())
        plans["sites_f64"] = (False, True, plain_k4(_site_forward_f64))
    runs = {label: step_gradients(device, dataset, idx, eps, kernels, k4,
                                  site, n_res_blocks)
            for label, (kernels, k4, site) in plans.items()}
    runs["f64"] = step_gradients_f64(device, dataset, idx, eps, n_res_blocks)
    loss_k, grads_k = runs["kernels"]
    loss_p = runs["plain"][0]
    ref = "sites_f64" if fused_train_conv else "plain"
    grads_p = runs[ref][1]
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    grad_errs, under, top = step_grad_errors(grads_k, grads_p)
    phase = "11b" if fused_train_conv else "8b"
    for name, u in under.items():
        print(f"  under the floor ({STEP_GRAD_FLOOR:.0e} of max|g| "
              f"{top:.2e}): {name}: max|g| {u['max_abs']:.2e}, max|k-p| / "
              f"own max {u['err_own']:.2e}"
              + (" (STEP_GRAD_ZERO)" if name in STEP_GRAD_ZERO else ""),
              flush=True)
    worst = max(grad_errs, key=grad_errs.get)
    worst5 = _worst(grad_errs, grads_p)
    witness, limit = {}, STEP_GRAD_TOL
    if fused_train_conv:
        for a, b in (("plain_sites", "sites_f64"), ("kernels", "plain")):
            errs = step_grad_errors(runs[a][1], runs[b][1])[0]
            witness[f"{a}_vs_{b}"] = max(errs.values())
            print(f"  {a} against {b}, worst gradients: "
                  f"{_worst(errs, runs[b][1])}", flush=True)
        limit = max(STEP_GRAD_TOL, witness["plain_sites_vs_sites_f64"])
    print(f"  worst gradients against {ref} (max|g| of all {top:.2e}; "
          f"limit {limit:.3e}): {worst5}", flush=True)
    # against the whole-model f64 step: the kernels step, and the wholly
    # plain f32 step beside it
    loss64, grads64 = runs["f64"]
    f64, errs64 = {}, {}
    for label in ("kernels", "plain"):
        errs64[label] = errs = step_grad_errors(runs[label][1], grads64)[0]
        worst64 = max(errs, key=errs.get)
        f64[label] = {"loss_rel_err": abs(runs[label][0] - loss64)
                      / abs(loss64), "worst_grad": worst64,
                      "worst_grad_rel_err": errs[worst64]}
        print(f"  {label} against f64: loss {f64[label]['loss_rel_err']:.3e}"
              f", worst gradients {_worst(errs, grads64)}", flush=True)
    # each leaf's share of its limit against f64
    share64 = {n: e / max(STEP_GRAD_TOL, STEP_F64_FACTOR * errs64["plain"][n])
               for n, e in errs64["kernels"].items()}
    worst_share = max(share64, key=share64.get)
    f64["kernels"].update(limit_share=share64[worst_share],
                          limit_share_leaf=worst_share)
    print(f"  kernels against f64, worst shares of max(STEP_GRAD_TOL, "
          f"{STEP_F64_FACTOR} x plain against f64): "
          + ", ".join(f"{n}: {share64[n]:.3f}"
                      for n in sorted(share64, key=share64.get)[-5:]),
          flush=True)
    if not (loss_err <= STEP_LOSS_RTOL and grad_errs[worst] <= limit
            and f64["kernels"]["loss_rel_err"] <= STEP_LOSS_RTOL
            and share64[worst_share] <= 1.0):
        raise AssertionError(f"kernels step against {ref}: loss rel err "
                             f"{loss_err:.3e}; largest gradient entry "
                             f"{top:.3e}; gradient limit {limit:.3e}; "
                             f"worst gradients {worst5}; against f64 "
                             f"{f64['kernels']}")
    _line(phase, "train_parity", t0, elbo_kernels=f"{loss_k:.6f}",
          elbo_plain=f"{loss_p:.6f}", loss_rel_err=f"{loss_err:.3e}",
          reference=ref, worst_grad=worst,
          worst_grad_rel_err=f"{grad_errs[worst]:.3e}",
          grad_limit=f"{limit:.3e}", params=len(grad_errs),
          under_floor=len(under),
          f64_loss_rel_err=f"{f64['kernels']['loss_rel_err']:.3e}",
          f64_worst_grad=f64["kernels"]["worst_grad"],
          f64_worst_grad_rel_err=(
              f"{f64['kernels']['worst_grad_rel_err']:.3e}"),
          plain_f64_worst_grad_rel_err=(
              f"{f64['plain']['worst_grad_rel_err']:.3e}"),
          f64_limit_share=f"{share64[worst_share]:.3f}",
          f64_limit_share_leaf=worst_share,
          **{k: f"{v:.3e}" for k, v in witness.items()})
    return {"loss_rel_err": loss_err, "reference": ref, "worst_grad": worst,
            "worst_grad_rel_err": grad_errs[worst], "grad_limit": limit,
            "under_floor": under, "witness": witness, "f64": f64}


# ---------------------------------------------------------------------- #
# bf16 (the JAX package's default compute dtype): painting and training

# the JAX package's bf16 paint of the golden input at the prior mean, in
# the transformed space, op by op, its f32 paint, their distance
# d_bf16_f32 and the distance d_bf16_jit of the package's own jitted bf16
# paint from it (scripts/make_bf16_paint_reference.py)
BF16_REFERENCE = "tests/goldens/bf16_paint_reference.npz"
# The port's bf16 paint lies no further from the JAX bf16 paint than
# max(BF16_PAINT_HALF * d_bf16_f32, d_bf16_jit), and at least
# BF16_REAL_RATIO * d_bf16_f32 from the port's f32 paint (a paint that is
# not bf16 fails). Two bf16 computations with the same rounding points but
# sums in another order drift apart by a bf16 step wherever a sum lands
# next to a rounding boundary, and the next layers carry that on: the
# JAX package's jitted paint lies 0.84 of d_bf16_f32 from its op-by-op one
BF16_PAINT_HALF = 0.5
BF16_REAL_RATIO = 0.5
# the kernels-vs-plain bf16 training step: the concatenated gradient's
# relative L2 distance from the plain step's, against the plain bf16
# step's distance from the plain f32 step
BF16_STEP_RATIO = 0.5


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| in f64, of tensors or arrays."""
    a = torch.as_tensor(a).double().cpu()
    b = torch.as_tensor(b).double().cpu()
    return float(torch.linalg.vector_norm(a - b)
                 / torch.linalg.vector_norm(b))


def paint_bf16(device, repo: Path = REPO, card=None, f32_ms=None,
               n_tiles: int = 16, warmup: int = 2, iters: int = 10,
               check: bool = True) -> dict:
    """Phase 14, a main path: the golden input painted in bf16 through
    ``CVAEPainter(dtype=torch.bfloat16, fused_inference=True,
    fused_heads=True)`` at the prior mean in the transformed space: on the
    card exactly 4 K1 and 1 K3-fwd launches, all in bf16, no u1 kept; held
    to the committed JAX bf16 paint (``BF16_REFERENCE``) within
    max(BF16_PAINT_HALF * its bf16-f32 distance, its jitted paint's
    distance), and at least BF16_REAL_RATIO of the bf16-f32 distance from
    the port's own f32 paint. Then
    ``paint_batch`` at ``n_tiles`` timed as phase 9 times it in f32
    (``f32_ms``)."""
    from baryon_painter_tpu_torch.painter import CVAEPainter
    t0 = time.perf_counter()
    device = torch.device(device)
    kw = dict(fused_inference=True, fused_heads=True, device=device)
    painter = CVAEPainter(str(repo / CHECKPOINT), dtype=torch.bfloat16, **kw)
    painter_f32 = CVAEPainter(str(repo / CHECKPOINT), **kw)
    with np.load(repo / BF16_REFERENCE) as r:
        jax_bf16, jax_f32 = r["jax_bf16"], r["jax_f32"]
        gap, d_jit = float(r["d_bf16_f32"]), float(r["d_bf16_jit"])
    limit = max(BF16_PAINT_HALF * gap, d_jit)
    tiles, zs = golden_inputs(512, 1), np.zeros(1, np.float32)
    paint = lambda p: p.paint_batch(tiles, zs, z_mode="mean",
                                    inverse_transform=False)
    _reset_launches()
    out = paint(painter)
    _sync(device)
    counts, bf16_counts = _launches(), _bf16_launches()
    kept = head_stack_fwd.kept_u1
    on_card = device.type == "cuda"
    _expect_launches("paint (bf16)", counts, {"k1": 4 if on_card else 0,
                                              "k3_fwd": 1 if on_card else 0})
    _expect_launches("paint (bf16 launches)", bf16_counts,
                     {"k1": 4, "k3_fwd": 1} if on_card else {})
    out_f32 = paint(painter_f32)
    got = out.float().cpu().numpy()
    d_ref = rel_l2(got, jax_bf16)
    d_real = rel_l2(got, out_f32)
    d_f32 = rel_l2(out_f32, jax_f32)
    res = {"dtype": str(out.dtype), "d_jax_bf16": d_ref, "d_port_f32": d_real,
           "d_f32_vs_jax_f32": d_f32, "gap": gap, "d_jax_jit": d_jit,
           "limit": limit, "ratio": d_ref / gap, "real_ratio": d_real / gap,
           "launches": counts, "bf16_launches": bf16_counts}
    ok = (out.dtype == torch.bfloat16 and got.shape == jax_bf16.shape
          and bool(np.all(np.isfinite(got))) and kept == 0
          and d_ref <= limit
          and d_real >= BF16_REAL_RATIO * gap)
    if check and not ok:
        raise AssertionError(f"bf16 paint against the JAX bf16 reference: "
                             f"{res}, u1 kept {kept}")
    ms = paint_time_ms(device, painter, n_tiles, warmup, iters)
    res.update(paint_ms=ms, tiles_per_s=n_tiles / ms * 1e3, painter=painter)
    _line(14, "paint_bf16", t0, card=json.dumps(card),
          launches=json.dumps(counts), bf16_launches=json.dumps(bf16_counts),
          d_jax_bf16=f"{d_ref:.4e}", jax_bf16_f32_gap=f"{gap:.4e}",
          ratio=f"{d_ref / gap:.4f}", limit_ratio=f"{limit / gap:.4f}",
          jax_jit_ratio=f"{d_jit / gap:.4f}",
          real_ratio=f"{d_real / gap:.4f}", f32_vs_jax_f32=f"{d_f32:.2e}",
          paint_ms=f"{ms:.3f}", n_tiles=n_tiles,
          tiles_per_s=f"{n_tiles / ms * 1e3:.2f}",
          paint_ms_f32=(f"{f32_ms:.3f}" if f32_ms is not None else None),
          tiles_per_s_f32=(f"{n_tiles / f32_ms * 1e3:.2f}"
                           if f32_ms is not None else None))
    return res


def _grad_vector(grads: dict) -> torch.Tensor:
    return torch.cat([grads[k].detach().double().flatten().cpu()
                      for k in sorted(grads)])


def train_parity_bf16(device, dataset, batch: int = TRAIN_BATCH,
                      n_res_blocks: int = N_RES_BLOCKS,
                      check: bool = True,
                      fused_train_conv: bool = False) -> dict:
    """Phase 13b (15b with ``fused_train_conv``): one bf16 step with the
    kernels (K2, K3 in bf16, and K4 in bf16 at the fused sites) against the
    bf16 step with their plain versions (the plain gather; the fused heads
    through ``head_stack_ref``/``head_stack_bwd_ref``; the fused sites
    through ``conv_bn_relu_ref``/``conv_bn_relu_bwd_ref``, ``plain_k4``),
    from the same initialisation, batch and latent noise: the concatenated
    gradient's relative L2 distance within BF16_STEP_RATIO of the plain
    bf16 step's distance from the plain f32 step (the same plain versions,
    in f32). The worst parameters (each to its own largest entry) and, in
    13b, the step with cuDNN's bf16 heads are printed; in 15b also the
    chaos floor: how far the plain bf16 step moves when only the sites'
    sums change order (their u summed in f64, ``_k4_u_in_f64``), against
    the same distance."""
    t0 = time.perf_counter()
    device = torch.device(device)
    idx, eps = parity_inputs(dataset, batch)
    k4 = fused_train_conv
    site = {"site": plain_k4()} if k4 else {}
    plans = {"kernels": dict(kernels=True, dtype=torch.bfloat16),
             "plain": dict(kernels=False, plain_heads=True,
                           dtype=torch.bfloat16, **site),
             "plain_f32": dict(kernels=False, plain_heads=True, **site)}
    if not k4:
        plans["cudnn_heads"] = dict(kernels=False, dtype=torch.bfloat16)
    runs = {label: step_gradients(device, dataset, idx, eps,
                                  fused_train_conv=k4,
                                  n_res_blocks=n_res_blocks, **kw)
            for label, kw in plans.items()}
    if k4:
        with _k4_u_in_f64():
            runs["plain_order"] = step_gradients(
                device, dataset, idx, eps, fused_train_conv=k4,
                n_res_blocks=n_res_blocks, **plans["plain"])
    vec = {k: _grad_vector(v[1]) for k, v in runs.items()}
    d_kp = rel_l2(vec["kernels"], vec["plain"])
    gap = rel_l2(vec["plain"], vec["plain_f32"])
    d_order = rel_l2(vec["plain_order"], vec["plain"]) if k4 else None
    d_cudnn = (None if k4 else rel_l2(vec["cudnn_heads"], vec["plain"]))
    loss = {k: v[0] for k, v in runs.items()}
    loss_err = abs(loss["kernels"] - loss["plain"]) / abs(loss["plain"])
    errs = step_grad_errors(runs["kernels"][1], runs["plain"][1])[0]
    worst5 = _worst(errs, runs["plain"][1])
    print(f"  bf16 step, worst gradients against the plain bf16 step: "
          f"{worst5}", flush=True)
    res = {"d_kernels_plain": d_kp, "d_plain_bf16_f32": gap,
           "ratio": d_kp / gap if gap > 0 else 0.0,
           "d_cudnn_heads_plain": d_cudnn, "d_order": d_order,
           "order_ratio": (d_order / gap if k4 and gap > 0 else None),
           "loss": loss,
           "loss_rel_err": loss_err,
           "worst_grad": max(errs, key=errs.get) if errs else None}
    if check and not d_kp <= BF16_STEP_RATIO * gap:
        raise AssertionError(f"bf16 kernels step against the plain bf16 "
                             f"step: {res}; worst gradients {worst5}")
    extra = ({"d_order": f"{d_order:.4e}",
              "order_ratio": f"{res['order_ratio']:.4f}"} if k4
             else {"d_cudnn_heads_plain": f"{d_cudnn:.4e}"})
    _line("15b" if k4 else "13b",
          "train_parity_bf16_k4" if k4 else "train_parity_bf16", t0,
          d_kernels_plain=f"{d_kp:.4e}", d_plain_bf16_f32=f"{gap:.4e}",
          ratio=f"{res['ratio']:.4f}", limit_ratio=BF16_STEP_RATIO, **extra,
          loss_rel_err=f"{loss_err:.3e}", worst_grad=res["worst_grad"])
    return res


def paint_fused_heads(device, card=None, heads_unfused_ms=None,
                      n_tiles: int = 16, warmup: int = 2,
                      iters: int = 10) -> dict:
    """Phase 9, a main path: the golden painted with the heads through K3
    (``CVAEPainter(fused_inference=True, fused_heads=True)``: 4 K1 and 1
    K3-fwd launches a call), then timed as phase 4 times the painter with
    cuDNN's heads (``heads_unfused_ms``). Painting keeps no u1: no K3-fwd
    launch of the golden or the timed calls writes one."""
    t0 = time.perf_counter()
    device = torch.device(device)
    paint = paint_golden(device, fused_heads=True, phase=9)
    ms = paint_time_ms(device, paint["painter"], n_tiles, warmup, iters)
    if head_stack_fwd.kept_u1:   # counted since the golden's launch
        raise AssertionError(f"paint: K3-fwd kept u1 in "
                             f"{head_stack_fwd.kept_u1} launches; painting "
                             f"keeps none")
    _line(9, "paint_timing_fused_heads", t0, card=json.dumps(card),
          paint_ms=f"{ms:.3f}", n_tiles=n_tiles,
          k3_fwd_launches_keeping_u1=head_stack_fwd.kept_u1,
          tiles_per_s=f"{n_tiles / ms * 1e3:.2f}",
          paint_ms_cudnn_heads=(f"{heads_unfused_ms:.3f}"
                                if heads_unfused_ms is not None else None))
    return {"paint_ms": ms, **paint}


def k4_site_shape(site: dict, batch: int, tile: int) -> dict:
    """The site's shapes at ``tile`` (its input edge scales with the tile)."""
    h = site["h"] * tile // TRAIN_TILE
    s = site["stride"] if site["transposed"] else 1
    return dict(n=batch, h=h, ho=h * s)


def k4_inputs(site: dict, batch: int, tile: int, device, seed: int = 0):
    """Seeded K4 operands at a site: x half-normal (the ReLU outputs and
    range-compressed fields the sites read are mostly positive), the kernel
    U(-b, b) with PyTorch's default bound b = 1/sqrt(k*k*C_in), gamma
    U(0.5, 1.5), beta N(0, 0.1^2), the cotangent dy standard normal."""
    sh = k4_site_shape(site, batch, tile)
    rng = np.random.default_rng(seed)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    cin, cout, k = site["cin"], site["cout"], site["k"]
    x = t(np.abs(rng.standard_normal((batch, cin, sh["h"], sh["h"]))))
    wshape = (cin, cout, k, k) if site["transposed"] else (cout, cin, k, k)
    w = t(rng.uniform(-1, 1, wshape) / np.sqrt(k * k * cin))
    gamma = t(rng.uniform(0.5, 1.5, cout))
    beta = t(0.1 * rng.standard_normal(cout))
    dy = t(rng.standard_normal((batch, cout, sh["ho"], sh["ho"])))
    return x, w, gamma, beta, dy


def k4_stats_rows(site: dict, batch: int, tile: int) -> int:
    """Partial rows K4-stats writes at a site: one a block of the u GEMM
    (output phases x 16-column tiles x 8 R-row tiles of the input grid, R
    = 2 up to 32 output channels, and per sample), as
    ``bpt_conv_bn_bwd1_tiles`` counts them."""
    h = k4_site_shape(site, batch, tile)["h"]
    s = site["stride"] if site["transposed"] else 1
    rows = 2 if -(-min(site["cout"], 64) // 8) * 8 <= 32 else 1
    return batch * s * s * -(-h // 16) * -(-h // (8 * rows))


def k4_bounds(site: dict, batch: int, tile: int,
              dtype=torch.float32) -> dict:
    """Least time of each K4 kernel at a site, x, w, y, dy and dx in
    ``dtype``: its operations over the f32 CUDA-core rate against its bytes
    over the memory rate. One conv pass is 2 N Ho Wo Cout Cin taps
    operations (taps = k^2, or (k/s)^2 for the transposed conv); stats, fwd
    and bwd1 need one pass and bwd2 three (u again, dx and dW), plus a few
    elementwise operations per output. Bytes: x and the weights read once,
    and y (fwd), dy (bwd1, bwd2), dx and dW (bwd2) moved once, at dtype's
    size; u and the partial sums are f32. The ``*_tc`` bounds are the
    kernels' design: the u GEMM, dx and dW on the tensor cores at the
    3xTF32 rate in f32 and the bf16 rate in bf16. ``stats_tc`` one pass,
    reading x and writing u and its partial sums; ``fwd_tc`` no pass, u
    read and y written (in place in f32; bound by memory); ``bwd1_tc`` one
    pass (u), reading x, y and dy and writing u; ``bwd2_tc`` two (dx, dW),
    reading x, u, y and dy and writing dx and dW. ``logical_fwd`` and
    ``logical_bwd`` bound the fused op as a whole, without the kernels'
    recomputes of u: one conv pass forward (x read, y written) and two
    backward (dx and dW, from x, y and dy), at the f32 rate."""
    sh = k4_site_shape(site, batch, tile)
    cin, cout, k = site["cin"], site["cout"], site["k"]
    taps = (k // site["stride"]) ** 2 if site["transposed"] else k * k
    e = torch.empty((), dtype=dtype).element_size()
    tc = PEAK_3XTF32 if dtype == torch.float32 else PEAK_FLOPS[dtype]
    out = batch * sh["ho"] * sh["ho"] * cout
    conv = 2.0 * out * cin * taps
    xb = e * batch * cin * sh["h"] * sh["h"]
    wb = e * cin * cout * k * k
    yb = e * out
    partials = 2 * 4.0 * k4_stats_rows(site, batch, tile) * cout
    return {"conv_flops": conv,
            "stats": _bound(conv + 3 * out, xb + wb),
            "fwd": _bound(conv + 3 * out, xb + wb + yb),
            "bwd1": _bound(conv + 6 * out, xb + wb + yb),
            "bwd2": _bound(3 * conv + 8 * out, 2 * xb + 2 * wb + yb),
            "stats_tc": _bound(conv + 3 * out, xb + wb + 4 * out + partials,
                               tc),
            "fwd_tc": _bound(3 * out, 4 * out + yb),
            "bwd1_tc": _bound(conv + 6 * out, xb + wb + 4 * out + 2 * yb, tc),
            "bwd2_tc": _bound(2 * conv + 8 * out,
                              2 * xb + 2 * wb + 4 * out + 2 * yb, tc),
            "logical_fwd": _bound(conv + 3 * out, xb + wb + yb),
            "logical_bwd": _bound(2 * conv + 8 * out,
                                  2 * xb + 2 * wb + 2 * yb)}


def library_conv_bn_relu(x, w, gamma, beta, site):
    """cuDNN's conv or transposed conv, then the port's train-mode
    BatchNorm and ReLU, as the unfused model runs them, in x's dtype; a
    yardstick only. Returns a callable of (x, w) and the BatchNorm module."""
    from baryon_painter_tpu_torch.models.layers import BatchNorm
    dt = None if x.dtype == torch.float32 else x.dtype
    bn = BatchNorm(site["cout"], dtype=dt).to(x.device).train()
    with torch.no_grad():
        bn.weight.copy_(gamma)
        bn.bias.copy_(beta)
    conv = F.conv_transpose2d if site["transposed"] else F.conv2d
    kw = dict(stride=site["stride"], padding=site["padding"])
    return (lambda xx, ww: torch.relu(bn(conv(xx, ww, **kw)))), bn


def _peak_start(device) -> int:
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    torch.cuda.reset_peak_memory_stats(device)
    return torch.cuda.memory_allocated(device)


def _peak_since(device, base: int) -> int:
    """Peak device memory since ``_peak_start`` beyond what was live then
    (0 on the CPU: a device number)."""
    if device.type != "cuda":
        return 0
    torch.cuda.synchronize(device)
    return torch.cuda.max_memory_allocated(device) - base


def _k4_forward(x, w, gamma, beta, kw, count):
    """K4-stats then K4-fwd (the kernels on the card): y (in f32 written
    over stats' u; in bf16 a new tensor), mean, var, and the peak device
    memory of the pair beyond what was live before it."""
    base = _peak_start(x.device)
    s1, s2, u = conv_bn_stats(x, w, **kw)
    mean, var = batch_stats(s1, s2, count)
    _, a, b = bn_affine(gamma, beta, mean, var)
    y = conv_bn_fwd(u, a, b, x.dtype)
    del u
    return y, mean, var, _peak_since(x.device, base)


def _k4_backward(x, w, gamma, beta, mean, var, y, dy, kw, count):
    """K4-bwd1 then K4-bwd2 (the kernels on the card): dx, dW, dgamma,
    dbeta, and the peak device memory of the pair beyond what was live
    before it (u is its transient)."""
    inv, a, _ = bn_affine(gamma, beta, mean, var)
    base = _peak_start(y.device)
    g1, g2, u = conv_bn_bwd1(x, w, mean, inv, y, dy, **kw)
    dx, dw = conv_bn_bwd2(x, w, a, mean, inv, g1 / count, g2 / count, u, y,
                          dy, **kw)
    del u
    return ({"dx": dx, "dw": dw, "dgamma": g2, "dbeta": g1},
            _peak_since(y.device, base))


def check_conv_bn(device, batch: int = TRAIN_BATCH, tile: int = TRAIN_TILE,
                  iters: int = 3, card=None, dtype=torch.float32) -> dict:
    """Phase 10 (10b in bf16: x, w and dy in ``dtype``, y, dx and dW
    returned in it, K4_TOL_BF16, and stats' u against the plain f32 u of
    the bf16 values within K4_TOL_BF16["u"]; the yardstick in bf16 on
    ``channels_last``): K4 against its plain version at each fused site of the
    fiducial training step (``K4_SITES``): y, mean and var from K4-stats and
    K4-fwd against ``conv_bn_relu_ref``; the u of K4-stats against the u
    K4-bwd1 recomputes (equal: one mainloop); dx, dW, dgamma and dbeta from
    K4-bwd1 and K4-bwd2 against ``conv_bn_relu_bwd_ref`` on the raw
    cotangent, both with K4's statistics and K4's ReLU mask (y > 0 of
    K4-fwd), as the training step runs them; and, as before the mask was
    shared, against the plain backward with its own forward on a cotangent
    zeroed where it meets a pre-activation within KINK_REL of ReLU's kink.
    The tolerances of K4_TOL. The peak device memory of the forward pair
    (y, written over stats' u) and of the backward pair (u's transient),
    each kernel, its plain version and the yardstick
    (``library_conv_bn_relu``, forward and autograd backward) timed with
    CUDA events; the bounds of the kernels' design (``K4_BOUND``) beside,
    the f32 CUDA-core ones in the record."""
    t0 = time.perf_counter()
    device = torch.device(device)
    bf16 = dtype == torch.bfloat16
    tols = K4_TOL_BF16 if bf16 else K4_TOL
    sites = {}
    for name, site in K4_SITES.items():
        x, w, gamma, beta, dy = k4_inputs(site, batch, tile, device)
        x, w, dy = x.to(dtype), w.to(dtype), dy.to(dtype)
        kw = {k: site[k] for k in ("transposed", "stride", "padding")}
        count = dy.shape[0] * dy.shape[2] * dy.shape[3]
        with torch.no_grad():
            y, mean, var, fwd_peak = _k4_forward(x, w, gamma, beta, kw,
                                                 count)
            inv, a, b = bn_affine(gamma, beta, mean, var)
            # stats' u and bwd1's: one GEMM code path, so equal bit for bit
            u_s = conv_bn_stats(x, w, **kw)[2]
            u_diff = (u_s - conv_bn_bwd1(x, w, mean, inv, y, dy, **kw)[2]
                      ).abs().max().item()
            y_r, mean_r, var_r = conv_bn_relu_ref(x, w, gamma, beta, **kw)
            pairs = [("y", y, y_r), ("mean", mean, mean_r),
                     ("var", var, var_r)]
            if bf16:
                pairs.append(("u", u_s, conv_bn_stats_ref(x, w, **kw)[2]))
            errs = {k: _rel_err(g, r) for k, g, r in pairs}
            abs_errs = {k: (g.float() - r.float()).abs().max().item()
                        for k, g, r in pairs}
            y_neq = (y != y_r).float().mean().item()
            del u_s, y_r, pairs
            # the raw cotangent, K4's statistics and mask on both sides
            got, peak = _k4_backward(x, w, gamma, beta, mean, var, y, dy, kw,
                                     count)
            want = dict(zip(("dx", "dw", "dgamma", "dbeta"),
                            conv_bn_relu_bwd_ref(x, w, gamma, beta, mean,
                                                 var, dy, active=y > 0,
                                                 **kw)))
            _sync(device)
            bad_dt = {k: str(v.dtype) for k, v in got.items()
                      if v.dtype != (dtype if k in ("dx", "dw")
                                     else torch.float32)}
            if y.dtype != dtype:
                bad_dt["y"] = str(y.dtype)
            for k in want:
                errs[k] = _rel_err(got[k], want[k])
                abs_errs[k] = (got[k].float() - want[k].float()
                               ).abs().max().item()
            del got, want
            # the kink-zeroed comparison against the plain forward's own
            _, a_r, b_r = bn_affine(gamma, beta, mean_r, var_r)
            v = (F.conv_transpose2d if site["transposed"] else F.conv2d)(
                x.float(), w.float(), stride=site["stride"],
                padding=site["padding"])
            v = v * a_r[:, None, None] + b_r[:, None, None]
            near = v.abs() <= KINK_REL * v.abs().max()
            dy_k = torch.where(near, 0.0, dy)
            zeroed = near.float().mean().item()
            active_r = v > 0
            del v, near
            got, _ = _k4_backward(x, w, gamma, beta, mean, var, y, dy_k, kw,
                                  count)
            want = dict(zip(("dx", "dw", "dgamma", "dbeta"),
                            conv_bn_relu_bwd_ref(x, w, gamma, beta, mean_r,
                                                 var_r, dy_k,
                                                 active=active_r, **kw)))
            _sync(device)
            errs_kink = {k: _rel_err(got[k], want[k]) for k in want}
            del got, want, dy_k, active_r
        bad = {k: e for k, e in errs.items() if not e <= tols[k]}
        bad.update({f"{k}_kink_zeroed": e for k, e in errs_kink.items()
                    if not e <= tols[k]})
        if u_diff != 0.0:
            bad["u_stats_vs_bwd1_max_abs"] = u_diff
        if bad_dt:
            bad["dtypes"] = bad_dt
        u_gb = 4 * y.numel() / 1e9
        print(f"  K4 {dtype} site {name}: raw cotangent, K4's mask: "
              + ", ".join(f"{k} {e:.2e}" for k, e in errs.items())
              + f"; cotangent zeroed near the kink ({zeroed:.3e}), plain "
              f"forward's own mask: "
              + ", ".join(f"{k} {e:.2e}" for k, e in errs_kink.items())
              + f"; u_stats_vs_bwd1_max_abs {u_diff:.3e}; y differs from "
              f"the plain y in {y_neq:.3e} of its elements; forward pair's "
              f"peak memory {fwd_peak / 1e9:.3f} GB (u {u_gb:.3f} GB, y "
              f"{y.element_size() * y.numel() / 1e9:.3f} GB); backward "
              f"pair's peak memory {peak / 1e9:.3f} GB (u {u_gb:.3f} GB)",
              flush=True)
        if bad:
            raise AssertionError(f"K4 ({dtype}) site {name} disagrees with "
                                 f"its plain version: {bad}")
        mask = y > 0
        s1, s2, u = conv_bn_bwd1(x, w, mean, inv, y, dy, **kw)
        s1n, s2n = s1 / count, s2 / count
        u_p = conv_bn_bwd1_ref(x, w, mean, inv, dy, active=mask, **kw)[2]
        # K4-fwd writes over its u: timed on a scratch copy, whose values
        # the repeated calls change (the time does not depend on them)
        u_t = u.clone()
        calls = {
            "stats": (lambda: conv_bn_stats(x, w, **kw),
                      lambda: conv_bn_stats_ref(x, w, **kw)),
            "fwd": (lambda: conv_bn_fwd(u_t, a, b, dtype),
                    lambda: conv_bn_fwd_ref(u_t, a, b, dtype)),
            "bwd1": (lambda: conv_bn_bwd1(x, w, mean, inv, y, dy, **kw),
                     lambda: conv_bn_bwd1_ref(x, w, mean, inv, dy,
                                              active=mask, **kw)),
            "bwd2": (lambda: conv_bn_bwd2(x, w, a, mean, inv, s1n, s2n, u, y,
                                          dy, **kw),
                     lambda: conv_bn_bwd2_ref(x, w, a, mean, inv, s1n, s2n,
                                              dy, active=mask, u=u_p, **kw)),
        }
        rec = {"errors": errs, "abs_errors": abs_errs,
               "errors_kink_zeroed": errs_kink, "kink_zeroed": zeroed,
               "u_stats_vs_bwd1": u_diff, "y_differs": y_neq,
               "fwd_peak_bytes": fwd_peak,
               "bwd_peak_bytes": peak, "u_bytes": 4 * y.numel(),
               "bounds": k4_bounds(site, batch, tile, dtype), "ms": {},
               "plain_ms": {}}
        with torch.no_grad():
            for k, (kern, plain) in calls.items():
                rec["ms"][k] = _time_ms(kern, device, 1, iters)
                rec["plain_ms"][k] = _time_ms(plain, device, 1, iters)
        del u, u_p, u_t, mask, calls
        # the yardstick: f32 NCHW; bf16 on channels_last, as phase 7b
        fmt = torch.channels_last if bf16 else torch.contiguous_format
        xl, wl, dyl = (t.contiguous(memory_format=fmt) for t in (x, w, dy))
        lib, bn = library_conv_bn_relu(xl, wl, gamma, beta, site)
        leaves = [xl.clone().requires_grad_(), wl.clone().requires_grad_(),
                  bn.weight, bn.bias]
        with torch.no_grad():
            rec["library_fwd_ms"] = _time_ms(lambda: lib(xl, wl), device, 1,
                                             iters)
        y_l = lib(leaves[0], leaves[1])
        rec["library_bwd_ms"] = _time_ms(
            lambda: torch.autograd.grad(y_l, leaves, dyl, retain_graph=True),
            device, 1, iters)
        del y_l, leaves, xl, wl, dyl
        sites[name] = rec
        b_ = {k: rec["bounds"][K4_BOUND[k]] for k in K4_KERNELS}
        pair = rec["ms"]["stats"] + rec["ms"]["fwd"]
        pair_bound = b_["stats"]["bound_ms"] + b_["fwd"]["bound_ms"]
        print(f"  K4 {dtype} site {name} ({card}): "
              + ", ".join(f"{k} {rec['ms'][k]:.3f} ms (plain "
                          f"{rec['plain_ms'][k]:.3f}, bound "
                          f"{b_[k]['bound_ms']:.3f} {b_[k]['bound_by']}, "
                          f"share {b_[k]['bound_ms'] / rec['ms'][k]:.3f})"
                          for k in K4_KERNELS)
              + f"; stats + fwd {pair:.3f} ms against the library's fwd "
              f"{rec['library_fwd_ms']:.3f} ms (bound {pair_bound:.3f}), "
              f"bwd1 + bwd2 against the library's bwd "
              f"{rec['library_bwd_ms']:.3f} ms; conv pass "
              f"{rec['bounds']['conv_flops'] / 1e9:.2f} GFLOP", flush=True)
    total = {k: sum(r["ms"][k] for r in sites.values()) for k in K4_KERNELS}
    logical = {k: sum(r["bounds"][f"logical_{k}"]["bound_ms"]
                      for r in sites.values()) for k in ("fwd", "bwd")}
    bound = {k: sum(r["bounds"][K4_BOUND[k]]["bound_ms"]
                    for r in sites.values()) for k in K4_KERNELS}
    fwd_tc = bound["stats"] + bound["fwd"]
    tc = bound["bwd1"] + bound["bwd2"]
    rate = "bf16" if bf16 else "3xtf32"
    _line("10b" if bf16 else 10,
          "k4_vs_plain_bf16" if bf16 else "k4_vs_plain", t0,
          sites=",".join(sites), batch=batch, card=json.dumps(card),
          **{f"{k}_ms_4_sites": f"{v:.3f}" for k, v in total.items()},
          logical_fwd_bound_ms=f"{logical['fwd']:.3f}",
          logical_bwd_bound_ms=f"{logical['bwd']:.3f}",
          fwd_design_bound_ms=f"{fwd_tc:.3f}",
          **{f"bwd_{rate}_bound_ms": f"{tc:.3f}"},
          stats_fwd_share_of_logical=(
              f"{logical['fwd'] / (total['stats'] + total['fwd']):.4f}"),
          stats_fwd_share_of_design_bound=(
              f"{fwd_tc / (total['stats'] + total['fwd']):.4f}"),
          u_stats_vs_bwd1_max_abs=(
              f"{max(r['u_stats_vs_bwd1'] for r in sites.values()):.3e}"),
          fwd_peak_gb_max=(
              f"{max(r['fwd_peak_bytes'] for r in sites.values()) / 1e9:.3f}"),
          bwd1_bwd2_share_of_logical=(
              f"{logical['bwd'] / (total['bwd1'] + total['bwd2']):.4f}"),
          **{f"bwd1_bwd2_share_of_{rate}": (
              f"{tc / (total['bwd1'] + total['bwd2']):.4f}")},
          bwd_peak_gb_max=(
              f"{max(r['bwd_peak_bytes'] for r in sites.values()) / 1e9:.3f}"),
          library_fwd_ms_4_sites=f"{sum(r['library_fwd_ms'] for r in sites.values()):.3f}",
          library_bwd_ms_4_sites=f"{sum(r['library_bwd_ms'] for r in sites.values()):.3f}")
    return {"sites": sites, "dtype": str(dtype).replace("torch.", "")}


def paint_tf32(device, repo: Path = REPO) -> dict:
    """Phase 12: with PyTorch's default TF32 settings (cuDNN TF32 on,
    matmul TF32 off), the golden repainted through the painter's inner
    ``_paint_batch``, which runs under that setting, for the record, and
    through ``paint_batch``, which pins f32 and must pass; the caller's
    settings are restored after."""
    t0 = time.perf_counter()
    with _tf32(cudnn=True, matmul=False):
        default = paint_golden(device, repo, phase=12, caller_tf32=True,
                               check=False)["worst_err_over_tol"]
        pinned = paint_golden(device, repo, phase=12)["worst_err_over_tol"]
    _line(12, "paint_tf32", t0,
          worst_err_over_tol_library_default=f"{default:.4f}",
          worst_err_over_tol_pinned_f32=f"{pinned:.4f}",
          default_within_golden=default <= 1.0)
    return {"library_default": default, "pinned": pinned}


# ---------------------------------------------------------------------- #
# phase 16: the SLICS lightcone, through the lightcone CLI's own code

CLI = REPO / "scripts" / "create_lightcone_torch.py"
# a synthetic line of sight of three shells: the massplane shell (its delta
# plane is 21.8 Mpc/h, under the 100 Mpc/h tile), the heaviest zoom (7050^2
# native tiles, 4 tiles) and the most tiles (64, a 3273^2 plane)
LC_Z = (0.042, 0.221, 2.007)
LC_LOS = 74
LC_OVERLAP = 0.2
LC_RESOLUTION = 7745 // 5
LC_PAINT_BATCH = 16
N_PIXEL_TILE = 512
# 16a: the resampler against scipy, the tolerance of tests/test_resample.py
RESAMPLE_RTOL, RESAMPLE_ATOL = 2e-3, 2e-4
# 16c: e(bf16 kernels, bf16 cuDNN) <= LC_BF16_RATIO * e(bf16 cuDNN, f32
# cuDNN), e the largest bin of cl_fractional_error over the y map
LC_BF16_RATIO = 0.5


def lightcone_geometry(z=LC_Z, n_pixel_delta: int = slics_io.N_PIXEL_DELTA,
                       resolution: int = LC_RESOLUTION) -> list:
    """The lightcone CLI's shells: kind, painted plane and native tile
    edges, tiles and paint calls (at LC_PAINT_BATCH tiles a call)."""
    shells = []
    for zz, size in zip(z, shell_sizes(z)):
        if size < TILE_SIZE:
            shells.append({"z": zz, "kind": "massplane", "tiles": 1,
                           "calls": 1})
            continue
        n_plane = int(size / TILE_SIZE * N_PIXEL_TILE)
        m = len(generate_tiling(n_plane, N_PIXEL_TILE, LC_OVERLAP)[0])
        shells.append({"z": zz, "kind": "delta", "n_plane": n_plane,
                       "n_nat": int(n_pixel_delta * (TILE_SIZE / size)),
                       "tiles": m * m, "calls": -(-m * m // LC_PAINT_BATCH)})
    return shells


def lightcone_resample_cases(shells, resolution: int = LC_RESOLUTION):
    """16a's cases, (edge in, edge out, order, mode): the native tile zooms
    of the delta shell with the most tiles and of the one with the largest
    tiles (order 3, reflect), and that first shell's painted plane to the
    y map (order 5, mirror)."""
    delta = [s for s in shells if s["kind"] == "delta"]
    most = max(delta, key=lambda s: s["tiles"])
    largest = max(delta, key=lambda s: s["n_nat"])
    return [(most["n_nat"], N_PIXEL_TILE, 3, "reflect"),
            (largest["n_nat"], N_PIXEL_TILE, 3, "reflect"),
            (most["n_plane"], resolution, 5, "mirror")]


@contextlib.contextmanager
def _fused_heads_env(on: bool):
    """BPT_FUSED_HEADS, which the lightcone CLI reads, for one call."""
    prev = os.environ.pop("BPT_FUSED_HEADS", None)
    if on:
        os.environ["BPT_FUSED_HEADS"] = "1"
    try:
        yield
    finally:
        os.environ.pop("BPT_FUSED_HEADS", None)
        if prev is not None:
            os.environ["BPT_FUSED_HEADS"] = prev


def _load_cli(path: Path = CLI):
    """A CLI script of the port (the lightcone CLI by default), as a
    module."""
    spec = importlib.util.spec_from_file_location(path.stem, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def run_lightcone_cli(device, los: dict, dtype: str, fused: bool,
                      kappa: bool = False, stage_times=None,
                      n_pixel_delta: int = slics_io.N_PIXEL_DELTA,
                      n_pixel_massplane: int = slics_io.N_PIXEL_MASSPLANE,
                      resolution: int = LC_RESOLUTION,
                      model_type: str = "CVAE",
                      seamless: bool = False, mesh=None) -> dict:
    """One lightcone through ``scripts/create_lightcone_torch.py``'s
    ``run``: ``fused`` adds ``--fused-paint`` (and for the CVAE
    ``BPT_FUSED_HEADS=1``); ``model_type="CGAN"`` paints with the CGAN
    (``CGAN_PATH``), ``seamless`` adds ``--seamless``; ``mesh`` (a
    ``DeviceMesh``) shards the paint over its devices."""
    base = str(Path(los["delta"]).parent)
    path = (REPO / CHECKPOINT if model_type == "CVAE"
            else REPO / CGAN_PATH).parent
    name = f"y_{model_type}_{dtype}_{fused}_{seamless}"
    argv = ["--model-type", model_type, f"--{model_type}-path", str(path),
            "--SLICS-base-path", base, "--SLICS-LOS", str(LC_LOS),
            "--output-file", os.path.join(base, name),
            "--tile-overlap", str(LC_OVERLAP),
            "--paint-batch-size", str(LC_PAINT_BATCH),
            "--output-resolution", str(resolution),
            "--paint-dtype", dtype, "--device", str(device),
            "--n-pixel-delta", str(n_pixel_delta),
            "--n-pixel-massplane", str(n_pixel_massplane)]
    if fused:
        argv.append("--fused-paint")
    if seamless:
        argv.append("--seamless")
    if kappa:
        argv += ["--kappa-path", los["kappa"]]
    with _fused_heads_env(fused and model_type == "CVAE"):
        out = _load_cli().run(argv, stage_times=stage_times, mesh=mesh)
    _sync(torch.device(device))
    return out


def _max_cl_error(pred, truth, device) -> float:
    """e(pred, truth): the largest bin of cl_fractional_error over the y
    maps (10 degrees a side), skipping the bins without modes."""
    frac, _ = cl_fractional_error(pred, truth, theta_deg=10.0, device=device)
    return float(np.nanmax(frac))


def _planes_vector(run: dict) -> torch.Tensor:
    return torch.cat([torch.as_tensor(p).double().flatten().cpu()
                      for p in run["planes"]])


def check_resampler_lightcone(device, cases, seed: int = 0) -> list:
    """Phase 16a: ``resize_spline`` at the lightcone's sizes against
    ``scipy.ndimage.zoom`` in f64, with cuDNN's and matmul's TF32 on (so a
    prefilter or an evaluation that does not pin f32 fails), within rtol
    RESAMPLE_RTOL, atol RESAMPLE_ATOL * max|scipy|."""
    from scipy.ndimage import zoom as scipy_zoom
    t0 = time.perf_counter()
    device = torch.device(device)
    rng = np.random.default_rng(seed)
    out = []
    with _tf32(True, True):
        for n_in, n_out, order, mode in cases:
            x = rng.gamma(2.0, 0.5, (n_in, n_in)).astype(np.float32)
            got = resize_spline(torch.as_tensor(x, device=device),
                                (n_out, n_out), order=order,
                                mode=mode).cpu().numpy()
            want = scipy_zoom(x.astype(np.float64), n_out / n_in,
                              order=order, mode=mode)
            tol = RESAMPLE_ATOL * np.abs(want).max() + RESAMPLE_RTOL * np.abs(
                want)
            ratio = (float((np.abs(got - want) / tol).max())
                     if got.shape == want.shape else float("inf"))
            rec = {"case": f"{n_in}->{n_out} order {order} {mode}",
                   "err_over_tol": ratio}
            out.append(rec)
            print(f"  resample {rec['case']}: worst |port - scipy| / tol = "
                  f"{ratio:.4f}", flush=True)
            if not ratio <= 1.0:
                raise AssertionError(f"resize_spline against scipy at "
                                     f"{rec['case']}: {ratio:.4f} of its "
                                     f"tolerance, shape {got.shape} vs "
                                     f"{want.shape}")
    _line("16a", "resample_vs_scipy", t0, cases=len(out),
          cudnn_allow_tf32=True, matmul_allow_tf32=True,
          worst_err_over_tol=f"{max(r['err_over_tol'] for r in out):.4f}")
    return out


@contextlib.contextmanager
def _cudnn(enabled: bool):
    prev = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = prev


def lightcone_f32(device, los: dict, shells: list, **size) -> dict:
    """Phase 16b: the lightcone CLI in f32 three times: with the kernels (K1's
    fused blocks, K3's fused heads), with cuDNN's blocks and heads, and
    plain (the same unfused painter with cuDNN off: PyTorch's own
    convolutions, im2col and a GEMM, TF32 off). Every painted plane and the
    y map of the kernels' run lie within the golden's tolerance (rtol
    GOLDEN_RTOL, atol GOLDEN_RTOL * mean|plain|) of the plain run's; the
    cuDNN run's distance from it, and the kernels' from cuDNN's, are
    printed for the record: cuDNN's own f32 convolutions at 16 tiles a call
    lie up to 1.3 of that tolerance from the plain run on an H100
    (``PERF.md`` §6). All three painters draw the same prior noise from the
    same seed.
    On the card the kernels' run launches 4 K1 and 1 K3-fwd a paint call,
    the others none."""
    t0 = time.perf_counter()
    on_card = torch.device(device).type == "cuda"
    calls = sum(s["calls"] for s in shells)
    runs, counts = {}, {}
    for label, fused, cudnn in (("kernels", True, True),
                                ("cudnn", False, True),
                                ("plain", False, False)):
        _reset_launches()
        with _cudnn(cudnn):
            runs[label] = run_lightcone_cli(device, los, "f32", fused,
                                            **size)
        counts[label] = _launches()
        _expect_launches(f"lightcone f32 ({label})", counts[label],
                         {"k1": 4 * calls, "k3_fwd": calls}
                         if on_card and fused else {})

    def ratios(a, b):
        return ([_golden_ratio(p, q) for p, q in zip(runs[a]["planes"],
                                                     runs[b]["planes"])],
                _golden_ratio(runs[a]["y_map"], runs[b]["y_map"]))

    kernels, kernels_y = ratios("kernels", "plain")
    cudnn, cudnn_y = ratios("cudnn", "plain")
    k_vs_c, k_vs_c_y = ratios("kernels", "cudnn")
    finite = all(bool(torch.as_tensor(p).isfinite().all())
                 for p in runs["kernels"]["planes"])
    if not (finite and max(kernels) <= 1.0 and kernels_y <= 1.0):
        raise AssertionError(f"lightcone f32, kernels against the plain "
                             f"run: planes {kernels}, y map {kernels_y} of "
                             f"the tolerance, finite={finite}")
    fmt = lambda r: json.dumps([round(v, 4) for v in r])
    _line("16b", "lightcone_f32_kernels_vs_plain", t0,
          launches=json.dumps(counts["kernels"]),
          planes_err_over_tol=fmt(kernels),
          y_map_err_over_tol=f"{kernels_y:.4f}",
          cudnn_planes_err_over_tol=fmt(cudnn),
          cudnn_y_map_err_over_tol=f"{cudnn_y:.4f}",
          kernels_vs_cudnn_planes=fmt(k_vs_c),
          kernels_vs_cudnn_y_map=f"{k_vs_c_y:.4f}")
    return {"runs": runs, "planes_err_over_tol": kernels,
            "y_map_err_over_tol": kernels_y,
            "cudnn_planes_err_over_tol": cudnn,
            "cudnn_y_map_err_over_tol": cudnn_y,
            "launches": counts["kernels"]}


def lightcone_bf16(device, los: dict, shells: list, f32_cudnn: dict,
                   **size) -> dict:
    """Phase 16c, the main path: the lightcone CLI's default, bf16, with
    ``--fused-paint``, ``BPT_FUSED_HEADS=1`` and ``--kappa-path``: on the card
    exactly 4 bf16 K1 and 1 bf16 K3-fwd launches a paint call and no other
    kernel; e(bf16 kernels, bf16 cuDNN) <= LC_BF16_RATIO * e(bf16 cuDNN,
    f32 cuDNN) on the y map's angular power (``cl_fractional_error``);
    the y x kappa cross-Cl finite in every bin with modes. The pixel-level
    d(kernels, cuDNN) / d(bf16, f32) is printed for the record."""
    t0 = time.perf_counter()
    device = torch.device(device)
    on_card = device.type == "cuda"
    calls = sum(s["calls"] for s in shells)
    want = {"k1": 4 * calls, "k3_fwd": calls} if on_card else {}
    _reset_launches()
    kern = run_lightcone_cli(device, los, "bf16", True, kappa=True, **size)
    counts, bf16_counts = _launches(), _bf16_launches()
    _expect_launches("lightcone (bf16)", counts, want)
    _expect_launches("lightcone (bf16 launches)", bf16_counts, want)
    cudnn = run_lightcone_cli(device, los, "bf16", False, **size)
    e_kc = _max_cl_error(kern["y_map"], cudnn["y_map"], device)
    e_gap = _max_cl_error(cudnn["y_map"], f32_cudnn["y_map"], device)
    d_planes = (rel_l2(_planes_vector(kern), _planes_vector(cudnn))
                / rel_l2(_planes_vector(cudnn), _planes_vector(f32_cudnn)))
    d_y = (rel_l2(kern["y_map"], cudnn["y_map"])
           / rel_l2(cudnn["y_map"], f32_cudnn["y_map"]))
    cl, _, _, n_mode = kern["cl_y_kappa"]
    cross_finite = bool(np.all(np.isfinite(cl[n_mode > 0])))
    ratio = e_kc / e_gap if e_gap > 0 else 0.0
    res = {"e_kernels_cudnn": e_kc, "e_bf16_f32": e_gap, "ratio": ratio,
           "d_planes_ratio": d_planes, "d_y_ratio": d_y,
           "cudnn": {"y_map": cudnn["y_map"], "planes": cudnn["planes"]},
           "cross_cl_finite": cross_finite, "launches": counts,
           "bf16_launches": bf16_counts,
           "tiles": sum(s["tiles"] for s in shells),
           "paint_calls": calls}
    ok = (e_kc <= LC_BF16_RATIO * e_gap and cross_finite
          and np.all(np.isfinite(kern["y_map"])))
    if not ok:
        raise AssertionError(f"lightcone bf16: {res}")
    _line("16c", "lightcone_bf16", t0, launches=json.dumps(counts),
          bf16_launches=json.dumps(bf16_counts), tiles=res["tiles"],
          e_kernels_cudnn=f"{e_kc:.4e}", e_bf16_f32=f"{e_gap:.4e}",
          ratio=f"{ratio:.4f}", limit_ratio=LC_BF16_RATIO,
          pixel_d_planes_ratio=f"{d_planes:.4f}",
          pixel_d_y_ratio=f"{d_y:.4f}",
          cross_cl_finite_bins=int(np.sum(n_mode > 0)))
    return res


class _CountedStages(StageTimes):
    """StageTimes that also keeps the launch counts at each mark (``counts``:
    the bf16 ones by default)."""

    def __init__(self, device, counts=None):
        self.launches = []
        self._counts = counts or _bf16_launches
        super().__init__(device)

    def mark(self, stage: str):
        super().mark(stage)
        self.launches.append(self._counts())


def _shell_stages(stages: _CountedStages, kernels=("k1", "k3_fwd")):
    """A timed lightcone's marks per shell (each from its ``upload`` to the
    next: upload, zoom, paint and, tiled, blend, in ms) with the launches
    of ``kernels`` in it, and the marks outside the shells."""
    shells, other = [], {}
    marks = list(zip(stages.intervals(), stages.launches[1:],
                     stages.launches))
    for (stage, ms), now, prev in marks:
        if stage == "upload":
            shells.append({"start": prev})
        if stage in ("upload", "zoom", "paint", "blend"):
            shells[-1][stage] = ms
            shells[-1]["end"] = now
        else:
            other[stage] = ms
    for s in shells:
        start, end = s.pop("start"), s.pop("end")
        for k in kernels:
            s[k] = end[k] - start[k]
    return shells, other


def time_lightcone(device, los: dict, card=None, paint_tiles_per_s=None,
                   **size) -> dict:
    """Phase 16, timed: the CLI's default bf16 lightcone again (16c was its
    warm-up), its stages marked by CUDA events (``StageTimes``): per shell
    read + upload, extract + zoom, paint, blend; then the y map and the
    cross-Cl; the whole call by the host clock. Lightcone tiles/s is the
    painted tiles over the shells' zoom + paint + blend time, beside
    ``paint_batch``'s bf16 tiles/s (phase 14)."""
    t0 = time.perf_counter()
    device = torch.device(device)
    _reset_launches()
    stages = _CountedStages(device)
    t = time.perf_counter()
    out = run_lightcone_cli(device, los, "bf16", True, kappa=True,
                            stage_times=stages, **size)
    wall_s = time.perf_counter() - t
    shells, other = _shell_stages(stages)
    device_ms = sum(s[k] for s in shells for k in ("zoom", "paint", "blend"))
    tiles = sum(s["tiles"] for s in lightcone_geometry(out["z_SLICS"]))
    tiles_per_s = tiles / device_ms * 1e3
    clock = "cuda_events" if device.type == "cuda" else "host_clock_cpu"
    for z, s in zip(out["z_SLICS"], shells):
        print(f"  shell z={z:.3f}: upload {s['upload']:.3f} ms, zoom "
              f"{s['zoom']:.3f}, paint {s['paint']:.3f}, blend "
              f"{s['blend']:.3f}; K1 {s['k1']}, K3-fwd {s['k3_fwd']} "
              f"(bf16)", flush=True)
    _line(16, "lightcone_timing", t0, clock=clock, card=json.dumps(card),
          los_s=f"{wall_s:.3f}", shells=len(shells), tiles=tiles,
          shells_device_ms=f"{device_ms:.3f}",
          upload_ms=f"{sum(s['upload'] for s in shells):.3f}",
          setup_ms=f"{other.get('setup', 0.0):.3f}",
          y_map_ms=f"{other.get('ymap', 0.0):.3f}",
          cl_ms=f"{other.get('cl', 0.0):.3f}",
          lightcone_tiles_per_s=f"{tiles_per_s:.2f}",
          paint_batch_tiles_per_s=(f"{paint_tiles_per_s:.2f}"
                                   if paint_tiles_per_s is not None
                                   else None))
    return {"los_s": wall_s, "shells": shells, "stages": other,
            "shells_device_ms": device_ms, "tiles": tiles,
            "tiles_per_s": tiles_per_s}


@contextlib.contextmanager
def synthetic_lightcone(device, z=LC_Z,
                        n_pixel_delta: int = slics_io.N_PIXEL_DELTA,
                        n_pixel_massplane: int = slics_io.N_PIXEL_MASSPLANE,
                        resolution: int = LC_RESOLUTION):
    """A synthetic SLICS line of sight (``z``'s shells at ``n_pixel_delta``
    / ``n_pixel_massplane``, the real SLICS sizes by default) written to a
    temporary directory for the block, removed after; yields ``{"los",
    "shells", "size"}`` (``size``: the CLI runs' size arguments)."""
    device = torch.device(device)
    size = dict(n_pixel_delta=n_pixel_delta,
                n_pixel_massplane=n_pixel_massplane, resolution=resolution)
    shells = lightcone_geometry(z, n_pixel_delta, resolution)
    with tempfile.TemporaryDirectory(prefix="bpt_lightcone_") as base:
        t0 = time.perf_counter()
        los = write_synthetic_los(base, z, LC_LOS, n_pixel_delta,
                                  n_pixel_massplane, device=device)
        _line(16, "lightcone_data", t0, shells=json.dumps(los["kinds"]),
              n_pixel_delta=n_pixel_delta,
              n_pixel_massplane=n_pixel_massplane,
              tiles=json.dumps([s["tiles"] for s in shells]))
        yield {"los": los, "shells": shells, "size": size}


def lightcone(device, data: dict, card=None,
              paint_tiles_per_s=None) -> dict:
    """Phase 16, a main path: on ``data`` (``synthetic_lightcone``'s) 16a,
    16b, 16c and the timed run, under PyTorch's default TF32 switches
    (cuDNN's on), as a user's process runs the CLI."""
    device = torch.device(device)
    los, shells, size = data["los"], data["shells"], data["size"]
    with _tf32(True, False):
        resample = check_resampler_lightcone(
            device, lightcone_resample_cases(shells, size["resolution"]))
        f32 = lightcone_f32(device, los, shells, **size)
        bf16 = lightcone_bf16(device, los, shells, f32["runs"]["cudnn"],
                              **size)
        timing = time_lightcone(device, los, card=card,
                                paint_tiles_per_s=paint_tiles_per_s, **size)
    return {"resample": resample, "f32": {k: v for k, v in f32.items()
                                          if k != "runs"},
            "bf16": bf16, "timing": timing, "shells": shells}


# ---------------------------------------------------------------------- #
# phase 17: the CGAN painter through K1 at slope 0.2

CGAN_PATH = "trained_models/CGAN/fiducial/model"
# the two CGAN goldens of tests/goldens/paint_goldens.npz, by checkpoint
CGAN_GOLDENS = {"cgan_fiducial": CGAN_PATH,
                "cgan_adv": "trained_models/CGAN/fiducial-adv/model"}
CGAN_TILE, CGAN_N_TILES = 256, 2
BF16_CGAN_REFERENCE = "tests/goldens/bf16_cgan_paint_reference.npz"
CGAN_SLOPE = 0.2
# K1's shapes on the CGAN's paths: the goldens' 2 tiles of 256^2 reach
# the blocks at 64^2, the lightcone CLI's 16 tiles of 512^2 at 128^2
K1_CGAN_SHAPES = ((2, 64, 64, 128), (16, 128, 128, 128))


def k1_cgan_cases() -> list:
    """17a's cases, (shape, dtype, slope, relative tolerance): both CGAN
    shapes in f32 and bf16 at slope 0.2, with K1_CASES' tolerances."""
    tol = {dtype: t for dtype, _, t in K1_CASES}
    return [(shape, dtype, CGAN_SLOPE, tol[dtype])
            for shape in K1_CGAN_SHAPES
            for dtype in (torch.float32, torch.bfloat16)]


def check_k1_cgan(device, cases=None) -> list:
    """Phase 17a: K1 against its plain version at the CGAN's shapes and
    slope."""
    t0 = time.perf_counter()
    device = torch.device(device)
    out = [_check_k1(*case, device) for case in cases or k1_cgan_cases()]
    _line("17a", "k1_cgan_vs_plain", t0, cases=len(out),
          worst_err_over_tol=f"{max(r['max_abs_err'] / r['tol'] for r in out):.4f}")
    return out


def _cgan_painter(device, path=CGAN_PATH, repo: Path = REPO, **kw):
    from baryon_painter_tpu_torch.painter import CGANPainter
    return CGANPainter(str(repo / path), device=device, **kw)


def _cgan_golden_batch():
    return (golden_inputs(CGAN_TILE, CGAN_N_TILES),
            np.linspace(0.0, 1.0, CGAN_N_TILES).astype(np.float32))


def paint_cgan_goldens(device, repo: Path = REPO) -> dict:
    """Phase 17b, a main path: both CGAN goldens repainted in f32 with
    ``CGANPainter(fused_inference=True)``: on the card exactly one f32 K1
    launch per residual block (9) a ``paint_batch`` and no other kernel;
    within the golden test's tolerance. The same with cuDNN's blocks
    (unfused: no launch), its distance printed."""
    t0 = time.perf_counter()
    device = torch.device(device)
    on_card = device.type == "cuda"
    tiles, zs = _cgan_golden_batch()
    with np.load(repo / GOLDENS) as g:
        wants = {name: g[name].astype(np.float32) for name in CGAN_GOLDENS}
    out = []
    for name, path in CGAN_GOLDENS.items():
        rec = {"name": name}
        for fused in (True, False):
            painter = _cgan_painter(device, path, repo,
                                    fused_inference=fused)
            blocks = painter.architecture["n_res_blocks"]
            _reset_launches()
            got = painter.paint_batch(tiles, zs)
            _sync(device)
            counts, bf16 = _launches(), _bf16_launches()
            label = f"CGAN paint {name} ({'K1' if fused else 'cuDNN'})"
            _expect_launches(label, counts,
                             {"k1": blocks} if on_card and fused else {})
            _expect_launches(label + " bf16", bf16, {})
            got = got.cpu().numpy()
            if got.shape != wants[name].shape or not np.isfinite(got).all():
                raise AssertionError(f"{label}: {got.shape}, finite="
                                     f"{np.isfinite(got).all()}")
            key = "worst_err_over_tol" if fused else "cudnn_err_over_tol"
            rec[key] = _golden_ratio(got, wants[name])
            if fused:
                rec["launches"] = counts["k1"]
        print(f"  {name}: K1 {rec['launches']} launches, worst |diff| / "
              f"tol {rec['worst_err_over_tol']:.4f}; cuDNN's blocks "
              f"{rec['cudnn_err_over_tol']:.4f}", flush=True)
        if not rec["worst_err_over_tol"] <= 1.0:
            raise AssertionError(f"the CGAN painted through K1 differs from "
                                 f"the golden: {rec}")
        out.append(rec)
    _line("17b", "paint_cgan_goldens", t0,
          k1_launches_per_paint=json.dumps([r["launches"] for r in out]),
          worst_err_over_tol=json.dumps(
              [round(r["worst_err_over_tol"], 4) for r in out]),
          cudnn_err_over_tol=json.dumps(
              [round(r["cudnn_err_over_tol"], 4) for r in out]))
    return {"goldens": out, "launches": out[0]["launches"]}


def paint_cgan_bf16(device, repo: Path = REPO) -> dict:
    """Phase 17c, a main path: the cgan_fiducial golden inputs painted in
    bf16 through ``CGANPainter(dtype=torch.bfloat16,
    fused_inference=True)`` in the transformed space: on the card exactly 9
    K1 launches, all bf16; held to the committed JAX bf16 paint
    (``BF16_CGAN_REFERENCE``) with phase 14's rule, d(port, JAX bf16) <=
    max(BF16_PAINT_HALF * d(JAX f32, JAX bf16), d(JAX jitted, JAX op by
    op)), and at least BF16_REAL_RATIO * d(JAX f32, JAX bf16) from the
    port's own f32 paint."""
    t0 = time.perf_counter()
    device = torch.device(device)
    on_card = device.type == "cuda"
    painter = _cgan_painter(device, repo=repo, fused_inference=True,
                            dtype=torch.bfloat16)
    painter_f32 = _cgan_painter(device, repo=repo, fused_inference=True)
    blocks = painter.architecture["n_res_blocks"]
    with np.load(repo / BF16_CGAN_REFERENCE) as r:
        jax_bf16, jax_f32 = r["jax_bf16"], r["jax_f32"]
        gap, d_jit = float(r["d_bf16_f32"]), float(r["d_bf16_jit"])
    limit = max(BF16_PAINT_HALF * gap, d_jit)
    tiles, zs = _cgan_golden_batch()
    _reset_launches()
    out = painter.paint_batch(tiles, zs, inverse_transform=False)
    _sync(device)
    counts, bf16_counts = _launches(), _bf16_launches()
    want = {"k1": blocks} if on_card else {}
    _expect_launches("CGAN paint (bf16)", counts, want)
    _expect_launches("CGAN paint (bf16 launches)", bf16_counts, want)
    got = out.float().cpu().numpy()
    out_f32 = painter_f32.paint_batch(tiles, zs, inverse_transform=False)
    d_ref, d_real = rel_l2(got, jax_bf16), rel_l2(got, out_f32)
    d_f32 = rel_l2(out_f32, jax_f32)
    res = {"dtype": str(out.dtype), "d_jax_bf16": d_ref, "d_port_f32": d_real,
           "d_f32_vs_jax_f32": d_f32, "gap": gap, "d_jax_jit": d_jit,
           "limit": limit, "launches": counts, "bf16_launches": bf16_counts}
    ok = (out.dtype == torch.bfloat16 and got.shape == jax_bf16.shape
          and bool(np.isfinite(got).all()) and d_ref <= limit
          and d_real >= BF16_REAL_RATIO * gap)
    if not ok:
        raise AssertionError(f"CGAN bf16 paint against the JAX bf16 "
                             f"reference: {res}")
    _line("17c", "paint_cgan_bf16", t0, launches=json.dumps(counts),
          bf16_launches=json.dumps(bf16_counts), d_jax_bf16=f"{d_ref:.4e}",
          jax_bf16_f32_gap=f"{gap:.4e}", ratio=f"{d_ref / gap:.4f}",
          limit_ratio=f"{limit / gap:.4f}",
          jax_jit_ratio=f"{d_jit / gap:.4f}",
          real_ratio=f"{d_real / gap:.4f}", f32_vs_jax_f32=f"{d_f32:.2e}")
    return res


def time_cgan(device, card=None, n_tiles: int = 16, warmup: int = 2,
              iters: int = 10, k1_shape=K1_CGAN_SHAPES[1],
              k1_iters: int = 20) -> dict:
    """Phase 17d: ``paint_batch`` at ``n_tiles`` 512^2 tiles (the lightcone
    CLI's calls) in f32 and bf16, with K1 and with cuDNN's blocks, CUDA
    events over ``iters`` calls after ``warmup``, each with its peak device
    memory; K1 per launch at ``k1_shape``, slope 0.2, beside its plain
    version, cuDNN's unfused LeakyReLU block on ``channels_last`` and the
    bound (``k1_bound``)."""
    t0 = time.perf_counter()
    device = torch.device(device)
    out = {"n_tiles": n_tiles, "paint_ms": {}, "tiles_per_s": {},
           "peak_gb": {}}
    for dtype in (torch.float32, torch.bfloat16):
        d = str(dtype).replace("torch.", "")
        for fused in (True, False):
            key = f"{d}_{'k1' if fused else 'cudnn'}"
            painter = _cgan_painter(
                device, fused_inference=fused,
                dtype=None if dtype == torch.float32 else dtype)
            base = _peak_start(device)
            ms = paint_time_ms(device, painter, n_tiles, warmup, iters)
            out["peak_gb"][key] = _peak_since(device, base) / 1e9
            out["paint_ms"][key] = ms
            out["tiles_per_s"][key] = n_tiles / ms * 1e3
            del painter
    slope = dict(inner_slope=CGAN_SLOPE, outer_slope=CGAN_SLOPE)
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            d = str(dtype).replace("torch.", "")
            args = k1_inputs(k1_shape, dtype, device)
            lib_args = library_block_args(args, dtype)
            out[f"k1_ms_{d}"] = _time_ms(
                lambda: res_block_infer(*args, **slope), device, 3, k1_iters)
            out[f"library_ms_{d}"] = _time_ms(
                lambda: library_block(*lib_args, slope=CGAN_SLOPE), device,
                3, k1_iters)
            out[f"plain_ms_{d}"] = _time_ms(
                lambda: res_block_infer_ref(*args, **slope), device, 3,
                k1_iters)
            out[f"bound_{d}"] = k1_bound(k1_shape, dtype)
    clock = "cuda_events" if device.type == "cuda" else "host_clock_cpu"
    f = lambda v: f"{v:.3f}"
    _line("17d", "cgan_timing", t0, clock=clock, card=json.dumps(card),
          n_tiles=n_tiles,
          paint_ms=json.dumps({k: round(v, 3)
                               for k, v in out["paint_ms"].items()}),
          tiles_per_s=json.dumps({k: round(v, 2)
                                  for k, v in out["tiles_per_s"].items()}),
          peak_gb=json.dumps({k: round(v, 3)
                              for k, v in out["peak_gb"].items()}),
          k1_shape=json.dumps(list(k1_shape)),
          k1_ms_f32=f"{out['k1_ms_float32']:.4f}",
          k1_ms_bf16=f"{out['k1_ms_bfloat16']:.4f}",
          cudnn_block_ms_f32=f"{out['library_ms_float32']:.4f}",
          cudnn_block_ms_bf16=f"{out['library_ms_bfloat16']:.4f}",
          plain_ms_f32=f"{out['plain_ms_float32']:.4f}",
          plain_ms_bf16=f"{out['plain_ms_bfloat16']:.4f}",
          bound_ms_f32_3xtf32=f"{out['bound_float32']['tc']['bound_ms']:.4f}",
          bound_ms_bf16=f"{out['bound_bfloat16']['tc']['bound_ms']:.4f}",
          paint_ms_f32_k1=f(out["paint_ms"]["float32_k1"]))
    return out


def lightcone_cgan(device, data: dict, card=None) -> dict:
    """Phase 17e, a main path: the lightcone CLI with ``--model-type CGAN
    --fused-paint`` (f32, its default) on phase 16's line of sight: on the
    card exactly 9 K1 launches a paint call and no other kernel; every
    painted plane and the y map within the golden's tolerance of the same
    run with cuDNN off (plain convolutions, the unfused painter); cuDNN's
    unfused run's distance printed. Then the K1 run again, timed by stage
    (CUDA events) and whole (host clock)."""
    t0 = time.perf_counter()
    device = torch.device(device)
    los, shells, size = data["los"], data["shells"], data["size"]
    on_card = device.type == "cuda"
    calls = sum(s["calls"] for s in shells)
    blocks = _load_meta(REPO / CGAN_PATH)["model_architecture"].get(
        "n_res_blocks", 9)
    runs, counts = {}, {}
    with _tf32(True, False):
        for label, fused, cudnn in (("kernels", True, True),
                                    ("plain", False, False),
                                    ("cudnn", False, True)):
            _reset_launches()
            with _cudnn(cudnn):
                runs[label] = run_lightcone_cli(device, los, "f32", fused,
                                                model_type="CGAN", **size)
            counts[label] = _launches()
            _expect_launches(f"CGAN lightcone ({label})", counts[label],
                             {"k1": blocks * calls}
                             if on_card and fused else {})
        stages = _CountedStages(device, counts=_launches)
        t = time.perf_counter()
        run_lightcone_cli(device, los, "f32", True, model_type="CGAN",
                          stage_times=stages, **size)
        wall_s = time.perf_counter() - t

    def ratios(a, b):
        return ([_golden_ratio(p, q) for p, q in zip(runs[a]["planes"],
                                                     runs[b]["planes"])],
                _golden_ratio(runs[a]["y_map"], runs[b]["y_map"]))

    kernels, kernels_y = ratios("kernels", "plain")
    cudnn, cudnn_y = ratios("cudnn", "plain")
    finite = all(bool(torch.as_tensor(p).isfinite().all())
                 for p in runs["kernels"]["planes"])
    if not (finite and max(kernels) <= 1.0 and kernels_y <= 1.0):
        raise AssertionError(f"CGAN lightcone, kernels against the plain "
                             f"run: planes {kernels}, y map {kernels_y}, "
                             f"finite={finite}")
    shell_ms, other = _shell_stages(stages, kernels=("k1",))
    for z, s in zip(runs["kernels"]["z_SLICS"], shell_ms):
        print(f"  CGAN shell z={z:.3f}: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in s.items() if k != "k1")
            + f"; K1 {s['k1']}", flush=True)
    tiles = sum(s["tiles"] for s in shells)
    device_ms = sum(s.get(k, 0.0) for s in shell_ms
                    for k in ("zoom", "paint", "blend"))
    fmt = lambda r: json.dumps([round(v, 4) for v in r])
    _line("17e", "lightcone_cgan", t0, card=json.dumps(card),
          launches=json.dumps(counts["kernels"]), paint_calls=calls,
          planes_err_over_tol=fmt(kernels),
          y_map_err_over_tol=f"{kernels_y:.4f}",
          cudnn_planes_err_over_tol=fmt(cudnn),
          cudnn_y_map_err_over_tol=f"{cudnn_y:.4f}", los_s=f"{wall_s:.3f}",
          shells_device_ms=f"{device_ms:.3f}",
          paint_ms=f"{sum(s['paint'] for s in shell_ms):.3f}",
          upload_ms=f"{sum(s['upload'] for s in shell_ms):.3f}",
          y_map_ms=f"{other.get('ymap', 0.0):.3f}",
          lightcone_tiles_per_s=f"{tiles / device_ms * 1e3:.2f}")
    return {"launches": counts["kernels"], "paint_calls": calls,
            "planes_err_over_tol": kernels, "y_map_err_over_tol": kernels_y,
            "cudnn_planes_err_over_tol": cudnn,
            "cudnn_y_map_err_over_tol": cudnn_y, "los_s": wall_s,
            "shells": shell_ms, "stages": other,
            "tiles_per_s": tiles / device_ms * 1e3}


def cgan(device, data: dict, card=None) -> dict:
    """Phase 17: the CGAN painter, 17a-17e."""
    return {"k1": check_k1_cgan(device),
            "goldens": paint_cgan_goldens(device),
            "bf16": paint_cgan_bf16(device),
            "timing": time_cgan(device, card=card),
            "lightcone": lightcone_cgan(device, data, card=card)}


# ---------------------------------------------------------------------- #
# phase 18: seamless whole-plane painting

# test_halo_sufficiency's tolerance (tests/test_spatial_paint.py)
HALO_RTOL, HALO_ATOL = 1e-5, 1e-6
# 18a's f32 limits, in units of that tolerance: the f32 paint at
# required_halo against the f64 paint at twice it. Set from
# scripts/halo_readings_torch.py on an H100 (3 processes x 4 paints):
# the largest reading CVAE 0.994, CGAN 5.41 (f32 is not exact, and cuDNN's
# default engines move it by up to 0.99 between paints); a halo one step
# below calibrate_halo reads 79.4 / 15.5
HALO_F32_LIMIT = {"cvae": 2.0, "cgan": 9.0}
HALO_PLANE = 512     # the probe plane's edge (18a)
SEAMLESS_PLANE = 1024  # 18b: plain convolutions im2col the whole plane


def _spatial_painters(device, dtype=None):
    """(label, painter, model kind, z_mode) of the fiducial-512 CVAE (at
    the prior mean) and the CGAN, computing in ``dtype``."""
    from baryon_painter_tpu_torch.painter import CVAEPainter
    return [("cvae", CVAEPainter(str(REPO / CHECKPOINT), device=device,
                                 dtype=dtype), "cvae", "mean"),
            ("cgan", _cgan_painter(device, dtype=dtype), "cgan", "mean")]


def _halo_ratio(a, b) -> float:
    """max |a - b| / (HALO_ATOL + HALO_RTOL |b|)."""
    a = torch.as_tensor(a).double().cpu()
    b = torch.as_tensor(b).double().cpu()
    return float(((a - b).abs() / (HALO_ATOL + HALO_RTOL * b.abs())).max())


def check_halo(device, n: int = HALO_PLANE, calibrate: bool = True) -> list:
    """Phase 18a: for the fiducial-512 CVAE (z_mode 'mean') and the CGAN, a
    probe plane (n^2 golden-style tiles) painted whole with ``paint_plane``
    and held to the f64 paint at twice ``required_halo``, in units of rtol
    1e-5, atol 1e-6 (the JAX package's halo test): the f64 paint at the
    halo within 1; the f32 paint at the halo, as users paint, within
    ``HALO_F32_LIMIT``. With ``calibrate``, ``calibrate_halo``'s measured
    halo (f32) beside the analytic bound, and the f32 paint at one
    alignment step below it must read above the limit, so that the f32
    gate sees a halo that is too short."""
    from baryon_painter_tpu_torch.parallel import spatial
    t0 = time.perf_counter()
    device = torch.device(device)
    plane = golden_inputs(n, 1)[0]
    out = []
    f64 = {label: p for label, p, _, _ in _spatial_painters(device,
                                                            torch.float64)}
    for label, painter, kind, z_mode in _spatial_painters(device):
        arch = painter.meta["model_architecture"]
        h = spatial.required_halo(arch, kind)

        def paint(p, halo):
            return spatial.paint_plane(p, plane, 0.5, halo=halo,
                                       z_mode=z_mode)

        ref = paint(f64[label], 2 * h)
        at_h = paint(painter, h)
        if not (torch.isfinite(at_h).all() and torch.isfinite(ref).all()):
            raise AssertionError(f"paint_plane {label}: not finite")
        rec = {"model": label, "halo": h, "limit": HALO_F32_LIMIT[label],
               "err_over_tol": _halo_ratio(paint(f64[label], h), ref),
               "f32_err_over_tol": _halo_ratio(at_h, ref),
               "calibrated": None, "short_err_over_tol": None}
        if calibrate:
            rec["calibrated"] = spatial.calibrate_halo(painter, z=0.5)
            step_below = rec["calibrated"] - spatial.latent_downsample(arch)
            rec["short_err_over_tol"] = _halo_ratio(
                paint(painter, step_below), ref)
        short = rec["short_err_over_tol"]
        print(f"  {label}: against f64 at halo {2 * h}, worst |diff| / tol:"
              f" f64 at {h} {rec['err_over_tol']:.4f}, f32 at {h} "
              f"{rec['f32_err_over_tol']:.4f} (limit {rec['limit']}); "
              f"calibrate_halo {rec['calibrated']}, f32 one step below it "
              f"{'-' if short is None else f'{short:.4f}'}", flush=True)
        if not (rec["err_over_tol"] <= 1.0
                and rec["f32_err_over_tol"] <= rec["limit"]
                and (rec["short_err_over_tol"] is None
                     or rec["short_err_over_tol"] > rec["limit"])):
            raise AssertionError(f"paint_plane at the required halo against "
                                 f"the f64 paint at twice it: {rec}")
        out.append(rec)
    by_model = lambda key: json.dumps({r["model"]: None if r[key] is None
                                       else round(r[key], 4) for r in out})
    _line("18a", "halo", t0, plane=n,
          halo=json.dumps({r["model"]: r["halo"] for r in out}),
          calibrated=json.dumps({r["model"]: r["calibrated"] for r in out}),
          err_over_tol_f64=by_model("err_over_tol"),
          err_over_tol_f32=by_model("f32_err_over_tol"),
          f32_limit=json.dumps(HALO_F32_LIMIT),
          short_err_over_tol_f32=by_model("short_err_over_tol"))
    return out


def seamless_vs_plain(device, n: int = SEAMLESS_PLANE) -> list:
    """Phase 18b: an n^2 plane painted whole (``paint_plane``) in f32 by
    both painters (the CVAE with one noise draw on the plane's latent grid)
    with cuDNN and with cuDNN off (PyTorch's own convolutions): within the
    golden's tolerance; each paint's peak device memory."""
    from baryon_painter_tpu_torch.parallel import spatial
    t0 = time.perf_counter()
    device = torch.device(device)
    plane = golden_inputs(n, 1)[0]
    out = []
    for label, painter, kind, _ in _spatial_painters(device):
        eps = None
        if kind == "cvae":
            gen = torch.Generator(device=device).manual_seed(0)
            eps = torch.randn(spatial.latent_noise_shape(painter, plane.shape),
                              generator=gen, device=device)
        got = {}
        for name, on in (("cudnn", True), ("plain", False)):
            base = _peak_start(device)
            with _cudnn(on):
                got[name] = spatial.paint_plane(painter, plane, 0.5,
                                                eps=eps).cpu()
            got[name + "_peak_gb"] = _peak_since(device, base) / 1e9
        rec = {"model": label, "err_over_tol": _golden_ratio(got["cudnn"],
                                                             got["plain"]),
               "peak_gb": got["cudnn_peak_gb"],
               "plain_peak_gb": got["plain_peak_gb"]}
        print(f"  {label}: {n}^2 seamless, cuDNN against plain: worst "
              f"|diff| / tol {rec['err_over_tol']:.4f}; peak "
              f"{rec['peak_gb']:.3f} GB (plain {rec['plain_peak_gb']:.3f})",
              flush=True)
        if not (rec["err_over_tol"] <= 1.0
                and torch.isfinite(got["cudnn"]).all()):
            raise AssertionError(f"seamless paint, cuDNN against plain: "
                                 f"{rec}")
        out.append(rec)
    _line("18b", "seamless_vs_plain", t0, plane=n,
          err_over_tol=json.dumps({r["model"]: round(r["err_over_tol"], 4)
                                   for r in out}))
    return out


def _p9999(plane) -> float:
    """The 99.99th percentile of a plane's values."""
    x = torch.as_tensor(plane).float().flatten().cpu()
    k = max(1, int(round(0.9999 * x.numel())))
    return float(x.kthvalue(k).values)


def lightcone_seamless(device, data: dict, tiled: dict, card=None) -> dict:
    """Phase 18c: the lightcone CLI with ``--seamless``, the CVAE in bf16
    (its default) and cuDNN's blocks (seamless paints without the fused
    layout, as in JAX), on phase 16's line of sight: no kernel launches;
    a warm-up run, then timed by stage (CUDA events) and whole (host
    clock) with its peak device memory; e(seamless, tiled), the largest
    bin of ``cl_fractional_error`` of its y map against ``tiled`` (phase
    16c's tiled bf16 cuDNN run: its y map and planes), printed as a finding
    (the two draw different prior noise, and the tiled planes carry the
    tiles' zero-padding edges where the plane's border cuts them), beside
    each delta plane's 99.99th percentile both ways.
    ``--seamless --fused-paint`` must raise ``ValueError``."""
    t0 = time.perf_counter()
    device = torch.device(device)
    los, shells, size = data["los"], data["shells"], data["size"]
    with _tf32(True, False):
        _reset_launches()
        run_lightcone_cli(device, los, "bf16", False, seamless=True, **size)
        counts = _launches()
        _expect_launches("seamless lightcone", counts, {})
        stages = _CountedStages(device, counts=_launches)
        base = _peak_start(device)
        t = time.perf_counter()
        run = run_lightcone_cli(device, los, "bf16", False, seamless=True,
                                stage_times=stages, **size)
        wall_s = time.perf_counter() - t
        peak_gb = _peak_since(device, base) / 1e9
        try:
            run_lightcone_cli(device, los, "bf16", True, seamless=True,
                              **size)
        except ValueError as e:
            refused = str(e)
        else:
            raise AssertionError("--seamless --fused-paint did not raise")
    from baryon_painter_tpu_torch.parallel import spatial
    arch = _load_meta(REPO / CHECKPOINT)["model_architecture"]
    halo = spatial.required_halo(arch, "cvae")
    f = spatial.latent_downsample(arch)
    planes = [s["n_plane"] for s in shells if s["kind"] == "delta"]
    extended = [-(-p // f) * f + 2 * halo for p in planes]
    e = _max_cl_error(run["y_map"], tiled["y_map"], device)
    delta = [i for i, s in enumerate(shells) if s["kind"] == "delta"]
    p9999 = {"seamless": [_p9999(run["planes"][i]) for i in delta],
             "tiled": [_p9999(tiled["planes"][i]) for i in delta]}
    shell_ms, other = _shell_stages(stages, kernels=("k1",))
    for z, s in zip(run["z_SLICS"], shell_ms):
        print(f"  seamless shell z={z:.3f}: " + ", ".join(
            f"{k} {v:.3f} ms" for k, v in s.items() if k != "k1"),
            flush=True)
    finite = bool(np.all(np.isfinite(run["y_map"])))
    if not finite:
        raise AssertionError("seamless lightcone: y map not finite")
    _line("18c", "lightcone_seamless", t0, card=json.dumps(card),
          launches=json.dumps(counts), planes=json.dumps(planes),
          extended=json.dumps(extended), los_s=f"{wall_s:.3f}",
          peak_gb=f"{peak_gb:.3f}",
          paint_ms=f"{sum(s['paint'] for s in shell_ms):.3f}",
          zoom_ms=f"{sum(s['zoom'] for s in shell_ms):.3f}",
          upload_ms=f"{sum(s['upload'] for s in shell_ms):.3f}",
          y_map_ms=f"{other.get('ymap', 0.0):.3f}",
          e_seamless_tiled=f"{e:.4e}",
          p9999=json.dumps({k: [round(v, 4) for v in vs]
                            for k, vs in p9999.items()}),
          fused_refused=json.dumps(refused))
    return {"los_s": wall_s, "peak_gb": peak_gb, "shells": shell_ms,
            "stages": other, "e_seamless_tiled": e, "planes": planes,
            "extended": extended, "launches": counts, "p9999": p9999}


def _load_meta(base: Path) -> dict:
    with open(str(base) + "_meta.json") as f:
        return json.load(f)


def seamless(device, data: dict, tiled: dict, card=None) -> dict:
    """Phase 18: seamless whole-plane painting, 18a-18c (``tiled``: phase
    16c's tiled bf16 cuDNN run)."""
    return {"halo": check_halo(device),
            "plain": seamless_vs_plain(device),
            "lightcone": lightcone_seamless(device, data, tiled, card=card)}


# what each K4 kernel's max_abs_err covers, and the yardstick it carries
_K4_ERRORS = {"stats": ("mean", "var"), "fwd": ("y",),
              "bwd1": ("dgamma", "dbeta"), "bwd2": ("dx", "dw")}
_K4_LIBRARY = {"fwd": "library_fwd_ms", "bwd2": "library_bwd_ms"}


# ---------------------------------------------------------------------- #
# phase 19: the training run, train(), through the training CLI's code

TRAIN_CLI = REPO / "scripts" / "train_cvae_torch.py"
# the run: a constant batch of TRAIN_BATCH, LOOP_PEPOCHS pepochs of
# LOOP_PEPOCH samples, validation and reports every 48 samples, a
# checkpoint every 96; the metrics copied to the host every 16 steps
LOOP_PEPOCH = 96
LOOP_PEPOCHS = 3
LOOP_RUN = dict(validation_loss_frequency=48, validation_loss_batch_size=24,
                checkpoint_frequency=96, statistics_report_frequency=48,
                stats_sync_every=16)
LOOP_PAINT_TILES = 16
LOOP_LR = 1e-4


@contextlib.contextmanager
def _cudnn_algorithms(deterministic: bool):
    """cuDNN's deterministic algorithms, or its default ones (as the
    training CLI runs), for the block; no benchmark either way."""
    prev = (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark)
    torch.backends.cudnn.deterministic = deterministic
    torch.backends.cudnn.benchmark = False
    try:
        yield
    finally:
        (torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = prev


def held_out_data(dataset, seed: int = 1):
    """Test data for the validation loss: one synthetic stack of the
    training stacks' size and redshifts, drawn with another seed, with the
    training data's transforms."""
    from baryon_painter_tpu_torch.data.dataset import (BahamasTileDataset,
                                                       load_file_info)
    from baryon_painter_tpu_torch.data.synthetic import make_synthetic_stacks
    with tempfile.TemporaryDirectory() as root:
        info = make_synthetic_stacks(root, n_stack=1, n_grid=dataset.n_grid,
                                     redshifts=tuple(dataset.redshifts),
                                     seed=seed)
        return BahamasTileDataset(
            files=load_file_info(info), root_path=root,
            n_tile=dataset.n_tile, tile_permutations=True, mmap_mode=None,
            transforms=dataset.transforms)


_MODEL_STATE = ("params", "batch_stats", "opt_state", "step")


def _state_leaves(a: dict, b: dict):
    def leaves(tree, prefix=""):
        for k, v in tree.items():
            if isinstance(v, dict):
                yield from leaves(v, f"{prefix}{k}/")
            else:
                yield prefix + k, np.asarray(v, np.float64)
    la = dict(leaves({k: a[k] for k in _MODEL_STATE}))
    lb = dict(leaves({k: b[k] for k in _MODEL_STATE}))
    if set(la) != set(lb):
        raise AssertionError(f"state trees differ in keys: "
                             f"{sorted(set(la) ^ set(lb))[:5]}")
    return la, lb


def state_distance(a: dict, b: dict) -> float:
    """max |a - b| over the model's state in two trainer state trees:
    parameters, running statistics, Adam's state and the step."""
    la, lb = _state_leaves(a, b)
    return max(float(np.abs(la[k] - lb[k]).max(initial=0.0)) for k in la)


def state_distance_detail(a: dict, b: dict) -> dict:
    """Which leaf sets ``state_distance`` and that difference relative to
    the leaf's own largest entry in ``b``; and the parameter leaf with the
    largest such relative difference (``params/`` only: Adam's second
    moments and the running variances are squares, whose relative
    differences double)."""
    la, lb = _state_leaves(a, b)

    def rel(k):
        scale = float(np.abs(lb[k]).max(initial=0.0))
        diff = float(np.abs(la[k] - lb[k]).max(initial=0.0))
        return diff / scale if scale > 0 else diff

    absolute = {k: float(np.abs(la[k] - lb[k]).max(initial=0.0)) for k in la}
    leaf = max(absolute, key=absolute.get)
    params = [k for k in la if k.startswith("params/")]
    worst = max(params, key=rel)
    return {"distance": absolute[leaf], "leaf": leaf, "leaf_rel": rel(leaf),
            "params_worst_leaf": worst, "params_worst_rel": rel(worst),
            "params_max_abs": max(absolute[k] for k in params)}


def train_loop(device, dataset, batch: int = TRAIN_BATCH,
               n_res_blocks: int = N_RES_BLOCKS, pepoch: int = LOOP_PEPOCH,
               run: dict = LOOP_RUN, paint_tiles: int = LOOP_PAINT_TILES,
               card=None) -> dict:
    """Phase 19, a main path: the training run of the training CLI
    (scripts/train_cvae_torch.py: its ``parse_args``, ``build`` and
    ``run``) at full width, f32, with ``--device-data`` and
    ``BPT_FUSED_HEADS=1``, on phase 5's stacks with a held-out stack as the
    test data, after a warm-up (two steps and a validation loss on a
    trainer thrown away) under each of cuDNN's settings below:

    19a ``train()`` with cuDNN's default algorithms, as the CLI runs:
        LOOP_PEPOCHS pepochs of ``pepoch`` samples at a constant batch,
        with ``run``'s validation, checkpoint and report frequencies, timed
        (host clock, synchronised), and inside it the statistics flushes,
        the validation losses (host batch included) and the checkpoint
        writes, each counted and timed from the end of the steps queued
        before it; on the card exactly one K2, one K3-fwd keeping u1 and
        one K3-bwd launch a step, and one K3-fwd without u1 per validation
        loss; peak device memory; one more checkpoint write timed on its
        own, with its bytes;
    19b the same steps (the indices and schedule ``train()`` passed) through
        ``step_indices`` on a new trainer from the same seed, timed with the
        default algorithms: the gap to 19a is what the loop adds
        (statistics, validation, checkpoints); the replay's state at the
        default algorithms against 19a's, printed and not held: which leaf
        sets the distance, relative to its own largest entry, and the
        parameter leaf furthest apart. No limit can hold there: the default
        algorithms sum the backward in an order that changes from run to
        run, and Adam divides each step by the root of the second moment,
        so a parameter whose gradient is at rounding level moves by up to
        lr a step whichever sign the rounding takes (a batch norm bias
        ahead of another batch norm lies 5.9e-2 of its size apart); a
        limit loose enough for that cannot tell a wrong replay from a
        right one. Then, under cuDNN's
        deterministic algorithms, ``train()`` and its ``step_indices``
        replay again, timed (their times against the default ones are the
        deterministic algorithms' cost); the replay's final state against
        that run's is the run's repeat distance;
    19c under the deterministic algorithms, ``run(--resume-from <that run's
        first periodic checkpoint>)`` into a copy of the first checkpoint
        and the statistics files: the final state and both statistics files
        must equal that run's (if the repeat distance is not 0, the resumed
        state may lie no further from that run's than the repeat does);
    19d ``load_painter`` on 19a's final ``model`` with ``fused_inference``:
        ``paint_tiles`` tiles painted in one call, exactly 4 K1 launches
        on the card, finite;
    19e the run in bf16 with K3 and K4, resumed bit for bit
        (``train_loop_bf16_k4``)."""
    from baryon_painter_tpu_torch.models.cvae import (
        fiducial_cvae_architecture)
    from baryon_painter_tpu_torch.painter import load_painter
    from baryon_painter_tpu_torch.train.run_config import RunConfig
    t0 = time.perf_counter()
    device = torch.device(device)
    cuda = device.type == "cuda"
    twin = _load_cli(TRAIN_CLI)
    datasets = (dataset, held_out_data(dataset))
    n_samples = LOOP_PEPOCHS * pepoch
    n_steps = n_samples // batch
    n_evals = n_samples // run["validation_loss_frequency"]
    with tempfile.TemporaryDirectory() as tmp, _fused_heads_env(True):
        root = Path(tmp)
        config = root / "run_config.json"
        RunConfig(architecture=fiducial_cvae_architecture(
                      dataset.tile_size, n_res_blocks=n_res_blocks),
                  transforms={f: t.to_dict()
                              for f, t in dataset.transforms.items()},
                  schedules={"batch_size_schedule": {"kind": "constant",
                                                     "value": batch}},
                  train=dict(run)).save(str(config))

        def argv(out, *extra):
            return ["--output-path", str(root / out), "--config",
                    str(config), "--n-pepoch", str(LOOP_PEPOCHS),
                    "--pepoch-size", str(pepoch), "--learning-rate",
                    str(LOOP_LR), "--device-data", "--device", str(device),
                    *extra]

        # warm-ups, so that no timed run pays the process's first use of
        # these convolutions under either setting
        for deterministic in (False, True):
            with _cudnn_algorithms(deterministic):
                warm, _ = twin.build(twin.parse_args(argv("warm")), datasets)
                warm.step_scan(np.stack([dataset.sample_indices(
                    np.random.default_rng(0), batch) for _ in range(2)]),
                    1e-4)
                warm.stats_tuple(warm.eval_loss(datasets[1].get_raw_batch(
                    np.arange(run["validation_loss_batch_size"]))))
                del warm
                _sync(device)

        def train(out):
            """``train()`` into ``out``, timed, with the steps it took and
            the loop's own work counted and timed apart: each call waits
            for the steps queued before it, then is timed to its end."""
            trainer, _ = twin.build(twin.parse_args(argv(out)), datasets)
            plan, scan = [], trainer.step_scan

            def recording(idx, lr, alpha_var=1.0, beta_KL=1.0):
                plan.append((idx, lr, alpha_var, beta_KL))
                return scan(idx, lr, alpha_var, beta_KL)

            spent = {"flush": 0.0, "validation": 0.0, "checkpoint": 0.0}
            calls = {"flush": 0, "checkpoint": 0}

            def timed(key, fn):
                def call(*args, **kwargs):
                    _sync(device)
                    t = time.perf_counter()
                    out = fn(*args, **kwargs)
                    _sync(device)
                    spent[key] += time.perf_counter() - t
                    if key in calls:
                        calls[key] += 1
                    return out
                return call

            trainer.step_scan = recording
            trainer._flush_stats = timed("flush", trainer._flush_stats)
            trainer.eval_loss = timed("validation", trainer.eval_loss)
            trainer.save = timed("checkpoint", trainer.save)
            test_batch = datasets[1].get_raw_batch
            datasets[1].get_raw_batch = timed("validation", test_batch)
            _sync(device)
            t = time.perf_counter()
            try:
                stats = trainer.train()
            finally:
                datasets[1].get_raw_batch = test_batch
            _sync(device)
            return (trainer, plan, time.perf_counter() - t, stats,
                    dict(spent), dict(calls))

        def replay(plan, out):
            """The steps of ``plan`` through ``step_indices`` on a new
            trainer, timed; returns its state tree and the seconds."""
            trainer, _ = twin.build(twin.parse_args(argv(out)), datasets)
            _sync(device)
            t = time.perf_counter()
            for idx, lr, alpha_var, beta_KL in plan:
                for row in idx:
                    trainer.step_indices(row, lr, alpha_var, beta_KL)
            _sync(device)
            return trainer.state_tree(), time.perf_counter() - t

        # 19a
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        _reset_launches()
        with _cudnn_algorithms(False):
            trainer, plan, train_s, (tstats, vstats), in_train, calls = \
                train("full")
        counts, kept = _launches(), head_stack_fwd.kept_u1
        peak = torch.cuda.max_memory_allocated(device) if cuda else None
        n = n_steps if cuda else 0
        _expect_launches("train_loop", counts,
                         {"k2": n, "k3_fwd": n + (n_evals if cuda else 0),
                          "k3_bwd": n})
        if kept != n or sum(len(i) for i, *_ in plan) != n_steps:
            raise AssertionError(f"train_loop: K3-fwd kept u1 {kept} times, "
                                 f"{n} steps expected")
        if (tstats.n_batches != n_steps or vstats.n_batches != n_evals
                or not np.isfinite(tstats.loss_terms["ELBO"]["all"]).all()):
            raise AssertionError(
                f"train_loop: {tstats.n_batches} training and "
                f"{vstats.n_batches} validation rows, expected {n_steps} "
                f"and {n_evals}, finite ELBO")
        _sync(device)
        t1 = time.perf_counter()
        ckpt_bytes = trainer.save(str(root / "timed"))
        ckpt_s = time.perf_counter() - t1
        full = trainer.state_tree()
        del trainer
        samples_per_s = n_samples / train_s
        _line("19a", "train_loop", t0, clock="host_clock_after_sync",
              card=json.dumps(card), cudnn="default", steps=n_steps,
              evals=n_evals, train_s=f"{train_s:.3f}",
              train_samples_per_s=f"{samples_per_s:.2f}",
              checkpoint_write_s=f"{ckpt_s:.3f}",
              checkpoint_bytes=ckpt_bytes,
              **{f"in_train_{k}_s": f"{v:.3f}" for k, v in in_train.items()},
              **{f"in_train_{k}_calls": v for k, v in calls.items()},
              peak_memory_gb=(f"{peak / 1e9:.3f}" if peak is not None
                              else "not_measured_on_cpu"),
              launches=json.dumps(counts), k3_fwd_kept_u1=kept,
              elbo_mavg_last=f"{tstats.loss_terms['ELBO']['mavg'][-1]:.4f}")

        # 19b
        t2 = time.perf_counter()
        with _cudnn_algorithms(False):
            default_state, replay_s = replay(plan, "replay")
        default_detail = state_distance_detail(default_state, full)
        default_repeat = default_detail["distance"]
        del default_state
        with _cudnn_algorithms(True):
            det, det_plan, det_train_s, _, _, _ = train("det")
            det_full = det.state_tree()
            del det
            det_state, det_replay_s = replay(det_plan, "det_replay")
        repeat = state_distance(det_state, det_full)
        del det_state
        step_samples_per_s = n_samples / replay_s
        loop_cost = train_s / replay_s - 1.0
        rest = train_s - replay_s - sum(in_train.values())
        _line("19b", "train_loop_vs_step_indices", t2,
              clock="host_clock_after_sync", card=json.dumps(card),
              step_indices_s=f"{replay_s:.3f}",
              train_s=f"{train_s:.3f}", train_rest_s=f"{rest:.3f}",
              step_indices_samples_per_s=f"{step_samples_per_s:.2f}",
              train_samples_per_s=f"{samples_per_s:.2f}",
              loop_cost_pct=f"{100 * loop_cost:.2f}",
              deterministic_step_indices_samples_per_s=(
                  f"{n_samples / det_replay_s:.2f}"),
              deterministic_train_samples_per_s=(
                  f"{n_samples / det_train_s:.2f}"),
              deterministic_step_cost_pct=(
                  f"{100 * (det_replay_s / replay_s - 1.0):.2f}"),
              default_repeat_distance=f"{default_repeat:.3e}",
              default_repeat_leaf=default_detail["leaf"],
              default_repeat_leaf_rel=f"{default_detail['leaf_rel']:.3e}",
              default_repeat_params_worst_leaf=default_detail[
                  "params_worst_leaf"],
              default_repeat_params_worst_rel=(
                  f"{default_detail['params_worst_rel']:.3e}"),
              default_repeat_params_max_abs=(
                  f"{default_detail['params_max_abs']:.3e}"),
              repeat_distance=f"{repeat:.3e}")

        # 19c
        t2 = time.perf_counter()
        first = f"checkpoint_sample{run['checkpoint_frequency']:0>10}"
        (root / "resumed").mkdir()
        for f in os.listdir(root / "det"):
            if f.startswith(first) or f.endswith(".txt"):
                (root / "resumed" / f).write_bytes(
                    (root / "det" / f).read_bytes())
        with _cudnn_algorithms(True):
            res = twin.run(argv("resumed", "--resume-from",
                                str(root / "resumed" / first)), datasets)
        resumed = state_distance(res["trainer"].state_tree(), det_full)
        stats_equal = all(
            (root / "resumed" / f).read_bytes()
            == (root / "det" / f).read_bytes()
            for f in ("training_stats.txt", "validation_stats.txt"))
        stats_files = {name: (root / d / "training_stats.txt").read_bytes()
                       for name, d in (("resumed", "resumed"),
                                       ("uninterrupted", "det"))}
        del res
        if (resumed > repeat or (repeat == 0 and not stats_equal)):
            raise AssertionError(
                f"train_loop: the resumed run lies {resumed:.3e} from the "
                f"uninterrupted one (statistics files equal: "
                f"{stats_equal}), its repeat distance is {repeat:.3e}")
        _line("19c", "train_loop_resume", t2, cudnn="deterministic",
              resumed_from=first, resumed_distance=f"{resumed:.3e}",
              repeat_distance=f"{repeat:.3e}", stats_files_equal=stats_equal)

        # 19d
        t2 = time.perf_counter()
        painter = load_painter(str(root / "full" / "model"),
                               fused_inference=True, device=device)
        tiles = golden_inputs(dataset.tile_size, paint_tiles)
        zs = np.linspace(0.0, 1.0, paint_tiles).astype(np.float32)
        _reset_launches()
        painted = painter.paint_batch(tiles, zs)
        _sync(device)
        paint_counts = _launches()
        _expect_launches("train_loop paint", paint_counts,
                         {"k1": n_res_blocks if cuda else 0})
        finite = bool(torch.isfinite(painted).all())
        if not finite or tuple(painted.shape) != tiles.shape:
            raise AssertionError(f"train_loop paint: shape "
                                 f"{tuple(painted.shape)}, finite {finite}")
        _line("19d", "train_loop_paint", t2, tiles=paint_tiles,
              launches=json.dumps(paint_counts), finite=finite)

        bf16_leg = train_loop_bf16_k4(device, twin, datasets, root, batch,
                                      n_res_blocks, run)
    return {"launches": counts, "paint_launches": paint_counts,
            "evals": n_evals, "steps": n_steps, "train_s": train_s,
            "samples_per_s": samples_per_s,
            "step_indices_samples_per_s": step_samples_per_s,
            "deterministic_train_s": det_train_s,
            "deterministic_step_indices_s": det_replay_s,
            "loop_cost": loop_cost, "checkpoint_s": ckpt_s,
            "in_train_s": in_train, "in_train_calls": calls,
            "train_rest_s": rest, "checkpoint_bytes": ckpt_bytes,
            "peak_bytes": peak, "default_repeat_distance": default_repeat,
            "repeat_distance": repeat, "resumed_distance": resumed,
            "stats_files_equal": stats_equal, "stats_files": stats_files,
            "default_repeat_detail": default_detail, "bf16_k4": bf16_leg}


# 19e: the bf16 run with K4, two pepochs of two steps, validation and a
# checkpoint after each pepoch; resumed from the first checkpoint
LOOP_BF16_PEPOCHS = 2


def train_loop_bf16_k4(device, twin, datasets, root: Path,
                       batch: int = TRAIN_BATCH,
                       n_res_blocks: int = N_RES_BLOCKS,
                       run: dict = LOOP_RUN) -> dict:
    """Phase 19e: the training CLI's run in bf16 with K3 and K4
    (``--dtype bfloat16``, ``BPT_FUSED_HEADS=1``, ``BPT_FUSED_TRAIN_CONV=1``)
    under cuDNN's deterministic algorithms: LOOP_BF16_PEPOCHS pepochs of two
    steps (``run``'s other settings), a validation loss and a checkpoint
    after each pepoch;
    on the card per step one K2 and, all in bf16, one K3-fwd keeping u1,
    one K3-bwd and 4 launches of each K4 kernel, and per validation loss
    (a train-mode forward without a gradient) one K3-fwd and 4 K4-stats
    and K4-fwd; then ``run(--resume-from`` the first checkpoint``)`` into
    a copy of it and the statistics files: the final state and both files
    equal the uninterrupted run's bit for bit."""
    from baryon_painter_tpu_torch.models.cvae import (
        fiducial_cvae_architecture)
    from baryon_painter_tpu_torch.train.run_config import RunConfig
    t0 = time.perf_counter()
    dataset = datasets[0]
    cuda = torch.device(device).type == "cuda"
    pepoch = 2 * batch
    config = root / "run_config_bf16.json"
    RunConfig(architecture=fiducial_cvae_architecture(
                  dataset.tile_size, n_res_blocks=n_res_blocks),
              transforms={f: t.to_dict()
                          for f, t in dataset.transforms.items()},
              schedules={"batch_size_schedule": {"kind": "constant",
                                                 "value": batch}},
              train=dict(run, validation_loss_frequency=pepoch,
                         checkpoint_frequency=pepoch,
                         statistics_report_frequency=pepoch)).save(
                             str(config))

    def argv(out, *extra):
        return ["--output-path", str(root / out), "--config", str(config),
                "--n-pepoch", str(LOOP_BF16_PEPOCHS), "--pepoch-size",
                str(pepoch), "--learning-rate", str(LOOP_LR), "--device-data",
                "--dtype", "bfloat16", "--device", str(device), *extra]

    steps = LOOP_BF16_PEPOCHS * pepoch // batch
    evals = LOOP_BF16_PEPOCHS
    prev = os.environ.get("BPT_FUSED_TRAIN_CONV")
    os.environ["BPT_FUSED_TRAIN_CONV"] = "1"
    try:
        with _fused_heads_env(True), _cudnn_algorithms(True):
            _reset_launches()
            full = twin.run(argv("bf16"), datasets)
            _sync(device)
            counts, bf16_counts = _launches(), _bf16_launches()
            kept = head_stack_fwd.kept_u1
            state = full["trainer"].state_tree()
            del full
            first = f"checkpoint_sample{pepoch:0>10}"
            (root / "bf16_resumed").mkdir()
            for f in os.listdir(root / "bf16"):
                if f.startswith(first) or f.endswith(".txt"):
                    (root / "bf16_resumed" / f).write_bytes(
                        (root / "bf16" / f).read_bytes())
            res = twin.run(argv("bf16_resumed", "--resume-from",
                                str(root / "bf16_resumed" / first)),
                           datasets)
            resumed = state_distance(res["trainer"].state_tree(), state)
            del res
    finally:
        if prev is None:
            os.environ.pop("BPT_FUSED_TRAIN_CONV", None)
        else:
            os.environ["BPT_FUSED_TRAIN_CONV"] = prev
    n, e = (steps, evals) if cuda else (0, 0)
    sites = k4_sites_per_step(dataset.tile_size)
    want = {"k2": n, "k3_fwd": n + e, "k3_bwd": n,
            "k4_stats": sites * (n + e), "k4_fwd": sites * (n + e),
            "k4_bwd1": sites * n, "k4_bwd2": sites * n}
    _expect_launches("train_loop bf16 K4", counts, want)
    _expect_launches("train_loop bf16 K4 (bf16 launches)", bf16_counts,
                     {k: v for k, v in want.items() if k != "k2"})
    stats_equal = all(
        (root / "bf16_resumed" / f).read_bytes()
        == (root / "bf16" / f).read_bytes()
        for f in ("training_stats.txt", "validation_stats.txt"))
    if kept != n or resumed != 0 or not stats_equal:
        raise AssertionError(
            f"train_loop bf16 K4: K3-fwd kept u1 {kept} times ({n} steps); "
            f"the resumed run lies {resumed:.3e} from the uninterrupted "
            f"one; statistics files equal: {stats_equal}")
    _line("19e", "train_loop_bf16_k4", t0, cudnn="deterministic",
          steps=steps, evals=evals, launches=json.dumps(counts),
          bf16_launches=json.dumps(bf16_counts), k3_fwd_kept_u1=kept,
          resumed_from=first, resumed_distance=f"{resumed:.3e}",
          stats_files_equal=stats_equal)
    return {"launches": counts, "bf16_launches": bf16_counts,
            "resumed_distance": resumed, "stats_files_equal": stats_equal,
            "steps": steps, "evals": evals}


# ---------------------------------------------------------------------- #
# Phase 20: the P(k) fidelity gate and the spectral training step

SPREAD_CLI = REPO / "scripts" / "fidelity_spread_torch.py"
# the JAX package's readings of phase 20's evaluations on the CPU and its
# prior noise (scripts/make_gate_reference_torch.py)
GATE_REFERENCE = (Path(__file__).resolve().parent / "data"
                  / "gate_reference.npz")
# the committed fiducial CVAE's gate evaluation (trained_models/README.md's
# command; its meta records no fidelity_dataset)
GATE_CVAE_DATASET = {
    "tile": 512, "redshifts": "0,0.125,0.25,0.375,0.5,0.75,1,1.25,1.5,1.75,2",
    "n_stack": 4, "physical": False, "pressure_noise": 0.1, "seed": 0}
# 3 of its 11 redshifts (time): the first three, whose stacks the synthetic
# generator draws first, so these alone give the committed tiles
GATE_CVAE_Z = "0,0.125,0.25"
GATE_TILES = 48
# prior-noise seeds of the spread (the CGAN draws no noise: one reading)
GATE_SEEDS = 4
# |kernels - plain| of each median error, both f32 at the same noise
GATE_KERNEL_TOL = 2e-3
# the committed value within max(GATE_SIGMA * sigma, GATE_FLOOR) of the
# mean over the noise seeds (scripts/fidelity_spread_torch.py)
GATE_SIGMA = 3.0
GATE_FLOOR = 5e-4
# the spectral term's weight in the committed fine-tunes
# (trained_models/README.md: --pk-loss-weight 2e4)
PK_WEIGHT = 2e4
PK_CONFIG = {"pk_loss_weight": PK_WEIGHT, "pk_loss_per_z": True}
PK_LOSS_RTOL = 1e-5


def _gate_reference() -> dict:
    with np.load(GATE_REFERENCE) as ref:
        return {k: ref[k] for k in ref.files}


def gate_check(device, checkpoint: str, want_launches: dict, kind: str,
               fallback: dict = None, redshifts: str = None,
               seeds: int = GATE_SEEDS, card=None, phase="20a") -> dict:
    """Phase 20a (20b): the gate twin (``scripts/fidelity_check_torch.py``,
    ``--eval-only``) on a committed checkpoint at the committed
    evaluation's tiles (``GATE_TILES`` per redshift; ``redshifts`` limits
    them). One paint call launches exactly ``want_launches`` on the card.
    Each median error (auto, cross) per redshift:

    - f32 at the JAX package's prior noise (``GATE_REFERENCE``, a CVAE's
      draw of PRNGKey(0)): the kernels' within GATE_KERNEL_TOL of the plain
      paint's (cuDNN off), and within GATE_FLOOR of the committed report;
    - over ``seeds`` noise seeds of the port's own generator, f32: the
      committed value within max(GATE_SIGMA sigma, GATE_FLOOR) of the
      port's mean (``scripts/fidelity_spread_torch.py``);
    - bf16 at the JAX package's bf16 noise: the kernels' within
      max(GATE_FLOOR, |JAX f32 - JAX bf16|, |JAX jitted - JAX pinned|) of
      the JAX package's bf16 on the CPU with the source's rounding points
      (``GATE_REFERENCE``): no further from JAX's bf16 than bf16 lies from
      f32 there. bf16 is chaotic at this metric: the JAX package's own TPU
      readings lie up to 0.63 of that distance from its CPU ones (the
      fiducial CVAE), the CGAN's pixels move by about all of it when only
      a sum's order changes (phase 17c); a bf16 paint gone wrong (NaN, or a
      1 -> 1 channel convolution off by 350 %) lies orders beyond it;
    - the committed report's bf16 ("model") values beside the port's
      spread, printed and counted but not held: the TPU's bf16 readings
      are not reproducible off the TPU, by the JAX package either (its CPU
      bf16 lies up to 7e-3 from them, ``scripts/make_gate_reference_torch.py``).

    The seconds of one evaluation (a paint of the tiles and its spectra)
    are printed per leg. The rules' failures come back under ``fails``;
    ``gate`` raises on them."""
    spread = _load_cli(SPREAD_CLI)
    gate = spread.gate
    t0 = time.perf_counter()
    device = torch.device(device)
    base = str(REPO / checkpoint)
    ref = _gate_reference()
    eps32 = ref.get(f"{kind}_eps_f32")
    eps16 = ref.get(f"{kind}_eps_bf16")
    committed = spread.committed_report(base)
    with tempfile.TemporaryDirectory() as tmp:
        flags = spread.dataset_flags(base, fallback)
        if redshifts is not None:
            flags += ["--redshifts", redshifts]
        args = gate.parse_args(flags + [
            "--eval-only", "--checkpoint", base, "--eval-tiles",
            str(GATE_TILES), "--workdir", tmp, "--device", str(device)])
        g = gate.setup(args)
        setup_s = time.perf_counter() - t0
        zs = list(g.val_ds.redshifts)
        k32, p32 = g.make_painter(None), g.make_painter(None, fused=False)
        k16 = g.make_painter(torch.bfloat16)
        p16 = g.make_painter(torch.bfloat16, fused=False)
        score = lambda p, z, eps: gate.pk_errors(
            p, g.val_ds, GATE_TILES, z=z,
            eps=None if eps is None else eps[:GATE_TILES])[:2]
        score(k32, zs[0], eps32)  # the truth spectra, cached
        _sync(device)
        _reset_launches()
        score(k32, zs[0], eps32)
        _sync(device)
        counts = _launches()
        _expect_launches(f"gate {checkpoint}", counts,
                         want_launches if device.type == "cuda" else {})
        rows, fails = {}, []
        for z in zs:
            zk = f"{z:g}"
            k = score(k32, z, eps32)
            with _cudnn(False):
                p = score(p32, z, eps32)
            bk, bc = score(k16, z, eps16), score(p16, z, eps16)
            jit = ref[f"{kind}_bf16_jit_z{zk}"]
            pinned = ref[f"{kind}_bf16_pinned_z{zk}"]
            jax32 = ref[f"{kind}_f32_z{zk}"]
            for i, name in enumerate(("auto", "cross")):
                r = {"f32": k[i], "f32_plain": p[i],
                     "kernels_vs_plain": abs(k[i] - p[i]),
                     "committed_f32": committed["f32"][zk][name],
                     "bf16": bk[i], "bf16_cudnn": bc[i],
                     "jax_bf16_jit": float(jit[i]),
                     "jax_bf16_pinned": float(pinned[i]),
                     "jax_f32": float(jax32[i]),
                     "bf16_limit": max(GATE_FLOOR,
                                       abs(jax32[i] - pinned[i]),
                                       abs(jit[i] - pinned[i]))}
                r["f32_vs_committed"] = abs(r["f32"] - r["committed_f32"])
                r["bf16_vs_jax"] = abs(r["bf16"] - r["jax_bf16_pinned"])
                rows[zk, name] = r
                print(f"  {phase} z={zk} {name}: f32 {k[i]:.5f} (plain "
                      f"{p[i]:.5f}, committed {r['committed_f32']}); bf16 "
                      f"{bk[i]:.5f} (cuDNN {bc[i]:.5f}, JAX CPU pinned "
                      f"{pinned[i]:.5f}, jitted {jit[i]:.5f}, limit "
                      f"{r['bf16_limit']:.5f})", flush=True)
                if r["kernels_vs_plain"] > GATE_KERNEL_TOL:
                    fails.append(("kernels_vs_plain", zk, name,
                                  r["kernels_vs_plain"]))
                if r["f32_vs_committed"] > GATE_FLOOR:
                    fails.append(("f32_vs_committed", zk, name,
                                  r["f32_vs_committed"]))
                if r["bf16_vs_jax"] > r["bf16_limit"]:
                    fails.append(("bf16_vs_jax", zk, name,
                                  r["bf16_vs_jax"]))
        del p32, p16
        eval_s, reads = {}, {}
        for label, dtype in g.legs:
            _sync(device)
            t = time.perf_counter()
            reads.update(spread.readings(
                SimpleNamespace(**{**vars(g), "legs": [(label, dtype)]}),
                zs, range(seeds), GATE_TILES, seed=args.seed))
            _sync(device)
            eval_s[label] = (time.perf_counter() - t) / (len(zs) * seeds)
    summary = spread.summarise(reads, committed, GATE_SIGMA, GATE_FLOOR)
    outside = {"f32": [], "model": []}
    for leg, per_z in summary.items():
        for z, kinds in per_z.items():
            for name, r in kinds.items():
                print(f"  {phase} spread {leg} z={z} {name}: port "
                      f"{r['mean']:.5f} +- {r['std']:.5f} ({len(r['values'])}"
                      f" seeds), committed {r['committed']}, limit "
                      f"{r['limit']:.5f}", flush=True)
                if r["within"] is False:
                    outside[leg].append((z, name, abs(r["committed"]
                                                      - r["mean"])))
    fails += [("f32_spread", z, name, d) for z, name, d in outside["f32"]]
    worst = lambda key: max(r[key] for r in rows.values())
    _line(phase, "gate", t0, checkpoint=checkpoint, card=json.dumps(card),
          redshifts=",".join(f"{z:g}" for z in zs), tiles=GATE_TILES,
          seeds=seeds, launches=json.dumps(counts),
          kernels_vs_plain_max=f"{worst('kernels_vs_plain'):.3e}",
          f32_vs_committed_max=f"{worst('f32_vs_committed'):.3e}",
          bf16_vs_jax_max=f"{worst('bf16_vs_jax'):.3e}",
          bf16_over_limit_max=(
              f"{max(r['bf16_vs_jax'] / r['bf16_limit'] for r in rows.values()):.3f}"),
          f32_spread_outside=len(outside["f32"]),
          bf16_committed_outside=len(outside["model"]),
          setup_s=f"{setup_s:.3f}",
          **{f"eval_s_{k}": f"{v:.4f}" for k, v in eval_s.items()})
    return {"launches": counts, "rows": {f"{z}/{k}": v
                                         for (z, k), v in rows.items()},
            "summary": summary, "outside": outside, "fails": fails,
            "eval_s": eval_s, "setup_s": setup_s,
            "data": (g.train_ds, g.val_ds)}


def gate(device, card=None, keep: dict = None) -> dict:
    """Phase 20a on the fiducial CVAE (K1 4 and K3-fwd 1 a paint call), 20b
    on the CGANs, fiducial and fiducial-adv (K1 9 a call), and 20d, the
    bf16 readings of the four committed CVAEs (``gate_bf16``; ``keep`` as
    there); raises on any failed rule."""
    run = {"cvae": gate_check(device, CHECKPOINT, {"k1": N_RES_BLOCKS,
                                                   "k3_fwd": 1}, "cvae",
                              fallback=GATE_CVAE_DATASET,
                              redshifts=GATE_CVAE_Z, card=card),
           "cgan": gate_check(device, CGAN_PATH, {"k1": 9}, "cgan",
                              seeds=1, card=card, phase="20b"),
           "cgan_adv": gate_check(device, CGAN_ADV_PATH, {"k1": 9},
                                  "cgan_adv", seeds=1, card=card,
                                  phase="20b"),
           "cvae_bf16": gate_bf16(device, card=card, keep=keep)}
    fails = {k: r["fails"] for k, r in run.items() if r["fails"]}
    if fails:
        raise AssertionError(f"gate: {fails}")
    return run


# 20d: the bf16 gate readings of the four committed CVAEs, each against the
# JAX package's CPU bf16 at its bf16 noise (GATE_REFERENCE, key prefix):
# (prefix, checkpoint, dataset fallback, redshifts held)
GATE_BF16_CASES = (
    ("cvae", CHECKPOINT, GATE_CVAE_DATASET,
     (0.0, 0.125, 0.25, 0.375, 0.5, 0.75, 1.0, 1.25, 1.5, 1.75, 2.0)),
    ("cvae_resize", "trained_models/CVAE/fiducial-resize/model", None,
     (0.5,)),
    ("cvae_lt", "trained_models/CVAE/physical-512-lt-wip/model", None,
     (0.25, 1.25, 1.75, 2.0)),
    ("cvae_resize_wip", "trained_models/CVAE/physical-512-resize-wip/model",
     None, (0.25, 1.0, 1.25, 1.5, 1.75, 2.0)))
# the committed bf16 readings that lay outside the port's spread over
# noise seeds (scripts/fidelity_spread_torch.py, ROADMAP.md section 3):
# {prefix: {z: kinds}}
GATE_BF16_OPEN = {
    "cvae": {0.0: ("auto", "cross"), 0.125: ("auto", "cross"),
             0.25: ("auto", "cross"), 0.375: ("auto", "cross"),
             0.5: ("auto", "cross"), 0.75: ("auto",),
             1.0: ("auto", "cross"), 1.25: ("auto",),
             1.5: ("auto", "cross"), 1.75: ("auto",),
             2.0: ("auto", "cross")},
    "cvae_resize": {0.5: ("auto",)},
    "cvae_lt": {0.25: ("auto",), 1.25: ("auto",), 1.75: ("auto",),
                2.0: ("auto",)},
    "cvae_resize_wip": {0.25: ("auto",), 1.0: ("auto", "cross"),
                        1.25: ("auto", "cross"), 1.5: ("auto", "cross"),
                        1.75: ("auto", "cross"), 2.0: ("auto", "cross")}}


def gate_bf16(device, cases=GATE_BF16_CASES, card=None,
              keep: dict = None) -> dict:
    """Phase 20d: the bf16 gate readings of the committed CVAEs at the
    redshifts of ``cases``, through the gate twin's ``--eval-only`` code at
    each committed evaluation's tiles (its dataset flags; ``GATE_TILES``
    a redshift), painted through K1 and K3 in bf16 at the JAX package's
    bf16 prior noise. Each median error (auto, cross) is held, as 20a/20b
    hold theirs, within max(GATE_FLOOR, |JAX f32 - JAX bf16|, |JAX jitted
    - JAX pinned|) of the JAX package's CPU bf16 (``GATE_REFERENCE``,
    ``scripts/make_gate_reference_torch.py``). Prints, for each reading,
    committed / JAX CPU bf16 / port / share of the limit, and whether it
    is one of the committed readings outside the port's spread
    (``GATE_BF16_OPEN``). ``keep`` maps a case's prefix to a directory in
    which its synthetic stacks are written and kept (phase 24 reads
    ``cvae_lt``'s); the others go to a temporary directory. The failures
    come back under ``fails``; the caller raises on them."""
    spread = _load_cli(SPREAD_CLI)
    gate = spread.gate
    t0 = time.perf_counter()
    device = torch.device(device)
    ref = _gate_reference()
    rows, fails, launches, setup_s, eval_s = [], [], {}, {}, {}
    for prefix, checkpoint, fallback, zs in cases:
        t = time.perf_counter()
        base = str(REPO / checkpoint)
        committed = spread.committed_report(base)["model"]
        eps = ref[f"{prefix}_eps_bf16"][:GATE_TILES]
        kept = (keep or {}).get(prefix)
        with (contextlib.nullcontext(str(kept)) if kept is not None
              else tempfile.TemporaryDirectory()) as tmp:
            args = gate.parse_args(spread.dataset_flags(base, fallback) + [
                "--eval-only", "--checkpoint", base, "--eval-tiles",
                str(GATE_TILES), "--workdir", tmp, "--device", str(device)])
            g = gate.setup(args)
            painter = g.make_painter(torch.bfloat16)
            setup_s[prefix] = time.perf_counter() - t
            score = lambda z: gate.pk_errors(painter, g.val_ds, GATE_TILES,
                                             z=z, eps=eps)[:2]
            score(zs[0])  # the truth spectra, cached
            _sync(device)
            _reset_launches()
            score(zs[0])
            _sync(device)
            launches[prefix] = _bf16_launches()
            t = time.perf_counter()
            for z in zs:
                zk = f"{z:g}"
                port = score(z)
                jit = ref[f"{prefix}_bf16_jit_z{zk}"]
                pinned = ref[f"{prefix}_bf16_pinned_z{zk}"]
                jax32 = ref[f"{prefix}_f32_z{zk}"]
                for i, kind in enumerate(("auto", "cross")):
                    limit = max(GATE_FLOOR, abs(jax32[i] - pinned[i]),
                                abs(jit[i] - pinned[i]))
                    r = {"model": prefix, "checkpoint": checkpoint,
                         "z": zk, "kind": kind,
                         "committed": committed[zk][kind],
                         "jax_bf16_pinned": float(pinned[i]),
                         "jax_bf16_jit": float(jit[i]),
                         "jax_f32": float(jax32[i]), "port": port[i],
                         "limit": float(limit),
                         "open": kind in GATE_BF16_OPEN.get(prefix, {}).get(
                             z, ())}
                    r["share"] = abs(r["port"] - r["jax_bf16_pinned"]) / limit
                    rows.append(r)
                    print(f"  20d {checkpoint} z={zk} {kind}: committed "
                          f"{r['committed']} / JAX CPU bf16 "
                          f"{r['jax_bf16_pinned']:.5f} / port "
                          f"{r['port']:.5f}: {r['share']:.3f} of the limit "
                          f"{limit:.5f}" + (" (open)" if r["open"] else ""),
                          flush=True)
                    if r["share"] > 1:
                        fails.append((checkpoint, zk, kind, r["share"]))
            _sync(device)
            eval_s[prefix] = (time.perf_counter() - t) / len(zs)
    open_rows = [r for r in rows if r["open"]]
    _line("20d", "gate_bf16", t0, card=json.dumps(card),
          readings=len(rows), open_readings=len(open_rows),
          open_within=sum(r["share"] <= 1 for r in open_rows),
          share_max=f"{max(r['share'] for r in rows):.3f}",
          open_share_max=(f"{max(r['share'] for r in open_rows):.3f}"
                          if open_rows else "-"),
          launches=json.dumps(launches),
          **{f"setup_s_{k}": f"{v:.3f}" for k, v in setup_s.items()},
          **{f"eval_s_{k}": f"{v:.4f}" for k, v in eval_s.items()})
    return {"rows": rows, "fails": fails, "launches": launches,
            "setup_s": setup_s, "eval_s": eval_s}


def _fiducial_variables() -> dict:
    from baryon_painter_tpu_torch.train import checkpoint as ckpt
    state, _ = ckpt.load_checkpoint(str(REPO / CHECKPOINT))
    return {"params": state["params"], "batch_stats": state["batch_stats"]}


def pk_parity(device, dataset, variables: dict,
              batch: int = TRAIN_BATCH) -> dict:
    """20c's step rules: one spectral step (``PK_CONFIG``, from the
    committed fiducial CVAE's weights: an initialised decoder paints an
    almost constant field, whose spectrum is round-off) with the kernels
    (K2, K3) against one with their plain versions, at the same batch, ELBO
    noise and spectral noise, cuDNN deterministic. f32 (against the plain
    gather and cuDNN's heads): the loss and ``pk_loss`` to PK_LOSS_RTOL, each
    gradient to STEP_GRAD_TOL of its own largest entry (8b's rule). bf16
    (the plain step with K3's plain versions, 13b's): d(kernels, plain) <=
    BF16_STEP_RATIO d(plain bf16, plain f32) over the concatenated
    gradient."""
    idx, eps = parity_inputs(dataset, batch)
    hz = dataset.tile_size // 32
    pk_eps = torch.randn((batch, 1, hz, hz),
                         generator=torch.Generator().manual_seed(4))
    common = dict(fused_train_conv=False, config=PK_CONFIG,
                  variables=variables, pk_eps=pk_eps)
    plans = {"kernels": dict(kernels=True),
             "plain": dict(kernels=False),
             "kernels_bf16": dict(kernels=True, dtype=torch.bfloat16),
             "plain_bf16": dict(kernels=False, plain_heads=True,
                                dtype=torch.bfloat16),
             "plain_heads_f32": dict(kernels=False, plain_heads=True)}
    runs, metrics = {}, {}
    for label, kw in plans.items():
        metrics[label] = {}
        runs[label] = step_gradients(device, dataset, idx, eps, **kw,
                                     **common, metrics=metrics[label])[1]
    loss = {k: -m["elbo"] + PK_WEIGHT * m["pk_loss"]
            for k, m in metrics.items()}
    rel = lambda a, b: abs(a - b) / abs(b)
    loss_err = rel(loss["kernels"], loss["plain"])
    pk_err = rel(metrics["kernels"]["pk_loss"], metrics["plain"]["pk_loss"])
    grad_errs, under, top = step_grad_errors(runs["kernels"], runs["plain"])
    worst = max(grad_errs, key=grad_errs.get)
    vec = {k: _grad_vector(v) for k, v in runs.items()}
    d_kp = rel_l2(vec["kernels_bf16"], vec["plain_bf16"])
    gap = rel_l2(vec["plain_bf16"], vec["plain_heads_f32"])
    res = {"loss_rel_err": loss_err, "pk_loss_rel_err": pk_err,
           "pk_loss": metrics["plain"]["pk_loss"],
           "pk_loss_bf16": metrics["plain_bf16"]["pk_loss"],
           "worst_grad": worst, "worst_grad_rel_err": grad_errs[worst],
           "bf16_d_kernels_plain": d_kp, "bf16_d_plain_bf16_f32": gap,
           "bf16_ratio": d_kp / gap if gap > 0 else 0.0,
           "under_floor": len(under)}
    print(f"  20c f32 worst gradients: {_worst(grad_errs, runs['plain'])}",
          flush=True)
    if not (loss_err <= PK_LOSS_RTOL and pk_err <= PK_LOSS_RTOL
                      and grad_errs[worst] <= STEP_GRAD_TOL
                      and d_kp <= BF16_STEP_RATIO * gap):
        raise AssertionError(f"spectral step, kernels against plain: {res}")
    return res


def pk_step(device, dataset, card=None, f32_ms=None, bf16_ms=None,
            batch: int = TRAIN_BATCH, warmup: int = 3,
            iters: int = 10) -> dict:
    """Phase 20c, a main path: the spectral fine-tuning step
    (``PK_CONFIG``, per redshift) at batch 24, 512^2, from the committed
    fiducial CVAE's weights, through K2 and K3, timed in f32 and bf16 as
    phases 8 and 13 are (``train``: per step one K2, two K3-fwd keeping u1
    and two K3-bwd launches, the spectral forward's among them; the
    running statistics the ELBO's alone); the peak device memory; phase 8's
    and 13's step without the term beside; then ``pk_parity``."""
    t0 = time.perf_counter()
    variables = _fiducial_variables()
    out = {}
    for label, dtype, without in (("float32", None, f32_ms),
                                  ("bfloat16", torch.bfloat16, bf16_ms)):
        extra = ({"step_ms_without_pk": f"{without:.3f}",
                  "samples_per_s_without_pk":
                      f"{batch / without * 1e3:.2f}"}
                 if without is not None else {})
        out[label] = train(device, dataset, batch=batch, warmup=warmup,
                           iters=iters, card=card, dtype=dtype,
                           config=PK_CONFIG, variables=variables,
                           phase=("20c", "train_pk" + (
                               "_bf16" if dtype is not None else "")),
                           extra=extra)
    parity = pk_parity(device, dataset, variables, batch=batch)
    _line("20c", "train_pk_parity", t0,
          loss_rel_err=f"{parity['loss_rel_err']:.3e}",
          pk_loss_rel_err=f"{parity['pk_loss_rel_err']:.3e}",
          pk_loss=f"{parity['pk_loss']:.6f}",
          worst_grad=parity["worst_grad"],
          worst_grad_rel_err=f"{parity['worst_grad_rel_err']:.3e}",
          bf16_ratio=f"{parity['bf16_ratio']:.4f}",
          bf16_limit_ratio=BF16_STEP_RATIO)
    out["parity"] = parity
    return out


# ---------------------------------------------------------------------- #
# Phase 21: CGAN training

CGAN_ADV_PATH = "trained_models/CGAN/fiducial-adv/model"
TRAIN_CGAN_CLI = REPO / "scripts" / "train_cgan_torch.py"
# the reference's batch (trained_models/README.md:130-139)
CGAN_BATCH = 6
# 21b: the f32 step against the same step in f64: the losses and the new
# running state (batch norm and spectral norm) to CGAN_F64_RTOL relative
# (of each state leaf's largest entry); D_real and D_fake, the mean
# probabilities, to CGAN_F64_RTOL relative in their logarithm (a saturated
# D's mean probability carries the logits' absolute f32 error as its
# relative one: at the CPU test's batch, where D_fake = 5.3e-8, the JAX
# package's own f32 discriminator lies 4.0e-5 from its f64 one,
# scripts/cgan_step_conditioning.py); every gradient leaf to STEP_GRAD_TOL
# of its own largest entry (8b's rule), the biases ahead of a batch norm
# (``train.cgan.zero_gradient_leaves``, whose gradient is 0 analytically)
# to STEP_GRAD_TOL of the network's largest
CGAN_F64_RTOL = 1e-5
# 21c: the spectral term's weight in fiducial-adv's fine-tunes
CGAN_PK_WEIGHT = 1e4
# 21d: two pepochs of 48 samples, validation every 24, a checkpoint every 48
CGAN_LOOP_PEPOCH = 48
CGAN_LOOP_PEPOCHS = 2
CGAN_LOOP_VALIDATION = 24
CGAN_LOOP_LR = 5e-5
# 21e: the tiles of one from_trainer paint call
CGAN_PAINT_TILES = 16


def _cgan_trainer(device, dataset, base=CGAN_ADV_PATH, dtype=None,
                  use_kernel="auto", test_data=None, **config):
    """A ``CGANTrainer`` at full width (9 residual blocks) on ``dataset``
    with the stack cache, restored from ``base`` (G, D, both Adams);
    ``dtype=torch.float64`` builds both networks in f64 first."""
    from baryon_painter_tpu_torch.models.cgan import (CGANDiscriminator,
                                                      CGANGenerator)
    from baryon_painter_tpu_torch.train.cgan import (CGANTrainConfig,
                                                     CGANTrainer)
    g = CGANGenerator(n_res_blocks=9, spectral_norm=True)
    d = CGANDiscriminator()
    if dtype is not None:
        g, d = g.to(dtype), d.to(dtype)
    trainer = CGANTrainer(dataset, test_data=test_data, generator=g,
                          discriminator=d,
                          config=CGANTrainConfig(
                              batch_size=config.pop("batch_size",
                                                    CGAN_BATCH),
                              **config),
                          device_data=True, device=device,
                          use_kernel=use_kernel)
    if base is not None:
        trainer.restore(str(REPO / base))
    return trainer


def _cgan_idx(dataset, batch: int, seed: int = 1):
    return dataset.sample_indices(np.random.default_rng(seed), batch)


def cgan_step(device, dataset, batch: int = CGAN_BATCH, warmup: int = 2,
              iters: int = 5, card=None) -> dict:
    """Phase 21a, a main path: ``CGANTrainer.step_indices`` at full width
    from the committed fiducial-adv state (G, D, both Adams) on phase 5's
    stacks, f32: warm-ups, then ``iters`` steps timed on the host clock
    after a synchronise, with the peak device memory; exactly one K2
    launch a step on the card (and no other kernel)."""
    t0 = time.perf_counter()
    device = torch.device(device)
    cuda = device.type == "cuda"
    trainer = _cgan_trainer(device, dataset, batch_size=batch)
    rng = np.random.default_rng(0)
    for _ in range(warmup):
        trainer.step_indices(dataset.sample_indices(rng, batch), 5e-5)
    base = _peak_start(device)
    _reset_launches()
    _sync(device)
    t = time.perf_counter()
    losses = []
    for _ in range(iters):
        m = trainer.step_indices(dataset.sample_indices(rng, batch), 5e-5)
        losses.append(m)
    _sync(device)
    step_s = (time.perf_counter() - t) / iters
    counts = _launches()
    peak = _peak_since(device, base)
    _expect_launches("cgan_step", counts, {"k2": iters} if cuda else {})
    rows = trainer._host_rows(losses)
    if not np.all(np.isfinite(rows)):
        raise AssertionError(f"cgan_step: losses {rows}")
    _line("21a", "cgan_step", t0, clock="host_clock_after_sync",
          card=json.dumps(card), batch=batch, tile=dataset.tile_size,
          n_res_blocks=9, steps=iters, step_ms=f"{1e3 * step_s:.3f}",
          samples_per_s=f"{batch / step_s:.2f}",
          peak_memory_gb=(f"{(peak + base) / 1e9:.3f}" if cuda
                          else "not_measured_on_cpu"),
          launches=json.dumps(counts),
          loss_D=f"{rows[-1][0]:.4f}", D_fake=f"{rows[-1][4]:.3e}")
    return {"step_ms": 1e3 * step_s, "samples_per_s": batch / step_s,
            "peak_bytes": peak + base if cuda else None, "launches": counts,
            "batch": batch}


def _cgan_grads(trainer) -> dict:
    """Each network's gradients of the last step, by flax path, as f64
    tensors."""
    from baryon_painter_tpu_torch.convert import to_jax_variables
    out = {}
    for net, model in (("g", trainer.generator),
                       ("d", trainer.discriminator)):
        tree = to_jax_variables(model, value=lambda p: p.grad.double())
        out[net] = _flat_tree(tree["params"])
    return out


def _flat_tree(tree, prefix="") -> dict:
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat_tree(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v, np.float64)
    return out


def _cgan_stats(trainer) -> dict:
    from baryon_painter_tpu_torch.convert import to_jax_variables
    return {net: _flat_tree(to_jax_variables(model)["batch_stats"])
            for net, model in (("g", trainer.generator),
                               ("d", trainer.discriminator))}


def cgan_f64_errors(f32, f64, m32: dict, m64: dict) -> dict:
    """21b's readings: each loss's relative difference and each mean
    probability's in its logarithm (CGAN_F64_RTOL's note), each gradient
    leaf's (``step_grad_errors``' scaling with the analytically zero leaves
    under the network's largest entry) and each running-state leaf's
    relative to its own largest entry; f64 is the reference."""
    from baryon_painter_tpu_torch.train.cgan import zero_gradient_leaves
    rel = lambda k: abs(float(m32[k]) - float(m64[k])) / abs(float(m64[k]))
    metrics = {k: rel(k) for k in ("loss_D", "loss_G_adv",
                                   "loss_G_perceptual")}
    for k in ("D_real", "D_fake"):
        want = np.log(float(m64[k]))
        metrics[k] = abs(np.log(float(m32[k])) - want) / abs(want)
    g32, g64 = _cgan_grads(f32), _cgan_grads(f64)
    zero = set(zero_gradient_leaves(f64.generator))
    grads = {}
    for net in ("g", "d"):
        top = max(np.abs(v).max() for v in g64[net].values())
        for k, want in g64[net].items():
            scale = top if k in zero else np.abs(want).max()
            grads[f"{net}/{k}"] = float(np.abs(g32[net][k] - want).max()
                                        / scale)
    s32, s64 = _cgan_stats(f32), _cgan_stats(f64)
    stats = {f"{net}/{k}": float(np.abs(s32[net][k] - want).max()
                                 / max(np.abs(want).max(), 1e-30))
             for net in ("g", "d") for k, want in s64[net].items()}
    # printed, not held: the mean probabilities' own relative distance
    probs = {k: rel(k) for k in ("D_real", "D_fake")}
    return {"metrics": metrics, "grads": grads, "stats": stats,
            "probabilities_rel": probs}


def cgan_parity(device, dataset, batch: int = CGAN_BATCH) -> dict:
    """Phase 21b: the f32 step against the same step with both networks in
    f64 (the batch and the state the same; the first whole-model f64
    reference of a training step), from the committed fiducial-adv state
    and again after ``reinit_discriminator(7)`` (a fresh D against a
    trained G: the other regime of the game); held to CGAN_F64_RTOL and
    STEP_GRAD_TOL (``cgan_f64_errors``). Then a step with K2 against a
    step with the plain gather (``use_kernel=False``) from the same state,
    under cuDNN's deterministic algorithms: every metric and the whole
    state after it equal bit for bit."""
    t0 = time.perf_counter()
    device = torch.device(device)
    idx = _cgan_idx(dataset, batch)
    regimes = {}
    for regime in ("committed", "reinit_d"):
        runs = {}
        for label, dtype in (("f32", None), ("f64", torch.float64)):
            tr = _cgan_trainer(device, dataset, dtype=dtype,
                               batch_size=batch)
            if regime == "reinit_d":
                tr.reinit_discriminator(7)
            runs[label] = (tr, tr.step_indices(idx, CGAN_LOOP_LR))
        errs = cgan_f64_errors(runs["f32"][0], runs["f64"][0],
                               runs["f32"][1], runs["f64"][1])
        held = ("metrics", "grads", "stats")
        worst = {k: max(errs[k], key=errs[k].get) for k in held}
        reading = {k: (worst[k], errs[k][worst[k]]) for k in held}
        regimes[regime] = {"errors": errs, "worst": reading,
                           "D_fake": float(runs["f64"][1]["D_fake"])}
        del runs
        print(f"  21b {regime}: worst metric {reading['metrics']}, "
              f"gradient {reading['grads']}, state {reading['stats']}; "
              f"D_fake {regimes[regime]['D_fake']:.3e}, the mean "
              f"probabilities' relative distance "
              f"{errs['probabilities_rel']}", flush=True)
        if not (reading["metrics"][1] <= CGAN_F64_RTOL
                and reading["grads"][1] <= STEP_GRAD_TOL
                and reading["stats"][1] <= CGAN_F64_RTOL):
            raise AssertionError(f"cgan f32 step against f64 ({regime}): "
                                 f"{reading}")
    with _cudnn_algorithms(True):
        pair = {}
        for label, use_kernel in (("k2", "auto"), ("plain", False)):
            tr = _cgan_trainer(device, dataset, use_kernel=use_kernel,
                               batch_size=batch)
            pair[label] = (tr, tr.step_indices(idx, CGAN_LOOP_LR))
    (tk, mk), (tp, mp) = pair["k2"], pair["plain"]
    equal = (all(torch.equal(mk[k], mp[k]) for k in mk)
             and state_distance_gan(tk, tp) == 0)
    del pair
    if not equal:
        raise AssertionError("cgan: the K2 step and the plain-gather step "
                             "differ")
    _line("21b", "cgan_parity", t0, batch=batch,
          **{f"{r}_worst_{k}": f"{v[0]}:{v[1]:.3e}"
             for r, res in regimes.items() for k, v in res["worst"].items()},
          k2_vs_plain_gather_equal=equal)
    return {"regimes": regimes, "k2_vs_plain_equal": equal}


CGAN_MODES = {
    "feature_matching": {"feature_matching": True},
    "calibration": {"adversarial_weight": 0.0},
    "freeze_bn_stats": {"freeze_bn_stats": True},
    "pk_per_z": {"pk_loss_weight": CGAN_PK_WEIGHT, "pk_loss_per_z": True},
    "reinit_d": {},
}


def cgan_modes(device, dataset, batch: int = CGAN_BATCH) -> dict:
    """Phase 21c: one step from the committed fiducial-adv state in each
    mode that changes the step's graph (``CGAN_MODES``; ``reinit_d`` the
    default step after ``reinit_discriminator(7)``), each with finite
    losses; calibration moves none of D's parameters and state and none of
    G's state, ``freeze_bn_stats`` none of G's state (D's moves)."""
    t0 = time.perf_counter()
    idx = _cgan_idx(dataset, batch)
    out = {}
    for mode, config in CGAN_MODES.items():
        tr = _cgan_trainer(device, dataset, batch_size=batch, **config)
        if mode == "reinit_d":
            tr.reinit_discriminator(7)
        before = {net: {k: v.clone() for k, v in m.state_dict().items()}
                  for net, m in (("g", tr.generator),
                                 ("d", tr.discriminator))}
        m = tr.step_indices(idx, CGAN_LOOP_LR)
        after = {"g": tr.generator.state_dict(),
                 "d": tr.discriminator.state_dict()}
        buffers = {"g": {n for n, _ in tr.generator.named_buffers()},
                   "d": {n for n, _ in tr.discriminator.named_buffers()}}
        moved = {f"{net}_{kind}": any(
            not torch.equal(before[net][k], after[net][k])
            for k in before[net] if (k in buffers[net]) == (kind == "state"))
            for net in ("g", "d") for kind in ("params", "state")}
        row = dict(zip(("loss_D", "loss_G_adv", "loss_G_perceptual",
                        "D_real", "D_fake"), tr.stats_tuple(m)))
        row["pk_loss"] = float(m["pk_loss"])
        out[mode] = {"metrics": row, "moved": moved}
        print(f"  21c {mode}: " + " ".join(
            f"{k}={v:.4e}" for k, v in row.items()) + f" moved={moved}",
            flush=True)
        del tr
        ok = all(np.isfinite(v) for v in row.values())
        if mode == "calibration":
            ok = ok and not (moved["d_params"] or moved["d_state"]
                             or moved["g_state"]) and moved["g_params"]
        if mode == "freeze_bn_stats":
            ok = ok and not moved["g_state"] and moved["d_state"]
        if mode == "pk_per_z":
            ok = ok and row["pk_loss"] > 0
        if not ok:
            raise AssertionError(f"cgan mode {mode}: {out[mode]}")
    _line("21c", "cgan_modes", t0, modes=",".join(out))
    return out


def cgan_train_loop(device, dataset, batch: int = CGAN_BATCH,
                    pepoch: int = CGAN_LOOP_PEPOCH,
                    validation: int = CGAN_LOOP_VALIDATION,
                    card=None) -> dict:
    """Phase 21d, a main path: ``train()`` through the CGAN training CLI's
    code (scripts/train_cgan_torch.py: ``parse_args``, ``build``, ``run``)
    from the committed fiducial-adv state (``--resume-from``; it holds no
    loop progress, so the run starts at sample 0), on phase 5's stacks with
    a held-out stack as the test data, under cuDNN's deterministic
    algorithms: CGAN_LOOP_PEPOCHS pepochs of ``pepoch`` samples at
    ``batch``, validation every ``validation`` samples, a checkpoint
    every pepoch; timed (host clock, synchronised), exactly one K2 launch a
    step; the same steps through ``step_indices`` on a trainer from the
    same state, timed; then ``run(--resume-from`` the first checkpoint``)``
    into a copy of it and the statistics files: the final state (both
    networks, their states and Adams), both statistics files and the final
    checkpoint's bytes (loop progress and data RNG too), equal to the
    uninterrupted run's bit for bit. Returns the final trainer and
    checkpoint for 21e."""
    t0 = time.perf_counter()
    device = torch.device(device)
    cuda = device.type == "cuda"
    twin = _load_cli(TRAIN_CGAN_CLI)
    datasets = (dataset, held_out_data(dataset))
    n_samples = CGAN_LOOP_PEPOCHS * pepoch
    n_steps = n_samples // batch
    n_evals = n_samples // validation
    tmp = tempfile.TemporaryDirectory()
    root = Path(tmp.name)

    def argv(out, resume_from):
        return ["--output-path", str(root / out), "--n-pepoch",
                str(CGAN_LOOP_PEPOCHS), "--pepoch-size", str(pepoch),
                "--batch-size", str(batch), "--learning-rate",
                str(CGAN_LOOP_LR), "--checkpoint-frequency", str(pepoch),
                "--validation-loss-frequency", str(validation),
                "--validation-loss-batch-size", str(batch),
                "--device-data", "--device", str(device), "--resume-from",
                str(resume_from)]

    with _cudnn_algorithms(True):
        warm = twin.build(twin.parse_args(argv("warm", REPO / CGAN_ADV_PATH)),
                          datasets)
        warm.step_indices(_cgan_idx(dataset, batch), CGAN_LOOP_LR)
        warm.eval_loss(datasets[1].get_raw_batch(np.arange(batch)))
        del warm
        plan = []
        scan = None

        def recording(trainer):
            nonlocal scan
            scan = trainer.step_scan

            def step_scan(idx, lr):
                plan.append((idx, lr))
                return scan(idx, lr)
            trainer.step_scan = step_scan

        build = twin.build

        def build_recording(args, data=None):
            trainer = build(args, data)
            recording(trainer)
            return trainer

        twin.build = build_recording
        _reset_launches()
        _sync(device)
        try:
            full = twin.run(argv("full", REPO / CGAN_ADV_PATH), datasets)
        finally:
            twin.build = build
        _sync(device)
        train_s = full["seconds"]
        counts = _launches()
        trainer = full["trainer"]
        tstats, vstats = full["training_stats"], full["validation_stats"]
        _expect_launches("cgan_train_loop", counts,
                         {"k2": n_steps} if cuda else {})
        if (tstats.n_batches != n_steps or vstats.n_batches != n_evals
                or sum(len(i) for i, _ in plan) != n_steps
                or not np.isfinite(tstats.loss_terms["loss_D"]["all"]).all()):
            raise AssertionError(
                f"cgan_train_loop: {tstats.n_batches} training and "
                f"{vstats.n_batches} validation rows, expected {n_steps} "
                f"and {n_evals}")
        replay = twin.build(twin.parse_args(argv("replay",
                                                 REPO / CGAN_ADV_PATH)),
                            datasets)
        replay.restore(str(REPO / CGAN_ADV_PATH))
        _sync(device)
        t = time.perf_counter()
        for idx, lr in plan:
            for row in idx:
                replay.step_indices(row, lr)
        _sync(device)
        replay_s = time.perf_counter() - t
        replay_distance = state_distance_gan(replay, trainer)
        del replay
        first = f"checkpoint_sample{pepoch:0>10}"
        (root / "resumed").mkdir()
        for f in os.listdir(root / "full"):
            if f.startswith(first) or f.endswith(".txt"):
                (root / "resumed" / f).write_bytes(
                    (root / "full" / f).read_bytes())
        res = twin.run(argv("resumed", root / "resumed" / first), datasets)
        resumed = state_distance_gan(res["trainer"], trainer)
        del res
    stats_equal = all((root / "resumed" / f).read_bytes()
                      == (root / "full" / f).read_bytes()
                      for f in ("training_stats.txt", "validation_stats.txt",
                                "model_state.msgpack"))
    if resumed != 0 or not stats_equal:
        raise AssertionError(
            f"cgan_train_loop: the resumed run lies {resumed:.3e} from the "
            f"uninterrupted one; statistics files equal: {stats_equal}")
    _line("21d", "cgan_train_loop", t0, clock="host_clock_after_sync",
          card=json.dumps(card), cudnn="deterministic", steps=n_steps,
          evals=n_evals, train_s=f"{train_s:.3f}",
          train_samples_per_s=f"{n_samples / train_s:.2f}",
          step_indices_s=f"{replay_s:.3f}",
          step_indices_samples_per_s=f"{n_samples / replay_s:.2f}",
          loop_cost_pct=f"{100 * (train_s / replay_s - 1):.2f}",
          launches=json.dumps(counts),
          replay_distance=f"{replay_distance:.3e}", resumed_from=first,
          resumed_distance=f"{resumed:.3e}", stats_files_equal=stats_equal,
          loss_D_mavg_last=f"{tstats.loss_terms['loss_D']['mavg'][-1]:.4f}")
    return {"launches": counts, "steps": n_steps, "evals": n_evals,
            "train_s": train_s, "samples_per_s": n_samples / train_s,
            "step_indices_samples_per_s": n_samples / replay_s,
            "replay_distance": replay_distance, "resumed_distance": resumed,
            "stats_files_equal": stats_equal, "trainer": trainer,
            "model": str(root / "full" / "model"), "tmp": tmp}


_GAN_MODEL_STATE = ("g_params", "g_stats", "g_opt", "d_params", "d_stats",
                    "d_opt", "step")


def state_distance_gan(a, b) -> float:
    """max |a - b| over two CGAN trainers' model state (both networks,
    their states, Adams and the step)."""
    pick = lambda t: {k: t[k] for k in _GAN_MODEL_STATE}
    la = _flat_tree(pick(a.state_tree()))
    lb = _flat_tree(pick(b.state_tree()))
    if la.keys() != lb.keys():
        raise AssertionError(f"state trees differ in keys: "
                             f"{sorted(set(la) ^ set(lb))[:5]}")
    return max(float(np.abs(la[k] - lb[k]).max(initial=0.0)) for k in la)


def cgan_from_trainer(device, loop: dict,
                      n_tiles: int = CGAN_PAINT_TILES) -> dict:
    """Phase 21e: ``CGANPainter.from_trainer(trainer,
    fused_inference=True)`` on 21d's final trainer, ``n_tiles`` tiles in one
    call: exactly 9 K1 launches on the card; held to the same trainer's
    unfused paint with cuDNN off at the golden tolerance, and equal to
    ``load_painter`` on 21d's final checkpoint (both under cuDNN's
    deterministic algorithms)."""
    from baryon_painter_tpu_torch.painter import CGANPainter, load_painter
    t0 = time.perf_counter()
    device = torch.device(device)
    trainer = loop["trainer"]
    tile = trainer.training_data.tile_size
    tiles = golden_inputs(tile, n_tiles)
    zs = np.linspace(0.0, 1.0, n_tiles).astype(np.float32)
    fused = CGANPainter.from_trainer(trainer, fused_inference=True)
    loaded = load_painter(loop["model"], fused_inference=True, device=device)
    # cuDNN's default algorithms may differ from call to call; the
    # comparison with load_painter's paint is bit for bit
    with _cudnn_algorithms(True):
        _reset_launches()
        painted = fused.paint_batch(tiles, zs)
        _sync(device)
        counts = _launches()
        loaded = loaded.paint_batch(tiles, zs)
    _expect_launches("cgan from_trainer paint", counts,
                     {"k1": 9} if device.type == "cuda" else {})
    with _cudnn(False):
        plain = CGANPainter.from_trainer(trainer).paint_batch(tiles, zs)
    ratio = _golden_ratio(painted, plain)
    equal = bool(torch.equal(loaded, painted))
    finite = bool(torch.isfinite(painted).all())
    if not (ratio <= 1.0 and equal and finite):
        raise AssertionError(f"cgan from_trainer: {ratio:.4f} of the golden "
                             f"tolerance from the unfused paint, "
                             f"load_painter equal {equal}, finite {finite}")
    _line("21e", "cgan_from_trainer", t0, tiles=n_tiles,
          launches=json.dumps(counts), vs_unfused_ratio=f"{ratio:.4f}",
          load_painter_equal=equal)
    return {"launches": counts, "ratio": ratio, "load_painter_equal": equal}


# 21f: the gate twin's CGAN training leg, short
CGAN_GATE_ARGS = ("--model", "cgan", "--n-samples", "48", "--batch", "24",
                  "--adv-weight", "1", "--pk-loss-weight", "1e4",
                  "--freeze-bn")


def cgan_gate_leg(device, gate_run: dict, args=CGAN_GATE_ARGS,
                  card=None) -> dict:
    """Phase 21f: the gate twin's CGAN training leg
    (``scripts/fidelity_check_torch.py --model cgan --resume``, ``args``)
    from a copy of fiducial-adv, on phase 20b's fiducial-adv datasets (its
    stacks and cached truth spectra, so the gate's set-up is not paid
    again): it trains (K2 one launch a step), paints through
    ``CGANPainter.from_trainer`` and K1 (9 launches a paint call) and
    prints its JSON line, whose readings must be finite."""
    import io
    spread = _load_cli(SPREAD_CLI)
    gate = spread.gate
    t0 = time.perf_counter()
    device = torch.device(device)
    base = REPO / CGAN_ADV_PATH
    with tempfile.TemporaryDirectory() as tmp:
        ckpt_base = Path(tmp) / "fiducial-adv"
        for suffix in ("_state.msgpack", "_meta.json"):
            (Path(tmp) / f"fiducial-adv{suffix}").write_bytes(
                Path(f"{base}{suffix}").read_bytes())
        argv = (spread.dataset_flags(str(base)) + list(args)
                + ["--resume", "--checkpoint", str(ckpt_base), "--workdir",
                   tmp, "--device", str(device)])
        _reset_launches()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            report = gate.main(argv, data=gate_run["cgan_adv"]["data"])
        _sync(device)
        counts = _launches()
    line = out.getvalue().strip().splitlines()[-1]
    print(line, flush=True)
    n = int(args[list(args).index("--n-samples") + 1])
    steps = n // int(args[list(args).index("--batch") + 1])
    values = [v for d in report["per_z_by_dtype"].values()
              for r in d.values() for v in r.values()]
    cuda = device.type == "cuda"
    ok = (json.loads(line) == report and all(np.isfinite(values))
          and counts["k2"] == (steps if cuda else 0)
          and counts["k1"] % 9 == 0 and (counts["k1"] > 0) == cuda
          and all(v == 0 for k, v in counts.items()
                  if k not in ("k1", "k2")))
    if not ok:
        raise AssertionError(f"cgan gate leg: launches {counts}, report "
                             f"{report}")
    _line("21f", "cgan_gate_leg", t0, card=json.dumps(card), steps=steps,
          launches=json.dumps(counts), paint_calls=counts["k1"] // 9,
          pass_5pct=report["pass_5pct"])
    return {"launches": counts, "report": report, "steps": steps}


def cgan_train(device, dataset, gate_run: dict, card=None,
               batch: int = CGAN_BATCH, step_iters: int = 5,
               loop: dict = None, paint_tiles: int = CGAN_PAINT_TILES,
               gate_args=CGAN_GATE_ARGS) -> dict:
    """Phase 21: CGAN training at full width from fiducial-adv (21a the
    step, 21b f32 against f64 and K2 against the plain gather, 21c the
    modes, 21d the run and its resume, 21e ``from_trainer``'s paint, 21f
    the gate twin's training leg); ``loop`` takes ``cgan_train_loop``'s
    ``pepoch`` and ``validation``."""
    out = {"step": cgan_step(device, dataset, batch=batch, iters=step_iters,
                             card=card),
           "parity": cgan_parity(device, dataset, batch=batch),
           "modes": cgan_modes(device, dataset, batch=batch)}
    run = cgan_train_loop(device, dataset, batch=batch, card=card,
                          **(loop or {}))
    try:
        out["paint"] = cgan_from_trainer(device, run, n_tiles=paint_tiles)
    finally:
        run.pop("tmp").cleanup()
    run.pop("trainer")
    out["loop"] = run
    out["gate"] = cgan_gate_leg(device, gate_run, args=gate_args, card=card)
    return out


# ---------------------------------------------------------------------- #
# Phase 22: the run tooling (profile, validate's figures, the stats twin,
# the reference-parity batches)

STATS_CLI = REPO / "scripts" / "compare_reference_stats_torch.py"
# 22a: the training twin with --profile, 2 pepochs of 48 samples
PROFILE_PEPOCH = 48
PROFILE_PEPOCHS = 2
# the kernels' symbols in a trace (csrc/*.cu)
TRACE_KERNELS = {"k2": "gather_tiles_kernel", "k3_fwd": "head_fwd_kernel",
                 "k3_bwd": "head_bwd_kernel"}
# 22b: the test batch of validate (the JAX CLI's validation_batch_size)
VALIDATE_BATCH = 8
# the P(k) fractional errors of one painted batch, card against CPU:
# max|card - cpu| / max|cpu|
VALIDATE_PK_RTOL = 1e-5
# 22c: the committed run whose shape phase 19's run is printed against
REFERENCE_STATS = "trained_models/CVAE/fiducial-512/training_stats.txt"
# 22d: the batches of BatchLoader(raw=False) compared with get_batch
LOADER_BATCHES = 2
LOADER_BATCH = 4


def _have_matplotlib() -> bool:
    from baryon_painter_tpu_torch.utils.validation_plotting import \
        require_matplotlib
    try:
        require_matplotlib()
        return True
    except ImportError:
        return False


def profile_run(device, dataset, batch: int = TRAIN_BATCH,
                pepoch: int = PROFILE_PEPOCH, pepochs: int = PROFILE_PEPOCHS,
                n_res_blocks: int = N_RES_BLOCKS, card=None) -> dict:
    """22a: ``scripts/train_cvae_torch.py``'s ``run`` at full width with
    K2 and K3 (``BPT_FUSED_HEADS=1``), ``pepochs`` pepochs of ``pepoch``
    samples at ``batch``, validation every ``pepoch`` samples, once with
    ``--profile`` and once without (after a warm-up run). The trace's
    device kernels counted by name (``TRACE_KERNELS``) must equal the
    wrappers' counts, which must be one K2 and one K3-bwd launch a step
    and one K3-fwd a step and a validation loss (or figure). Prints the
    trace's size and the profiler's cost on this short run: the whole
    block's seconds traced over untraced (the profiler's stop and the
    trace's export included); beside it both runs' samples/s over
    ``train()`` alone (host clock), which a few steps cannot resolve."""
    from baryon_painter_tpu_torch.models.cvae import (
        fiducial_cvae_architecture)
    from baryon_painter_tpu_torch.train.run_config import RunConfig
    t0 = time.perf_counter()
    device = torch.device(device)
    cuda = device.type == "cuda"
    twin = _load_cli(TRAIN_CLI)
    datasets = (dataset, held_out_data(dataset))
    n_samples = pepochs * pepoch
    n_steps = n_samples // batch
    run = dict(LOOP_RUN, validation_loss_frequency=pepoch,
               statistics_report_frequency=pepoch,
               checkpoint_frequency=n_samples)
    n_evals = n_samples // pepoch
    out = {}
    with tempfile.TemporaryDirectory() as tmp, _fused_heads_env(True):
        root = Path(tmp)
        config = root / "run_config.json"
        RunConfig(architecture=fiducial_cvae_architecture(
                      dataset.tile_size, n_res_blocks=n_res_blocks),
                  transforms={f: t.to_dict()
                              for f, t in dataset.transforms.items()},
                  schedules={"batch_size_schedule": {"kind": "constant",
                                                     "value": batch}},
                  train=run).save(str(config))
        argv = lambda name, *extra: [
            "--output-path", str(root / name), "--config", str(config),
            "--n-pepoch", str(pepochs), "--pepoch-size", str(pepoch),
            "--learning-rate", str(LOOP_LR), "--device-data", "--device",
            str(device), *extra]
        twin.run(argv("warm"), datasets)
        for label, extra in (("traced", ("--profile", str(root / "trace"))),
                             ("untraced", ())):
            _sync(device)
            _reset_launches()
            res = twin.run(argv(label, *extra), datasets)
            _sync(device)
            out[label] = {"launches": _launches(),
                          "samples_per_s": n_samples / res["seconds"],
                          "block_s": res["block_seconds"],
                          "trace": res["trace"]}
        trace = out["traced"]["trace"]
        trace_bytes = os.path.getsize(trace)
        by_name = profiling.trace_kernel_counts(trace,
                                                TRACE_KERNELS.values())
    counts = out["traced"]["launches"]
    figures = n_evals if _have_matplotlib() else 0
    want = {"k2": n_steps, "k3_fwd": n_steps + n_evals + figures,
            "k3_bwd": n_steps} if cuda else {}
    _expect_launches("profile_run", counts, want)
    traced = {k: by_name[v] for k, v in TRACE_KERNELS.items()}
    if cuda and traced != {k: counts[k] for k in TRACE_KERNELS}:
        raise AssertionError(f"profile_run: the trace counts {traced}, the "
                             f"wrappers {counts}")
    per_step = {k: (v - (n_evals + figures if k == "k3_fwd" else 0))
                / n_steps for k, v in traced.items()}
    cost = out["traced"]["block_s"] / out["untraced"]["block_s"]
    _line("22a", "profile_run", t0, card=json.dumps(card), steps=n_steps,
          evals=n_evals, figures=figures, launches=json.dumps(counts),
          trace_kernels=json.dumps(traced),
          trace_per_step=json.dumps(per_step), trace_bytes=trace_bytes,
          samples_per_s_traced=f"{out['traced']['samples_per_s']:.2f}",
          samples_per_s_untraced=f"{out['untraced']['samples_per_s']:.2f}",
          traced_block_s=f"{out['traced']['block_s']:.3f}",
          untraced_block_s=f"{out['untraced']['block_s']:.3f}",
          profiler_cost_x=f"{cost:.3f}")
    return {"launches": counts, "trace_kernels": traced,
            "trace_per_step": per_step, "trace_bytes": trace_bytes,
            "steps": n_steps, "evals": n_evals, "figures": figures,
            "samples_per_s": {k: v["samples_per_s"] for k, v in out.items()},
            "block_s": {k: v["block_s"] for k, v in out.items()},
            "profiler_cost": cost}


def _pk_errors_card_cpu(sample: dict, ds, device) -> dict:
    """The P(k) fractional errors (auto, cross) of a painted test batch
    (``validation_sample``'s) computed on ``device`` and on the CPU, and
    max|device - cpu| / max|cpu| of each."""
    from baryon_painter_tpu_torch.utils.validation_plotting import \
        power_spectrum_fractional_error
    inv = [ds.get_inverse_transforms(z=float(z)) for z in sample["z"]]
    out = {}
    for mode in ("auto", "cross"):
        devs = {}
        for dev in (device, torch.device("cpu")):
            move = lambda t: t.to(dev)
            devs[dev.type] = power_spectrum_fractional_error(
                move(sample["x"]), move(sample["pred"]), move(sample["y"]),
                ds.tile_L, mode=mode,
                output_inverse_transforms=[t[1:] for t in inv],
                input_inverse_transforms=[t[0] for t in inv],
                device=dev)[1]
        cpu = devs["cpu"]
        out[mode] = float(np.abs(devs[device.type] - cpu).max()
                          / np.abs(cpu).max())
    return out


def validate_figures(device, dataset, batch: int = VALIDATE_BATCH,
                     card=None) -> dict:
    """22b: ``validate`` on the CVAE trainer (K3 heads, the committed
    fiducial weights: an untrained decoder paints a near-constant field)
    and on the CGAN trainer (fiducial-adv; spectral norm keeps K1 off),
    both on 512^2 held-out stacks. With matplotlib: the figures of one
    call (the JAX CLI's: sample with variance, auto and cross P(k), log
    histogram), saved, each file not empty, the call timed. Without: the
    call raises an ImportError naming matplotlib, and the line says so.
    Either way ``validation_sample``'s painted batch (one K3-fwd launch a
    CVAE call on the card, as a ``validate`` call makes) and its P(k)
    fractional errors on the card against the CPU's, within
    VALIDATE_PK_RTOL."""
    t0 = time.perf_counter()
    device = torch.device(device)
    cuda = device.type == "cuda"
    test = held_out_data(dataset)
    mpl = _have_matplotlib()
    cvae = make_trainer(device, dataset, True, variables=_fiducial_variables())
    cvae.test_data = test
    gan = _cgan_trainer(device, dataset, test_data=test)
    out, fails = {}, []
    with tempfile.TemporaryDirectory() as tmp:
        for label, trainer, kw, want in (
                ("cvae", cvae, dict(plot_sample_var=True,
                                    plot_power_spectra=["auto", "cross"],
                                    plot_histogram=["log"]),
                 {"k3_fwd": 1}),
                ("cgan", gan, dict(plot_power_spectra=["auto", "cross"],
                                   plot_histogram=["log"]), {})):
            r = {}
            if mpl:
                import matplotlib.pyplot as plt
                template = os.path.join(tmp, f"{label}_{{plot_type}}.png")
                _sync(device)
                _reset_launches()
                t = time.perf_counter()
                figs = trainer.validate(validation_batch_size=batch,
                                        save_plots=True,
                                        filename_template=template, **kw)
                _sync(device)
                r["validate_s"] = time.perf_counter() - t
                r["validate_launches"] = _launches()
                _expect_launches(f"validate {label}", r["validate_launches"],
                                 want if cuda else {})
                r["figures"] = sorted(figs)
                sizes = {k: os.path.getsize(template.format(plot_type=k))
                         for k in figs}
                r["figure_bytes"] = sizes
                for fig in figs.values():
                    plt.close(fig)
                if not all(sizes.values()):
                    fails.append((label, "empty figure", sizes))
            else:
                try:
                    trainer.validate(validation_batch_size=batch, **kw)
                    fails.append((label, "validate drew without matplotlib"))
                except ImportError as e:
                    if "matplotlib" not in str(e):
                        raise
            _sync(device)
            _reset_launches()
            t = time.perf_counter()
            sample = trainer.validation_sample(batch, **(
                {"return_var": True} if label == "cvae" else {}))
            _sync(device)
            r["sample_s"] = time.perf_counter() - t
            r["sample_launches"] = _launches()
            _expect_launches(f"validation_sample {label}",
                             r["sample_launches"], want if cuda else {})
            r["pk_card_vs_cpu"] = _pk_errors_card_cpu(sample, test, device)
            worst = max(r["pk_card_vs_cpu"].values())
            if not (np.isfinite(worst) and worst <= VALIDATE_PK_RTOL):
                fails.append((label, "pk card vs cpu", r["pk_card_vs_cpu"]))
            out[label] = r
            _line("22b", f"validate_{label}", t0, card=json.dumps(card),
                  matplotlib=mpl,
                  figures=("not drawn: matplotlib is not installed" if not mpl
                           else json.dumps(r["figure_bytes"])),
                  validate_s=(f"{r['validate_s']:.3f}" if mpl
                              else "not measured"),
                  sample_s=f"{r['sample_s']:.3f}",
                  launches=json.dumps(r["sample_launches"]),
                  pk_card_vs_cpu=json.dumps(
                      {k: f"{v:.3e}" for k, v in r["pk_card_vs_cpu"].items()}),
                  limit=VALIDATE_PK_RTOL)
    del cvae, gan
    if fails:
        raise AssertionError(f"validate_figures: {fails}")
    out["matplotlib"] = mpl
    return out


def stats_twin(train_loop: dict, card=None) -> dict:
    """22c: ``scripts/compare_reference_stats_torch.py`` on phase 19c's
    statistics: in absolute mode the resumed run's ``training_stats.txt``
    against the uninterrupted run's (cuDNN deterministic) must read a
    maximum deviation of exactly 0, and the CLI exit 0 at ``--band 0``;
    in shape mode the uninterrupted run against the committed fiducial
    run's log (``REFERENCE_STATS``), printed with no band (other data: a
    number, not a gate)."""
    t0 = time.perf_counter()
    cli = _load_cli(STATS_CLI)
    with tempfile.TemporaryDirectory() as tmp:
        paths = {}
        for name, data in train_loop["stats_files"].items():
            paths[name] = os.path.join(tmp, f"{name}_training_stats.txt")
            with open(paths[name], "wb") as f:
                f.write(data)
        absolute_out = os.path.join(tmp, "absolute.json")
        with contextlib.redirect_stdout(open(os.devnull, "w")):
            rc = cli.main(["--reference", paths["uninterrupted"], "--ours",
                           paths["resumed"], "--mode", "absolute",
                           "--band", "0", "--out", absolute_out])
            shape = cli.main(["--reference", str(REPO / REFERENCE_STATS),
                              "--ours", paths["uninterrupted"],
                              "--out", os.path.join(tmp, "shape.json")])
        with open(absolute_out) as f:
            absolute = json.load(f)
        with open(os.path.join(tmp, "shape.json")) as f:
            shape_report = json.load(f)
    if rc != 0 or absolute["max_deviation"] != 0.0 or shape != 0:
        raise AssertionError(f"stats twin: exit {rc}, absolute max deviation "
                             f"{absolute['max_deviation']}")
    _line("22c", "stats_twin", t0,
          absolute_max_deviation=repr(absolute["max_deviation"]),
          absolute_exit=rc,
          shape_max_deviation=f"{shape_report['max_deviation']:.4f}",
          shape_final_deviation=f"{shape_report['final_deviation']:.4f}",
          shape_overlap=json.dumps(shape_report["overlap"]),
          reference=REFERENCE_STATS)
    return {"absolute_max_deviation": absolute["max_deviation"],
            "shape_max_deviation": shape_report["max_deviation"],
            "shape_final_deviation": shape_report["final_deviation"]}


def loader_batches(dataset, n: int = LOADER_BATCHES,
                   batch: int = LOADER_BATCH, seed: int = 7) -> dict:
    """22d: ``BatchLoader(raw=False)`` on the 512^2 synthetic stacks: its
    first ``n`` batches equal ``get_batch`` for the same index draws."""
    from baryon_painter_tpu_torch.data.dataset import BatchLoader
    t0 = time.perf_counter()
    loader = BatchLoader(dataset, batch, seed=seed, raw=False)
    try:
        got = [next(loader) for _ in range(n)]
    finally:
        loader.close()
    rng = np.random.default_rng(seed)
    want = [dataset.get_batch(idx=dataset.sample_indices(rng, batch))
            for _ in range(n)]
    equal = all(np.array_equal(g[0], w[0]) and np.array_equal(g[1], w[1])
                and np.array_equal(g[2], w[2]) for g, w in zip(got, want))
    shape = tuple(got[0][0].shape)
    if not equal:
        raise AssertionError("BatchLoader(raw=False) differs from get_batch")
    _line("22d", "loader_batches", t0, batches=n, batch=batch,
          shape=json.dumps(shape), equal=equal)
    return {"equal": equal, "shape": shape}


def tooling(device, dataset, train_loop: dict, card=None) -> dict:
    """Phase 22: 22a ``profile_run``, 22b ``validate_figures``, 22c
    ``stats_twin``, 22d ``loader_batches``."""
    return {"profile": profile_run(device, dataset, card=card),
            "validate": validate_figures(device, dataset, card=card),
            "stats": stats_twin(train_loop, card=card),
            "loader": loader_batches(dataset)}


def _add_tooling_launches(entries: list, tooling: dict):
    """Phase 22's launches on the f32 entries of K2 and K3: 22a's profiled
    run (the wrappers' counts, the trace's beside) and 22b's CVAE
    ``validation_sample`` call (K3-fwd)."""
    prof = tooling["profile"]
    for entry in entries:
        if entry["dtype"] != "float32":
            continue
        for key, name in (("k2", "gather_tiles"), ("k3_fwd", "head_stack_fwd"),
                          ("k3_bwd", "head_stack_bwd")):
            if entry["name"] == name:
                entry["profile_run_launches"] = prof["launches"][key]
                entry["profile_trace_launches"] = prof["trace_kernels"][key]
        if entry["name"] == "head_stack_fwd":
            entry["validate_launches"] = tooling["validate"]["cvae"][
                "sample_launches"]["k3_fwd"]


def _add_mesh_launches(entries: list, mesh: dict):
    """Phase 23's launches on the f32 entries: K2, K3 and K4's in one
    step under the one-rank mesh (23a) and on each rank of the two-rank
    mesh (23b); K1's and K3-fwd's in the sharded lightcone (23c)."""
    keys = {"gather_tiles": "k2", "head_stack_fwd": "k3_fwd",
            "head_stack_bwd": "k3_bwd", "res_block_infer": "k1"}
    for entry in entries:
        if entry["dtype"] != "float32":
            continue
        key = keys.get(entry["name"], "k4_" + entry["name"].split("_")[-1])
        if key in mesh["one"]["launches"] and key != "k1":
            entry["mesh_step_launches"] = mesh["one"]["launches"][key]
            entry["mesh_rank_step_launches"] = [
                r["launches"][key] for r in mesh["two"]["ranks"]]
        if key in ("k1", "k3_fwd"):
            entry["mesh_lightcone_launches"] = mesh["paint"]["launches"][key]


def _add_cgan_train_launches(entries: list, cgan_train: dict):
    """Phase 21's launches on the f32 entries of K2 (21a's timed steps,
    21d's run) and K1 (21e's ``from_trainer`` paint call)."""
    for entry in entries:
        if entry["dtype"] != "float32":
            continue
        if entry["name"] == "gather_tiles":
            entry["cgan_step_launches"] = cgan_train["step"]["launches"]["k2"]
            entry["cgan_train_loop_launches"] = cgan_train["loop"][
                "launches"]["k2"]
        if entry["name"] == "res_block_infer":
            entry["cgan_from_trainer_launches"] = cgan_train["paint"][
                "launches"]["k1"]


def _add_gate_launches(entries: list, gate_run: dict, pk: dict):
    """Phase 20's launches on their kernels-record entries: K1's and
    K3-fwd's in one gate paint call (20a's CVAE, 20b's CGAN), K2's and
    K3's in the spectral step's timed steps (20c, f32 and bf16)."""
    for entry in entries:
        name, bf16 = entry["name"], entry["dtype"] == "bfloat16"
        if name == "res_block_infer" and not bf16:
            entry["gate_launches"] = gate_run["cvae"]["launches"]["k1"]
            entry["gate_cgan_launches"] = gate_run["cgan"]["launches"]["k1"]
            entry["gate_cgan_adv_launches"] = gate_run["cgan_adv"][
                "launches"]["k1"]
        if name == "head_stack_fwd" and not bf16:
            entry["gate_launches"] = gate_run["cvae"]["launches"]["k3_fwd"]
        keys = {"gather_tiles": "k2", "head_stack_fwd": "k3_fwd",
                "head_stack_bwd": "k3_bwd"}
        if name in keys:
            run = pk["bfloat16" if bf16 else "float32"]
            group = "bf16_launches" if bf16 and name != "gather_tiles" \
                else "launches"
            entry["pk_step_launches"] = run[group][keys[name]]


def k4_record(conv_bn: dict, training_k4: dict) -> list:
    """K4's four entries of the kernels record, each summed over the four
    sites of phase 10 (10b in bf16; the per-site values are printed there),
    with the launches of phase 11's timed steps (15's bf16 launches). The
    yardstick times the library's
    forward (conv, BatchNorm, ReLU) and its autograd backward; they stand
    on K4-fwd and K4-bwd2, as the pairs stats + fwd and bwd1 + bwd2 compute
    those functions. Each bound is that of the kernels' design
    (``K4_BOUND``: the GEMMs at the 3xTF32 tensor-core rate, fwd bound by
    memory; in bf16 the bf16 rate), the f32 CUDA-core bound beside it in
    f32; K4-stats carries its u's difference from K4-bwd1's."""
    sites = conv_bn["sites"].values()
    dtype = conv_bn.get("dtype", "float32")
    bf16 = dtype == "bfloat16"
    launches = training_k4["bf16_launches" if bf16 else "launches"]
    out = []
    for k in K4_KERNELS:
        # the bound of the kernels' design (K4_BOUND), the f32 CUDA-core
        # one beside it
        bk = K4_BOUND[k]
        peak = (PEAK_FLOPS[torch.float32] if k == "fwd" else
                PEAK_FLOPS[torch.bfloat16] if bf16 else PEAK_3XTF32)
        t_ops = sum(r["bounds"][bk]["flops"] for r in sites) / peak
        t_bytes = sum(r["bounds"][bk]["bytes"] for r in sites) / HBM_BYTES_PER_S
        lib = _K4_LIBRARY.get(k)
        entry = {
            "name": f"conv_bn_{k}", "dtype": dtype, "route": "cuda",
            "source": K4_SOURCE,
            "replaces": K4_REPLACES[k],
            "launches": launches[f"k4_{k}"],
            "max_abs_err": max(r["abs_errors"][e] for r in sites
                               for e in _K4_ERRORS[k]),
            "ms": sum(r["ms"][k] for r in sites),
            "plain_ms": sum(r["plain_ms"][k] for r in sites),
            "bound_ms": sum(r["bounds"][bk]["bound_ms"] for r in sites),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": (sum(r[lib] for r in sites)
                           if lib is not None else None),
            "sites": len(conv_bn["sites"])}
        if lib is not None:
            entry["library_covers"] = ("stats+fwd" if k == "fwd"
                                       else "bwd1+bwd2")
        if k == "stats":
            entry["u_vs_bwd1_max_abs"] = max(r["u_stats_vs_bwd1"]
                                             for r in sites)
        if not bf16:
            entry["bound_ms_f32_cuda_cores"] = sum(
                r["bounds"][k]["bound_ms"] for r in sites)
        out.append(entry)
    return out


def _add_lightcone_launches(entries: list, lightcone: dict):
    """Phase 16's bf16 launches of K1 and K3-fwd (16c's, and the timed
    run's per shell) on their kernels-record entries."""
    keys = {"res_block_infer": "k1", "head_stack_fwd": "k3_fwd"}
    for entry in entries:
        key = keys.get(entry["name"])
        if key is not None:
            entry["lightcone_launches"] = lightcone["bf16"][
                "bf16_launches"][key]
            entry["lightcone_launches_per_shell"] = [
                s[key] for s in lightcone["timing"]["shells"]]


def _add_cgan(entry: dict, cgan: dict, dtype: str):
    """Phase 17's K1 numbers on a K1 entry of ``dtype``."""
    timing, shape = cgan["timing"], K1_CGAN_SHAPES[1]
    err = max(r["max_abs_err"] for r in cgan["k1"] if r["dtype"] == dtype
              and r["shape"] == list(shape))
    entry.update({
        "cgan_launches": (cgan["goldens"]["launches"] if dtype == "float32"
                          else cgan["bf16"]["bf16_launches"]["k1"]),
        "cgan_shape": list(shape), "cgan_slope": CGAN_SLOPE,
        "cgan_max_abs_err": err, "cgan_ms": timing[f"k1_ms_{dtype}"],
        "cgan_plain_ms": timing[f"plain_ms_{dtype}"],
        "cgan_library_ms": timing[f"library_ms_{dtype}"],
        "cgan_bound_ms": timing[f"bound_{dtype}"]["tc"]["bound_ms"],
        "cgan_bound_by": timing[f"bound_{dtype}"]["tc"]["bound_by"]})
    if dtype == "float32":
        entry["cgan_lightcone_launches"] = cgan["lightcone"]["launches"]["k1"]


def _add_train_loop_launches(entries: list, train_loop: dict):
    """Phase 19's launches on the f32 entries of K1 (19d's paint), K2 and
    K3 (19a's run; K3-fwd's include one per validation loss)."""
    keys = {"res_block_infer": ("paint_launches", "k1"),
            "gather_tiles": ("launches", "k2"),
            "head_stack_fwd": ("launches", "k3_fwd"),
            "head_stack_bwd": ("launches", "k3_bwd")}
    for entry in entries:
        if entry["dtype"] == "float32" and entry["name"] in keys:
            group, key = keys[entry["name"]]
            entry["train_loop_launches"] = train_loop[group][key]


def kernels_record(checks: list, paint: dict, timing: dict, gather: dict,
                   heads: dict, training: dict, conv_bn: dict,
                   training_k4: dict, heads_bf16: dict = None,
                   paint_bf16: dict = None, training_bf16: dict = None,
                   conv_bn_bf16: dict = None,
                   training_bf16_k4: dict = None,
                   lightcone: dict = None, cgan: dict = None,
                   train_loop: dict = None, gate_run: dict = None,
                   pk: dict = None, cgan_train: dict = None,
                   tooling: dict = None, mesh: dict = None) -> dict:
    """The ``{"kernels": [...]}`` record of the run, each entry with its
    ``dtype``: K1 in f32, its bf16 numbers beside it; K2, K3-fwd and K3-bwd
    with their launches in the timed training steps; K4's four kernels
    (``k4_record``); given the bf16 phases, K1 in bf16 with its launches
    in the bf16 paint, K3-fwd and K3-bwd in bf16 with theirs in the bf16
    training steps, and K4's four kernels in bf16 (phase 10b) with their
    bf16 launches in phase 15's steps. K1 and K3 run on the tensor cores:
    their bound is the
    tensor-core one (``k1_bound``'s ``tc``, ``k3_bounds``' ``fwd_tc`` and
    ``bwd_tc``), the f32 CUDA-core one beside it. K3-fwd's times are with
    u1 kept, as the training steps that count its launches run it; without
    u1 (painting) beside them. Given phase 16, the bf16 K1 and K3-fwd
    entries also carry their launches in the bf16 lightcone (16c) and per
    shell (the timed run). Given phase 17, both K1 entries carry the
    CGAN's: its launches per paint call (17b in f32, 17c in bf16) and in
    the f32 CGAN lightcone (17e), and K1 at the CLI's CGAN shape (slope
    0.2; 17a's error, 17d's times and the bound there). Given phase 19,
    the f32 K1, K2 and K3 entries carry their launches in the training
    run and its final checkpoint's paint (``train_loop_launches``). Given
    phase 20, K1 and K3-fwd carry their launches in a gate paint call and
    K2 and K3 theirs in the spectral step (``_add_gate_launches``). Given
    phase 21, K2 carries its launches in the CGAN's timed steps and run,
    and K1 in a ``from_trainer`` paint call
    (``_add_cgan_train_launches``)."""
    f32 = next(c for c in checks if c["dtype"] == "float32")
    bf16 = next(c for c in checks if c["dtype"] == "bfloat16")
    def k3(name, key, replaces, heads=heads, launches=None):
        d = key[3:]
        launches = training["launches"] if launches is None else launches
        return {"name": name, "dtype": heads.get("dtype", "float32"),
                "route": "cuda", "source": K3_SOURCE,
                "replaces": replaces, "launches": launches[key],
                "max_abs_err": heads["abs_errors"][
                    "y" if key == "k3_fwd" else "dx"],
                "ms": heads[f"{d}_ms"],
                "plain_ms": heads[f"{d}_plain_ms"],
                "bound_ms": heads[f"{d}_tc_bound"]["bound_ms"],
                "bound_by": heads[f"{d}_tc_bound"]["bound_by"],
                "library_ms": heads[f"{d}_library_ms"],
                "bound_ms_f32_cuda_cores": heads[f"{d}_bound"]["bound_ms"]}

    k3_fwd = k3("head_stack_fwd", "k3_fwd", K3_FWD_REPLACES)
    k3_fwd["u1_max_abs_err"] = heads["abs_errors"]["u1"]
    k3_fwd["ms_without_u1"] = heads["fwd_without_u1_ms"]
    bf16_entries = []
    if paint_bf16 is not None:
        k1_b = timing["bound_bfloat16"]
        bf16_entries.append({
            "name": "res_block_infer", "dtype": "bfloat16", "route": "cuda",
            "source": K1_SOURCE, "replaces": K1_REPLACES,
            "launches": paint_bf16["bf16_launches"]["k1"],
            "max_abs_err": bf16["max_abs_err"],
            "ms": timing["k1_ms_bfloat16"],
            "plain_ms": timing["plain_ms_bfloat16"],
            "bound_ms": k1_b["tc"]["bound_ms"],
            "bound_by": k1_b["tc"]["bound_by"],
            "library_ms": timing["library_ms_bfloat16"]})
    if heads_bf16 is not None and training_bf16 is not None:
        launches = training_bf16["bf16_launches"]
        fwd_b = k3("head_stack_fwd", "k3_fwd", K3_FWD_REPLACES, heads_bf16,
                   launches)
        fwd_b["u1_max_abs_err"] = heads_bf16["abs_errors"]["u1"]
        fwd_b["ms_without_u1"] = heads_bf16["fwd_without_u1_ms"]
        bf16_entries += [fwd_b, k3("head_stack_bwd", "k3_bwd",
                                   K3_BWD_REPLACES, heads_bf16, launches)]
    if lightcone is not None:
        _add_lightcone_launches(bf16_entries, lightcone)
    k1_f32 = timing["bound_float32"]
    k1_entry = {
        "name": "res_block_infer", "dtype": "float32", "route": "cuda",
        "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": paint["launches"],
        "max_abs_err": f32["max_abs_err"], "ms": timing["k1_ms_float32"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": k1_f32["tc"]["bound_ms"],
        "bound_by": k1_f32["tc"]["bound_by"],
        "library_ms": timing["library_ms"],
        "bound_ms_f32_cuda_cores": k1_f32["bound_ms"],
        "bf16_ms": timing["k1_ms_bfloat16"],
        "bf16_bound_ms": timing["bound_bfloat16"]["bound_ms"],
        "bf16_library_ms": timing["library_ms_bfloat16"],
        "bf16_max_abs_err": bf16["max_abs_err"]}
    if cgan is not None:
        _add_cgan(k1_entry, cgan, "float32")
        for entry in bf16_entries:
            if entry["name"] == "res_block_infer":
                _add_cgan(entry, cgan, "bfloat16")
    if conv_bn_bf16 is not None and training_bf16_k4 is not None:
        bf16_entries += k4_record(conv_bn_bf16, training_bf16_k4)
    entries = [k1_entry, {
        "name": "gather_tiles", "dtype": "float32", "route": "cuda",
        "source": K2_SOURCE,
        "replaces": K2_REPLACES, "launches": training["launches"]["k2"],
        "max_abs_err": gather["max_abs_err"], "ms": gather["ms"],
        "plain_ms": gather["plain_ms"], "bound_ms": gather["bound_ms"],
        "bound_by": gather["bound_by"], "library_ms": gather["library_ms"]},
        k3_fwd, k3("head_stack_bwd", "k3_bwd", K3_BWD_REPLACES),
        *k4_record(conv_bn, training_k4), *bf16_entries]
    if train_loop is not None:
        _add_train_loop_launches(entries, train_loop)
    if gate_run is not None and pk is not None:
        _add_gate_launches(entries, gate_run, pk)
    if cgan_train is not None:
        _add_cgan_train_launches(entries, cgan_train)
    if tooling is not None:
        _add_tooling_launches(entries, tooling)
    if mesh is not None:
        _add_mesh_launches(entries, mesh)
    return {"kernels": entries}
