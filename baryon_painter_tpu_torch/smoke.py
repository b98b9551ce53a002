"""The phases of ``chip_smoke.py``, as functions of a device.

``chip_smoke.py`` runs them on ``cuda``; the CPU tests run the same control
flow with ``device="cpu"``, where the kernel wrapper computes its plain
version, nothing is built, and times are host times of no device. Each phase
prints one line with its elapsed seconds and returns what it found; a phase
that fails raises.

  0. environment: card, power limit, versions; TF32 switched off
  1. build K1, K2, K3 and K4 from the sources (one library)
  2. K1 against its plain version (f32 with both slopes, bf16)
  3. paint the committed 512^2 golden through the fused painter (4 K1
     launches) and compare
  4. time the painter, K1, its plain version and the library yardstick
  5. the training data: synthetic stacks and the tile dataset
  6. K2 against its plain version (bit for bit), timed with a library
     yardstick
  7. K3 forward and backward against their plain versions, timed with
     cuDNN's heads as the yardstick
  8. train: steps of the CVAE trainer with the batch gathered by K2 and the
     heads through K3 (one launch of each per step), timed; a step with the
     kernels against a step with the plain versions from the same start
  9. paint the golden with the heads through K3 (one K3-fwd launch), timed
 10. K4 (stats, fwd, bwd1, bwd2) against its plain version at the four
     fused sites of the fiducial training step, timed with cuDNN's conv,
     the port's BatchNorm and ReLU as the yardstick
 11. train with K4 as well (``fused_train_conv=True``: 4 launches of each
     K4 kernel per step at 512^2), timed beside phase 8's step; 11b a step
     with every kernel against a plain step from the same start
 12. repaint the golden with PyTorch's default TF32 setting (cuDNN TF32 on)
     for the record, and with the painter's pinned f32, which must pass
"""
from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from baryon_painter_tpu_torch.ops.conv_bn import (
    batch_stats, bn_affine, conv_bn_bwd1, conv_bn_bwd1_ref, conv_bn_bwd2,
    conv_bn_bwd2_ref, conv_bn_fwd, conv_bn_fwd_ref, conv_bn_relu_bwd_ref,
    conv_bn_relu, conv_bn_relu_ref, conv_bn_stats, conv_bn_stats_ref)
from baryon_painter_tpu_torch.ops.gather import (gather_tiles,
                                                 gather_tiles_ref)
from baryon_painter_tpu_torch.ops.head_stack import (head_stack_bwd,
                                                     head_stack_bwd_ref,
                                                     head_stack_fwd,
                                                     head_stack_ref)
from baryon_painter_tpu_torch.ops.res_block import (fold_bn, res_block_infer,
                                                    res_block_infer_ref)

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

# one H100 SXM at 700 W (NVIDIA's data sheet): f32 on the CUDA cores,
# dense bf16 on the tensor cores, HBM3
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
HBM_BYTES_PER_S = 3.35e12

# main-path shape of K1: 16 tiles of 512^2 reach the blocks at 64x64x128
K1_SHAPE = (16, 64, 64, 128)
# (dtype, inner/outer slope, tolerance on max|kernel - plain| / max|plain|):
# f32 differs only by summation order; bf16 also by where the intermediate
# rounds to bf16
K1_CASES = ((torch.float32, 0.0, 1e-4), (torch.float32, 0.2, 1e-4),
            (torch.bfloat16, 0.0, 2e-2))
# the golden test's own tolerance (tests/test_paint_goldens.py)
GOLDEN_RTOL = 5e-3


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


def check_kernels(device, shape=K1_SHAPE, cases=K1_CASES) -> list:
    """Phase 2: K1 against res_block_infer_ref on the same inputs."""
    t0 = time.perf_counter()
    device = torch.device(device)
    results = []
    for dtype, slope, rel_tol in cases:
        args = k1_inputs(shape, dtype, device)
        got = res_block_infer(*args, inner_slope=slope, outer_slope=slope)
        want = res_block_infer_ref(*args, inner_slope=slope,
                                   outer_slope=slope)
        _sync(device)
        err = (got.float() - want.float()).abs().max().item()
        scale = want.float().abs().max().item()
        rec = {"dtype": str(dtype).replace("torch.", ""), "slope": slope,
               "max_abs_err": err, "max_abs_ref": scale,
               "tol": rel_tol * scale}
        results.append(rec)
        print(f"  K1 {rec['dtype']} slope={slope}: max|k-ref|={err:.3e} "
              f"tol={rec['tol']:.3e}", flush=True)
        if not (err <= rel_tol * scale) or not torch.isfinite(got).all():
            raise AssertionError(f"K1 disagrees with its plain version: "
                                 f"{rec}")
    _line(2, "k1_vs_plain", t0, shape=list(shape), cases=len(results))
    return results


_COUNTED = {"k1": res_block_infer, "k2": gather_tiles,
            "k3_fwd": head_stack_fwd, "k3_bwd": head_stack_bwd,
            "k4_stats": conv_bn_stats, "k4_fwd": conv_bn_fwd,
            "k4_bwd1": conv_bn_bwd1, "k4_bwd2": conv_bn_bwd2}


def _reset_launches():
    for fn in _COUNTED.values():
        fn.launches = 0


def _launches() -> dict:
    return {key: fn.launches for key, fn in _COUNTED.items()}


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
    atol = GOLDEN_RTOL * np.abs(want).mean()
    ratio = float((np.abs(got - want)
                   / (atol + GOLDEN_RTOL * np.abs(want))).max())
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


def _bound(flops: float, nbytes: float, peak: float = PEAK_FLOPS[
        torch.float32]) -> dict:
    t_ops = flops / peak
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


def k1_bound(shape, dtype) -> dict:
    """Least time for one K1 launch: the larger of its operations over the
    peak rate for the type and its bytes (x read, out written, weights and
    folded BN read once) over the memory rate."""
    n, h, w, c = shape
    elt = torch.empty((), dtype=dtype).element_size()
    flops = 2 * 2 * n * h * w * c * c * 9
    nbytes = 2 * n * h * w * c * elt + 2 * 9 * c * c * elt + 4 * c * 4
    return _bound(flops, nbytes, PEAK_FLOPS[dtype])


def library_block(x, w1, s1, b1, w2, s2, b2):
    """The residual block as two library convolutions (cuDNN on the card)
    plus the affine and the ReLUs, NCHW; a yardstick only."""
    a = lambda v: v[:, None, None]
    h = torch.relu(F.conv2d(x, w1, padding=1) * a(s1) + a(b1))
    return torch.relu(F.conv2d(h, w2, padding=1) * a(s2) + a(b2) + x)


def time_main_path(device, painter, card=None, n_tiles: int = 16,
                   warmup: int = 2, iters: int = 10, k1_shape=K1_SHAPE,
                   k1_iters: int = 20) -> dict:
    """Phase 4: paint_batch at n_tiles 512^2 tiles over the 11 redshifts of
    the checkpoint's grid; K1 per launch in f32 and bf16; the plain version;
    the library yardstick; the bound. ``card`` (nvidia-smi's name and power
    limit) is printed beside the times."""
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
        args = k1_inputs(k1_shape, torch.float32, device)
        out["plain_ms"] = _time_ms(lambda: res_block_infer_ref(*args),
                                   device, 3, k1_iters)
        x, w1, s1, b1, w2, s2, b2 = args
        lib_args = (x.permute(0, 3, 1, 2), w1.permute(3, 2, 0, 1).contiguous(),
                    s1, b1, w2.permute(3, 2, 0, 1).contiguous(), s2, b2)
        out["library_ms"] = _time_ms(lambda: library_block(*lib_args),
                                     device, 3, k1_iters)
    out["k1_share_of_bound_float32"] = (out["bound_float32"]["bound_ms"]
                                        / out["k1_ms_float32"])
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
          bound_ms_f32=f"{out['bound_float32']['bound_ms']:.4f}",
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
# tolerances on max|kernel - plain| / max|plain|: the outputs and dx differ
# by summation order only; the weight and slope gradients sum 6.3 M pixels
K3_TOL = {"y": 1e-4, "dx": 1e-4, "dw1": 1e-3, "dw2": 1e-3, "dw3": 1e-3,
          "dalphas": 1e-3}
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
# K4 against its plain version, max|kernel - plain| / max|plain|: y, the
# batch statistics and dx differ by summation order only; the weight and
# batch-norm parameter gradients sum over every output pixel
K4_TOL = {"y": 1e-4, "mean": 1e-4, "var": 1e-4, "dx": 1e-4, "dw": 1e-3,
          "dgamma": 1e-3, "dbeta": 1e-3}
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
# operations per pixel and head: forward conv7 16->8, conv5 8->1, conv3 1->1
_HEAD_FWD_OPS = 2 * (7 * 7 * 16 * 8 + 5 * 5 * 8 + 3 * 3)
# backward: the recomputed u1, u2 and the input and weight gradients of the
# three convs
_HEAD_BWD_OPS = (2 * (7 * 7 * 16 * 8 + 5 * 5 * 8)
                 + 2 * 2 * (7 * 7 * 16 * 8 + 5 * 5 * 8 + 3 * 3))


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


def kink_free_cotangent(x, w1, w2, w3, alphas, dy, rel: float = KINK_REL):
    """``dy`` with zeros wherever a cotangent would reach a pre-activation at
    PReLU's kink, and the fraction zeroed.

    PReLU's derivative jumps at 0, so where u1 or u2 is within summation
    noise of 0 the kernel and the plain version, both right to f32, may
    take different branches and their gradients differ by (1 - alpha) times
    the cotangent there. At the training shape some of the 10^8
    pre-activations are that close to 0. u2 at q is reached from dy on
    q +- 1 (conv3) and u1 at r from dy on r +- 3 (conv5, conv3), per head,
    so dy is zeroed on those windows; everything else is compared."""
    xc = x.permute(0, 3, 1, 2)
    keep = []
    for h in range(w1.shape[0]):
        u1 = F.conv2d(xc, w1[h].permute(3, 2, 0, 1), padding=3)
        v1 = torch.where(u1 >= 0, u1, alphas[h, 0] * u1)
        u2 = F.conv2d(v1, w2[h].permute(3, 2, 0, 1), padding=2)
        near1 = (u1.abs() <= rel * u1.abs().max()).any(1, keepdim=True)
        near2 = u2.abs() <= rel * u2.abs().max()
        reach = (F.max_pool2d(near1.float(), 7, 1, 3)
                 + F.max_pool2d(near2.float(), 3, 1, 1))
        keep.append(reach == 0)
    keep = torch.cat(keep, dim=1)
    return dy * keep, 1.0 - keep.float().mean().item()


def k3_bounds(n: int, h: int, w: int) -> dict:
    """Least times of K3-fwd and K3-bwd: their operations (both heads) over
    the f32 CUDA-core rate, against x, dy, y, dx and the weights moved
    once."""
    pix = n * h * w
    weights = 2 * (7 * 7 * 16 * 8 + 5 * 5 * 8 + 3 * 3 + 2) * 4
    return {"fwd": _bound(2 * pix * _HEAD_FWD_OPS,
                          pix * (16 + 2) * 4 + weights),
            "bwd": _bound(2 * pix * _HEAD_BWD_OPS,
                          pix * (16 + 2 + 16) * 4 + 2 * weights)}


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
                iters: int = 5) -> dict:
    """Phase 7: K3-fwd and K3-bwd against their plain versions at the
    training shape, with the tolerances of K3_TOL, the backward on a
    cotangent free of PReLU's kink (``kink_free_cotangent``); each timed,
    beside cuDNN's unfused heads forward and (under autograd) backward."""
    t0 = time.perf_counter()
    device = torch.device(device)
    x, w1, w2, w3, al, dy = head_inputs(*shape, device)
    with torch.no_grad():
        dy_check, zeroed = kink_free_cotangent(x, w1, w2, w3, al, dy)
    got = (head_stack_fwd(x, w1, w2, w3, al),
           *head_stack_bwd(x, w1, w2, w3, al, dy_check))
    want = (head_stack_ref(x, w1, w2, w3, al),
            *head_stack_bwd_ref(x, w1, w2, w3, al, dy_check))
    _sync(device)
    errs, abs_errs = {}, {}
    for name, a, b in zip(K3_TOL, got, want):
        errs[name] = _rel_err(a, b)
        abs_errs[name] = (a - b).abs().max().item()
    del got, want
    print(f"  K3 cotangent zeroed near the kink: {zeroed:.3e} of dy",
          flush=True)
    for name, err in errs.items():
        print(f"  K3 {name}: max|k-ref|/max|ref|={err:.3e} "
              f"tol={K3_TOL[name]:.0e}", flush=True)
    bad = {k: v for k, v in errs.items() if not v <= K3_TOL[k]}
    if bad:
        raise AssertionError(f"K3 disagrees with its plain version: {bad}")
    oihw = lambda w: w.permute(0, 4, 3, 1, 2).contiguous()
    xc = x.permute(0, 3, 1, 2).contiguous()
    lib_args = [t.clone().requires_grad_() for t in
                (xc, oihw(w1), oihw(w2), oihw(w3), al)]
    out = {"errors": errs, "abs_errors": abs_errs, "kink_zeroed": zeroed,
           **{f"{k}_bound": v for k, v in
                              k3_bounds(*shape).items()}}
    with torch.no_grad():
        out["fwd_ms"] = _time_ms(lambda: head_stack_fwd(x, w1, w2, w3, al),
                                 device, 1, iters)
        out["fwd_plain_ms"] = _time_ms(
            lambda: head_stack_ref(x, w1, w2, w3, al), device, 1, iters)
        out["fwd_library_ms"] = _time_ms(lambda: library_heads(*lib_args),
                                         device, 1, iters)
        out["bwd_ms"] = _time_ms(
            lambda: head_stack_bwd(x, w1, w2, w3, al, dy), device, 1, iters)
        out["bwd_plain_ms"] = _time_ms(
            lambda: head_stack_bwd_ref(x, w1, w2, w3, al, dy), device, 1,
            iters)
    y = library_heads(*lib_args)
    out["bwd_library_ms"] = _time_ms(
        lambda: torch.autograd.grad(y, lib_args, dy, retain_graph=True),
        device, 1, iters)
    del y
    _line(7, "k3_vs_plain", t0, shape=list(shape),
          fwd_ms=f"{out['fwd_ms']:.3f}",
          fwd_plain_ms=f"{out['fwd_plain_ms']:.3f}",
          fwd_library_ms=f"{out['fwd_library_ms']:.3f}",
          fwd_bound_ms=f"{out['fwd_bound']['bound_ms']:.3f}",
          bwd_ms=f"{out['bwd_ms']:.3f}",
          bwd_plain_ms=f"{out['bwd_plain_ms']:.3f}",
          bwd_library_ms=f"{out['bwd_library_ms']:.3f}",
          bwd_bound_ms=f"{out['bwd_bound']['bound_ms']:.3f}")
    return out


def make_trainer(device, dataset, fused_heads: bool, use_kernel="auto",
                 n_res_blocks: int = N_RES_BLOCKS, seed: int = 0,
                 fused_train_conv: bool = False):
    from baryon_painter_tpu_torch.models.cvae import (
        CVAE, fiducial_cvae_architecture)
    from baryon_painter_tpu_torch.train.trainer import (CVAETrainer,
                                                        TrainConfig)
    arch = fiducial_cvae_architecture(dataset.tile_size,
                                      n_res_blocks=n_res_blocks)
    model = CVAE(arch, fused_heads=fused_heads,
                 fused_train_conv=fused_train_conv)
    return CVAETrainer(model, dataset, config=TrainConfig(seed=seed),
                       device_data=True, device=device, use_kernel=use_kernel)


def k4_sites_per_step(tile: int) -> int:
    """K4 calls in one fiducial training step: the three up-convs, and the
    input conv where its rows pass the space-to-depth rule (h >= 128)."""
    return 4 if tile >= 128 else 3


def train(device, dataset, batch: int = TRAIN_BATCH, warmup: int = 3,
          iters: int = 10, n_res_blocks: int = N_RES_BLOCKS,
          lr: float = 1e-4, card=None, fused_train_conv: bool = False,
          k4_off_ms=None) -> dict:
    """Phase 8 (and 11 with ``fused_train_conv``), a main path: ``warmup``
    then ``iters`` timed training steps (``step_indices``: batch gathered on
    the device through K2, heads through K3, and with ``fused_train_conv``
    the gated conv + batch norm + ReLU triples through K4) from the port's
    own initialisation. Per timed step on the card exactly one K2, K3-fwd
    and K3-bwd launch and, with K4, ``k4_sites_per_step`` of each K4
    kernel; finite metrics; the parameters change. Host clock around steps
    that end in a synchronise; ``k4_off_ms`` (phase 8's step) is printed
    beside."""
    t0 = time.perf_counter()
    device = torch.device(device)
    trainer = make_trainer(device, dataset, True, n_res_blocks=n_res_blocks,
                           fused_train_conv=fused_train_conv)
    rng = np.random.default_rng(1)
    idx = [dataset.sample_indices(rng, batch) for _ in range(warmup + iters)]
    before = [p.detach().clone() for p in trainer.params]
    for i in range(warmup):
        trainer.step_indices(idx[i], lr)
    _sync(device)
    _reset_launches()
    t1 = time.perf_counter()
    metrics = [trainer.step_indices(idx[warmup + i], lr)
               for i in range(iters)]
    _sync(device)
    step_ms = (time.perf_counter() - t1) * 1e3 / iters
    counts = _launches()
    n = iters if device.type == "cuda" else 0
    want = {"k2": n, "k3_fwd": n, "k3_bwd": n}
    if fused_train_conv:
        sites = k4_sites_per_step(dataset.tile_size)
        want.update({f"k4_{k}": sites * n for k in K4_KERNELS})
    _expect_launches("train", counts, want)
    finite = all(bool(torch.isfinite(v).all()) for m in metrics
                 for v in m.values())
    changed = any(not torch.equal(a, b) for a, b in zip(before,
                                                        trainer.params))
    if not (finite and changed):
        raise AssertionError(f"training: finite metrics {finite}, "
                             f"parameters changed {changed}")
    out = {"step_ms": step_ms, "samples_per_s": batch / step_ms * 1e3,
           "batch": batch, "launches": counts,
           "elbo": [float(m["elbo"]) for m in metrics]}
    extra = {}
    if fused_train_conv and k4_off_ms is not None:
        extra = dict(step_ms_k4_off=f"{k4_off_ms:.3f}",
                     samples_per_s_k4_off=f"{batch / k4_off_ms * 1e3:.2f}")
    _line(11 if fused_train_conv else 8,
          "train_k4" if fused_train_conv else "train", t0,
          clock="host_clock_after_sync", card=json.dumps(card), batch=batch,
          steps=iters, step_ms=f"{step_ms:.3f}",
          samples_per_s=f"{out['samples_per_s']:.2f}", **extra,
          launches=json.dumps(counts),
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
    """A K4 site in plain PyTorch: the plain forward (``conv_bn_relu_ref``,
    or with ``f64`` ``_site_forward_f64``), then the plain backward with the
    ReLU's active set ``active`` when given (K4's, recorded in the kernels
    step), else the forward's own (y > 0)."""

    @staticmethod
    def forward(ctx, x, w, gamma, beta, transposed, stride, padding, eps,
                active, f64):
        kw = dict(transposed=transposed, stride=stride, padding=padding)
        if f64:
            y, mean, var = _site_forward_f64(x, w, gamma, beta, eps=eps,
                                             **kw)
        else:
            y, mean, var = conv_bn_relu_ref(x, w, gamma, beta, eps=eps, **kw)
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


def _recording_k4(masks: list):
    """``conv_bn_relu`` that appends each call's ReLU active set (y > 0) to
    ``masks``."""
    def site(x, w, gamma, beta, **kw):
        y, mean, var = conv_bn_relu(x, w, gamma, beta, **kw)
        masks.append(y.detach() > 0)
        return y, mean, var
    return site


def _plain_k4(masks=None, f64: bool = False):
    """``_PlainSite`` as a ``conv_bn_relu``: with ``masks``, each call takes
    the next recorded active set."""
    def site(x, w, gamma, beta, *, transposed, stride, padding, eps=1e-5):
        active = masks.pop(0) if masks is not None else None
        return _PlainSite.apply(x, w, gamma, beta, transposed, stride,
                                padding, eps, active, f64)
    return site


def _worst(errs: dict, ref: dict, n: int = 5) -> str:
    return ", ".join(f"{k}: {errs[k]:.2e} (max|g| {ref[k].abs().max():.2e})"
                     for k in sorted(errs, key=errs.get)[-n:])


def train_parity(device, dataset, batch: int = TRAIN_BATCH,
                 n_res_blocks: int = N_RES_BLOCKS,
                 fused_train_conv: bool = False) -> dict:
    """Phase 8b (11b with ``fused_train_conv``): one step with the kernels
    (K2, K3, and with ``fused_train_conv`` K4) against one with the plain
    versions (``use_kernel=False``, cuDNN heads and trunk) from the same
    initialisation, batch and latent noise: the loss to STEP_LOSS_RTOL,
    every parameter's gradient to STEP_GRAD_TOL of its largest entry
    (``step_grad_errors``). Prints every parameter whose gradient lies under
    STEP_GRAD_FLOOR of the largest entry of all.

    With K4 the plain step runs the fused sites in plain PyTorch
    (``_PlainSite``: the library's conv, the batch statistics, the ReLU and
    the closed-form backward), its forward wholly its own, and takes K4's
    ReLU active sets at those sites, recorded in the kernels step: K4
    recomputes u, so at a pre-activation within rounding of the kink it can
    pass the ReLU where the plain forward does not. Printed beside, for the
    record: the kernels step against the wholly plain step, and the witness
    of how far rounding of the sites' forward alone moves the gradients,
    the plain sites' step and the kernels step each against a step whose
    sites' forward is computed in f64 (``_site_forward_f64``). cuDNN runs
    its deterministic algorithms here, so the comparison reads the same in
    every run."""
    t0 = time.perf_counter()
    device = torch.device(device)
    idx = dataset.sample_indices(np.random.default_rng(2), batch)
    hz = dataset.tile_size // 32
    eps = torch.randn((1, batch, 1, hz, hz),
                      generator=torch.Generator().manual_seed(3))
    masks = []
    # (label, fused heads and gather kernel, fused sites, their function)
    plans = [("kernels", True, fused_train_conv, _recording_k4(masks)),
             ("plain", False, False, None)]
    if fused_train_conv:
        plans += [("plain_k4_active", False, True, _plain_k4(masks)),
                  ("plain_sites", False, True, _plain_k4()),
                  ("sites_f64", False, True, _plain_k4(f64=True))]
    runs = {}
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for label, kernels, k4, site in plans:
            trainer = make_trainer(device, dataset, kernels,
                                   use_kernel=kernels,
                                   n_res_blocks=n_res_blocks,
                                   fused_train_conv=k4)
            with _k4_sites(site or conv_bn_relu):
                m = trainer.step_indices(idx, 1e-4, eps=eps)
            names = [n for n, p in trainer.model.named_parameters()
                     if p.requires_grad]
            runs[label] = (float(m["elbo"]), dict(zip(names, (
                p.grad.detach().clone() for p in trainer.params))))
            del trainer
    finally:
        torch.backends.cudnn.deterministic = deterministic
    if masks:
        raise AssertionError(f"{len(masks)} recorded K4 active sets left "
                             f"unused: the steps fused different sites")
    loss_k, grads_k = runs["kernels"]
    loss_p, grads_plain = runs["plain"]
    ref = "plain_k4_active" if fused_train_conv else "plain"
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
    witness = {}
    if fused_train_conv:
        for a, b in (("kernels", "plain"), ("plain_sites", "sites_f64"),
                     ("kernels", "sites_f64")):
            errs, _, _ = step_grad_errors(runs[a][1], runs[b][1])
            witness[f"{a}_vs_{b}"] = max(errs.values())
            print(f"  {a} against {b}, worst gradients: "
                  f"{_worst(errs, runs[b][1])}", flush=True)
    print(f"  worst gradients against {ref} (max|g| of all {top:.2e}): "
          f"{worst5}", flush=True)
    if not (loss_err <= STEP_LOSS_RTOL
            and grad_errs[worst] <= STEP_GRAD_TOL):
        raise AssertionError(f"kernels-vs-plain step: loss rel err "
                             f"{loss_err:.3e}; largest gradient entry "
                             f"{top:.3e}; worst gradients {worst5}")
    _line(phase, "train_parity", t0, elbo_kernels=f"{loss_k:.6f}",
          elbo_plain=f"{loss_p:.6f}", loss_rel_err=f"{loss_err:.3e}",
          worst_grad=worst, worst_grad_rel_err=f"{grad_errs[worst]:.3e}",
          params=len(grad_errs), under_floor=len(under),
          **{k: f"{v:.3e}" for k, v in witness.items()})
    return {"loss_rel_err": loss_err, "worst_grad": worst,
            "worst_grad_rel_err": grad_errs[worst], "under_floor": under,
            "witness": witness}


def paint_fused_heads(device, card=None, heads_unfused_ms=None,
                      n_tiles: int = 16, warmup: int = 2,
                      iters: int = 10) -> dict:
    """Phase 9, a main path: the golden painted with the heads through K3
    (``CVAEPainter(fused_inference=True, fused_heads=True)``: 4 K1 and 1
    K3-fwd launches a call), then timed as phase 4 times the painter with
    cuDNN's heads (``heads_unfused_ms``)."""
    t0 = time.perf_counter()
    device = torch.device(device)
    paint = paint_golden(device, fused_heads=True, phase=9)
    ms = paint_time_ms(device, paint["painter"], n_tiles, warmup, iters)
    _line(9, "paint_timing_fused_heads", t0, card=json.dumps(card),
          paint_ms=f"{ms:.3f}", n_tiles=n_tiles,
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


def k4_bounds(site: dict, batch: int, tile: int) -> dict:
    """Least time of each K4 kernel at a site: its operations over the f32
    CUDA-core rate against its bytes over the memory rate. One conv pass is
    2 N Ho Wo Cout Cin taps operations (taps = k^2, or (k/s)^2 for the
    transposed conv); stats, fwd and bwd1 need one pass and bwd2 three (u
    again, dx and dW), plus a few elementwise operations per output. Bytes:
    x and the weights read once, and y (fwd), dy (bwd1, bwd2), dx and dW
    (bwd2) moved once. ``logical_fwd`` and ``logical_bwd`` bound the fused
    op as a whole, without the kernels' recomputes of u: one conv pass
    forward (x read, y written) and two backward (dx and dW, from x, y and
    dy)."""
    sh = k4_site_shape(site, batch, tile)
    cin, cout, k = site["cin"], site["cout"], site["k"]
    taps = (k // site["stride"]) ** 2 if site["transposed"] else k * k
    out = batch * sh["ho"] * sh["ho"] * cout
    conv = 2.0 * out * cin * taps
    xb = 4.0 * batch * cin * sh["h"] * sh["h"]
    wb = 4.0 * cin * cout * k * k
    return {"conv_flops": conv,
            "stats": _bound(conv + 3 * out, xb + wb),
            "fwd": _bound(conv + 3 * out, xb + wb + 4 * out),
            "bwd1": _bound(conv + 6 * out, xb + wb + 4 * out),
            "bwd2": _bound(3 * conv + 8 * out, 2 * xb + 2 * wb + 4 * out),
            "logical_fwd": _bound(conv + 3 * out, xb + wb + 4 * out),
            "logical_bwd": _bound(2 * conv + 8 * out,
                                  2 * xb + 2 * wb + 8 * out)}


def library_conv_bn_relu(x, w, gamma, beta, site):
    """cuDNN's conv or transposed conv, then the port's train-mode
    BatchNorm and ReLU, as the unfused model runs them; a yardstick only.
    Returns a callable of (x, w) and the BatchNorm module."""
    from baryon_painter_tpu_torch.models.layers import BatchNorm
    bn = BatchNorm(site["cout"]).to(x.device).train()
    with torch.no_grad():
        bn.weight.copy_(gamma)
        bn.bias.copy_(beta)
    conv = F.conv_transpose2d if site["transposed"] else F.conv2d
    kw = dict(stride=site["stride"], padding=site["padding"])
    return (lambda xx, ww: torch.relu(bn(conv(xx, ww, **kw)))), bn


def check_conv_bn(device, batch: int = TRAIN_BATCH, tile: int = TRAIN_TILE,
                  iters: int = 3, card=None) -> dict:
    """Phase 10: K4 against its plain version at each fused site of the
    fiducial training step (``K4_SITES``): y, mean and var from K4-stats and
    K4-fwd against ``conv_bn_relu_ref``; dx, dW, dgamma and dbeta from
    K4-bwd1 and K4-bwd2 against ``conv_bn_relu_bwd_ref`` on a cotangent
    zeroed where it meets a pre-activation within KINK_REL of ReLU's kink
    (the kernel recomputes u, so there it may take the other branch); the
    tolerances of K4_TOL. Each kernel, its plain version and the yardstick
    (``library_conv_bn_relu``, forward and autograd backward) timed with
    CUDA events; the bound beside."""
    t0 = time.perf_counter()
    device = torch.device(device)
    sites = {}
    for name, site in K4_SITES.items():
        x, w, gamma, beta, dy = k4_inputs(site, batch, tile, device)
        kw = {k: site[k] for k in ("transposed", "stride", "padding")}
        count = dy.shape[0] * dy.shape[2] * dy.shape[3]
        with torch.no_grad():
            mean, var = batch_stats(*conv_bn_stats(x, w, **kw), count)
            inv, a, b = bn_affine(gamma, beta, mean, var)
            y = conv_bn_fwd(x, w, a, b, **kw)
            y_r, mean_r, var_r = conv_bn_relu_ref(x, w, gamma, beta, **kw)
            _, a_r, b_r = bn_affine(gamma, beta, mean_r, var_r)
            v = (F.conv_transpose2d if site["transposed"] else F.conv2d)(
                x, w, stride=site["stride"], padding=site["padding"])
            v = v * a_r[:, None, None] + b_r[:, None, None]
            near = v.abs() <= KINK_REL * v.abs().max()
            dy_k = torch.where(near, 0.0, dy)
            zeroed = near.float().mean().item()
            del v, near
            g1, g2 = conv_bn_bwd1(x, w, a, b, mean, inv, dy_k, **kw)
            dx, dw = conv_bn_bwd2(x, w, a, b, mean, inv, g1 / count,
                                  g2 / count, dy_k, **kw)
            want = dict(zip(("dx", "dw", "dgamma", "dbeta"),
                            conv_bn_relu_bwd_ref(x, w, gamma, beta, mean_r,
                                                 var_r, dy_k, **kw)))
            got = {"y": y, "mean": mean, "var": var, "dx": dx, "dw": dw,
                   "dgamma": g2, "dbeta": g1}
            want.update(y=y_r, mean=mean_r, var=var_r)
            _sync(device)
            errs = {k: _rel_err(got[k], want[k]) for k in K4_TOL}
            abs_errs = {k: (got[k] - want[k]).abs().max().item()
                        for k in K4_TOL}
            del got, want, y, y_r, dx, dw
        bad = {k: e for k, e in errs.items() if not e <= K4_TOL[k]}
        print(f"  K4 site {name}: cotangent zeroed near the kink "
              f"{zeroed:.3e}; " + ", ".join(f"{k} {e:.2e}"
                                            for k, e in errs.items()),
              flush=True)
        if bad:
            raise AssertionError(f"K4 site {name} disagrees with its plain "
                                 f"version: {bad}")
        s1n, s2n = g1 / count, g2 / count
        calls = {
            "stats": (lambda: conv_bn_stats(x, w, **kw),
                      lambda: conv_bn_stats_ref(x, w, **kw)),
            "fwd": (lambda: conv_bn_fwd(x, w, a, b, **kw),
                    lambda: conv_bn_fwd_ref(x, w, a, b, **kw)),
            "bwd1": (lambda: conv_bn_bwd1(x, w, a, b, mean, inv, dy, **kw),
                     lambda: conv_bn_bwd1_ref(x, w, a, b, mean, inv, dy,
                                              **kw)),
            "bwd2": (lambda: conv_bn_bwd2(x, w, a, b, mean, inv, s1n, s2n,
                                          dy, **kw),
                     lambda: conv_bn_bwd2_ref(x, w, a, b, mean, inv, s1n,
                                              s2n, dy, **kw)),
        }
        rec = {"errors": errs, "abs_errors": abs_errs, "kink_zeroed": zeroed,
               "bounds": k4_bounds(site, batch, tile), "ms": {},
               "plain_ms": {}}
        with torch.no_grad():
            for k, (kern, plain) in calls.items():
                rec["ms"][k] = _time_ms(kern, device, 1, iters)
                rec["plain_ms"][k] = _time_ms(plain, device, 1, iters)
        lib, bn = library_conv_bn_relu(x, w, gamma, beta, site)
        leaves = [x.clone().requires_grad_(), w.clone().requires_grad_(),
                  bn.weight, bn.bias]
        with torch.no_grad():
            rec["library_fwd_ms"] = _time_ms(lambda: lib(x, w), device, 1,
                                             iters)
        y_l = lib(leaves[0], leaves[1])
        rec["library_bwd_ms"] = _time_ms(
            lambda: torch.autograd.grad(y_l, leaves, dy, retain_graph=True),
            device, 1, iters)
        del y_l, leaves, calls
        sites[name] = rec
        b_ = rec["bounds"]
        print(f"  K4 site {name} ({card}): "
              + ", ".join(f"{k} {rec['ms'][k]:.3f} ms (plain "
                          f"{rec['plain_ms'][k]:.3f}, bound "
                          f"{b_[k]['bound_ms']:.3f})" for k in K4_KERNELS)
              + f"; library fwd {rec['library_fwd_ms']:.3f} ms, bwd "
              f"{rec['library_bwd_ms']:.3f} ms; conv pass "
              f"{b_['conv_flops'] / 1e9:.2f} GFLOP", flush=True)
    total = {k: sum(r["ms"][k] for r in sites.values()) for k in K4_KERNELS}
    logical = {k: sum(r["bounds"][f"logical_{k}"]["bound_ms"]
                      for r in sites.values()) for k in ("fwd", "bwd")}
    _line(10, "k4_vs_plain", t0, sites=",".join(sites), batch=batch,
          card=json.dumps(card),
          **{f"{k}_ms_4_sites": f"{v:.3f}" for k, v in total.items()},
          logical_fwd_bound_ms=f"{logical['fwd']:.3f}",
          logical_bwd_bound_ms=f"{logical['bwd']:.3f}",
          stats_fwd_share_of_logical=(
              f"{logical['fwd'] / (total['stats'] + total['fwd']):.4f}"),
          bwd1_bwd2_share_of_logical=(
              f"{logical['bwd'] / (total['bwd1'] + total['bwd2']):.4f}"),
          library_fwd_ms_4_sites=f"{sum(r['library_fwd_ms'] for r in sites.values()):.3f}",
          library_bwd_ms_4_sites=f"{sum(r['library_bwd_ms'] for r in sites.values()):.3f}")
    return {"sites": sites}


def paint_tf32(device, repo: Path = REPO) -> dict:
    """Phase 12: with PyTorch's default TF32 settings (cuDNN TF32 on,
    matmul TF32 off), the golden repainted through the painter's inner
    ``_paint_batch``, which runs under that setting, for the record, and
    through ``paint_batch``, which pins f32 and must pass; the caller's
    settings are restored after."""
    t0 = time.perf_counter()
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        default = paint_golden(device, repo, phase=12, caller_tf32=True,
                               check=False)["worst_err_over_tol"]
        pinned = paint_golden(device, repo, phase=12)["worst_err_over_tol"]
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = prev
    _line(12, "paint_tf32", t0,
          worst_err_over_tol_library_default=f"{default:.4f}",
          worst_err_over_tol_pinned_f32=f"{pinned:.4f}",
          default_within_golden=default <= 1.0)
    return {"library_default": default, "pinned": pinned}


# what each K4 kernel's max_abs_err covers, and the yardstick it carries
_K4_ERRORS = {"stats": ("mean", "var"), "fwd": ("y",),
              "bwd1": ("dgamma", "dbeta"), "bwd2": ("dx", "dw")}
_K4_LIBRARY = {"fwd": "library_fwd_ms", "bwd2": "library_bwd_ms"}


def k4_record(conv_bn: dict, training_k4: dict) -> list:
    """K4's four entries of the kernels record, each summed over the four
    sites of phase 10 (the per-site values are printed there), with the
    launches of phase 11's timed steps. The yardstick times the library's
    forward (conv, BatchNorm, ReLU) and its autograd backward; they stand
    on K4-fwd and K4-bwd2, as the pairs stats + fwd and bwd1 + bwd2 compute
    those functions."""
    sites = conv_bn["sites"].values()
    out = []
    for k in K4_KERNELS:
        t_ops = sum(r["bounds"][k]["flops"] for r in sites) / PEAK_FLOPS[
            torch.float32]
        t_bytes = sum(r["bounds"][k]["bytes"] for r in sites) / HBM_BYTES_PER_S
        lib = _K4_LIBRARY.get(k)
        entry = {
            "name": f"conv_bn_{k}", "route": "cuda", "source": K4_SOURCE,
            "replaces": K4_REPLACES[k],
            "launches": training_k4["launches"][f"k4_{k}"],
            "max_abs_err": max(r["abs_errors"][e] for r in sites
                               for e in _K4_ERRORS[k]),
            "ms": sum(r["ms"][k] for r in sites),
            "plain_ms": sum(r["plain_ms"][k] for r in sites),
            "bound_ms": sum(r["bounds"][k]["bound_ms"] for r in sites),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": (sum(r[lib] for r in sites)
                           if lib is not None else None),
            "sites": len(conv_bn["sites"])}
        if lib is not None:
            entry["library_covers"] = ("stats+fwd" if k == "fwd"
                                       else "bwd1+bwd2")
        out.append(entry)
    return out


def kernels_record(checks: list, paint: dict, timing: dict, gather: dict,
                   heads: dict, training: dict, conv_bn: dict,
                   training_k4: dict) -> dict:
    """The ``{"kernels": [...]}`` record of the run: K1 at the main path's
    dtype (f32), its bf16 numbers beside it; K2, K3-fwd and K3-bwd with
    their launches in the timed training steps; K4's four kernels
    (``k4_record``)."""
    f32 = next(c for c in checks if c["dtype"] == "float32")
    bf16 = next(c for c in checks if c["dtype"] == "bfloat16")
    k3 = lambda name, key, replaces: {
        "name": name, "route": "cuda", "source": K3_SOURCE,
        "replaces": replaces, "launches": training["launches"][key],
        "max_abs_err": heads["abs_errors"]["y" if key == "k3_fwd" else "dx"],
        "ms": heads[f"{key[3:]}_ms"], "plain_ms": heads[f"{key[3:]}_plain_ms"],
        "bound_ms": heads[f"{key[3:]}_bound"]["bound_ms"],
        "bound_by": heads[f"{key[3:]}_bound"]["bound_by"],
        "library_ms": heads[f"{key[3:]}_library_ms"]}
    return {"kernels": [{
        "name": "res_block_infer", "route": "cuda", "source": K1_SOURCE,
        "replaces": K1_REPLACES, "launches": paint["launches"],
        "max_abs_err": f32["max_abs_err"], "ms": timing["k1_ms_float32"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_float32"]["bound_ms"],
        "bound_by": timing["bound_float32"]["bound_by"],
        "library_ms": timing["library_ms"],
        "bf16_ms": timing["k1_ms_bfloat16"],
        "bf16_bound_ms": timing["bound_bfloat16"]["bound_ms"],
        "bf16_max_abs_err": bf16["max_abs_err"]}, {
        "name": "gather_tiles", "route": "cuda", "source": K2_SOURCE,
        "replaces": K2_REPLACES, "launches": training["launches"]["k2"],
        "max_abs_err": gather["max_abs_err"], "ms": gather["ms"],
        "plain_ms": gather["plain_ms"], "bound_ms": gather["bound_ms"],
        "bound_by": gather["bound_by"], "library_ms": gather["library_ms"]},
        k3("head_stack_fwd", "k3_fwd", K3_FWD_REPLACES),
        k3("head_stack_bwd", "k3_bwd", K3_BWD_REPLACES),
        *k4_record(conv_bn, training_k4)]}
