"""The phases of ``chip_smoke.py``, as functions of a device.

``chip_smoke.py`` runs them on ``cuda``; the CPU tests run the same control
flow with ``device="cpu"``, where the kernel wrapper computes its plain
version, nothing is built, and times are host times of no device. Each phase
prints one line with its elapsed seconds and returns what it found; a phase
that fails raises.

  0. environment: card, power limit, versions; TF32 switched off
  1. build K1 from the sources
  2. K1 against its plain version (f32 with both slopes, bf16)
  3. paint the committed 512^2 golden through the fused painter (4 K1
     launches) and compare
  4. time the painter, K1, its plain version and the library yardstick
"""
from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from baryon_painter_tpu_torch.ops.res_block import (fold_bn, res_block_infer,
                                                    res_block_infer_ref)

REPO = Path(__file__).resolve().parent.parent
CHECKPOINT = "trained_models/CVAE/fiducial-512/model"
GOLDENS = "tests/goldens/paint_goldens.npz"
GOLDEN_EPS = Path(__file__).resolve().parent / "data" / "golden_eps.npz"
K1_REPLACES = "baryon_painter_tpu/ops/pallas_conv.py:72"
K1_SOURCE = "baryon_painter_tpu_torch/csrc/res_block.cu"

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
    """Phase 1: build K1 from the sources, from scratch (cuda only)."""
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


def paint_golden(device, repo: Path = REPO) -> dict:
    """Phase 3: the main path. Paint the committed 512^2 golden's inputs with
    the fused painter and the committed prior noise; compare with the golden
    and count K1 launches (4 on the card: one per residual block)."""
    from baryon_painter_tpu_torch.painter import CVAEPainter
    t0 = time.perf_counter()
    device = torch.device(device)
    painter = CVAEPainter(str(repo / CHECKPOINT), fused_inference=True,
                          device=device)
    with np.load(repo / GOLDENS) as g:
        want = g["cvae_512"].astype(np.float32)
    with np.load(GOLDEN_EPS) as e:
        eps = e["eps_512"]
    tiles = golden_inputs(512, 1)
    zs = np.zeros(1, np.float32)
    res_block_infer.launches = 0
    out = painter.paint_batch(tiles, zs, eps=eps)
    _sync(device)
    launches = res_block_infer.launches
    got = out.cpu().numpy()
    expected = 4 if device.type == "cuda" else 0
    if launches != expected:
        raise AssertionError(f"K1 launched {launches} times on the paint "
                             f"path, expected {expected}")
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        raise AssertionError(f"painted {got.shape}, finite="
                             f"{np.all(np.isfinite(got))}")
    atol = GOLDEN_RTOL * np.abs(want).mean()
    ratio = float((np.abs(got - want)
                   / (atol + GOLDEN_RTOL * np.abs(want))).max())
    if not ratio <= 1.0:
        raise AssertionError(f"painted tile differs from the golden: worst "
                             f"|diff| / tolerance = {ratio:.3f}")
    _line(3, "paint_golden", t0, launches=launches,
          worst_err_over_tol=f"{ratio:.4f}")
    return {"launches": launches, "worst_err_over_tol": ratio,
            "painter": painter}


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


def k1_bound(shape, dtype) -> dict:
    """Least time for one K1 launch: the larger of its operations over the
    peak rate for the type and its bytes (x read, out written, weights and
    folded BN read once) over the memory rate."""
    n, h, w, c = shape
    elt = torch.empty((), dtype=dtype).element_size()
    flops = 2 * 2 * n * h * w * c * c * 9
    nbytes = 2 * n * h * w * c * elt + 2 * 9 * c * c * elt + 4 * c * 4
    t_ops = flops / PEAK_FLOPS[dtype]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return {"flops": flops, "bytes": nbytes,
            "bound_ms": max(t_ops, t_bytes) * 1e3,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes"}


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
    z_grid = np.asarray(painter.meta["stats"][painter.input_field]["z_grid"],
                        np.float32)
    tiles = torch.as_tensor(golden_inputs(512, n_tiles), device=device)
    zs = torch.as_tensor(z_grid[np.arange(n_tiles) % len(z_grid)],
                         device=device)
    paint_ms = _time_ms(lambda: painter.paint_batch(tiles, zs), device,
                        warmup, iters)
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


def kernels_record(checks: list, paint: dict, timing: dict) -> dict:
    """The ``{"kernels": [...]}`` record of the run: K1 at the main path's
    dtype (f32), its bf16 numbers beside it."""
    f32 = next(c for c in checks if c["dtype"] == "float32")
    bf16 = next(c for c in checks if c["dtype"] == "bfloat16")
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
        "bf16_max_abs_err": bf16["max_abs_err"]}]}
