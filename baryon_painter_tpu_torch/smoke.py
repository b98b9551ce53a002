"""The phases of ``chip_smoke.py``, as functions of a device.

``chip_smoke.py`` runs them on ``cuda``; the CPU tests run the same control
flow with ``device="cpu"``, where the kernel wrapper computes its plain
version, nothing is built, and times are host times of no device. Each phase
prints one line with its elapsed seconds and returns what it found; a phase
that fails raises.

  0. environment: card, power limit, versions; TF32 switched off
  1. build K1, K2 and K3 from the sources (one library)
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
"""
from __future__ import annotations

import json
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

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


def _reset_launches():
    for fn in (res_block_infer, gather_tiles, head_stack_fwd,
               head_stack_bwd):
        fn.launches = 0


def _launches() -> dict:
    return {"k1": res_block_infer.launches, "k2": gather_tiles.launches,
            "k3_fwd": head_stack_fwd.launches,
            "k3_bwd": head_stack_bwd.launches}


def _expect_launches(path: str, got: dict, want: dict):
    """Every kernel's launch count on a path, against what it must be."""
    if got != want:
        raise AssertionError(f"{path}: kernel launches {got}, expected "
                             f"{want}")


def paint_golden(device, repo: Path = REPO, fused_heads: bool = False,
                 phase: int = 3) -> dict:
    """Phase 3 (and 9 with ``fused_heads``): a main path. Paint the
    committed 512^2 golden's inputs with the fused painter and the committed
    prior noise; compare with the golden and count the launches (on the
    card 4 of K1, one per residual block, and with ``fused_heads`` 1 of
    K3-fwd; none on the CPU)."""
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
    out = painter.paint_batch(tiles, zs, eps=eps)
    _sync(device)
    counts = _launches()
    got = out.cpu().numpy()
    on_card = device.type == "cuda"
    _expect_launches("paint", counts, {
        "k1": 4 if on_card else 0, "k2": 0,
        "k3_fwd": 1 if on_card and fused_heads else 0, "k3_bwd": 0})
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        raise AssertionError(f"painted {got.shape}, finite="
                             f"{np.all(np.isfinite(got))}")
    atol = GOLDEN_RTOL * np.abs(want).mean()
    ratio = float((np.abs(got - want)
                   / (atol + GOLDEN_RTOL * np.abs(want))).max())
    if not ratio <= 1.0:
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
# gradient as the weight gradients above, relative to its largest entry or,
# where that is below STEP_GRAD_FLOOR of the largest entry of all the
# gradients, to that floor: the scale of a batch norm followed, through a
# ReLU and a bias-free conv, by another batch norm has an analytic gradient
# of 0, and both sides return rounding noise for it
STEP_LOSS_RTOL = 1e-5
STEP_GRAD_TOL = 1e-3
STEP_GRAD_FLOOR = 1e-3
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
             n_res_blocks: int = N_RES_BLOCKS, seed: int = 0):
    from baryon_painter_tpu_torch.models.cvae import (
        CVAE, fiducial_cvae_architecture)
    from baryon_painter_tpu_torch.train.trainer import (CVAETrainer,
                                                        TrainConfig)
    arch = fiducial_cvae_architecture(dataset.tile_size,
                                      n_res_blocks=n_res_blocks)
    return CVAETrainer(CVAE(arch, fused_heads=fused_heads), dataset,
                       config=TrainConfig(seed=seed), device_data=True,
                       device=device, use_kernel=use_kernel)


def train(device, dataset, batch: int = TRAIN_BATCH, warmup: int = 3,
          iters: int = 10, n_res_blocks: int = N_RES_BLOCKS,
          lr: float = 1e-4, card=None) -> dict:
    """Phase 8, a main path: ``warmup`` then ``iters`` timed training steps
    (``step_indices``: batch gathered on the device through K2, heads
    through K3) from the port's own initialisation. Exactly one K2, K3-fwd
    and K3-bwd launch per timed step on the card; finite metrics; the
    parameters change. Host clock around steps that end in a
    synchronise."""
    t0 = time.perf_counter()
    device = torch.device(device)
    trainer = make_trainer(device, dataset, True, n_res_blocks=n_res_blocks)
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
    _expect_launches("train", counts,
                     {"k1": 0, "k2": n, "k3_fwd": n, "k3_bwd": n})
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
    _line(8, "train", t0, clock="host_clock_after_sync",
          card=json.dumps(card), batch=batch, steps=iters,
          step_ms=f"{step_ms:.3f}",
          samples_per_s=f"{out['samples_per_s']:.2f}",
          launches=json.dumps(counts),
          elbo_first_last=f"{out['elbo'][0]:.4f},{out['elbo'][-1]:.4f}")
    return out


def train_parity(device, dataset, batch: int = TRAIN_BATCH,
                 n_res_blocks: int = N_RES_BLOCKS) -> dict:
    """Phase 8b: one step with the kernels (K2, K3) against one with the
    plain versions (``use_kernel=False``, cuDNN heads) from the same
    initialisation, batch and latent noise: the loss to STEP_LOSS_RTOL,
    every parameter's gradient to STEP_GRAD_TOL of its largest entry (with
    the STEP_GRAD_FLOOR)."""
    t0 = time.perf_counter()
    device = torch.device(device)
    idx = dataset.sample_indices(np.random.default_rng(2), batch)
    hz = dataset.tile_size // 32
    eps = torch.randn((1, batch, 1, hz, hz),
                      generator=torch.Generator().manual_seed(3))
    runs = []
    for fused, use_kernel in ((True, True), (False, False)):
        trainer = make_trainer(device, dataset, fused, use_kernel=use_kernel,
                           n_res_blocks=n_res_blocks)
        m = trainer.step_indices(idx, 1e-4, eps=eps)
        names = [n for n, p in trainer.model.named_parameters()
                 if p.requires_grad]
        runs.append((float(m["elbo"]), dict(zip(names, (
            p.grad.detach().clone() for p in trainer.params)))))
        del trainer
    (loss_k, grads_k), (loss_p, grads_p) = runs
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    top = max(g.abs().max().item() for g in grads_p.values())
    grad_errs = {n: (grads_k[n] - g).abs().max().item()
                 / max(g.abs().max().item(), STEP_GRAD_FLOOR * top)
                 for n, g in grads_p.items()}
    worst = max(grad_errs, key=grad_errs.get)
    worst5 = ", ".join(
        f"{n}: {grad_errs[n]:.2e} (max|g| {grads_p[n].abs().max():.2e})"
        for n in sorted(grad_errs, key=grad_errs.get)[-5:])
    if not (loss_err <= STEP_LOSS_RTOL
            and grad_errs[worst] <= STEP_GRAD_TOL):
        raise AssertionError(f"kernels-vs-plain step: loss rel err "
                             f"{loss_err:.3e}; largest gradient entry "
                             f"{top:.3e}; worst gradients {worst5}")
    print(f"  worst gradients (max|g| of all {top:.2e}): {worst5}",
          flush=True)
    _line(8, "train_parity", t0, elbo_kernels=f"{loss_k:.6f}",
          elbo_plain=f"{loss_p:.6f}", loss_rel_err=f"{loss_err:.3e}",
          worst_grad=worst, worst_grad_rel_err=f"{grad_errs[worst]:.3e}",
          params=len(grad_errs))
    return {"loss_rel_err": loss_err, "worst_grad": worst,
            "worst_grad_rel_err": grad_errs[worst]}


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


def kernels_record(checks: list, paint: dict, timing: dict, gather: dict,
                   heads: dict, training: dict) -> dict:
    """The ``{"kernels": [...]}`` record of the run: K1 at the main path's
    dtype (f32), its bf16 numbers beside it; K2, K3-fwd and K3-bwd with
    their launches in the timed training steps."""
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
        k3("head_stack_bwd", "k3_bwd", K3_BWD_REPLACES)]}
