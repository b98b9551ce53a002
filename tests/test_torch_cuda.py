"""The port on the card: K1 (csrc/res_block.cu), K2 (csrc/gather_tiles.cu),
K3 (csrc/head_stack.cu, forward and backward) and K4 (csrc/conv_bn.cu: stats,
fwd, bwd1, bwd2) against their plain versions,
the fused painter on CUDA against the same painter on the CPU and the golden
(the CVAE and the CGAN, whose K1 runs at slope 0.2), whole-plane painting,
and training steps with the kernels against steps with the plain versions.

Every test here needs a CUDA device and skips without one. The file imports
only torch, numpy, pytest and the port, so it runs on the machine with the
card, which has no JAX; there, skip the JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py -q

Tolerances: f32 K1 differs from the plain version only by summation order
(max|diff| <= 1e-4 max|plain|); bf16 also by where the intermediate rounds
(2e-2); the painter by the golden test's own rtol 5e-3. K2 is a copy: bit
for bit. K3's outputs, the u1 it keeps and dx differ by summation order
(1e-4 of the largest entry), its weight and slope gradients sum over every
pixel (1e-3); its backward is compared with the plain backward given the
kernel's u1, on a cotangent that reaches no u2 within summation noise of
PReLU's kink, where the two may take different branches. In bf16 (x, y,
dy, dx bf16) K3's outputs and gradients to 2e-2 of their largest entry (a
sum in another order rounds the other way next to a bf16 boundary) and u1
(f32) to 1e-4 (``smoke.K3_TOL_BF16``).
K4 as ``smoke.K4_TOL`` (summation order: 1e-4 for y, the statistics and dx,
1e-3 for the sums over every pixel); its backward (3xTF32 on the tensor
cores) on the raw cotangent, the plain version taking K4's statistics and
the forward's ReLU mask (y > 0 of K4-fwd), as the kernels do. K4-stats'
u equals K4-bwd1's bit for bit (one mainloop), and K4-fwd writes y over it
in place, bit for bit as the plain affine + ReLU of that u. In bf16 (x, w,
y, dy, dx and dW bf16; u and the statistics f32) K4 as
``smoke.K4_TOL_BF16``: y, dx and dW to 2e-2 (one bf16 step), u, mean and
var to 1e-4, dgamma and dbeta to 1e-3; K4-stats' u equals K4-bwd1's bit
for bit, and K4-fwd's bf16 y is bit for bit the plain version of that u.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from baryon_painter_tpu_torch import smoke
from baryon_painter_tpu_torch.ops import conv_bn as k4
from baryon_painter_tpu_torch.ops import gather as k2
from baryon_painter_tpu_torch.ops import head_stack as k3
from baryon_painter_tpu_torch.ops import res_block as k1

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: K1 has no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _max_rel_err(got, want):
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (3, 13, 21, 12),
                                   (2, 64, 64, 128), (1, 9, 7, 128),
                                   (1, 8, 20, 124)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("slopes", [(0.0, 0.0), (0.2, 0.2), (0.0, 0.2)])
def test_kernel_matches_plain_version_f32(cuda_device, shape, slopes):
    """Whole and ragged (masked) tiles; C a multiple of the K chunk or
    zero-padded to one; C near the 128 channels a block computes."""
    args = smoke.k1_inputs(shape, torch.float32, cuda_device)
    before = k1.res_block_infer.launches
    got = k1.res_block_infer(*args, inner_slope=slopes[0],
                             outer_slope=slopes[1])
    want = k1.res_block_infer_ref(*args, inner_slope=slopes[0],
                                  outer_slope=slopes[1])
    torch.cuda.synchronize()
    assert k1.res_block_infer.launches == before + 1
    assert got.shape == want.shape and got.dtype == torch.float32
    assert _max_rel_err(got, want) <= 1e-4


@pytest.mark.parametrize("shape", [(2, 64, 64, 128), (3, 13, 21, 12)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_matches_plain_version_bf16(cuda_device, shape):
    args = smoke.k1_inputs(shape, torch.bfloat16, cuda_device)
    got = k1.res_block_infer(*args, inner_slope=0.2, outer_slope=0.2)
    want = k1.res_block_infer_ref(*args, inner_slope=0.2, outer_slope=0.2)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    assert _max_rel_err(got, want) <= 2e-2


def test_kernel_runs_on_the_current_stream(cuda_device):
    args = smoke.k1_inputs((2, 16, 16, 8), torch.float32, cuda_device)
    want = k1.res_block_infer_ref(*args)
    stream = torch.cuda.Stream()
    with torch.cuda.stream(stream):
        got = k1.res_block_infer(*args)
    stream.synchronize()
    assert _max_rel_err(got, want) <= 1e-4


def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    args = smoke.k1_inputs((1, 8, 8, 6), torch.float32, cuda_device)
    with pytest.raises(ValueError, match="multiple of 4"):
        k1.res_block_infer(*args)
    args = smoke.k1_inputs((1, 8, 8, 132), torch.float32, cuda_device)
    with pytest.raises(ValueError, match="channels a block"):
        k1.res_block_infer(*args)
    args = smoke.k1_inputs((1, 8, 8, 8), torch.float32, cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        k1.res_block_infer(args[0].transpose(1, 2), *args[1:])
    with pytest.raises(TypeError):
        k1.res_block_infer(args[0].half(), *args[1:])
    with pytest.raises(ValueError, match="w1"):
        k1.res_block_infer(args[0], args[1].cpu(), *args[2:])


def test_fused_painter_on_the_card_matches_cpu_and_golden(cuda_device):
    from baryon_painter_tpu_torch.painter import CVAEPainter
    repo = Path(smoke.REPO)
    with np.load(smoke.GOLDEN_EPS) as e:
        eps = e["eps_512"]
    tiles = smoke.golden_inputs(512, 1)
    zs = np.zeros(1, np.float32)
    out = {}
    for device in (cuda_device, torch.device("cpu")):
        painter = CVAEPainter(str(repo / smoke.CHECKPOINT),
                              fused_inference=True, device=device)
        before = k1.res_block_infer.launches
        out[device.type] = painter.paint_batch(tiles, zs, eps=eps).cpu()
        launched = k1.res_block_infer.launches - before
        assert launched == (4 if device.type == "cuda" else 0)
    with np.load(repo / smoke.GOLDENS) as g:
        want = g["cvae_512"].astype(np.float32)
    scale = np.abs(want).mean()
    for got in out.values():
        np.testing.assert_allclose(got.numpy(), want, rtol=5e-3,
                                   atol=5e-3 * scale)
    np.testing.assert_allclose(out["cuda"].numpy(), out["cpu"].numpy(),
                               rtol=1e-3, atol=1e-3 * scale)


def _stacks(device, f=2, z=2, s100=3, s150=2, g=64, seed=0):
    rng = np.random.default_rng(seed)
    mk = lambda s: torch.as_tensor(
        rng.standard_normal((f, z, s, g, g)).astype(np.float32),
        device=device)
    return mk(s100), mk(s150)


def _digits(b, z, s100, s150, n_tile, seed=1):
    rng = np.random.default_rng(seed)
    cols = [z, 8, 8, s100, n_tile, n_tile, s150, n_tile, n_tile]
    return np.stack([rng.integers(0, c, b) for c in cols], 1).astype(
        np.int32)


@pytest.mark.parametrize("tile,g", [(32, 64), (16, 64), (4, 12)])
def test_k2_matches_plain_version_bit_for_bit(cuda_device, tile, g):
    d100, d150 = _stacks(cuda_device, g=g)
    digits = _digits(7, 2, 3, 2, g // tile)
    before = k2.gather_tiles.launches
    got = k2.gather_tiles(d100, d150, digits, tile)
    want = k2.gather_tiles_ref(d100, d150, digits, tile)
    torch.cuda.synchronize()
    assert k2.gather_tiles.launches == before + 1
    assert got.shape == (7, 2, 2, tile, tile)
    assert torch.equal(got, want)


def test_k2_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    d100, d150 = _stacks(cuda_device)
    bad = _digits(2, 2, 3, 2, 2)
    bad[1, 7] = 2                                  # tx150 past the stack
    with pytest.raises(IndexError, match="tx150"):
        k2.gather_tiles(d100, d150, bad, 32)
    with pytest.raises(ValueError, match="multiples of 4"):
        k2.gather_tiles(d100, d150, _digits(2, 2, 3, 2, 2), 30)
    with pytest.raises(TypeError):
        k2.gather_tiles(d100.double(), d150.double(),
                        _digits(2, 2, 3, 2, 2), 32)


def test_device_cache_on_the_card_matches_the_cpu(cuda_device):
    ds = smoke.training_data(tile=32)
    from baryon_painter_tpu_torch.data.device_cache import DeviceStackCache
    digits = None
    out = {}
    for device in (cuda_device, torch.device("cpu")):
        cache = DeviceStackCache(ds, device=device)
        if digits is None:
            digits = cache.digits(ds.sample_indices(
                np.random.default_rng(0), 6))
        out[device.type] = [t.cpu() for t in cache.gather(digits)]
    for a, b in zip(out["cuda"], out["cpu"]):
        assert torch.equal(a, b)


@pytest.mark.parametrize("shape", [(2, 32, 32), (3, 37, 45), (1, 16, 16),
                                   (1, 12, 20), (4, 512, 512)],
                         ids=lambda s: "x".join(map(str, s)))
def test_k3_matches_plain_version(cuda_device, shape):
    """Whole and ragged tiles, one tile, a partial tile at every image edge
    (1, 12, 20) and the training resolution: K3-fwd's y and kept u1, and
    K3-bwd from that u1 against the plain backward given the same u1; the
    cotangent zeroed where it would reach u2's kink
    (``smoke.kink_free_cotangent``). Without u1 kept K3-fwd gives the same
    y."""
    x, w1, w2, w3, al, dy = smoke.head_inputs(*shape, cuda_device)
    dy, _ = smoke.kink_free_cotangent(x, w1, w2, w3, al, dy)
    f0, b0 = k3.head_stack_fwd.launches, k3.head_stack_bwd.launches
    kept0 = k3.head_stack_fwd.kept_u1
    y, u1 = k3.head_stack_fwd(x, w1, w2, w3, al, keep_u1=True)
    y_paint = k3.head_stack_fwd(x, w1, w2, w3, al)
    got = (y, u1, *k3.head_stack_bwd(x, w1, w2, w3, al, dy, u1=u1))
    want = (*k3.head_stack_ref(x, w1, w2, w3, al, keep_u1=True),
            *k3.head_stack_bwd_ref(x, w1, w2, w3, al, dy, u1=u1))
    torch.cuda.synchronize()
    assert k3.head_stack_fwd.launches == f0 + 2
    assert k3.head_stack_fwd.kept_u1 == kept0 + 1
    assert k3.head_stack_bwd.launches == b0 + 1
    assert torch.equal(y_paint, y)
    for name, a, b in zip(smoke.K3_TOL, got, want):
        assert a.shape == b.shape, name
        assert _max_rel_err(a, b) <= smoke.K3_TOL[name], name


def test_k3_autograd_on_the_card_matches_autograd_of_the_plain_version(
        cuda_device):
    """head_stack under autograd keeps u1 (one K3-fwd launch writing it) and
    its backward is one K3-bwd launch from that u1."""
    args = smoke.head_inputs(2, 48, 32, cuda_device, seed=3)
    dy, _ = smoke.kink_free_cotangent(*args)
    grads = []
    kept0, b0 = k3.head_stack_fwd.kept_u1, k3.head_stack_bwd.launches
    for fn in (k3.head_stack, k3.head_stack_ref):
        leaves = [a.clone().requires_grad_() for a in args[:-1]]
        (fn(*leaves) * dy).sum().backward()
        grads.append([a.grad for a in leaves])
    assert k3.head_stack_fwd.kept_u1 == kept0 + 1
    assert k3.head_stack_bwd.launches == b0 + 1
    for name, a, b in zip(("dx", "dw1", "dw2", "dw3", "dalphas"), *grads):
        assert _max_rel_err(a, b) <= smoke.K3_TOL[name], name


def test_k3_keeps_no_u1_without_autograd(cuda_device):
    x, w1, w2, w3, al, _ = smoke.head_inputs(1, 20, 20, cuda_device)
    kept0, f0 = k3.head_stack_fwd.kept_u1, k3.head_stack_fwd.launches
    leaves = [t.requires_grad_() for t in (w1, w2, w3, al)]
    with torch.inference_mode():
        k3.head_stack(x, *leaves)
    with torch.no_grad():
        k3.head_stack(x, *leaves)
    assert k3.head_stack_fwd.launches == f0 + 2
    assert k3.head_stack_fwd.kept_u1 == kept0


def test_k3_bwd_is_deterministic(cuda_device):
    """K3-bwd's weight gradients are per-block partials summed in torch, no
    atomics: two calls are bit-identical (a row of 19 tiles, so two blocks
    walk each tile row)."""
    x, w1, w2, w3, al, dy = smoke.head_inputs(2, 40, 300, cuda_device, seed=5)
    _, u1 = k3.head_stack_fwd(x, w1, w2, w3, al, keep_u1=True)
    first = k3.head_stack_bwd(x, w1, w2, w3, al, dy, u1=u1)
    again = k3.head_stack_bwd(x, w1, w2, w3, al, dy, u1=u1)
    for name, a, b in zip(("dx", "dw1", "dw2", "dw3", "dalphas"), first,
                          again):
        assert torch.equal(a, b), name


def test_k3_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    x, w1, w2, w3, al, dy = smoke.head_inputs(1, 16, 16, cuda_device)
    with pytest.raises(TypeError, match="float32"):
        k3.head_stack_fwd(x.half(), w1, w2, w3, al)
    with pytest.raises(TypeError, match="w1"):
        k3.head_stack_fwd(x.bfloat16(), w1.bfloat16(), w2, w3, al)
    with pytest.raises(ValueError, match="16"):
        k3.head_stack_fwd(x[..., :8], w1[..., :8, :], w2, w3, al)
    with pytest.raises(ValueError, match="w1"):
        k3.head_stack_fwd(x, w1[:1], w2, w3, al)
    _, u1 = k3.head_stack_fwd(x, w1, w2, w3, al, keep_u1=True)
    with pytest.raises(ValueError, match="dy"):
        k3.head_stack_bwd(x, w1, w2, w3, al, dy[:, :1], u1=u1)
    with pytest.raises(ValueError, match="u1 is required"):
        k3.head_stack_bwd(x, w1, w2, w3, al, dy)
    with pytest.raises(ValueError, match="u1"):
        k3.head_stack_bwd(x, w1, w2, w3, al, dy, u1=u1[..., :8])
    with pytest.raises(TypeError, match="u1"):
        k3.head_stack_bwd(x, w1, w2, w3, al, dy, u1=u1.double())


@pytest.mark.parametrize("shape", [(2, 32, 32), (3, 37, 45), (1, 12, 20),
                                   (4, 512, 512)],
                         ids=lambda s: "x".join(map(str, s)))
def test_k3_bf16_matches_plain_version(cuda_device, shape):
    """K3-fwd and K3-bwd in bf16 against the plain bf16 versions, as the
    f32 test holds them, with the bf16 tolerances; each launch counted in
    bf16."""
    x, w1, w2, w3, al, dy = smoke.head_inputs(*shape, cuda_device)
    x, dy = x.bfloat16(), dy.bfloat16()
    dy, _ = smoke.kink_free_cotangent(x, w1, w2, w3, al, dy,
                                      dtype=torch.bfloat16)
    f0, b0 = k3.head_stack_fwd.bf16_launches, k3.head_stack_bwd.bf16_launches
    y, u1 = k3.head_stack_fwd(x, w1, w2, w3, al, keep_u1=True)
    y_paint = k3.head_stack_fwd(x, w1, w2, w3, al)
    got = (y, u1, *k3.head_stack_bwd(x, w1, w2, w3, al, dy, u1=u1))
    want = (*k3.head_stack_ref(x, w1, w2, w3, al, keep_u1=True),
            *k3.head_stack_bwd_ref(x, w1, w2, w3, al, dy, u1=u1))
    torch.cuda.synchronize()
    assert k3.head_stack_fwd.bf16_launches == f0 + 2
    assert k3.head_stack_bwd.bf16_launches == b0 + 1
    assert torch.equal(y_paint, y)
    assert y.dtype == got[2].dtype == torch.bfloat16
    assert u1.dtype == torch.float32
    for name, a, b in zip(smoke.K3_TOL_BF16, got, want):
        assert a.shape == b.shape and a.dtype == b.dtype, name
        assert _max_rel_err(a, b) <= smoke.K3_TOL_BF16[name], name


def test_k3_bf16_bwd_is_deterministic(cuda_device):
    x, w1, w2, w3, al, dy = smoke.head_inputs(2, 40, 300, cuda_device, seed=5)
    x, dy = x.bfloat16(), dy.bfloat16()
    _, u1 = k3.head_stack_fwd(x, w1, w2, w3, al, keep_u1=True)
    a = k3.head_stack_bwd(x, w1, w2, w3, al, dy, u1=u1)
    b = k3.head_stack_bwd(x, w1, w2, w3, al, dy, u1=u1)
    for s, t in zip(a, b):
        assert torch.equal(s, t)


def test_bf16_training_and_painting_on_the_card(cuda_device):
    """bf16 training steps launch K2 and K3 in bf16 once each a step and
    match the plain bf16 step (``smoke.train_parity_bf16``); the bf16
    paint of the golden input launches 4 bf16 K1 and 1 bf16 K3-fwd and
    meets the committed JAX bf16 reference (``smoke.paint_bf16``)."""
    ds = smoke.training_data(tile=64)
    out = smoke.train(cuda_device, ds, batch=4, warmup=1, iters=3,
                      n_res_blocks=1, dtype=torch.bfloat16)
    no_k4 = {f"k4_{k}": 0 for k in smoke.K4_KERNELS}
    assert out["bf16_launches"] == {"k1": 0, "k3_fwd": 3, "k3_bwd": 3,
                                    **no_k4}
    res = smoke.train_parity_bf16(cuda_device, ds, batch=4, n_res_blocks=1)
    assert res["ratio"] <= smoke.BF16_STEP_RATIO
    paint = smoke.paint_bf16(cuda_device, n_tiles=2, warmup=1, iters=1)
    assert paint["bf16_launches"] == {"k1": 4, "k3_fwd": 1, "k3_bwd": 0,
                                      **no_k4}
    assert paint["d_jax_bf16"] <= paint["limit"]


def test_training_steps_with_kernels_match_plain_steps(cuda_device):
    """One launch of K2, K3-fwd and K3-bwd per step; the loss and every
    gradient as with the plain versions, from the same start."""
    ds = smoke.training_data(tile=64)
    res = smoke.train_parity(cuda_device, ds, batch=4, n_res_blocks=1)
    assert res["loss_rel_err"] <= smoke.STEP_LOSS_RTOL
    out = smoke.train(cuda_device, ds, batch=4, warmup=1, iters=3,
                      n_res_blocks=1)
    assert out["launches"] == {"k1": 0, "k2": 3, "k3_fwd": 3, "k3_bwd": 3,
                               "k4_stats": 0, "k4_fwd": 0, "k4_bwd1": 0,
                               "k4_bwd2": 0}


def test_fused_heads_painter_on_the_card(cuda_device):
    """4 K1 and 1 K3-fwd launches, and no u1 kept (phase 9 raises if one
    is)."""
    out = smoke.paint_fused_heads(cuda_device, n_tiles=2, warmup=0, iters=1)
    assert out["launches"] == 4 and out["k3_fwd_launches"] == 1
    assert k3.head_stack_fwd.kept_u1 == 0
    assert out["worst_err_over_tol"] <= 1.0


def _k4_site(transposed, cin, cout, h, k=None, s=2):
    if transposed:
        return dict(transposed=True, cin=cin, cout=cout, k=2 * s, stride=s,
                    padding=s // 2, h=h)
    return dict(transposed=False, cin=cin, cout=cout, k=k, stride=1,
                padding=(k - 1) // 2, h=h)


def _k4_run(site, batch, device, seed=0, dtype=torch.float32):
    """Kernels and plain versions on the same inputs: {name: (got, want)}
    and the launches counted (in bf16 the bf16 launches). The backward on
    the raw cotangent; its plain version takes K4's statistics and
    K4-fwd's ReLU mask, as the kernels do. x, w and dy in ``dtype``."""
    x, w, gamma, beta, dy = smoke.k4_inputs(site, batch, smoke.TRAIN_TILE,
                                            device, seed)
    x, w, dy = x.to(dtype), w.to(dtype), dy.to(dtype)
    kw = {k: site[k] for k in ("transposed", "stride", "padding")}
    count = dy.shape[0] * dy.shape[2] * dy.shape[3]
    y_r, mean_r, var_r = k4.conv_bn_relu_ref(x, w, gamma, beta, **kw)
    counter = "bf16_launches" if dtype == torch.bfloat16 else "launches"
    fns = (k4.conv_bn_stats, k4.conv_bn_fwd, k4.conv_bn_bwd1,
           k4.conv_bn_bwd2)
    before = {f: getattr(f, counter) for f in fns}
    s1, s2, u_s = k4.conv_bn_stats(x, w, **kw)
    mean, var = k4.batch_stats(s1, s2, count)
    inv, a, b = k4.bn_affine(gamma, beta, mean, var)
    u_stats = u_s.clone()
    y = k4.conv_bn_fwd(u_s, a, b, dtype)
    g1, g2, u = k4.conv_bn_bwd1(x, w, mean, inv, y, dy, **kw)
    dx, dw = k4.conv_bn_bwd2(x, w, a, mean, inv, g1 / count, g2 / count, u,
                             y, dy, **kw)
    want = k4.conv_bn_relu_bwd_ref(x, w, gamma, beta, mean, var, dy,
                                   active=y > 0, **kw)
    torch.cuda.synchronize()
    launches = {f: getattr(f, counter) - n for f, n in before.items()}
    u_r = k4.conv_bn_stats_ref(x, w, **kw)[2]
    got = {"y": (y, y_r), "mean": (mean, mean_r), "var": (var, var_r),
           "u": (u, u_r), "u_stats": (u_stats, u_r)}
    got.update(zip(("dx", "dw", "dgamma", "dbeta"),
                   zip((dx, dw, g2, g1), want)))
    return got, launches


@pytest.mark.parametrize("site,batch", [
    (_k4_site(False, 3, 16, 40, k=5), 2),      # small, ragged tiles
    (_k4_site(False, 5, 20, 37, k=3), 1),      # two channel groups
    (_k4_site(False, 3, 16, 512, k=5), 4),     # site A's shape
    (_k4_site(True, 12, 18, 9), 2),            # small transposed, ragged
    (_k4_site(True, 128, 64, 64), 4),          # site B's shape
    (_k4_site(True, 32, 16, 256), 4),          # site D's shape
    (_k4_site(False, 4, 12, 29, k=1), 2),      # the other "same" kernels
    (_k4_site(False, 6, 16, 33, k=7), 2),
    (_k4_site(True, 6, 10, 11, s=4), 2),       # stride 4, ragged
    (_k4_site(True, 16, 8, 40, s=4), 2),       # stride 4, many bwd2 rows
], ids=["same_small", "same_groups", "same_512", "transp_small",
        "transp_64", "transp_256", "same_k1", "same_k7", "transp_s4_small",
        "transp_s4_40"])
def test_k4_matches_plain_version(cuda_device, site, batch):
    got, launches = _k4_run(site, batch, cuda_device)
    assert set(launches.values()) == {1}
    for name, (a, b) in got.items():
        assert a.shape == b.shape, name
        # u, the conv that K4-stats writes and K4-bwd1 keeps, to y's
        # tolerance
        tol = smoke.K4_TOL["y" if name.startswith("u") else name]
        assert _max_rel_err(a, b) <= tol, name


K4_SHAPES = [
    (_k4_site(False, 3, 16, 40, k=5), 2), (_k4_site(False, 5, 20, 37, k=3), 1),
    (_k4_site(False, 3, 16, 512, k=5), 4), (_k4_site(True, 12, 18, 9), 2),
    (_k4_site(True, 128, 64, 64), 4), (_k4_site(True, 32, 16, 256), 4),
    (_k4_site(False, 4, 12, 29, k=1), 2), (_k4_site(False, 6, 16, 33, k=7), 2),
    (_k4_site(True, 6, 10, 11, s=4), 2), (_k4_site(True, 16, 8, 40, s=4), 2)]


@pytest.mark.parametrize("site,batch", K4_SHAPES,
                         ids=["same_small", "same_groups", "same_512",
                              "transp_small", "transp_64", "transp_256",
                              "same_k1", "same_k7", "transp_s4_small",
                              "transp_s4_40"])
def test_k4_bf16_matches_plain_version(cuda_device, site, batch):
    """The shapes of ``test_k4_matches_plain_version`` in bf16 (odd Cin and
    Cout, ragged tiles, widths that are not a multiple of 8, two channel
    groups): one bf16 launch of each kernel, y, dx and dW bf16 within a
    bf16 step, u and the statistics f32 within summation order."""
    got, launches = _k4_run(site, batch, cuda_device, dtype=torch.bfloat16)
    assert set(launches.values()) == {1}
    for name, (a, b) in got.items():
        assert a.shape == b.shape and a.dtype == b.dtype, name
        want_dt = (torch.bfloat16 if name in ("y", "dx", "dw")
                   else torch.float32)
        assert a.dtype == want_dt, name
        tol = smoke.K4_TOL_BF16["u" if name.startswith("u") else name]
        assert _max_rel_err(a, b) <= tol, name


@pytest.mark.parametrize("site", [
    _k4_site(False, 3, 16, 40, k=5), _k4_site(False, 5, 20, 37, k=3),
    _k4_site(False, 4, 12, 29, k=1), _k4_site(False, 6, 16, 33, k=7),
    _k4_site(True, 12, 18, 9), _k4_site(True, 6, 70, 11, s=4),
], ids=["same_k5", "same_k3", "same_k1", "same_k7", "transp_s2",
        "transp_s4_two_groups"])
def test_k4_bf16_stats_u_is_bwd1_u_bit_for_bit(cuda_device, site):
    """One bf16 mainloop for K4-stats and K4-bwd1: the f32 u behind the
    batch statistics and the forward's bf16 y is the u of the backward;
    K4-fwd's bf16 y is bit for bit the plain bf16 affine + ReLU of it, and
    leaves u as it was."""
    x, w, gamma, beta, dy = smoke.k4_inputs(site, 2, smoke.TRAIN_TILE,
                                            cuda_device)
    x, w, dy = x.bfloat16(), w.bfloat16(), dy.bfloat16()
    kw = {k: site[k] for k in ("transposed", "stride", "padding")}
    count = dy.shape[0] * dy.shape[2] * dy.shape[3]
    s1, s2, u = k4.conv_bn_stats(x, w, **kw)
    mean, var = k4.batch_stats(s1, s2, count)
    inv, a, b = k4.bn_affine(gamma, beta, mean, var)
    u_stats = u.clone()
    y = k4.conv_bn_fwd(u, a, b, torch.bfloat16)
    assert y.dtype == torch.bfloat16 and torch.equal(u, u_stats)
    assert torch.equal(y, k4.conv_bn_fwd_ref(u_stats, a, b, torch.bfloat16))
    _, _, u_bwd1 = k4.conv_bn_bwd1(x, w, mean, inv, y, dy, **kw)
    assert torch.equal(u_stats, u_bwd1)


def test_k4_bf16_fwd_takes_any_plane_length(cuda_device):
    """bf16 y from planes whose length is not a multiple of 4 (element by
    element) and from ones that are (4 at a time): bit for bit the plain
    version. A block covers 4096 elements of a plane, so 4097 and 8195
    (hw % 4 != 0 with hw // 4 a multiple of 1024) need a block for their
    last 1-3 elements; y's memory is filled with NaN first (through the
    caching allocator), so an element never written shows."""
    g = torch.Generator(device=cuda_device).manual_seed(1)
    for hw in ((7, 9), (1, 3), (3, 1367), (16, 16), (64, 4100), (17, 241),
               (1, 4097), (1, 8195), (1, 4096), (1, 4095)):
        u = torch.randn((2, 5) + hw, generator=g, device=cuda_device)
        a = torch.rand(5, generator=g, device=cuda_device) + 0.5
        b = torch.randn(5, generator=g, device=cuda_device)
        torch.full_like(u, float("nan"), dtype=torch.bfloat16)
        y = k4.conv_bn_fwd(u, a, b, torch.bfloat16)
        assert torch.equal(y, k4.conv_bn_fwd_ref(u, a, b, torch.bfloat16)), \
            hw


def test_k4_bf16_is_deterministic(cuda_device):
    site = _k4_site(True, 64, 32, 128)
    first, _ = _k4_run(site, 2, cuda_device, dtype=torch.bfloat16)
    again, _ = _k4_run(site, 2, cuda_device, dtype=torch.bfloat16)
    for name in ("mean", "var", "dw", "dgamma", "dbeta", "y", "dx", "u",
                 "u_stats"):
        assert torch.equal(first[name][0], again[name][0]), name


def test_k4_bf16_wrappers_refuse_float16_and_mixed_dtypes(cuda_device):
    site = _k4_site(True, 16, 8, 24)
    x, w, gamma, beta, dy = smoke.k4_inputs(site, 2, smoke.TRAIN_TILE,
                                            cuda_device)
    kw = dict(transposed=True, stride=2, padding=1)
    for xx, ww in ((x.half(), w.half()), (x.bfloat16(), w),
                   (x, w.bfloat16())):
        with pytest.raises(TypeError):
            k4.conv_bn_stats(xx, ww, **kw)
    _, _, u = k4.conv_bn_stats(x.bfloat16(), w.bfloat16(), **kw)
    with pytest.raises(TypeError, match="float16"):
        k4.conv_bn_fwd(u, gamma, beta, torch.float16)
    with pytest.raises(TypeError, match="float32"):
        k4.conv_bn_fwd(u.bfloat16(), gamma, beta, torch.bfloat16)
    y = k4.conv_bn_fwd(u, gamma, beta, torch.bfloat16)
    with pytest.raises(TypeError):   # dy in another dtype than x
        k4.conv_bn_bwd1(x.bfloat16(), w.bfloat16(), gamma, beta, y, dy,
                        **kw)


def test_training_steps_with_bf16_k4_match_plain_steps(cuda_device):
    """At 64^2 three bf16 K4 calls a step (the up-convs), every K4 launch
    in bf16; the bf16 step with every kernel within BF16_STEP_RATIO of the
    plain bf16 step's distance from the plain f32 step (phase 15b)."""
    ds = smoke.training_data(tile=64)
    out = smoke.train(cuda_device, ds, batch=4, warmup=1, iters=2,
                      n_res_blocks=1, fused_train_conv=True,
                      dtype=torch.bfloat16)
    k4_six = {f"k4_{k}": 6 for k in smoke.K4_KERNELS}
    assert out["bf16_launches"] == {"k1": 0, "k3_fwd": 2, "k3_bwd": 2,
                                    **k4_six}
    assert out["launches"] == {"k1": 0, "k2": 2, "k3_fwd": 2, "k3_bwd": 2,
                               **k4_six}
    res = smoke.train_parity_bf16(cuda_device, ds, batch=4, n_res_blocks=1,
                                  fused_train_conv=True)
    assert res["ratio"] <= smoke.BF16_STEP_RATIO


@pytest.mark.parametrize("site", [
    _k4_site(False, 3, 16, 40, k=5), _k4_site(False, 5, 20, 37, k=3),
    _k4_site(False, 4, 12, 29, k=1), _k4_site(False, 6, 16, 33, k=7),
    _k4_site(True, 12, 18, 9), _k4_site(True, 6, 70, 11, s=4),
], ids=["same_k5", "same_k3", "same_k1", "same_k7", "transp_s2",
        "transp_s4_two_groups"])
def test_k4_stats_u_is_bwd1_u_bit_for_bit(cuda_device, site):
    """One mainloop for K4-stats and K4-bwd1: the u behind the batch
    statistics and the forward's ReLU mask is the u of the backward; and
    K4-fwd writes y over it in place, bit for bit the plain affine + ReLU
    of that u."""
    x, w, gamma, beta, dy = smoke.k4_inputs(site, 2, smoke.TRAIN_TILE,
                                            cuda_device)
    kw = {k: site[k] for k in ("transposed", "stride", "padding")}
    count = dy.shape[0] * dy.shape[2] * dy.shape[3]
    s1, s2, u = k4.conv_bn_stats(x, w, **kw)
    mean, var = k4.batch_stats(s1, s2, count)
    inv, a, b = k4.bn_affine(gamma, beta, mean, var)
    u_stats = u.clone()
    y = k4.conv_bn_fwd(u, a, b)
    assert y.data_ptr() == u.data_ptr()
    assert torch.equal(y, k4.conv_bn_fwd_ref(u_stats, a, b))
    _, _, u_bwd1 = k4.conv_bn_bwd1(x, w, mean, inv, y, dy, **kw)
    assert torch.equal(u_stats, u_bwd1)


def test_k4_fwd_takes_any_plane_length_and_offset(cuda_device):
    """Planes whose length is not a multiple of 4 and u starting past a
    16-byte boundary (a view into a larger buffer): K4-fwd in place, bit
    for bit the plain version, nothing outside u written."""
    g = torch.Generator(device=cuda_device).manual_seed(0)
    for hw, off in (((7, 9), 0), ((7, 9), 3), ((1, 3), 1), ((3, 1367), 2)):
        n, c = 2, 5
        size = n * c * hw[0] * hw[1]
        flat = torch.randn(size + 8, generator=g, device=cuda_device)
        before = flat.clone()
        u = flat[off:off + size].view(n, c, *hw)
        a = torch.rand(c, generator=g, device=cuda_device) + 0.5
        b = torch.randn(c, generator=g, device=cuda_device)
        want = k4.conv_bn_fwd_ref(u.clone(), a, b)
        y = k4.conv_bn_fwd(u, a, b)
        assert torch.equal(y, want) and y.data_ptr() == u.data_ptr()
        assert torch.equal(flat[:off], before[:off])
        assert torch.equal(flat[off + size:], before[off + size:])


def test_k4_is_deterministic(cuda_device):
    site = _k4_site(True, 64, 32, 128)
    first, _ = _k4_run(site, 2, cuda_device)
    again, _ = _k4_run(site, 2, cuda_device)
    for name in ("mean", "var", "dw", "dgamma", "dbeta", "y", "dx", "u",
                 "u_stats"):
        assert torch.equal(first[name][0], again[name][0]), name


def test_k4_autograd_on_the_card_matches_autograd_of_the_plain_version(
        cuda_device):
    site = _k4_site(True, 16, 8, 24)
    x, w, gamma, beta, dy = smoke.k4_inputs(site, 2, smoke.TRAIN_TILE,
                                            cuda_device, seed=3)
    kw = dict(transposed=True, stride=2, padding=1)
    y, mean, var = k4.conv_bn_relu(x, w, gamma, beta, **kw)
    assert not mean.requires_grad and not var.requires_grad
    leaves = [t.clone().requires_grad_() for t in (x, w, gamma, beta)]
    yk, _, _ = k4.conv_bn_relu(*leaves, **kw)
    (yk * dy).sum().backward()
    y_r, mean_r, var_r = k4.conv_bn_relu_ref(x, w, gamma, beta, **kw)
    want = k4.conv_bn_relu_bwd_ref(x, w, gamma, beta, mean_r, var_r, dy,
                                   active=yk.detach() > 0, **kw)
    assert _max_rel_err(yk, y_r) <= smoke.K4_TOL["y"]
    for name, leaf, b in zip(("dx", "dw", "dgamma", "dbeta"), leaves, want):
        assert _max_rel_err(leaf.grad, b) <= smoke.K4_TOL[name], name


def test_k4_wrapper_raises_on_what_the_kernels_do_not_take(cuda_device):
    site = _k4_site(False, 3, 16, 16, k=5)
    x, w, gamma, beta, _ = smoke.k4_inputs(site, 1, smoke.TRAIN_TILE,
                                           cuda_device)
    kw = dict(transposed=False, stride=1, padding=2)
    with pytest.raises(TypeError, match="float32"):
        k4.conv_bn_relu(x.half(), w.half(), gamma, beta, **kw)
    with pytest.raises(ValueError, match="bias-free"):
        k4.conv_bn_relu(x, w, gamma, beta, bias=torch.zeros_like(gamma),
                        **kw)
    with pytest.raises(ValueError, match="kernels take"):
        k4.conv_bn_stats(x, w, transposed=False, stride=1, padding=1)
    with pytest.raises(ValueError, match="kernels take"):
        k4.conv_bn_stats(x, w, transposed=False, stride=2, padding=2)
    wt = torch.zeros((3, 16, 3, 3), device=cuda_device)
    with pytest.raises(ValueError, match="kernels take"):
        k4.conv_bn_stats(x, wt, transposed=True, stride=2, padding=1)
    # K4-fwd writes over u: a u that is not contiguous raises, uncopied
    u = torch.zeros((1, 16, 16, 32), device=cuda_device)[..., ::2]
    with pytest.raises(ValueError, match="contiguous"):
        k4.conv_bn_fwd(u, gamma, beta)
    with pytest.raises(ValueError, match=r"a must be \(16,\)"):
        k4.conv_bn_fwd(u.contiguous(), gamma[:8], beta)
    # the backward tiles both channel counts (64 a block), so its shared
    # memory stays inside a block's 232448 bytes at any width; what it
    # refuses is a grid past 65535 blocks in z (N x ceil(Cin / 64))
    from baryon_painter_tpu_torch.ops._build import load_library
    for k, s in ((1, 1), (3, 1), (5, 1), (7, 1), (4, 2), (8, 4)):
        for which in range(3):   # bwd1, dx, dW
            for code in (0, 1):   # float32, bfloat16
                assert 0 < load_library().bpt_conv_bn_bwd_smem(
                    4096, 4096, k, s, which, code) <= 232448
    with pytest.raises(ValueError, match="65535"):
        n, cin = 1025, 4096
        wide = torch.zeros((16, cin, 5, 5), device=cuda_device)
        ones = torch.ones(16, device=cuda_device)
        out = torch.zeros((n, 16, 1, 1), device=cuda_device)
        k4.conv_bn_bwd2(torch.zeros((n, cin, 1, 1), device=cuda_device),
                        wide, ones, ones, ones, ones, ones, out, out, out,
                        **kw)


def test_k4_runs_on_the_current_stream(cuda_device):
    site = _k4_site(True, 16, 8, 24)
    x, w, gamma, beta, _ = smoke.k4_inputs(site, 2, smoke.TRAIN_TILE,
                                           cuda_device)
    kw = dict(transposed=True, stride=2, padding=1)
    want = k4.conv_bn_relu_ref(x, w, gamma, beta, **kw)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        got = k4.conv_bn_relu(x, w, gamma, beta, **kw)
    stream.synchronize()
    for a, b in zip(got, want):
        assert _max_rel_err(a, b) <= 1e-4


def test_training_steps_with_k4_match_plain_steps(cuda_device):
    """At 64^2 the input conv fails the space-to-depth rule (h >= 128), so
    three K4 calls a step: the up-convs."""
    ds = smoke.training_data(tile=64)
    res = smoke.train_parity(cuda_device, ds, batch=4, n_res_blocks=1,
                             fused_train_conv=True)
    assert res["loss_rel_err"] <= smoke.STEP_LOSS_RTOL
    out = smoke.train(cuda_device, ds, batch=4, warmup=1, iters=2,
                      n_res_blocks=1, fused_train_conv=True)
    assert out["launches"] == {"k1": 0, "k2": 2, "k3_fwd": 2, "k3_bwd": 2,
                               "k4_stats": 6, "k4_fwd": 6, "k4_bwd1": 6,
                               "k4_bwd2": 6}


# ---------------------------------------------------------------------- #
# the lightcone's resampler and pipeline on the card, with TF32 on: they
# pin f32 themselves (rtol 2e-3, atol 2e-4 * max|scipy|, as
# tests/test_resample.py)


@pytest.fixture
def tf32_on(cuda_device):
    prev = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    yield cuda_device
    (torch.backends.cudnn.allow_tf32,
     torch.backends.cuda.matmul.allow_tf32) = prev


@pytest.mark.parametrize("order", [0, 1, 3, 5])
@pytest.mark.parametrize("mode", ["mirror", "reflect", "wrap"])
@pytest.mark.parametrize("shape,out", [((24, 30), (41, 51)),
                                       ((1211, 1211), (512, 512))],
                         ids=["small", "lightcone_tile"])
def test_resampler_on_the_card_matches_scipy_with_tf32_on(tf32_on, order,
                                                          mode, shape, out):
    from scipy.ndimage import zoom as scipy_zoom

    from baryon_painter_tpu_torch.ops.resample import resize_spline
    x = np.random.default_rng(0).gamma(2.0, 0.5, shape).astype(np.float32)
    got = resize_spline(torch.as_tensor(x, device=tf32_on), out,
                        order=order, mode=mode)
    assert got.device.type == "cuda"
    kw = (dict(mode="grid-wrap", grid_mode=True) if mode == "wrap"
          else dict(mode=mode))
    want = scipy_zoom(x.astype(np.float64),
                      (out[0] / shape[0], out[1] / shape[1]), order=order,
                      **kw)
    assert tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.cpu().numpy(), want, rtol=2e-3,
                               atol=2e-4 * np.abs(want).max())


def test_power_spectrum_on_the_card_matches_the_cpu(cuda_device):
    """The same f32 FFT and per-bin sums on either device: rtol 1e-5."""
    from baryon_painter_tpu_torch.angular_power import pseudo_cl_2d
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (2, 256, 256)).astype(np.float32))
    got = pseudo_cl_2d(x.to(cuda_device), theta_deg=10.0)
    want = pseudo_cl_2d(x, theta_deg=10.0)
    for g, w in zip(got, want):
        assert g.device.type == "cuda"
        np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-5,
                                   atol=1e-5 * w.abs().max().item())


def test_cgan_painter_on_the_card_matches_cpu_and_golden(cuda_device):
    """Both CGAN goldens through K1 at slope 0.2 (9 launches a paint),
    against the same painter on the CPU and the golden, and the unfused
    painter (no launch) against the golden (``smoke.paint_cgan_goldens``);
    the bf16 CGAN paint against the committed JAX bf16 reference
    (``smoke.paint_cgan_bf16``)."""
    out = smoke.paint_cgan_goldens(cuda_device)
    assert [g["launches"] for g in out["goldens"]] == [9, 9]
    assert all(g["worst_err_over_tol"] <= 1.0 and
               g["cudnn_err_over_tol"] <= 1.0 for g in out["goldens"])
    tiles, zs = smoke._cgan_golden_batch()
    card = smoke._cgan_painter(cuda_device, fused_inference=True)
    cpu = smoke._cgan_painter("cpu", fused_inference=True)
    got = card.paint_batch(tiles, zs).cpu()
    want = cpu.paint_batch(tiles, zs)
    assert smoke._golden_ratio(got, want) <= 1.0
    bf16 = smoke.paint_cgan_bf16(cuda_device)
    assert bf16["bf16_launches"]["k1"] == 9


def test_seamless_plane_on_the_card(cuda_device):
    """``paint_plane`` on the card against the CPU at 128^2, both painters
    (the CVAE at the prior mean), within the golden tolerance."""
    from baryon_painter_tpu_torch.parallel import spatial
    plane = smoke.golden_inputs(128, 1)[0]
    for (_, card, _, z_mode), (_, cpu, _, _) in zip(
            smoke._spatial_painters(cuda_device),
            smoke._spatial_painters(torch.device("cpu"))):
        got = spatial.paint_plane(card, plane, 0.5, z_mode=z_mode)
        want = spatial.paint_plane(cpu, plane, 0.5, z_mode=z_mode)
        assert got.device.type == "cuda"
        assert smoke._golden_ratio(got.cpu(), want) <= 1.0


@pytest.mark.parametrize("fn, cin, cout, size", [
    ("conv2d", 1, 1, 16), ("conv2d", 1, 1, 64), ("conv2d", 1, 1, 512),
    ("conv2d", 8, 1, 256), ("conv2d", 2, 8, 512),
    ("conv_transpose2d", 1, 1, 128)])
def test_bf16_convolutions_with_one_channel_on_the_card(cuda_device, fn, cin,
                                                        cout, size):
    """The CVAE's bf16 convolutions with one channel on either side, at the
    painters' shapes (batch 48), against the f64 conv of the same rounded
    operands: within one bf16 step (2e-2 of the largest entry). cuDNN's bf16
    1 -> 1 ``conv2d`` misses by ~100 % (or paints NaN) from 32^2 up, so the
    port runs that one in f32 on the rounded operands (``layers._conv``)."""
    import torch.nn.functional as F

    from baryon_painter_tpu_torch.models import layers
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn((48, cin, size, size), generator=g, device=cuda_device)
    if fn == "conv2d":
        mod = layers.Conv2d(cin, cout, 3, padding=1, bias=False,
                            dtype=torch.bfloat16)
        ref_fn = lambda a, w: F.conv2d(a, w, padding=1)
    else:
        mod = layers.ConvTranspose2d(cin, cout, 4, stride=2, padding=1,
                                     bias=False, dtype=torch.bfloat16)
        ref_fn = lambda a, w: F.conv_transpose2d(a, w, stride=2, padding=1)
    mod = mod.to(cuda_device)
    with torch.no_grad():
        mod.weight.copy_(0.3 * torch.randn(mod.weight.shape, generator=g,
                                           device=cuda_device))
        got = mod(x.to(torch.bfloat16)).double()
        want = ref_fn(x.to(torch.bfloat16).double(),
                      mod.weight.to(torch.bfloat16).double())
    assert torch.isfinite(got).all()
    assert (got - want).abs().max() <= 2e-2 * want.abs().max()
