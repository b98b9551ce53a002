"""The port on the card: K1 (csrc/res_block.cu), K2 (csrc/gather_tiles.cu),
K3 (csrc/head_stack.cu, forward and backward) and K4 (csrc/conv_bn.cu: stats,
fwd, bwd1, bwd2) against their plain versions,
the fused painter on CUDA against the same painter on the CPU and the golden,
and training steps with the kernels against steps with the plain versions.

Every test here needs a CUDA device and skips without one. The file imports
only torch, numpy, pytest and the port, so it runs on the machine with the
card, which has no JAX; there, skip the JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py -q

Tolerances: f32 K1 differs from the plain version only by summation order
(max|diff| <= 1e-4 max|plain|); bf16 also by where the intermediate rounds
(2e-2); the painter by the golden test's own rtol 5e-3. K2 is a copy: bit
for bit. K3's outputs and dx differ by summation order (1e-4 of the largest
entry), its weight and slope gradients sum over every pixel (1e-3); its
backward is compared on a cotangent that reaches no pre-activation within
summation noise of PReLU's kink, where the two may take different branches.
K4 as ``smoke.K4_TOL`` (summation order: 1e-4 for y, the statistics and dx,
1e-3 for the sums over every pixel), its backward on a cotangent zeroed
where a pre-activation lies within ``smoke.KINK_REL`` of ReLU's kink.
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
                                   (1, 8, 8, 232)],
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("slopes", [(0.0, 0.0), (0.2, 0.2), (0.0, 0.2)])
def test_kernel_matches_plain_version_f32(cuda_device, shape, slopes):
    """Whole and ragged (masked) tiles; C/4 dividing the 256 threads or not;
    the widest C that fits the shared memory."""
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
    args = smoke.k1_inputs((1, 8, 8, 256), torch.float32, cuda_device)
    with pytest.raises(ValueError, match="shared memory"):
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
                                   (4, 512, 512)],
                         ids=lambda s: "x".join(map(str, s)))
def test_k3_matches_plain_version(cuda_device, shape):
    """Whole and ragged tiles, one tile, and the training resolution; the
    cotangent zeroed where it would reach PReLU's kink
    (``smoke.kink_free_cotangent``)."""
    x, w1, w2, w3, al, dy = smoke.head_inputs(*shape, cuda_device)
    dy, _ = smoke.kink_free_cotangent(x, w1, w2, w3, al, dy)
    f0, b0 = k3.head_stack_fwd.launches, k3.head_stack_bwd.launches
    got = (k3.head_stack_fwd(x, w1, w2, w3, al),
           *k3.head_stack_bwd(x, w1, w2, w3, al, dy))
    want = (k3.head_stack_ref(x, w1, w2, w3, al),
            *k3.head_stack_bwd_ref(x, w1, w2, w3, al, dy))
    torch.cuda.synchronize()
    assert k3.head_stack_fwd.launches == f0 + 1
    assert k3.head_stack_bwd.launches == b0 + 1
    for name, a, b in zip(smoke.K3_TOL, got, want):
        assert a.shape == b.shape, name
        assert _max_rel_err(a, b) <= smoke.K3_TOL[name], name


def test_k3_autograd_on_the_card_matches_autograd_of_the_plain_version(
        cuda_device):
    args = smoke.head_inputs(2, 48, 32, cuda_device, seed=3)
    dy, _ = smoke.kink_free_cotangent(*args)
    grads = []
    for fn in (k3.head_stack, k3.head_stack_ref):
        leaves = [a.clone().requires_grad_() for a in args[:-1]]
        (fn(*leaves) * dy).sum().backward()
        grads.append([a.grad for a in leaves])
    for name, a, b in zip(("dx", "dw1", "dw2", "dw3", "dalphas"), *grads):
        assert _max_rel_err(a, b) <= smoke.K3_TOL[name], name


def test_k3_wrapper_raises_on_what_the_kernel_does_not_take(cuda_device):
    x, w1, w2, w3, al, dy = smoke.head_inputs(1, 16, 16, cuda_device)
    with pytest.raises(TypeError, match="float32"):
        k3.head_stack_fwd(x.bfloat16(), w1, w2, w3, al)
    with pytest.raises(ValueError, match="16"):
        k3.head_stack_fwd(x[..., :8], w1[..., :8, :], w2, w3, al)
    with pytest.raises(ValueError, match="w1"):
        k3.head_stack_fwd(x, w1[:1], w2, w3, al)
    with pytest.raises(ValueError, match="dy"):
        k3.head_stack_bwd(x, w1, w2, w3, al, dy[:, :1])


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
    out = smoke.paint_fused_heads(cuda_device, n_tiles=2, warmup=0, iters=1)
    assert out["launches"] == 4 and out["k3_fwd_launches"] == 1
    assert out["worst_err_over_tol"] <= 1.0


def _k4_site(transposed, cin, cout, h, k=None, s=2):
    if transposed:
        return dict(transposed=True, cin=cin, cout=cout, k=2 * s, stride=s,
                    padding=s // 2, h=h)
    return dict(transposed=False, cin=cin, cout=cout, k=k, stride=1,
                padding=(k - 1) // 2, h=h)


def _k4_run(site, batch, device, seed=0):
    """Kernels and plain versions on the same inputs: {name: (got, want)}
    and the launches counted."""
    x, w, gamma, beta, dy = smoke.k4_inputs(site, batch, smoke.TRAIN_TILE,
                                            device, seed)
    kw = {k: site[k] for k in ("transposed", "stride", "padding")}
    count = dy.shape[0] * dy.shape[2] * dy.shape[3]
    y_r, mean_r, var_r = k4.conv_bn_relu_ref(x, w, gamma, beta, **kw)
    _, a_r, b_r = k4.bn_affine(gamma, beta, mean_r, var_r)
    v = k4._conv(x, w, **kw) * a_r[:, None, None] + b_r[:, None, None]
    dy = torch.where(v.abs() <= smoke.KINK_REL * v.abs().max(), 0.0, dy)
    before = {f: f.launches for f in (k4.conv_bn_stats, k4.conv_bn_fwd,
                                      k4.conv_bn_bwd1, k4.conv_bn_bwd2)}
    mean, var = k4.batch_stats(*k4.conv_bn_stats(x, w, **kw), count)
    inv, a, b = k4.bn_affine(gamma, beta, mean, var)
    y = k4.conv_bn_fwd(x, w, a, b, **kw)
    g1, g2 = k4.conv_bn_bwd1(x, w, a, b, mean, inv, dy, **kw)
    dx, dw = k4.conv_bn_bwd2(x, w, a, b, mean, inv, g1 / count, g2 / count,
                             dy, **kw)
    want = k4.conv_bn_relu_bwd_ref(x, w, gamma, beta, mean_r, var_r, dy,
                                   **kw)
    torch.cuda.synchronize()
    launches = {f: f.launches - n for f, n in before.items()}
    got = {"y": (y, y_r), "mean": (mean, mean_r), "var": (var, var_r)}
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
        assert _max_rel_err(a, b) <= smoke.K4_TOL[name], name


def test_k4_is_deterministic(cuda_device):
    site = _k4_site(True, 64, 32, 128)
    first, _ = _k4_run(site, 2, cuda_device)
    again, _ = _k4_run(site, 2, cuda_device)
    for name in ("mean", "var", "dw", "dgamma", "dbeta", "y", "dx"):
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
                                   **kw)
    assert _max_rel_err(yk, y_r) <= smoke.K4_TOL["y"]
    for name, leaf, b in zip(("dx", "dw", "dgamma", "dbeta"), leaves, want):
        assert _max_rel_err(leaf.grad, b) <= smoke.K4_TOL[name], name


def test_k4_wrapper_raises_on_what_the_kernels_do_not_take(cuda_device):
    site = _k4_site(False, 3, 16, 16, k=5)
    x, w, gamma, beta, _ = smoke.k4_inputs(site, 1, smoke.TRAIN_TILE,
                                           cuda_device)
    kw = dict(transposed=False, stride=1, padding=2)
    with pytest.raises(TypeError, match="float32"):
        k4.conv_bn_relu(x.bfloat16(), w.bfloat16(), gamma, beta, **kw)
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
    with pytest.raises(ValueError, match="shared memory"):
        wide = torch.zeros((96, 3, 5, 5), device=cuda_device)
        ones = torch.ones(96, device=cuda_device)
        k4.conv_bn_bwd2(x, wide, ones, ones, ones, ones, ones, ones,
                        torch.zeros((1, 96, 16, 16), device=cuda_device),
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
