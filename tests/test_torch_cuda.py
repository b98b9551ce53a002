"""The port on the card: K1 (csrc/res_block.cu) against its plain version, and
the fused painter on CUDA against the same painter on the CPU and the golden.

Every test here needs a CUDA device and skips without one. The file imports
only torch, numpy, pytest and the port, so it runs on the machine with the
card, which has no JAX; there, skip the JAX-importing conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py -q

Tolerances: f32 K1 differs from the plain version only by summation order
(max|diff| <= 1e-4 max|plain|); bf16 also by where the intermediate rounds
(2e-2); the painter by the golden test's own rtol 5e-3.
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from baryon_painter_tpu_torch import smoke
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
