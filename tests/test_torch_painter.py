"""The port's painter on the committed CVAE checkpoints.

* Every committed CVAE golden (tests/goldens/paint_goldens.npz, painted by
  the JAX package in CPU float32) is repainted by the port on the CPU, with
  the residual blocks unfused and fused (K1's plain version), at the golden
  test's own tolerance (rtol 5e-3, atol 5e-3 * mean|golden|: the goldens are
  stored in float16). The prior noise is the committed one
  (baryon_painter_tpu_torch/data/golden_eps.npz), since torch cannot draw
  jax.random's numbers.
* That noise is recomputed from the JAX painter, so the pin cannot drift.
* The port runs with jax, flax, msgpack and the JAX package unimportable, as
  on the machine with the card.
* Without a device argument the painter wants CUDA, and raises without it.
"""
import importlib.util
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from baryon_painter_tpu_torch.painter import CVAEPainter
from golden_utils import GOLDEN_PATH, MODELS, REPO, golden_inputs

CVAE_GOLDENS = [m for m in MODELS if m[2] == "cvae"]
EPS_PATH = os.path.join(REPO, "baryon_painter_tpu_torch", "data",
                        "golden_eps.npz")


@pytest.fixture(scope="module")
def goldens():
    with np.load(GOLDEN_PATH) as z:
        return {k: z[k].astype(np.float32) for k in z.files}


@pytest.fixture(scope="module")
def golden_eps():
    with np.load(EPS_PATH) as z:
        return {k: z[k] for k in z.files}


def test_five_cvae_goldens_are_covered():
    assert [m[0] for m in CVAE_GOLDENS] == [
        "cvae_fiducial", "cvae_resize", "cvae_512", "cvae_phys512_lt",
        "cvae_phys512_resize"]


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("name,base,kind,tile,n", CVAE_GOLDENS,
                         ids=[m[0] for m in CVAE_GOLDENS])
def test_port_paints_committed_golden(goldens, golden_eps, name, base, kind,
                                      tile, n, fused):
    painter = CVAEPainter(os.path.join(REPO, base), fused_inference=fused,
                          device="cpu")
    zs = np.linspace(0.0, 1.0, n).astype(np.float32)
    got = painter.paint_batch(golden_inputs(tile, n), zs,
                              eps=golden_eps[f"eps_{tile}"]).numpy()
    want = goldens[name]
    assert got.shape == want.shape
    assert np.all(np.isfinite(got))
    scale = np.abs(want).mean()
    np.testing.assert_allclose(got, want, rtol=5e-3, atol=5e-3 * scale,
                               err_msg=f"{name}: the port's paint differs "
                                       f"from the committed golden")


def _load_eps_script():
    path = os.path.join(REPO, "scripts", "make_golden_eps.py")
    spec = importlib.util.spec_from_file_location("make_golden_eps", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("key", ["eps_256", "eps_512"])
def test_committed_noise_is_what_the_jax_painter_draws(golden_eps, key):
    """Recompute the pin from the JAX painter (PRNGKey(7)); recovering it as
    (z - mu)/(exp(logvar/2) + min_z_var) costs a few f32 ulp, hence 1e-5."""
    mod = _load_eps_script()
    by_name = {m[0]: m for m in MODELS}
    _, base, _, tile, n = by_name[mod.SOURCES[key]]
    got = mod.recover_eps(base, tile, n)
    assert got.shape == golden_eps[key].shape == (n, tile // 32, tile // 32)
    np.testing.assert_allclose(golden_eps[key], got, rtol=1e-5, atol=1e-5)


def test_paint_single_tile_returns_numpy(golden_eps):
    painter = CVAEPainter(os.path.join(REPO, CVAE_GOLDENS[0][1]),
                          device="cpu")
    tile = golden_inputs(256, 1)[0]
    out, var = painter.paint(tile, z=0.0, eps=golden_eps["eps_256"][0],
                             return_var=True)
    assert isinstance(out, np.ndarray) and out.shape == (256, 256)
    assert var.shape == (256, 256) and np.all(np.isfinite(var))
    assert np.all(var >= 0)
    batch = painter.paint_batch(tile[None], [0.0],
                                eps=golden_eps["eps_256"][:1]).numpy()
    np.testing.assert_array_equal(out, batch[0])
    with pytest.raises(ValueError, match="Shape mismatch"):
        painter.paint(np.ones((64, 64), np.float32))
    with pytest.raises(ValueError, match="2-D"):
        painter.paint(np.ones((1, 256, 256), np.float32))


def test_default_device_is_cuda_and_raises_without_it():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        CVAEPainter(os.path.join(REPO, CVAE_GOLDENS[2][1]))


_BLOCKED_RUN = textwrap.dedent("""
    import importlib.abc, sys
    BLOCKED = ("jax", "jaxlib", "flax", "msgpack", "baryon_painter_tpu")

    class Block(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"{name} is blocked")
            return None

    sys.meta_path.insert(0, Block())
    import numpy as np
    from baryon_painter_tpu_torch.painter import CVAEPainter
    from baryon_painter_tpu_torch import smoke
    painter = CVAEPainter("trained_models/CVAE/fiducial-512/model",
                          fused_inference=True, device="cpu")
    tiles = smoke.golden_inputs(64, 1)
    out = painter.paint_batch(tiles, np.zeros(1, np.float32), z_mode="mean")
    assert out.shape == (1, 64, 64) and bool(out.isfinite().all())
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
    assert not loaded, loaded
    print("PAINTED", tuple(out.shape))
""")


def test_port_runs_without_jax_flax_msgpack_or_the_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", _BLOCKED_RUN], cwd=REPO,
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "PAINTED (1, 64, 64)" in proc.stdout
