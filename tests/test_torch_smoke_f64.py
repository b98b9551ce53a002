"""Phase 15c of ``chip_smoke.py`` (``smoke.train_parity_f64``) on the CPU at
a small size: its plans and readings, and that each of its rules raises
when the step it holds moves. On the CPU the kernels' wrappers run their
plain versions, so the kernels steps equal the plain ones."""
import pytest
import torch

from baryon_painter_tpu_torch import smoke


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def dataset():
    return smoke.training_data(tile=32)


def _run(dataset):
    return smoke.train_parity_f64("cpu", dataset, batch=2, n_res_blocks=1)


def test_f64_phase_readings_on_cpu(dataset):
    out = _run(dataset)
    assert set(out) == {"f32_kernels", "f32_kernels_k4", "f32_plain",
                        "f32_plain_heads", "f32_plain_k4", "f32_sites_f64",
                        "f32_plain_det", "f32_kernels_det", "bf16_kernels",
                        "bf16_kernels_k4"}
    for key in ("f32_kernels", "f32_kernels_k4"):
        r = out[key]
        assert r["loss"] <= smoke.STEP_LOSS_RTOL
        # the plain versions: the kernels steps are the plain ones here
        assert r["worst_leaf_err"] == out["f32_plain"]["worst_leaf_err"]
        assert r["limit_share"] <= 1.0
    for key in ("bf16_kernels", "bf16_kernels_k4"):
        r = out[key]
        # the plain bf16 steps' distance is the larger of two plain
        # versions', of which the kernels step here is one
        assert 0 < r["vector"] <= r["plain_vector"]
        assert r["vector_ratio"] <= 1.0
        assert r["limit_share"] == pytest.approx(1 / smoke.BF16_F64_FACTOR)
    # bf16 lies further from f64 than f32 does
    assert out["bf16_kernels"]["loss"] > out["f32_kernels"]["loss"]


def _moved(monkeypatch, label_kw, leaf=None, loss=None, scale=None):
    """step_gradients with the steps matching ``label_kw`` moved: one leaf
    by ``leaf`` of its largest entry, the loss by ``loss`` relative, or
    every gradient scaled by ``scale``."""
    real = smoke.step_gradients

    def fake(*args, **kw):
        value, grads = real(*args, **kw)
        if all(kw.get(k) == v for k, v in label_kw.items()):
            if leaf is not None:
                name = sorted(grads)[0]
                g = grads[name]
                grads[name] = g + leaf * g.abs().max()
            if loss is not None:
                value = value * (1 + loss)
            if scale is not None:
                grads = {k: v * scale for k, v in grads.items()}
        return value, grads

    monkeypatch.setattr(smoke, "step_gradients", fake)


@pytest.mark.parametrize("label_kw, move", [
    ({"kernels": True, "fused_train_conv": False, "dtype": None,
      "deterministic": False}, {"leaf": 1e-2}),
    ({"kernels": True, "fused_train_conv": True, "dtype": None,
      "deterministic": False}, {"loss": 1e-3}),
    ({"kernels": True, "fused_train_conv": False,
      "dtype": torch.bfloat16}, {"scale": 1.2}),
    ({"kernels": True, "fused_train_conv": True,
      "dtype": torch.bfloat16}, {"loss": 1.0}),
], ids=["f32_leaf", "f32_k4_loss", "bf16_vector", "bf16_k4_loss"])
def test_f64_phase_fails_when_a_kernels_step_moves(dataset, monkeypatch,
                                                   label_kw, move):
    _moved(monkeypatch, label_kw, **move)
    with pytest.raises(AssertionError, match="15c"):
        _run(dataset)
