"""The comparison that decides ``correct`` refuses a broken program: each
cell's run, on the CPU at a small size (the look for a card skipped),
with a fault of ``tools/faults.py`` planted under the timed path, comes
out not correct; the same run unbroken comes out correct."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "benchmark" / "tools"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

from benchmark.entries import paint, train  # noqa: E402
from faults import PAINT_FAULTS, TRAIN_FAULTS, planted  # noqa: E402
from harness_small_cells import small_cell  # noqa: E402

CASES = ([("cvae_paint_bf16_n16", f) for f in (None,) + PAINT_FAULTS]
         + [("cgan_paint_f32_n16", f) for f in (None,) + PAINT_FAULTS]
         + [("cvae_train_f32_b24", f) for f in (None,) + TRAIN_FAULTS])


@pytest.fixture
def no_onednn():
    """PyTorch's own CPU convolutions: oneDNN's f32 sums put a training
    gradient 3e-3 from f64 at these sizes."""
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    yield
    torch.backends.mkldnn.enabled = prev


@pytest.mark.parametrize("name,fault", CASES,
                         ids=[f"{n}-{f}" for n, f in CASES])
def test_run_refuses_a_fault(tmp_path, no_onednn, name, fault):
    cell = small_cell(name, tmp_path, seconds=0.5)
    entry = train if cell.workload["entry"] == "train" else paint
    if fault is None:
        out = entry.run(cell)
        assert out["checks"].correct, out["checks"].record()
        assert out["failed"] == 0
        return
    with planted(cell.workload["entry"], fault,
                 cell.workload.get("painter", "")):
        out = entry.run(cell)
    assert not out["checks"].correct, out["checks"].record()
    assert out["failed"] > 0
