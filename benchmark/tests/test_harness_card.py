"""On the card, at each cell's own size: the control (the reference in the
precision below the cell's, put in the program's place) fails the cell's
limits, and the program passes them, on one seed. Skips without a card.

    python3 -m pytest -p no:cacheprovider -m cuda benchmark/tests -q
"""
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (ROOT, ROOT / "benchmark" / "tools"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

CELLS = ("cvae_paint_bf16_n16", "cgan_paint_f32_n16", "cvae_train_f32_b24")
SEED = 2 ** 31 + 101


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _readings(name, device, control):
    import readings
    from benchmark.harness.core import load_cell
    cell = load_cell(name)
    read = (readings.train_readings if cell.workload["entry"] == "train"
            else readings.paint_readings)
    row = read(cell, [SEED], device, control)[0]
    return cell, {k: row[k] for k in cell.workload["checks"]}


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_control_fails_the_limits(card, name):
    cell, got = _readings(name, card, control=True)
    limits = cell.workload["checks"]
    assert any(not v <= limits[k] for k, v in got.items()), got


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_program_passes_the_limits(card, name):
    cell, got = _readings(name, card, control=False)
    limits = cell.workload["checks"]
    assert all(v <= limits[k] for k, v in got.items()), got
