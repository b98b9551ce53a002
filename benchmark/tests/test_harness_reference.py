"""The frozen reference against the port on the CPU: both painters at 64^2
tiles from the committed checkpoints, f32, the same inputs and noise; and
the reference's batches and first training step against the port's
trainer on a small cell."""
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from benchmark.harness import compare  # noqa: E402
from benchmark.reference.painting import ReferencePainter  # noqa: E402
from harness_small_cells import small_cell  # noqa: E402

# the port's f32 paint and the reference's differ by their f32 sums'
# order (fused blocks, heads and batch norms against plain ones)
PAINT_RTOL = 1e-4


@pytest.mark.parametrize("name,fused", [
    ("cvae_paint_bf16_n16", {}),
    ("cvae_paint_bf16_n16", {"fused_inference": True, "fused_heads": True}),
    ("cgan_paint_f32_n16", {}),
    ("cgan_paint_f32_n16", {"fused_inference": True})])
def test_reference_paints_as_the_port(tmp_path, name, fused):
    from baryon_painter_tpu_torch import painter
    from benchmark.entries.paint import PaintSystem
    cell = small_cell(name, tmp_path)
    dev = torch.device("cpu")
    inputs = PaintSystem(cell, 2 ** 31 + 11, dev, program=False)
    tiles, zs, eps = inputs.inputs(0)
    cls = getattr(painter, cell.workload["painter"])
    port = cls(cell.config["checkpoint"], device="cpu", **fused)
    out = (port.paint_batch(tiles, zs) if eps is None
           else port.paint_batch(tiles, zs, eps=eps))
    ref = ReferencePainter(cell.config, dev).paint(tiles, zs, eps)
    assert torch.isfinite(ref).all()
    assert float(compare.tile_errors(out, ref).max()) < PAINT_RTOL


def test_reference_batches_are_the_ports(tmp_path):
    """K2's gather, the dihedral permutations, the depth sum and the SLICS
    scale, worked out again from the raw stacks."""
    from baryon_painter_tpu_torch.data.dataset import BahamasTileDataset
    from benchmark.harness import traffic
    from benchmark.reference import training
    cell = small_cell("cvae_train_f32_b24", tmp_path)
    tr = cell.traffic
    data = traffic.train_stacks(tr, torch.device("cpu"))
    ds = BahamasTileDataset(data=data, redshifts=tr["redshifts"],
                            label_fields=["pressure"], n_tile=tr["n_tile"],
                            n_stack=tr["n_stack"], tile_permutations=True,
                            scale_to_SLICS=True)
    idx = traffic.sample_batches(len(ds), 16, 5, 1, 1)[0]
    port = ds.get_raw_batch(idx)
    dm, pressure, z = training.batch(data, tr["redshifts"], tr["n_tile"],
                                     tr["n_stack"], idx)
    assert (dm == port["input"]).all() and (z == port["z"]).all()
    assert (pressure == port["labels"][0]).all()


def test_reference_steps_as_the_trainer(tmp_path):
    """The first steps' readings of the port's trainer and of the f64
    reference from the same state, batches and noise (the CPU's f32, oneDNN
    off: its f32 sums put a gradient 3e-3 from f64)."""
    from benchmark.entries.train import TrainSystem
    cell = small_cell("cvae_train_f32_b24", tmp_path)
    prev = torch.backends.mkldnn.enabled
    torch.backends.mkldnn.enabled = False
    try:
        system = TrainSystem(cell, 2 ** 31 + 3, torch.device("cpu"))
        got = system.first_steps()
        system.free_program()
        gaps = compare.train_gaps(got, system.reference())
    finally:
        torch.backends.mkldnn.enabled = prev
    assert gaps["first_loss_gap"] < 1e-6
    assert gaps["grad_gap"] < 1e-3
    assert gaps["change_gap"] < 0.05
