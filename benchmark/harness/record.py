"""What a traced run hands the per-layer readers (``metrics/*.py``)."""
from __future__ import annotations

import json
from dataclasses import dataclass
from typing import Optional

from benchmark.counts import kernels as kcounts
from benchmark.harness.core import BENCH_DIR, Cell
from benchmark.harness.measure import Trace, Window

__all__ = ["Run", "port_kernels"]


def port_kernels() -> dict:
    """The port's hand-written kernels by function name, per kernel family
    (``port_kernels.json``)."""
    with open(BENCH_DIR / "harness" / "port_kernels.json") as f:
        return json.load(f)


@dataclass
class Run:
    cell: Cell
    kind: str              # torch.cuda.get_device_name()
    dtype: str             # "float32" or "bfloat16"
    window: Window         # the untraced part of the window
    trace: Trace           # the traced part
    units_per_call: int    # tiles a paint call, samples a step

    @property
    def peaks(self) -> Optional[dict]:
        return kcounts.peaks(self.kind)

    @property
    def units_per_s(self) -> float:
        return self.window.units / self.window.seconds

    def all_port_kernels(self) -> list:
        return sorted({n for names in port_kernels().values()
                       for n in names})

    def roofline(self, family: str, bound_per_call_s: float):
        """100 x (the bound of the traced calls) / (the device seconds of
        the kernels of ``family``), or None where they did not run or the
        card has no peaks in the table."""
        if self.peaks is None:
            return None
        t = self.trace.kernel_s(port_kernels()[family])
        if t <= 0:
            return None
        return 100.0 * bound_per_call_s * self.trace.calls / t
