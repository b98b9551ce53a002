"""K3-fwd and K3-bwd's (``ops/head_stack.py``) share of their roofline in
training steps, in %: the bounds of ``counts/kernels.k3_fwd`` and
``k3_bwd`` at the step's batch summed, times the traced steps, over the
device time of K3's kernels."""
from benchmark.counts import kernels


def read(run):
    if run.peaks is None:
        return None
    t, n = run.cell.traffic["tile"], run.units_per_call
    per_step = sum(kernels.bound_s(*f(n, t, t, run.dtype), run.peaks,
                                   run.dtype)
                   for f in (kernels.k3_fwd, kernels.k3_bwd))
    return run.roofline("k3", per_step)
