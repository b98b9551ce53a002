"""K3-fwd's (``ops/head_stack.py``, both output heads) share of its
roofline in paint calls, in %: ``counts/kernels.k3_fwd``'s bound at the
call's tiles times the traced calls, over the device time of K3-fwd's
kernels."""
from benchmark.counts import kernels


def read(run):
    if run.peaks is None:
        return None
    t = run.cell.traffic["tile"]
    per_call = kernels.bound_s(
        *kernels.k3_fwd(run.units_per_call, t, t, run.dtype), run.peaks,
        run.dtype)
    return run.roofline("k3_fwd", per_call)
