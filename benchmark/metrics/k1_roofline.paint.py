"""K1's (``ops/res_block.py``) share of its roofline in paint calls, in %:
the bound of every residual block a call runs (``counts/kernels.k1`` at
the block's shape, the call's tiles) times the traced calls, over the
device time of K1's kernels."""
from benchmark.counts import kernels, models


def read(run):
    if run.peaks is None:
        return None
    tile = run.cell.traffic["tile"]
    per_call = sum(
        kernels.bound_s(*kernels.k1(run.units_per_call, h, w, c, run.dtype),
                        run.peaks, run.dtype)
        for c, h, w in models.paint_res_blocks(run.cell.config, tile))
    return run.roofline("k1", per_call)
