"""K4's (``ops/conv_bn.py``) share of its roofline in training steps, in
%: at each of the trunk's sites (``counts/models.cvae_k4_sites``) the
forward's and the backward's bounds (``counts/kernels.k4_site``) summed,
times the traced steps, over the device time of K4's kernels."""
from benchmark.counts import kernels, models


def read(run):
    if run.peaks is None:
        return None
    arch = run.cell.config["architecture"]
    per_step = 0.0
    for site in models.cvae_k4_sites(arch, run.cell.traffic["tile"]):
        for ops, nbytes in kernels.k4_site(site, run.units_per_call,
                                           run.dtype):
            per_step += kernels.bound_s(ops, nbytes, run.peaks, run.dtype)
    return run.roofline("k4", per_step)
