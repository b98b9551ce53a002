"""The whole training step's share of the card's peak, in %: three times
the forward's direct-convolution operations a sample
(``counts/models.cvae_train_forward_flops``: recognition net, prior net
and decoder) times the samples a second of the untraced part of the
window, over the dtype's peak (``counts/peaks.json``)."""
from benchmark.counts import models


def read(run):
    if run.peaks is None:
        return None
    flops = 3 * models.cvae_train_forward_flops(run.cell.config[
        "architecture"], run.cell.traffic["tile"])
    return 100.0 * flops * run.units_per_s / run.peaks[run.dtype]
