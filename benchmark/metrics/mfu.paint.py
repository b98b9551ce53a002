"""The whole paint call's share of the card's peak, in %: the
configuration's direct-convolution operations a tile
(``counts/models.paint_flops``) times the tiles a second of the untraced
part of the window, over the dtype's peak (``counts/peaks.json``)."""
from benchmark.counts import models


def read(run):
    if run.peaks is None:
        return None
    flops = models.paint_flops(run.cell.config, run.cell.traffic["tile"])
    return 100.0 * flops * run.units_per_s / run.peaks[run.dtype]
