"""Device milliseconds a paint call spends in its transforms (the painter,
``painter.py`` and ``transforms.py``): the spans ``paint.transform`` (range
compression and the ``channels_last`` copy) and ``paint.inverse`` (the
inverse transform and the output's copy), each between its two CUDA
events, summed over the traced calls and divided by them. None where the
program records no spans or their calls are not the traced calls."""
from baryon_painter_tpu_torch.utils import profiling


def read(run):
    per_call = getattr(profiling, "per_call", None)
    if per_call is None:
        return None
    return per_call("paint", ("paint.transform", "paint.inverse"),
                    run.trace.calls)
