"""Device milliseconds a CVAE paint call spends in the prior network and
the latent draw (``models/cvae.py``): the span ``paint.prior``, between its
two CUDA events, over the traced calls. None where the program records no
spans or their calls are not the traced calls."""
from baryon_painter_tpu_torch.utils import profiling


def read(run):
    per_call = getattr(profiling, "per_call", None)
    if per_call is None:
        return None
    return per_call("paint", ("paint.prior",), run.trace.calls)
