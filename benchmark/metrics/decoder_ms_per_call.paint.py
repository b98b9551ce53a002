"""Device milliseconds a paint call spends in the decoder's trunk
(``models/cvae.py``, ``models/cgan.py``, ``models/layers.py``): the span
``paint.decode`` (the CVAE's ``sample_P``, the CGAN's generator) less the
output heads' ``decode.heads`` inside it, each between its two CUDA
events, over the traced calls. None where the program records no spans or
their calls are not the traced calls."""
from baryon_painter_tpu_torch.utils import profiling


def read(run):
    per_call = getattr(profiling, "per_call", None)
    if per_call is None:
        return None
    return per_call("paint", ("paint.decode",),
                    run.trace.calls, less=("decode.heads",))
