"""Host milliseconds a paint call spends dispatching the model
(``models/cvae.py``, ``models/cgan.py``, ``models/layers.py``): the host's
clock inside the spans ``paint.prior`` and ``paint.decode``, over the
traced calls. None where the program records no spans or their calls are
not the traced calls."""
from baryon_painter_tpu_torch.utils import profiling


def read(run):
    per_call = getattr(profiling, "per_call", None)
    if per_call is None:
        return None
    return per_call("paint", ("paint.prior", "paint.decode"),
                    run.trace.calls, clock="host")
