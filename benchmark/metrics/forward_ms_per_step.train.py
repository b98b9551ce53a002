"""Device milliseconds a training step spends in the model's forward and
ELBO (``models/cvae.py``, ``models/layers.py``, with K3 and K4): the span
``train.forward``, between its two CUDA events, over the traced steps.
None where the program records no spans or their steps are not the traced
steps."""
from baryon_painter_tpu_torch.utils import profiling


def read(run):
    per_call = getattr(profiling, "per_call", None)
    if per_call is None:
        return None
    return per_call("train.step", ("train.forward",), run.trace.calls)
