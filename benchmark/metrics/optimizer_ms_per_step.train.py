"""Device milliseconds a training step spends in its optimizer (the
trainer, ``train/trainer.py``): the span ``train.optimizer`` (the gradient
list, global norm, clip, Adam and the parameter update), between its two
CUDA events, over the traced steps. None where the program records no
spans or their steps are not the traced steps."""
from baryon_painter_tpu_torch.utils import profiling


def read(run):
    per_call = getattr(profiling, "per_call", None)
    if per_call is None:
        return None
    return per_call("train.step", ("train.optimizer",), run.trace.calls)
