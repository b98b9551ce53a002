"""Host milliseconds a training step spends in its host-to-device copies
of sample digits (the trainer, ``train/trainer.py`` and
``data/device_cache.py``): the host's clock inside the spans
``train.upload``, which wait for the queue where the digits are pageable,
over the traced steps. None where the program records no spans or their
steps are not the traced steps."""
from baryon_painter_tpu_torch.utils import profiling


def read(run):
    per_call = getattr(profiling, "per_call", None)
    if per_call is None:
        return None
    return per_call("train.step", ("train.upload",),
                    run.trace.calls, clock="host")
