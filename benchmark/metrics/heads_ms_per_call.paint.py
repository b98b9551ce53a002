"""Device milliseconds a CVAE paint call spends in its two output heads
(K3, ``ops/head_stack.py``): the span ``decode.heads`` (K3-fwd with its
weights' restack, the NHWC copy, softplus and casts), between its two CUDA
events, over the traced calls; ``k3_roofline.paint`` reads K3's kernels
alone. None where the program records no spans or their calls are not the
traced calls."""
from baryon_painter_tpu_torch.utils import profiling


def read(run):
    per_call = getattr(profiling, "per_call", None)
    if per_call is None:
        return None
    return per_call("paint", ("decode.heads",), run.trace.calls)
