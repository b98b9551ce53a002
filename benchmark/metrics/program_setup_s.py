"""Host seconds of the program's set-up spans: each top-level ``setup.*``
span (inside no other set-up span) of the run, on the host's clock. They
are the kernel library's load or build (``setup.library``,
``ops/_build.py``), the checkpoint's read and decode (``setup.checkpoint``,
``train/checkpoint.py``), the painter's model build and weights to the
card (``setup.model``, ``painter.py``), the trainer's own weight draw
(``setup.trainer``, ``train/trainer.py``) and the training stacks'
assembly and upload (``setup.stacks``, ``data/device_cache.py``). None
where the program records no set-up spans."""
from baryon_painter_tpu_torch.utils import profiling


def read(run):
    if not hasattr(profiling, "spans"):
        return None
    recs = profiling.spans()
    names = {r.id: r.name for r in recs}
    top = [r.host_ms for r in recs if r.name.startswith("setup.")
           and not names.get(r.parent, "").startswith("setup.")]
    if not top or None in top:
        return None
    return sum(top) / 1e3
