"""baryon_painter_tpu_torch: the PyTorch/CUDA port of baryon_painter_tpu.

Paints gas pressure onto dark-matter tiles with the committed CVAE and
CGAN checkpoints, tile by tile or as whole seamless planes, and trains the
CVAE, in PyTorch, on an NVIDIA H100. Three
hand-written CUDA kernels (``csrc/``) carry the parts the JAX package wrote
in Pallas: the fused residual block (K1, ``ops/res_block.py``), the training
batch's tile gather (K2, ``ops/gather.py``) and the output heads, forward and
backward (K3, ``ops/head_stack.py``); everything else is plain PyTorch. The
JAX package ``baryon_painter_tpu`` is the reference this package is tested
against; this package imports nothing of it, nor of JAX.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``:

    from baryon_painter_tpu_torch import CVAEPainter
    painter = CVAEPainter("trained_models/CVAE/fiducial-512/model",
                          fused_inference=True)
    pressure = painter.paint_batch(tiles, zs)   # (N,512,512) on the card
"""

__version__ = "0.1.0"



def __getattr__(name):
    """Lazy top-level export of ``CVAEPainter``, ``CGANPainter`` and
    ``load_painter`` (keeps ``import baryon_painter_tpu_torch`` light:
    torch is imported on use)."""
    if name in ("CVAEPainter", "CGANPainter", "load_painter"):
        from baryon_painter_tpu_torch import painter
        return getattr(painter, name)
    raise AttributeError(f"module 'baryon_painter_tpu_torch' has no "
                         f"attribute '{name}'")
