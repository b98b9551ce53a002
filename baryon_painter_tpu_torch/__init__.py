"""baryon_painter_tpu_torch: the PyTorch/CUDA port of baryon_painter_tpu.

Paints gas pressure onto dark-matter tiles with the committed CVAE
checkpoints, in PyTorch, on an NVIDIA H100. The fused residual block runs
through a hand-written CUDA kernel (``ops/res_block.py``,
``csrc/res_block.cu``); everything else is plain PyTorch. The JAX package
``baryon_painter_tpu`` is the reference this package is tested against; this
package imports nothing of it, nor of JAX.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``:

    from baryon_painter_tpu_torch import CVAEPainter
    painter = CVAEPainter("trained_models/CVAE/fiducial-512/model",
                          fused_inference=True)
    pressure = painter.paint_batch(tiles, zs)   # (N,512,512) on the card
"""

__version__ = "0.1.0"



def __getattr__(name):
    """Lazy top-level export of ``CVAEPainter`` (keeps
    ``import baryon_painter_tpu_torch`` light: torch is imported on use)."""
    if name == "CVAEPainter":
        from baryon_painter_tpu_torch.painter import CVAEPainter
        return CVAEPainter
    raise AttributeError(f"module 'baryon_painter_tpu_torch' has no "
                         f"attribute '{name}'")
