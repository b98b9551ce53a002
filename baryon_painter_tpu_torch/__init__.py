"""baryon_painter_tpu_torch: the PyTorch/CUDA port of baryon_painter_tpu.

Paints gas pressure onto dark-matter tiles with the committed CVAE and
CGAN checkpoints, tile by tile or as whole seamless planes, and trains the
CVAE and the CGAN, in PyTorch, on an NVIDIA H100. Four
hand-written CUDA kernels (``csrc/``) carry the parts the JAX package wrote
in Pallas: the fused residual block (K1, ``ops/res_block.py``), the training
batch's tile gather (K2, ``ops/gather.py``), the output heads, forward and
backward (K3, ``ops/head_stack.py``) and the train-mode conv + batch norm +
ReLU (K4, ``ops/conv_bn.py``); everything else is plain PyTorch. The
JAX package ``baryon_painter_tpu`` is the reference this package is tested
against; this package imports nothing of it, nor of JAX.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``:

    from baryon_painter_tpu_torch import CVAEPainter
    painter = CVAEPainter("trained_models/CVAE/fiducial-512/model",
                          fused_inference=True)
    pressure = painter.paint_batch(tiles, zs)   # (N,512,512) on the card

    from baryon_painter_tpu_torch import CGANTrainer, CGANTrainConfig
    trainer = CGANTrainer(dataset, device_data=True,
                          config=CGANTrainConfig(output_path="run"))
    trainer.train()
"""

__version__ = "0.1.0"

_LAZY = {"CVAEPainter": "painter", "CGANPainter": "painter",
         "load_painter": "painter", "CVAE": "models.cvae",
         "BahamasTileDataset": "data.dataset",
         "CVAETrainer": "train.trainer", "TrainConfig": "train.trainer",
         "CGANTrainer": "train.cgan", "CGANTrainConfig": "train.cgan",
         "process_slics": "lightcone.pipeline",
         "create_y_map": "lightcone.ymap",
         "pseudo_pofk_2d": "power_spectrum"}
# modules exported whole, as the JAX package exports ``transforms``
_LAZY_MODULES = ("transforms",)


def __getattr__(name):
    """Lazy top-level export of the painters, ``load_painter``, the
    trainers, the CVAE, the dataset, the lightcone's ``process_slics`` and
    ``create_y_map``, ``pseudo_pofk_2d`` and the ``transforms`` module, the
    JAX package's top-level names (keeps ``import baryon_painter_tpu_torch``
    light: torch is imported on use)."""
    import importlib
    if name in _LAZY_MODULES:
        return importlib.import_module(f"baryon_painter_tpu_torch.{name}")
    if name in _LAZY:
        module = importlib.import_module(f"baryon_painter_tpu_torch."
                                         f"{_LAZY[name]}")
        return getattr(module, name)
    raise AttributeError(f"module 'baryon_painter_tpu_torch' has no "
                         f"attribute '{name}'")
