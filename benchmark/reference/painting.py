"""The reference painters: a configuration's checkpoint read by this
package's own decoder, painted in plain PyTorch (``models``)."""
from __future__ import annotations

import torch

from benchmark.reference import models, nets

__all__ = ["ReferencePainter", "tf32_off"]


class tf32_off:
    """cuDNN's and matmul's TF32 switched off inside the block, restored
    after."""

    def __enter__(self):
        self.prev = (torch.backends.cudnn.allow_tf32,
                     torch.backends.cuda.matmul.allow_tf32)
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False

    def __exit__(self, *exc):
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = self.prev
        return False


class ReferencePainter:
    """``paint(tiles, zs, eps)``: raw dark-matter tiles (N, H, W), their
    redshifts (N,) and, for the CVAE, the prior noise (N, Cz, h, w) -> the
    painted pressure (N, H, W), f32, in ``numerics``' precision."""

    def __init__(self, config: dict, device, numerics: str = "f32"):
        state, meta = models.load_checkpoint(config["checkpoint"])
        self.config = config
        self.model = config["model"]
        self.nm = nets.Numerics(numerics)
        if self.model == "cvae":
            flat = models.cvae_params_from_checkpoint(state)
        elif self.model == "cgan":
            flat = models.cgan_params_from_checkpoint(state)
        else:
            raise NotImplementedError(self.model)
        self.params = {k: torch.as_tensor(v, device=device).to(self.nm.dtype)
                       for k, v in flat.items()}
        self.fin = models.FieldTransform(
            meta["transforms"][meta["input_field"]],
            meta["stats"][meta["input_field"]])
        out = meta["label_fields"][0]
        self.fout = models.FieldTransform(meta["transforms"][out],
                                          meta["stats"][out])

    @torch.no_grad()
    def paint(self, tiles, zs, eps=None):
        dt = self.nm.dtype
        with tf32_off():
            y = self.fin.forward(tiles.to(dt), zs)[:, None]
            zs = zs.to(dt)
            if self.model == "cvae":
                out = models.cvae_paint(self.config["architecture"],
                                        self.params, y, zs, eps, self.nm)
            else:
                out = models.cgan_paint(self.config["generator"],
                                        self.params, y, zs, self.nm)
            return self.fout.inverse(out[:, 0], zs).float()
