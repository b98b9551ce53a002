"""Differentiable P(k)-fidelity loss, in PyTorch.

Port of ``baryon_painter_tpu/train/spectral.py``. The fidelity gate is the
fractional error of the painted auto- and cross-P(k) against the truth, per
redshift. This loss term matches the batch-mean spectra of a painted batch
(already inverse-transformed to physical space, the paint-time code path)
to the truth's:

- auto spectra are positive: squared log-ratio, scale-free across the ~6
  decades of P(k);
- cross spectra are signed and pass through ~0 at high k where the true
  correlation is weak, so a log|.| there explodes; the relative error
  against |P_ct| anchors sign and magnitude instead.

With ``redshifts`` given, one masked batch-mean is computed per redshift
and the errors averaged (the gate is per-z; a pooled mixed-z loss lets the
model overshoot one z and undershoot another with a perfect z-averaged
spectrum). A redshift absent from the batch adds no term.

The spectra are ``power_spectrum.pseudo_pofk_2d``'s (``fft2``, a gather in
bin order, per-bin sums): differentiable, and the same bits on every run.

With a ``ProcessMesh`` each rank holds its rows of the global batch; the
batch means are the global batch's (the per-z sums and counts, or the
pooled means, summed over the ranks differentiably), so every rank returns
the global loss.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from baryon_painter_tpu_torch.power_spectrum import pseudo_pofk_2d

__all__ = ["pk_fidelity_loss"]


def pk_fidelity_loss(pred, truth, dm, L: float, n_bins: int, z=None,
                     redshifts: Optional[Sequence[float]] = None,
                     mesh=None):
    """Spectral fidelity loss between painted and truth batches (a scalar
    f32 tensor, differentiable in ``pred``).

    Args:
      pred, truth, dm: (N, H, W) physical-space fields.
      L: tile side length [Mpc/h].
      n_bins: number of log-spaced k bins.
      z: (N,) per-sample redshifts; required when ``redshifts`` is given.
      redshifts: the training redshifts for the per-z variant, or None for
        a pooled batch-mean.
      mesh: a ``ProcessMesh`` whose ranks hold equal shares of the batch
        (module docstring), or None.
    """
    def sample_pk(a, b=None):
        pk, _, _, nm = pseudo_pofk_2d(a, b, L=L, n_k_bin=n_bins)
        return pk, nm > 0  # pk: (N, n_bins)

    pk_p, occ = sample_pk(pred)
    pk_t, _ = sample_pk(truth)
    pk_cp, _ = sample_pk(pred, dm)
    pk_ct, _ = sample_pk(truth, dm)

    if redshifts is not None:
        if z is None:
            raise ValueError("the per-z loss needs the samples' redshifts z")
        zs = torch.tensor(list(redshifts), dtype=torch.float32,
                          device=pk_p.device)
        w = (torch.as_tensor(z, device=pk_p.device).float()[None, :]
             == zs[:, None]).float()                 # (n_z, N)
        total = w.sum(dim=1, keepdim=True)
        wsum = lambda pk: w @ pk
        if mesh is not None:
            total = mesh.all_reduce(total)
            wsum = lambda pk: mesh.sum(w @ pk)
        cnt = total.clamp(min=1.0)
        mean = lambda pk: wsum(pk) / cnt             # (n_z, n_bins)
        present = total > 0                          # z's in this batch
    else:
        mean = lambda pk: pk.mean(dim=0, keepdim=True)
        if mesh is not None:
            mean = lambda pk: mesh.mean(pk.mean(dim=0, keepdim=True))
        present = torch.ones((1, 1), dtype=torch.bool, device=pk_p.device)

    m_p, m_t = mean(pk_p), mean(pk_t)
    m_cp, m_ct = mean(pk_cp), mean(pk_ct)
    use = occ[None, :] & present
    zero = torch.zeros((), device=pk_p.device)
    auto = torch.where(use, torch.log(m_p + 1e-30) - torch.log(m_t + 1e-30),
                       zero)
    cross = torch.where(use, (m_cp - m_ct) / (m_ct.abs() + 1e-30), zero)
    n = use.sum().clamp(min=1)
    return ((auto ** 2).sum() + (cross ** 2).sum()) / n
