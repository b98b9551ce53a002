"""Validation diagnostics: sample grids, power spectra, histograms.

The counterpart of ``baryon_painter_tpu/utils/validation_plotting.py``
(reference-parity plotting, utils/validation_plotting.py:10-193) on the
port's P(k) estimator. matplotlib is imported lazily with the Agg backend,
so the metrics never need it; a figure without it raises an ImportError
that names it (``require_matplotlib``).

Array convention: fields are (N, C, H, W), numpy arrays or tensors. The
inverse-transform callables (``BahamasTileDataset.get_inverse_transforms``)
take tensors. The spectra of a whole batch are one batched
``pseudo_pofk_2d`` call on ``device``: when it is not given, on the device
of ``output_true`` where that is a tensor, else on the card
(``platform.device_of``); pass ``device="cpu"`` for the host.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from baryon_painter_tpu_torch.power_spectrum import pseudo_pofk_2d
from baryon_painter_tpu_torch.utils.platform import device_of

__all__ = ["plot_samples", "plot_power_spectra", "plot_histogram",
           "power_spectrum_fractional_error", "require_matplotlib",
           "validation_figures", "save_figures"]


def require_matplotlib():
    """Raise an ImportError naming matplotlib when it is not installed."""
    try:
        import matplotlib  # noqa: F401
    except ImportError as e:
        raise ImportError(
            "validation figures need matplotlib, which is not installed "
            "here; the numbers (power_spectrum_fractional_error, the "
            "validation loss) do not") from e


def _plt():
    require_matplotlib()
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _host(a) -> np.ndarray:
    if torch.is_tensor(a):
        return a.detach().float().cpu().numpy()
    return np.asarray(a, dtype=np.float32)


def _fields(arr, transforms, device):
    """(N, C, H, W) -> (N, C, H, W) f32 on ``device``, each (sample,
    channel) through ``transforms[sample][channel]`` when given."""
    t = torch.as_tensor(arr).to(device=device, dtype=torch.float32)
    if not transforms:
        return t
    return torch.stack([torch.stack([
        torch.as_tensor(transforms[j][i](t[j, i])).float()
        for i in range(t.shape[1])]) for j in range(t.shape[0])])


def _spectra(output_true, output_pred, input, L, mode,
             output_transforms, input_transforms, n_k_bin, device):
    """k (n_k,), P_true and P_pred (N, C, n_k) as numpy: one batched
    spectrum of each."""
    if mode not in ("auto", "cross"):
        raise ValueError(f"Invalid mode: {mode}.")
    device = device_of(output_true, device)
    a_true = _fields(output_true, output_transforms, device)
    a_pred = _fields(output_pred, output_transforms, device)
    if mode == "auto":
        b_true, b_pred = a_true, a_pred
    else:
        inv_in = ([[t] for t in input_transforms]
                  if input_transforms else None)
        b = _fields(torch.as_tensor(input)[:, :1], inv_in, device)
        b_true = b_pred = b.expand_as(a_true)
    pk_t, k, _, _ = pseudo_pofk_2d(a_true, b_true, L, n_k_bin=n_k_bin,
                                   device=device)
    pk_p, _, _, _ = pseudo_pofk_2d(a_pred, b_pred, L, n_k_bin=n_k_bin,
                                   device=device)
    return _host(k), _host(pk_t), _host(pk_p)


def _frac(pk_t, pk_p):
    # empty log-bins (no modes) carry no signal -> 0 deviation
    return np.where(pk_t != 0, pk_p / np.where(pk_t != 0, pk_t, 1) - 1, 0.0)


def plot_samples(output_true, output_pred, input, output_pred_var=None,
                 n_sample: int = 4, input_label: str = "",
                 output_labels: Sequence[str] = (), tile_size: float = 2.5):
    """Grid of truth/prediction(/variance) tiles per sample."""
    plt = _plt()
    output_true, output_pred, input = map(_host, (output_true, output_pred,
                                                  input))
    n = min(output_true.shape[0], n_sample)
    rows_per = 2 if output_pred_var is None else 3
    if output_pred_var is not None:
        output_pred_var = _host(output_pred_var)
    n_row = rows_per * n
    n_col = output_true.shape[1] + 1
    fig, ax = plt.subplots(n_row, n_col, sharex=True, sharey=True,
                           figsize=(n_col * tile_size, n_row * tile_size),
                           squeeze=False)
    cmaps = ["viridis", "magma", "plasma", "inferno"]
    for i in range(n):
        ax[rows_per * i, 0].imshow(np.squeeze(input[i]), cmap=cmaps[0],
                                   vmin=-1, vmax=1)
        for j in range(output_true.shape[1]):
            kw = {"cmap": cmaps[(j + 1) % 4], "vmin": -1, "vmax": 1}
            ax[rows_per * i, j + 1].imshow(np.squeeze(output_true[i, j]),
                                           **kw)
            ax[rows_per * i + 1, j + 1].imshow(
                np.squeeze(output_pred[i, j]), **kw)
            if output_pred_var is not None:
                ax[rows_per * i + 2, j + 1].imshow(
                    np.log(np.squeeze(output_pred_var[i, j])),
                    cmap=kw["cmap"])
    for p in ax.flat:
        p.set_axis_off()
    ax[0, 0].set_title(input_label)
    for j, lab in enumerate(output_labels):
        ax[0, j + 1].set_title(lab)
    return fig, ax


def power_spectrum_fractional_error(output_true, output_pred, input, L,
                                    mode: str = "auto",
                                    output_inverse_transforms=None,
                                    input_inverse_transforms=None,
                                    n_k_bin: int = 20, device=None):
    """The metric behind the plots: per-sample Pk_pred/Pk_true - 1.

    Fields are (N, C, H, W); transforms (if given) are lists of per-sample
    callables applied before the FFT (the reference inverse-transforms
    tiles back to physical units first, painter.py:321,345-346). Computed
    on ``device`` (by default ``output_true``'s, else the card). Returns
    (k, frac_dev (N, C, n_k)) as numpy."""
    k, pk_t, pk_p = _spectra(output_true, output_pred, input, L, mode,
                             output_inverse_transforms,
                             input_inverse_transforms, n_k_bin, device)
    return k, _frac(pk_t, pk_p)


def plot_power_spectra(output_true, output_pred, input, L,
                       mode: str = "auto", output_labels: Sequence[str] = (),
                       plot_size=(4, 2),
                       input_transform=None, output_transforms=None,
                       n_k_bin: int = 20, plot_mean_deviation: bool = True,
                       device=None):
    """Auto/cross P(k) with a fractional-deviation panel (+-0.5 band)."""
    plt = _plt()
    k, pk_t_all, pk_p_all = _spectra(output_true, output_pred, input, L,
                                     mode, output_transforms,
                                     input_transform, n_k_bin, device)
    frac_all = _frac(pk_t_all, pk_p_all)
    n, c = frac_all.shape[:2]
    fig, ax = plt.subplots(2, c, sharex=True,
                           figsize=(plot_size[0] * c, plot_size[1] * 2),
                           squeeze=False)
    for j in range(n):
        for i in range(c):
            ax[0, i].loglog(k, k ** 2 * pk_t_all[j, i], alpha=0.2, c="C0")
            ax[0, i].loglog(k, k ** 2 * pk_p_all[j, i], alpha=0.2, c="C1")
            ax[1, i].semilogx(k, frac_all[j, i], alpha=0.2, c="C0")
    for i in range(c):
        if plot_mean_deviation:
            ax[1, i].semilogx(k, frac_all[:, i].mean(axis=0), lw=2, c="C0")
        if i < len(output_labels):
            ax[0, i].set_title(output_labels[i])
    for p in ax[0]:
        p.set_ylabel(r"$k^2 P(k)$")
        p.plot([], [], c="C0", label="Truth")
        p.plot([], [], c="C1", label="Predicted")
        p.legend(frameon=False)
    for p in ax[1]:
        p.set_ylim(-0.5, 0.5)
        p.axhline(0)
        p.set_ylabel("Fractional\ndifference")
        p.set_xlabel(r"$k$ [Mpc$^{-1}$ h]")
    fig.suptitle(f"{mode.capitalize()} power spectrum")
    return fig, ax


def plot_histogram(output_true, output_pred, n_sample: int = 1,
                   labels: Sequence[str] = (), plot_size=(4, 2),
                   n_bin: int = 100, x_logscale: bool = False,
                   y_logscale: bool = False, **plot_kwargs):
    """Pixel-value histograms, truth vs prediction."""
    plt = _plt()
    output_true, output_pred = _host(output_true), _host(output_pred)
    c = output_true.shape[1]
    fig, ax = plt.subplots(1, c, sharex=True,
                           figsize=(plot_size[0] * c, plot_size[1]),
                           squeeze=False)
    ax = ax[0]
    for i in range(c):
        d_true = output_true[:n_sample, i].ravel()
        d_pred = output_pred[:n_sample, i].ravel()
        lo = min(d_true.min(), d_pred.min())
        hi = max(d_true.max(), d_pred.max())
        if x_logscale:
            bins = np.logspace(np.log10(max(lo, 1e-12)), np.log10(hi), n_bin)
        else:
            bins = np.linspace(lo, hi, n_bin)
        ax[i].hist(d_true, bins=bins, density=True, alpha=0.5,
                   facecolor="C0", label="Truth", **plot_kwargs)
        ax[i].hist(d_pred, bins=bins, density=True, alpha=0.5,
                   facecolor="C1", label="Predicted", **plot_kwargs)
        ax[i].legend()
        if x_logscale:
            ax[i].set_xscale("log")
        if y_logscale:
            ax[i].set_yscale("log")
        if i < len(labels):
            ax[i].set_xlabel(labels[i])
    return fig, ax


def validation_figures(x, pred, y, ds, zs, pred_var=None,
                       spectra: Sequence[str] = ("auto",),
                       histograms: Sequence[str] = ("log",),
                       device=None) -> dict:
    """The figures of a trainer's ``validate`` (the JAX trainers'): the
    truth ``x``, the painted ``pred`` (and ``pred_var``) and the input
    ``y`` of a test batch of ``ds`` at redshifts ``zs``, as (N, C, H, W),
    under the keys ``sample``, ``{mode}_power_spectrum`` for each mode of
    ``spectra`` and ``{mode}_histogram`` for each of ``histograms``;
    spectra on ``device``."""
    inv = [ds.get_inverse_transforms(z=float(z)) for z in zs]
    figs = {}
    figs["sample"], _ = plot_samples(
        x, pred, y, output_pred_var=pred_var, input_label=ds.input_field,
        output_labels=ds.label_fields)
    for mode in spectra or ():
        figs[f"{mode}_power_spectrum"], _ = plot_power_spectra(
            x, pred, y, L=ds.tile_L, mode=mode,
            output_labels=ds.label_fields,
            input_transform=[t[0] for t in inv],
            output_transforms=[t[1:] for t in inv], device=device)
    for mode in histograms or ():
        figs[f"{mode}_histogram"], _ = plot_histogram(
            x, pred, labels=ds.label_fields, y_logscale=mode == "log")
    return figs


def save_figures(figs: dict, filename_template: str):
    """Save each figure as ``filename_template.format(plot_type=key)``."""
    for name, fig in figs.items():
        fig.savefig(filename_template.format(plot_type=name))
